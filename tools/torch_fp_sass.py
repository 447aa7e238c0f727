"""Count the SASS instructions of one Fp product and one Fp squaring of
the port's field code (cess_tpu_torch/csrc/fp381.cuh) on sm_90a and, on
a card, measure what each kind of integer multiply-add costs to issue.

    python3 tools/torch_fp_sass.py

Compiles one library with the port's nvcc flags (`_FLAGS` of
ops/_cuda.py) and disassembles it with cuobjdump.  Prints one JSON line
for each of two one-line kernels, r = a·b and r = a², on words loaded
from and stored to global memory: the total instruction count and the
count of each opcode with its modifiers (IMAD, IMAD.WIDE.U32,
IMAD.HI.U32, IMAD.X, IMAD.MOV.U32, …; the loads, stores and the exit are
in the totals and listed, so they can be taken out).

Where torch sees a CUDA device it also runs the rate kernels, one line
each: every resident thread repeats one instruction kind on CH
independent registers (or, for `fp_mul` and `fp_sqr`, the field product
and squaring on two independent values) between two reads of the SM's
cycle counter, with the grid sized to one full wave.  A line gives the
SASS between the two counter reads and the operations retired per cycle
per SM (all its blocks' operations over the span from the first block's
start to the last block's end on that SM's counter; the median, least
and most over the SMs), so the issue cost of each multiply-add variant,
and of a whole product, is measured in cycles rather than assumed.  Without a card only
the counts are printed.
"""

from __future__ import annotations

import collections
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

CH = 16       # independent registers a thread in the instruction kernels
ITERS = 4096  # loop trips between the counter reads
FP_ITERS = 64
THREADS = 256

# kind → (PTX of one operation on register i, operations a trip)
KINDS = {
    "IMAD": ('asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(a[i]) : "r"(b), "r"(c));', CH),
    "IMAD.WIDE.U32": ('asm volatile("mad.wide.u32 %0, %1, %2, %0;" : "+l"(w[i]) : "r"(a[i]), "r"(b));', CH),
    "IMAD.HI.U32": ('asm volatile("mad.hi.u32 %0, %0, %1, %2;" : "+r"(a[i]) : "r"(b), "r"(c));', CH),
    "IADD3": ('asm volatile("add.u32 %0, %0, %1;" : "+r"(a[i]) : "r"(b));', CH),
    "carry pair": ('asm volatile("add.cc.u32 %0, %0, %2;\\n\\tmadc.lo.u32 %1, %1, %2, %3;" '
                   ': "+r"(a[i]), "+r"(u[i]) : "r"(b), "r"(c));', CH),
}

SRC = r"""
#include "fp381.cuh"
#define CH %(ch)d
#define FPN 2

__global__ void probe_mul(const Fp* a, const Fp* b, Fp* r) { fp_mul(*r, *a, *b); }
__global__ void probe_sqr(const Fp* a, Fp* r) { fp_sqr(*r, *a); }

// A block's SM and its first and last cycle on that SM's counter.
__device__ void record(long long* cyc, long long t0, long long t1) {
  unsigned sm;
  asm volatile("mov.u32 %%0, %%%%smid;" : "=r"(sm));
  cyc[3 * blockIdx.x] = sm;
  cyc[3 * blockIdx.x + 1] = t0;
  cyc[3 * blockIdx.x + 2] = t1;
}

%(kernels)s

template <int SQR>
__global__ void __launch_bounds__(%(threads)d) rate_fp(uint32_t* out, long long* cyc,
                                                       int iters) {
  Fp x[FPN], y;
  for (int i = 0; i < NW; ++i) y.w[i] = (threadIdx.x * 977u + i) %% 65521u;
  for (int k = 0; k < FPN; ++k)
    for (int i = 0; i < NW; ++i) x[k].w[i] = (blockIdx.x * 31u + k + i) %% 65521u;
  __syncthreads();
  const long long t0 = clock64();
#pragma unroll 1
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int k = 0; k < FPN; ++k) {
      if (SQR) fp_sqr(x[k], x[k]); else fp_mul(x[k], x[k], y);
    }
  __syncthreads();
  const long long t1 = clock64();
  uint32_t h = 0;
  for (int k = 0; k < FPN; ++k)
    for (int i = 0; i < NW; ++i) h ^= x[k].w[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = h;
  if (threadIdx.x == 0) record(cyc, t0, t1);
}

extern "C" int init(const uint32_t* words) { return cess_upload_fp(words); }

template <typename K>
static int launch(K kern, uint32_t* out, long long* cyc, int iters, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, %(threads)d, 0);
  *blocks = per_sm;
  kern<<<per_sm * sms, %(threads)d>>>(out, cyc, iters);
  cudaError_t e = cudaDeviceSynchronize();
  return e ? (int)e : (int)cudaGetLastError();
}

extern "C" int run(int kind, uint32_t* out, long long* cyc, int iters, int* blocks) {
  switch (kind) {
%(cases)s
    case %(nk)d: return launch(rate_fp<0>, out, cyc, iters, blocks);
    case %(nk1)d: return launch(rate_fp<1>, out, cyc, iters, blocks);
  }
  return -1;
}
"""

KERNEL = r"""
__global__ void __launch_bounds__(%(threads)d) rate_%(idx)d(uint32_t* out, long long* cyc,
                                                            int iters) {
  uint32_t a[CH], u[CH];
  unsigned long long w[CH];
  const uint32_t b = threadIdx.x * 2654435761u + 1u, c = blockIdx.x + 7u;
  for (int i = 0; i < CH; ++i) { a[i] = threadIdx.x + i * 977u; u[i] = a[i] ^ 5u; w[i] = a[i]; }
  __syncthreads();
  const long long t0 = clock64();
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < CH; ++i) { %(op)s }
  }
  __syncthreads();
  const long long t1 = clock64();
  uint32_t h = 0;
  for (int i = 0; i < CH; ++i) h ^= a[i] ^ u[i] ^ (uint32_t)w[i] ^ (uint32_t)(w[i] >> 32);
  out[blockIdx.x * blockDim.x + threadIdx.x] = h;
  if (threadIdx.x == 0) record(cyc, t0, t1);
}
"""

_OP = re.compile(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def _source() -> str:
    kernels = "".join(KERNEL % {"threads": THREADS, "idx": k, "op": op}
                      for k, (op, _) in enumerate(KINDS.values()))
    cases = "\n".join(f"    case {k}: return launch(rate_{k}, out, cyc, iters, blocks);"
                      for k in range(len(KINDS)))
    return SRC % {"ch": CH, "threads": THREADS, "kernels": kernels, "cases": cases,
                  "nk": len(KINDS), "nk1": len(KINDS) + 1}


def _sass_counts(sass: str) -> dict[str, tuple[collections.Counter, collections.Counter]]:
    """function name → (every instruction, the instructions between the
    two reads of the cycle counter)."""
    out: dict[str, tuple[collections.Counter, collections.Counter]] = {}
    name = None
    clocks = 0
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name, clocks = m.group(1), 0
            out[name] = (collections.Counter(), collections.Counter())
            continue
        m = _OP.match(line)
        if not (name and m) or m.group(1) == "NOP":
            continue
        if "SR_CLOCK" in line:
            clocks += 1
            continue
        out[name][0][m.group(1)] += 1
        if clocks == 1:
            out[name][1][m.group(1)] += 1
    return out


def _rates(lib_path: Path, sass) -> None:
    import torch

    from cess_tpu_torch.ops import _cuda

    lib = ctypes.CDLL(str(lib_path))
    words = _cuda._consts_fp()
    buf = (ctypes.c_uint32 * len(words))(*words)
    if lib.init(buf):
        raise RuntimeError("constant upload failed")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 64 * THREADS, dtype=torch.int32, device="cuda")
    cyc = torch.zeros(3 * sms * 64, dtype=torch.int64, device="cuda")
    blocks = ctypes.c_int(0)
    names = list(KINDS) + ["fp_mul", "fp_sqr"]
    fn_of = {}
    for fn in sass:
        m = re.search(r"rate_(\d+)", fn)
        if m:
            fn_of[names[int(m.group(1))]] = fn
        elif "rate_fp" in fn:
            fn_of["fp_sqr" if "ILi1E" in fn else "fp_mul"] = fn
    for k, name in enumerate(names):
        fp = name.startswith("fp_")
        iters = FP_ITERS if fp else ITERS
        per_trip = 2 if fp else KINDS[name][1]
        for _ in range(2):  # the first launch loads the module
            cyc.zero_()
            rc = lib.run(k, ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(cyc.data_ptr()),
                         iters, ctypes.byref(blocks))
            if rc:
                raise RuntimeError(f"rate kernel {name}: CUDA error {rc}")
        rec = cyc[: 3 * blocks.value * sms].view(-1, 3).cpu().tolist()
        span: dict[int, list] = {}
        for sm, t0, t1 in rec:  # per SM: blocks, first start, last end
            b = span.setdefault(sm, [0, t0, t1])
            b[0], b[1], b[2] = b[0] + 1, min(b[1], t0), max(b[2], t1)
        per_sm = sorted(n * THREADS * iters * per_trip / (t1 - t0)
                        for n, t0, t1 in span.values())
        loop = sass[fn_of[name]][1]
        print(json.dumps({
            "rate": name, "blocks_per_sm": blocks.value, "threads": THREADS, "sms": len(span),
            "ops_per_cycle_per_sm_median": per_sm[len(per_sm) // 2],
            "ops_per_cycle_per_sm_min": per_sm[0], "ops_per_cycle_per_sm_max": per_sm[-1],
            "sass_between_clock_reads": dict(loop.most_common()),
        }), flush=True)


def main() -> None:
    root = Path(__file__).resolve().parents[1]
    csrc = root / "cess_tpu_torch" / "csrc"
    sys.path.insert(0, str(root))
    from cess_tpu_torch.ops import _cuda

    nvcc = _cuda._nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    with tempfile.TemporaryDirectory() as tmp:
        cu = Path(tmp) / "probe.cu"
        cu.write_text(_source())
        lib = Path(tmp) / "probe.so"
        subprocess.run([nvcc, *_cuda._FLAGS, "-I", str(csrc), "-o", str(lib), str(cu)],
                       check=True, capture_output=True)
        sass = _sass_counts(subprocess.run([cuobjdump, "-sass", str(lib)], check=True,
                                           capture_output=True, text=True).stdout)
        for name in ("mul", "sqr"):
            fn = next(f for f in sass if f"probe_{name}" in f)
            c = sass[fn][0]
            print(json.dumps({
                "kernel": f"fp_{name}", "instructions": sum(c.values()),
                "imad_family": sum(v for k, v in c.items() if k.startswith("IMAD")),
                "by_opcode": dict(c.most_common())}), flush=True)
        import torch

        if torch.cuda.is_available():
            _rates(lib, sass)


if __name__ == "__main__":
    main()
