// glv.cu — kernel K2: per-lane [k1 + k2·λ]([h_eff]P) (clear = 1) or
// [k1 + k2·λ]P (clear = 0).
//
// Replaces the JAX package's Pallas GLV fold (cess_tpu/ops/glv.py,
// _glv_tile_kernel).  Same chain: the fixed [h_eff] double-and-add (63
// doublings, 6 additions, bits uploaded by the host), the 16-entry table
// T[4b + a] = [a]Q + [b]φ(Q) with φ(x, y) = (βx, y), then 64 steps of
// acc = 4·acc + T[window] reading two bits each of k1 and k2.  About
// 2,500 Fp products per lane with the clear (8 per doubling, 2 of them
// squarings; 12 per addition), so the kernel is bound by integer
// multiply-adds.
//
// Design.  One lane per thread, the accumulator and the addend in
// registers.  The whole chain — clear, table, ladder — is one loop whose
// step is "load, up to two doublings, one addition, store", so each point
// formula is compiled once and the kernel stays small.  The table lives
// in a scratch buffer the wrapper allocates, word-major per entry and a
// warp wide (word w of entry e of lane l of a warp at (e·36 + w)·32 + l in
// the warp's block), not in the thread's stack frame.  Blocks are
// persistent: as many as the occupancy calculator lets every SM hold,
// striding over the lanes, so a launch is whole waves (48,128 lanes at
// 12 warps an SM are 0.95 of one).
#include "fp381.cuh"

#define GLV_THREADS 128
#define GLV_MIN_BLOCKS 3  // 12 warps an SM: at most 168 registers a thread
#define GLV_TABLE_WORDS (16 * 3 * NW)

struct GlvConsts {
  uint32_t beta[NW];  // β in Montgomery form
  uint32_t heff_nbits;
  uint32_t heff_bits[64];  // h_eff, MSB first
};

__constant__ GlvConsts GC;

// Table word i of entry e lives at tab[(e·36 + i)·32]: `tab` points at
// the thread's column of its warp's 576 × 32-word block, so a warp's
// stores are coalesced and every offset is a compile-time constant.
__device__ __forceinline__ void tab_put(uint32_t* tab, int e, const Pt& p) {
  uint32_t* d = tab + e * 3 * NW * 32;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    d[i * 32] = p.x.w[i];
    d[(NW + i) * 32] = p.y.w[i];
    d[(2 * NW + i) * 32] = p.z.w[i];
  }
}

__device__ __forceinline__ void tab_get(Pt& p, const uint32_t* tab, int e) {
  const uint32_t* s = tab + e * 3 * NW * 32;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    p.x.w[i] = s[i * 32];
    p.y.w[i] = s[(NW + i) * 32];
    p.z.w[i] = s[(2 * NW + i) * 32];
  }
}

__global__ void __launch_bounds__(GLV_THREADS, GLV_MIN_BLOCKS)
    glv_kernel(const int32_t* __restrict__ X, const int32_t* __restrict__ Y,
               const int32_t* __restrict__ Z, const int32_t* __restrict__ K1,
               const int32_t* __restrict__ K2, int32_t* oX, int32_t* oY,
               int32_t* oZ, uint32_t* scratch, long long n, int clear) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  uint32_t* tab =
      scratch + (tid >> 5) * (GLV_TABLE_WORDS * 32) + (threadIdx.x & 31);
  const int nc = clear ? (int)GC.heff_nbits - 1 : 0;
#pragma unroll 1
  for (long long lane = tid; lane < n; lane += nthreads) {
    Pt acc, q;
    pt_load(acc, X, Y, Z, (size_t)lane, (size_t)n);
    pt_inf(q);
    tab_put(tab, 0, q);
    tab_put(tab, 1, acc);
    // steps [0, nc): the clear, acc = 2·acc (+ Q); [nc, nc + 14): table
    // entries 2…15; then the 64 windows, acc = 4·acc + T[window]
#pragma unroll 1
    for (int it = 0; it < nc + 14 + 64; ++it) {
      int ndbl = 0, add = -1, dst = -1;
      if (it < nc) {
        ndbl = 1;
        if (GC.heff_bits[it + 1]) add = 1;
        if (it == nc - 1) dst = 1;
      } else if (it < nc + 14) {
        const int e = it - nc + 2, a = e & 3, b = e >> 2;
        dst = e;
        if (e == 2) {
          ndbl = 1;  // acc holds T[1]
        } else if (e == 3) {
          add = 1;  // acc holds T[2]
        } else if (a == 0) {
          Fp beta;
          fp_load(beta, GC.beta);
          tab_get(acc, tab, b);
          fp_mul(acc.x, beta, acc.x);  // φ(T[b])
        } else {
          tab_get(acc, tab, a);
          add = 4 * b;  // T[a] + φ(T[b])
        }
      } else {
        const int i = it - nc - 14;
        const int bpos = 126 - 2 * i;  // MSB-first bit position
        const int limb = bpos / 12, sh = bpos % 12;
        const int d1 = (K1[(size_t)limb * n + lane] >> sh) & 3;
        const int d2 = (K2[(size_t)limb * n + lane] >> sh) & 3;
        if (i == 0) pt_inf(acc);
        ndbl = 2;
        add = d1 + 4 * d2;
      }
#pragma unroll 1
      for (int d = 0; d < ndbl; ++d) pt_dbl(acc);
      if (add >= 0) {
        tab_get(q, tab, add);
        pt_add(acc, q);
      }
      if (dst >= 0) tab_put(tab, dst, acc);
    }
    pt_store(oX, oY, oZ, (size_t)lane, (size_t)n, acc);
  }
}

// Persistent grid: min(blocks the lanes need, blocks every SM can hold).
static unsigned glv_grid(long long n) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, glv_kernel,
                                                GLV_THREADS, 0);
  const long long need = (n + GLV_THREADS - 1) / GLV_THREADS;
  const long long full = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  return (unsigned)(need < full ? need : full);
}

extern "C" int cess_consts_words(void) {
  return CESS_FP_WORDS + (int)(sizeof(GlvConsts) / 4);
}

extern "C" int cess_init(const uint32_t* words, int nwords) {
  if (nwords != cess_consts_words()) return -1;
  int e = cess_upload_fp(words);
  if (e) return e;
  e = (int)cudaMemcpyToSymbol(GC, words + CESS_FP_WORDS, sizeof(GlvConsts));
  if (e) return e;
  return (int)cudaDeviceSynchronize();
}

// 32-bit words of table scratch a launch over n lanes needs.
extern "C" long long cess_glv_scratch_words(long long n) {
  if (n <= 0) return 0;
  return (long long)glv_grid(n) * GLV_THREADS * GLV_TABLE_WORDS;
}

extern "C" int cess_glv(const int32_t* X, const int32_t* Y, const int32_t* Z,
                        const int32_t* K1, const int32_t* K2, int32_t* oX,
                        int32_t* oY, int32_t* oZ, uint32_t* scratch,
                        long long n, int clear, void* stream) {
  if (n <= 0) return 0;
  if (!scratch) return (int)cudaErrorInvalidValue;
  glv_kernel<<<glv_grid(n), GLV_THREADS, 0, (cudaStream_t)stream>>>(
      X, Y, Z, K1, K2, oX, oY, oZ, scratch, n, clear);
  return (int)cudaGetLastError();
}
