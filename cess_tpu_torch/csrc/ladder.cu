// ladder.cu — kernel K3: per-lane [s]P by MSB-first double-and-add.
//
// Replaces the JAX package's Pallas ladder (cess_tpu/ops/g1.py,
// _ladder_tile_kernel).  One lane per thread: the whole bit loop runs in
// registers and local memory, reading the point and the scalar once and
// writing the result once, so the kernel is bound by integer
// multiply-adds (20 Fp products per bit: 8 for the doubling, 12 for the
// addition), not by bytes.  On the verify
// path it runs the ρ folds and the subgroup chain [r]σ in one launch of a
// few thousand lanes — too few to fill 132 SMs — so it uses 32-thread
// blocks to spread them over as many SMs as it can.
//
// Data-oblivious like the TPU kernel: every bit computes the double and
// the add, and a select keeps one.
#include "fp381.cuh"

__global__ void __launch_bounds__(128)
    ladder_kernel(const int32_t* __restrict__ X, const int32_t* __restrict__ Y,
                  const int32_t* __restrict__ Z, const int32_t* __restrict__ S,
                  int32_t* oX, int32_t* oY, int32_t* oZ, long long n,
                  int bits) {
  long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  Pt p, acc, s;
  pt_load(p, X, Y, Z, (size_t)lane, (size_t)n);
  pt_inf(acc);
#pragma unroll 1
  for (int i = 0; i < bits; ++i) {
    const int j = bits - 1 - i;
    pt_dbl(acc, acc);
    pt_add(s, acc, p);
    const int limb = S[(size_t)(j / 12) * n + lane];
    const bool bit = ((limb >> (j % 12)) & 1) != 0;
    pt_select(acc, bit, s, acc);
  }
  pt_store(oX, oY, oZ, (size_t)lane, (size_t)n, acc);
}

extern "C" int cess_consts_words(void) { return CESS_FP_WORDS; }

extern "C" int cess_init(const uint32_t* words, int nwords) {
  if (nwords != CESS_FP_WORDS) return -1;
  int e = cess_upload_fp(words);
  if (e) return e;
  return (int)cudaDeviceSynchronize();
}

extern "C" int cess_ladder(const int32_t* X, const int32_t* Y,
                           const int32_t* Z, const int32_t* S, int32_t* oX,
                           int32_t* oY, int32_t* oZ, long long n, int bits,
                           void* stream) {
  if (n <= 0) return 0;
  const int t = cess_threads(n);
  ladder_kernel<<<cess_blocks(n, t), t, 0, (cudaStream_t)stream>>>(
      X, Y, Z, S, oX, oY, oZ, n, bits);
  return (int)cudaGetLastError();
}
