// powc1.cu — kernel K4: per-lane t^((p−3)/4), the square-root chain of
// the SSWU map.
//
// Replaces the JAX package's Pallas chain (cess_tpu/ops/h2c.py,
// _powc1_tile_kernel; inside the map kernel it ran as pow_hook).  Same
// fixed-window algorithm: a table t^0…t^15, then for each 4-bit digit of
// (p−3)/4 four squarings and one table multiply (≈ 480 Fp products per
// lane).  One lane per thread; bound by integer multiply-adds.  The
// 16-entry table (768 B per lane) is indexed by a digit that is uniform
// across the warp, so it lives in local memory and hits L1.  The digits
// are uploaded by the host into __constant__ memory.
#include "fp381.cuh"

struct PowConsts {
  uint32_t ndigits;
  uint32_t digits[127];
};

__constant__ PowConsts PWC;

__global__ void __launch_bounds__(128)
    powc1_kernel(const int32_t* __restrict__ T, int32_t* out, long long n) {
  long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  Fp pre[16];
  fp_one(pre[0]);
  fp_from_limbs(pre[1], T + lane, (size_t)n);
#pragma unroll 1
  for (int k = 2; k < 16; ++k) fp_mul(pre[k], pre[k - 1], pre[1]);
  Fp acc = pre[PWC.digits[0]];
#pragma unroll 1
  for (int i = 1; i < (int)PWC.ndigits; ++i) {
#pragma unroll 1
    for (int s = 0; s < 4; ++s) fp_sqr(acc, acc);
    fp_mul(acc, acc, pre[PWC.digits[i]]);
  }
  fp_to_limbs(out + lane, (size_t)n, acc);
}

extern "C" int cess_consts_words(void) {
  return CESS_FP_WORDS + (int)(sizeof(PowConsts) / 4);
}

extern "C" int cess_init(const uint32_t* words, int nwords) {
  if (nwords != cess_consts_words()) return -1;
  int e = cess_upload_fp(words);
  if (e) return e;
  e = (int)cudaMemcpyToSymbol(PWC, words + CESS_FP_WORDS, sizeof(PowConsts));
  if (e) return e;
  return (int)cudaDeviceSynchronize();
}

extern "C" int cess_pow_c1(const int32_t* T, int32_t* out, long long n,
                           void* stream) {
  if (n <= 0) return 0;
  const int t = cess_threads(n);
  powc1_kernel<<<cess_blocks(n, t), t, 0, (cudaStream_t)stream>>>(T, out, n);
  return (int)cudaGetLastError();
}
