// glv.cu — kernel K2: per-lane [k1 + k2·λ]([h_eff]P) (clear = 1) or
// [k1 + k2·λ]P (clear = 0).
//
// Replaces the JAX package's Pallas GLV fold (cess_tpu/ops/glv.py,
// _glv_tile_kernel).  Same chain: the fixed [h_eff] double-and-add (63
// doublings, 6 additions, bits uploaded by the host), the 16-entry table
// T[4b + a] = [a]Q + [b]φ(Q) with φ(x, y) = (βx, y), then 64 steps of
// acc = 4·acc + T[window] reading two bits each of k1 and k2.  About
// 2,500 Fp products per lane with the clear (8 per doubling, 12 per
// addition), so the kernel is bound by integer multiply-adds; the table
// (16 points, 2.3 KB per lane in the 12-word form) sits in local memory,
// indexed per lane.
#include "fp381.cuh"

struct GlvConsts {
  uint32_t beta[NW];  // β in Montgomery form
  uint32_t heff_nbits;
  uint32_t heff_bits[64];  // h_eff, MSB first
};

__constant__ GlvConsts GC;

__global__ void __launch_bounds__(128)
    glv_kernel(const int32_t* __restrict__ X, const int32_t* __restrict__ Y,
               const int32_t* __restrict__ Z, const int32_t* __restrict__ K1,
               const int32_t* __restrict__ K2, int32_t* oX, int32_t* oY,
               int32_t* oZ, long long n, int clear) {
  long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  Pt q;
  pt_load(q, X, Y, Z, (size_t)lane, (size_t)n);
  if (clear) {
    Pt acc = q;
#pragma unroll 1
    for (int b = 1; b < (int)GC.heff_nbits; ++b) {
      pt_dbl(acc, acc);
      if (GC.heff_bits[b]) pt_add(acc, acc, q);
    }
    q = acc;
  }
  Pt T[16];
  Fp beta;
  fp_load(beta, GC.beta);
  pt_inf(T[0]);
  T[1] = q;
  pt_dbl(T[2], q);
  pt_add(T[3], T[2], q);
#pragma unroll 1
  for (int b = 1; b < 4; ++b) {
    Pt phi;
    fp_mul(phi.x, T[b].x, beta);
    phi.y = T[b].y;
    phi.z = T[b].z;
    T[4 * b] = phi;
#pragma unroll 1
    for (int a = 1; a < 4; ++a) pt_add(T[4 * b + a], T[a], phi);
  }
  Pt acc;
  pt_inf(acc);
#pragma unroll 1
  for (int i = 0; i < 64; ++i) {
    const int bpos = 126 - 2 * i;  // MSB-first bit position
    const int limb = bpos / 12, sh = bpos % 12;
    const int d1 = (K1[(size_t)limb * n + lane] >> sh) & 3;
    const int d2 = (K2[(size_t)limb * n + lane] >> sh) & 3;
    pt_dbl(acc, acc);
    pt_dbl(acc, acc);
    pt_add(acc, acc, T[d1 + 4 * d2]);
  }
  pt_store(oX, oY, oZ, (size_t)lane, (size_t)n, acc);
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

extern "C" int cess_glv(const int32_t* X, const int32_t* Y, const int32_t* Z,
                        const int32_t* K1, const int32_t* K2, int32_t* oX,
                        int32_t* oY, int32_t* oZ, long long n, int clear,
                        void* stream) {
  if (n <= 0) return 0;
  const int t = cess_threads(n);
  glv_kernel<<<cess_blocks(n, t), t, 0, (cudaStream_t)stream>>>(
      X, Y, Z, K1, K2, oX, oY, oZ, n, clear);
  return (int)cudaGetLastError();
}
