// fp381.cuh — BLS12-381 base field Fp and the complete G1 formulas, one
// lane per thread, shared by the four kernels of cess_tpu_torch.
//
// Internal form: 12 little-endian 32-bit words in Montgomery form
// (R = 2^384), always fully reduced (< p).  Products are CIOS Montgomery
// multiplications on 64-bit partial products.  Because every value is
// canonical, equality and zero tests compare words directly; the parity
// (sgn0) predicate converts out of Montgomery form first, since the low
// bit of a Montgomery word is not the parity of the value.
//
// Boundary form: the JAX package's layout — 33 loose base-4096 limbs per
// element, limb-major (33, N) int32.  `fp_from_limbs` reduces any loose
// value (< 2^396) into Montgomery form; `fp_to_limbs` writes canonical
// limbs (each < 4096, limb 32 = 0), which are valid loose limbs.
//
// The constants (p, R^2, R^3, R mod p, −p^−1 mod 2^32) are uploaded once
// by the host into __constant__ memory (see cess_tpu_torch/ops/_cuda.py);
// nothing numeric is typed into these sources.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

#define NW 12     // 32-bit words per Fp element
#define NLIMB 33  // base-4096 limbs per element at the boundary

struct Fp {
  uint32_t w[NW];
};

struct Pt {
  Fp x, y, z;
};

struct FpConsts {
  uint32_t p[NW];
  uint32_t r2[NW];   // R^2 mod p
  uint32_t r3[NW];   // R^3 mod p
  uint32_t one[NW];  // R mod p (Montgomery 1)
  uint32_t pinv;     // -p^-1 mod 2^32
};

__constant__ FpConsts FPC;

__device__ __forceinline__ void fp_load(Fp& r, const uint32_t* c) {
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = c[i];
}

__device__ __forceinline__ void fp_zero(Fp& r) {
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = 0;
}

__device__ __forceinline__ void fp_one(Fp& r) { fp_load(r, FPC.one); }

__device__ __forceinline__ bool fp_is_zero(const Fp& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) acc |= a.w[i];
  return acc == 0;
}

__device__ __forceinline__ bool fp_eq(const Fp& a, const Fp& b) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) acc |= a.w[i] ^ b.w[i];
  return acc == 0;
}

// r = t - p if t >= p (t given as NW words plus a high word), else t.
__device__ __forceinline__ void fp_reduce_once(Fp& r, const uint32_t* t,
                                               uint32_t hi) {
  uint32_t d[NW];
  int64_t br = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    int64_t v = (int64_t)t[i] - (int64_t)FPC.p[i] + br;
    d[i] = (uint32_t)v;
    br = v >> 32;  // 0 or -1
  }
  bool take = (hi != 0) || (br == 0);
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = take ? d[i] : t[i];
}

// CIOS Montgomery product: r = a·b·R^−1 mod p for a < R, b < p.
__device__ __forceinline__ void fp_mul(Fp& r, const Fp& a, const Fp& b) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int i = 0; i < NW + 2; ++i) t[i] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      uint64_t uv = (uint64_t)t[j] + (uint64_t)a.w[j] * b.w[i] + c;
      t[j] = (uint32_t)uv;
      c = uv >> 32;
    }
    uint64_t s = (uint64_t)t[NW] + c;
    t[NW] = (uint32_t)s;
    t[NW + 1] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * FPC.pinv;
    uint64_t uv = (uint64_t)t[0] + (uint64_t)m * FPC.p[0];
    c = uv >> 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      uv = (uint64_t)t[j] + (uint64_t)m * FPC.p[j] + c;
      t[j - 1] = (uint32_t)uv;
      c = uv >> 32;
    }
    uv = (uint64_t)t[NW] + c;
    t[NW - 1] = (uint32_t)uv;
    t[NW] = t[NW + 1] + (uint32_t)(uv >> 32);
  }
  fp_reduce_once(r, t, t[NW]);
}

__device__ __forceinline__ void fp_add(Fp& r, const Fp& a, const Fp& b) {
  uint32_t t[NW];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t v = (uint64_t)a.w[i] + b.w[i] + c;
    t[i] = (uint32_t)v;
    c = v >> 32;
  }
  fp_reduce_once(r, t, (uint32_t)c);
}

__device__ __forceinline__ void fp_sub(Fp& r, const Fp& a, const Fp& b) {
  uint32_t t[NW];
  int64_t br = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    int64_t v = (int64_t)a.w[i] - (int64_t)b.w[i] + br;
    t[i] = (uint32_t)v;
    br = v >> 32;
  }
  // on borrow add p back
  uint32_t mask = br ? 0xffffffffu : 0u;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t v = (uint64_t)t[i] + (FPC.p[i] & mask) + c;
    r.w[i] = (uint32_t)v;
    c = v >> 32;
  }
}

__device__ __forceinline__ void fp_neg(Fp& r, const Fp& a) {
  Fp z;
  fp_zero(z);
  fp_sub(r, z, a);
}

// r = k·a for a small compile-time constant k, by double-and-add.
__host__ __device__ constexpr int cess_top_bit(int k) {
  return k <= 1 ? 0 : 1 + cess_top_bit(k >> 1);
}

template <int K>
__device__ __forceinline__ void fp_small(Fp& r, const Fp& a) {
  static_assert(K >= 1 && K < 256, "small constant");
  Fp acc = a;
#pragma unroll
  for (int bit = cess_top_bit(K) - 1; bit >= 0; --bit) {
    fp_add(acc, acc, acc);
    if ((K >> bit) & 1) fp_add(acc, acc, a);
  }
  r = acc;
}

__device__ __forceinline__ void fp_select(Fp& r, bool c, const Fp& a,
                                          const Fp& b) {
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = c ? a.w[i] : b.w[i];
}

// Montgomery → standard form (canonical, < p).
__device__ __forceinline__ void fp_to_std(Fp& r, const Fp& a) {
  Fp one;
  fp_zero(one);
  one.w[0] = 1;
  fp_mul(r, a, one);
}

// (33 loose limbs at src[i·stride]) → Montgomery form.
__device__ __forceinline__ void fp_from_limbs(Fp& r, const int32_t* src,
                                              size_t stride) {
  uint32_t w[NW + 2];
  uint64_t acc = 0;
  int nb = 0, wi = 0;
#pragma unroll
  for (int i = 0; i < NLIMB; ++i) {
    acc += (uint64_t)(uint32_t)src[(size_t)i * stride] << nb;
    nb += 12;
    if (nb >= 32) {
      w[wi++] = (uint32_t)acc;
      acc >>= 32;
      nb -= 32;
    }
  }
  w[NW] = (uint32_t)acc;
  w[NW + 1] = (uint32_t)(acc >> 32);
  Fp lo, hi, r2, r3, a, b;
#pragma unroll
  for (int i = 0; i < NW; ++i) lo.w[i] = w[i];
  fp_zero(hi);
  hi.w[0] = w[NW];
  hi.w[1] = w[NW + 1];
  fp_load(r2, FPC.r2);
  fp_load(r3, FPC.r3);
  fp_mul(a, lo, r2);  // lo·R
  fp_mul(b, hi, r3);  // hi·2^384·R
  fp_add(r, a, b);
}

// Montgomery form → 33 canonical base-4096 limbs at dst[i·stride].
__device__ __forceinline__ void fp_to_limbs(int32_t* dst, size_t stride,
                                            const Fp& a) {
  Fp s;
  fp_to_std(s, a);
#pragma unroll
  for (int i = 0; i < NLIMB - 1; ++i) {
    const int bit = 12 * i, wi = bit / 32, sh = bit % 32;
    uint32_t v = s.w[wi] >> sh;
    if (sh > 20) v |= s.w[wi + 1] << (32 - sh);
    dst[(size_t)i * stride] = (int32_t)(v & 0xfffu);
  }
  dst[(size_t)(NLIMB - 1) * stride] = 0;
}

__device__ __forceinline__ int fp_parity(const Fp& a) {
  Fp s;
  fp_to_std(s, a);
  return (int)(s.w[0] & 1u);
}

// ------------------------------------------------------------ G1 points
// Projective (X : Y : Z) on y² = x³ + 4, ∞ = (0 : 1 : 0).  Complete
// formulas of Renes–Costello–Batina 2016 for a = 0 (Alg. 7 and 9), in the
// JAX package's exact step order, so every coordinate equals the plain
// tensor twin's mod p.

__device__ __forceinline__ void pt_inf(Pt& r) {
  fp_zero(r.x);
  fp_one(r.y);
  fp_zero(r.z);
}

__device__ __forceinline__ void pt_load(Pt& r, const int32_t* X,
                                        const int32_t* Y, const int32_t* Z,
                                        size_t lane, size_t n) {
  fp_from_limbs(r.x, X + lane, n);
  fp_from_limbs(r.y, Y + lane, n);
  fp_from_limbs(r.z, Z + lane, n);
}

__device__ __forceinline__ void pt_store(int32_t* X, int32_t* Y, int32_t* Z,
                                         size_t lane, size_t n, const Pt& p) {
  fp_to_limbs(X + lane, n, p.x);
  fp_to_limbs(Y + lane, n, p.y);
  fp_to_limbs(Z + lane, n, p.z);
}

__device__ __noinline__ void pt_add(Pt& r, const Pt& p, const Pt& q) {
  Fp t0, t1, t2, t3, t4, ty, a, b, X3, Y3, Z3;
  fp_mul(t0, p.x, q.x);
  fp_mul(t1, p.y, q.y);
  fp_mul(t2, p.z, q.z);
  fp_add(a, p.x, p.y);
  fp_add(b, q.x, q.y);
  fp_mul(t3, a, b);
  fp_add(a, t0, t1);
  fp_sub(t3, t3, a);  // X1Y2 + X2Y1
  fp_add(a, p.y, p.z);
  fp_add(b, q.y, q.z);
  fp_mul(t4, a, b);
  fp_add(a, t1, t2);
  fp_sub(t4, t4, a);  // Y1Z2 + Y2Z1
  fp_add(a, p.x, p.z);
  fp_add(b, q.x, q.z);
  fp_mul(ty, a, b);
  fp_add(a, t0, t2);
  fp_sub(ty, ty, a);  // X1Z2 + X2Z1
  fp_add(a, t0, t0);
  fp_add(t0, a, t0);  // 3·X1X2
  fp_small<12>(t2, t2);  // 3b·Z1Z2
  fp_add(Z3, t1, t2);
  fp_sub(t1, t1, t2);
  fp_small<12>(ty, ty);
  fp_mul(X3, t3, t1);
  fp_mul(a, t4, ty);
  fp_sub(X3, X3, a);
  fp_mul(Y3, t1, Z3);
  fp_mul(a, ty, t0);
  fp_add(Y3, Y3, a);
  fp_mul(Z3, Z3, t4);
  fp_mul(a, t0, t3);
  fp_add(Z3, Z3, a);
  r.x = X3;
  r.y = Y3;
  r.z = Z3;
}

__device__ __noinline__ void pt_dbl(Pt& r, const Pt& p) {
  Fp t0, t1, t2, X3, Y3, Z3, a;
  fp_mul(t0, p.y, p.y);
  fp_add(Z3, t0, t0);
  fp_add(Z3, Z3, Z3);
  fp_add(Z3, Z3, Z3);  // 8Y²
  fp_mul(t1, p.y, p.z);
  fp_mul(t2, p.z, p.z);
  fp_small<12>(t2, t2);  // 3bZ²
  fp_mul(X3, t2, Z3);
  fp_add(Y3, t0, t2);
  fp_mul(Z3, t1, Z3);  // 8Y³Z
  fp_add(a, t2, t2);
  fp_add(t2, a, t2);  // 9bZ²
  fp_sub(t0, t0, t2);
  fp_mul(a, t0, Y3);
  fp_add(Y3, X3, a);
  fp_mul(a, p.x, p.y);
  fp_mul(X3, t0, a);
  fp_add(X3, X3, X3);
  r.x = X3;
  r.y = Y3;
  r.z = Z3;
}

__device__ __forceinline__ void pt_select(Pt& r, bool c, const Pt& a,
                                          const Pt& b) {
  fp_select(r.x, c, a.x, b.x);
  fp_select(r.y, c, a.y, b.y);
  fp_select(r.z, c, a.z, b.z);
}

static inline int cess_threads(long long n) { return n >= 16384 ? 128 : 32; }
static inline unsigned cess_blocks(long long n, int t) {
  return (unsigned)((n + t - 1) / t);
}

#define CESS_FP_WORDS ((int)(sizeof(FpConsts) / 4))

// Copies the shared field constants (the first CESS_FP_WORDS words of a
// module's constant block) into __constant__ memory.
static int cess_upload_fp(const uint32_t* words) {
  return (int)cudaMemcpyToSymbol(FPC, words, sizeof(FpConsts));
}
