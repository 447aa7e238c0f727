// fp381.cuh — BLS12-381 base field Fp and the complete G1 formulas,
// shared by the four kernels of cess_tpu_torch.
//
// Internal form: 12 little-endian 32-bit words in Montgomery form
// (R = 2^384), always fully reduced (< p).  Because every value is
// canonical, equality and zero tests compare words directly, and a
// product computed any other way gives the same words; the parity (sgn0)
// predicate converts out of Montgomery form first, since the low bit of a
// Montgomery word is not the parity of the value.
//
// Products are PTX carry chains held in registers.  `fp_mul` is a CIOS
// Montgomery product whose partial products are split by the parity of
// the word of `a` into two accumulators (even words, odd words), so two
// independent carry chains interleave; the reduction row of each word of
// b follows its product row (144 + 144 word products, 588 multiply-adds).
// `fp_sqr` forms the 66 cross products once in the same even/odd split,
// doubles them, adds the 12 squares and reduces the low half separately
// (456 multiply-adds).  Every chain is written one PTX instruction per
// `asm volatile`, so the compiler keeps their order and never puts its own
// code between a carry and its use.
//
// Boundary form: the JAX package's layout — 33 loose base-4096 limbs per
// element, limb-major (33, N) int32.  `fp_from_limbs` reduces any loose
// value (< 2^397) into Montgomery form; `fp_to_limbs` writes canonical
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

// ------------------------------------------------------------ PTX words
// One instruction each; `cc` sets the carry flag, `c` reads it.

#define CESS_PTX3(name, op)                                               \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b) {      \
    uint32_t d;                                                           \
    asm volatile(op " %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));           \
    return d;                                                             \
  }
#define CESS_PTX4(name, op)                                               \
  __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b,        \
                                           uint32_t c) {                  \
    uint32_t d;                                                           \
    asm volatile(op " %0, %1, %2, %3;"                                    \
                 : "=r"(d)                                                \
                 : "r"(a), "r"(b), "r"(c));                               \
    return d;                                                             \
  }
CESS_PTX3(mul_lo, "mul.lo.u32")
CESS_PTX3(mul_hi, "mul.hi.u32")
CESS_PTX3(add_cc, "add.cc.u32")
CESS_PTX3(addc_cc, "addc.cc.u32")
CESS_PTX3(addc, "addc.u32")
CESS_PTX3(sub_cc, "sub.cc.u32")
CESS_PTX3(subc_cc, "subc.cc.u32")
CESS_PTX3(subc, "subc.u32")
CESS_PTX4(mad_lo_cc, "mad.lo.cc.u32")
CESS_PTX4(madc_lo_cc, "madc.lo.cc.u32")
CESS_PTX4(madc_hi_cc, "madc.hi.cc.u32")
CESS_PTX4(madc_hi, "madc.hi.u32")
#undef CESS_PTX3
#undef CESS_PTX4

// ------------------------------------------------------------ rows
// An accumulator pair (e, o) holds Σ e[j]·2^(32j) + Σ o[j]·2^(32(j+1)).
// `a` is read at even offsets only: a row over a[0], a[2], … or, passed
// a + 1, over a[1], a[3], …; each word product lands on two words.

// acc = a[0, 2, …]·b (fresh).
__device__ __forceinline__ void row_mul(uint32_t* acc, const uint32_t* a,
                                        uint32_t b) {
#pragma unroll
  for (int j = 0; j < NW; j += 2) {
    acc[j] = mul_lo(a[j], b);
    acc[j + 1] = mul_hi(a[j], b);
  }
}

// acc += a[0, 2, …]·b in one chain; leaves the carry out in the flag.
__device__ __forceinline__ void row_mad(uint32_t* acc, const uint32_t* a,
                                        uint32_t b) {
  acc[0] = mad_lo_cc(a[0], b, acc[0]);
  acc[1] = madc_hi_cc(a[0], b, acc[1]);
#pragma unroll
  for (int j = 2; j < NW; j += 2) {
    acc[j] = madc_lo_cc(a[j], b, acc[j]);
    acc[j + 1] = madc_hi_cc(a[j], b, acc[j + 1]);
  }
}

// acc = (acc >> 64) + a[0, 2, …]·b + flag, ending the chain.
__device__ __forceinline__ void row_mad_shift(uint32_t* acc, const uint32_t* a,
                                              uint32_t b) {
#pragma unroll
  for (int j = 0; j < NW - 2; j += 2) {
    acc[j] = madc_lo_cc(a[j], b, acc[j + 2]);
    acc[j + 1] = madc_hi_cc(a[j], b, acc[j + 3]);
  }
  acc[NW - 2] = madc_lo_cc(a[NW - 2], b, 0);
  acc[NW - 1] = madc_hi(a[NW - 2], b, 0);
}

// The reduction of one word: m = e[0]·(−p^−1), (e, o) += m·p, after which
// e[0] = 0 and the pair's value is a multiple of 2^32.
__device__ __forceinline__ void row_redc(uint32_t* e, uint32_t* o) {
  const uint32_t m = mul_lo(e[0], FPC.pinv);
  row_mad(o, FPC.p + 1, m);
  row_mad(e, FPC.p, m);
  o[NW - 1] = addc(o[NW - 1], 0);
}

// Divide the reduced pair (e, o) by 2^32 into the swapped pair (o, e),
// add a·b, and reduce.  `first`: the pair is empty.
__device__ __forceinline__ void step_mul(uint32_t* e, uint32_t* o,
                                         const uint32_t* a, uint32_t b,
                                         bool first) {
  if (first) {
    row_mul(o, a + 1, b);
    row_mul(e, a, b);
  } else {
    e[0] = add_cc(e[0], o[1]);
    row_mad_shift(o, a + 1, b);
    row_mad(e, a, b);
    o[NW - 1] = addc(o[NW - 1], 0);
  }
  row_redc(e, o);
}

// r = e + (o >> 32) for a reduced pair (o[0] = 0, value/2^32 < 2^384).
__device__ __forceinline__ void merge(uint32_t* r, const uint32_t* e,
                                      const uint32_t* o) {
  r[0] = add_cc(e[0], o[1]);
#pragma unroll
  for (int i = 1; i < NW - 1; ++i) r[i] = addc_cc(e[i], o[i + 1]);
  r[NW - 1] = addc(e[NW - 1], 0);
}

// r = t − p if t ≥ p, else t (t < 2p).
__device__ __forceinline__ void fp_reduce_once(Fp& r, const uint32_t* t) {
  uint32_t d[NW];
  d[0] = sub_cc(t[0], FPC.p[0]);
#pragma unroll
  for (int i = 1; i < NW; ++i) d[i] = subc_cc(t[i], FPC.p[i]);
  const uint32_t borrow = subc(0, 0);  // all ones when t < p
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = borrow ? t[i] : d[i];
}

// ------------------------------------------------------------ field ops

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

// Montgomery product r = a·b·R^−1 mod p for a < p, b < R.
__device__ __forceinline__ void fp_mul(Fp& r, const Fp& a, const Fp& b) {
  uint32_t e[NW], o[NW], t[NW];
#pragma unroll
  for (int i = 0; i < NW; i += 2) {
    step_mul(e, o, a.w, b.w[i], i == 0);
    step_mul(o, e, a.w, b.w[i + 1], false);
  }
  merge(t, e, o);
  fp_reduce_once(r, t);
}

// Montgomery square r = a²·R^−1 mod p for a < p.
__device__ __forceinline__ void fp_sqr(Fp& r, const Fp& x) {
  const uint32_t* a = x.w;
  // cross products a_i·a_j (i < j) at word i + j: even i + j into e,
  // odd into o, each row one chain per array whose carry lands on a word
  // no earlier row has filled beyond a carry of its own
  uint32_t e[2 * NW], o[2 * NW], t[2 * NW];
#pragma unroll
  for (int k = 0; k < 2 * NW; ++k) e[k] = o[k] = 0;
#pragma unroll
  for (int i = 0; i < NW - 1; ++i) {
#pragma unroll
    for (int par = 1; par <= 2; ++par) {
      uint32_t* acc = par == 1 ? o : e;
      const int j0 = i + par;
      if (j0 >= NW) continue;
      int top = 0;
#pragma unroll
      for (int j = j0; j < NW; j += 2) {
        const int k = i + j;
        acc[k] = j == j0 ? mad_lo_cc(a[i], a[j], acc[k])
                         : madc_lo_cc(a[i], a[j], acc[k]);
        acc[k + 1] = madc_hi_cc(a[i], a[j], acc[k + 1]);
        top = k + 1;
      }
      acc[top + 1] = addc(acc[top + 1], 0);
    }
  }
  // t = 2·(e + o) + Σ a_i²·2^(64i)
  t[0] = 0;
  t[1] = o[1];
  t[2] = add_cc(e[2], o[2]);
#pragma unroll
  for (int k = 3; k < 2 * NW - 1; ++k) t[k] = addc_cc(e[k], o[k]);
  t[2 * NW - 1] = addc(e[2 * NW - 1], o[2 * NW - 1]);
#pragma unroll
  for (int k = 2 * NW - 1; k > 0; --k) t[k] = __funnelshift_l(t[k - 1], t[k], 1);
  t[0] = 0;
  t[0] = mad_lo_cc(a[0], a[0], t[0]);
  t[1] = madc_hi_cc(a[0], a[0], t[1]);
#pragma unroll
  for (int i = 1; i < NW; ++i) {
    t[2 * i] = madc_lo_cc(a[i], a[i], t[2 * i]);
    t[2 * i + 1] = madc_hi_cc(a[i], a[i], t[2 * i + 1]);
  }
  // reduce the low half: u = (t_lo + m·p)/R ≤ p, then u + t_hi < 2p
  uint32_t re[NW], ro[NW], u[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) re[i] = t[i];
  {
    const uint32_t m = mul_lo(re[0], FPC.pinv);
    row_mul(ro, FPC.p + 1, m);
    row_mad(re, FPC.p, m);
    ro[NW - 1] = addc(ro[NW - 1], 0);
  }
#pragma unroll
  for (int i = 1; i < NW; ++i) {
    uint32_t* ev = (i & 1) ? ro : re;
    uint32_t* od = (i & 1) ? re : ro;
    ev[0] = add_cc(ev[0], od[1]);
    const uint32_t m = mul_lo(ev[0], FPC.pinv);
    row_mad_shift(od, FPC.p + 1, m);
    row_mad(ev, FPC.p, m);
    od[NW - 1] = addc(od[NW - 1], 0);
  }
  merge(u, re, ro);
  u[0] = add_cc(u[0], t[NW]);
#pragma unroll
  for (int i = 1; i < NW - 1; ++i) u[i] = addc_cc(u[i], t[NW + i]);
  u[NW - 1] = addc(u[NW - 1], t[2 * NW - 1]);
  fp_reduce_once(r, u);
}

__device__ __forceinline__ void fp_add(Fp& r, const Fp& a, const Fp& b) {
  uint32_t t[NW];
  t[0] = add_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int i = 1; i < NW - 1; ++i) t[i] = addc_cc(a.w[i], b.w[i]);
  t[NW - 1] = addc(a.w[NW - 1], b.w[NW - 1]);  // < 2p < 2^383: no carry
  fp_reduce_once(r, t);
}

__device__ __forceinline__ void fp_sub(Fp& r, const Fp& a, const Fp& b) {
  uint32_t t[NW];
  t[0] = sub_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int i = 1; i < NW; ++i) t[i] = subc_cc(a.w[i], b.w[i]);
  const uint32_t mask = subc(0, 0);  // all ones on borrow: add p back
  r.w[0] = add_cc(t[0], FPC.p[0] & mask);
#pragma unroll
  for (int i = 1; i < NW - 1; ++i) r.w[i] = addc_cc(t[i], FPC.p[i] & mask);
  r.w[NW - 1] = addc(t[NW - 1], FPC.p[NW - 1] & mask);
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
  for (int i = 0; i < NLIMB; ++i, src += stride) {
    acc += (uint64_t)(uint32_t)*src << nb;
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
  fp_mul(a, r2, lo);  // lo·R (lo may reach 2^384: the word operand)
  fp_mul(b, r3, hi);  // hi·2^384·R
  fp_add(r, a, b);
}

// Montgomery form → 33 canonical base-4096 limbs at dst[i·stride].
__device__ __forceinline__ void fp_to_limbs(int32_t* dst, size_t stride,
                                            const Fp& a) {
  Fp s;
  fp_to_std(s, a);
#pragma unroll
  for (int i = 0; i < NLIMB - 1; ++i, dst += stride) {
    const int bit = 12 * i, wi = bit / 32, sh = bit % 32;
    uint32_t v = s.w[wi] >> sh;
    if (sh > 20) v |= s.w[wi + 1] << (32 - sh);
    *dst = (int32_t)(v & 0xfffu);
  }
  *dst = 0;
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
// tensor twin's mod p.  Inlined: the points stay in registers.

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

// acc = acc + q.  The first level's six products run in the order that
// retires the input coordinates soonest (X, then Y, then Z), so fewer
// words are live at once.
__device__ __forceinline__ void pt_add(Pt& acc, const Pt& q) {
  Fp t0, t1, t2, t3, t4, ty, a, b;
  fp_mul(t0, acc.x, q.x);
  fp_add(a, acc.x, acc.y);
  fp_add(b, q.x, q.y);
  fp_mul(t3, a, b);
  fp_add(a, acc.x, acc.z);
  fp_add(b, q.x, q.z);
  fp_mul(ty, a, b);
  fp_mul(t1, acc.y, q.y);
  fp_add(a, acc.y, acc.z);
  fp_add(b, q.y, q.z);
  fp_mul(t4, a, b);
  fp_mul(t2, acc.z, q.z);
  fp_add(a, t0, t1);
  fp_sub(t3, t3, a);  // X1Y2 + X2Y1
  fp_add(a, t1, t2);
  fp_sub(t4, t4, a);  // Y1Z2 + Y2Z1
  fp_add(a, t0, t2);
  fp_sub(ty, ty, a);  // X1Z2 + X2Z1
  fp_add(a, t0, t0);
  fp_add(t0, a, t0);     // 3·X1X2
  fp_small<12>(t2, t2);  // 3b·Z1Z2
  fp_add(b, t1, t2);     // Z3 before its product
  fp_sub(t1, t1, t2);
  fp_small<12>(ty, ty);
  fp_mul(acc.x, t3, t1);
  fp_mul(a, t4, ty);
  fp_sub(acc.x, acc.x, a);
  fp_mul(acc.y, t1, b);
  fp_mul(a, ty, t0);
  fp_add(acc.y, acc.y, a);
  fp_mul(acc.z, b, t4);
  fp_mul(a, t0, t3);
  fp_add(acc.z, acc.z, a);
}

// acc = 2·acc.
__device__ __forceinline__ void pt_dbl(Pt& acc) {
  Fp t0, t1, t2, Z3, a;
  fp_sqr(t0, acc.y);
  fp_add(Z3, t0, t0);
  fp_add(Z3, Z3, Z3);
  fp_add(Z3, Z3, Z3);  // 8Y²
  fp_mul(t1, acc.y, acc.z);
  fp_mul(a, acc.x, acc.y);
  fp_sqr(t2, acc.z);
  fp_small<12>(t2, t2);  // 3bZ²
  fp_mul(acc.x, t2, Z3);
  fp_add(acc.y, t0, t2);
  fp_mul(acc.z, t1, Z3);  // 8Y³Z
  fp_add(t1, t2, t2);
  fp_add(t2, t1, t2);  // 9bZ²
  fp_sub(t0, t0, t2);
  fp_mul(t1, t0, acc.y);
  fp_add(acc.y, acc.x, t1);
  fp_mul(acc.x, t0, a);
  fp_add(acc.x, acc.x, acc.x);
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
