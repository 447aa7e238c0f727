// map.cu — kernel K1: per pair (u0, u1), two simplified-SWU maps onto the
// 11-isogenous curve E′ (RFC 9380 F.2, straight-line form), one complete
// E′ addition (Renes–Costello–Batina Alg. 1, a = A′) and the 11-isogeny
// back to E.  The output is the uncleared projective point on E.
//
// Replaces the JAX package's fused Pallas map (cess_tpu/ops/h2c.py,
// _map_tile_kernel).  That kernel ran the t^((p−3)/4) chain of each
// square root in place (pow_hook).  Here the map runs in two phases
// around a launch of kernel K4 (powc1.cu) over all 2N field elements:
//
//   map_front  (one thread per u)    u → SSWU up to the chain's input
//                                    u′·v′³, plus six values the back
//                                    phase needs, kept in Montgomery form
//                                    in a scratch buffer;
//   K4         (one thread per u)    the chain: 484 Fp products per u,
//                                    ≈ 970 of the ≈ 1,150 per pair;
//   map_back   (one thread per pair) the rest of both square roots and
//                                    maps, the E′ add and the isogeny.
//
// Every phase is bound by integer multiply-adds; the scratch costs 6 Fp
// elements per u of device-memory traffic, small beside the arithmetic.
// The predicates the straight-line form needs are taken on canonical
// values: is-square compares fully reduced Montgomery words (equal iff
// equal mod p), sgn0 converts out of Montgomery form first, and the
// isogeny's Z = 0 test makes the output exactly (0 : 1 : 0).
#include "fp381.cuh"

struct MapConsts {
  uint32_t a[NW];   // A′
  uint32_t b[NW];   // B′
  uint32_t b3[NW];  // 3·B′
  uint32_t z[NW];   // Z = 11 as a field element
  uint32_t c2[NW];  // sqrt(−Z)
  // isogeny coefficient rows, low degree first: X_NUM (12), X_DEN (11),
  // Y_NUM (16), Y_DEN (16)
  uint32_t iso[55][NW];
};

#define ISO_XNUM 0
#define ISO_XDEN 12
#define ISO_YNUM 23
#define ISO_YDEN 39

__constant__ MapConsts MC;

#define N_SCRATCH 6  // tv1, tv3, tv4, t2 (= u′), tv6 (= v′), u′·v′

__device__ __forceinline__ void scratch_store(uint32_t* s, int k,
                                              size_t lane, size_t m,
                                              const Fp& a) {
#pragma unroll
  for (int i = 0; i < NW; ++i) s[((size_t)k * NW + i) * m + lane] = a.w[i];
}

__device__ __forceinline__ void scratch_load(Fp& a, const uint32_t* s, int k,
                                             size_t lane, size_t m) {
#pragma unroll
  for (int i = 0; i < NW; ++i) a.w[i] = s[((size_t)k * NW + i) * m + lane];
}

// u: (33, 2N) limbs (the (33, 2, N) layout read flat); exc: (2N,).
__global__ void __launch_bounds__(128)
    map_front_kernel(const int32_t* __restrict__ U,
                     const int32_t* __restrict__ EXC, int32_t* powin,
                     uint32_t* scratch, long long m) {
  long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= m) return;
  Fp u, tv1, tv2, tv3, tv4, tv5, tv6, t2, a, c;
  fp_from_limbs(u, U + lane, (size_t)m);
  fp_sqr(a, u);
  fp_small<11>(tv1, a);  // Z·u²
  fp_sqr(a, tv1);
  fp_add(tv2, a, tv1);  // Z²u⁴ + Zu²
  fp_one(a);
  fp_add(a, tv2, a);
  fp_load(c, MC.b);
  fp_mul(tv3, a, c);  // B(tv2 + 1)
  if (EXC[lane] == 1) {
    fp_load(tv4, MC.z);
  } else {
    fp_neg(tv4, tv2);
  }
  fp_load(c, MC.a);
  fp_mul(tv4, tv4, c);
  fp_sqr(t2, tv3);
  fp_sqr(tv6, tv4);
  fp_mul(tv5, tv6, c);
  fp_add(a, t2, tv5);
  fp_mul(t2, a, tv3);
  fp_mul(tv6, tv6, tv4);  // tv4³
  fp_load(c, MC.b);
  fp_mul(tv5, tv6, c);
  fp_add(t2, t2, tv5);  // g(x1)·tv4³
  // sqrt_ratio(t2, tv6), up to the chain's input u′·v′³
  Fp uv;
  fp_sqr(a, tv6);
  fp_mul(uv, t2, tv6);
  fp_mul(a, a, uv);
  fp_to_limbs(powin + lane, (size_t)m, a);
  scratch_store(scratch, 0, (size_t)lane, (size_t)m, tv1);
  scratch_store(scratch, 1, (size_t)lane, (size_t)m, tv3);
  scratch_store(scratch, 2, (size_t)lane, (size_t)m, tv4);
  scratch_store(scratch, 3, (size_t)lane, (size_t)m, t2);
  scratch_store(scratch, 4, (size_t)lane, (size_t)m, tv6);
  scratch_store(scratch, 5, (size_t)lane, (size_t)m, uv);
}

// The rest of one SSWU map for u-lane `l`: returns (x : y·tv4 : tv4) on E′.
__device__ __noinline__ void sswu_tail(Pt& r, const int32_t* U,
                                       const int32_t* SGN,
                                       const int32_t* powout,
                                       const uint32_t* scratch, size_t l,
                                       size_t m) {
  Fp u, tv1, tv3, tv4, t2, tv6, uv, pw, y1, y2, a, c, x, y;
  fp_from_limbs(u, U + l, m);
  scratch_load(tv1, scratch, 0, l, m);
  scratch_load(tv3, scratch, 1, l, m);
  scratch_load(tv4, scratch, 2, l, m);
  scratch_load(t2, scratch, 3, l, m);
  scratch_load(tv6, scratch, 4, l, m);
  scratch_load(uv, scratch, 5, l, m);
  fp_from_limbs(pw, powout + l, m);
  // sqrt_ratio tail
  fp_mul(y1, pw, uv);
  fp_load(c, MC.c2);
  fp_mul(y2, y1, c);
  fp_sqr(a, y1);
  fp_mul(a, a, tv6);
  const bool is_qr = fp_eq(a, t2);
  fp_select(y1, is_qr, y1, y2);
  // SSWU tail
  fp_mul(x, tv1, tv3);
  fp_mul(a, tv1, u);
  fp_mul(y, a, y1);
  fp_select(x, is_qr, tv3, x);
  fp_select(y, is_qr, y1, y);
  if (SGN[l] != fp_parity(y)) fp_neg(y, y);
  r.x = x;
  fp_mul(r.y, y, tv4);
  r.z = tv4;
}

// Complete projective addition on E′ (RCB 2016 Alg. 1, a = A′).
__device__ __noinline__ void pt_add_aprime(Pt& r, const Pt& p, const Pt& q) {
  Fp t0, t1, t2, t3, t4, t5, a, b, ac, b3c, X3, Y3, Z3;
  fp_load(ac, MC.a);
  fp_load(b3c, MC.b3);
  fp_mul(t0, p.x, q.x);
  fp_mul(t1, p.y, q.y);
  fp_mul(t2, p.z, q.z);
  fp_add(a, p.x, p.y);
  fp_add(b, q.x, q.y);
  fp_mul(t3, a, b);
  fp_add(a, t0, t1);
  fp_sub(t3, t3, a);
  fp_add(a, p.x, p.z);
  fp_add(b, q.x, q.z);
  fp_mul(t4, a, b);
  fp_add(a, t0, t2);
  fp_sub(t4, t4, a);
  fp_add(a, p.y, p.z);
  fp_add(b, q.y, q.z);
  fp_mul(t5, a, b);
  fp_add(a, t1, t2);
  fp_sub(t5, t5, a);
  fp_mul(Z3, t4, ac);
  fp_mul(X3, t2, b3c);
  fp_add(Z3, X3, Z3);
  fp_sub(X3, t1, Z3);
  fp_add(Z3, t1, Z3);
  fp_mul(Y3, X3, Z3);
  fp_add(a, t0, t0);
  fp_add(t1, a, t0);
  fp_mul(t2, t2, ac);
  fp_mul(t4, t4, b3c);
  fp_add(t1, t1, t2);
  fp_sub(t2, t0, t2);
  fp_mul(t2, t2, ac);
  fp_add(t4, t4, t2);
  fp_mul(t0, t1, t4);
  fp_add(Y3, Y3, t0);
  fp_mul(t0, t5, t4);
  fp_mul(X3, t3, X3);
  fp_sub(X3, X3, t0);
  fp_mul(t0, t3, t1);
  fp_mul(Z3, t5, Z3);
  fp_add(Z3, Z3, t0);
  r.x = X3;
  r.y = Y3;
  r.z = Z3;
}

// Homogenised Horner over the coefficient row block at `off`:
// acc = k_deg·X + k_{deg−1}·Z, then acc = acc·X + Z^(deg−i)·k_i for
// i = deg−2 … 0.
__device__ __forceinline__ void horner(Fp& r, int off, int deg, const Fp& X,
                                       const Fp* zpow) {
  Fp acc, a, c;
  fp_load(c, MC.iso[off + deg]);
  fp_mul(acc, X, c);
  fp_load(c, MC.iso[off + deg - 1]);
  fp_mul(a, zpow[1], c);
  fp_add(acc, acc, a);
#pragma unroll 1
  for (int i = deg - 2; i >= 0; --i) {
    fp_mul(acc, acc, X);
    fp_load(c, MC.iso[off + i]);
    fp_mul(a, zpow[deg - i], c);
    fp_add(acc, acc, a);
  }
  r = acc;
}

// sgn: (2N,); powout: (33, 2N) limbs from K4; out: (33, N) each.
__global__ void __launch_bounds__(128)
    map_back_kernel(const int32_t* __restrict__ U,
                    const int32_t* __restrict__ SGN,
                    const int32_t* __restrict__ powout,
                    const uint32_t* __restrict__ scratch, int32_t* oX,
                    int32_t* oY, int32_t* oZ, long long n) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const size_t m = 2 * (size_t)n;
  Pt p0, p1, e;
  sswu_tail(p0, U, SGN, powout, scratch, (size_t)j, m);
  sswu_tail(p1, U, SGN, powout, scratch, (size_t)j + n, m);
  pt_add_aprime(e, p0, p1);
  // 11-isogeny E′ → E
  Fp zpow[16];
  zpow[1] = e.z;
#pragma unroll 1
  for (int k = 2; k < 16; ++k) fp_mul(zpow[k], zpow[k - 1], e.z);
  Fp xn, xd, yn, yd, a;
  horner(xn, ISO_XNUM, 11, e.x, zpow);
  horner(xd, ISO_XDEN, 10, e.x, zpow);
  horner(yn, ISO_YNUM, 15, e.x, zpow);
  horner(yd, ISO_YDEN, 15, e.x, zpow);
  Pt out;
  fp_mul(out.x, xn, yd);
  fp_mul(a, e.y, yn);
  fp_mul(out.y, a, xd);
  fp_mul(a, e.z, xd);
  fp_mul(out.z, a, yd);
  if (fp_is_zero(out.z)) pt_inf(out);
  pt_store(oX, oY, oZ, (size_t)j, (size_t)n, out);
}

extern "C" int cess_consts_words(void) {
  return CESS_FP_WORDS + (int)(sizeof(MapConsts) / 4);
}

extern "C" int cess_init(const uint32_t* words, int nwords) {
  if (nwords != cess_consts_words()) return -1;
  int e = cess_upload_fp(words);
  if (e) return e;
  e = (int)cudaMemcpyToSymbol(MC, words + CESS_FP_WORDS, sizeof(MapConsts));
  if (e) return e;
  return (int)cudaDeviceSynchronize();
}

extern "C" int cess_scratch_words(void) { return N_SCRATCH * NW; }

// n pairs: u (33, 2, n), exc (2, n) → powin (33, 2n), scratch (72, 2n).
extern "C" int cess_map_front(const int32_t* U, const int32_t* EXC,
                              int32_t* powin, uint32_t* scratch, long long n,
                              void* stream) {
  if (n <= 0) return 0;
  const long long m = 2 * n;
  const int t = cess_threads(m);
  map_front_kernel<<<cess_blocks(m, t), t, 0, (cudaStream_t)stream>>>(
      U, EXC, powin, scratch, m);
  return (int)cudaGetLastError();
}

extern "C" int cess_map_back(const int32_t* U, const int32_t* SGN,
                             const int32_t* powout, const uint32_t* scratch,
                             int32_t* oX, int32_t* oY, int32_t* oZ,
                             long long n, void* stream) {
  if (n <= 0) return 0;
  const int t = cess_threads(n);
  map_back_kernel<<<cess_blocks(n, t), t, 0, (cudaStream_t)stream>>>(
      U, SGN, powout, scratch, oX, oY, oZ, n);
  return (int)cudaGetLastError();
}
