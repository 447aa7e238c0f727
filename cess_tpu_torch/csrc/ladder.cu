// ladder.cu — kernel K3: per-lane [s]P by MSB-first double-and-add.
//
// Replaces the JAX package's Pallas ladder (cess_tpu/ops/g1.py,
// _ladder_tile_kernel).  The kernel is bound by integer multiply-adds (8
// Fp products a doubling, 12 an addition), but on the verify path it runs
// only a few thousand lanes (the ρ folds and the subgroup chain [r]σ in
// one 3,072-lane launch): at one lane a thread that is one warp on a
// quarter of the SMs, and the time is the latency of one lane's chain.
//
// Design.  Six threads a lane, five lanes a warp, one warp a block.  Each
// point formula runs as levels of independent products, one product a
// thread: a doubling as 4 + 4 products (Y², YZ, Z², XY; then 24bY²Z²,
// 8Y³Z and the two products with Y² − 9bZ²), an addition as 6 + 6.  The
// lane's accumulator and the level's products live in shared memory and
// pass between levels with __syncwarp; the linear steps between levels
// (additions, ×3, ×12) are computed by every thread of the group, so the
// warp never diverges on them, and pairs of products are combined through
// __shfl_down_sync.  A thread's operand from P is formed once.  The
// squarings Y² and Z² use the general product: a level's threads share
// one code path.
//
// A launch of LAD_WIDE_MIN_LANES lanes or more (prove_batch's grouped
// MSM: 1,024 groups of 64) fills the card one lane a thread, where six
// threads a lane would spend 12 product slots on a doubling's 8; there
// ladder_wide_kernel runs the register formulas of fp381.cuh instead.
// The two cross between 12,288 lanes (six threads a lane faster) and
// 24,576 (one lane a thread faster) on the H100 (PERF.md).
//
// No-op steps are skipped, exactly: the loop starts at the highest bit
// any lane of the warp has set (above it every accumulator is (0 : 1 : 0),
// which a doubling maps to itself word for word), and a bit that no lane
// of the warp has set skips the addition (the select would keep the
// accumulator).  Every coordinate equals the data-oblivious ladder's.
#include "fp381.cuh"

#define LAD_GROUP 6                    // threads a lane
#define LAD_LANES 5                    // lanes a warp (30 of 32 threads)
#define LAD_FULL 0xffffffffu
#define LAD_SLIMBS 22                  // base-4096 scalar limbs
#define LAD_WIDE_MIN_LANES 16384       // from here on, one lane a thread
#define LAD_WIDE_THREADS 128

struct LaneShared {
  uint4 acc[3][3];  // accumulator X, Y, Z (12 words each)
  uint4 r[6][3];    // one level's products
  int32_t s[LAD_SLIMBS];
};

__device__ __forceinline__ void sh_get(Fp& a, const uint4* v) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const uint4 q = v[i];
    a.w[4 * i] = q.x;
    a.w[4 * i + 1] = q.y;
    a.w[4 * i + 2] = q.z;
    a.w[4 * i + 3] = q.w;
  }
}

__device__ __forceinline__ void sh_put(uint4* v, const Fp& a) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    v[i] = make_uint4(a.w[4 * i], a.w[4 * i + 1], a.w[4 * i + 2],
                      a.w[4 * i + 3]);
}

__device__ __forceinline__ void fp_shfl_down(Fp& r, const Fp& a, int d) {
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = __shfl_down_sync(LAD_FULL, a.w[i], d);
}

// The highest set bit below `bits` of the scalar whose limbs are at
// s[l·n], or −1 for a zero scalar.
__device__ __forceinline__ int top_bit(const int32_t* s, long long n,
                                       int bits) {
  for (int l = (bits - 1) / 12; l >= 0; --l) {
    uint32_t v = (uint32_t)s[(size_t)l * n] & 0xfffu;
    const int w = bits - 12 * l;
    if (w < 12) v &= (1u << w) - 1;
    if (v) return 12 * l + 31 - __clz(v);
  }
  return -1;
}

// acc = 2·acc for the group's lane (RCB Alg. 9).
__device__ __forceinline__ void lane_dbl(LaneShared& L, int k) {
  Fp a, b, m;
  fp_zero(m);
  if (k < 4) {  // Y·Y, Y·Z, Z·Z, X·Y
    sh_get(a, L.acc[k == 2 ? 2 : (k == 3 ? 0 : 1)]);
    sh_get(b, L.acc[(k == 0 || k == 3) ? 1 : 2]);
    fp_mul(m, a, b);
    sh_put(L.r[k], m);
  }
  __syncwarp();
  if (k < 4) {
    Fp t0, zz, z8, t2, u, v, o;
    sh_get(t0, L.r[0]);
    sh_get(zz, L.r[2]);
    fp_add(z8, t0, t0);
    fp_add(z8, z8, z8);
    fp_add(z8, z8, z8);    // 8Y²
    fp_small<12>(t2, zz);  // 3bZ²
    fp_add(u, t2, t2);
    fp_add(u, u, t2);
    fp_sub(u, t0, u);  // Y² − 9bZ²
    fp_add(v, t0, t2);  // Y² + 3bZ²
    sh_get(o, L.r[k == 1 ? 1 : 3]);  // YZ for k = 1, XY for k = 3
    // k0: 3bZ²·8Y²   k1: YZ·8Y²   k2: (Y² − 9bZ²)(Y² + 3bZ²)
    // k3: (Y² − 9bZ²)·XY
    fp_select(a, k == 1, o, u);
    fp_select(a, k == 0, t2, a);
    fp_select(b, k == 2, v, o);
    fp_select(b, k <= 1, z8, b);
    fp_mul(m, a, b);
  }
  fp_shfl_down(a, m, 2);
  if (k == 0) {
    fp_add(m, m, a);
    sh_put(L.acc[1], m);
  } else if (k == 1) {
    sh_put(L.acc[2], m);
  } else if (k == 3) {
    fp_add(m, m, m);
    sh_put(L.acc[0], m);
  }
  __syncwarp();
}

// acc = acc + P where `bit` (RCB Alg. 7); `pq` is this thread's operand
// from P: X2, Y2, Z2, X2 + Y2, Y2 + Z2, X2 + Z2 for k = 0…5.
__device__ __forceinline__ void lane_add(LaneShared& L, int k, const Fp& pq,
                                         bool bit) {
  Fp a, b, m;
  fp_zero(m);
  if (k < LAD_GROUP) {
    sh_get(a, L.acc[k < 3 ? k : (k == 4 ? 1 : 0)]);
    if (k >= 3) {
      sh_get(b, L.acc[k == 3 ? 1 : 2]);
      fp_add(a, a, b);
    }
    fp_mul(m, a, pq);
    sh_put(L.r[k], m);
  }
  __syncwarp();
  if (k < LAD_GROUP) {
    Fp t0, t1, t2, c, t3, t4, ty, z3;
    sh_get(t0, L.r[0]);
    sh_get(t1, L.r[1]);
    sh_get(t2, L.r[2]);
    sh_get(c, L.r[3]);
    fp_add(t3, t0, t1);
    fp_sub(t3, c, t3);  // X1Y2 + X2Y1
    sh_get(c, L.r[4]);
    fp_add(t4, t1, t2);
    fp_sub(t4, c, t4);  // Y1Z2 + Y2Z1
    sh_get(c, L.r[5]);
    fp_add(ty, t0, t2);
    fp_sub(ty, c, ty);     // X1Z2 + X2Z1
    fp_small<12>(ty, ty);  // 3b(X1Z2 + X2Z1)
    fp_add(c, t0, t0);
    fp_add(t0, c, t0);     // 3·X1X2
    fp_small<12>(t2, t2);  // 3b·Z1Z2
    fp_add(z3, t1, t2);
    fp_sub(t1, t1, t2);
    // k0: t3·t1  k1: t4·ty  k2: t1·z3  k3: ty·t0  k4: z3·t4  k5: t0·t3
    // (selects by value: a reference picked at run time would put the
    // candidates in the stack frame)
    fp_select(a, k == 4, z3, t0);
    fp_select(a, k == 3, ty, a);
    fp_select(a, k == 2, t1, a);
    fp_select(a, k == 1, t4, a);
    fp_select(a, k == 0, t3, a);
    fp_select(b, k == 4, t4, t3);
    fp_select(b, k == 3, t0, b);
    fp_select(b, k == 2, z3, b);
    fp_select(b, k == 1, ty, b);
    fp_select(b, k == 0, t1, b);
    fp_mul(m, a, b);
  }
  fp_shfl_down(a, m, 1);
  if (bit && (k & 1) == 0 && k < LAD_GROUP) {
    if (k == 0)
      fp_sub(m, m, a);
    else
      fp_add(m, m, a);
    sh_put(L.acc[k >> 1], m);
  }
  __syncwarp();
}

__global__ void __launch_bounds__(32)
    ladder_kernel(const int32_t* __restrict__ X, const int32_t* __restrict__ Y,
                  const int32_t* __restrict__ Z, const int32_t* __restrict__ S,
                  int32_t* oX, int32_t* oY, int32_t* oZ, long long n,
                  int bits) {
  __shared__ LaneShared sh[LAD_LANES];
  const int g = threadIdx.x / LAD_GROUP, k = threadIdx.x % LAD_GROUP;
  const long long lane = (long long)blockIdx.x * LAD_LANES + g;
  const bool live = g < LAD_LANES && lane < n;
  LaneShared& L = sh[g < LAD_LANES ? g : 0];

  // P into r[0..2], the scalar limbs into s, this lane's top set bit
  int top = -1;
  if (live) {
    if (k < 3) {
      Fp c;
      fp_from_limbs(c, (k == 0 ? X : (k == 1 ? Y : Z)) + lane, (size_t)n);
      sh_put(L.r[k], c);
    }
    for (int l = k; l < LAD_SLIMBS; l += LAD_GROUP)
      L.s[l] = S[(size_t)l * n + lane] & 0xfff;
    top = top_bit(S + lane, n, bits);
  }
  __syncwarp();
  Fp pq, c;
  fp_zero(pq);
  if (live) {
    sh_get(pq, L.r[k < 3 ? k : (k == 4 ? 1 : 0)]);
    if (k >= 3) {
      sh_get(c, L.r[k == 3 ? 1 : 2]);
      fp_add(pq, pq, c);
    }
    if (k < 3) {  // acc = (0 : 1 : 0)
      if (k == 1) fp_one(c); else fp_zero(c);
      sh_put(L.acc[k], c);
    }
  }
  __syncwarp();

  const int start = __reduce_max_sync(LAD_FULL, top);
#pragma unroll 1
  for (int j = start; j >= 0; --j) {
    if (j < start) lane_dbl(L, live ? k : LAD_GROUP);
    const bool bit = live && ((L.s[j / 12] >> (j % 12)) & 1);
    if (__ballot_sync(LAD_FULL, bit)) lane_add(L, live ? k : LAD_GROUP, pq, bit);
  }

  if (live && k < 3) {
    sh_get(c, L.acc[k]);
    fp_to_limbs((k == 0 ? oX : (k == 1 ? oY : oZ)) + lane, (size_t)n, c);
  }
}

// One lane a thread, for launches that fill the card on their own, with
// the same skips over a whole warp (a lane without the bit takes no part
// in the addition).
__global__ void __launch_bounds__(LAD_WIDE_THREADS)
    ladder_wide_kernel(const int32_t* __restrict__ X,
                       const int32_t* __restrict__ Y,
                       const int32_t* __restrict__ Z,
                       const int32_t* __restrict__ S, int32_t* oX, int32_t* oY,
                       int32_t* oZ, long long n, int bits) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = lane < n;
  Pt p, acc;
  pt_inf(p);
  pt_inf(acc);
  int top = -1;
  if (live) {
    pt_load(p, X, Y, Z, (size_t)lane, (size_t)n);
    top = top_bit(S + lane, n, bits);
  }
  const int start = __reduce_max_sync(LAD_FULL, top);
#pragma unroll 1
  for (int j = start; j >= 0; --j) {
    if (j < start) pt_dbl(acc);
    if (live && ((S[(size_t)(j / 12) * n + lane] >> (j % 12)) & 1))
      pt_add(acc, p);
  }
  if (live) pt_store(oX, oY, oZ, (size_t)lane, (size_t)n, acc);
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
  if (n >= LAD_WIDE_MIN_LANES) {
    const long long blocks = (n + LAD_WIDE_THREADS - 1) / LAD_WIDE_THREADS;
    ladder_wide_kernel<<<(unsigned)blocks, LAD_WIDE_THREADS, 0,
                         (cudaStream_t)stream>>>(X, Y, Z, S, oX, oY, oZ, n,
                                                 bits);
  } else {
    const long long blocks = (n + LAD_LANES - 1) / LAD_LANES;
    ladder_kernel<<<(unsigned)blocks, 32, 0, (cudaStream_t)stream>>>(
        X, Y, Z, S, oX, oY, oZ, n, bits);
  }
  return (int)cudaGetLastError();
}
