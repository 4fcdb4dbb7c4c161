// K1: fixed Newton inversion of the order-p tensor GLL map over
// (point, element) rows grouped by element, one thread per row, the
// block's element lattices staged in shared memory.
//
// Replaces the Pallas TPU kernels of the JAX package, search/pallas_newton.py
// :: newton_refs_rows (K1, every round of the locate ladder) and
// :: newton_refs (K3, the scan retry of crowded-out rows, which calls this
// kernel once per candidate column, and the trilinear prefilter, which
// calls it at order 1 on the element corners).
//
// Contract, as the TPU kernel's: the point is centred and scaled into the
// element's unit frame, p_c = (p - ctr[e]) * inv_scale[e] (here in f64,
// then cast to f32 -- the card has native f64, so the split-f32 centring
// of the TPU path is not needed), then `iters` Newton steps from ref = 0
// run in f32 on the element's f32 unit-frame lattice: 3x3 / 2x2 adjugate
// solve, det == 0 gives a zero step, a non-finite step is zeroed, refs
// are clamped to +/- clamp.  Outputs are the refs and the max-abs
// residual at the last iterate.  An out-of-range element id writes NaN
// refs and residual (never converged) instead of reading out of bounds.
//
// Rows are visited in the order `perm` gives; thread t of block b solves
// row perm[b * 128 + t] and writes its refs and residual back at that
// row, so the caller's order is kept and no gathered copy of the points
// is made.  Any permutation gives the same results, bit for bit; grouping
// only makes them cheap.  mmt_group_rows builds the grouping permutation
// with a counting sort over E + 1 bins (bin E takes every out-of-range
// id): a histogram, an exclusive scan, a scatter, with one atomic per
// run of equal ids in a warp (so rows already grouped do not queue on one
// address); the order of rows inside a bin is whatever the atomics give.
// The scan runs over tiles of kScanTile bins, one block each, then over
// the tiles' totals: its cost must not grow with a thread's share of E + 1,
// since every launch pays it, the 8,192-row rescue launches of a
// 500,000-element source included (one block walking all bins took 0.74 ms
// there on an H100, four times such a launch's Newton kernel).
//
// What bounds it on Hopper: FMA issue.  Grouped, the 128 rows of a block
// share a few elements (~3 in the ladder's first round: 64 rows per
// element on average), so the block copies those lattices once into
// shared memory, coalesced (4-byte loads: an element's lattice row, 1,500
// bytes at order 4, 3-D, is not 16-byte aligned), as one float4 (float2
// in 2-D) per node, and every node read in the solve is a warp-uniform
// LDS.128 broadcast instead of three scattered 4-byte L1/L2 reads per
// row (the slots are assigned by grouping.cuh, shared with K4 and K5).  A
// row whose element found no slot (more than kSlots distinct elements in
// a block, as in sparse rescue rounds or an ungrouped order) reads its
// lattice from global memory with the same arithmetic, so its results are
// bit for bit those of a slot.  The map and Jacobian are
// evaluated by sum factorisation -- over k: A = sum l2 v, B = sum dl2 v
// per (i, j, a);
// over j: AA, AB, BA; over i: x and J -- 1,035 FMAs a step at order 4,
// 3-D where the direct form takes ~2,000; the 1-D Lagrange values and
// derivatives come from prefix and suffix products, with the GLL nodes
// and barycentric weights as compile-time constants.  The outer node
// axis stays rolled, so the order-4 body stays far from the 255-register
// ceiling.  Bytes are not the limit: a 262,144-row launch moves ~18 MB.
// At order 1 (8 nodes, the scan's prefilter) the arithmetic is small and
// the rows' own reads and writes, at scattered rows once grouped, and the
// counting sort's atomics take most of the time instead.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "grouping.cuh"

namespace {

using mmt_grouping::kBlockRows;
constexpr int kSlotBytes = 32768;  // shared memory for staged lattices

// GLL nodes x_i and barycentric weights w_i = 1 / prod_{j != i}(x_i - x_j)
// (multimesh_tpu_torch/core/gll.py), as f32 like the TPU kernel's tables.
template <int ORDER> struct Gll;

template <> struct Gll<1> {
  __device__ __forceinline__ static float x(int i) {
    switch (i) {
      case 0: return (float)-1.0;
      default: return (float)1.0;
    }
  }
  __device__ __forceinline__ static float w(int i) {
    switch (i) {
      case 0: return (float)-0.5;
      default: return (float)0.5;
    }
  }
};

template <> struct Gll<2> {
  __device__ __forceinline__ static float x(int i) {
    switch (i) {
      case 0: return (float)-1.0;
      case 1: return (float)0.0;
      default: return (float)1.0;
    }
  }
  __device__ __forceinline__ static float w(int i) {
    switch (i) {
      case 0: return (float)0.5;
      case 1: return (float)-1.0;
      default: return (float)0.5;
    }
  }
};

template <> struct Gll<3> {
  __device__ __forceinline__ static float x(int i) {
    switch (i) {
      case 0: return (float)-1.0;
      case 1: return (float)-0.4472135954999579;
      case 2: return (float)0.4472135954999579;
      default: return (float)1.0;
    }
  }
  __device__ __forceinline__ static float w(int i) {
    switch (i) {
      case 0: return (float)-0.625;
      case 1: return (float)1.3975424859373684;
      case 2: return (float)-1.3975424859373684;
      default: return (float)0.625;
    }
  }
};

template <> struct Gll<4> {
  __device__ __forceinline__ static float x(int i) {
    switch (i) {
      case 0: return (float)-1.0;
      case 1: return (float)-0.6546536707079771;
      case 2: return (float)0.0;
      case 3: return (float)0.6546536707079771;
      default: return (float)1.0;
    }
  }
  __device__ __forceinline__ static float w(int i) {
    switch (i) {
      case 0: return (float)0.8749999999999999;
      case 1: return (float)-2.041666666666667;
      case 2: return (float)2.333333333333334;
      case 3: return (float)-2.0416666666666665;
      default: return (float)0.8749999999999999;
    }
  }
};

template <> struct Gll<5> {
  __device__ __forceinline__ static float x(int i) {
    switch (i) {
      case 0: return (float)-1.0;
      case 1: return (float)-0.7650553239294647;
      case 2: return (float)-0.2852315164806451;
      case 3: return (float)0.2852315164806451;
      case 4: return (float)0.7650553239294647;
      default: return (float)1.0;
    }
  }
  __device__ __forceinline__ static float w(int i) {
    switch (i) {
      case 0: return (float)-1.3125;
      case 1: return (float)3.1272565826974357;
      case 2: return (float)-3.7864830338951148;
      case 3: return (float)3.786483033895115;
      case 4: return (float)-3.1272565826974352;
      default: return (float)1.3125000000000002;
    }
  }
};

template <> struct Gll<6> {
  __device__ __forceinline__ static float x(int i) {
    switch (i) {
      case 0: return (float)-1.0;
      case 1: return (float)-0.830223896278567;
      case 2: return (float)-0.46884879347071423;
      case 3: return (float)0.0;
      case 4: return (float)0.46884879347071423;
      case 5: return (float)0.830223896278567;
      default: return (float)1.0;
    }
  }
  __device__ __forceinline__ static float w(int i) {
    switch (i) {
      case 0: return (float)2.0625;
      case 1: return (float)-4.972869706086958;
      case 2: return (float)6.210369706086957;
      case 3: return (float)-6.6;
      case 4: return (float)6.210369706086957;
      case 5: return (float)-4.972869706086958;
      default: return (float)2.0625000000000004;
    }
  }
};

template <> struct Gll<7> {
  __device__ __forceinline__ static float x(int i) {
    switch (i) {
      case 0: return (float)-1.0;
      case 1: return (float)-0.8717401485096066;
      case 2: return (float)-0.5917001814331423;
      case 3: return (float)-0.20929921790247885;
      case 4: return (float)0.20929921790247885;
      case 5: return (float)0.5917001814331423;
      case 6: return (float)0.8717401485096066;
      default: return (float)1.0;
    }
  }
  __device__ __forceinline__ static float w(int i) {
    switch (i) {
      case 0: return (float)-3.3515624999999996;
      case 1: return (float)8.140722718253864;
      case 2: return (float)-10.358136828950462;
      case 3: return (float)11.389813748486596;
      case 4: return (float)-11.389813748486597;
      case 5: return (float)10.358136828950459;
      case 6: return (float)-8.140722718253866;
      default: return (float)3.3515624999999987;
    }
  }
};

// Cardinal values l_i(t) = w_i P_i S_i and derivatives l_i'(t), from the
// prefix products P_i = prod_{j<i}(t - x_j), the suffix products
// S_i = prod_{j>i}(t - x_j) and their derivatives, fully unrolled.
template <int ORDER>
__device__ __forceinline__ void lagrange(float t, float (&l)[ORDER + 1],
                                         float (&dl)[ORDER + 1]) {
  constexpr int N1 = ORDER + 1;
  float d[N1], P[N1], dP[N1], S[N1], dS[N1];
#pragma unroll
  for (int j = 0; j < N1; ++j) d[j] = t - Gll<ORDER>::x(j);
  P[1] = d[0];
  dP[1] = 1.0f;
#pragma unroll
  for (int i = 2; i < N1; ++i) {
    P[i] = P[i - 1] * d[i - 1];
    dP[i] = fmaf(dP[i - 1], d[i - 1], P[i - 1]);
  }
  S[N1 - 2] = d[N1 - 1];
  dS[N1 - 2] = 1.0f;
#pragma unroll
  for (int i = N1 - 3; i >= 0; --i) {
    S[i] = S[i + 1] * d[i + 1];
    dS[i] = fmaf(dS[i + 1], d[i + 1], S[i + 1]);
  }
  l[0] = Gll<ORDER>::w(0) * S[0];
  dl[0] = Gll<ORDER>::w(0) * dS[0];
#pragma unroll
  for (int i = 1; i < N1 - 1; ++i) {
    l[i] = Gll<ORDER>::w(i) * (P[i] * S[i]);
    dl[i] = Gll<ORDER>::w(i) * fmaf(dP[i], S[i], P[i] * dS[i]);
  }
  l[N1 - 1] = Gll<ORDER>::w(N1 - 1) * P[N1 - 1];
  dl[N1 - 1] = Gll<ORDER>::w(N1 - 1) * dP[N1 - 1];
}

// a[i] for a runtime i without spilling the register array to local memory
template <int N>
__device__ __forceinline__ float pick(const float (&a)[N], int i) {
  float v = a[0];
#pragma unroll
  for (int q = 1; q < N; ++q)
    if (i == q) v = a[q];
  return v;
}

// One node per float4 (x, y, z, unused) in 3-D, per float2 in 2-D.
template <int ORDER, int DIM> struct Shape {
  static constexpr int N1 = ORDER + 1;
  static constexpr int kNodes = DIM == 3 ? N1 * N1 * N1 : N1 * N1;
  using Vec = std::conditional_t<DIM == 3, float4, float2>;
  static constexpr int kSlots =
      mmt_grouping::slots_for(kSlotBytes, kNodes * (int)sizeof(Vec));
};

// A lattice staged in shared memory: one wide load per node.
template <int DIM> struct SharedLattice {
  const std::conditional_t<DIM == 3, float4, float2>* p;
  __device__ __forceinline__ void node(int m, float (&v)[DIM]) const {
    if constexpr (DIM == 3) {
      const float4 q = p[m];
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
    } else {
      const float2 q = p[m];
      v[0] = q.x;
      v[1] = q.y;
    }
  }
};

// A lattice row in global memory (layout m * DIM + a).
template <int DIM> struct GlobalLattice {
  const float* __restrict__ p;
  __device__ __forceinline__ void node(int m, float (&v)[DIM]) const {
#pragma unroll
    for (int a = 0; a < DIM; ++a) v[a] = __ldg(p + m * DIM + a);
  }
};

// x(ref) and, with JAC, J[a][b] = dx_a/dref_b over all lattice nodes
// (canonical row-major node order, axis 0 outermost), sum-factorised.
template <int ORDER, int DIM, bool JAC, class Lattice>
__device__ __forceinline__ void eval_map(const Lattice& lat,
                                         const float (&l)[DIM][ORDER + 1],
                                         const float (&dl)[DIM][ORDER + 1],
                                         float (&x)[DIM],
                                         float (&J)[DIM][DIM]) {
  constexpr int N1 = ORDER + 1;
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    x[a] = 0.0f;
#pragma unroll
    for (int b = 0; b < DIM; ++b) J[a][b] = 0.0f;
  }
#pragma unroll 1
  for (int i = 0; i < N1; ++i) {
    const float l0 = pick(l[0], i);
    const float d0 = pick(dl[0], i);
    // A over the last axis (3-D: then folded over j), per coordinate a
    float AA[DIM], AB[DIM], BA[DIM];
#pragma unroll
    for (int a = 0; a < DIM; ++a) AA[a] = AB[a] = BA[a] = 0.0f;
    if constexpr (DIM == 3) {
#pragma unroll
      for (int j = 0; j < N1; ++j) {
        float A[3], B[3];
#pragma unroll
        for (int k = 0; k < N1; ++k) {
          float v[3];
          lat.node((i * N1 + j) * N1 + k, v);
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            A[a] = k == 0 ? l[2][0] * v[a] : fmaf(l[2][k], v[a], A[a]);
            if constexpr (JAC)
              B[a] = k == 0 ? dl[2][0] * v[a] : fmaf(dl[2][k], v[a], B[a]);
          }
        }
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          AA[a] = fmaf(l[1][j], A[a], AA[a]);
          if constexpr (JAC) {
            AB[a] = fmaf(l[1][j], B[a], AB[a]);
            BA[a] = fmaf(dl[1][j], A[a], BA[a]);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        x[a] = fmaf(l0, AA[a], x[a]);
        if constexpr (JAC) {
          J[a][0] = fmaf(d0, AA[a], J[a][0]);
          J[a][1] = fmaf(l0, BA[a], J[a][1]);
          J[a][2] = fmaf(l0, AB[a], J[a][2]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < N1; ++j) {
        float v[2];
        lat.node(i * N1 + j, v);
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          AA[a] = fmaf(l[1][j], v[a], AA[a]);
          if constexpr (JAC) AB[a] = fmaf(dl[1][j], v[a], AB[a]);
        }
      }
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        x[a] = fmaf(l0, AA[a], x[a]);
        if constexpr (JAC) {
          J[a][0] = fmaf(d0, AA[a], J[a][0]);
          J[a][1] = fmaf(l0, AB[a], J[a][1]);
        }
      }
    }
  }
}

// `iters` Newton steps from ref = 0 for the unit-frame point p, then the
// max-abs residual at the last iterate.
template <int ORDER, int DIM, class Lattice>
__device__ __forceinline__ void solve(const Lattice& lat,
                                      const float (&p)[DIM], int iters,
                                      float clamp, float (&ref)[DIM],
                                      float& r_max) {
  constexpr int N1 = ORDER + 1;
  float l[DIM][N1], dl[DIM][N1], x[DIM], J[DIM][DIM];
#pragma unroll
  for (int a = 0; a < DIM; ++a) ref[a] = 0.0f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int a = 0; a < DIM; ++a) lagrange<ORDER>(ref[a], l[a], dl[a]);
    eval_map<ORDER, DIM, true>(lat, l, dl, x, J);
    float r[DIM], step[DIM];
#pragma unroll
    for (int a = 0; a < DIM; ++a) r[a] = p[a] - x[a];
    if constexpr (DIM == 3) {
      const float c00 = J[1][1] * J[2][2] - J[1][2] * J[2][1];
      const float c01 = J[0][2] * J[2][1] - J[0][1] * J[2][2];
      const float c02 = J[0][1] * J[1][2] - J[0][2] * J[1][1];
      const float c10 = J[1][2] * J[2][0] - J[1][0] * J[2][2];
      const float c11 = J[0][0] * J[2][2] - J[0][2] * J[2][0];
      const float c12 = J[0][2] * J[1][0] - J[0][0] * J[1][2];
      const float c20 = J[1][0] * J[2][1] - J[1][1] * J[2][0];
      const float c21 = J[0][1] * J[2][0] - J[0][0] * J[2][1];
      const float c22 = J[0][0] * J[1][1] - J[0][1] * J[1][0];
      const float det = J[0][0] * c00 + J[0][1] * c10 + J[0][2] * c20;
      const float inv = det == 0.0f ? 0.0f : 1.0f / det;
      step[0] = (c00 * r[0] + c01 * r[1] + c02 * r[2]) * inv;
      step[1] = (c10 * r[0] + c11 * r[1] + c12 * r[2]) * inv;
      step[2] = (c20 * r[0] + c21 * r[1] + c22 * r[2]) * inv;
    } else {
      const float det = J[0][0] * J[1][1] - J[0][1] * J[1][0];
      const float inv = det == 0.0f ? 0.0f : 1.0f / det;
      step[0] = (J[1][1] * r[0] - J[0][1] * r[1]) * inv;
      step[1] = (J[0][0] * r[1] - J[1][0] * r[0]) * inv;
    }
#pragma unroll
    for (int a = 0; a < DIM; ++a) {
      const float st = isfinite(step[a]) ? step[a] : 0.0f;
      ref[a] = fminf(fmaxf(ref[a] + st, -clamp), clamp);
    }
  }

  // residual at the last iterate, in the unit-element frame
#pragma unroll
  for (int a = 0; a < DIM; ++a) lagrange<ORDER>(ref[a], l[a], dl[a]);
  eval_map<ORDER, DIM, false>(lat, l, dl, x, J);
  r_max = 0.0f;
#pragma unroll
  for (int a = 0; a < DIM; ++a) r_max = fmaxf(r_max, fabsf(p[a] - x[a]));
}

template <int ORDER, int DIM>
__global__ void __launch_bounds__(kBlockRows, 3)
newton_rows_kernel(const double* __restrict__ points,
                   const int* __restrict__ ids,
                   const int* __restrict__ perm,
                   const double* __restrict__ ctr,
                   const double* __restrict__ inv_scale,
                   const float* __restrict__ nodes, int64_t M, int64_t E,
                   int iters, float clamp, float* __restrict__ refs,
                   float* __restrict__ res) {
  using Sh = Shape<ORDER, DIM>;
  using Vec = typename Sh::Vec;
  constexpr int NN = Sh::kNodes;
  constexpr int kSlots = Sh::kSlots;
  static_assert(kSlots >= 1, "one element lattice must fit in kSlotBytes");
  __shared__ Vec lat[kSlots * NN];
  __shared__ mmt_grouping::SlotTable<kSlots> tab;

  const int t = threadIdx.x;
  const int64_t pos = blockIdx.x * (int64_t)kBlockRows + t;
  int64_t row = 0;
  int e = -1;
  if (pos < M) {
    row = perm[pos];
    e = ids[row];
  }
  const bool ok = pos < M && e >= 0 && e < E;
  int staged;
  const int slot = mmt_grouping::assign_slots(tab, e, ok, staged);

  // Stage the slotted lattices: consecutive threads read consecutive
  // floats of an element's row (coalesced) into its node vectors.
  for (int q = t; q < staged * NN * DIM; q += kBlockRows) {
    const int s = q / (NN * DIM);
    const int r = q - s * (NN * DIM);
    const int m = r / DIM;
    const float v = __ldg(nodes + (int64_t)tab.elem[s] * (NN * DIM) + r);
    reinterpret_cast<float*>(&lat[s * NN + m])[r - m * DIM] = v;
  }
  __syncthreads();

  if (pos >= M) return;
  if (!ok) {
#pragma unroll
    for (int a = 0; a < DIM; ++a) refs[row * DIM + a] = NAN;
    res[row] = NAN;
    return;
  }
  const double sc = inv_scale[e];
  float p[DIM], ref[DIM], r_max;
#pragma unroll
  for (int a = 0; a < DIM; ++a)
    p[a] = (float)((points[row * DIM + a] - ctr[(int64_t)e * DIM + a]) * sc);
  if (slot < kSlots) {
    solve<ORDER, DIM>(SharedLattice<DIM>{lat + slot * NN}, p, iters, clamp,
                      ref, r_max);
  } else {
    solve<ORDER, DIM>(GlobalLattice<DIM>{nodes + (int64_t)e * (NN * DIM)},
                      p, iters, clamp, ref, r_max);
  }
#pragma unroll
  for (int a = 0; a < DIM; ++a) refs[row * DIM + a] = ref[a];
  res[row] = r_max;
}

// ---- grouping pre-pass: counting sort of the rows by element id -----------

__device__ __forceinline__ int bin_of(int e, int E) {
  return e >= 0 && e < E ? e : E;
}

// counts[bin] += rows of the bin
__global__ void __launch_bounds__(256)
group_count_kernel(const int* __restrict__ ids, int M, int E,
                   int* __restrict__ counts) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in = row < M;
  const unsigned active = __ballot_sync(0xffffffffu, in);
  if (!in) return;
  const int b = bin_of(ids[row], E);
  const unsigned peers = __match_any_sync(active, b);  // lanes of bin b
  if ((int)(threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(counts + b, __popc(peers));
}

constexpr int kScanThreads = 256;
constexpr int kScanPer = 8;  // consecutive bins of a thread: one 32 B sector
constexpr int kScanTile = kScanThreads * kScanPer;

// counts[tile] -> their exclusive prefix sums within the tile, in place, one
// block a tile; tile_sums[tile] = the tile's total
__global__ void __launch_bounds__(kScanThreads)
group_scan_tiles_kernel(int* __restrict__ counts, int n,
                        int* __restrict__ tile_sums) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int64_t base = (int64_t)blockIdx.x * kScanTile + t * kScanPer;
  int v[kScanPer];
  int sum = 0;
#pragma unroll
  for (int k = 0; k < kScanPer; ++k) {
    v[k] = base + k < n ? counts[base + k] : 0;
    sum += v[k];
  }
  int x = sum;  // inclusive scan of the threads' sums, warp then block
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  int before = 0;
#pragma unroll
  for (int w = 0; w < kScanThreads / 32; ++w)
    before += w < warp ? warp_sums[w] : 0;
  int run = before + x - sum;
#pragma unroll
  for (int k = 0; k < kScanPer; ++k) {
    if (base + k < n) counts[base + k] = run;
    run += v[k];
  }
  if (t == kScanThreads - 1) tile_sums[blockIdx.x] = run;
}

// counts[0..n) -> their exclusive prefix sums, in place, by one block (the
// tiles' totals: 244 of them at 499,201 bins)
__global__ void __launch_bounds__(1024)
group_scan_kernel(int* __restrict__ counts, int n) {
  __shared__ int warp_sums[32];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int per = (n + 1023) / 1024;
  const int lo = t * per < n ? t * per : n;
  const int hi = lo + per < n ? lo + per : n;
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += counts[i];
  int x = sum;  // inclusive scan of the threads' sums, warp then block
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int v = warp_sums[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    warp_sums[lane] = v;
  }
  __syncthreads();
  int run = x - sum + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int c = counts[i];
    counts[i] = run;
    run += c;
  }
}

// perm[tile_start[bin's tile] + cursor[bin]++] = row
__global__ void __launch_bounds__(256)
group_scatter_kernel(const int* __restrict__ ids, int M, int E,
                     int* __restrict__ cursor,
                     const int* __restrict__ tile_start,
                     int* __restrict__ perm) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool in = row < M;
  const unsigned active = __ballot_sync(0xffffffffu, in);
  if (!in) return;
  const int b = bin_of(ids[row], E);
  const unsigned peers = __match_any_sync(active, b);
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if (lane == leader)
    base = atomicAdd(cursor + b, __popc(peers)) + tile_start[b / kScanTile];
  base = __shfl_sync(peers, base, leader);
  perm[base + __popc(peers & ((1u << lane) - 1u))] = row;
}

template <int ORDER, int DIM>
cudaError_t launch(const void* points, const void* ids, const void* perm,
                   const void* ctr, const void* inv_scale, const void* nodes,
                   int64_t M, int64_t E, int iters, float clamp, void* refs,
                   void* res, cudaStream_t stream) {
  const int64_t blocks = (M + kBlockRows - 1) / kBlockRows;
  newton_rows_kernel<ORDER, DIM><<<(unsigned)blocks, kBlockRows, 0, stream>>>(
      static_cast<const double*>(points), static_cast<const int*>(ids),
      static_cast<const int*>(perm), static_cast<const double*>(ctr),
      static_cast<const double*>(inv_scale), static_cast<const float*>(nodes),
      M, E, iters, clamp, static_cast<float*>(refs), static_cast<float*>(res));
  return cudaGetLastError();
}

}  // namespace

extern "C" int mmt_newton_rows(const void* points, const void* ids,
                               const void* perm, const void* ctr,
                               const void* inv_scale, const void* nodes,
                               int64_t M, int64_t E, int order, int dim,
                               int iters, float clamp, void* refs, void* res,
                               void* stream) {
  if (M <= 0) return (int)cudaSuccess;
  if (M > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (order * 10 + dim) {
#define MMT_CASE(O, D) \
    case O * 10 + D: \
      return (int)launch<O, D>(points, ids, perm, ctr, inv_scale, nodes, M, E, \
                               iters, clamp, refs, res, s);
    MMT_CASE(1, 2) MMT_CASE(1, 3) MMT_CASE(2, 2) MMT_CASE(2, 3)
    MMT_CASE(3, 2) MMT_CASE(3, 3) MMT_CASE(4, 2) MMT_CASE(4, 3)
    MMT_CASE(5, 2) MMT_CASE(5, 3) MMT_CASE(6, 2) MMT_CASE(6, 3)
    MMT_CASE(7, 2) MMT_CASE(7, 3)
#undef MMT_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

// Bins of one tile of the grouping's scan: the caller sizes tile_sums by it.
extern "C" int mmt_group_scan_tile() { return kScanTile; }

// counts: E + 1 ints of scratch, tile_sums: n_tiles >= ceil((E + 1) /
// mmt_group_scan_tile()) more.
extern "C" int mmt_group_rows(const void* ids, int64_t M, int64_t E,
                              void* counts, void* tile_sums, int64_t n_tiles,
                              void* perm, void* stream) {
  if (M <= 0) return (int)cudaSuccess;
  const int64_t tiles = (E + 1 + kScanTile - 1) / kScanTile;
  if (M > 0x7fffffff || E < 0 || E >= 0x7fffffff || n_tiles < tiles)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  int* c = static_cast<int*>(counts);
  int* ts = static_cast<int*>(tile_sums);
  const int m = (int)M, e = (int)E;
  const unsigned blocks = (unsigned)((M + 255) / 256);
  cudaError_t err = cudaMemsetAsync(c, 0, (E + 1) * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  group_count_kernel<<<blocks, 256, 0, s>>>(id, m, e, c);
  group_scan_tiles_kernel<<<(unsigned)tiles, kScanThreads, 0, s>>>(c, e + 1,
                                                                   ts);
  group_scan_kernel<<<1, 1024, 0, s>>>(ts, (int)tiles);
  group_scatter_kernel<<<blocks, 256, 0, s>>>(id, m, e, c, ts,
                                              static_cast<int*>(perm));
  return (int)cudaGetLastError();
}

extern "C" const char* mmt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
