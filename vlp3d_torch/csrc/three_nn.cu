// Three nearest neighbours and the FP module's inverse-distance
// interpolation for Hopper (sm_90a).
//
// Replaces vlp3d/ops/interpolate.py::three_nn (an XLA op that builds the
// whole (B, n, m) distance matrix and takes three masked minima) and,
// fused behind it, ::three_interpolate / ::interpolate_features (a
// take-along-axis gather into a (B, n, 3, C) tensor, a broadcast
// multiply and a sum). For each unknown point: the three known points
// with the smallest squared distance, ascending, lowest index on ties,
// where d^2 is (dx*dx + dy*dy) + dz*dz in round-to-nearest without FMA
// contraction; then, when features are given,
//
//   recip_k = 1 / (sqrt(d2_k) + 1e-8)
//   w_k     = recip_k / ((recip_0 + recip_1) + recip_2)
//   out     = (w_0 * f[i_0] + w_1 * f[i_1]) + w_2 * f[i_2]
//
// each in IEEE round-to-nearest, no contraction: the plain version's
// arithmetic, operation for operation.
//
// What bounds it on the H100: bytes, once the interpolation is fused
// (the known features read and the output rows written; the n*m distance
// tests are a few microseconds of arithmetic at the FP sites). What held
// the first kernel back was neither: one thread a point gave 16 or 32
// blocks at the FP sites, each thread running hundreds of dependent
// compare-and-shift steps on a fraction of the SMs.
//
// three_nn_team_kernel<L, kInterp, V>: a team of L lanes (4 to 32, a
//   power of two, aligned inside a warp) owns one unknown point, and a
//   block holds blockDim.x / L points of one batch row. The row's known
//   points are staged into shared memory as three arrays x[], y[], z[]
//   (a tile at a time when m exceeds the tile), so consecutive lanes read
//   consecutive words and the teams of a warp read the same ones. Lane t
//   scans the known points j = t (mod L) in ascending j and keeps its own
//   top 3 with strict <: on a tie inside a lane the earlier j stays, so a
//   lane's list holds its three smallest under the order (d, then j).
//   log2(L) butterfly steps of __shfl_xor_sync then merge the lanes'
//   lists under that order; the three smallest of the row under (d, j)
//   are exactly what the serial strict-< scan and the JAX op (iterative
//   minimum, lowest index on ties) return. Every list starts as
//   (inf, 0) three times, so a slot that no finite distance fills comes
//   out as (inf, 0). With kInterp the team then computes the weights and
//   each lane writes every L-th unit of the output row (V = float4 where
//   the rows are 16-byte aligned, else float); no (B, n, 3, C) tensor
//   exists. Without kInterp it writes dist2 and idx only.
// three_nn_kernel: the first design, one thread a point, kept as the
//   yardstick that measurements time beside the team kernel.

#include <cuda_runtime.h>

#include "batch_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;  // known points staged per pass (12 KB)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// strict <, for a scan in ascending j: a tie keeps the earlier index
__device__ __forceinline__ void insert3(float d, int j, float& d0, int& i0,
                                        float& d1, int& i1, float& d2,
                                        int& i2) {
  if (d < d0) {
    d2 = d1; i2 = i1;
    d1 = d0; i1 = i0;
    d0 = d;  i0 = j;
  } else if (d < d1) {
    d2 = d1; i2 = i1;
    d1 = d;  i1 = j;
  } else if (d < d2) {
    d2 = d;  i2 = j;
  }
}

// the order (d, then j)
__device__ __forceinline__ bool lex_less(float da, int ja, float db, int jb) {
  return da < db || (da == db && ja < jb);
}

__device__ __forceinline__ void insert3_lex(float d, int j, float& d0,
                                            int& i0, float& d1, int& i1,
                                            float& d2, int& i2) {
  if (lex_less(d, j, d0, i0)) {
    d2 = d1; i2 = i1;
    d1 = d0; i1 = i0;
    d0 = d;  i0 = j;
  } else if (lex_less(d, j, d1, i1)) {
    d2 = d1; i2 = i1;
    d1 = d;  i1 = j;
  } else if (lex_less(d, j, d2, i2)) {
    d2 = d;  i2 = j;
  }
}

__device__ __forceinline__ float vmul(float a, float w) {
  return __fmul_rn(a, w);
}

__device__ __forceinline__ float4 vmul(float4 a, float w) {
  return make_float4(__fmul_rn(a.x, w), __fmul_rn(a.y, w), __fmul_rn(a.z, w),
                     __fmul_rn(a.w, w));
}

__device__ __forceinline__ float vadd(float a, float b) {
  return __fadd_rn(a, b);
}

__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

template <typename T>
__device__ __forceinline__ T pick3(int k, T a, T b, T c) {
  return k == 0 ? a : k == 1 ? b : c;
}

__global__ void __launch_bounds__(kThreads)
    three_nn_kernel(const float* __restrict__ unknown,
                    const float* __restrict__ known, int B, int n, int m,
                    float* __restrict__ dist2, int* __restrict__ idx) {
  __shared__ float tile[kTile * 3];
  const int b = grid_row();
  if (b >= B) return;  // the whole block, before any barrier
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool active = i < n;
  const float* u = unknown + ((size_t)b * n + (active ? i : 0)) * 3;
  const float ux = u[0], uy = u[1], uz = u[2];
  const float* kb = known + (size_t)b * m * 3;
  const float inf = __int_as_float(0x7f800000);

  float d0 = inf, d1 = inf, d2 = inf;
  int i0 = 0, i1 = 0, i2 = 0;
  for (int t0 = 0; t0 < m; t0 += kTile) {
    const int len = min(kTile, m - t0);
    for (int s = threadIdx.x; s < 3 * len; s += kThreads) {
      tile[s] = kb[3 * t0 + s];
    }
    __syncthreads();
    if (active) {
      for (int s = 0; s < len; ++s) {
        const float d = sq3(__fsub_rn(ux, tile[3 * s]),
                            __fsub_rn(uy, tile[3 * s + 1]),
                            __fsub_rn(uz, tile[3 * s + 2]));
        insert3(d, t0 + s, d0, i0, d1, i1, d2, i2);
      }
    }
    __syncthreads();
  }
  if (active) {
    const size_t o = ((size_t)b * n + i) * 3;
    dist2[o] = d0; dist2[o + 1] = d1; dist2[o + 2] = d2;
    idx[o] = i0;   idx[o + 1] = i1;   idx[o + 2] = i2;
  }
}

// Grid: x = groups of blockDim.x / L points, y = batch rows; blockDim.x a
// multiple of 32 and of L. feats: (b, m, units) of V; out: (b, n, units)
// of V; dist2 may be null with kInterp (then only idx, weight and out
// are written).
template <int L, bool kInterp, typename V>
__global__ void __launch_bounds__(1024)
    three_nn_team_kernel(const float* __restrict__ unknown,
                         const float* __restrict__ known,
                         const V* __restrict__ feats, int B, int n, int m,
                         int units, float* __restrict__ dist2,
                         int* __restrict__ idx, float* __restrict__ weight,
                         V* __restrict__ out) {
  __shared__ float sxyz[3][kTile];  // x[], y[], z[]
  const int b = grid_row();
  if (b >= B) return;  // the whole block, before any barrier
  const int lane = threadIdx.x & (L - 1);
  const int i = blockIdx.x * (blockDim.x / L) + threadIdx.x / L;
  const bool active = i < n;
  // a team past the row's end scans the last point: every lane of a warp
  // takes part in the shuffles
  const float* u = unknown + ((size_t)b * n + (active ? i : n - 1)) * 3;
  const float ux = __ldg(u), uy = __ldg(u + 1), uz = __ldg(u + 2);
  const float* kb = known + (size_t)b * m * 3;
  const float inf = __int_as_float(0x7f800000);

  float d0 = inf, d1 = inf, d2 = inf;
  int i0 = 0, i1 = 0, i2 = 0;
  for (int t0 = 0; t0 < m; t0 += kTile) {
    const int len = min(kTile, m - t0);
    // coalesced: consecutive threads read consecutive floats
    for (int s = threadIdx.x; s < 3 * len; s += blockDim.x) {
      const float v = __ldg(kb + 3 * (size_t)t0 + s);
      const int p = s / 3;
      sxyz[s - 3 * p][p] = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int s = lane; s < len; s += L) {
      const float d = sq3(__fsub_rn(ux, sxyz[0][s]),
                          __fsub_rn(uy, sxyz[1][s]),
                          __fsub_rn(uz, sxyz[2][s]));
      insert3(d, t0 + s, d0, i0, d1, i1, d2, i2);
    }
    __syncthreads();
  }

  // butterfly merge inside the team: after the step of distance `off`
  // lanes t and t ^ off hold the three smallest of the same, disjoint
  // union of lanes, so both sides insert the other's list
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) {
    const float e0 = __shfl_xor_sync(kFull, d0, off);
    const float e1 = __shfl_xor_sync(kFull, d1, off);
    const float e2 = __shfl_xor_sync(kFull, d2, off);
    const int j0 = __shfl_xor_sync(kFull, i0, off);
    const int j1 = __shfl_xor_sync(kFull, i1, off);
    const int j2 = __shfl_xor_sync(kFull, i2, off);
    insert3_lex(e0, j0, d0, i0, d1, i1, d2, i2);
    insert3_lex(e1, j1, d0, i0, d1, i1, d2, i2);
    insert3_lex(e2, j2, d0, i0, d1, i1, d2, i2);
  }
  if (!active) return;

  const size_t o = ((size_t)b * n + i) * 3;
  if (!kInterp) {
    if (lane < 3) {
      dist2[o + lane] = pick3(lane, d0, d1, d2);
      idx[o + lane] = pick3(lane, i0, i1, i2);
    }
    return;
  }
  const float r0 = __fdiv_rn(1.0f, __fadd_rn(__fsqrt_rn(d0), 1e-8f));
  const float r1 = __fdiv_rn(1.0f, __fadd_rn(__fsqrt_rn(d1), 1e-8f));
  const float r2 = __fdiv_rn(1.0f, __fadd_rn(__fsqrt_rn(d2), 1e-8f));
  const float sum = __fadd_rn(__fadd_rn(r0, r1), r2);
  const float w0 = __fdiv_rn(r0, sum), w1 = __fdiv_rn(r1, sum),
              w2 = __fdiv_rn(r2, sum);
  if (lane < 3) {
    idx[o + lane] = pick3(lane, i0, i1, i2);
    weight[o + lane] = pick3(lane, w0, w1, w2);
    if (dist2) dist2[o + lane] = pick3(lane, d0, d1, d2);
  }
  const V* f0 = feats + ((size_t)b * m + i0) * units;
  const V* f1 = feats + ((size_t)b * m + i1) * units;
  const V* f2 = feats + ((size_t)b * m + i2) * units;
  V* dst = out + ((size_t)b * n + i) * units;
#pragma unroll 2
  for (int e = lane; e < units; e += L) {
    const V a = __ldg(f0 + e), c = __ldg(f1 + e), g = __ldg(f2 + e);
    dst[e] = vadd(vadd(vmul(a, w0), vmul(c, w1)), vmul(g, w2));
  }
}

template <int L>
void launch_team(const float* unknown, const float* known, const float* feats,
                 int b, int n, int m, int c, int threads, bool vec,
                 float* dist2, int* idx, float* weight, float* out,
                 cudaStream_t s) {
  const int points = threads / L;
  const dim3 grid = rows_grid((n + points - 1) / points, b);
  if (!feats) {
    three_nn_team_kernel<L, false, float><<<grid, threads, 0, s>>>(
        unknown, known, nullptr, b, n, m, 0, dist2, idx, nullptr, nullptr);
  } else if (vec) {
    three_nn_team_kernel<L, true, float4><<<grid, threads, 0, s>>>(
        unknown, known, (const float4*)feats, b, n, m, c / 4, dist2, idx,
        weight, (float4*)out);
  } else {
    three_nn_team_kernel<L, true, float><<<grid, threads, 0, s>>>(
        unknown, known, feats, b, n, m, c, dist2, idx, weight, out);
  }
}

}  // namespace

extern "C" {

// The first design. unknown: (b, n, 3) f32; known: (b, m, 3) f32,
// m >= 3; dist2: (b, n, 3) f32; idx: (b, n, 3) i32.
int vlp3d_three_nn(const void* unknown, const void* known, int b, int n,
                   int m, void* dist2, void* idx, void* stream) {
  const dim3 grid = rows_grid((n + kThreads - 1) / kThreads, b);
  three_nn_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)unknown, (const float*)known, b, n, m, (float*)dist2,
      (int*)idx);
  return (int)cudaGetLastError();
}

// The team kernel: `lanes` a point (4, 8, 16 or 32), `threads` a block (a
// multiple of 32 and of lanes, at most 1024). unknown: (b, n, 3) f32;
// known: (b, m, 3) f32, m >= 3; idx: (b, n, 3) i32. feats null: three-NN
// only, dist2 (b, n, 3) f32 written. feats (b, m, c) f32: the
// interpolation too, into weight (b, n, 3) f32 and out (b, n, c) f32,
// dist2 written only where it is not null; vec != 0 moves float4 units
// (the caller has checked that c is a multiple of 4 and feats and out are
// 16-byte aligned). A plan the kernel does not take comes back as
// cudaErrorInvalidValue, with no launch.
int vlp3d_three_nn_team(const void* unknown, const void* known,
                        const void* feats, int b, int n, int m, int c,
                        int lanes, int threads, int vec, void* dist2,
                        void* idx, void* weight, void* out, void* stream) {
  if (threads < 32 || threads > 1024 || threads % 32 != 0 || b < 1 ||
      n < 1 || m < 1 || (feats && c < 1))
    return (int)cudaErrorInvalidValue;
  const float* u = (const float*)unknown;
  const float* k = (const float*)known;
  const float* f = (const float*)feats;
  float *d = (float*)dist2, *w = (float*)weight, *o = (float*)out;
  int* ix = (int*)idx;
  cudaStream_t s = (cudaStream_t)stream;
  switch (lanes) {
    case 4:
      launch_team<4>(u, k, f, b, n, m, c, threads, vec, d, ix, w, o, s);
      break;
    case 8:
      launch_team<8>(u, k, f, b, n, m, c, threads, vec, d, ix, w, o, s);
      break;
    case 16:
      launch_team<16>(u, k, f, b, n, m, c, threads, vec, d, ix, w, o, s);
      break;
    case 32:
      launch_team<32>(u, k, f, b, n, m, c, threads, vec, d, ix, w, o, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
