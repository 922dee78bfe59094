// Three nearest neighbours for Hopper (sm_90a).
//
// Replaces vlp3d/ops/interpolate.py::three_nn (an XLA op that builds the
// whole (B, n, m) distance matrix and takes three masked minima). For
// each unknown point: the three known points with the smallest squared
// distance, ascending, lowest index on ties, where d^2 is
// (dx*dx + dy*dy) + dz*dz in round-to-nearest without FMA contraction.
//
// What bounds it on the H100: arithmetic, n*m distance tests of ~8 flops
// with nothing to reuse but the known points; no (B, n, m) matrix is
// ever written. One thread owns one unknown point and keeps its top 3 in
// registers; a block stages the known points through shared memory a
// tile at a time, so each known point is read from device memory once a
// block. Strict < on insertion keeps the earlier (lower) index on ties.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;  // known points staged per pass (12 KB)

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

__global__ void __launch_bounds__(kThreads)
    three_nn_kernel(const float* __restrict__ unknown,
                    const float* __restrict__ known, int n, int m,
                    float* __restrict__ dist2, int* __restrict__ idx) {
  __shared__ float tile[kTile * 3];
  const int b = blockIdx.y;
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
        const int j = t0 + s;
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
    }
    __syncthreads();
  }
  if (active) {
    const size_t o = ((size_t)b * n + i) * 3;
    dist2[o] = d0; dist2[o + 1] = d1; dist2[o + 2] = d2;
    idx[o] = i0;   idx[o + 1] = i1;   idx[o + 2] = i2;
  }
}

}  // namespace

extern "C" {

// unknown: (b, n, 3) f32; known: (b, m, 3) f32, m >= 3;
// dist2: (b, n, 3) f32; idx: (b, n, 3) i32.
int vlp3d_three_nn(const void* unknown, const void* known, int b, int n,
                   int m, void* dist2, void* idx, void* stream) {
  dim3 grid((n + kThreads - 1) / kThreads, b);
  three_nn_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)unknown, (const float*)known, n, m, (float*)dist2,
      (int*)idx);
  return (int)cudaGetLastError();
}

}  // extern "C"
