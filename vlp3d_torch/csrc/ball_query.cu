// Ball query for Hopper (sm_90a).
//
// Replaces vlp3d/ops/ball_query.py::_ball_query_chunk (the XLA op behind
// ball_query and ball_query_with_count, shaped for the TPU as one-hot
// matmuls over 128-point blocks). Semantics: for each center, the first
// nsample point indices in scan order with d^2 < r^2, where d^2 is
// (dx*dx + dy*dy) + dz*dz in round-to-nearest without FMA contraction;
// slots past the hits repeat the first hit; an empty ball gives zeros.
// With a count output the kernel also returns the uncapped in-ball
// count, and then scans every point.
//
// What bounds it on the H100: the scan. Each center reads points until
// its nsample-th hit (all N with a count), 12 bytes and ~8 flops a
// point, almost all from L2 (a row's points are shared by all its
// centers). One warp takes one center and tests 32 consecutive points a
// step; __ballot_sync plus __popc of the lower lanes gives each hit its
// slot in scan order with no shared memory and no block barrier, and the
// warp stops as soon as nsample hits are placed.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // centers per block

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

__global__ void __launch_bounds__(kWarps * 32)
    ball_query_kernel(const float* __restrict__ xyz,
                      const float* __restrict__ centers, int n, int m,
                      float r2, int nsample, int* __restrict__ idx,
                      int* __restrict__ count) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int b = blockIdx.y;
  if (c >= m) return;  // the whole warp leaves together

  const size_t row = (size_t)b * m + c;
  const float cx = centers[3 * row], cy = centers[3 * row + 1],
              cz = centers[3 * row + 2];
  const float* p = xyz + (size_t)b * n * 3;
  int* out = idx + row * nsample;
  const unsigned below = (1u << lane) - 1u;

  int hits = 0, first = 0;
  for (int base = 0; base < n; base += 32) {
    const int k = base + lane;
    bool in = false;
    if (k < n) {
      in = sq3(__fsub_rn(cx, p[3 * k]), __fsub_rn(cy, p[3 * k + 1]),
               __fsub_rn(cz, p[3 * k + 2])) < r2;
    }
    const unsigned ball = __ballot_sync(0xffffffffu, in);
    if (ball == 0u) continue;
    if (hits == 0) first = base + __ffs(ball) - 1;
    if (in) {
      const int slot = hits + __popc(ball & below);
      if (slot < nsample) out[slot] = k;
    }
    hits += __popc(ball);
    if (count == nullptr && hits >= nsample) break;
  }
  for (int s = min(hits, nsample) + lane; s < nsample; s += 32) out[s] = first;
  if (count != nullptr && lane == 0) count[row] = hits;
}

}  // namespace

extern "C" {

// xyz: (b, n, 3) f32; centers: (b, m, 3) f32; idx: (b, m, nsample) i32;
// count: (b, m) i32, or null for the early-exit form without counts.
int vlp3d_ball_query(const void* xyz, const void* centers, int b, int n,
                     int m, float r2, int nsample, void* idx, void* count,
                     void* stream) {
  dim3 grid((m + kWarps - 1) / kWarps, b);
  ball_query_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const float*)xyz, (const float*)centers, n, m, r2, nsample,
      (int*)idx, (int*)count);
  return (int)cudaGetLastError();
}

}  // extern "C"
