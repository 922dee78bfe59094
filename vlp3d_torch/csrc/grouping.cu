// Row gather and its scatter-add backward for Hopper (sm_90a).
//
// Replaces vlp3d/ops/grouping.py::group_points / gather_points (XLA
// take-along-axis gathers split under a 2^18-row table limit) and their
// backward _group_points_bwd / _gather_points_bwd / _sorted_scatter_add
// (argsort + permute + sorted segment-sum, a TPU device that is not
// carried over).
//
//   forward:  out[b, r, :]            = points[b, idx[b, r], :]
//   backward: dpoints[b, idx[b, r], :] += grad[b, r, :]   (dpoints zeroed)
//
// with r running over the M*K neighbourhood slots of batch row b
// (gather_points is K = 1). Indices must lie in [0, n); one that does not
// is never followed: its output row is zeros and its gradient row is
// dropped.
//
// What bounds both on the H100: bytes. Each output row is written once
// and each source row read at least once; there is no arithmetic. A group
// of `lanes` neighbouring threads (a power of two up to a warp) owns one
// output row and walks its channels, so reads and writes of a row are
// coalesced; where the channel count and the addresses allow it the
// group moves float4 (16 bytes a thread), otherwise single floats (C = 3,
// C = 135). The source may be a view whose rows are `row_stride` floats
// apart (a channel slice of the input cloud), so no copy is made first.
//
// The backward adds with atomicAdd straight into the source rows, as the
// reference's group_points_grad kernel does: colliding rows (a padded
// neighbourhood repeats its first index up to K times) serialise in L2
// and the sum's order changes from launch to launch, so it is exact only
// up to float32 rounding of a reordered sum. The float4 form uses
// Hopper's 16-byte vector atomicAdd (one L2 transaction for 4 channels).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename V>
__device__ __forceinline__ V zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() {
  return 0.0f;
}
template <>
__device__ __forceinline__ float4 zero_of<float4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

__device__ __forceinline__ void atomic_add_vec(float* addr, float v) {
  atomicAdd(addr, v);
}

__device__ __forceinline__ void atomic_add_vec(float4* addr, float4 v) {
#if defined(__CUDACC_VER_MAJOR__) && \
    (__CUDACC_VER_MAJOR__ > 12 ||    \
     (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1))
  atomicAdd(addr, v);
#else
  float* a = reinterpret_cast<float*>(addr);
  atomicAdd(a, v.x);
  atomicAdd(a + 1, v.y);
  atomicAdd(a + 2, v.z);
  atomicAdd(a + 3, v.w);
#endif
}

// V is float or float4; cv, row_stride and batch_stride count V elements.
template <typename V>
__global__ void __launch_bounds__(kThreads)
    group_points_kernel(const V* __restrict__ points,
                        const int* __restrict__ idx, int rows,
                        int rows_per_batch, int cv, int n,
                        long long row_stride, long long batch_stride,
                        int lanes, V* __restrict__ out) {
  const int row = blockIdx.x * (kThreads / lanes) + threadIdx.x / lanes;
  if (row >= rows) return;
  const int lane = threadIdx.x % lanes;
  const int b = row / rows_per_batch;
  const int i = __ldg(idx + row);
  V* dst = out + (long long)row * cv;
  if ((unsigned)i >= (unsigned)n) {
    for (int j = lane; j < cv; j += lanes) dst[j] = zero_of<V>();
    return;
  }
  const V* src = points + b * batch_stride + i * row_stride;
  for (int j = lane; j < cv; j += lanes) dst[j] = __ldg(src + j);
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
    group_points_grad_kernel(const V* __restrict__ grad,
                             const int* __restrict__ idx, int rows,
                             int rows_per_batch, int cv, int n, int lanes,
                             V* __restrict__ dpoints) {
  const int row = blockIdx.x * (kThreads / lanes) + threadIdx.x / lanes;
  if (row >= rows) return;
  const int lane = threadIdx.x % lanes;
  const int b = row / rows_per_batch;
  const int i = __ldg(idx + row);
  if ((unsigned)i >= (unsigned)n) return;
  const V* src = grad + (long long)row * cv;
  V* dst = dpoints + ((long long)b * n + i) * cv;
  for (int j = lane; j < cv; j += lanes) atomic_add_vec(dst + j, src[j]);
}

// threads that share a row: the smallest power of two >= cv, at most 32
int lanes_for(int cv) {
  int lanes = 1;
  while (lanes < cv && lanes < 32) lanes *= 2;
  return lanes;
}

}  // namespace

extern "C" {

// points: b batches of n rows of c floats, rows row_stride floats apart
// and batches batch_stride floats apart; idx: (b, rows_per_batch) i32;
// out: (b, rows_per_batch, c) f32, contiguous. vec != 0 moves float4: the
// caller has checked that c, both strides and all addresses are multiples
// of 4 floats.
int vlp3d_group_points(const void* points, const void* idx, int b, int n,
                       int rows_per_batch, int c, long long row_stride,
                       long long batch_stride, int vec, void* out,
                       void* stream) {
  const int rows = b * rows_per_batch;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    const int cv = c / 4, lanes = lanes_for(cv);
    const int grid = (rows + kThreads / lanes - 1) / (kThreads / lanes);
    group_points_kernel<float4><<<grid, kThreads, 0, s>>>(
        (const float4*)points, (const int*)idx, rows, rows_per_batch, cv, n,
        row_stride / 4, batch_stride / 4, lanes, (float4*)out);
  } else {
    const int lanes = lanes_for(c);
    const int grid = (rows + kThreads / lanes - 1) / (kThreads / lanes);
    group_points_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)points, (const int*)idx, rows, rows_per_batch, c, n,
        row_stride, batch_stride, lanes, (float*)out);
  }
  return (int)cudaGetLastError();
}

// grad: (b, rows_per_batch, c) f32 contiguous; idx: (b, rows_per_batch)
// i32; dpoints: (b, n, c) f32 contiguous, zeroed by the caller.
int vlp3d_group_points_grad(const void* grad, const void* idx, int b,
                            int rows_per_batch, int c, int n, int vec,
                            void* dpoints, void* stream) {
  const int rows = b * rows_per_batch;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    const int cv = c / 4, lanes = lanes_for(cv);
    const int grid = (rows + kThreads / lanes - 1) / (kThreads / lanes);
    group_points_grad_kernel<float4><<<grid, kThreads, 0, s>>>(
        (const float4*)grad, (const int*)idx, rows, rows_per_batch, cv, n,
        lanes, (float4*)dpoints);
  } else {
    const int lanes = lanes_for(c);
    const int grid = (rows + kThreads / lanes - 1) / (kThreads / lanes);
    group_points_grad_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)grad, (const int*)idx, rows, rows_per_batch, c, n,
        lanes, (float*)dpoints);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
