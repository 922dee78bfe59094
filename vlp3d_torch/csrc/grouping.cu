// Row gather and its scatter-add backward for Hopper (sm_90a).
//
// Replaces vlp3d/ops/grouping.py::group_points / gather_points (XLA
// take-along-axis gathers split under a 2^18-row table limit) and their
// backward _group_points_bwd / _gather_points_bwd / _sorted_scatter_add
// (argsort + permute + sorted segment-sum, a TPU device that is not
// carried over).
//
//   forward:  out[b, r, :] = points[b, idx[b, r], :] - sub[b, r / k, :]
//   backward: dpoints[b, idx[b, r], :] += grad[b, r, :]  (dpoints zeroed)
//
// with r running over the M*K neighbourhood slots of batch row b
// (gather_points is K = 1) and `sub` an optional row a centre (the SA
// first layer's centre term, which XLA fuses into the gather in the JAX
// package): one float32 subtraction, so the result equals the two-op
// form bit for bit. Indices must lie in [0, n); one that does not is
// never followed: its source row counts as zeros and its gradient row
// is dropped.
//
// What bounds both on the H100: bytes. Each output row is written once
// and each source row read at least once; there is no arithmetic worth
// the name. Two forward kernels:
//
// group_points_vec_kernel: rows whose width, strides and addresses are
//   multiples of 16 bytes (C = 64, 128, 256). A group of `lanes`
//   neighbouring threads (a power of two up to a warp) owns one output
//   row and moves it as float4, so reads and writes are coalesced.
// group_points_stream_kernel: every other width (C = 3, C = 135: a row
//   of 540 bytes is 12 mod 16, so neither source nor output rows are
//   16-byte aligned). The output is one contiguous stream whose base is
//   16-byte aligned whatever C is, and four consecutive output rows are
//   4 * C floats = C float4, again 16-byte aligned: a group of threads
//   owns such a chunk of four rows, a thread builds output float4 e of
//   the chunk from four 4-byte source loads (which may come from two
//   rows, at whatever alignment each source row has) and writes it with
//   one aligned 16-byte store. The four rows' indices load up front and
//   a thread's float4s are independent, so index load, row load and
//   store are not one dependent chain.
//
// The source may be a view whose rows are `row_stride` floats apart (a
// channel slice of the input cloud), so no copy is made first.
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

// cv, row_stride and batch_stride count float4 elements; k is the number
// of consecutive output rows that share one row of sub.
template <bool kSub>
__global__ void __launch_bounds__(kThreads)
    group_points_vec_kernel(const float4* __restrict__ points,
                            const int* __restrict__ idx,
                            const float4* __restrict__ sub, int rows,
                            int rows_per_batch, int k, int cv, int n,
                            long long row_stride, long long batch_stride,
                            int lanes, float4* __restrict__ out) {
  const int row = blockIdx.x * (kThreads / lanes) + threadIdx.x / lanes;
  if (row >= rows) return;
  const int lane = threadIdx.x % lanes;
  const int b = row / rows_per_batch;
  const int i = __ldg(idx + row);
  const bool follow = (unsigned)i < (unsigned)n;
  const float4* src = points + b * batch_stride + (follow ? i : 0) * row_stride;
  const float4* s = kSub ? sub + (long long)(row / k) * cv : nullptr;
  float4* dst = out + (long long)row * cv;
  for (int j = lane; j < cv; j += lanes) {
    float4 v = follow ? __ldg(src + j) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (kSub) {
      const float4 c = __ldg(s + j);
      v = make_float4(__fsub_rn(v.x, c.x), __fsub_rn(v.y, c.y),
                      __fsub_rn(v.z, c.z), __fsub_rn(v.w, c.w));
    }
    dst[j] = v;
  }
}

__device__ __forceinline__ const float* pick4(const float* const (&a)[4],
                                              int r) {
  return r == 0 ? a[0] : r == 1 ? a[1] : r == 2 ? a[2] : a[3];
}

// Any row width c: a group of `lanes` threads owns the chunk of output
// rows 4g .. 4g + 3, which is c float4 at a 16-byte aligned address.
template <bool kSub>
__global__ void __launch_bounds__(kThreads)
    group_points_stream_kernel(const float* __restrict__ points,
                               const int* __restrict__ idx,
                               const float* __restrict__ sub, int rows,
                               int rows_per_batch, int k, int c, int n,
                               long long row_stride, long long batch_stride,
                               int lanes, float* __restrict__ out) {
  const int chunk = blockIdx.x * (kThreads / lanes) + threadIdx.x / lanes;
  const long long first = 4LL * chunk;
  if (first >= rows) return;
  const int lane = threadIdx.x % lanes;
  const int row0 = (int)first;
  const int live = min(4, rows - row0);

  // the four rows' sources (null: index out of range) and sub rows
  const float* src[4];
  const float* sb[4];
  int b = row0 / rows_per_batch, rb = row0 - b * rows_per_batch;
  int sc = kSub ? row0 / k : 0, rk = kSub ? row0 - sc * k : 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    src[q] = nullptr;
    sb[q] = nullptr;
    if (q < live) {
      const int i = __ldg(idx + row0 + q);
      if ((unsigned)i < (unsigned)n)
        src[q] = points + b * batch_stride + i * row_stride;
      if (kSub) sb[q] = sub + (long long)sc * c;
    }
    if (++rb == rows_per_batch) {
      rb = 0;
      ++b;
    }
    if (kSub && ++rk == k) {
      rk = 0;
      ++sc;
    }
  }

  const int nf = live * c;  // floats of this chunk
  float* dst = out + first * c;
#pragma unroll 2
  for (int e = lane; 4 * e < nf; e += lanes) {
    const int f = 4 * e;
    int r = (f >= c) + (f >= 2 * c) + (f >= 3 * c);
    int ch = f - r * c;
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      while (ch >= c) {  // at most once for c >= 4
        ch -= c;
        ++r;
      }
      float val = 0.0f;
      if (f + q < nf) {
        const float* s = pick4(src, r);
        if (s) val = __ldg(s + ch);
        if (kSub) val = __fsub_rn(val, __ldg(pick4(sb, r) + ch));
      }
      v[q] = val;
      ++ch;
    }
    if (f + 3 < nf) {
      *reinterpret_cast<float4*>(dst + f) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (f + q < nf) dst[f + q] = v[q];
    }
  }
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
// sub: null, or (b, rows_per_batch / k, c) f32 contiguous, subtracted
// from the k output rows of each centre; out: (b, rows_per_batch, c) f32,
// contiguous, 16-byte aligned. vec != 0 moves whole float4 rows: the
// caller has checked that c, both strides and all addresses are
// multiples of 4 floats.
int vlp3d_group_points(const void* points, const void* idx, const void* sub,
                       int b, int n, int rows_per_batch, int k, int c,
                       long long row_stride, long long batch_stride, int vec,
                       void* out, void* stream) {
  const int rows = b * rows_per_batch;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec) {
    const int cv = c / 4, lanes = lanes_for(cv);
    const int grid = (rows + kThreads / lanes - 1) / (kThreads / lanes);
    auto kernel = sub ? group_points_vec_kernel<true>
                      : group_points_vec_kernel<false>;
    kernel<<<grid, kThreads, 0, s>>>(
        (const float4*)points, (const int*)idx, (const float4*)sub, rows,
        rows_per_batch, k, cv, n, row_stride / 4, batch_stride / 4, lanes,
        (float4*)out);
  } else {
    const int lanes = lanes_for(c), chunks = (rows + 3) / 4;
    const int grid = (chunks + kThreads / lanes - 1) / (kThreads / lanes);
    auto kernel = sub ? group_points_stream_kernel<true>
                      : group_points_stream_kernel<false>;
    kernel<<<grid, kThreads, 0, s>>>(
        (const float*)points, (const int*)idx, (const float*)sub, rows,
        rows_per_batch, k, c, n, row_stride, batch_stride, lanes,
        (float*)out);
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
