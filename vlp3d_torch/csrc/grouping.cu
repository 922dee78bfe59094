// Row gather and its scatter-add backward for Hopper (sm_90a).
//
// Replaces vlp3d/ops/grouping.py::group_points / gather_points (XLA
// take-along-axis gathers split under a 2^18-row table limit) and their
// backward _group_points_bwd / _gather_points_bwd / _sorted_scatter_add
// (a global argsort + permute + sorted segment-sum, shaped for the TPU;
// here a counting sort inside each block takes its place).
//
//   forward:  out[b, r, :] = points[b, idx[b, r], :] - sub[b, r / k, :]
//   backward: dpoints[b, i, :] = sum of grad[b, r, :] over idx[b, r] == i
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
// Two backward kernels:
//
// group_points_grad_sorted_kernel: one block a (batch row, range of
//   `rows` source rows, slice of channels). What bounds the backward is
//   the gradient's bytes, read once; what held the atomic form back was
//   the collisions (16 rows on average meet in one source row at SA2,
//   and an unfilled ball repeats its first hit in every empty slot:
//   atomics on one address serialise in L2), the zeroed table it needs
//   (a second launch) and its order, which changes from launch to launch.
//   Here a block transposes its part of the index table in shared memory
//   by a counting sort. Each warp takes a contiguous share of the batch
//   row's index table and counts, with shared-memory atomics (a count
//   does not depend on their order), how many of its rows land on each
//   source row of the range; a block scan turns the counts into start
//   positions, target-major and warp-minor; a second pass over the same
//   indices places each gradient row at its start plus its rank among
//   the lanes of its step with the same target (__match_any_sync). So a
//   source row's list holds its gradient rows in ascending order, which
//   depends on the indices alone. Then a group of lanes a source row sums
//   that list's gradient rows in registers, in list order (float4 reads,
//   coalesced, four in flight), and writes the row once, zeros included:
//   no zeroed table, no float atomics, and two launches give the same
//   bits. Every block reads the batch row's whole index table twice, so
//   blocks are few and wide (up to 32 warps, about one an SM) and the
//   index passes stay a fraction of the gradient's bytes. A list longer
//   than the shared-memory window (every row of a batch row on one
//   source row, say) is taken in several windows; a source row that
//   spans two keeps its partial sum in the output row, which only the
//   lane that wrote it reads back, so the order stays the same.
//   Its weighted instantiation is the backward of the three-NN
//   interpolation (vlp3d/ops/interpolate.py::three_interpolate, whose
//   forward csrc/three_nn.cu fuses): the (b, 3n) table of neighbour
//   indices, entry r standing for gradient row r / 3 times weight[b, r].
//   The sort and the ordered sum are the same, so no (b, n, 3, c)
//   weighted gradient is ever written and two launches give the same
//   bits.
// group_points_grad_kernel: the first design, as the reference's
//   group_points_grad kernel does: atomicAdd straight into a zeroed
//   table, 16-byte vector atomics where the row allows. Its sum is exact
//   only up to float32 rounding of a reordered sum. It stays for tables
//   too large for the sorted kernel's index passes (every block reads the
//   whole batch row's index table twice) and as its yardstick.

#include <cuda_runtime.h>

#include <algorithm>

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

constexpr int kSortMaxThreads = 1024;

__device__ __forceinline__ float vadd(float a, float b) { return a + b; }

__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float vmul(float a, float w) {
  return __fmul_rn(a, w);
}

__device__ __forceinline__ float4 vmul(float4 a, float w) {
  return make_float4(__fmul_rn(a.x, w), __fmul_rn(a.y, w), __fmul_rn(a.z, w),
                     __fmul_rn(a.w, w));
}

template <typename V>
__device__ __forceinline__ V vzero();
template <>
__device__ __forceinline__ float vzero<float>() {
  return 0.0f;
}
template <>
__device__ __forceinline__ float4 vzero<float4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// The source row (relative to i0, in [0, rows)) that gradient row r
// lands on, or -1 (another block's range, or an index out of range).
__device__ __forceinline__ int target_of(int i, int i0, int rows, int n) {
  const unsigned t = (unsigned)(i - i0);
  return (unsigned)i < (unsigned)n && t < (unsigned)rows ? (int)t : -1;
}

// Entry r of a batch row's index table contributes gradient row r (the
// gather's backward) or, kWeighted, gradient row r / 3 scaled by
// weight[b, r] (the three-NN interpolation's backward: three entries an
// unknown point, one float32 product each, then the same ordered sum).
template <typename V, bool kWeighted>
__device__ __forceinline__ V grad_term(const V* gb, const float* wb, int r,
                                       int units, int u) {
  if (!kWeighted) return __ldg(gb + (size_t)r * units + u);
  return vmul(__ldg(gb + (size_t)(r / 3) * units + u), __ldg(wb + r));
}

// Grid: x = ranges of `rows` source rows, y = batch rows, z = slices of
// `uslice` channel units (a unit is a V: float4, or float); blockDim.x
// a multiple of 32. Dynamic shared memory: per warp and source row a
// count, then a start, and a cursor; per source row its list start
// (rows + 1); the list window of `cap` gradient row numbers; 32 words of
// scan scratch. weight: null, or kWeighted (b, rows_per_batch) f32.
template <typename V, bool kWeighted>
__global__ void __launch_bounds__(kSortMaxThreads)
    group_points_grad_sorted_kernel(const V* __restrict__ grad,
                                    const int* __restrict__ idx,
                                    const float* __restrict__ weight,
                                    int rows_per_batch, int units, int n,
                                    int rows, int uslice, int lanes, int cap,
                                    V* __restrict__ dpoints) {
  extern __shared__ int sm[];
  const int threads = blockDim.x, warps = threads >> 5;
  int* wstart = sm;                     // [warps][rows]
  int* cursor = wstart + warps * rows;  // [warps][rows]
  int* tstart = cursor + warps * rows;  // [rows + 1]
  int* list = tstart + rows + 1;        // [cap]
  int* scan = list + cap;               // [32]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = blockIdx.x * rows, b = blockIdx.y;
  const int u0 = blockIdx.z * uslice, u1 = min(units, u0 + uslice);
  const int r_all = rows_per_batch;
  const int* ix = idx + (size_t)b * r_all;
  // a warp's share of the index table: consecutive rows, whole steps
  const int per = (r_all + 32 * warps - 1) / (32 * warps) * 32;
  const int wlo = min(r_all, warp * per), whi = min(r_all, wlo + per);
  const unsigned below = (1u << lane) - 1u;

  for (int k = tid; k < warps * rows; k += threads) wstart[k] = 0;
  __syncthreads();

  // 1. count: rows of this warp's share landing on each source row (a
  // count is the same whatever order the atomics take)
  for (int r0 = wlo; r0 < whi; r0 += 128) {
    int t[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = r0 + 32 * q + lane;
      t[q] = r < whi ? target_of(__ldg(ix + r), i0, rows, n) : -1;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (t[q] >= 0) atomicAdd(wstart + warp * rows + t[q], 1);
  }
  __syncthreads();

  // 2. starts: a thread takes consecutive source rows; block-wide
  // exclusive scan of their totals (target-major, warp-minor)
  const int chunk = (rows + threads - 1) / threads;
  const int t_lo = min(rows, tid * chunk), t_hi = min(rows, t_lo + chunk);
  int mine = 0;
  for (int t = t_lo; t < t_hi; ++t)
    for (int w = 0; w < warps; ++w) mine += wstart[w * rows + t];
  int incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) scan[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int v = lane < warps ? scan[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v += u;
    }
    scan[lane] = v;  // inclusive totals of warps 0..lane
  }
  __syncthreads();
  int pos = (warp > 0 ? scan[warp - 1] : 0) + incl - mine;
  for (int t = t_lo; t < t_hi; ++t) {
    tstart[t] = pos;
    for (int w = 0; w < warps; ++w) {
      const int c = wstart[w * rows + t];
      wstart[w * rows + t] = pos;
      pos += c;
    }
  }
  const int total = scan[warps - 1];
  if (tid == 0) tstart[rows] = total;
  __syncthreads();

  const int groups = threads / lanes, g = tid / lanes, gl = tid % lanes;
  const V* gb = grad + (size_t)b * (kWeighted ? r_all / 3 : r_all) * units;
  const float* wb = kWeighted ? weight + (size_t)b * r_all : nullptr;
  V* db = dpoints + (size_t)b * n * units;
  // the list in windows of cap entries (one window unless rows pile up)
  for (int ws = 0; ws < max(total, 1); ws += cap) {
    const int we = ws + cap;
    // 3. place: the same pass again, each row at start + its rank among
    // the lanes of its step with the same source row
    for (int k = tid; k < warps * rows; k += threads) cursor[k] = wstart[k];
    __syncthreads();
    for (int r0 = wlo; r0 < whi; r0 += 128) {
      int t[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = r0 + 32 * q + lane;
        t[q] = r < whi ? target_of(__ldg(ix + r), i0, rows, n) : -1;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (__ballot_sync(0xffffffffu, t[q] >= 0) == 0u) continue;
        const unsigned peers = __match_any_sync(0xffffffffu, t[q]);
        if (t[q] >= 0) {
          const int p = cursor[warp * rows + t[q]] + __popc(peers & below);
          if (p >= ws && p < we) list[p - ws] = r0 + 32 * q + lane;
        }
        __syncwarp();
        if (t[q] >= 0 && (peers & below) == 0)
          cursor[warp * rows + t[q]] += __popc(peers);
        __syncwarp();
      }
    }
    __syncthreads();

    // 4. sum: a group of lanes a source row, its list in order
    for (int t = g; t < rows && i0 + t < n; t += groups) {
      const int s = tstart[t], e = tstart[t + 1];
      const int lo = max(s, ws), hi = min(e, we);
      V* dst = db + (size_t)(i0 + t) * units;
      if (lo >= hi) {
        if (ws == 0 && s == e)  // nothing lands here: a zero row
          for (int u = u0 + gl; u < u1; u += lanes) dst[u] = vzero<V>();
        continue;
      }
      for (int u = u0 + gl; u < u1; u += lanes) {
        // a row begun in an earlier window goes on from its partial sum
        V acc = lo > s ? dst[u] : vzero<V>();
        int k = lo;
        for (; k + 4 <= hi; k += 4) {
          const V g0 = grad_term<V, kWeighted>(gb, wb, list[k - ws], units, u);
          const V g1 =
              grad_term<V, kWeighted>(gb, wb, list[k + 1 - ws], units, u);
          const V g2 =
              grad_term<V, kWeighted>(gb, wb, list[k + 2 - ws], units, u);
          const V g3 =
              grad_term<V, kWeighted>(gb, wb, list[k + 3 - ws], units, u);
          acc = vadd(vadd(vadd(vadd(acc, g0), g1), g2), g3);
        }
        for (; k < hi; ++k)
          acc = vadd(acc,
                     grad_term<V, kWeighted>(gb, wb, list[k - ws], units, u));
        dst[u] = acc;
      }
    }
    __syncthreads();  // the next window overwrites the list
  }
}

size_t sorted_smem_bytes(int warps, int rows, int cap) {
  return 4 * ((size_t)2 * warps * rows + rows + 1 + cap + 32);
}

template <typename V, bool kWeighted>
int launch_sorted(const V* grad, const int* idx, const float* weight, int b,
                  int rows_per_batch, int units, int n, int rows, int uslice,
                  int lanes, int warps, int cap, V* dpoints,
                  cudaStream_t stream) {
  if (rows < 1 || rows > 1024 || uslice < 1 || warps < 1 || warps > 32 ||
      cap < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sorted_smem_bytes(warps, rows, cap);
  auto kernel = group_points_grad_sorted_kernel<V, kWeighted>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it
      return (int)err;
    }
  }
  dim3 grid((n + rows - 1) / rows, b, (units + uslice - 1) / uslice);
  kernel<<<grid, 32 * warps, smem, stream>>>(grad, idx, weight,
                                             rows_per_batch, units, n, rows,
                                             uslice, lanes, cap, dpoints);
  return (int)cudaGetLastError();
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
// i32; dpoints: (b, n, c) f32 contiguous, zeroed by the caller. The
// first design: float atomics.
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

// The same function, deterministic, through
// group_points_grad_sorted_kernel; dpoints need not be zeroed: every row
// is written. `rows` source rows a block (1 to 1024), `uslice` channel
// units a block (float4 when vec, else float; at least 1), `warps` a
// block (1 to 32), `cap` list entries in shared memory (at least 1). A
// shape the card refuses comes back as its error code.
int vlp3d_group_points_grad_sorted(const void* grad, const void* idx, int b,
                                   int rows_per_batch, int c, int n, int vec,
                                   int rows, int uslice, int warps, int cap,
                                   void* dpoints, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int units = vec ? c / 4 : c;
  const int lanes = lanes_for(std::min(units, uslice));
  if (vec)
    return launch_sorted<float4, false>(
        (const float4*)grad, (const int*)idx, nullptr, b, rows_per_batch,
        units, n, rows, uslice, lanes, warps, cap, (float4*)dpoints, s);
  return launch_sorted<float, false>(
      (const float*)grad, (const int*)idx, nullptr, b, rows_per_batch, units,
      n, rows, uslice, lanes, warps, cap, (float*)dpoints, s);
}

// The backward of the three-NN interpolation, through the same kernel:
// dfeats[b, j, :] = sum over (i, k) with idx[b, i, k] == j, in ascending
// 3 i + k, of weight[b, i, k] * grad[b, i, :]. grad: (b, n, c) f32
// contiguous; idx, weight: (b, n, 3) i32 / f32 contiguous; dfeats:
// (b, m, c) f32, every row written. Plan arguments as above.
int vlp3d_three_interpolate_grad(const void* grad, const void* idx,
                                 const void* weight, int b, int n, int c,
                                 int m, int vec, int rows, int uslice,
                                 int warps, int cap, void* dfeats,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int units = vec ? c / 4 : c;
  const int lanes = lanes_for(std::min(units, uslice));
  if (vec)
    return launch_sorted<float4, true>(
        (const float4*)grad, (const int*)idx, (const float*)weight, b, 3 * n,
        units, m, rows, uslice, lanes, warps, cap, (float4*)dfeats, s);
  return launch_sorted<float, true>(
      (const float*)grad, (const int*)idx, (const float*)weight, b, 3 * n,
      units, m, rows, uslice, lanes, warps, cap, (float*)dfeats, s);
}

}  // extern "C"
