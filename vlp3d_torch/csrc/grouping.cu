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
// form bit for bit. Out-of-range indices follow the JAX package's
// gather_points within batch row b: an index i in [-n, 0) reads row
// i + n, any other index outside [0, n) gives a row of NaN (before the
// subtrahend, so it stays NaN), and the backward passes a gradient only
// to indices in [0, n): a wrapped or out-of-range index drops its
// gradient row.
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
// three_interpolate_grad_kernel: the backward of the three-NN
//   interpolation (vlp3d/ops/interpolate.py::three_interpolate, whose
//   forward csrc/three_nn.cu fuses), replacing XLA's VJP of its gather
//   (a scatter-add of the weighted rows):
//     dfeats[b, j, :] = sum over the entries r of the (b, 3n) index table
//                       with idx[b, r] == j, in ascending r, from +0, of
//                       weight[b, r] * grad[b, r / 3, :]
//   (one __fmul_rn, then one addition an entry: the products and sums of
//   the sorted kernel that computed it before, so the bits are the same).
//   What bounds it on the H100: bytes (the gradient read, the output
//   written), 1.9 / 3.8 us at the FP sites (8 x 512 / 1024 unknown points,
//   256 channels); what held the sorted form back was its fixed cost,
//   four barrier-separated passes in blocks of up to 1024 threads, about
//   one an SM. Here one warp owns one known row of a block's `warps`
//   consecutive rows, on a slice of up to 32 x kU channel units. The
//   block scans the batch row's index table once a window of 512 x warps
//   entries: a lane takes 16 consecutive entries (four int4 loads where
//   the table allows), keeps those landing in the block's rows, and a
//   shuffle scan of the lanes' counts plus one barrier for the warps'
//   gives each its place in a list in shared memory that ascends in r.
//   After a second barrier each warp filters the list for its own row by
//   ballot (about 6 x warps entries at the FP sites), stages its entries'
//   numbers, and sums their rows in registers, 8 vector loads in flight
//   a lane, in list order; the row is written once, zeros included. Every
//   gradient row is read once an entry, three times in all, from L2
//   after the first: at FP2 those 24 MB are most of the time. Blocks of
//   256 threads, several an SM; no zeroed table, no float atomics, two
//   launches give the same bits.
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

// the value of a source row that an out-of-range index reads
__device__ __forceinline__ float nan_row() { return __int_as_float(0x7fc00000); }

// source row of index i in a table of n rows: i + n for i in [-n, 0),
// else i; the result lies in [0, n) exactly when the row exists
__device__ __forceinline__ int wrap_index(int i, int n) {
  return i < 0 ? i + n : i;
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
  const int i = wrap_index(__ldg(idx + row), n);
  const bool follow = (unsigned)i < (unsigned)n;
  const float4* src = points + b * batch_stride + (follow ? i : 0) * row_stride;
  const float4* s = kSub ? sub + (long long)(row / k) * cv : nullptr;
  float4* dst = out + (long long)row * cv;
  const float nan = nan_row();
  for (int j = lane; j < cv; j += lanes) {
    float4 v = follow ? __ldg(src + j) : make_float4(nan, nan, nan, nan);
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

  // the four rows' sources (null: index out of range, a NaN row) and
  // sub rows
  const float* src[4];
  const float* sb[4];
  int b = row0 / rows_per_batch, rb = row0 - b * rows_per_batch;
  int sc = kSub ? row0 / k : 0, rk = kSub ? row0 - sc * k : 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    src[q] = nullptr;
    sb[q] = nullptr;
    if (q < live) {
      const int i = wrap_index(__ldg(idx + row0 + q), n);
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
        val = s ? __ldg(s + ch) : nan_row();
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
  if ((unsigned)i >= (unsigned)n) return;  // negative ones too: no wrap
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
// lands on, or -1 (another block's range, or an index outside [0, n):
// a negative index is dropped, not wrapped as the forward wraps it).
__device__ __forceinline__ int target_of(int i, int i0, int rows, int n) {
  const unsigned t = (unsigned)(i - i0);
  return (unsigned)i < (unsigned)n && t < (unsigned)rows ? (int)t : -1;
}

// Grid: x = ranges of `rows` source rows, y = batch rows, z = slices of
// `uslice` channel units (a unit is a V: float4, or float); blockDim.x
// a multiple of 32. Dynamic shared memory: per warp and source row a
// count, then a start, and a cursor; per source row its list start
// (rows + 1); the list window of `cap` gradient row numbers; 32 words of
// scan scratch.
template <typename V>
__global__ void __launch_bounds__(kSortMaxThreads)
    group_points_grad_sorted_kernel(const V* __restrict__ grad,
                                    const int* __restrict__ idx,
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
  // the row of the batch outer in x (no grid limit on the batch)
  const int per_row = (n + rows - 1) / rows;
  const int i0 = blockIdx.x % per_row * rows, b = blockIdx.x / per_row;
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
  const V* gb = grad + (size_t)b * r_all * units;
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
          const V g0 = __ldg(gb + (size_t)list[k - ws] * units + u);
          const V g1 = __ldg(gb + (size_t)list[k + 1 - ws] * units + u);
          const V g2 = __ldg(gb + (size_t)list[k + 2 - ws] * units + u);
          const V g3 = __ldg(gb + (size_t)list[k + 3 - ws] * units + u);
          acc = vadd(vadd(vadd(vadd(acc, g0), g1), g2), g3);
        }
        for (; k < hi; ++k)
          acc = vadd(acc, __ldg(gb + (size_t)list[k - ws] * units + u));
        dst[u] = acc;
      }
    }
    __syncthreads();  // the next window overwrites the list
  }
}

size_t sorted_smem_bytes(int warps, int rows, int cap) {
  return 4 * ((size_t)2 * warps * rows + rows + 1 + cap + 32);
}

template <typename V>
int launch_sorted(const V* grad, const int* idx, int b, int rows_per_batch,
                  int units, int n, int rows, int uslice, int lanes,
                  int warps, int cap, V* dpoints, cudaStream_t stream) {
  if (rows < 1 || rows > 1024 || uslice < 1 || warps < 1 || warps > 32 ||
      cap < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sorted_smem_bytes(warps, rows, cap);
  auto kernel = group_points_grad_sorted_kernel<V>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it
      return (int)err;
    }
  }
  // the batch folded into x with the row's blocks (z holds the channel
  // slices): at SA2 0.160 -> 0.119 ms against the batch on y on an H100
  // (PERF.md section 6)
  dim3 grid((unsigned)((long long)((n + rows - 1) / rows) * b), 1,
            (units + uslice - 1) / uslice);
  kernel<<<grid, 32 * warps, smem, stream>>>(grad, idx, rows_per_batch,
                                             units, n, rows, uslice, lanes,
                                             cap, dpoints);
  return (int)cudaGetLastError();
}

// index-table entries a lane holds in a window's scan; stage slots a warp
constexpr int kScanPer = 16;
constexpr int kStage = 64;
constexpr int kInterpMaxWarps = 16;

// Sum the n staged entries (numbers r of the batch row's index table) of
// this warp's row into acc, in staged order: 8 / kU entries' loads in
// flight, then their products added one by one.
template <typename V, int kU>
__device__ __forceinline__ void sum_staged(const int* st, int n,
                                           const V* gb, const float* wb,
                                           int units, int u0, int lane,
                                           V (&acc)[kU]) {
  constexpr int kB = 8 / kU;
  for (int s = 0; s < n; s += kB) {
    V g[kB][kU];
    float w[kB];
#pragma unroll
    for (int h = 0; h < kB; ++h) {
      w[h] = 0.0f;
      if (s + h < n) {
        const int r = st[s + h];
        w[h] = __ldg(wb + r);
        const V* row = gb + (size_t)(r / 3) * units;
#pragma unroll
        for (int q = 0; q < kU; ++q) {
          const int u = u0 + lane + 32 * q;
          g[h][q] = u < units ? __ldg(row + u) : vzero<V>();
        }
      }
    }
#pragma unroll
    for (int h = 0; h < kB; ++h)
      if (s + h < n)
#pragma unroll
        for (int q = 0; q < kU; ++q) acc[q] = vadd(acc[q], vmul(g[h][q], w[h]));
  }
}

// Grid: x = ranges of blockDim.x / 32 known rows, y = batch rows, z =
// slices of 32 * kU channel units (a unit is a V). Dynamic shared memory:
// the list (512 entries a warp), kStage staged entries a warp, 32 counts.
template <typename V, int kU>
__global__ void __launch_bounds__(32 * kInterpMaxWarps)
    three_interpolate_grad_kernel(const V* __restrict__ grad,
                                  const int* __restrict__ idx,
                                  const float* __restrict__ weight,
                                  int r_all, int units, int m,
                                  V* __restrict__ dfeats) {
  extern __shared__ int sm[];
  const int warps = blockDim.x >> 5;
  const int cap = warps * 32 * kScanPer;  // entries a window
  int* list = sm;                         // [cap]: (r - ws) << 5 | row
  int* stage = list + cap;                // [warps][kStage]
  int* wcount = stage + warps * kStage;   // [32]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j0 = blockIdx.x * warps, b = blockIdx.y;
  const int u0 = blockIdx.z * 32 * kU;
  const bool own = j0 + warp < m;  // this warp's known row exists
  const int* ix = idx + (size_t)b * r_all;
  const float* wb = weight + (size_t)b * r_all;
  const V* gb = grad + (size_t)b * (r_all / 3) * units;
  int* st = stage + warp * kStage;
  const unsigned below = (1u << lane) - 1u;
  V acc[kU];
#pragma unroll
  for (int q = 0; q < kU; ++q) acc[q] = vzero<V>();
  int staged = 0;
  // the index table as int4 where its rows allow
  const bool vec_idx = (r_all & 3) == 0 && ((size_t)idx & 15) == 0;

  for (int ws = 0; ws < r_all; ws += cap) {
    // 1. this warp's 512 entries of the window, 16 consecutive a lane:
    // their rows in the block (-1: another block's, or an index outside
    // [0, m)), counted, and the lanes' counts scanned
    const int wbase = ws + warp * 32 * kScanPer;
    const int lbase = wbase + kScanPer * lane;
    int t[kScanPer];
    unsigned hits = 0;
#pragma unroll
    for (int q = 0; q < kScanPer; ++q) t[q] = -1;
    if (wbase < r_all) {
      if (vec_idx && lbase + kScanPer <= r_all) {
#pragma unroll
        for (int v = 0; v < kScanPer / 4; ++v) {
          const int4 f = __ldg(reinterpret_cast<const int4*>(ix + lbase) + v);
          t[4 * v] = f.x;
          t[4 * v + 1] = f.y;
          t[4 * v + 2] = f.z;
          t[4 * v + 3] = f.w;
        }
      } else {
#pragma unroll
        for (int q = 0; q < kScanPer; ++q)
          if (lbase + q < r_all) t[q] = __ldg(ix + lbase + q);
      }
#pragma unroll
      for (int q = 0; q < kScanPer; ++q) {
        const unsigned d = (unsigned)(t[q] - j0);
        const bool hit = lbase + q < r_all && (unsigned)t[q] < (unsigned)m &&
                         d < (unsigned)warps;
        t[q] = hit ? (int)d : -1;
        hits |= (unsigned)hit << q;
      }
    }
    const int mine = __popc(hits);
    int incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) wcount[warp] = incl;
    __syncthreads();

    // 2. place at the offset of the warps and lanes before: the list
    // ascends in r
    const int c = lane < warps ? wcount[lane] : 0;
    int at = __reduce_add_sync(0xffffffffu, lane < warp ? c : 0) + incl - mine;
    const int total = __reduce_add_sync(0xffffffffu, c);
    if (hits) {
#pragma unroll
      for (int q = 0; q < kScanPer; ++q)
        if (t[q] >= 0) list[at++] = ((lbase + q - ws) << 5) | t[q];
    }
    __syncthreads();

    // 3. this warp's row: its entries in list order, staged, summed; the
    // row written after the last window
    if (own) {
      for (int k0 = 0; k0 < total; k0 += 32) {
        const int e = k0 + lane < total ? list[k0 + lane] : -1;
        const bool hit = e >= 0 && (e & 31) == warp;
        const unsigned bal = __ballot_sync(0xffffffffu, hit);
        if (hit) st[staged + __popc(bal & below)] = ws + (e >> 5);
        staged += __popc(bal);
        if (staged >= 32) {
          __syncwarp();
          sum_staged<V, kU>(st, staged, gb, wb, units, u0, lane, acc);
          staged = 0;
          __syncwarp();
        }
      }
      if (ws + cap >= r_all) {
        __syncwarp();
        sum_staged<V, kU>(st, staged, gb, wb, units, u0, lane, acc);
        V* dst = dfeats + ((size_t)b * m + j0 + warp) * units;
#pragma unroll
        for (int q = 0; q < kU; ++q) {
          const int u = u0 + lane + 32 * q;
          if (u < units) dst[u] = acc[q];
        }
      }
    }
    if (ws + cap < r_all) __syncthreads();  // the next window rewrites
  }
}

size_t interp_smem_bytes(int warps) {
  return 4 * ((size_t)warps * (32 * kScanPer + kStage) + 32);
}

template <typename V, int kU>
int launch_interp(const V* grad, const int* idx, const float* weight, int b,
                  int n, int units, int m, int warps, V* dfeats,
                  cudaStream_t stream) {
  const size_t smem = interp_smem_bytes(warps);
  auto kernel = three_interpolate_grad_kernel<V, kU>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it
      return (int)err;
    }
  }
  // the batch on the grid's y (z holds the channel units, so not
  // batch_rows.cuh's y and z), one launch a chunk of 65535 rows (one
  // launch below that: folding the row into x cost the call 2-3% on an
  // H100, PERF.md section 6)
  for (int b0 = 0; b0 < b; b0 += 65535) {
    const size_t r = (size_t)b0 * 3 * n;
    dim3 grid((m + warps - 1) / warps, std::min(b - b0, 65535),
              (units + 32 * kU - 1) / (32 * kU));
    kernel<<<grid, 32 * warps, smem, stream>>>(
        grad + (size_t)b0 * n * units, idx + r, weight + r, 3 * n, units, m,
        dfeats + (size_t)b0 * m * units);
  }
  return (int)cudaGetLastError();
}

template <typename V>
int launch_interp_units(const V* grad, const int* idx, const float* weight,
                        int b, int n, int units, int m, int warps,
                        int lane_units, V* dfeats, cudaStream_t stream) {
  if (warps < 1 || warps > kInterpMaxWarps)
    return (int)cudaErrorInvalidValue;
  switch (lane_units) {
    case 1:
      return launch_interp<V, 1>(grad, idx, weight, b, n, units, m, warps,
                                 dfeats, stream);
    case 2:
      return launch_interp<V, 2>(grad, idx, weight, b, n, units, m, warps,
                                 dfeats, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
    return launch_sorted<float4>((const float4*)grad, (const int*)idx, b,
                                 rows_per_batch, units, n, rows, uslice,
                                 lanes, warps, cap, (float4*)dpoints, s);
  return launch_sorted<float>((const float*)grad, (const int*)idx, b,
                              rows_per_batch, units, n, rows, uslice, lanes,
                              warps, cap, (float*)dpoints, s);
}

// The backward of the three-NN interpolation
// (three_interpolate_grad_kernel): dfeats[b, j, :] = sum over (i, k)
// with idx[b, i, k] == j, in ascending 3 i + k, of weight[b, i, k] *
// grad[b, i, :]. grad: (b, n, c) f32 contiguous; idx, weight: (b, n, 3)
// i32 / f32 contiguous; dfeats: (b, m, c) f32, every row written. vec != 0
// moves float4 units (the caller has checked that c and the addresses are
// multiples of 4 floats). `warps` known rows a block (1 to 16), one a
// warp; `lane_units` channel units a lane (1 or 2), so a block covers
// 32 x lane_units units and the grid's z the rest.
int vlp3d_three_interpolate_grad(const void* grad, const void* idx,
                                 const void* weight, int b, int n, int c,
                                 int m, int vec, int warps, int lane_units,
                                 void* dfeats, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    return launch_interp_units<float4>(
        (const float4*)grad, (const int*)idx, (const float*)weight, b, n,
        c / 4, m, warps, lane_units, (float4*)dfeats, s);
  return launch_interp_units<float>((const float*)grad, (const int*)idx,
                                    (const float*)weight, b, n, c, m, warps,
                                    lane_units, (float*)dfeats, s);
}

}  // extern "C"
