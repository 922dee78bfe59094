// Dynamic and hard voxelization (PointPillars) for Hopper (sm_90a).
//
// Replaces vlp3d/ops/voxelize.py::dynamic_voxelize and ::hard_voxelize
// (XLA: a stable argsort over the cell keys, segment ranks, scatters),
// themselves the TPU rewrite of the reference's voxelization_cuda.cu.
//
// Semantics (the JAX functions', bit for bit):
//   - a point's cell is floor((p - lo) / vs) per axis in float32 with a
//     correctly rounded subtraction and division (__fsub_rn, __fdiv_rn;
//     never a multiply by the reciprocal); outside [0, grid) on any axis
//     the point has no cell and its coordinates are -1. The grid,
//     round((hi - lo) / vs) with round-half-to-even, comes from the host;
//   - hard: voxel ids go to cells in the order of each cell's first
//     point; a cell whose first point comes after max_voxels cells is
//     dropped whole; a point's slot is its rank among the earlier points
//     of its cell, and points at slot max_points or later are dropped;
//     voxels past voxel_num are zeros with coordinates -1 and count 0.
//
// The TPU version sorts; here every step is a pass over the points or
// the voxels, and the order of the sequential loop is rebuilt from point
// indices, never from the order atomics happen to run in:
//   1. voxel_head_kernel: each point's linear cell key into a dense cell
//      table (grid cells a batch row, set to INT_MAX first): an atomicMin
//      of the point index leaves each cell's first point;
//   2. the head flags (key valid and table[key] == index) prefix-summed
//      in point order give each head its voxel id, in three launches
//      (tile_sum_kernel, tile_scan_kernel over a row's tile sums,
//      voxel_assign_kernel), and the row's cell count voxel_num;
//   3. voxel_count_kernel: every point takes its head's voxel id and the
//      kept voxels count their points (warp-aggregated atomics);
//   4. the counts prefix-summed the same way into segment offsets
//      (voxel_offsets_kernel also writes each voxel's count, coordinates
//      and mask, and lists the voxels of more than kLongLen points);
//   5. voxel_place_kernel: each point written into its voxel's segment
//      (any order within it);
//   6. a point's slot is the number of smaller point indices in its
//      segment: voxel_rank_kernel counts them, a thread a point (the
//      count stops at max_points: such a point is dropped), for short
//      segments; voxel_rank_long_kernel, a block a listed voxel, sets a
//      bit a point in a bitmap over the row, prefix-sums the words'
//      popcounts and reads each rank off the bits below its own. A kept
//      point copies its channels into its slot and records
//      voxel * max_points + slot for the backward pass.
//
// What bounds it on the H100: neither bytes nor arithmetic at these
// sizes (a few MB a call) but latency: a dozen dependent launches, the
// head table's random reads, and atomics on hot cells (a pillar holding
// 20000 points): the table's atomicMin is skipped once a smaller index
// is there, and counts and placements are aggregated over a warp.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
// a tile of a row's prefix sum: kTileThreads threads of kPer items
constexpr int kTileThreads = 256;
constexpr int kPer = 8;
constexpr int kTile = kTileThreads * kPer;  // VOXEL_TILE in voxelize.py
// segments longer than this are ranked by bitmap, when a row's bitmap
// (and its word prefix) fits in shared memory
constexpr int kLongLen = 256;
constexpr int kLongSmem = 200 * 1024;
constexpr int kLongBlocks = 264;
constexpr unsigned kFull = 0xffffffffu;

__global__ void dynamic_voxelize_kernel(const float* __restrict__ points,
                                        long long total, int c, float lo0,
                                        float lo1, float lo2, float vs0,
                                        float vs1, float vs2, int g0, int g1,
                                        int g2, int* __restrict__ coords) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= total) return;
  const float* p = points + i * c;
  const float f0 = floorf(__fdiv_rn(__fsub_rn(p[0], lo0), vs0));
  const float f1 = floorf(__fdiv_rn(__fsub_rn(p[1], lo1), vs1));
  const float f2 = floorf(__fdiv_rn(__fsub_rn(p[2], lo2), vs2));
  // compared as floats: a cell index past int32 is outside as in JAX
  // (whose conversion saturates); NaN is outside too
  const bool valid = f0 >= 0.f && f0 < static_cast<float>(g0) &&
                     f1 >= 0.f && f1 < static_cast<float>(g1) &&
                     f2 >= 0.f && f2 < static_cast<float>(g2);
  coords[3 * i + 0] = valid ? static_cast<int>(f0) : -1;
  coords[3 * i + 1] = valid ? static_cast<int>(f1) : -1;
  coords[3 * i + 2] = valid ? static_cast<int>(f2) : -1;
}

__global__ void voxel_head_kernel(const int* __restrict__ coords,
                                  long long total, int n, int g0, int g1,
                                  long long cells, int* __restrict__ key,
                                  int* __restrict__ head) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= total) return;
  const int x = coords[3 * i], y = coords[3 * i + 1], z = coords[3 * i + 2];
  const int k = x < 0 ? -1 : (z * g1 + y) * g0 + x;
  key[i] = k;
  if (k < 0) return;
  const int j = static_cast<int>(i % n);
  int* h = head + (i / n) * cells + k;
  if (j < *h) atomicMin(h, j);
}

// exclusive prefix sum of v over the block; *total gets the block's sum
__device__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nwarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    if (lane < nwarps) warp_sums[lane] = s;
  }
  __syncthreads();
  const int prefix = (warp ? warp_sums[warp - 1] : 0) + x - v;
  *total = warp_sums[nwarps - 1];
  __syncthreads();  // warp_sums is read before a later call rewrites it
  return prefix;
}

// A prefix sum over a batch row runs in three launches: tile_sum_kernel
// (a tile of kTile items a block), tile_scan_kernel (one block a row
// over the row's tile sums) and an apply kernel that scans its tile
// again from the tile's offset.
struct HeadFlag {  // 1 where a point is its cell's first
  const int* key;
  const int* head;
  int n;
  long long cells;
  __device__ int operator()(int b, int j) const {
    const int k = key[static_cast<long long>(b) * n + j];
    return k >= 0 && head[b * cells + k] == j;
  }
};

struct VoxelCount {  // the points of a kept voxel
  const int* count;
  int max_voxels;
  __device__ int operator()(int b, int v) const {
    return count[static_cast<long long>(b) * max_voxels + v];
  }
};

template <class F>
__global__ void __launch_bounds__(kTileThreads)
    tile_sum_kernel(F f, int len, int* __restrict__ sums) {
  const int b = blockIdx.y, tiles = gridDim.x;
  const int begin = blockIdx.x * kTile + threadIdx.x * kPer;
  int sum = 0;
#pragma unroll
  for (int u = 0; u < kPer; ++u)
    if (begin + u < len) sum += f(b, begin + u);
  int total;
  block_exclusive_scan(sum, &total);
  if (threadIdx.x == 0) sums[b * tiles + blockIdx.x] = total;
}

// sums (b, tiles) -> exclusive offsets in place; totals[b] = min(the
// row's total, cap) when totals is given
__global__ void __launch_bounds__(kScanThreads)
    tile_scan_kernel(int* __restrict__ sums, int tiles, int cap,
                     int* __restrict__ totals) {
  int* row = sums + static_cast<long long>(blockIdx.x) * tiles;
  const int chunk = (tiles + blockDim.x - 1) / blockDim.x;
  const int begin = min(tiles, threadIdx.x * chunk);
  const int end = min(tiles, begin + chunk);
  int sum = 0;
  for (int t = begin; t < end; ++t) sum += row[t];
  int total;
  int at = block_exclusive_scan(sum, &total);
  for (int t = begin; t < end; ++t) {
    const int v = row[t];
    row[t] = at;
    at += v;
  }
  if (totals != nullptr && threadIdx.x == 0)
    totals[blockIdx.x] = min(total, cap);
}

// each head gets its voxel id (the heads before it in point order)
__global__ void __launch_bounds__(kTileThreads)
    voxel_assign_kernel(HeadFlag f, const int* __restrict__ tile_off,
                        int max_voxels, int* __restrict__ pvid,
                        int* __restrict__ voxel_head) {
  const int b = blockIdx.y, tiles = gridDim.x;
  const int begin = blockIdx.x * kTile + threadIdx.x * kPer;
  int flags = 0, sum = 0;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int on = begin + u < f.n ? f(b, begin + u) : 0;
    flags |= on << u;
    sum += on;
  }
  int total;
  int vid = tile_off[b * tiles + blockIdx.x] +
            block_exclusive_scan(sum, &total);
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    if (flags >> u & 1) {
      pvid[static_cast<long long>(b) * f.n + begin + u] = vid;
      if (vid < max_voxels)
        voxel_head[static_cast<long long>(b) * max_voxels + vid] =
            begin + u;
      ++vid;
    }
  }
}

// one atomicAdd of the lanes' sum a distinct slot; returns each lane's
// position among its slot's lanes plus the slot's old value (-1 slot:
// not taking part)
__device__ int warp_aggregated_add(int* __restrict__ base, long long slot) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(kFull, slot);
  const int leader = __ffs(peers) - 1;
  int old = 0;
  if (slot >= 0 && lane == leader) old = atomicAdd(base + slot,
                                                   __popc(peers));
  old = __shfl_sync(kFull, old, leader);
  return old + __popc(peers & ((1u << lane) - 1));
}

__global__ void voxel_count_kernel(const int* __restrict__ key,
                                   const int* __restrict__ head,
                                   int* __restrict__ pvid, long long total,
                                   int n, long long cells, int max_voxels,
                                   int* __restrict__ count) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  long long slot = -1;
  if (i < total) {
    const long long b = i / n;
    const int k = key[i];
    int vid = -1;
    if (k >= 0) vid = pvid[b * n + head[b * cells + k]];
    // a head writes back its own id; no one reads the others' entries
    pvid[i] = vid;
    if (vid >= 0 && vid < max_voxels) slot = b * max_voxels + vid;
  }
  warp_aggregated_add(count, slot);
}

// each voxel's segment offset (the points of the voxels before it), its
// count, coordinates and mask; a voxel of more than long_len points
// joins the list the bitmap ranking takes
__global__ void __launch_bounds__(kTileThreads)
    voxel_offsets_kernel(VoxelCount f, const int* __restrict__ tile_off,
                         const int* __restrict__ voxel_head,
                         const int* __restrict__ coords,
                         const int* __restrict__ voxel_num, int n,
                         int max_points, int long_len,
                         int* __restrict__ offset, int* __restrict__ num,
                         int* __restrict__ coors, uint8_t* __restrict__ mask,
                         int* __restrict__ n_long,
                         int* __restrict__ long_list) {
  const int b = blockIdx.y, tiles = gridDim.x, nv = f.max_voxels;
  const int begin = blockIdx.x * kTile + threadIdx.x * kPer;
  int counts[kPer], sum = 0;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    counts[u] = begin + u < nv ? f(b, begin + u) : 0;
    sum += counts[u];
  }
  int total;
  int at = tile_off[b * tiles + blockIdx.x] +
           block_exclusive_scan(sum, &total);
  const int used = voxel_num[b];
  const long long row = static_cast<long long>(b) * nv;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int v = begin + u;
    if (v >= nv) break;
    offset[row + v] = at;
    at += counts[u];
    int* cv = coors + 3 * (row + v);
    if (v < used) {
      num[row + v] = min(counts[u], max_points);
      const int* c = coords + 3 * (static_cast<long long>(b) * n +
                                   voxel_head[row + v]);
      cv[0] = c[0];
      cv[1] = c[1];
      cv[2] = c[2];
      mask[row + v] = 1;
      if (counts[u] > long_len)
        long_list[atomicAdd(n_long, 1)] = static_cast<int>(row + v);
    } else {
      num[row + v] = 0;
      cv[0] = cv[1] = cv[2] = -1;
      mask[row + v] = 0;
    }
  }
}

__global__ void voxel_place_kernel(const int* __restrict__ pvid,
                                   const int* __restrict__ offset,
                                   long long total, int n, int max_voxels,
                                   int* __restrict__ fill,
                                   int* __restrict__ seg) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  long long slot = -1;
  long long b = 0;
  if (i < total) {
    b = i / n;
    const int vid = pvid[i];
    if (vid >= 0 && vid < max_voxels) slot = b * max_voxels + vid;
  }
  const int pos = warp_aggregated_add(fill, slot);
  if (slot >= 0) seg[b * n + offset[slot] + pos] = static_cast<int>(i % n);
}

__global__ void voxel_rank_kernel(const float* __restrict__ points,
                                  const int* __restrict__ pvid,
                                  const int* __restrict__ offset,
                                  const int* __restrict__ count,
                                  const int* __restrict__ seg,
                                  long long total, int n, int c,
                                  int max_voxels, int max_points,
                                  int long_len, float* __restrict__ voxels,
                                  int* __restrict__ slot_out) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= total) return;
  const int vid = pvid[i];
  int out = -1;
  if (vid >= 0 && vid < max_voxels) {
    const long long b = i / n;
    const int j = static_cast<int>(i % n);
    const long long slot = b * max_voxels + vid;
    const int* s = seg + b * n + offset[slot];
    const int len = count[slot];
    if (len > long_len) return;  // voxel_rank_long_kernel ranks it
    // eight loads in flight a step; the count may pass max_points inside
    // a step, which only says the point is dropped
    int rank = 0, t = 0;
    for (; t + 8 <= len && rank < max_points; t += 8) {
      int r = 0;
#pragma unroll
      for (int u = 0; u < 8; ++u) r += s[t + u] < j;
      rank += r;
    }
    for (; t < len && rank < max_points; ++t) rank += s[t] < j;
    if (rank < max_points) {
      out = vid * max_points + rank;
      float* dst = voxels + (slot * max_points + rank) * c;
      const float* src = points + i * c;
      for (int ch = 0; ch < c; ++ch) dst[ch] = src[ch];
    }
  }
  slot_out[i] = out;
}

// A voxel of more than long_len points, a block each: its points'
// indices as bits of a bitmap over the row in shared memory, the
// words' popcounts prefix-summed, and a point's rank the bits below it.
__global__ void __launch_bounds__(kScanThreads)
    voxel_rank_long_kernel(const float* __restrict__ points,
                           const int* __restrict__ offset,
                           const int* __restrict__ count,
                           const int* __restrict__ seg,
                           const int* __restrict__ n_long,
                           const int* __restrict__ long_list, int n, int c,
                           int max_voxels, int max_points,
                           float* __restrict__ voxels,
                           int* __restrict__ slot_out) {
  extern __shared__ unsigned bits[];
  const int words = (n + 31) >> 5;
  int* prefix = reinterpret_cast<int*>(bits + words);
  const int todo = *n_long;
  for (int item = blockIdx.x; item < todo; item += gridDim.x) {
    const int slot = long_list[item];
    const int b = slot / max_voxels, vid = slot % max_voxels;
    const int* s = seg + static_cast<long long>(b) * n + offset[slot];
    const int len = count[slot];
    for (int w = threadIdx.x; w < words; w += blockDim.x) bits[w] = 0;
    __syncthreads();
    for (int t = threadIdx.x; t < len; t += blockDim.x)
      atomicOr(&bits[s[t] >> 5], 1u << (s[t] & 31));
    __syncthreads();
    const int chunk = (words + blockDim.x - 1) / blockDim.x;
    const int begin = min(words, threadIdx.x * chunk);
    const int end = min(words, begin + chunk);
    int sum = 0;
    for (int w = begin; w < end; ++w) sum += __popc(bits[w]);
    int total;
    int at = block_exclusive_scan(sum, &total);
    for (int w = begin; w < end; ++w) {
      prefix[w] = at;
      at += __popc(bits[w]);
    }
    __syncthreads();
    for (int t = threadIdx.x; t < len; t += blockDim.x) {
      const int j = s[t];
      const int rank = prefix[j >> 5] +
                       __popc(bits[j >> 5] & ((1u << (j & 31)) - 1));
      const long long i = static_cast<long long>(b) * n + j;
      int out = -1;
      if (rank < max_points) {
        out = vid * max_points + rank;
        float* dst = voxels + (static_cast<long long>(slot) * max_points +
                               rank) * c;
        const float* src = points + i * c;
        for (int ch = 0; ch < c; ++ch) dst[ch] = src[ch];
      }
      slot_out[i] = out;
    }
    __syncthreads();  // the next voxel reuses the bitmap
  }
}

unsigned blocks_for(long long total) {
  return static_cast<unsigned>((total + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// points (total, c) f32 -> coords (total, 3) i32
int vlp3d_dynamic_voxelize(const float* points, long long total, int c,
                           float lo0, float lo1, float lo2, float vs0,
                           float vs1, float vs2, int g0, int g1, int g2,
                           int* coords, cudaStream_t stream) {
  if (total > 0)
    dynamic_voxelize_kernel<<<blocks_for(total), kThreads, 0, stream>>>(
        points, total, c, lo0, lo1, lo2, vs0, vs1, vs2, g0, g1, g2, coords);
  return static_cast<int>(cudaGetLastError());
}

// points (b, n, c) f32 and their coords (b, n, 3) i32 -> voxels
// (b, V, P, c), coors (b, V, 3), num (b, V), voxel_num (b,), mask (b, V)
// and each point's voxel * P + slot (or -1) in slot_out (b, n).
// workspace: 3 * b * n + b * cells + 5 * b * V + 1
//            + b * (ceil(n / kTile) + ceil(V / kTile)) ints.
int vlp3d_hard_voxelize(const float* points, const int* coords, int b, int n,
                        int c, int g0, int g1, int g2, int max_points,
                        int max_voxels, int* workspace, float* voxels,
                        int* coors, int* num, int* voxel_num, uint8_t* mask,
                        int* slot_out, cudaStream_t stream) {
  const long long total = static_cast<long long>(b) * n;
  const long long cells = static_cast<long long>(g0) * g1 * g2;
  const long long nv = static_cast<long long>(b) * max_voxels;
  const int tiles_n = (n + kTile - 1) / kTile;
  const int tiles_v = (max_voxels + kTile - 1) / kTile;
  int* key = workspace;
  int* pvid = key + total;
  int* seg = pvid + total;
  int* head = seg + total;
  int* voxel_head = head + b * cells;
  int* count = voxel_head + nv;
  int* fill = count + nv;
  int* n_long = fill + nv;
  int* offset = n_long + 1;
  int* long_list = offset + nv;
  int* sums_n = long_list + nv;
  int* sums_v = sums_n + static_cast<long long>(b) * tiles_n;
  // the bitmap ranking needs a row's bitmap and word prefix in shared
  // memory; past that every voxel takes the counting rank
  const int words = (n + 31) / 32;
  const size_t long_smem = sizeof(int) * 2 * static_cast<size_t>(words);
  const int long_len = long_smem <= kLongSmem ? kLongLen : INT_MAX;
  cudaMemsetAsync(head, 0x7f, sizeof(int) * b * cells, stream);  // > any n
  // count, fill and the long-voxel counter
  cudaMemsetAsync(count, 0, sizeof(int) * (2 * nv + 1), stream);
  cudaMemsetAsync(voxels, 0, sizeof(float) * nv * max_points * c, stream);
  if (total > 0) {
    voxel_head_kernel<<<blocks_for(total), kThreads, 0, stream>>>(
        coords, total, n, g0, g1, cells, key, head);
    const HeadFlag heads{key, head, n, cells};
    tile_sum_kernel<<<dim3(tiles_n, b), kTileThreads, 0, stream>>>(
        heads, n, sums_n);
    tile_scan_kernel<<<b, kScanThreads, 0, stream>>>(sums_n, tiles_n,
                                                     max_voxels, voxel_num);
    voxel_assign_kernel<<<dim3(tiles_n, b), kTileThreads, 0, stream>>>(
        heads, sums_n, max_voxels, pvid, voxel_head);
    voxel_count_kernel<<<blocks_for(total), kThreads, 0, stream>>>(
        key, head, pvid, total, n, cells, max_voxels, count);
  } else {
    cudaMemsetAsync(voxel_num, 0, sizeof(int) * b, stream);
  }
  if (max_voxels > 0) {
    const VoxelCount counts{count, max_voxels};
    tile_sum_kernel<<<dim3(tiles_v, b), kTileThreads, 0, stream>>>(
        counts, max_voxels, sums_v);
    tile_scan_kernel<<<b, kScanThreads, 0, stream>>>(sums_v, tiles_v, 0,
                                                     nullptr);
    voxel_offsets_kernel<<<dim3(tiles_v, b), kTileThreads, 0, stream>>>(
        counts, sums_v, voxel_head, coords, voxel_num, n, max_points,
        long_len, offset, num, coors, mask, n_long, long_list);
  }
  if (total > 0 && max_voxels > 0) {
    voxel_place_kernel<<<blocks_for(total), kThreads, 0, stream>>>(
        pvid, offset, total, n, max_voxels, fill, seg);
    voxel_rank_kernel<<<blocks_for(total), kThreads, 0, stream>>>(
        points, pvid, offset, count, seg, total, n, c, max_voxels,
        max_points, long_len, voxels, slot_out);
    if (long_len != INT_MAX) {
      if (long_smem > 48 * 1024)
        cudaFuncSetAttribute(voxel_rank_long_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(long_smem));
      voxel_rank_long_kernel<<<kLongBlocks, kScanThreads, long_smem,
                               stream>>>(
          points, offset, count, seg, n_long, long_list, n, c, max_voxels,
          max_points, voxels, slot_out);
    }
  } else if (total > 0) {
    cudaMemsetAsync(slot_out, 0xff, sizeof(int) * total, stream);  // -1
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
