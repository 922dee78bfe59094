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
// indices, never from the order atomics happen to run in. One memset and
// four dependent kernels after the dynamic one:
//   (a) voxel_head_count_kernel: each point's linear cell key; the cell
//       table (a dense {head, count} pair a grid cell a batch row) keeps
//       n - (the cell's first point's index) by atomicMax (0: empty) and
//       the cell's count. Lanes of a warp in one cell (__match_any_sync)
//       make one atomic of each, and a cell several lanes meet gathers
//       its block's in shared memory first (HotTable), since a cell may
//       hold 20 000 points and atomics on one address serialise. One
//       memset clears the table, the scan's status words and its ticket;
//   (b) voxel_scan_kernel: one single-pass prefix sum over the points in
//       point order, a tile of kTile points a block, tiles taken in the
//       order of an atomic ticket (so a tile's predecessors are running
//       and the look-back cannot deadlock), one chain a batch row. It
//       sums the pair (heads so far, points of those heads so far) packed
//       in 64 bits; a tile publishes its sum and then its inclusive prefix
//       in one 64-bit status word, flag and value together, and a warp
//       looks back over 32 predecessors at a time. A head's exclusive
//       pair is its voxel id and, since ids grow with the head's index
//       and every earlier head is kept when it is, its segment's offset
//       among the kept voxels' points. A kept head records its voxel's
//       first point, offset and count, and turns its cell's head entry
//       into -1 - offset (never n - j, so a later read of the entry still
//       finds no head); the row's last tile writes voxel_num =
//       min(heads, max_voxels);
//   (c) voxel_place_kernel: every point takes one from its cell's head
//       entry (one atomicSub for a warp's lanes in one cell, or a
//       block's, through the same shared table as (a)); an entry
//       below 0 gives the point the next place of its voxel's segment, in
//       whatever order the atomics run, and a dropped cell's entry (n - its
//       head's index) stays above 0. Every point writes -1 as its slot;
//   (d) voxel_write_kernel: a warp writes the whole rows of kVox voxels,
//       max_points x C floats each, once, with coalesced stores, zeros
//       after the last kept point, and their coordinates, counts and
//       masks; a voxel past voxel_num is zeros, -1, 0 and false. The kept
//       points are the min(count, max_points) smallest indices of the
//       segment, slot s the s-th: a segment of up to 32 is sorted in the
//       warp's registers (bitonic, by shuffles); a longer one, where
//       max_points <= 32 and it holds at most kWarpLong points, by a
//       running merge of the 32 smallest in registers (a 32-point chunk
//       is merged only if it holds one below the 32nd smallest so far);
//       the rest by the whole block after its warps are done, as a bitmap
//       of the segment's indices over a window of the row in shared
//       memory, whose set bits a thread's share of words counts and a
//       block scan places; the block then copies the kept points.
//
// What bounds it on the H100: bytes, most of them the voxels written
// once (4 x 16000 x 32 x 4 floats at PointPillars' KITTI widths, 32.8 MB
// of the call's 43.5); then the cell table's random accesses (a few a
// point, each a 32-byte sector), the atomics on a hot cell (one address,
// serialised) and the dependent launches.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
// points a thread of (a) and (c), kThreads apart; points a block
constexpr int kPts = 4;
constexpr int kSpan = kPts * kThreads;
// a tile of the points' prefix sum: kTileThreads threads of kPer items
constexpr int kTileThreads = 256;
constexpr int kPer = 8;
constexpr int kTile = kTileThreads * kPer;  // VOXEL_TILE in voxelize.py
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

// A block's table of the cells that several lanes of one of its warps
// meet (the hot ones among them: a pillar of 20 000 points meets ~5
// lanes of every warp): their atomics are gathered in shared memory and
// made once a block on the cell table. A cell that finds no slot in
// kProbe probes makes its own.
constexpr int kHot = 64;
constexpr int kProbe = 4;

struct HotTable {
  int key[kHot], count[kHot], head[kHot], base[kHot];

  __device__ void clear() {
    for (int t = threadIdx.x; t < kHot; t += blockDim.x) {
      key[t] = -1;
      count[t] = 0;
      head[t] = 0;
    }
  }
  // the slot of cell k, claimed if free; -1 when none is found
  __device__ int slot(int k) {
    int t = static_cast<int>((static_cast<unsigned>(k) * 2654435761u) >> 26);
    for (int p = 0; p < kProbe; ++p, t = (t + 1) & (kHot - 1)) {
      const int prev = atomicCAS(&key[t], -1, k);
      if (prev == -1 || prev == k) return t;
    }
    return -1;
  }
};

// (a) keys, heads and counts. cell: (b, cells) of {head, count}, zero.
// Grid: x = spans of kSpan points of a row, y = batch rows; a thread
// takes kPts points kThreads apart, their loads together.
__global__ void __launch_bounds__(kThreads)
    voxel_head_count_kernel(const int* __restrict__ coords, int n, int g0,
                            int g1, long long cells, int* __restrict__ key,
                            int2* __restrict__ cell) {
  __shared__ HotTable hot;
  const int b = blockIdx.y, lane = threadIdx.x & 31;
  const int j0 = blockIdx.x * kSpan + threadIdx.x;
  const int* cr = coords + 3LL * b * n;
  int* kr = key + static_cast<long long>(b) * n;
  int2* cb = cell + b * cells;
  hot.clear();
  int x[kPts], y[kPts], z[kPts];
#pragma unroll
  for (int r = 0; r < kPts; ++r) {
    const int j = j0 + r * kThreads;
    x[r] = j < n ? cr[3 * j] : -1;
    y[r] = j < n ? cr[3 * j + 1] : -1;
    z[r] = j < n ? cr[3 * j + 2] : -1;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kPts; ++r) {
    const int j = j0 + r * kThreads;
    const int k = x[r] < 0 ? -1 : (z[r] * g1 + y[r]) * g0 + x[r];
    if (j < n) kr[j] = k;
    // lanes in one cell: the lowest holds the smallest index (lanes
    // follow the points) and makes the cell's atomics for all
    const unsigned peers = __match_any_sync(kFull, k);
    if (k >= 0 && lane == __ffs(peers) - 1) {
      const int t = __popc(peers) > 1 ? hot.slot(k) : -1;
      if (t >= 0) {
        atomicMax(&hot.head[t], n - j);
        atomicAdd(&hot.count[t], __popc(peers));
      } else {
        atomicMax(&cb[k].x, n - j);
        atomicAdd(&cb[k].y, __popc(peers));
      }
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < kHot; t += blockDim.x) {
    const int k = hot.key[t];
    if (k < 0) continue;
    int* h = &cb[k].x;
    if (hot.head[t] > *h) atomicMax(h, hot.head[t]);
    atomicAdd(&cb[k].y, hot.count[t]);
  }
}

// a tile's status word: flag << 62 | (heads << 31 | points)
constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kInclusive = 2ull << 62;
constexpr unsigned long long kValue = (1ull << 62) - 1;

// A status word carries its flag and its value in one 64-bit access, and
// nothing else is published through it, so relaxed (not release /
// acquire) stores and loads at the GPU's scope suffice: no fence.
__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// (b) the pair prefix sum over the points. status: (b, tiles) words and a
// ticket, zero; vinfo: (b, max_voxels) of {first point, offset, count}.
__global__ void __launch_bounds__(kTileThreads)
    voxel_scan_kernel(const int* __restrict__ key, int2* __restrict__ cell,
                      int n, int tiles, long long cells, int max_voxels,
                      unsigned long long* __restrict__ status,
                      unsigned* __restrict__ ticket,
                      int4* __restrict__ vinfo, int* __restrict__ voxel_num) {
  __shared__ unsigned long long warp_sums[kTileThreads / 32];
  __shared__ unsigned long long tile_excl;
  __shared__ unsigned tile_id;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) tile_id = atomicAdd(ticket, 1u);
  __syncthreads();
  const int b = tile_id / tiles, tile = tile_id % tiles;
  const int begin = tile * kTile + threadIdx.x * kPer;
  const int* kb = key + static_cast<long long>(b) * n;
  int2* cb = cell + b * cells;
  int k[kPer];
  if ((n & 3) == 0 && begin + kPer <= n) {
#pragma unroll
    for (int v = 0; v < kPer / 4; ++v) {
      const int4 f = *reinterpret_cast<const int4*>(kb + begin + 4 * v);
      k[4 * v] = f.x;
      k[4 * v + 1] = f.y;
      k[4 * v + 2] = f.z;
      k[4 * v + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int u = 0; u < kPer; ++u) k[u] = begin + u < n ? kb[begin + u] : -1;
  }
  int heads = 0, c[kPer];  // bit u: point begin + u is its cell's head
  unsigned long long mine = 0;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    c[u] = 0;
    if (k[u] >= 0) {
      const int2 e = cb[k[u]];
      if (e.x == n - (begin + u)) {
        heads |= 1 << u;
        c[u] = e.y;
        mine += (1ull << 31) + e.y;
      }
    }
  }
  // the block's exclusive scan of the pairs, and its total
  unsigned long long x = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    unsigned long long w = lane < kTileThreads / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kTileThreads / 32) warp_sums[lane] = w;
    const unsigned long long agg =
        __shfl_sync(kFull, w, kTileThreads / 32 - 1);
    unsigned long long* st = status + static_cast<long long>(b) * tiles;
    // publish the tile's sum, look back for its prefix, publish that
    unsigned long long excl = 0;
    if (tile == 0) {
      if (lane == 0) store_status(st, kInclusive | agg);
    } else {
      if (lane == 0) store_status(st + tile, kAggregate | agg);
      for (int p = tile - 1;; p -= 32) {
        const int q = p - lane;
        unsigned long long s = kInclusive;  // before tile 0: nothing
        if (q >= 0) {
          do {
            s = load_status(st + q);
          } while (s == 0);
        }
        const unsigned inc = __ballot_sync(kFull, s >= kInclusive);
        const int stop = inc ? __ffs(inc) - 1 : 31;
        unsigned long long v = lane <= stop ? s & kValue : 0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
        excl += v;
        if (inc) break;
      }
      if (lane == 0) store_status(st + tile, kInclusive | (excl + agg));
    }
    if (lane == 0) {
      tile_excl = excl;
      if (tile == tiles - 1) {
        const int all = static_cast<int>((excl + agg) >> 31);
        voxel_num[b] = min(all, max_voxels);
      }
    }
  }
  __syncthreads();
  if (heads == 0) return;
  unsigned long long at = tile_excl + (warp ? warp_sums[warp - 1] : 0) + x -
                          mine;
  const long long row = static_cast<long long>(b) * max_voxels;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    if (!(heads >> u & 1)) continue;
    const int vid = static_cast<int>(at >> 31);
    const int off = static_cast<int>(at & 0x7fffffff);
    if (vid < max_voxels) {
      vinfo[row + vid] = make_int4(begin + u, off, c[u], 0);
      cb[k[u]].x = -1 - off;
    }
    at += (1ull << 31) + c[u];
  }
}

// (c) each point of a kept cell into its voxel's segment; every slot -1.
// Every point of a cell subtracts from its head entry: a kept cell's is
// -1 - its next place, a dropped cell's n - its head's index, which its
// points (no more than that many) cannot bring below 1. Grid as (a); a
// cell several lanes meet takes its block's places in one atomicSub.
__global__ void __launch_bounds__(kThreads)
    voxel_place_kernel(const int* __restrict__ key, int2* __restrict__ cell,
                       int n, long long cells, int* __restrict__ seg,
                       int* __restrict__ slot_out) {
  __shared__ HotTable hot;
  const int b = blockIdx.y, lane = threadIdx.x & 31;
  const int j0 = blockIdx.x * kSpan + threadIdx.x;
  const int* kr = key + static_cast<long long>(b) * n;
  int2* cb = cell + b * cells;
  int* sr = seg + static_cast<long long>(b) * n;
  hot.clear();
  int k[kPts], old[kPts], t[kPts];
  unsigned peers[kPts];
#pragma unroll
  for (int r = 0; r < kPts; ++r) {
    const int j = j0 + r * kThreads;
    k[r] = j < n ? kr[j] : -1;
    if (j < n) slot_out[static_cast<long long>(b) * n + j] = -1;
  }
  __syncthreads();
  // a leader's old value: from its own atomic, or (a hot slot) its
  // share's start within the block's, the block's base added below
#pragma unroll
  for (int r = 0; r < kPts; ++r) {
    peers[r] = __match_any_sync(kFull, k[r]);
    old[r] = 0;
    t[r] = -1;
    if (k[r] >= 0 && lane == __ffs(peers[r]) - 1) {
      t[r] = __popc(peers[r]) > 1 ? hot.slot(k[r]) : -1;
      if (t[r] >= 0)
        old[r] = -atomicAdd(&hot.count[t[r]], __popc(peers[r]));
      else
        old[r] = atomicSub(&cb[k[r]].x, __popc(peers[r]));
    }
  }
  __syncthreads();
  for (int s = threadIdx.x; s < kHot; s += blockDim.x)
    if (hot.key[s] >= 0)
      hot.base[s] = atomicSub(&cb[hot.key[s]].x, hot.count[s]);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kPts; ++r) {
    const int leader = __ffs(peers[r]) - 1;
    if (t[r] >= 0) old[r] += hot.base[t[r]];
    const int o = __shfl_sync(kFull, old[r], leader);
    if (k[r] >= 0 && o < 0)
      sr[(-1 - o) + __popc(peers[r] & ((1u << lane) - 1))] =
          j0 + r * kThreads;
  }
}

// (d) a warp kVox voxels, kWriteWarps warps a block; a segment of over 32
// points by the warp's running merge (max_points <= 32, up to kWarpLong
// points), else by the whole block after the rest. Dynamic shared
// memory: the bitmap window, `words` words (at most kWindowWords).
constexpr int kWriteWarps = 8;
constexpr int kVox = 4;
constexpr int kWarpLong = 1024;
constexpr int kWindowWords = 8192;
constexpr int kSel = 256;  // slots a block lists before it copies them

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

// x sorted ascending across the warp's lanes (bitonic)
__device__ __forceinline__ int sort32(int x, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int d = k >> 1; d > 0; d >>= 1) {
      const int o = __shfl_xor_sync(kFull, x, d);
      const bool up = (lane & k) == 0, low = (lane & d) == 0;
      x = low == up ? min(x, o) : max(x, o);
    }
  }
  return x;
}

// the 32 smallest of cur (ascending across the lanes) and y, ascending
__device__ __forceinline__ int merge32(int cur, int y, int lane) {
  y = sort32(y, lane);
  int m = min(cur, __shfl_sync(kFull, y, 31 - lane));  // bitonic
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int o = __shfl_xor_sync(kFull, m, d);
    m = lane & d ? max(m, o) : min(m, o);
  }
  return m;
}

// a voxel's row of max_points x cv units: slot s < kept from the point
// lane s of x names, zeros after; kept <= 32
template <typename V>
__device__ __forceinline__ void write_row(V* dst, const V* src, int cv,
                                          int max_points, int kept, int x,
                                          int lane) {
  const int total = max_points * cv;
  for (int e0 = 0; e0 < total; e0 += 32) {
    const int e = e0 + lane;
    const int s = cv == 1 ? e : e / cv;
    const int j = __shfl_sync(kFull, x, s & 31);  // every lane shuffles
    if (e < total)
      dst[e] = s < kept ? src[static_cast<long long>(j) * cv + (e - s * cv)]
                        : vzero<V>();
  }
}

template <typename V>
__global__ void __launch_bounds__(32 * kWriteWarps)
    voxel_write_kernel(const V* __restrict__ points,
                       const int* __restrict__ coords,
                       const int* __restrict__ seg,
                       const int4* __restrict__ vinfo,
                       const int* __restrict__ voxel_num, int n, int cv,
                       int max_voxels, int max_points, int words,
                       V* __restrict__ voxels, int* __restrict__ coors,
                       int* __restrict__ num, uint8_t* __restrict__ mask,
                       int* __restrict__ slot_out) {
  extern __shared__ unsigned bits[];
  __shared__ int sel[kSel];
  __shared__ int long_v[kWriteWarps * kVox];
  __shared__ int n_long;
  __shared__ int scan[kWriteWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x;  // rows interleaved: low voxel ids first
  const int v0 = (blockIdx.y * kWriteWarps + warp) * kVox;
  const long long row = static_cast<long long>(b) * max_voxels;
  const V* src = points + static_cast<long long>(b) * n * cv;
  const int* sb = seg + static_cast<long long>(b) * n;
  int* so = slot_out + static_cast<long long>(b) * n;
  if (threadIdx.x == 0) n_long = 0;
  // lane q < kVox: voxel v0 + q's count, offset and first point, read
  // beside voxel_num (entries past it are not used)
  int mc = 0, mo = 0, mh = 0;
  if (lane < kVox && v0 + lane < max_voxels) {
    const int4 f = vinfo[row + v0 + lane];
    mh = f.x;
    mo = f.y;
    mc = f.z;
  }
  const int used = voxel_num[b];
  if (v0 + lane >= used) mc = 0;
  // coordinates (3 kVox lanes), then counts and masks (2 kVox lanes)
  {
    const int q = lane / 3 & (kVox - 1);
    const int hq = __shfl_sync(kFull, mh, q);
    const int v = v0 + q;
    if (lane < 3 * kVox && v < max_voxels)
      coors[3 * (row + v) + lane % 3] =
          v < used ? coords[3 * (static_cast<long long>(b) * n + hq) +
                            lane % 3]
                   : -1;
    const int q2 = lane & (kVox - 1), v2 = v0 + q2;
    if (lane < 2 * kVox && v2 < max_voxels) {
      if (lane < kVox)
        num[row + v2] = min(mc, max_points);
      else
        mask[row + v2] = v2 < used;
    }
  }
  // segments of up to 32 points: loaded together, sorted in registers
  int x[kVox];
#pragma unroll
  for (int q = 0; q < kVox; ++q) {
    const int cq = __shfl_sync(kFull, mc, q), oq = __shfl_sync(kFull, mo, q);
    x[q] = cq <= 32 && lane < cq ? sb[oq + lane] : INT_MAX;
  }
  __syncthreads();  // n_long is set
#pragma unroll
  for (int q = 0; q < kVox; ++q) {
    const int v = v0 + q;
    const int cq = __shfl_sync(kFull, mc, q);
    const bool block = cq > 32 && (max_points > 32 || cq > kWarpLong);
    if (v < max_voxels && block && lane == 0)
      long_v[atomicAdd(&n_long, 1)] = v;
    if (v < max_voxels && !block) {
      if (cq > 32) {
        // the running 32 smallest, a chunk of 32 merged only when it
        // holds one below the 32nd smallest so far; four chunks' loads
        // in flight
        const int* sg = sb + __shfl_sync(kFull, mo, q);
        x[q] = sort32(sg[lane], lane);
        for (int base = 32; base < cq; base += 128) {
          int y[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int t = base + 32 * u + lane;
            y[u] = t < cq ? sg[t] : INT_MAX;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (__any_sync(kFull, y[u] < __shfl_sync(kFull, x[q], 31)))
              x[q] = merge32(x[q], y[u], lane);
        }
      } else if (cq > 1) {
        x[q] = sort32(x[q], lane);
      }
      const int kept = min(cq, max_points);
      if (lane < kept) so[x[q]] = v * max_points + lane;
      write_row(voxels + (row + v) * max_points * cv, src, cv, max_points,
                kept, x[q], lane);
    }
  }
  __syncthreads();
  // the rest, the whole block each: the segment's indices as bits over
  // windows of the row, slot s the s-th set bit
  const int todo = n_long;
  for (int item = 0; item < todo; ++item) {
    const int lv = long_v[item];
    const int4 f = vinfo[row + lv];
    const int cnt = f.z, off = f.y;
    const int kept = min(cnt, max_points);
    const int* sg = sb + off;
    V* dst = voxels + (row + lv) * max_points * cv;
    // zeros past the kept points
    for (int e = kept * cv + threadIdx.x; e < max_points * cv;
         e += blockDim.x)
      dst[e] = vzero<V>();
    int got = 0;
    for (int w0 = 0; got < kept && w0 < n; w0 += 32 * words) {
      for (int w = threadIdx.x; w < words; w += blockDim.x) bits[w] = 0;
      __syncthreads();
      // the segment as int4 past its first unaligned entries, four
      // loads in flight a thread
      const int lead = min(cnt, static_cast<int>(
                                    (4 - ((reinterpret_cast<uintptr_t>(sg) >>
                                           2) & 3)) & 3));
      const int quads = (cnt - lead) >> 2;
      const int4* s4 = reinterpret_cast<const int4*>(sg + lead);
      const int span = 32 * words;
      auto set_bit = [&](int j) {
        j -= w0;
        if (j >= 0 && j < span) atomicOr(&bits[j >> 5], 1u << (j & 31));
      };
      for (int t = threadIdx.x; t < lead + ((cnt - lead) & 3);
           t += blockDim.x)
        set_bit(t < lead ? sg[t] : sg[lead + 4 * quads + t - lead]);
      for (int t0 = threadIdx.x; t0 < quads; t0 += 4 * blockDim.x) {
        int4 f[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int t = t0 + u * blockDim.x;
          f[u] = t < quads ? s4[t] : make_int4(w0 - 1, w0 - 1, w0 - 1, w0 - 1);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          set_bit(f[u].x);
          set_bit(f[u].y);
          set_bit(f[u].z);
          set_bit(f[u].w);
        }
      }
      __syncthreads();
      // a thread's consecutive words, counted, then placed by a scan
      const int per = (words + blockDim.x - 1) / blockDim.x;
      const int lo = min(words, static_cast<int>(threadIdx.x) * per);
      const int hi = min(words, lo + per);
      int mine = 0;
      for (int w = lo; w < hi; ++w) mine += __popc(bits[w]);
      int incl = mine;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      if (lane == 31) scan[warp] = incl;
      __syncthreads();
      int before = got;
      for (int q = 0; q < warp; ++q) before += scan[q];
      int all = got;
      for (int q = 0; q < kWriteWarps; ++q) all += scan[q];
      // slots [got, last) of this window, kSel at a time: each thread
      // lists the points of its slots, then the block copies them
      const int first = before + incl - mine, last = min(all, kept);
      for (int s0 = got; s0 < last; s0 += kSel) {
        const int s1 = min(s0 + kSel, last);
        int s = first;
        for (int w = lo; w < hi && s < s1; ++w) {
          for (unsigned m = bits[w]; m && s < s1; m &= m - 1, ++s) {
            if (s < s0) continue;
            const int j = w0 + 32 * w + __ffs(m) - 1;
            sel[s - s0] = j;
            so[j] = lv * max_points + s;
          }
        }
        __syncthreads();
        const int units = (s1 - s0) * cv;
        for (int e = threadIdx.x; e < units; e += blockDim.x) {
          const int q = cv == 1 ? e : e / cv;
          dst[s0 * cv + e] =
              src[static_cast<long long>(sel[q]) * cv + (e - q * cv)];
        }
        __syncthreads();
      }
      got = last;
      __syncthreads();  // the next window or voxel rewrites the bitmap
    }
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
// workspace: 2 * b * n + 2 * b * ceil(n / kTile) + 2 + 2 * b * cells
//            + 3 + 4 * b * V ints, 16-byte aligned. Device operations: one
// memset (the cell tables, the scan's status words and ticket), then the
// four kernels (a)-(d); voxels is written once, by (d).
int vlp3d_hard_voxelize(const float* points, const int* coords, int b, int n,
                        int c, int g0, int g1, int g2, int max_points,
                        int max_voxels, int* workspace, float* voxels,
                        int* coors, int* num, int* voxel_num, uint8_t* mask,
                        int* slot_out, cudaStream_t stream) {
  const long long total = static_cast<long long>(b) * n;
  const long long cells = static_cast<long long>(g0) * g1 * g2;
  const long long nv = static_cast<long long>(b) * max_voxels;
  const int tiles = (n + kTile - 1) / kTile;
  int* key = workspace;
  int* seg = key + total;
  // the memset's part: status words, ticket, cell table
  auto* status = reinterpret_cast<unsigned long long*>(seg + total);
  auto* ticket = reinterpret_cast<unsigned*>(status + b * tiles);
  auto* cell = reinterpret_cast<int2*>(ticket + 2);
  // vinfo on the next 16-byte boundary (at most three ints of padding)
  const long long at = (2 * total + 2LL * b * tiles + 2 + 2 * b * cells +
                        3) & ~3LL;
  auto* vinfo = reinterpret_cast<int4*>(workspace + at);
  cudaMemsetAsync(status, 0,
                  sizeof(int) * (2LL * b * tiles + 2 + 2 * b * cells),
                  stream);
  if (total > 0) {
    const dim3 span((n + kSpan - 1) / kSpan, b);
    voxel_head_count_kernel<<<span, kThreads, 0, stream>>>(
        coords, n, g0, g1, cells, key, cell);
    voxel_scan_kernel<<<b * tiles, kTileThreads, 0, stream>>>(
        key, cell, n, tiles, cells, max_voxels, status, ticket, vinfo,
        voxel_num);
    voxel_place_kernel<<<span, kThreads, 0, stream>>>(key, cell, n, cells,
                                                       seg, slot_out);
  } else {
    cudaMemsetAsync(voxel_num, 0, sizeof(int) * b, stream);
  }
  if (max_voxels > 0) {
    // the long voxels' bitmap: a window of the row's indices
    const int words = static_cast<int>(
        std::max(1LL, std::min<long long>((n + 31) / 32, kWindowWords)));
    const int per_block = kWriteWarps * kVox;
    const dim3 grid(b, (max_voxels + per_block - 1) / per_block);
    const size_t smem = sizeof(unsigned) * words;
    if (c % 4 == 0 && reinterpret_cast<uintptr_t>(points) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(voxels) % 16 == 0)
      voxel_write_kernel<float4><<<grid, 32 * kWriteWarps, smem, stream>>>(
          reinterpret_cast<const float4*>(points), coords, seg, vinfo,
          voxel_num, n, c / 4, max_voxels, max_points, words,
          reinterpret_cast<float4*>(voxels), coors, num, mask, slot_out);
    else
      voxel_write_kernel<float><<<grid, 32 * kWriteWarps, smem, stream>>>(
          points, coords, seg, vinfo, voxel_num, n, c, max_voxels,
          max_points, words, voxels, coors, num, mask, slot_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
