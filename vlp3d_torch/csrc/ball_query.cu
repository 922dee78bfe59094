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
// What bounds it on the H100: the distance tests. At SA1 (8 rows of
// 40960 points, 2048 centers each, r = 0.2, 64 slots) almost no ball
// fills, so nearly every center scans its whole row: 671M tests of 9
// fp32 instructions that cannot fuse (3 sub, 3 mul, 2 add, compare), 0.18
// ms at the card's 33.4e12 non-FMA instructions a second. The bytes (a
// row's 480 KB, read by every center) come from L1 or L2; a design that
// loads a point from there once a test is bound by those loads instead.
//
// ball_query_tile_kernel<L>: a block owns one center a thread (in
//   registers) of one batch row and one contiguous segment of the row's
//   points. The segment streams through shared memory in tiles, double
//   buffered with 4-byte cp.async (a row's xyz has no 16-byte alignment
//   at an arbitrary point), and every lane of a warp reads the same
//   point: a broadcast, three 16-byte shared loads for four points. A
//   thread tests eight points before one branch on their hits, so the
//   eight chains overlap. So a test costs its arithmetic and a fraction
//   of a load. Each thread appends its center's hits to a list of its
//   own in shared memory, in scan order, with no ballot and no atomics; a
//   hit is kept as its 2-byte offset in the segment (L = unsigned short,
//   segments of at most 65536 points), so that the lists, which bound
//   how many blocks an SM holds, stay small. (Two centers a thread, to
//   share each shared load, lost at every site on an H100: twice the
//   list space a thread halves the blocks an SM holds.) The block stops
//   after a tile in which every center it holds has nsample hits
//   (__syncthreads_and), unless counts are wanted.
//   A row has few centers for a card of 132 SMs (SA1: 2048 a row, 16384
//   in all, 512 warps at one a thread), so the points of a row are cut
//   into S contiguous segments, one a block of a thread-block cluster of
//   S blocks. After one cluster barrier block s reads the segment counts
//   of the other blocks through distributed shared memory, and writes its
//   hits at slots [offset, offset + count) below nsample, offset being
//   the sum of the counts of blocks < s; the lowest block with a hit
//   writes the padding (block 0 the zeros of an empty ball) and block 0
//   the summed count. No second launch and no global scratch.
// ball_query_kernel: the first design, kept for shapes where no tile
//   plan is faster and as the yardstick the smoke run times beside it.
//   One warp takes one center and tests 32 consecutive points a step
//   straight from L1/L2 (three 4-byte loads a lane at a 12-byte stride:
//   9 L1 wavefronts a step where 3 would do); __ballot_sync plus __popc
//   of the lower lanes gives each hit its slot in scan order, and the
//   warp stops as soon as nsample hits are placed.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "batch_rows.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;  // centers per block of ball_query_kernel
constexpr int kMaxCluster = 16;
constexpr int kMaxSmem = 232448;  // bytes a block may have on sm_90

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

__global__ void __launch_bounds__(kWarps * 32)
    ball_query_kernel(const float* __restrict__ xyz,
                      const float* __restrict__ centers, int B, int n, int m,
                      float r2, int nsample, int* __restrict__ idx,
                      int* __restrict__ count) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int b = grid_row();
  if (c >= m || b >= B) return;  // the whole warp leaves together

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

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// Shared memory of ball_query_tile_kernel: two tiles of `tile` points
// (x, y, z) and, for each of the block's centers (one a thread), its
// segment count, offset, total and first block (4-byte words), then its
// hit list of nsample | 1 entries of L (the odd stride spreads the lists
// over the banks). A hit is kept as its offset from the segment's first
// point, so a segment of at most 65536 points takes 2-byte entries.
size_t tile_smem_bytes(int threads, int tile, int nsample,
                       size_t list_entry) {
  return 4 * ((size_t)6 * tile + (size_t)4 * threads) +
         list_entry * threads * (nsample | 1);
}

// Grid: x = cluster blocks (segments) x center tiles, y = batch rows;
// `seg` points a segment, `tile` points a shared-memory tile (a multiple
// of 4), `segs` blocks a cluster (1: no cluster).
template <typename L>
__global__ void __launch_bounds__(1024)
    ball_query_tile_kernel(const float* __restrict__ xyz,
                           const float* __restrict__ centers, int B, int n,
                           int m, float r2, int nsample, int seg, int tile,
                           int segs, int* __restrict__ idx,
                           int* __restrict__ count) {
  extern __shared__ __align__(16) float smem[];
  const int threads = blockDim.x, tid = threadIdx.x;
  const int stride = nsample | 1;
  float* tiles = smem;
  int* seg_cnt = reinterpret_cast<int*>(smem + 6 * tile);
  int* offs = seg_cnt + threads;
  int* totals = offs + threads;
  int* firsts = totals + threads;
  L* lists = reinterpret_cast<L*>(firsts + threads);
  L* list = lists + tid * stride;  // this thread's center's hits

  const int b = grid_row();
  if (b >= B) return;  // the whole block, before any barrier
  const int rank = blockIdx.x % segs;
  const int c0 = blockIdx.x / segs * threads;
  const bool live = c0 + tid < m;
  const bool with_count = count != nullptr;

  const float nan = __int_as_float(0x7fc00000);  // never in a ball
  const float* q = centers + 3 * ((size_t)b * m + c0 + tid);
  const float cx = live ? q[0] : nan, cy = live ? q[1] : nan,
              cz = live ? q[2] : nan;
  int cnt = 0;

  const int lo = min(n, rank * seg), hi = min(n, lo + seg);
  const int ntiles = (hi - lo + tile - 1) / tile;
  const float* row = xyz + (size_t)b * n * 3;

  auto load = [&](int t) {
    const int p0 = lo + t * tile;
    const int nf = 3 * min(tile, hi - p0);
    float* dst = tiles + (t & 1) * 3 * tile;
    const float* src = row + 3 * (size_t)p0;
    for (int f = tid; f < nf; f += threads) cp_async4(dst + f, src + f);
    cp_async_commit();
  };

  auto in_ball = [&](float px, float py, float pz) {
    return sq3(__fsub_rn(cx, px), __fsub_rn(cy, py), __fsub_rn(cz, pz)) < r2;
  };
  // k: the hit's offset from the segment's first point
  auto append = [&](int k) {
    if (cnt < nsample) list[cnt] = (L)k;
    ++cnt;
  };

  if (ntiles > 0) load(0);
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      load(t + 1);  // into the buffer every thread left after tile t - 1
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = t * tile;  // offset of the tile in the segment
    const int np = min(tile, hi - lo - k0);
    const float* tp = tiles + (t & 1) * 3 * tile;
    const float4* t4 = reinterpret_cast<const float4*>(tp);
    int j = 0;
    for (; j + 8 <= np; j += 8) {  // four points are three float4
      float x[24];
#pragma unroll
      for (int w = 0; w < 6; ++w) {
        const float4 v = t4[3 * (j >> 2) + w];
        x[4 * w] = v.x;
        x[4 * w + 1] = v.y;
        x[4 * w + 2] = v.z;
        x[4 * w + 3] = v.w;
      }
      // eight tests first, one branch for all eight: hits are rare
      unsigned hit = 0;
#pragma unroll
      for (int h = 0; h < 8; ++h)
        hit |= (unsigned)in_ball(x[3 * h], x[3 * h + 1], x[3 * h + 2]) << h;
      if (hit) {
#pragma unroll
        for (int h = 0; h < 8; ++h)
          if (hit >> h & 1u) append(k0 + j + h);
      }
    }
    for (; j < np; ++j)
      if (in_ball(tp[3 * j], tp[3 * j + 1], tp[3 * j + 2])) append(k0 + j);
    const bool done = !with_count && (cnt >= nsample || !live);
    // also keeps the buffer of tile t until every thread has tested it
    if (__syncthreads_and(done)) break;
  }
  cp_async_wait<0>();  // nothing may still land after an early stop

  seg_cnt[tid] = cnt;

  // merge the segments: every block's counts are visible after the
  // barrier; a peer's shared memory is read through the cluster window
  cg::cluster_group cluster = cg::this_cluster();
  if (segs > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }
  {
    int off = 0, total = 0, first = -1;
    for (int s = 0; s < segs; ++s) {
      const int cs = s == rank ? cnt : *cluster.map_shared_rank(
                                           seg_cnt + tid, (unsigned)s);
      if (s < rank) off += cs;
      if (first < 0 && cs > 0) first = s;
      total += cs;
    }
    offs[tid] = off;
    totals[tid] = total;
    firsts[tid] = first < 0 ? 0 : first;  // block 0 writes an empty ball
  }
  // no block may leave while a peer still reads its counts; also makes
  // this block's offsets visible to all its warps
  if (segs > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }

  // write out: a warp a center, its lanes over the slots (coalesced)
  const int lane = tid & 31, warps = threads >> 5;
  for (int local = tid >> 5; local < threads; local += warps) {
    const int c = c0 + local;
    if (c >= m) break;
    const int own = seg_cnt[local], off = offs[local], total = totals[local];
    const bool pads = firsts[local] == rank;
    const int filled = min(total, nsample);
    const L* hits = lists + local * stride;
    int* out = idx + ((size_t)b * m + c) * nsample;
    for (int j = lane; j < nsample; j += 32) {
      if (j >= off && j - off < own) {
        out[j] = lo + (int)hits[j - off];
      } else if (pads && j >= filled) {
        out[j] = total > 0 ? lo + (int)hits[0] : 0;
      }
    }
    if (with_count && rank == 0 && lane == 0)
      count[(size_t)b * m + c] = total;
  }
}

template <typename L>
int launch_tile(const float* xyz, const float* centers, int b, int n, int m,
                float r2, int nsample, int* idx, int* count, int threads,
                int segs, int tile, cudaStream_t stream) {
  const int seg = (n + segs - 1) / segs;
  tile = std::max(4, std::min(tile, (seg + 3) / 4 * 4));  // within a segment
  const size_t smem = tile_smem_bytes(threads, tile, nsample, sizeof(L));
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = ball_query_tile_kernel<L>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && segs > 8)  // past the portable cluster size
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it
    return (int)err;
  }
  const int blocks_m = (m + threads - 1) / threads;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = rows_grid((unsigned)(segs * blocks_m), b);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  if (segs > 1) {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = segs;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, xyz, centers, b, n, m, r2, nsample,
                           seg, tile, segs, idx, count);
  const cudaError_t last = cudaGetLastError();  // also clears it
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace

extern "C" {

// xyz: (b, n, 3) f32; centers: (b, m, 3) f32; idx: (b, m, nsample) i32;
// count: (b, m) i32, or null for the early-exit form without counts.
// The first design: one warp a center.
int vlp3d_ball_query(const void* xyz, const void* centers, int b, int n,
                     int m, float r2, int nsample, void* idx, void* count,
                     void* stream) {
  const dim3 grid = rows_grid((m + kWarps - 1) / kWarps, b);
  ball_query_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const float*)xyz, (const float*)centers, b, n, m, r2, nsample,
      (int*)idx, (int*)count);
  return (int)cudaGetLastError();
}

// The same function through ball_query_tile_kernel: `threads` a block
// (a multiple of 32, one center each), `segs` blocks a cluster, one a
// segment of the row (1 to 16), `tile` points a shared-memory tile (a
// multiple of 4; cut to the segment). A plan the card refuses (shared
// memory, cluster size) comes back as its error code and leaves no error
// behind.
int vlp3d_ball_query_tile(const void* xyz, const void* centers, int b, int n,
                          int m, float r2, int nsample, void* idx,
                          void* count, int threads, int segs, int tile,
                          void* stream) {
  if (threads < 32 || threads > 1024 || threads % 32 != 0 || segs < 1 ||
      segs > kMaxCluster || tile < 4 || tile % 4 != 0 || nsample < 1)
    return (int)cudaErrorInvalidValue;
  const float* x = (const float*)xyz;
  const float* c = (const float*)centers;
  cudaStream_t s = (cudaStream_t)stream;
  // 2-byte hit lists where a segment has at most 65536 points
  if ((n + segs - 1) / segs <= 65536)
    return launch_tile<unsigned short>(x, c, b, n, m, r2, nsample, (int*)idx,
                                       (int*)count, threads, segs, tile, s);
  return launch_tile<int>(x, c, b, n, m, r2, nsample, (int*)idx, (int*)count,
                          threads, segs, tile, s);
}

}  // extern "C"
