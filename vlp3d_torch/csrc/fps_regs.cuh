// The device code of the points-in-registers FPS (fps.cu's
// fps_regs_kernel), shared with the point-sharded FPS loop
// (point_parallel.cu's fps_shard_loop_kernel): a block's share of a row
// held in registers, one step's local update and block argmax, the
// candidate exchange between the blocks of a cluster (st.async into the
// receivers' shared memory, counted on their mbarriers), and the launch
// configuration of a kernel built from these pieces.
//
// Distances are (dx*dx + dy*dy) + dz*dz in round-to-nearest without FMA
// contraction (the sources spell it with __fmul_rn / __fadd_rn /
// __fsub_rn and build with --fmad=false), so indices equal the plain
// versions' bit for bit. Validity and padding ride in the running
// distance: an invalid point (|p|^2 <= 1e-3) holds -1 for ever, a slot
// past the end of the row holds -inf and never wins.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

namespace cg = cooperative_groups;

constexpr float kMinSqNorm = 1e-3f;
constexpr float kInit = 1e10f;
// the most blocks a cluster may have (the card's limit is 16)
constexpr int kMaxBlocks = 16;
constexpr unsigned kFullMask = 0xffffffffu;
// threads a block of a kernel that streams its share (regs_config's p = 0)
constexpr int kStreamThreads = 1024;

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// the most threads a block of a points-in-registers kernel holding P
// points a thread may have: 4 registers a point plus the loop's own,
// inside the 64K registers of an SM
constexpr int regs_max_threads(int p) {
  return p <= 4 ? 1024 : p <= 16 ? 512 : 256;
}

// threads a block so that P points a thread cover `share` points
inline int regs_threads(int share, int p) {
  return 32 * ((share + 32 * p - 1) / (32 * p));
}

// float -> unsigned whose order is the float's (-inf < -1 < 0 < 1e10), so
// that a warp's maximum is one redux.sync
__device__ __forceinline__ unsigned ordered(float v) {
  const unsigned u = __float_as_uint(v);
  return u ^ ((u >> 31) ? 0xffffffffu : 0x80000000u);
}

// the inverse of ordered()
__device__ __forceinline__ float unordered(unsigned key) {
  return __uint_as_float((key >> 31) ? key ^ 0x80000000u : ~key);
}

// Warp argmax of (key, index), lowest index among equal keys: every lane
// leaves with the winner's key and index; `mine` says whether the winner
// was this lane's.
__device__ __forceinline__ int warp_argmax(unsigned& key, int idx,
                                           bool& mine) {
  const unsigned top = __reduce_max_sync(kFullMask, key);
  const int best = __reduce_min_sync(kFullMask, key == top ? idx : INT_MAX);
  mine = key == top && idx == best;
  key = top;
  return best;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// address of this block's shared-memory location `addr` in block `rank`
// of the cluster
__device__ __forceinline__ unsigned peer_addr(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// 16 bytes into block `to`'s copy of `slot`, counted on its copy of `bar`
__device__ __forceinline__ void st_async_v4(const uint4* slot,
                                            unsigned long long* bar,
                                            unsigned to, unsigned a,
                                            unsigned b, unsigned c,
                                            unsigned d) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
      "[%0], {%1, %2, %3, %4}, [%5];" ::"r"(peer_addr(smem_addr(slot), to)),
      "r"(a), "r"(b), "r"(c), "r"(d), "r"(peer_addr(smem_addr(bar), to))
      : "memory");
}

// 4 bytes into block `to`'s copy of `slot`, counted on its copy of `bar`
__device__ __forceinline__ void st_async_b32(const int* slot,
                                             unsigned long long* bar,
                                             unsigned to, int a) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
      "[%0], %1, [%2];" ::"r"(peer_addr(smem_addr(slot), to)),
      "r"(a), "r"(peer_addr(smem_addr(bar), to))
      : "memory");
}

// Load a block's share of a row into registers and shared memory. `share`
// is the number of consecutive points a block owns (n for one block); a
// thread holds P of them: point k of thread tid is index
// base + tid + k * threads (base = block rank * share), and
// P * threads >= share. Shared memory holds the share's coordinates as
// three arrays of P * threads floats, read only to look up a candidate's
// coordinates by index.
template <int P>
__device__ __forceinline__ void load_share(const float* p, int n, int base,
                                           int share, int tid, int threads,
                                           float (&x)[P], float (&y)[P],
                                           float (&z)[P], float (&t)[P],
                                           float* xs, float* ys, float* zs) {
  const float neg_inf = __int_as_float(0xff800000);
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int loc = tid + k * threads;
    const int i = base + loc;
    const bool in = loc < share && i < n;
    float a = 0.0f, b = 0.0f, c = 0.0f;
    if (in) {
      a = p[3 * i];
      b = p[3 * i + 1];
      c = p[3 * i + 2];
    }
    x[k] = a;
    y[k] = b;
    z[k] = c;
    t[k] = in ? (sq3(a, b, c) > kMinSqNorm ? kInit : -1.0f) : neg_inf;
    xs[loc] = a;
    ys[loc] = b;
    zs[loc] = c;
  }
}

// The block's candidate from each thread's (ordered key, index): the
// lowest index among the largest keys. With several warps the warps'
// candidates meet in the double-buffered `slot_k` / `slot_i` (index `par`)
// behind one __syncthreads(); `every_warp` says whether every warp leaves
// with the block's candidate or warp 0 alone does.
__device__ __forceinline__ int block_candidate(unsigned& key, int bi, int tid,
                                               int threads, bool every_warp,
                                               unsigned (*slot_k)[32],
                                               int (*slot_i)[32], int par) {
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = threads >> 5;
  bool mine;
  bi = warp_argmax(key, bi, mine);
  // every lane of the warp now holds the warp's candidate; the block's
  // candidate is the best of its warps'
  if (warps > 1) {
    if (lane == 0) {
      slot_k[par][warp] = key;
      slot_i[par][warp] = bi;
    }
    __syncthreads();
    if (every_warp || warp == 0) {
      key = 0;  // below every float's key
      bi = INT_MAX;
      if (lane < warps) {  // at most 32 warps
        key = slot_k[par][lane];
        bi = slot_i[par][lane];
      }
      bi = warp_argmax(key, bi, mine);
    }
  }
  return bi;
}

// One step's local part: every running distance min-updated with the
// newest pick (px, py, pz), then the block's candidate (ordered key, index
// base + loc; INT_MAX where the block holds only padding). The loop over
// a thread's points has no branch and its maximum is a tree, so the P
// dependent chains overlap; block_candidate() then merges the threads'.
template <int P>
__device__ __forceinline__ int step_candidate(
    const float (&x)[P], const float (&y)[P], const float (&z)[P],
    float (&t)[P], float px, float py, float pz, int base, int tid,
    int threads, bool every_warp, unsigned (*slot_k)[32], int (*slot_i)[32],
    int par, unsigned& key) {
  const float neg_inf = __int_as_float(0xff800000);
  float v[P];
  int id[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const float d = sq3(__fsub_rn(x[k], px), __fsub_rn(y[k], py),
                        __fsub_rn(z[k], pz));
    t[k] = fminf(t[k], d);
    v[k] = t[k];
    id[k] = k;
  }
#pragma unroll
  for (int s = 1; s < P; s <<= 1) {
#pragma unroll
    for (int k = 0; k + s < P; k += 2 * s) {
      if (v[k + s] > v[k]) {  // strict >: the lower k, the lower index
        v[k] = v[k + s];
        id[k] = id[k + s];
      }
    }
  }
  key = ordered(v[0]);
  return block_candidate(
      key, v[0] == neg_inf ? INT_MAX : base + tid + id[0] * threads, tid,
      threads, every_warp, slot_k, slot_i, par);
}

// The coordinates of a block candidate's index (zeros for INT_MAX), as
// bits, from the share's copy in shared memory.
__device__ __forceinline__ uint3 candidate_xyz(int bi, int base,
                                               const float* xs,
                                               const float* ys,
                                               const float* zs) {
  if (bi == INT_MAX) return make_uint3(0u, 0u, 0u);
  const int loc = bi - base;
  return make_uint3(__float_as_uint(xs[loc]), __float_as_uint(ys[loc]),
                    __float_as_uint(zs[loc]));
}

// The cluster's winner among the blocks' (key, x, y, z) candidates in
// `cands` (one a block, `blocks` of them): the largest key, then the
// lowest block rank (shares are consecutive index ranges, so among equal
// keys the lowest rank holds the lowest index and the index itself need
// not travel). Every lane leaves with the winner's block rank, key and
// coordinates.
__device__ __forceinline__ int cluster_winner(const uint4* cands, int blocks,
                                              int lane, unsigned& top,
                                              float& px, float& py,
                                              float& pz) {
  const uint4 c = cands[lane < blocks ? lane : 0];
  top = __reduce_max_sync(kFullMask, c.x);
  const int winner = __reduce_min_sync(
      kFullMask, lane < blocks && c.x == top ? lane : INT_MAX);
  px = __uint_as_float(__shfl_sync(kFullMask, c.y, winner));
  py = __uint_as_float(__shfl_sync(kFullMask, c.z, winner));
  pz = __uint_as_float(__shfl_sync(kFullMask, c.w, winner));
  return winner;
}

// Launch configuration of a points-in-registers kernel: `clusters`
// clusters (rows, for fps.cu) of `cluster` blocks (a plain launch when
// `cluster` is 1), each block as many threads as cover `share` points at
// P a thread, the share's coordinates in dynamic shared memory; p = 0 is
// a kernel whose blocks of kStreamThreads stream their share from global
// memory instead (point_parallel.cu's loop for slabs past registers).
// Fills cfg and attr (which cfg points to).
template <typename Kernel>
cudaError_t regs_config(Kernel kernel, int p, int clusters, int cluster,
                        int share, cudaStream_t stream,
                        cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr) {
  const int threads = p ? regs_threads(share, p) : kStreamThreads;
  if (p && threads > regs_max_threads(p)) return cudaErrorInvalidValue;
  const size_t smem = (size_t)3 * p * threads * sizeof(float);
  cudaError_t err = cudaSuccess;
  if (smem > 32 * 1024) {  // with the static part, past the 48 KB default
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  if (cluster > 8) {  // past the portable cluster size
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cfg = {};
  cfg.gridDim = dim3((unsigned)clusters * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  if (cluster > 1) {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
  return cudaSuccess;
}

// How many clusters of `cluster` blocks of `kernel` the card runs at once
// (negative: the configuration is refused, the CUDA error negated).
template <typename Kernel>
int regs_max_clusters(Kernel kernel, int p, int cluster, int share) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = regs_config(kernel, p, 1, cluster, share, nullptr, cfg,
                                attr);
  int num = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&num, kernel, &cfg);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it
    return -(int)err;
  }
  return num;
}

}  // namespace

// call `what` with the template argument P = points (one of the
// instantiated 2, 4, 8, 16, 32); `refused` otherwise
#define VLP3D_REGS_DISPATCH(points, what, refused) \
  switch (points) {                                \
    case 2: { constexpr int P = 2; return what; }  \
    case 4: { constexpr int P = 4; return what; }  \
    case 8: { constexpr int P = 8; return what; }  \
    case 16: { constexpr int P = 16; return what; } \
    case 32: { constexpr int P = 32; return what; } \
    default: return refused;                       \
  }
