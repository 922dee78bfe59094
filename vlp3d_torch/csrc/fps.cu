// Furthest point sampling for Hopper (sm_90a).
//
// Replaces the TPU kernel vlp3d/ops/sampling.py::_fps_pallas_kernel
// (launched by _fps_pallas, dispatched by furthest_point_sample).
// Semantics: the first pick is index 0; points with |p|^2 <= 1e-3 are
// never picked; each step updates every point's running min squared
// distance to the newest pick and picks the masked argmax, lowest index
// on ties; a row with no valid point picks 0 at every step (argmax over
// all -1). d^2 is (dx*dx + dy*dy) + dz*dz in round-to-nearest without
// FMA contraction, so indices equal the plain version's bit for bit.
//
// What bounds it on the H100: neither bytes nor arithmetic but latency.
// The npoint steps of a row are one serial chain (every step needs the
// previous pick), and the five calls of a forward feed each other, so
// the time is steps x the latency of one step. Two kernels keep a step
// short, and a third takes rows too long for either:
//
// fps_regs_kernel<P, false>: one block a batch row, for short rows. A
//   thread keeps up to P points (x, y, z, running distance) in registers
//   for the whole call; nothing is read from global memory or L2 inside
//   the loop. A step is the local update, one warp reduction (two
//   redux.sync on an order-preserving integer key), one
//   candidate a warp into shared memory, one __syncthreads() (candidate
//   slots are double-buffered by step parity), and every warp merges the
//   candidates for itself. A single-warp block needs no barrier at all.
// fps_regs_kernel<P, true>: one thread-block cluster a batch row, for
//   long rows. The row is cut into contiguous shares, one a block, held
//   in registers as above, so a row has cluster-size SMs working for it
//   and B = 8 rows fill the card. Each block merges its warps'
//   candidates as above and writes the result (value and the
//   candidate's coordinates, so nobody reads global memory for the pick)
//   into its slot in every block's shared memory through distributed
//   shared memory (st.async, counted on an mbarrier of the receiving
//   block: no cluster-wide barrier inside the loop); every warp of every
//   block waits for the step's candidates and merges them for itself.
//   The index stays home: the block that owns the pick writes it out.
// The two fps_regs_kernel forms are built from fps_regs.cuh, whose pieces
// point_parallel.cu's point-sharded FPS loop shares.
// fps_kernel: the first design, one 1024-thread block a row with the running
//   distances in shared memory or, for rows past every other limit, in a
//   global scratch; coordinates are read from L2 at every step.
//
// Validity and padding ride in the running distance: an invalid point
// holds -1 for ever (fminf(-1, d) = -1, the plain version's masked
// value), a slot past the end of the row holds -inf and never wins.
// Ties resolve by explicit index comparison inside a block and by rank
// between blocks (shares are consecutive index ranges), so equal
// distances in two blocks' shares still give the lowest global index.

#include <cuda_runtime.h>

#include <climits>

#include "fps_regs.cuh"

namespace {

constexpr int kThreads = 1024;

// (value, index) max with the lowest index on equal values
__device__ __forceinline__ void argmax_merge(float& v, int& i, float ov,
                                             int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(kThreads)
    fps_kernel(const float* __restrict__ xyz, int n, int npoint,
               int* __restrict__ out, float* __restrict__ temp_global) {
  extern __shared__ float temp_shared[];
  __shared__ float red_v[kThreads / 32];
  __shared__ int red_i[kThreads / 32];
  __shared__ int s_pick;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* p = xyz + (size_t)b * n * 3;
  int* o = out + (size_t)b * npoint;
  float* temp = temp_global ? temp_global + (size_t)b * n : temp_shared;
  const float neg_inf = __int_as_float(0xff800000);

  for (int i = tid; i < n; i += kThreads) temp[i] = kInit;
  if (tid == 0) o[0] = 0;
  int old = 0;
  __syncthreads();

  for (int j = 1; j < npoint; ++j) {
    const float px = p[3 * old], py = p[3 * old + 1], pz = p[3 * old + 2];
    float bv = neg_inf;
    int bi = n;
    for (int i = tid; i < n; i += kThreads) {
      const float x = p[3 * i], y = p[3 * i + 1], z = p[3 * i + 2];
      const float d = sq3(__fsub_rn(x, px), __fsub_rn(y, py),
                          __fsub_rn(z, pz));
      const float t = fminf(temp[i], d);
      temp[i] = t;
      const float cand = sq3(x, y, z) > kMinSqNorm ? t : -1.0f;
      if (cand > bv) {  // i rises, so strict > keeps the lowest index
        bv = cand;
        bi = i;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      argmax_merge(bv, bi, __shfl_down_sync(0xffffffffu, bv, off),
                   __shfl_down_sync(0xffffffffu, bi, off));
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = red_v[lane];  // kThreads / 32 == 32 warps
      bi = red_i[lane];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        argmax_merge(bv, bi, __shfl_down_sync(0xffffffffu, bv, off),
                     __shfl_down_sync(0xffffffffu, bi, off));
      }
      if (lane == 0) {
        s_pick = bi;
        o[j] = bi;
      }
    }
    __syncthreads();
    old = s_pick;
  }
}

// One row = one block (kCluster false) or one cluster of blocks; the
// pieces are fps_regs.cuh's (load_share, step_candidate, cluster_winner).
//
// In a cluster a step has no cluster-wide barrier. Warp 0 sends the
// block's candidate to every block with st.async, which writes into the
// peer's shared memory and counts the bytes on an mbarrier there; every
// warp waits on its own block's mbarrier until the candidates of all
// blocks have landed, then merges them for itself. Slots and mbarriers
// alternate by step parity: a candidate of step j + 2 can only be sent
// after its sender has seen every block's candidate of step j + 1, which
// each block sent after all its warps had read the slots of step j.
template <int P, bool kCluster>
__global__ void __launch_bounds__(regs_max_threads(P))
    fps_regs_kernel(const float* __restrict__ xyz, int n, int npoint,
                    int share, int* __restrict__ out) {
  extern __shared__ float coords[];
  // a step's candidates: one a warp (key, index) inside the block, and
  // in a cluster one a block (key, x, y, z), written by the peers
  __shared__ unsigned slot_k[2][32];
  __shared__ int slot_i[2][32];
  __shared__ uint4 peer_kxyz[2][kMaxBlocks];
  __shared__ unsigned long long bars[2];

  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int rank = 0, blocks = 1, row = blockIdx.x;
  if constexpr (kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    rank = (int)cluster.block_rank();
    blocks = (int)cluster.num_blocks();
    row = blockIdx.x / blocks;
  }
  const float* p = xyz + (size_t)row * n * 3;
  int* o = out + (size_t)row * npoint;
  const int base = rank * share;
  const int span = P * threads;
  float* xs = coords;
  float* ys = xs + span;
  float* zs = ys + span;

  float x[P], y[P], z[P], t[P];
  load_share<P>(p, n, base, share, tid, threads, x, y, z, t, xs, ys, zs);
  float px = p[0], py = p[1], pz = p[2];
  if (rank == 0 && tid == 0) o[0] = 0;
  if constexpr (kCluster) {
    if (tid == 0) {
      mbar_init(&bars[0]);
      mbar_init(&bars[1]);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    // every block of the cluster must be running, its mbarriers set up,
    // before a peer writes into its shared memory
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }

  for (int j = 1; j < npoint; ++j) {
    const int par = j & 1;
    // this step's candidates: 16 bytes from each block of the cluster
    if (kCluster && tid == 0) mbar_expect(&bars[par], blocks * 16);
    unsigned key;
    // every warp needs the block's candidate in a single block, warp 0
    // alone in a cluster
    const int bi = step_candidate<P>(x, y, z, t, px, py, pz, base, tid,
                                     threads, !kCluster, slot_k, slot_i, par,
                                     key);
    if constexpr (!kCluster) {
      px = xs[bi];
      py = ys[bi];
      pz = zs[bi];
      if (tid == 0) o[j] = bi;
    } else {
      if (warp == 0 && lane < blocks) {
        // lane L sends the block's candidate to block L
        const uint3 c = candidate_xyz(bi, base, xs, ys, zs);
        st_async_v4(&peer_kxyz[par][rank], &bars[par], lane, key, c.x, c.y,
                    c.z);
      }
      // steps 1 and 2 are the first use of their mbarriers (phase 0)
      mbar_wait(smem_addr(&bars[par]), ((j - 1) >> 1) & 1);
      unsigned top;
      const int winner =
          cluster_winner(peer_kxyz[par], blocks, lane, top, px, py, pz);
      // warp 0 of the winning block still holds its candidate's index
      if (rank == winner && tid == 0) o[j] = bi;
    }
  }
  // no block may exit while a peer can still address its shared memory
  if constexpr (kCluster) cg::this_cluster().sync();
}

template <int P, bool kCluster>
struct RegsLaunch {
  static auto kernel() { return fps_regs_kernel<P, kCluster>; }

  static cudaError_t launch(const float* xyz, int b, int n, int npoint,
                            int* out, int cluster, int share,
                            cudaStream_t stream) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t err =
        regs_config(kernel(), P, b, cluster, share, stream, cfg, attr);
    if (err != cudaSuccess) return err;
    err = cudaLaunchKernelEx(&cfg, kernel(), xyz, n, npoint, share, out);
    const cudaError_t last = cudaGetLastError();  // also clears it
    return err != cudaSuccess ? err : last;
  }
};

}  // namespace

extern "C" {

// xyz: (b, n, 3) f32; out: (b, npoint) i32; temp_global: (b, n) f32
// scratch, or null to keep the running distances in shared memory (a
// row too long for that is refused: the error code comes back).
int vlp3d_fps(const void* xyz, int b, int n, int npoint, void* out,
              void* temp_global, void* stream) {
  size_t smem = temp_global ? 0 : (size_t)n * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it
    return (int)err;
  }
  fps_kernel<<<b, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)xyz, n, npoint, (int*)out, (float*)temp_global);
  return (int)cudaGetLastError();
}

// Points in registers: `cluster` blocks a row (1: a plain launch), each
// thread holding `points` (2, 4, 8, 16 or 32) of them, in as many threads
// as cover the block's share. The row must fit: the threads within the
// register budget of `points`, at most 16 blocks a cluster. A launch the
// card refuses comes back as its error code.
int vlp3d_fps_regs(const void* xyz, int b, int n, int npoint, void* out,
                   int cluster, int points, void* stream) {
  if (cluster < 1 || cluster > kMaxBlocks || n < 1)
    return (int)cudaErrorInvalidValue;
  const int share = (n + cluster - 1) / cluster;
  cudaStream_t s = (cudaStream_t)stream;
  if (cluster == 1) {
    VLP3D_REGS_DISPATCH(points,
                        (RegsLaunch<P, false>::launch((const float*)xyz, b, n,
                                                      npoint, (int*)out, 1,
                                                      share, s)),
                        (int)cudaErrorInvalidValue)
  }
  VLP3D_REGS_DISPATCH(points,
                      (RegsLaunch<P, true>::launch((const float*)xyz, b, n,
                                                   npoint, (int*)out, cluster,
                                                   share, s)),
                      (int)cudaErrorInvalidValue)
}

// How many clusters of `cluster` blocks, each thread holding `points`
// points of an n-point row, the card runs at once (negative: refused).
int vlp3d_fps_max_clusters(int cluster, int n, int points) {
  if (cluster < 2 || cluster > kMaxBlocks || n < 1) return -1;
  const int share = (n + cluster - 1) / cluster;
  VLP3D_REGS_DISPATCH(
      points, regs_max_clusters(fps_regs_kernel<P, true>, P, cluster, share),
      -1)
}

}  // extern "C"
