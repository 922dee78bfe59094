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

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr float kMinSqNorm = 1e-3f;
constexpr float kInit = 1e10f;
// the most blocks a cluster may have (the card's limit is 16)
constexpr int kMaxBlocks = 16;

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

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

// the most threads a block of fps_regs_kernel<P> may have: 4 registers a
// point plus the loop's own, inside the 64K registers of an SM
constexpr int regs_max_threads(int p) {
  return p <= 4 ? 1024 : p <= 16 ? 512 : 256;
}

// float -> unsigned whose order is the float's (-inf < -1 < 0 < 1e10), so
// that a warp's maximum is one redux.sync
__device__ __forceinline__ unsigned ordered(float v) {
  const unsigned u = __float_as_uint(v);
  return u ^ ((u >> 31) ? 0xffffffffu : 0x80000000u);
}

// Warp argmax of (key, index), lowest index among equal keys: every lane
// leaves with the winner's key and index; `mine` says whether the winner
// was this lane's.
__device__ __forceinline__ int warp_argmax(unsigned& key, int idx,
                                           bool& mine) {
  const unsigned top = __reduce_max_sync(0xffffffffu, key);
  const int best =
      __reduce_min_sync(0xffffffffu, key == top ? idx : INT_MAX);
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

// One row = one block (kCluster false) or one cluster of blocks. `share`
// is the number of consecutive points a block owns (n for one block); a
// thread holds P of them: point k of thread tid is index
// rank * share + tid + k * blockDim.x, and P * blockDim.x >= share. The
// loop over a thread's points has no branch and its maximum is a tree,
// so the P dependent chains overlap. Dynamic shared memory holds the
// block's coordinates as three arrays of P * blockDim.x floats, read
// only to look up a candidate's coordinates by index.
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
  const int warps = threads >> 5;
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
  const float neg_inf = __int_as_float(0xff800000);

  float x[P], y[P], z[P], t[P];
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
  float px = p[0], py = p[1], pz = p[2];
  if (rank == 0 && tid == 0) o[0] = 0;
  if constexpr (kCluster) {
    if (tid == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       smem_addr(&bars[0]))
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       smem_addr(&bars[1]))
                   : "memory");
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
    if constexpr (kCluster) {
      // this step's candidates: 16 bytes from each block of the cluster
      if (tid == 0)
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                smem_addr(&bars[par])),
            "r"(blocks * 16)
            : "memory");
    }
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
    bool mine;
    unsigned key = ordered(v[0]);
    int bi = warp_argmax(
        key, v[0] == neg_inf ? INT_MAX : base + tid + id[0] * threads, mine);
    // every lane of the warp now holds the warp's candidate; the block's
    // candidate is the best of its warps' (warp 0 alone needs it in a
    // cluster, every warp in a single block)
    if (warps > 1) {
      if (lane == 0) {
        slot_k[par][warp] = key;
        slot_i[par][warp] = bi;
      }
      __syncthreads();
      if (!kCluster || warp == 0) {
        key = 0;  // below every float's key
        bi = INT_MAX;
        if (lane < warps) {  // at most 32 warps
          key = slot_k[par][lane];
          bi = slot_i[par][lane];
        }
        bi = warp_argmax(key, bi, mine);
      }
    }

    if constexpr (!kCluster) {
      px = xs[bi];
      py = ys[bi];
      pz = zs[bi];
      if (tid == 0) o[j] = bi;
    } else {
      if (warp == 0 && lane < blocks) {
        // lane L sends the block's candidate to block L. Shares are
        // consecutive index ranges, so among equal keys the lowest rank
        // holds the lowest index and the index itself need not travel.
        unsigned cx = 0, cy = 0, cz = 0;
        if (bi != INT_MAX) {
          const int loc = bi - base;
          cx = __float_as_uint(xs[loc]);
          cy = __float_as_uint(ys[loc]);
          cz = __float_as_uint(zs[loc]);
        }
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
            "[%0], {%1, %2, %3, %4}, [%5];" ::"r"(
                peer_addr(smem_addr(&peer_kxyz[par][rank]), lane)),
            "r"(key), "r"(cx), "r"(cy), "r"(cz),
            "r"(peer_addr(smem_addr(&bars[par]), lane))
            : "memory");
      }
      // steps 1 and 2 are the first use of their mbarriers (phase 0)
      mbar_wait(smem_addr(&bars[par]), ((j - 1) >> 1) & 1);
      const uint4 c = peer_kxyz[par][lane < blocks ? lane : 0];
      const unsigned top = __reduce_max_sync(0xffffffffu, c.x);
      const int winner = __reduce_min_sync(
          0xffffffffu, lane < blocks && c.x == top ? lane : INT_MAX);
      px = __uint_as_float(__shfl_sync(0xffffffffu, c.y, winner));
      py = __uint_as_float(__shfl_sync(0xffffffffu, c.z, winner));
      pz = __uint_as_float(__shfl_sync(0xffffffffu, c.w, winner));
      // warp 0 of the winning block still holds its candidate's index
      if (rank == winner && tid == 0) o[j] = bi;
    }
  }
  // no block may exit while a peer can still address its shared memory
  if constexpr (kCluster) cg::this_cluster().sync();
}

// threads a block so that P points a thread cover `share` points
int regs_threads(int share, int p) {
  return 32 * ((share + 32 * p - 1) / (32 * p));
}

template <int P, bool kCluster>
struct RegsLaunch {
  static auto kernel() { return fps_regs_kernel<P, kCluster>; }

  // fill cfg (and attr, which it points to) for `rows` rows
  static cudaError_t config(int rows, int cluster, int share,
                            cudaStream_t stream, cudaLaunchConfig_t& cfg,
                            cudaLaunchAttribute& attr) {
    const int threads = regs_threads(share, P);
    if (threads > regs_max_threads(P)) return cudaErrorInvalidValue;
    const size_t smem = (size_t)3 * P * threads * sizeof(float);
    cudaError_t err = cudaSuccess;
    if (smem > 32 * 1024) {  // with the static part, past the 48 KB default
      err = cudaFuncSetAttribute(
          kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    if (cluster > 8) {  // past the portable cluster size
      err = cudaFuncSetAttribute(
          kernel(), cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
    }
    cfg = {};
    cfg.gridDim = dim3((unsigned)rows * cluster);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    if (kCluster) {
      attr.id = cudaLaunchAttributeClusterDimension;
      attr.val.clusterDim.x = cluster;
      attr.val.clusterDim.y = 1;
      attr.val.clusterDim.z = 1;
      cfg.attrs = &attr;
      cfg.numAttrs = 1;
    }
    return cudaSuccess;
  }

  static cudaError_t launch(const float* xyz, int b, int n, int npoint,
                            int* out, int cluster, int share,
                            cudaStream_t stream) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t err = config(b, cluster, share, stream, cfg, attr);
    if (err != cudaSuccess) return err;
    err = cudaLaunchKernelEx(&cfg, kernel(), xyz, n, npoint, share, out);
    const cudaError_t last = cudaGetLastError();  // also clears it
    return err != cudaSuccess ? err : last;
  }

  static int max_clusters(int cluster, int share) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t err = config(1, cluster, share, nullptr, cfg, attr);
    int num = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&num, kernel(), &cfg);
    return err == cudaSuccess ? num : -(int)err;
  }
};

// call `what` of RegsLaunch<points, kCluster>; points must be one of the
// instantiated 2, 4, 8, 16, 32
#define VLP3D_FPS_DISPATCH(points, kCluster, what, refused) \
  switch (points) {                                          \
    case 2: return RegsLaunch<2, kCluster>::what;            \
    case 4: return RegsLaunch<4, kCluster>::what;            \
    case 8: return RegsLaunch<8, kCluster>::what;            \
    case 16: return RegsLaunch<16, kCluster>::what;          \
    case 32: return RegsLaunch<32, kCluster>::what;          \
    default: return refused;                                 \
  }

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
    VLP3D_FPS_DISPATCH(points, false,
                       launch((const float*)xyz, b, n, npoint, (int*)out, 1,
                              share, s),
                       (int)cudaErrorInvalidValue)
  }
  VLP3D_FPS_DISPATCH(points, true,
                     launch((const float*)xyz, b, n, npoint, (int*)out,
                            cluster, share, s),
                     (int)cudaErrorInvalidValue)
}

// How many clusters of `cluster` blocks, each thread holding `points`
// points of an n-point row, the card runs at once (negative: refused).
int vlp3d_fps_max_clusters(int cluster, int n, int points) {
  if (cluster < 2 || cluster > kMaxBlocks || n < 1) return -1;
  const int share = (n + cluster - 1) / cluster;
  VLP3D_FPS_DISPATCH(points, true, max_clusters(cluster, share), -1)
}

}  // extern "C"
