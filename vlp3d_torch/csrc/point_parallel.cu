// Point-axis (sequence) parallel kernels: the per-rank pieces of the
// point-sharded SA front end (vlp3d_torch/parallel/point_parallel.py).
//
// Replaces the TPU side of vlp3d/parallel/point_parallel.py, which has no
// Pallas kernel of its own there: XLA fuses fps_sharded's loop body
// (point_parallel.py:74-130), ball_query_sharded's merge (:133-205) and
// _owned_rows (:208-219) around the pmax / pmin / psum collectives. Here:
//
//   * fps_shard_loop (the peer route): a whole fps_sharded call in one
//     persistent launch, the ranks' candidates exchanged through peer
//     memory instead of a collective an iteration. One cluster a row, each
//     block's share of this rank's slab in registers (fps_regs.cuh, the
//     device code of fps.cu's fps_regs_kernel<P, true>) or, for a share
//     too long for registers (P = 0), streamed from global memory with
//     its running distances in a scratch, as fps.cu's fps_kernel does for
//     rows past a cluster; a cluster walks rows c, c + nc, ... in the same
//     order on every rank, and the grid is sized so that every cluster is
//     resident (a cluster that waits on a peer never holds up one the peer
//     waits on). An iteration:
//       - every block updates its running distances and sends its
//         candidate (key, x, y, z, and its index) to block 0 through
//         distributed shared memory (st.async on block 0's mbarrier);
//       - block 0 merges them into the row's candidate, five int32 lanes:
//         distance bits, global index (slab offset + local), x, y, z bits
//         (an index never rides in a float lane); lane w of its warp 0
//         stores it into slot seq % 2 of rank w's exchange buffer (seq =
//         the call's base + the iteration, rising across calls), each
//         lane as an 8-byte pair with seq's low 32 bits for a flag;
//       - warp 0 of every block spins on its own buffer's W slots of the
//         row until every pair carries seq, picks the winner (the largest
//         distance, then the lowest global index) and hands it to the
//         block's other warps through shared memory. An
//         invalid point (|p|^2 <= 1e-3) offers -1, so a row with no valid
//         point picks 0; at iteration 0 rank 0 offers global point 0 and
//         the others nothing.
//     A slot is written again two sequence numbers later, which a rank
//     does only after it has read every rank's candidate of the one
//     between, which each rank sends only after its blocks have read the
//     slot. One rank (W = 1) runs the same exchange through its own
//     buffer. A wait for a rank's candidate that outlasts the call's
//     limit (%globaltimer, nanoseconds) traps, so a fault of the exchange
//     fails the run instead of hanging it; the wrapper starts a call of
//     several ranks behind a collective on the same stream, so the limit
//     counts from the moment every rank has reached the call. Bound by
//     latency: npoint dependent steps, each a cluster merge plus a
//     store's flight to every rank's buffer.
//   * ball_query_merge: the all-gathered per-shard (first-k local
//     indices, in-ball count) of ball_query.cu's count variant, merged
//     into global slots: slot s of a centre comes from the first shard
//     whose cumulative count (each capped at nsample) exceeds s, at local
//     slot s - (the counts before it), plus that shard's offset; slots
//     past the total repeat the first hit; an empty ball is all zeros.
//     One warp a centre, 32-bit indexing: lane w < W loads count w once
//     and a shuffle scan gives each shard's start and the total; lanes
//     then fill 16-byte-aligned quads of slots with int4 stores (int4
//     loads where a quad comes from one shard at an aligned offset, shard
//     0's read before the counts arrive), the row's unaligned head and
//     tail slot by slot. More than 32 shards come 32 a chunk, the running
//     count carried from chunk to chunk (any W; JAX's merge has no
//     limit). Bound by bytes; two dependent reads a centre (the counts,
//     then the other shards' indices), one with W = 1.
//   * fps_shard_step: one iteration of the collective route, for a group
//     whose cards cannot reach each other's memory (see the kernel).
//   * gather_owned: rows of this rank's slab at global indices, a row of
//     zeros where another rank owns the index (the sum over the point
//     group then holds every row once). Not grouping.cu's gather on
//     idx - offset: that one wraps [-N, 0) and gives NaN elsewhere, and
//     NaN * 0 stays NaN. One thread an output element. Bound by bytes.
//
// Distances are (dx*dx + dy*dy) + dz*dz with dx = x - px, spelled with
// __fmul_rn / __fadd_rn / __fsub_rn (and built with --fmad=false), so the
// picks equal the dense FPS's and JAX's bit for bit.

#include <cstddef>
#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

#include "fps_regs.cuh"

namespace {

constexpr float kEmpty = -3.0f;  // a rank offering nothing: below -1
constexpr int kMergeWarps = 8;   // centres a block of the merge

// ---------------------------------------------------------------- FPS loop

// A rank's exchange buffer: int slots[2][B][W][12], slot (row, w) written
// by rank w only. A candidate's five lanes travel as (lane, flag) pairs of
// 8 bytes, each pair one store, the flag the low 32 bits of the sequence
// number (NCCL's LL form): a reader that sees a pair's flag sees its
// lane, so neither side needs a fence, and the wait is the store's flight.
__device__ __forceinline__ int* slot_at(int* buf, int B, int W,
                                        unsigned slot, int row, int from) {
  return buf + (((size_t)slot * B + row) * W + from) * 12;
}

__device__ __forceinline__ void st_volatile_v4(int* p, unsigned a,
                                               unsigned b, unsigned c,
                                               unsigned d) {
  asm volatile("st.volatile.global.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

__device__ __forceinline__ uint4 ld_volatile_v4(const int* p) {
  uint4 v;
  asm volatile("ld.volatile.global.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p)
               : "memory");
  return v;
}

// the card's nanosecond clock (the same rate whatever the SM clock)
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// lane w < W of block 0's warp 0: the row's candidate into rank w's slot
// of sequence number `seq`
__device__ __forceinline__ void push_candidate(int* peer, int B, int W,
                                               int row, int rank,
                                               unsigned seq, unsigned vbits,
                                               int gi, unsigned cx,
                                               unsigned cy, unsigned cz) {
  int* d = slot_at(peer, B, W, seq & 1, row, rank);
  st_volatile_v4(d, vbits, seq, (unsigned)gi, seq);
  st_volatile_v4(d + 4, cx, seq, cy, seq);
  st_volatile_v4(d + 8, cz, seq, 0u, seq);
}

// every warp: wait for the W ranks' candidates of `seq` in this rank's
// buffer and take the winner (largest distance, lowest global index);
// returns its global index, its coordinates in (px, py, pz). A wait past
// spin_ns traps.
__device__ __forceinline__ int exchange_pick(int* mine, int B, int W,
                                             int row, unsigned seq,
                                             long long spin_ns, int lane,
                                             float& px, float& py,
                                             float& pz) {
  unsigned key = 0, cx = 0, cy = 0, cz = 0;
  int gi = INT_MAX;
  if (lane < W) {
    const int* q = slot_at(mine, B, W, seq & 1, row, lane);
    unsigned long long t0 = 0;
    uint4 a, b, c;
    while (true) {
      a = ld_volatile_v4(q);
      b = ld_volatile_v4(q + 4);
      c = ld_volatile_v4(q + 8);
      if (a.y == seq && a.w == seq && b.y == seq && b.w == seq &&
          c.y == seq && c.w == seq)
        break;
      if (t0 == 0)
        t0 = now_ns();
      else if ((long long)(now_ns() - t0) > spin_ns)
        __trap();
    }
    key = ordered(__uint_as_float(a.x));
    gi = (int)a.z;
    cx = b.x;
    cy = b.z;
    cz = c.x;
  }
  const unsigned top = __reduce_max_sync(kFullMask, key);
  const int best = __reduce_min_sync(kFullMask, key == top ? gi : INT_MAX);
  const int win =
      __ffs(__ballot_sync(kFullMask, key == top && gi == best)) - 1;
  px = __uint_as_float(__shfl_sync(kFullMask, cx, win));
  py = __uint_as_float(__shfl_sync(kFullMask, cy, win));
  pz = __uint_as_float(__shfl_sync(kFullMask, cz, win));
  return best;
}

// every thread of a block: warp 0 alone waits for the pick (with every
// warp of every block polling, a call over four H100s was slower: the
// polls crowd out the stores they wait for), writes its index to `o`
// (block 0) and hands its coordinates to the block's other warps through
// `slot` behind one __syncthreads(). A slot of parity par is written again
// two steps later, after every warp has passed the barriers of the step
// between.
__device__ __forceinline__ void pick_for_block(int* mine, int B, int W,
                                               int row, unsigned seq,
                                               long long spin_ns, int warp,
                                               int lane, float4& slot, int* o,
                                               float& px, float& py,
                                               float& pz) {
  if (warp == 0) {
    const int gi =
        exchange_pick(mine, B, W, row, seq, spin_ns, lane, px, py, pz);
    if (lane == 0) {
      slot = make_float4(px, py, pz, 0.0f);
      if (o) *o = gi;
    }
  }
  __syncthreads();
  const float4 p = slot;
  px = p.x;
  py = p.y;
  pz = p.z;
}

// The streamed form's share (P = 0): points [base, base + len) of the slab
// `p`, read from global memory at every step, their running distances in
// `tm` (the slab's row of the scratch). A thread visits base + tid,
// base + tid + threads, ... in every step, so it alone reads and writes
// those distances and no barrier guards them.
__device__ __forceinline__ void stream_init(const float* p, float* tm,
                                            int base, int len, int tid,
                                            int threads) {
  for (int i = base + tid; i < base + len; i += threads)
    tm[i] = sq3(p[3 * i], p[3 * i + 1], p[3 * i + 2]) > kMinSqNorm ? kInit
                                                                   : -1.0f;
}

// the streamed form's step_candidate(): warp 0 leaves with the block's
// candidate (key, slab index; INT_MAX for an empty share)
__device__ __forceinline__ int stream_candidate(
    const float* p, float* tm, int base, int len, float px, float py,
    float pz, int tid, int threads, unsigned (*slot_k)[32],
    int (*slot_i)[32], int par, unsigned& key) {
  float bv = __int_as_float(0xff800000);
  int bi = INT_MAX;
  for (int i = base + tid; i < base + len; i += threads) {
    const float d = sq3(__fsub_rn(p[3 * i], px), __fsub_rn(p[3 * i + 1], py),
                        __fsub_rn(p[3 * i + 2], pz));
    const float t = fminf(tm[i], d);
    tm[i] = t;
    if (t > bv) {  // i rises, so strict > keeps the lowest index
      bv = t;
      bi = i;
    }
  }
  key = ordered(bv);
  return block_candidate(key, bi, tid, threads, false, slot_k, slot_i, par);
}

// The launch holds `ranks_here` ranks (one on a card of its own; W in
// the one-card emulation), nc clusters each; cluster id = local rank * nc
// + c. Local rank l's slab of row r starts at point l * nl of xyz's row r
// (rows of row_points points), its indices go to out[l][r]. peers: W
// pointers to the ranks' exchange buffers (W = 1: this rank's own). P = 0
// streams a block's share from global memory, its running distances in
// temp (ranks_here, B, nl); P > 0 holds it in registers (temp unused).
template <int P>
__global__ void __launch_bounds__(P ? regs_max_threads(P) : kStreamThreads)
    fps_shard_loop_kernel(const float* __restrict__ xyz, int row_points,
                          int nl, int npoint, int share, int B, int W,
                          int rank0, int nc,
                          const unsigned long long* __restrict__ peers,
                          unsigned long long seq_base, long long spin_ns,
                          float* __restrict__ temp, int* __restrict__ out) {
  extern __shared__ float coords[];
  __shared__ unsigned slot_k[2][32];
  __shared__ int slot_i[2][32];
  __shared__ uint4 peer_kxyz[2][kMaxBlocks];
  __shared__ int peer_idx[2][kMaxBlocks];
  __shared__ unsigned long long bars[2];
  __shared__ float4 win_p[2];  // the pick, from warp 0 to the block

  cg::cluster_group cluster = cg::this_cluster();
  const int crank = (int)cluster.block_rank();
  const int blocks = (int)cluster.num_blocks();
  const int cid = blockIdx.x / blocks;
  const int local = cid / nc;
  const int rank = rank0 + local;
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int base = crank * share;
  const int len = max(0, min(share, nl - base));
  const int span = P * threads;
  float* xs = coords;
  float* ys = xs + span;
  float* zs = ys + span;
  int* mine = reinterpret_cast<int*>(peers[rank]);
  // lane w < W of warp 0: rank w's buffer
  int* peer = lane < W ? reinterpret_cast<int*>(peers[lane]) : nullptr;
  if (tid == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // every block of the cluster must be running, its mbarriers set up,
  // before a peer writes into its shared memory
  cluster.sync();

  int s = 0;  // the cluster's steps so far, over its rows (mbarrier phase)
  for (int row = cid % nc; row < B; row += nc) {
    const float* p = xyz + ((size_t)row * row_points + (size_t)local * nl) * 3;
    float* tm = P ? nullptr : temp + ((size_t)local * B + row) * nl;
    int* o = out + ((size_t)local * B + row) * npoint;
    __syncthreads();  // the previous row's coordinates have been read
    float x[P ? P : 1], y[P ? P : 1], z[P ? P : 1], t[P ? P : 1];
    if constexpr (P > 0)
      load_share<P>(p, nl, base, share, tid, threads, x, y, z, t, xs, ys, zs);
    else
      stream_init(p, tm, base, len, tid, threads);
    float px, py, pz;
    // iteration 0: rank 0 offers global point 0, the others nothing
    if (crank == 0 && warp == 0 && lane < W) {
      const bool first = rank == 0;
      push_candidate(peer, B, W, row, rank, (unsigned)seq_base,
                     __float_as_uint(first ? kInit : kEmpty),
                     first ? 0 : INT_MAX,
                     first ? __float_as_uint(p[0]) : 0u,
                     first ? __float_as_uint(p[1]) : 0u,
                     first ? __float_as_uint(p[2]) : 0u);
    }
    pick_for_block(mine, B, W, row, (unsigned)seq_base, spin_ns, warp, lane,
                   win_p[0], crank == 0 ? o : nullptr, px, py, pz);
    __syncthreads();  // win_p[0] is read before step 1 writes it again
    for (int j = 1; j < npoint; ++j) {
      ++s;
      const int par = s & 1;
      // this step's candidates: 16 + 4 bytes from each block to block 0
      if (tid == 0 && crank == 0) mbar_expect(&bars[par], blocks * 20);
      unsigned key;
      int bi;
      if constexpr (P > 0)
        bi = step_candidate<P>(x, y, z, t, px, py, pz, base, tid, threads,
                               false, slot_k, slot_i, par, key);
      else
        bi = stream_candidate(p, tm, base, len, px, py, pz, tid, threads,
                              slot_k, slot_i, par, key);
      if (tid == 0) {
        uint3 c = make_uint3(0u, 0u, 0u);
        if constexpr (P > 0)
          c = candidate_xyz(bi, base, xs, ys, zs);
        else if (bi != INT_MAX)
          c = make_uint3(__float_as_uint(p[3 * bi]),
                         __float_as_uint(p[3 * bi + 1]),
                         __float_as_uint(p[3 * bi + 2]));
        st_async_v4(&peer_kxyz[par][crank], &bars[par], 0, key, c.x, c.y,
                    c.z);
        st_async_b32(&peer_idx[par][crank], &bars[par], 0, bi);
      }
      if (crank == 0 && warp == 0) {
        // a wait inside the cluster, which no other rank can hold up
        mbar_wait(smem_addr(&bars[par]), ((s - 1) >> 1) & 1);
        unsigned top;
        float cx, cy, cz;
        const int winner =
            cluster_winner(peer_kxyz[par], blocks, lane, top, cx, cy, cz);
        const int gi =
            __shfl_sync(kFullMask, peer_idx[par][lane < blocks ? lane : 0],
                        winner) +
            rank * nl;
        if (lane < W)
          push_candidate(peer, B, W, row, rank, (unsigned)(seq_base + j),
                         __float_as_uint(unordered(top)), gi,
                         __float_as_uint(cx), __float_as_uint(cy),
                         __float_as_uint(cz));
      }
      pick_for_block(mine, B, W, row, (unsigned)(seq_base + j), spin_ns,
                     warp, lane, win_p[par], crank == 0 ? o + j : nullptr,
                     px, py, pz);
    }
  }
  // no block may exit while a peer can still address its shared memory
  cluster.sync();
}

template <int P>
struct LoopLaunch {
  static cudaError_t launch(const float* xyz, int b, int row_points, int nl,
                            int npoint, int w, int rank0, int ranks_here,
                            int nc, int cluster,
                            const unsigned long long* peers,
                            unsigned long long seq_base, long long spin_ns,
                            float* temp, int* out, cudaStream_t stream) {
    const int share = (nl + cluster - 1) / cluster;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t err = regs_config(fps_shard_loop_kernel<P>, P,
                                  ranks_here * nc, cluster, share, stream,
                                  cfg, attr);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, fps_shard_loop_kernel<P>, xyz,
                               row_points, nl, npoint, share, b, w, rank0,
                               nc, peers, seq_base, spin_ns, temp, out);
    const cudaError_t last = cudaGetLastError();  // also clears it
    return err != cudaSuccess ? err : last;
  }

  static int max_clusters(int cluster, int nl) {
    return regs_max_clusters(fps_shard_loop_kernel<P>, P, cluster,
                             (nl + cluster - 1) / cluster);
  }
};

// ---------------------------------------------------------------- FPS step

// One iteration of a point-sharded FPS call for the collective route (a
// group whose cards cannot reach each other's memory): the candidates of
// the previous iteration come all-gathered over NCCL, one launch a step,
// fps_shard_step_plain in point_parallel.py in its exact layout. cands
// (W, B, 5) int32: distance bits, global index, x, y, z bits a rank. A
// cluster of `blocks` blocks a row (the grid's rows folded into x):
//   - warp 0 of every block picks the winner among the W candidates, 32 at
//     a time (the largest distance, then the lowest global index, the
//     lowest rank among equals), block 0 writes its index to out[:, t];
//   - unless `last`, each block streams its share of the slab, min-updates
//     the running distances in temp (B, nl) with (dx^2 + dy^2) + dz^2,
//     and offers its largest distance (-1 for a point with |p|^2 <= 1e-3),
//     the lowest index among equals; block 0 reads the blocks' offers
//     from their shared memory (between two cluster barriers) and writes
//     this rank's candidate, global index = offset + local, to
//     cand_out (B, 5).
// Bound by bytes (16 a point read, 4 written a step); the step's launch
// and the all-gather's host time bound the call.
constexpr int kStepThreads = 1024;

__global__ void __launch_bounds__(kStepThreads)
    fps_shard_step_kernel(const float* __restrict__ xyz,
                          float* __restrict__ temp,
                          const int* __restrict__ cands, int W, int B, int nl,
                          int share, int offset, int t, int last, int npoint,
                          int* __restrict__ out, int* __restrict__ cand_out) {
  __shared__ unsigned slot_k[2][32];
  __shared__ int slot_i[2][32];
  __shared__ float4 pick;
  __shared__ uint4 offer;  // this block's: key, x, y, z bits
  __shared__ int offer_i;
  cg::cluster_group cluster = cg::this_cluster();
  const int crank = (int)cluster.block_rank();
  const int blocks = (int)cluster.num_blocks();
  const int row = blockIdx.x / blocks;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (warp == 0) {
    unsigned key = 0;  // below every float's key
    int gi = INT_MAX, src = 0;
    for (int w0 = 0; w0 < W; w0 += 32) {
      unsigned k = 0;
      int g = INT_MAX;
      if (w0 + lane < W) {
        const int* c = cands + ((size_t)(w0 + lane) * B + row) * 5;
        k = ordered(__int_as_float(c[0]));
        g = c[1];
      }
      const unsigned top = __reduce_max_sync(kFullMask, k);
      const int best = __reduce_min_sync(kFullMask, k == top ? g : INT_MAX);
      if (top > key || (top == key && best < gi)) {
        key = top;
        gi = best;
        src = w0 +
              __ffs(__ballot_sync(kFullMask, k == top && g == best)) - 1;
      }
    }
    if (lane == 0) {
      if (crank == 0) out[(size_t)row * npoint + t] = gi;
      const int* c = cands + ((size_t)src * B + row) * 5;
      pick = make_float4(__int_as_float(c[2]), __int_as_float(c[3]),
                         __int_as_float(c[4]), 0.0f);
    }
  }
  if (last) return;  // every block of the grid: no barrier is pending
  __syncthreads();
  const float px = pick.x, py = pick.y, pz = pick.z;
  const float* p = xyz + (size_t)row * nl * 3;
  float* tm = temp + (size_t)row * nl;
  const int base = crank * share;
  const int end = min(nl, base + share);
  float bv = __int_as_float(0xff800000);
  int bi = INT_MAX;
  for (int i = base + tid; i < end; i += blockDim.x) {
    const float x = p[3 * i], y = p[3 * i + 1], z = p[3 * i + 2];
    const float d = sq3(__fsub_rn(x, px), __fsub_rn(y, py), __fsub_rn(z, pz));
    const float v = fminf(tm[i], d);
    tm[i] = v;
    const float o = sq3(x, y, z) > kMinSqNorm ? v : -1.0f;
    if (o > bv) {  // i rises, so strict > keeps the lowest index
      bv = o;
      bi = i;
    }
  }
  unsigned key = ordered(bv);
  bi = block_candidate(key, bi, tid, blockDim.x, false, slot_k, slot_i, 0);
  if (tid == 0) {
    offer = bi == INT_MAX
                ? make_uint4(key, 0u, 0u, 0u)
                : make_uint4(key, __float_as_uint(p[3 * bi]),
                             __float_as_uint(p[3 * bi + 1]),
                             __float_as_uint(p[3 * bi + 2]));
    offer_i = bi;
  }
  cluster.sync();  // every block's offer is in its shared memory
  if (crank == 0 && warp == 0) {
    uint4 c = make_uint4(0u, 0u, 0u, 0u);
    int ci = INT_MAX;
    if (lane < blocks) {
      c = *cluster.map_shared_rank(&offer, lane);
      ci = *cluster.map_shared_rank(&offer_i, lane);
    }
    // shares are consecutive, so among equal keys the lowest block rank
    // holds the lowest index
    const unsigned top = __reduce_max_sync(kFullMask, c.x);
    const int win = __reduce_min_sync(
        kFullMask, lane < blocks && c.x == top ? lane : INT_MAX);
    if (lane == win) {
      int* o = cand_out + (size_t)row * 5;
      o[0] = __float_as_int(unordered(top));
      o[1] = ci + offset;
      o[2] = (int)c.y;
      o[3] = (int)c.z;
      o[4] = (int)c.w;
    }
  }
  cluster.sync();  // block 0 has read every block's shared memory
}

// blocks a row of the step kernel for slabs of nl points: at least 4
// points a thread, at most 8 blocks (the portable cluster size)
int step_blocks(int nl) {
  int blocks = 1;
  while (blocks < 8 && (long long)blocks * kStepThreads * 4 < nl) blocks *= 2;
  return blocks;
}

// ------------------------------------------------------------------ merge

// slots [lo, up) of a centre's row `o` (r0 = its first slot's index in
// out), from the chunk of shards w0 .. w0 + 31 whose inclusive ends
// (`end`, the earlier chunks' hits included) and starts each lane holds:
// slot sl < total from the shard holding it, the rest `pad`. 16-byte
// quads wholly inside [lo, up) go as int4 stores (int4 loads where a quad
// comes from one shard at an aligned offset; chunk 0's shard 0 from
// `pre`, its first 32 quads read before the counts), the rest slot by
// slot. Without kWide the range is the whole row, and no range is
// checked.
template <bool kWide>
__device__ __forceinline__ void merge_range(
    const int* __restrict__ all_idx, int* o, int r0, int S, int BM, int bm,
    int nl, int w0, int shards, int end, int start, int total, int pad,
    int lo, int up, int4 pre, int lane) {
  const int a0 = (r0 + 3) & ~3;
  const int a1 = (r0 + S) & ~3;
  const int head = min(a0, r0 + S) - r0;
  const int tail0 = max(a1 - r0, head);
  const int nq = a1 > a0 ? (a1 - a0) >> 2 : 0;
  // the chunk's shard holding slot sl < total: its lanes whose end is <=
  // sl (the chunk's last shard ends past every slot it holds)
  auto owner = [&](int sl) {
    int own = 0;
    for (int w = 0; w + 1 < shards; ++w)
      own += __shfl_sync(kFullMask, end, w) <= sl ? 1 : 0;
    return own;
  };
  auto value = [&](int sl, int own, int st) {
    return sl < total
               ? all_idx[((w0 + own) * BM + bm) * S + sl - st] + (w0 + own) * nl
               : pad;
  };
  {
    int sl = -1;  // lanes 0-2 the head, lanes 4-6 the tail
    if (lane < head)
      sl = lane;
    else if (lane >= 4 && lane - 4 < S - tail0)
      sl = tail0 + lane - 4;
    const int own = owner(sl);
    const int st = __shfl_sync(kFullMask, start, own);
    if (sl >= 0 && (!kWide || (sl >= lo && sl < up)))
      o[sl] = value(sl, own, st);
  }
  for (int qb = 0; qb < nq; qb += 32) {
    const int q = qb + lane;
    const int sl = a0 - r0 + 4 * q;
    int own[4] = {0, 0, 0, 0};
    for (int w = 0; w + 1 < shards; ++w) {
      const int e = __shfl_sync(kFullMask, end, w);
#pragma unroll
      for (int k = 0; k < 4; ++k) own[k] += e <= sl + k ? 1 : 0;
    }
    int st[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) st[k] = __shfl_sync(kFullMask, start, own[k]);
    if (q >= nq) continue;
    if (kWide && (sl + 3 < lo || sl >= up)) continue;
    if (kWide && (sl < lo || sl + 3 >= up)) {  // cut by the range
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (sl + k >= lo && sl + k < up)
          o[sl + k] = value(sl + k, own[k], st[k]);
      continue;
    }
    int4 v;
    const int src = ((w0 + own[0]) * BM + bm) * S + sl - st[0];
    if (sl + 3 < total && own[3] == 0 && w0 == 0 && qb == 0) {
      v = pre;
    } else if (sl + 3 < total && own[0] == own[3] && (src & 3) == 0) {
      v = *reinterpret_cast<const int4*>(all_idx + src);
      const int add = (w0 + own[0]) * nl;
      v.x += add;
      v.y += add;
      v.z += add;
      v.w += add;
    } else {
      v = make_int4(value(sl, own[0], st[0]), value(sl + 1, own[1], st[1]),
                    value(sl + 2, own[2], st[2]),
                    value(sl + 3, own[3], st[3]));
    }
    *reinterpret_cast<int4*>(o + sl) = v;
  }
}

// One warp a centre. The counts come 32 shards a chunk: lane w of chunk
// w0 loads count w0 + w. Up to 32 shards (kWide false) are one chunk.
// Past 32, a first pass over the chunks sums the total and finds the
// first shard with a hit (the padding), then each chunk in turn fills
// the slots its hits reach, the running count carried from chunk to
// chunk, so the hits keep their global order; the chunk that reaches the
// total also writes the padding. (One kernel for both took 38% longer at
// one shard on an H100: PERF.md.)
template <bool kWide>
__global__ void __launch_bounds__(kMergeWarps * 32)
    ball_query_merge_kernel(const int* __restrict__ all_idx,
                            const int* __restrict__ all_cnt, int W, int BM,
                            int S, int nl, int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int bm = blockIdx.x * kMergeWarps + (threadIdx.x >> 5);
  if (bm >= BM) return;  // the whole warp
  const int r0 = bm * S;
  int* o = out + r0;
  const int a0 = (r0 + 3) & ~3;
  const int a1 = (r0 + S) & ~3;
  const int nq = a1 > a0 ? (a1 - a0) >> 2 : 0;
  // shard 0's quads of the first batch, read before the counts are known
  // (shard 0 starts at slot 0, so its quads are aligned where out's are):
  // with one shard, the counts and the indices arrive together
  int4 pre = make_int4(0, 0, 0, 0);
  if (lane < nq)
    pre = *reinterpret_cast<const int4*>(all_idx + a0 + 4 * lane);
  const int c0 = lane < W ? min(all_cnt[lane * BM + bm], S) : 0;
  int end = c0;  // chunk 0's inclusive ends
#pragma unroll
  for (int o2 = 1; o2 < 32; o2 <<= 1) {
    const int v = __shfl_up_sync(kFullMask, end, o2);
    if (lane >= o2) end += v;
  }
  int total = __shfl_sync(kFullMask, end, 31);
  int first = __ffs(__ballot_sync(kFullMask, c0 > 0)) - 1;
  if constexpr (kWide) {
    for (int w0 = 32; w0 < W; w0 += 32) {
      const int c =
          w0 + lane < W ? min(all_cnt[(w0 + lane) * BM + bm], S) : 0;
      total += __reduce_add_sync(kFullMask, c);
      const unsigned hit = __ballot_sync(kFullMask, c > 0);
      if (first < 0 && hit) first = w0 + __ffs(hit) - 1;
    }
  }
  // slots past the total repeat the first hit, slot 0; an empty ball is
  // zeros
  const int pre0 = __shfl_sync(kFullMask, pre.x, 0);
  int pad = 0;
  if (first == 0 && a0 == r0 && nq > 0)
    pad = pre0;
  else if (first >= 0)
    pad = all_idx[(first * BM + bm) * S] + first * nl;
  if constexpr (!kWide) {
    merge_range<false>(all_idx, o, r0, S, BM, bm, nl, 0, W, end, end - c0,
                       total, pad, 0, S, pre, lane);
  } else {
    const int reach = min(total, S);
    int carry = 0;  // the earlier chunks' hits
    for (int w0 = 0; w0 < W; w0 += 32) {
      int c = c0;
      if (w0 > 0) {
        c = w0 + lane < W ? min(all_cnt[(w0 + lane) * BM + bm], S) : 0;
        end = c;
#pragma unroll
        for (int o2 = 1; o2 < 32; o2 <<= 1) {
          const int v = __shfl_up_sync(kFullMask, end, o2);
          if (lane >= o2) end += v;
        }
        end += carry;
      }
      const int hi = __shfl_sync(kFullMask, end, 31);
      const bool closes = hi >= reach;
      merge_range<true>(all_idx, o, r0, S, BM, bm, nl, w0, min(32, W - w0),
                        end, end - c, total, pad, carry, closes ? S : hi,
                        pre, lane);
      if (closes) break;
      carry = hi;
    }
  }
}

// ------------------------------------------------------------ owned rows

__global__ void gather_owned_kernel(const float* __restrict__ points,
                                    const int* __restrict__ gidx, int B,
                                    int nl, long long R, int C, int offset,
                                    float* __restrict__ out) {
  const size_t total = static_cast<size_t>(B) * R * C;
  for (size_t tid = static_cast<size_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
       tid < total; tid += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t br = tid / C;
    const int c = static_cast<int>(tid % C);
    const size_t b = br / R;
    const int i = gidx[br] - offset;
    out[tid] = (i >= 0 && i < nl)
                   ? points[(b * nl + i) * static_cast<size_t>(C) + c]
                   : 0.0f;
  }
}

int grid_for(size_t total, int threads) {
  const size_t blocks = (total + threads - 1) / threads;
  return static_cast<int>(blocks < 65536 ? blocks : 65536);
}

}  // namespace

extern "C" {

// call `what` with the template argument P = points (0: the streamed
// form, else as VLP3D_REGS_DISPATCH)
#define VLP3D_LOOP_DISPATCH(points, what, refused)  \
  if (points == 0) {                                \
    constexpr int P = 0;                            \
    return what;                                    \
  }                                                 \
  VLP3D_REGS_DISPATCH(points, what, refused)

// A whole point-sharded FPS call: xyz rows of row_points points, each
// holding `ranks_here` consecutive slabs of nl points (one on a card of
// its own, W in the one-card emulation), ranks rank0 .. of W; out
// (ranks_here, b, npoint) i32 global indices. `clusters_per_rank`
// clusters of `cluster` blocks a rank (all must be resident: see
// vlp3d_fps_shard_loop_max_clusters), `points` a thread (2, 4, 8, 16 or
// 32 in registers; 0 streams the share from global memory, its running
// distances in temp, (ranks_here, b, nl) f32, else unused). peers: device
// array of W u64 pointers to the ranks' exchange buffers (24 * b * W int32
// each, 16-byte aligned, zeroed once); seq_base: above every sequence
// number a previous call on these buffers used (its low 32 bits are the
// flags), advanced by npoint a call; a wait for a rank's candidate that
// lasts timeout_s traps.
int vlp3d_fps_shard_loop(const void* xyz, int b, int row_points, int nl,
                         int npoint, int w, int rank0, int ranks_here,
                         int clusters_per_rank, int cluster, int points,
                         const void* peers, unsigned long long seq_base,
                         float timeout_s, void* temp, void* out,
                         void* stream) {
  if (cluster < 2 || cluster > kMaxBlocks || nl < 1 || b < 1 ||
      npoint < 1 || w < 1 || w > 32 || ranks_here < 1 ||
      clusters_per_rank < 1 || rank0 < 0 || rank0 + ranks_here > w ||
      !peers || (points == 0 && !temp))
    return (int)cudaErrorInvalidValue;
  const long long spin_ns = (long long)((double)timeout_s * 1e9);
  VLP3D_LOOP_DISPATCH(
      points,
      (LoopLaunch<P>::launch((const float*)xyz, b, row_points, nl, npoint, w,
                             rank0, ranks_here, clusters_per_rank, cluster,
                             (const unsigned long long*)peers, seq_base,
                             spin_ns, (float*)temp, (int*)out,
                             (cudaStream_t)stream)),
      (int)cudaErrorInvalidValue)
}

// How many clusters of `cluster` blocks of the loop kernel, each thread
// holding `points` points of an nl-point slab (0: streamed), the card
// runs at once (negative: refused).
int vlp3d_fps_shard_loop_max_clusters(int cluster, int nl, int points) {
  if (cluster < 2 || cluster > kMaxBlocks || nl < 1) return -1;
  VLP3D_LOOP_DISPATCH(points, LoopLaunch<P>::max_clusters(cluster, nl), -1)
}

// The PCI bus id of card `device` ("0000:18:00.0"), which names a card
// the same way in every process of a host, however each numbers its
// cards.
int vlp3d_pci_bus_id(int device, char* out, int len) {
  const cudaError_t err = cudaDeviceGetPCIBusId(out, len, device);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

// CUDA IPC of the exchange buffers: the 64-byte handle of the device
// allocation starting at `base`; that handle opened on the current device
// (peer access enabled as needed), its base in *ptr. An opened buffer
// stays mapped for the life of the process.
int vlp3d_ipc_handle(const void* base, void* handle) {
  cudaIpcMemHandle_t h;
  const cudaError_t err = cudaIpcGetMemHandle(&h, const_cast<void*>(base));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  memcpy(handle, &h, sizeof(h));
  return 0;
}

int vlp3d_ipc_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  const cudaError_t err =
      cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

// One step of the collective route: xyz (b, nl, 3) f32 this rank's slab,
// temp (b, nl) f32 its running distances (updated), cands (w, b, 5) i32
// the ranks' candidates of the previous iteration; out (b, npoint) i32
// gets the winner at column t; unless `last`, cand_out (b, 5) i32 this
// rank's candidate (global index = offset + local).
int vlp3d_fps_shard_step(const float* xyz, float* temp, const int* cands,
                         int w, int b, int nl, int offset, int t, int last,
                         int npoint, int* out, int* cand_out,
                         cudaStream_t stream) {
  if (w < 1 || b < 1 || nl < 1 || t < 0 || t >= npoint ||
      (!last && !cand_out))
    return (int)cudaErrorInvalidValue;
  const int blocks = step_blocks(nl);
  const int share = (nl + blocks - 1) / blocks;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3((unsigned)blocks * (unsigned)b);
  cfg.blockDim = dim3(kStepThreads);
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = blocks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, fps_shard_step_kernel, xyz, temp, cands, w, b, nl, share, offset,
      t, last, npoint, out, cand_out);
  const cudaError_t after = cudaGetLastError();  // also clears it
  return (int)(err != cudaSuccess ? err : after);
}

// all_idx (W, B, M, S) / all_cnt (W, B, M) i32 -> out (B, M, S) i32;
// any W >= 1, W * B * M * S < 2^31.
int vlp3d_ball_query_merge(const int* all_idx, const int* all_cnt, int W,
                           int B, int M, int S, int nl, int* out,
                           cudaStream_t stream) {
  if (W < 1) return (int)cudaErrorInvalidValue;
  const int bm = B * M;
  const int grid = (bm + kMergeWarps - 1) / kMergeWarps;
  if (W <= 32)
    ball_query_merge_kernel<false><<<grid, kMergeWarps * 32, 0, stream>>>(
        all_idx, all_cnt, W, bm, S, nl, out);
  else
    ball_query_merge_kernel<true><<<grid, kMergeWarps * 32, 0, stream>>>(
        all_idx, all_cnt, W, bm, S, nl, out);
  return static_cast<int>(cudaGetLastError());
}

int vlp3d_gather_owned(const float* points, const int* gidx, int B, int nl,
                       long long R, int C, int offset, float* out,
                       cudaStream_t stream) {
  const int threads = 256;
  const size_t total = static_cast<size_t>(B) * R * C;
  gather_owned_kernel<<<grid_for(total, threads), threads, 0, stream>>>(
      points, gidx, B, nl, R, C, offset, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
