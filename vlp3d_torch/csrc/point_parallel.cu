// Point-axis (sequence) parallel kernels: the per-rank pieces of the
// point-sharded SA front end (vlp3d_torch/parallel/point_parallel.py).
//
// Replaces the TPU side of vlp3d/parallel/point_parallel.py, which has no
// Pallas kernel of its own there: XLA fuses fps_sharded's loop body
// (point_parallel.py:74-130), ball_query_sharded's merge (:133-205) and
// _owned_rows (:208-219) around the pmax / pmin / psum collectives. Here
// each becomes one hand kernel between two NCCL collectives:
//
//   * fps_shard_step: one FPS iteration on this rank's slab. It picks the
//     previous iteration's global winner from the all-gathered
//     candidates (largest running distance, then lowest global index;
//     invalid points, |p|^2 <= 1e-3, offer -1 as JAX's cand does), writes
//     that index, min-updates the slab's running distance with the
//     winner's coordinates and writes this block's candidate: (distance
//     bits, global index as an int32, x, y, z bits), five int32 lanes, so
//     an index is never carried in a float lane. A row is cut into G
//     chunks, one block each; every chunk's candidate joins the
//     all-gather, so no block waits for another and the pick reads W * G
//     candidates. Bound by latency at SA1's shapes (2048 dependent
//     launches, each with a collective); a launch moves the slab's xyz and
//     running distance once (20 bytes a point). The state lives in global
//     memory between launches, so fps.cu's points-in-registers loop does
//     not apply.
//   * ball_query_merge: the all-gathered per-shard (first-k local
//     indices, in-ball count) of ball_query.cu's count variant, merged
//     into global slots: slot s of a centre comes from the first shard
//     whose cumulative count (each capped at nsample) exceeds s, at local
//     slot s - (the counts before it), plus that shard's offset; slots
//     past the total repeat the first hit; an empty ball is all zeros.
//     One thread a (b, m, slot). Bound by bytes.
//   * gather_owned: rows of this rank's slab at global indices, a row of
//     zeros where another rank owns the index (the sum over the point
//     group then holds every row once). Not grouping.cu's gather on
//     idx - offset: that one wraps [-N, 0) and gives NaN elsewhere, and
//     NaN * 0 stays NaN. One thread an output element. Bound by bytes.
//
// Distances are (dx*dx + dy*dy) + dz*dz with dx = x - px, spelled with
// __fmul_rn / __fadd_rn / __fsub_rn (and built with --fmad=false), so the
// picks equal the dense FPS's and JAX's bit for bit.

#include <cfloat>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr float kMinSqNorm = 1e-3f;  // sampling_gpu.cu:105-106
constexpr float kEmptyChunk = -3.0f;  // below any real candidate (-1)
constexpr int kNoIndex = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sq3(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// a beats b: larger value, then lower index
__device__ __forceinline__ bool beats(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

__global__ void fps_shard_step_kernel(const float* __restrict__ xyz,
                                      float* __restrict__ temp,
                                      const int* __restrict__ cands,
                                      int ncand, int B, int nl, int offset,
                                      int chunk, int t, int npoint, int last,
                                      int* __restrict__ out_idx,
                                      int* __restrict__ my_cand) {
  const int g = blockIdx.x, b = blockIdx.y;
  __shared__ float win[3];
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  if (threadIdx.x == 0) {
    // (a) the previous iteration's winner
    float bv = -FLT_MAX;
    int bi = kNoIndex, bc = 0;
    for (int c = 0; c < ncand; ++c) {
      const int* q = cands + (static_cast<size_t>(c) * B + b) * 5;
      const float v = __int_as_float(q[0]);
      if (beats(v, q[1], bv, bi)) {
        bv = v;
        bi = q[1];
        bc = c;
      }
    }
    const int* q = cands + (static_cast<size_t>(bc) * B + b) * 5;
    win[0] = __int_as_float(q[2]);
    win[1] = __int_as_float(q[3]);
    win[2] = __int_as_float(q[4]);
    // (b) its index
    if (g == 0) out_idx[static_cast<size_t>(b) * npoint + t] = bi;
  }
  __syncthreads();
  if (last) return;
  const float px = win[0], py = win[1], pz = win[2];
  // (c) the running distance of this block's chunk, (d) its candidate
  const int lo = g * chunk;
  const int hi = min(lo + chunk, nl);
  float bv = kEmptyChunk;
  int bi = kNoIndex;
  const float* row = xyz + static_cast<size_t>(b) * nl * 3;
  float* trow = temp + static_cast<size_t>(b) * nl;
  for (int n = lo + threadIdx.x; n < hi; n += blockDim.x) {
    const float x = row[3 * n], y = row[3 * n + 1], z = row[3 * n + 2];
    const float d = sq3(__fsub_rn(x, px), __fsub_rn(y, py),
                        __fsub_rn(z, pz));
    const float tmp = fminf(trow[n], d);
    trow[n] = tmp;
    const float c = sq3(x, y, z) > kMinSqNorm ? tmp : -1.0f;
    if (beats(c, n, bv, bi)) {
      bv = c;
      bi = n;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float v2 = __shfl_down_sync(kFull, bv, o);
    const int i2 = __shfl_down_sync(kFull, bi, o);
    if (beats(v2, i2, bv, bi)) {
      bv = v2;
      bi = i2;
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red_v[warp] = bv;
    red_i[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    bv = lane < nwarps ? red_v[lane] : kEmptyChunk;
    bi = lane < nwarps ? red_i[lane] : kNoIndex;
    for (int o = 16; o > 0; o >>= 1) {
      const float v2 = __shfl_down_sync(kFull, bv, o);
      const int i2 = __shfl_down_sync(kFull, bi, o);
      if (beats(v2, i2, bv, bi)) {
        bv = v2;
        bi = i2;
      }
    }
    if (lane == 0) {
      int* q = my_cand + (static_cast<size_t>(g) * B + b) * 5;
      q[0] = __float_as_int(bv);
      if (bi == kNoIndex) {
        q[1] = kNoIndex;
        q[2] = q[3] = q[4] = 0;
      } else {
        q[1] = bi + offset;
        q[2] = __float_as_int(row[3 * bi]);
        q[3] = __float_as_int(row[3 * bi + 1]);
        q[4] = __float_as_int(row[3 * bi + 2]);
      }
    }
  }
}

__global__ void ball_query_merge_kernel(const int* __restrict__ all_idx,
                                        const int* __restrict__ all_cnt,
                                        int W, int B, int M, int S, int nl,
                                        int* __restrict__ out) {
  const size_t total = static_cast<size_t>(B) * M * S;
  const size_t bm_all = static_cast<size_t>(B) * M;
  for (size_t tid = static_cast<size_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
       tid < total; tid += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int s = static_cast<int>(tid % S);
    const size_t bm = tid / S;
    int seen = 0, owner = -1, ostart = 0, first = -1;
    for (int w = 0; w < W; ++w) {
      const int c = min(all_cnt[w * bm_all + bm], S);
      if (c > 0 && first < 0) first = w;
      if (owner < 0 && s < seen + c) {
        owner = w;
        ostart = seen;
      }
      seen += c;
    }
    int v = 0;
    if (owner >= 0) {
      v = all_idx[(owner * bm_all + bm) * S + (s - ostart)] + owner * nl;
    } else if (first >= 0) {
      v = all_idx[(first * bm_all + bm) * S] + first * nl;
    }
    out[tid] = v;
  }
}

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

// cands (ncand, B, 5) i32; temp (B, nl) f32 in/out; out_idx (B, npoint);
// my_cand (groups, B, 5) i32, one chunk of `chunk` points a block.
int vlp3d_fps_shard_step(const float* xyz, float* temp, const int* cands,
                         int ncand, int B, int nl, int offset, int groups,
                         int chunk, int threads, int t, int npoint, int last,
                         int* out_idx, int* my_cand, cudaStream_t stream) {
  dim3 grid(groups, B);
  fps_shard_step_kernel<<<grid, threads, 0, stream>>>(
      xyz, temp, cands, ncand, B, nl, offset, chunk, t, npoint, last,
      out_idx, my_cand);
  return static_cast<int>(cudaGetLastError());
}

int vlp3d_ball_query_merge(const int* all_idx, const int* all_cnt, int W,
                           int B, int M, int S, int nl, int* out,
                           cudaStream_t stream) {
  const int threads = 256;
  const size_t total = static_cast<size_t>(B) * M * S;
  ball_query_merge_kernel<<<grid_for(total, threads), threads, 0, stream>>>(
      all_idx, all_cnt, W, B, M, S, nl, out);
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
