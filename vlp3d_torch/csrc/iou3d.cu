// Rotated bird's-eye-view box overlap, IoU and NMS for Hopper (sm_90a).
//
// Replaces vlp3d/ops/iou3d.py::boxes_overlap_bev / boxes_iou_bev (XLA:
// a vmapped fixed-shape polygon clip over all pairs) and ::nms_rotated /
// nms_normal (a fori_loop over the ranked IoU matrix), themselves the
// TPU rewrite of the reference's iou3d_kernel.cu. Boxes are
// [x1, y1, x2, y2, angle], rotated about their centre.
//
// The pair (pair_overlap): box A's four corners clipped against box B's
// edges k = 0..3 in order (Sutherland-Hodgman), the JAX function's
// arithmetic step for step: a vertex is inside when
// d.x * (p.y - a.y) - d.y * (p.x - a.x) >= 0; an edge that crosses
// emits t = s_cur / (s_cur - s_nxt) (the denominator 1e-12 when its
// magnitude is below 1e-12) and cur + (nxt - cur) * t; each edge emits
// its current vertex (if inside), then the intersection (if it
// crosses). The buffer has JAX's 16 slots: an emission past slot 15 is
// dropped while the count goes on, and a read past slot 15 reads slot
// 15, so identical, edge-sharing and nested boxes (whose clips emit
// duplicates) match. The area is |sum of cross products| / 2 summed in
// vertex order, 0 unless the count is at least 3; the IoU is
// inter / max(area_a + area_b - inter, 1e-8). overlap(a, b) is not
// overlap(b, a) in the last bits, so A is always the row box.
//
// iou_bev_kernel: one thread a pair, 16 x 16 pairs a block, the corners
//   of the block's 16 + 16 boxes in shared memory.
// nms_mask_kernel: on score-ranked boxes, bit j of row i is
//   iou(i, j) > thresh for j != i: a full N x ceil(N / 64) mask (JAX
//   suppresses over the whole row, so a later kept box can drop an
//   earlier kept one where the matrix is asymmetric; a j > i mask would
//   not), one thread a row and 64 columns, the same pair function.
// nms_scan_kernel: one warp walks the rows in rank order over an alive
//   bitmap in shared memory; a row that is alive clears its bits.
//
// What bounds it on the H100: arithmetic (about 9 float operations a
// vertex a clip and 6 an intersection, ~130 a pair at PointPillars'
// post-processing boxes, no tensor-core form) for the pairs, and, as
// written, the local-memory traffic of the vertex buffers; the scan is
// one serial chain of N dependent steps, each a row read.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxV = 16;  // JAX's _MAXV
constexpr int kTile = 16;
constexpr int kRows = 64;

struct Corners {
  float x[4], y[4];
  float area;
};

__device__ __forceinline__ Corners box_corners(const float* __restrict__ b) {
  Corners q;
  const float cx = __fdiv_rn(__fadd_rn(b[0], b[2]), 2.f);
  const float cy = __fdiv_rn(__fadd_rn(b[1], b[3]), 2.f);
  const float hx = __fdiv_rn(__fsub_rn(b[2], b[0]), 2.f);
  const float hy = __fdiv_rn(__fsub_rn(b[3], b[1]), 2.f);
  const float c = cosf(b[4]), s = sinf(b[4]);
  const float lx[4] = {-hx, hx, hx, -hx};
  const float ly[4] = {-hy, -hy, hy, hy};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // (local @ rot.T)[k] + centre, rot = [[c, -s], [s, c]]
    q.x[k] = __fadd_rn(__fsub_rn(__fmul_rn(lx[k], c), __fmul_rn(ly[k], s)),
                       cx);
    q.y[k] = __fadd_rn(__fadd_rn(__fmul_rn(lx[k], s), __fmul_rn(ly[k], c)),
                       cy);
  }
  q.area = __fmul_rn(__fsub_rn(b[2], b[0]), __fsub_rn(b[3], b[1]));
  return q;
}

__device__ __forceinline__ int next_slot(int idx, int count) {
  return idx + 1 >= count ? 0 : min(idx + 1, kMaxV - 1);
}

// the signed distance of (px, py) from edge (ax, ay) + t (dx, dy)
__device__ __forceinline__ float side(float dx, float dy, float ax, float ay,
                                      float px, float py) {
  return __fsub_rn(__fmul_rn(dx, __fsub_rn(py, ay)),
                   __fmul_rn(dy, __fsub_rn(px, ax)));
}

// The vertices live in two 16-slot buffers in local memory, each clip
// reading one and writing the other; slots past a polygon's count are
// never read (a read past the count wraps to slot 0), so neither is
// cleared. A vertex is read once a clip: the next vertex's coordinates
// and signed distance carry over to the next step (JAX computes the
// distance of a vertex twice, as cur and as nxt, from the same values).
__device__ float pair_overlap(const Corners& a, const Corners& b) {
  float vx[2][kMaxV], vy[2][kMaxV];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    vx[0][k] = a.x[k];
    vy[0][k] = a.y[k];
  }
  int count = 4;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float* ix = vx[k & 1];
    const float* iy = vy[k & 1];
    float* ox = vx[(k + 1) & 1];
    float* oy = vy[(k + 1) & 1];
    const float ax = b.x[k], ay = b.y[k];
    const float dx = __fsub_rn(b.x[(k + 1) & 3], ax);
    const float dy = __fsub_rn(b.y[(k + 1) & 3], ay);
    const int lim = min(count, kMaxV);
    int pos = 0;
    if (lim > 0) {
      const float x0 = ix[0], y0 = iy[0];
      const float s0 = side(dx, dy, ax, ay, x0, y0);
      float cx = x0, cy = y0, s_cur = s0;
      for (int idx = 0; idx < lim; ++idx) {
        const int nx = next_slot(idx, count);
        float px, py, s_nxt;
        if (nx == 0) {
          px = x0, py = y0, s_nxt = s0;
        } else if (nx == idx) {  // past slot 15: slot 15 itself
          px = cx, py = cy, s_nxt = s_cur;
        } else {
          px = ix[nx], py = iy[nx];
          s_nxt = side(dx, dy, ax, ay, px, py);
        }
        const bool in_cur = s_cur >= 0.f, in_nxt = s_nxt >= 0.f;
        if (in_cur) {
          if (pos < kMaxV) {
            ox[pos] = cx;
            oy[pos] = cy;
          }
          ++pos;
        }
        if (in_cur != in_nxt) {
          float den = __fsub_rn(s_cur, s_nxt);
          if (fabsf(den) < 1e-12f) den = 1e-12f;
          const float t = __fdiv_rn(s_cur, den);
          if (pos < kMaxV) {
            ox[pos] = __fadd_rn(cx, __fmul_rn(__fsub_rn(px, cx), t));
            oy[pos] = __fadd_rn(cy, __fmul_rn(__fsub_rn(py, cy), t));
          }
          ++pos;
        }
        cx = px, cy = py, s_cur = s_nxt;  // slot idx + 1 while it lasts
      }
    }
    count = pos;
  }
  if (count < 3) return 0.f;
  // the clips above ran 4 times: the polygon is in buffer 0
  const float* fx = vx[0];
  const float* fy = vy[0];
  const int lim = min(count, kMaxV);
  const float x0 = fx[0], y0 = fy[0];
  float cx = x0, cy = y0, sum = 0.f;
  for (int idx = 0; idx < lim; ++idx) {
    const int nx = next_slot(idx, count);
    float px, py;
    if (nx == 0) {
      px = x0, py = y0;
    } else if (nx == idx) {
      px = cx, py = cy;
    } else {
      px = fx[nx], py = fy[nx];
    }
    sum = __fadd_rn(sum, __fsub_rn(__fmul_rn(cx, py), __fmul_rn(px, cy)));
    cx = px, cy = py;
  }
  return __fdiv_rn(fabsf(sum), 2.f);
}

__device__ __forceinline__ float pair_iou(const Corners& a,
                                          const Corners& b) {
  const float inter = pair_overlap(a, b);
  return __fdiv_rn(inter,
                   fmaxf(__fsub_rn(__fadd_rn(a.area, b.area), inter), 1e-8f));
}

__global__ void iou_bev_kernel(const float* __restrict__ boxes_a,
                               const float* __restrict__ boxes_b, int n,
                               int m, int iou, float* __restrict__ out) {
  __shared__ Corners sa[kTile], sb[kTile];
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;
  if (tid < kTile && i0 + tid < n) sa[tid] = box_corners(boxes_a + 5 * (i0 + tid));
  if (tid >= kTile && tid < 2 * kTile && j0 + tid - kTile < m)
    sb[tid - kTile] = box_corners(boxes_b + 5 * (j0 + tid - kTile));
  __syncthreads();
  const int i = i0 + threadIdx.y, j = j0 + threadIdx.x;
  if (i >= n || j >= m) return;
  const Corners& a = sa[threadIdx.y];
  const Corners& b = sb[threadIdx.x];
  out[static_cast<long long>(i) * m + j] = iou ? pair_iou(a, b)
                                               : pair_overlap(a, b);
}

__global__ void nms_mask_kernel(const float* __restrict__ boxes, int n,
                                int words, float thresh,
                                unsigned long long* __restrict__ mask) {
  __shared__ Corners cols[kRows];
  const int j0 = blockIdx.x * kRows;
  const int i = blockIdx.y * kRows + threadIdx.x;
  if (j0 + threadIdx.x < n)
    cols[threadIdx.x] = box_corners(boxes + 5 * (j0 + threadIdx.x));
  __syncthreads();
  if (i >= n) return;
  const Corners row = box_corners(boxes + 5 * i);
  const int width = min(kRows, n - j0);
  unsigned long long bits = 0;
  for (int t = 0; t < width; ++t) {
    if (j0 + t != i && pair_iou(row, cols[t]) > thresh) bits |= 1ull << t;
  }
  mask[static_cast<long long>(i) * words + blockIdx.x] = bits;
}

__global__ void nms_scan_kernel(const unsigned long long* __restrict__ mask,
                                int n, int words,
                                const long long* __restrict__ order,
                                uint8_t* __restrict__ keep) {
  extern __shared__ unsigned long long alive[];
  const int lane = threadIdx.x;
  for (int w = lane; w < words; w += 32) {
    const int left = n - 64 * w;
    alive[w] = left >= 64 ? ~0ull : (1ull << left) - 1;
  }
  __syncwarp();
  for (int i = 0; i < n; ++i) {
    const bool on = (alive[i >> 6] >> (i & 63)) & 1ull;
    __syncwarp();
    if (on) {
      const unsigned long long* row = mask + static_cast<long long>(i) * words;
      for (int w = lane; w < words; w += 32) alive[w] &= ~row[w];
    }
    __syncwarp();
  }
  for (int i = lane; i < n; i += 32)
    keep[order[i]] = static_cast<uint8_t>((alive[i >> 6] >> (i & 63)) & 1ull);
}

}  // namespace

extern "C" {

// boxes_a (n, 5), boxes_b (m, 5) f32 -> out (n, m): IoU when iou != 0,
// else the intersection area
int vlp3d_iou_bev(const float* boxes_a, const float* boxes_b, int n, int m,
                  int iou, float* out, cudaStream_t stream) {
  if (n > 0 && m > 0) {
    const dim3 grid((m + kTile - 1) / kTile, (n + kTile - 1) / kTile);
    iou_bev_kernel<<<grid, dim3(kTile, kTile), 0, stream>>>(
        boxes_a, boxes_b, n, m, iou, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// ranked boxes (n, 5) f32, order (n,) i64 (rank -> box) -> keep (n,) bool
// by box; mask: n * ceil(n / 64) uint64 of scratch
int vlp3d_nms_bev(const float* ranked, const long long* order, int n,
                  float thresh, unsigned long long* mask, uint8_t* keep,
                  cudaStream_t stream) {
  if (n > 0) {
    const int words = (n + kRows - 1) / kRows;
    nms_mask_kernel<<<dim3(words, words), kRows, 0, stream>>>(
        ranked, n, words, thresh, mask);
    nms_scan_kernel<<<1, 32, sizeof(unsigned long long) * words, stream>>>(
        mask, n, words, order, keep);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
