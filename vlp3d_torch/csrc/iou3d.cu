// Rotated bird's-eye-view box overlap, IoU and NMS for Hopper (sm_90a).
//
// Replaces vlp3d/ops/iou3d.py::boxes_overlap_bev / boxes_iou_bev (XLA:
// a vmapped fixed-shape polygon clip over all pairs) and ::nms_rotated /
// nms_normal (a fori_loop over the ranked IoU matrix), themselves the
// TPU rewrite of the reference's iou3d_kernel.cu. Boxes are
// [x1, y1, x2, y2, angle], rotated about their centre.
//
// The pair: box A's four corners clipped against box B's edges k = 0..3
// in order (Sutherland-Hodgman), the JAX function's arithmetic step for
// step: a vertex is inside when d.x * (p.y - a.y) - d.y * (p.x - a.x) >=
// 0; an edge that crosses emits t = s_cur / (s_cur - s_nxt) (the
// denominator 1e-12 when its magnitude is below 1e-12) and cur + (nxt -
// cur) * t; each edge emits its current vertex (if inside), then the
// intersection (if it crosses). The area is |sum of cross products| / 2
// summed in vertex order, 0 unless the count is at least 3; the IoU is
// inter / max(area_a + area_b - inter, 1e-8). overlap(a, b) is not
// overlap(b, a) in the last bits, so A is always the row box.
//
// box_corners_kernel: each box's corners and area once, into a (n, 9)
//   table [x0..x3, y0..y3, area] that the pair kernels read.
// iou_tile_kernel / nms_mask_kernel (one routine, pair_tile): a block
//   takes a tile of row and column boxes, their corners in shared
//   memory; a warp takes one row box at a time and its lanes 32
//   neighbouring columns, so a row of `out` is written coalesced and a
//   mask word is two ballots. A pair takes the first of three screens
//   that settles it, each run by a warp's 32 lanes on 32 pairs so that
//   no lane idles on a neighbour's longer clip:
//   1. (screen) clip by clip, while A's four corners lie all inside B's
//      edge the clip is the identity; all outside, the polygon is empty.
//      90% of phase 17's pairs end here (empty, or A inside B).
//   2. (clips_empty) a pair whose corners straddle edge k0 goes into
//      its warp's queue; 32 at a time, the points that clip emits are
//      held against the later edges: all outside one, the polygon is
//      empty whatever their order. Two in three queued pairs end here.
//   3. (clip_regs) the rest go to a second queue and, 32 at a time,
//      through the ordered clip from edge k0 on, the polygon in 8
//      register slots, every slot index a constant after unrolling, an
//      emission written to its position by a select. A convex 4-gon
//      clipped by 4 half-planes keeps at most 8 vertices; only
//      degenerate pairs (vertices within rounding of an edge) emit
//      more, and those are finished by JAX's 16-slot routine
//      (pair_overlap16: an emission past slot 15 is dropped while the
//      count goes on, a read past slot 15 reads slot 15), its buffers
//      in the warp's shared memory, one lane at a time.
//   Each step's result is JAX's to the bit: an identity clip keeps the
//   polygon, an all-outside clip empties it, and the ordered clip is
//   JAX's arithmetic.
// nms_mask_kernel: on score-ranked boxes, bit j of row i is iou(i, j) >
//   thresh for j != i: a full N x ceil(N / 64) mask (JAX suppresses over
//   the whole row, so a later kept box can drop an earlier kept one
//   where the matrix is asymmetric; a j > i mask would not).
// nms_scan_kernel: one block walks the 64-row blocks in rank order. A
//   row is kept at its own step (is in S) iff no earlier member of S
//   has its bit, and the keep mask is ~(OR of S's rows) (ROADMAP C23).
//   One thread resolves a block's 64 decisions from its still-alive
//   word and the block's 64 diagonal words; then all threads OR the
//   full rows of the block's members into a `removed` bitmap in shared
//   memory, while the next block's diagonal words arrive by cp.async.
//   The dependent chain is N / 64 block steps, not N row steps.
//
// What bounds it on the H100: arithmetic (about 9 float operations a
// vertex a clip and 6 an intersection; 71 a pair at phase 17's boxes,
// no tensor-core form), and, as written, instruction throughput: the
// screens' and clips' instructions with the lanes a warp's pairs leave
// idle. The queues flush at the end of each tile, so a tile's pairs per
// warp set how full its last passes run: of the tiles timed on the H100
// at 4096 boxes (64 x 128 up to 128 x 512; PERF.md), 256 x 256
// (256 pairs a thread, 8 warps of 89-90 registers, two blocks an SM) was
// fastest, 64 x 128 slowest. Where most pairs reach the ordered clip
// (chip_smoke.py's crowded set) the time grows about 5.6x, and stays
// below a thread a pair's. All four kernels compile to no stack frame
// and no spills except box_corners_kernel's 32 bytes (sinf / cosf's
// reduction of large angles).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxV = 16;  // JAX's _MAXV: the degenerate path's slots
constexpr int kRegV = 8;   // the register path's slots
constexpr int kBox = 9;    // a corner table's row: x0..x3, y0..y3, area
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kQueue = 64;  // a warp's queued pairs (< 32 + 32)
constexpr int kScanThreads = 1024;
// a block's tile of pairs: row boxes x column boxes
constexpr int kTileRows = 256, kTileCols = 256;
constexpr int kTileWords = kTileCols / 32;  // a tile row's 32-bit mask words

// the tile's shared memory: corners, queues, 16-slot buffers and (the
// NMS mask) its bits
constexpr int tile_smem(bool mask) {
  return 4 * (kBox * (kTileRows + kTileCols) + 2 * kWarps * kQueue +
              kWarps * 4 * kMaxV + (mask ? kTileRows * kTileWords : 0));
}

// a queue entry holds a column in 12 bits and a row from bit 14; a mask
// word is two 32-bit words of one tile
static_assert(kTileCols % 64 == 0 && kTileCols <= 4096, "tile columns");
static_assert(kTileRows <= 16384, "tile rows");
static_assert(tile_smem(true) <= 48 * 1024, "tile shared memory");

struct Box {
  float x[4], y[4];
  float area;
};

__device__ __forceinline__ Box load_box(const float* __restrict__ t) {
  Box q;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    q.x[k] = t[k];
    q.y[k] = t[4 + k];
  }
  q.area = t[8];
  return q;
}

// the signed distance of (px, py) from edge (ax, ay) + t (dx, dy)
__device__ __forceinline__ float side(float dx, float dy, float ax, float ay,
                                      float px, float py) {
  return __fsub_rn(__fmul_rn(dx, __fsub_rn(py, ay)),
                   __fmul_rn(dy, __fsub_rn(px, ax)));
}

__device__ __forceinline__ float cross_term(float cx, float cy, float px,
                                            float py) {
  return __fsub_rn(__fmul_rn(cx, py), __fmul_rn(px, cy));
}

__device__ __forceinline__ float finish(float inter, float area_a,
                                        float area_b, int iou) {
  // 0 / max(union, 1e-8) is +0 for any union: no division for an empty
  // pair (most pairs)
  if (!iou || inter == 0.f) return inter;
  return __fdiv_rn(inter,
                   fmaxf(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-8f));
}

// The first clip of A's corners against B's edges (b: a table row) that
// is neither all inside nor all outside: 0..3; 4 when every clip is all
// inside (the polygon is A), -1 when one is all outside (it is empty).
__device__ __forceinline__ int screen(const Box& a,
                                      const float* __restrict__ b) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float ax = b[k], ay = b[4 + k];
    const float dx = __fsub_rn(b[(k + 1) & 3], ax);
    const float dy = __fsub_rn(b[4 + ((k + 1) & 3)], ay);
    int in = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      in += side(dx, dy, ax, ay, a.x[i], a.y[i]) >= 0.f;
    if (in == 0) return -1;
    if (in < 4) return k;
  }
  return 4;
}

// the area of A's own 4-gon, as the clip's area sums it
__device__ __forceinline__ float quad_area(const Box& a) {
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    sum = __fadd_rn(sum, cross_term(a.x[i], a.y[i], a.x[(i + 1) & 3],
                                    a.y[(i + 1) & 3]));
  return __fdiv_rn(fabsf(sum), 2.f);
}

// A pair whose corners straddle B's edge k0: that clip emits A's inside
// corners and, where the edge from vertex i to i + 1 crosses, the point
// at JAX's t. While all of these lie inside a later edge, that clip is
// the identity; all outside, the polygon is empty whatever their order.
// True when it is (the overlap is 0); false when the pair needs the
// ordered clip (a later edge straddles, none empties it, or the clip at
// k0 crosses more than twice).
__device__ __forceinline__ bool clips_empty(const Box& a,
                                            const float* __restrict__ b,
                                            int k0) {
  float ax = b[k0], ay = b[4 + k0];
  float dx = __fsub_rn(b[(k0 + 1) & 3], ax);
  float dy = __fsub_rn(b[4 + ((k0 + 1) & 3)], ay);
  float s[4];
  unsigned in = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s[i] = side(dx, dy, ax, ay, a.x[i], a.y[i]);
    if (s[i] >= 0.f) in |= 1u << i;
  }
  const unsigned cross = in ^ ((in >> 1) | ((in & 1u) << 3));
  if (__popc(cross) != 2) return false;
  // the emitted points: slots 0..3 A's corners (those inside), 4 and 5
  // the two crossings
  float qx[6], qy[6];
  unsigned live = in | (3u << 4);
  int slot = 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qx[i] = a.x[i];
    qy[i] = a.y[i];
    if ((cross >> i) & 1u) {
      float den = __fsub_rn(s[i], s[(i + 1) & 3]);
      if (fabsf(den) < 1e-12f) den = 1e-12f;
      const float t = __fdiv_rn(s[i], den);
      const float cx = __fadd_rn(
          a.x[i], __fmul_rn(__fsub_rn(a.x[(i + 1) & 3], a.x[i]), t));
      const float cy = __fadd_rn(
          a.y[i], __fmul_rn(__fsub_rn(a.y[(i + 1) & 3], a.y[i]), t));
      // the first crossing to slot 4, the second to slot 5
      if (slot == 4) {
        qx[4] = cx, qy[4] = cy;
      } else {
        qx[5] = cx, qy[5] = cy;
      }
      ++slot;
    }
  }
  for (int k = k0 + 1; k < 4; ++k) {
    ax = b[k], ay = b[4 + k];
    dx = __fsub_rn(b[(k + 1) & 3], ax);
    dy = __fsub_rn(b[4 + ((k + 1) & 3)], ay);
    unsigned inside = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i)
      if (side(dx, dy, ax, ay, qx[i], qy[i]) >= 0.f) inside |= 1u << i;
    inside &= live;
    if (inside == 0) return true;
    if (inside != live) return false;
  }
  return false;
}

// Write (vx, vy) to slot pos of (ox, oy) when on. `reach`, a constant
// once the caller's loop is unrolled, is the largest slot pos can be, so
// only slots 0..reach are selects.
__device__ __forceinline__ void emit(float (&ox)[kRegV], float (&oy)[kRegV],
                                     int reach, int pos, bool on, float vx,
                                     float vy) {
#pragma unroll
  for (int j = 0; j < kRegV; ++j) {
    if (j <= reach && on && pos == j) {
      ox[j] = vx;
      oy[j] = vy;
    }
  }
}

// Clip A by B's edges k0..3 (A's corners are the polygon up to edge k0:
// the clips before it were all inside) with the polygon in registers;
// the intersection area into `inter`. False when a clip would emit more
// than kRegV vertices: the pair needs pair_overlap16.
__device__ __forceinline__ bool clip_regs(const Box& a,
                                          const float* __restrict__ b, int k0,
                                          float& inter) {
  float px[kRegV], py[kRegV];
#pragma unroll
  for (int i = 0; i < kRegV; ++i) {
    px[i] = a.x[i & 3];
    py[i] = a.y[i & 3];
  }
  int count = 4;
  for (int k = k0; k < 4; ++k) {
    const float ax = b[k], ay = b[4 + k];
    const float dx = __fsub_rn(b[(k + 1) & 3], ax);
    const float dy = __fsub_rn(b[4 + ((k + 1) & 3)], ay);
    float s[kRegV];
    unsigned in = 0;
#pragma unroll
    for (int i = 0; i < kRegV; ++i) {
      s[i] = 0.f;
      if (i < count) {
        s[i] = side(dx, dy, ax, ay, px[i], py[i]);
        if (s[i] >= 0.f) in |= 1u << i;
      }
    }
    if (in == 0) {
      count = 0;
      break;
    }
    if (in == (1u << count) - 1) continue;  // all inside: the identity
    float ox[kRegV], oy[kRegV];
#pragma unroll
    for (int j = 0; j < kRegV; ++j) ox[j] = oy[j] = 0.f;
    int pos = 0;
#pragma unroll
    for (int i = 0; i < kRegV; ++i) {
      if (i < count) {
        // the next vertex: slot i + 1, or slot 0 after the last
        const bool wrap = i + 1 >= count;
        const int nx = i + 1 < kRegV ? i + 1 : 0;
        const float qx = wrap ? px[0] : px[nx];
        const float qy = wrap ? py[0] : py[nx];
        const float s_nxt = wrap ? s[0] : s[nx];
        const bool in_cur = (in >> i) & 1u;
        const bool in_nxt = s_nxt >= 0.f;
        emit(ox, oy, 2 * i, pos, in_cur, px[i], py[i]);
        pos += in_cur;
        if (in_cur != in_nxt) {
          float den = __fsub_rn(s[i], s_nxt);
          if (fabsf(den) < 1e-12f) den = 1e-12f;
          const float t = __fdiv_rn(s[i], den);
          emit(ox, oy, 2 * i + 1, pos, true,
               __fadd_rn(px[i], __fmul_rn(__fsub_rn(qx, px[i]), t)),
               __fadd_rn(py[i], __fmul_rn(__fsub_rn(qy, py[i]), t)));
          ++pos;
        }
      }
    }
    if (pos > kRegV) return false;
#pragma unroll
    for (int j = 0; j < kRegV; ++j) {
      px[j] = ox[j];
      py[j] = oy[j];
    }
    count = pos;
  }
  float sum = 0.f;
  if (count >= 3) {
#pragma unroll
    for (int i = 0; i < kRegV; ++i) {
      if (i < count) {
        const bool wrap = i + 1 >= count;
        const int nx = i + 1 < kRegV ? i + 1 : 0;
        sum = __fadd_rn(sum, cross_term(px[i], py[i], wrap ? px[0] : px[nx],
                                        wrap ? py[0] : py[nx]));
      }
    }
  }
  inter = count >= 3 ? __fdiv_rn(fabsf(sum), 2.f) : 0.f;
  return true;
}

__device__ __forceinline__ int next_slot(int idx, int count) {
  return idx + 1 >= count ? 0 : min(idx + 1, kMaxV - 1);
}

// JAX's 16-slot clip, for the pairs clip_regs refuses. The vertices live
// in two 16-slot buffers (buf: 2 x 2 x kMaxV floats of shared memory),
// each clip reading one and writing the other; slots past a polygon's
// count are never read (a read past the count wraps to slot 0), so
// neither is cleared. A vertex is read once a clip: the next vertex's
// coordinates and signed distance carry over to the next step.
__device__ __forceinline__ float pair_overlap16(const float* a,
                                               const float* b, float* buf) {
  float* vx[2] = {buf, buf + 2 * kMaxV};
  float* vy[2] = {buf + kMaxV, buf + 3 * kMaxV};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    vx[0][k] = a[k];
    vy[0][k] = a[4 + k];
  }
  int count = 4;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float* ix = vx[k & 1];
    const float* iy = vy[k & 1];
    float* ox = vx[(k + 1) & 1];
    float* oy = vy[(k + 1) & 1];
    const float ax = b[k], ay = b[4 + k];
    const float dx = __fsub_rn(b[(k + 1) & 3], ax);
    const float dy = __fsub_rn(b[4 + ((k + 1) & 3)], ay);
    const int lim = min(count, kMaxV);
    int pos = 0;
    if (lim > 0) {
      const float x0 = ix[0], y0 = iy[0];
      const float s0 = side(dx, dy, ax, ay, x0, y0);
      float cx = x0, cy = y0, s_cur = s0;
      for (int idx = 0; idx < lim; ++idx) {
        const int nx = next_slot(idx, count);
        float qx, qy, s_nxt;
        if (nx == 0) {
          qx = x0, qy = y0, s_nxt = s0;
        } else if (nx == idx) {  // past slot 15: slot 15 itself
          qx = cx, qy = cy, s_nxt = s_cur;
        } else {
          qx = ix[nx], qy = iy[nx];
          s_nxt = side(dx, dy, ax, ay, qx, qy);
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
            ox[pos] = __fadd_rn(cx, __fmul_rn(__fsub_rn(qx, cx), t));
            oy[pos] = __fadd_rn(cy, __fmul_rn(__fsub_rn(qy, cy), t));
          }
          ++pos;
        }
        cx = qx, cy = qy, s_cur = s_nxt;  // slot idx + 1 while it lasts
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
    float qx, qy;
    if (nx == 0) {
      qx = x0, qy = y0;
    } else if (nx == idx) {
      qx = cx, qy = cy;
    } else {
      qx = fx[nx], qy = fy[nx];
    }
    sum = __fadd_rn(sum, cross_term(cx, cy, qx, qy));
    cx = qx, cy = qy;
  }
  return __fdiv_rn(fabsf(sum), 2.f);
}

__global__ void box_corners_kernel(const float* __restrict__ boxes_a, int n,
                                   const float* __restrict__ boxes_b, int m,
                                   float* __restrict__ table_a,
                                   float* __restrict__ table_b) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n + m) return;
  const float* b = t < n ? boxes_a + 5 * t : boxes_b + 5 * (t - n);
  float* q = t < n ? table_a + kBox * t : table_b + kBox * (t - n);
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
    q[k] = __fadd_rn(__fsub_rn(__fmul_rn(lx[k], c), __fmul_rn(ly[k], s)),
                     cx);
    q[4 + k] = __fadd_rn(__fadd_rn(__fmul_rn(lx[k], s), __fmul_rn(ly[k], c)),
                         cy);
  }
  q[8] = __fmul_rn(__fsub_rn(b[2], b[0]), __fsub_rn(b[3], b[1]));
}

// Where a tile's pair results go: out[i][j] (the IoU when iou, else the
// area), or (kMask) bit j of row i, iou(i, j) > thresh for j != i, into
// the tile's 32-bit words in shared memory, then the (n, words) mask.
struct PairOut {
  float* out;
  unsigned long long* mask;
  unsigned* bits;  // the tile's rows x kTileWords words
  int m, i0, j0, iou;
  float thresh;

  __device__ __forceinline__ bool over(float inter, float area_a,
                                       float area_b, int r, int c) const {
    return i0 + r != j0 + c && finish(inter, area_a, area_b, 1) > thresh;
  }

  // one pair's result, from a lane of its own (not a row's ballot)
  template <bool kMask>
  __device__ __forceinline__ void put(float inter, float area_a,
                                      float area_b, int r, int c) const {
    if constexpr (kMask) {
      if (over(inter, area_a, area_b, r, c))
        atomicOr(bits + r * kTileWords + (c >> 5), 1u << (c & 31));
    } else {
      out[static_cast<long long>(i0 + r) * m + j0 + c] =
          finish(inter, area_a, area_b, iou);
    }
  }
};

// A warp's queue of pairs in shared memory: entries (r << 14) | (c << 2)
// | k0, at most 63 (a push adds up to 32 below 32)
struct Queue {
  int* q;
  int size;

  // lanes with `on` push their entry; true once 32 are waiting
  __device__ __forceinline__ bool push(bool on, int entry) {
    const unsigned lanes = __ballot_sync(~0u, on);
    if (on) q[size + __popc(lanes & ((1u << (threadIdx.x & 31)) - 1))] = entry;
    size += __popc(lanes);
    return size >= 32;
  }

  // the entry of this lane among the last cnt (cnt <= 32), and pops them;
  // -1 for a lane past cnt
  __device__ __forceinline__ int pop(int cnt) {
    __syncwarp();
    const int lane = threadIdx.x & 31;
    size -= cnt;
    const int e = lane < cnt ? q[size + lane] : -1;
    __syncwarp();
    return e;
  }
};

// The ordered clip of up to 32 pairs (entries e, one a lane; -1 none),
// and their results.
template <bool kMask>
__device__ __forceinline__ void clip_pairs(const PairOut& o,
                                           const float* rows,
                                           const float* cols, int e,
                                           float* slow) {
  const int lane = threadIdx.x & 31;
  const bool mine = e >= 0;
  const int r = mine ? e >> 14 : 0, c = mine ? (e >> 2) & 4095 : 0;
  const float* a_row = rows + kBox * r;
  const float* b = cols + kBox * c;
  const Box a = load_box(a_row);
  float inter = 0.f;
  const bool done = !mine || clip_regs(a, b, e & 3, inter);
  for (unsigned left = __ballot_sync(~0u, !done); left; left &= left - 1) {
    if (lane == __ffs(left) - 1) inter = pair_overlap16(a_row, b, slow);
    __syncwarp();
  }
  if (mine) o.put<kMask>(inter, a.area, b[8], r, c);
}

// The second screen of up to 32 straddling pairs (entries e): an empty
// one's result is written, the rest go to `full`, which the warp clips
// 32 at a time.
template <bool kMask>
__device__ __forceinline__ void sift_pairs(const PairOut& o,
                                           const float* rows,
                                           const float* cols, int e,
                                           Queue& full, float* slow) {
  const bool mine = e >= 0;
  const int r = mine ? e >> 14 : 0, c = mine ? (e >> 2) & 4095 : 0;
  const float* b = cols + kBox * c;
  const Box a = load_box(rows + kBox * r);
  const bool empty = mine && clips_empty(a, b, e & 3);
  if (empty) o.put<kMask>(0.f, a.area, b[8], r, c);
  if (full.push(mine && !empty, e))
    clip_pairs<kMask>(o, rows, cols, full.pop(32), slow);
}

// A block's tile of pairs: rows i0.. of table ta (n rows) against
// columns j0.. of table tb (m rows); blocks are numbered row-tile major.
template <bool kMask>
__device__ __forceinline__ void pair_tile(const float* __restrict__ ta,
                                          const float* __restrict__ tb, int n,
                                          int m, PairOut o) {
  extern __shared__ float smem[];
  float* rows = smem;
  float* cols = rows + kBox * kTileRows;
  int* queues = reinterpret_cast<int*>(cols + kBox * kTileCols);
  float* slows = reinterpret_cast<float*>(queues + 2 * kWarps * kQueue);
  o.bits = reinterpret_cast<unsigned*>(slows + kWarps * 4 * kMaxV);
  o.m = m;
  const int col_tiles = (m + kTileCols - 1) / kTileCols;
  o.i0 = static_cast<int>(blockIdx.x / col_tiles) * kTileRows;
  o.j0 = static_cast<int>(blockIdx.x % col_tiles) * kTileCols;
  const int nr = min(kTileRows, n - o.i0), nc = min(kTileCols, m - o.j0);
  for (int t = threadIdx.x; t < kBox * nr; t += kThreads)
    rows[t] = ta[static_cast<long long>(kBox) * o.i0 + t];
  for (int t = threadIdx.x; t < kBox * nc; t += kThreads)
    cols[t] = tb[static_cast<long long>(kBox) * o.j0 + t];
  if constexpr (kMask) {
    for (int t = threadIdx.x; t < kTileRows * kTileWords; t += kThreads)
      o.bits[t] = 0u;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // a warp's pairs that straddle an edge, and those needing the ordered
  // clip: each screened densely, 32 at a time
  Queue straddle{queues + 2 * kQueue * warp, 0};
  Queue full{queues + 2 * kQueue * warp + kQueue, 0};
  float* slow = slows + warp * 4 * kMaxV;
  for (int r = warp; r < nr; r += kWarps) {
    for (int c0 = 0; c0 < nc; c0 += 32) {
      // the row box anew each chunk: nothing of it is live across a
      // clip of queued pairs
      const Box a = load_box(rows + kBox * r);
      const int c = c0 + lane;
      int k0 = -1;
      float inter = 0.f;
      if (c < nc) {
        k0 = screen(a, cols + kBox * c);
        if (k0 == 4) inter = quad_area(a);
      }
      const bool later = k0 >= 0 && k0 < 4;
      const bool now = c < nc && !later;
      const float area_b = cols[kBox * min(c, nc - 1) + 8];
      if constexpr (kMask) {
        const unsigned word =
            __ballot_sync(~0u, now && o.over(inter, a.area, area_b, r, c));
        if (lane == 0) o.bits[r * kTileWords + (c0 >> 5)] = word;
      } else if (now) {
        o.out[static_cast<long long>(o.i0 + r) * m + o.j0 + c] =
            finish(inter, a.area, area_b, o.iou);
      }
      if (straddle.push(later, (r << 14) | (c << 2) | k0))
        sift_pairs<kMask>(o, rows, cols, straddle.pop(32), full, slow);
    }
  }
  if (straddle.size > 0)
    sift_pairs<kMask>(o, rows, cols, straddle.pop(straddle.size), full,
                      slow);
  if (full.size > 0)
    clip_pairs<kMask>(o, rows, cols, full.pop(full.size), slow);
  if constexpr (kMask) {
    // the tile's 64-bit words: bits 0..31 the even 32-bit word
    __syncthreads();
    constexpr int per_row = kTileCols / 64;
    const int words = (m + 63) / 64;
    for (int t = threadIdx.x; t < nr * per_row; t += kThreads) {
      const int r = t / per_row, q = t % per_row, w = o.j0 / 64 + q;
      if (w >= words) continue;
      const unsigned* bw = o.bits + r * kTileWords + 2 * q;
      o.mask[static_cast<long long>(o.i0 + r) * words + w] =
          bw[0] | (static_cast<unsigned long long>(bw[1]) << 32);
    }
  }
}

// two blocks an SM: with no such bound ptxas gives nms_mask_kernel 80
// registers and a stack frame with spills, and it runs slower
__global__ void __launch_bounds__(kThreads, 2)
    iou_tile_kernel(const float* __restrict__ ta, const float* __restrict__ tb,
                    int n, int m, int iou, float* __restrict__ out) {
  PairOut o{};
  o.out = out;
  o.iou = iou;
  pair_tile<false>(ta, tb, n, m, o);
}

__global__ void __launch_bounds__(kThreads, 2)
    nms_mask_kernel(const float* __restrict__ table, int n, float thresh,
                    unsigned long long* __restrict__ mask) {
  PairOut o{};
  o.mask = mask;
  o.thresh = thresh;
  pair_tile<true>(table, table, n, n, o);
}

// Row 64 b + t's word b (the block's diagonal word) into dst by cp.async;
// zero past row n.
__device__ __forceinline__ void fetch_diag(unsigned long long* dst,
                                           const unsigned long long* mask,
                                           int n, int words, int b, int t) {
  const int row = 64 * b + t;
  const unsigned long long* src =
      row < n ? mask + static_cast<long long>(row) * words + b : mask;
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(dst + t));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(addr),
               "l"(src), "r"(row < n ? 8 : 0));
}

__global__ void __launch_bounds__(kScanThreads)
    nms_scan_kernel(const unsigned long long* __restrict__ mask, int n,
                    int words, const long long* __restrict__ order,
                    uint8_t* __restrict__ keep) {
  extern __shared__ unsigned long long removed[];  // words, then 2 x 64
  unsigned long long* diag = removed + words;
  __shared__ int members[64];
  __shared__ int n_members;
  const int tid = threadIdx.x;
  for (int w = tid; w < words; w += kScanThreads) removed[w] = 0ull;
  if (tid < 64) fetch_diag(diag, mask, n, words, 0, tid);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int b = 0; b < words; ++b) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // block b's diagonal words and removed[b] are final
    if (b + 1 < words && tid < 64)
      fetch_diag(diag + 64 * ((b + 1) & 1), mask, n, words, b + 1, tid);
    asm volatile("cp.async.commit_group;\n" ::);
    if (tid == 0) {
      // rank order within the block: the lowest alive row is in S and
      // drops its row's bits of this block
      const int left = n - 64 * b;
      unsigned long long alive =
          ~removed[b] & (left >= 64 ? ~0ull : (1ull << left) - 1);
      const unsigned long long* d = diag + 64 * (b & 1);
      int cnt = 0;
      while (alive) {
        const int r = __ffsll(static_cast<long long>(alive)) - 1;
        members[cnt++] = 64 * b + r;
        alive &= alive - 1;
        alive &= ~d[r];
      }
      n_members = cnt;
    }
    __syncthreads();
    const int items = n_members * words;
#pragma unroll 4
    for (int it = tid; it < items; it += kScanThreads) {
      const int w = it % words;
      const unsigned long long row =
          mask[static_cast<long long>(members[it / words]) * words + w];
      if (row) atomicOr(removed + w, row);
    }
  }
  __syncthreads();
  // kept: not dropped by any member of S (a row outside S was dropped by
  // an earlier member)
  for (int i = tid; i < n; i += kScanThreads)
    keep[order[i]] =
        static_cast<uint8_t>(!((removed[i >> 6] >> (i & 63)) & 1ull));
}

int corners(const float* a, int n, const float* b, int m, float* ta,
            float* tb, cudaStream_t stream) {
  box_corners_kernel<<<(n + m + 255) / 256, 256, 0, stream>>>(a, n, b, m, ta,
                                                              tb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// boxes_a (n, 5), boxes_b (m, 5) f32 -> out (n, m): IoU when iou != 0,
// else the intersection area; tables: (n + m) x 9 floats of scratch
int vlp3d_iou_bev(const float* boxes_a, const float* boxes_b, int n, int m,
                  int iou, float* tables, float* out, cudaStream_t stream) {
  if (n <= 0 || m <= 0) return 0;
  float* tb = tables + static_cast<long long>(kBox) * n;
  const int rc = corners(boxes_a, n, boxes_b, m, tables, tb, stream);
  if (rc) return rc;
  const long long blocks =
      static_cast<long long>((n + kTileRows - 1) / kTileRows) *
      ((m + kTileCols - 1) / kTileCols);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  iou_tile_kernel<<<static_cast<unsigned>(blocks), kThreads, tile_smem(false),
                    stream>>>(tables, tb, n, m, iou, out);
  return static_cast<int>(cudaGetLastError());
}

// ranked boxes (n, 5) f32, order (n,) i64 (rank -> box) -> keep (n,) bool
// by box; table: n x 9 floats and mask: n * ceil(n / 64) uint64 of
// scratch
int vlp3d_nms_bev(const float* ranked, const long long* order, int n,
                  float thresh, float* table, unsigned long long* mask,
                  uint8_t* keep, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int words = (n + 63) / 64;
  const int scan_smem = 8 * (words + 2 * 64);
  if (scan_smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        scan_smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int rc = corners(ranked, n, nullptr, 0, table, nullptr, stream);
  if (rc) return rc;
  const long long blocks =
      static_cast<long long>((n + kTileRows - 1) / kTileRows) *
      ((n + kTileCols - 1) / kTileCols);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  nms_mask_kernel<<<static_cast<unsigned>(blocks), kThreads, tile_smem(true),
                    stream>>>(table, n, thresh, mask);
  nms_scan_kernel<<<1, kScanThreads, scan_smem, stream>>>(mask, n, words,
                                                          order, keep);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
