/* Native host-side data-loader kernels: vlp3d_torch's copy of
 * vlp3d/native/loader.c, the same code built with the same flags.
 *
 * Host-side counterpart of the reference's C++-backed loading path (the
 * reference leans on torch DataLoader's native workers + CUDA prefetcher;
 * our hot per-item work runs here instead): single-pass GT vote
 * regeneration (lib/joint/dataset.py:669-678 does a Python loop over
 * np.unique(instance_labels) with a full boolean mask per instance —
 * O(N * n_instances); this is O(N)).
 *
 * Built on demand with `cc -O3 -shared -fPIC`, loaded via ctypes
 * (no pybind11 in this environment).
 */

#include <pthread.h>
#include <stdint.h>
#include <string.h>
#include <sys/mman.h>

#define MAX_INSTANCES 4096

/* ---------------------------------------------------------------- buffers
 *
 * Size-bucketed free-list of mmap'd buffers for the large recurring
 * batch allocations. Fresh ~170 MB numpy allocations pay a first-touch
 * page-fault storm on every batch — and numpy madvises MADV_HUGEPAGE for
 * large buffers, which under THP defrag=madvise turns each fault into
 * synchronous compaction (measured 50-400 ms per batch depending on
 * compaction debt, vs ~30 ms for a reused buffer). Buffers here are
 * MADV_NOHUGEPAGE mmaps recycled through a per-size free list; the
 * Python wrapper ties release to numpy view refcounts, so recycling is
 * correct even when a zero-copy consumer (torch.from_numpy) keeps a
 * reference. Lists are capped per size; overflow is munmap'd.
 */

#define BUF_BUCKETS 64
#define BUF_CACHE_PER_BUCKET 8

typedef struct FreeNode {
  struct FreeNode *next;
} FreeNode;

static pthread_mutex_t buf_lock = PTHREAD_MUTEX_INITIALIZER;
static FreeNode *free_lists[BUF_BUCKETS];
static int free_counts[BUF_BUCKETS];
static size_t bucket_sizes[BUF_BUCKETS];
static int n_buckets = 0;

static int bucket_for(size_t size, int create) {
  for (int i = 0; i < n_buckets; ++i) {
    if (bucket_sizes[i] == size) return i;
  }
  if (create && n_buckets < BUF_BUCKETS) {
    bucket_sizes[n_buckets] = size;
    return n_buckets++;
  }
  return -1;
}

void *vlp3d_buf_acquire(size_t size) {
  void *p = NULL;
  pthread_mutex_lock(&buf_lock);
  int b = bucket_for(size, 1);
  if (b >= 0 && free_lists[b]) {
    p = free_lists[b];
    free_lists[b] = free_lists[b]->next;
    free_counts[b]--;
  }
  pthread_mutex_unlock(&buf_lock);
  if (p) return p;
  p = mmap(NULL, size, PROT_READ | PROT_WRITE,
           MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
  if (p == MAP_FAILED) return NULL;
  madvise(p, size, MADV_NOHUGEPAGE);
  return p;
}

void vlp3d_buf_release(void *p, size_t size) {
  if (!p) return;
  pthread_mutex_lock(&buf_lock);
  int b = bucket_for(size, 0);
  if (b >= 0 && free_counts[b] < BUF_CACHE_PER_BUCKET &&
      size >= sizeof(FreeNode)) {
    FreeNode *node = (FreeNode *)p;
    node->next = free_lists[b];
    free_lists[b] = node;
    free_counts[b]++;
    pthread_mutex_unlock(&buf_lock);
    return;
  }
  pthread_mutex_unlock(&buf_lock);
  munmap(p, size);
}

/* points: (n, stride) float32, xyz in the first 3 columns.
 * instance_labels: (n,) int64 in [0, MAX_INSTANCES).
 * semantic_ok: (n,) uint8 — 1 if the point's semantic label is in the
 *   detection set (precomputed by the caller).
 * votes_out: (n, 3) float32; mask_out: (n,) float32.
 *
 * Semantics: for every instance whose FIRST point (scan order) has
 * semantic_ok, each member point votes for the instance's AABB center
 * (0.5 * (min + max) over member xyz). Matches dataset.py:669-678 where
 * the semantic gate reads semantic_labels[ind[0]].
 */
void compute_votes(const float *points, int64_t stride, int64_t n,
                   const int64_t *instance_labels,
                   const uint8_t *semantic_ok, float *votes_out,
                   float *mask_out) {
  static const float FMAX = 3.4e38f;
  float mins[MAX_INSTANCES][3];
  float maxs[MAX_INSTANCES][3];
  uint8_t seen[MAX_INSTANCES];
  uint8_t ok[MAX_INSTANCES];
  memset(seen, 0, sizeof(seen));

  for (int64_t i = 0; i < n; ++i) {
    int64_t ins = instance_labels[i];
    if (ins < 0 || ins >= MAX_INSTANCES) continue;
    const float *p = points + i * stride;
    if (!seen[ins]) {
      seen[ins] = 1;
      ok[ins] = semantic_ok[i]; /* gate on the first member's semantics */
      for (int d = 0; d < 3; ++d) {
        mins[ins][d] = p[d];
        maxs[ins][d] = p[d];
      }
    } else {
      for (int d = 0; d < 3; ++d) {
        if (p[d] < mins[ins][d]) mins[ins][d] = p[d];
        if (p[d] > maxs[ins][d]) maxs[ins][d] = p[d];
      }
    }
  }

  for (int64_t i = 0; i < n; ++i) {
    int64_t ins = instance_labels[i];
    const float *p = points + i * stride;
    float *v = votes_out + i * 3;
    if (ins >= 0 && ins < MAX_INSTANCES && seen[ins] && ok[ins]) {
      for (int d = 0; d < 3; ++d) {
        v[d] = 0.5f * (mins[ins][d] + maxs[ins][d]) - p[d];
      }
      mask_out[i] = 1.0f;
    } else {
      v[0] = v[1] = v[2] = 0.0f;
      mask_out[i] = 0.0f;
    }
  }
  (void)FMAX;
}

void gather_rows_i64(const int64_t *src, const int64_t *idx, int64_t n_out,
                     int64_t *out) {
  for (int64_t i = 0; i < n_out; ++i) out[i] = src[idx[i]];
}

void gather_u8(const uint8_t *src, const int64_t *idx, int64_t n_out,
               uint8_t *out) {
  for (int64_t i = 0; i < n_out; ++i) out[i] = src[idx[i]];
}

/* Fused sample-gather + train-time augmentation + height channel.
 *
 * One pass per item instead of five (row gather, narrow xyz copy-out,
 * flip/rotate/scale/translate numpy passes, copy-back, height write).
 * The arithmetic replicates the numpy augment chain BIT-FOR-BIT:
 *
 *   - flip: exact f32 negation (utils_fn.py:28-40);
 *   - rotate/scale: numpy evaluates the elementwise-f64 form
 *     (x*m00 + y*m10) + z*m20 per output column (augment.py
 *     apply_mat3_points — deliberately NOT np.dot, whose BLAS dgemm may
 *     use FMA with different f64-internal rounding) and rounds to f32 on
 *     the slice store. Here: promote to double, same grouping, one
 *     (float) round per step. The build passes -ffp-contract=off so the
 *     compiler cannot fuse a*b+c into FMA either.
 *   - col-3 scale: numpy's `pc[:, 3] * float(s22)` runs an f32 loop
 *     under NEP 50 (python float is weak) -> f32 scalar, f32 multiply.
 *   - translate: numpy's in-place += with a float64 rhs runs the f64
 *     loop and casts on store -> (float)((double)x + t).
 *   - height: f32 subtract of the (f32) floor percentile, computed from
 *     the RAW z before augmentation (dataset.py:603-607 computes height
 *     on the pre-augment cloud).
 *
 * Column layout quirks mirrored from the reference (utils_fn.py:116-117
 * scales column 3 WHATEVER it holds): with c_raw == 3 the height IS
 * column 3 and gets scaled; with feature channels, column 3 is the first
 * feature (scaled) and the unscaled height lands in the last column.
 */
void gather_augment_rows(const float *src, int64_t src_stride,
                         const int64_t *idx, int64_t n_out, int64_t c_raw,
                         float *out, int64_t out_stride, int64_t c_out,
                         int augment, int flip0, int flip1,
                         const double *rot, const double *scale,
                         float s22_f32, const double *trans,
                         int use_height, float floor_height) {
  for (int64_t i = 0; i < n_out; ++i) {
    const float *s = src + idx[i] * src_stride;
    float *o = out + i * out_stride;
    memcpy(o, s, (size_t)c_raw * sizeof(float));
    float h_pre = 0.0f;
    if (use_height) h_pre = s[2] - floor_height;
    if (augment) {
      float x = o[0], y = o[1], z = o[2];
      if (flip0) x = -x;
      if (flip1) y = -y;
      double dx = x, dy = y, dz = z;
      /* volatile: each stage must ROUND to f32 exactly where the numpy
       * chain stores to the f32 array; without it the optimizer keeps
       * the value in a double register across stages (measured: the
       * (float) cast was elided at -O3, skipping the intermediate
       * round and drifting 1 ulp vs the numpy path). */
      volatile float rx =
          (float)((dx * rot[0] + dy * rot[3]) + dz * rot[6]);
      volatile float ry =
          (float)((dx * rot[1] + dy * rot[4]) + dz * rot[7]);
      volatile float rz =
          (float)((dx * rot[2] + dy * rot[5]) + dz * rot[8]);
      dx = rx;
      dy = ry;
      dz = rz;
      volatile float sx =
          (float)((dx * scale[0] + dy * scale[3]) + dz * scale[6]);
      volatile float sy =
          (float)((dx * scale[1] + dy * scale[4]) + dz * scale[7]);
      volatile float sz =
          (float)((dx * scale[2] + dy * scale[5]) + dz * scale[8]);
      o[0] = (float)((double)sx + trans[0]);
      o[1] = (float)((double)sy + trans[1]);
      o[2] = (float)((double)sz + trans[2]);
      if (use_height) {
        float v3 = (c_raw == 3) ? h_pre : o[3];
        float v3s = v3 * s22_f32;
        o[3] = v3s;
        if (c_raw != 3) o[c_out - 1] = h_pre;
      }
    } else if (use_height) {
      o[c_out - 1] = h_pre;
    }
  }
}

/* compute_votes with the GT_VOTE_FACTOR=3 tiling (np.tile(votes, (1, 3)),
 * dataset.py:679) and the int64 mask folded in, writing both straight
 * into their batch-buffer slots. Same instance/center semantics as
 * compute_votes above. */
void compute_votes_tiled(const float *points, int64_t stride, int64_t n,
                         const int64_t *instance_labels,
                         const uint8_t *semantic_ok, float *votes_out,
                         int64_t votes_stride, int64_t *mask_out) {
  float mins[MAX_INSTANCES][3];
  float maxs[MAX_INSTANCES][3];
  uint8_t seen[MAX_INSTANCES];
  uint8_t ok[MAX_INSTANCES];
  memset(seen, 0, sizeof(seen));

  for (int64_t i = 0; i < n; ++i) {
    int64_t ins = instance_labels[i];
    if (ins < 0 || ins >= MAX_INSTANCES) continue;
    const float *p = points + i * stride;
    if (!seen[ins]) {
      seen[ins] = 1;
      ok[ins] = semantic_ok[i];
      for (int d = 0; d < 3; ++d) {
        mins[ins][d] = p[d];
        maxs[ins][d] = p[d];
      }
    } else {
      for (int d = 0; d < 3; ++d) {
        if (p[d] < mins[ins][d]) mins[ins][d] = p[d];
        if (p[d] > maxs[ins][d]) maxs[ins][d] = p[d];
      }
    }
  }

  for (int64_t i = 0; i < n; ++i) {
    int64_t ins = instance_labels[i];
    const float *p = points + i * stride;
    float *v = votes_out + i * votes_stride;
    if (ins >= 0 && ins < MAX_INSTANCES && seen[ins] && ok[ins]) {
      for (int d = 0; d < 3; ++d) {
        float vd = 0.5f * (mins[ins][d] + maxs[ins][d]) - p[d];
        v[d] = vd;
        v[3 + d] = vd;
        v[6 + d] = vd;
      }
      mask_out[i] = 1;
    } else {
      for (int d = 0; d < 9; ++d) v[d] = 0.0f;
      mask_out[i] = 0;
    }
  }
}
