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
// What bounds it on the H100: not bytes (a row's coordinates, 480 KB at
// N=40960, are read once per step from L2) nor arithmetic (about 8
// flops a point a step), but the npoint serial steps, each of which
// ends in a block-wide argmax. This design gives each batch row one
// block of 1024 threads with the running distances in dynamic shared
// memory (160 KB at N=40960, past the 48 KB default, hence the opt-in),
// so a step costs one pass over N/1024 points a thread plus a two-level
// shuffle reduction. With B=8 only 8 of 132 SMs work; spreading a row
// over a thread-block cluster is later work. Rows whose distances do not
// fit in shared memory keep them in a global scratch the caller passes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr float kMinSqNorm = 1e-3f;
constexpr float kInit = 1e10f;

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

}  // namespace

extern "C" {

// Largest dynamic shared memory (bytes) a block of fps_kernel may use.
int vlp3d_fps_smem_limit(void) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, fps_kernel) != cudaSuccess) return 0;
  return optin - (int)attr.sharedSizeBytes;
}

// xyz: (b, n, 3) f32; out: (b, npoint) i32; temp_global: (b, n) f32
// scratch, or null to keep the running distances in shared memory.
int vlp3d_fps(const void* xyz, int b, int n, int npoint, void* out,
              void* temp_global, void* stream) {
  size_t smem = temp_global ? 0 : (size_t)n * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fps_kernel<<<b, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)xyz, n, npoint, (int*)out, (float*)temp_global);
  return (int)cudaGetLastError();
}

}  // extern "C"
