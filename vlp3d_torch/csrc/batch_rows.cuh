// Batch rows on a launch grid, past the grid's 65535 on y: a kernel's
// rows go on the grid's y, those past 65535 on its z (rows_grid); a block
// finds its row with grid_row(). The grid's last z-slab may hold a few
// rows past the batch, which leave at once. Shared by ball_query.cu,
// three_nn.cu and voxelize.cu (whose write kernel puts its voxel blocks
// there). grouping.cu's two backwards keep z for their channel slices
// and handle the batch otherwise, each as its comment says.

#pragma once

#include <cuda_runtime.h>

namespace {

// A grid of x blocks a row by `rows` rows on y and z.
inline dim3 rows_grid(unsigned x, int rows) {
  return dim3(x, (unsigned)(rows < 65535 ? rows : 65535),
              (unsigned)((rows + 65534) / 65535));
}

// This block's row of a rows_grid launch.
__device__ __forceinline__ int grid_row() {
  return blockIdx.y + gridDim.y * blockIdx.z;
}

}  // namespace
