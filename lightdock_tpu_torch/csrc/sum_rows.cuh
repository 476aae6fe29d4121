// The second pass shared by the pair kernels (K1-K5): each kernel writes
// per-tile (or per-block) partial rows of per-pose sums, and this adds the
// rows in row order, so that repeats of a call are bit-equal (no float
// atomics anywhere).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSumRowsThreads = 128;

// raw[g] = sum over rows, in row order, of partial[row][g]; the row count
// is n_rows, or *n_rows_dev when that is given.
__global__ void sum_rows_kernel(const float* __restrict__ partial,
                                const int32_t* __restrict__ n_rows_dev,
                                float* __restrict__ raw, int n_rows, int gp) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= gp) return;
  const int n = n_rows_dev != nullptr ? *n_rows_dev : n_rows;
  float s = 0.0f;
  for (int t = 0; t < n; ++t) s += partial[(size_t)t * gp + g];
  raw[g] = s;
}

// Launches sum_rows_kernel over gp poses on stream s; 0 or a CUDA error code.
inline int sum_rows(const float* partial, const int32_t* n_rows_dev, float* raw,
                    int n_rows, int gp, cudaStream_t s) {
  sum_rows_kernel<<<(gp + kSumRowsThreads - 1) / kSumRowsThreads, kSumRowsThreads, 0, s>>>(
      partial, n_rows_dev, raw, n_rows, gp);
  return (int)cudaGetLastError();
}

}  // namespace
