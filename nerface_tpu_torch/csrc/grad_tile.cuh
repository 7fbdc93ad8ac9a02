// The backward passes' ordered sums: `reduce_rows` adds the partial rows
// of a pass (dW's row segments, the CTAs' bias and head sums) in a fixed
// order, so two calls give bit-identical gradients (K1 and K3b,
// paper_train.cuh; K4b, fused_flex.cu); `align256` lays out their
// workspaces.

#pragma once

#include "mma_tile.cuh"

namespace nerface {

__host__ __device__ inline size_t align256(size_t x) { return (x + 255) & ~size_t(255); }

// out[c] = Σ_{p in order} part[p][c] for c < C; columns below C1 go to
// out1[c], the others to out2[c − C1].
__global__ void reduce_rows(const float* __restrict__ part, int P, int C, int C1, float* out1,
                            float* out2) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float sum = 0.f;
  for (int p = 0; p < P; ++p) sum += part[(size_t)p * C + c];
  if (c < C1)
    out1[c] = sum;
  else
    out2[c - C1] = sum;
}

}  // namespace nerface
