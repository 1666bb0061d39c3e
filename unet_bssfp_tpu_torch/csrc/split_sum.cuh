// The fixed-order split sum of the weight-gradient kernels (conv3x3_wgrad.cu,
// conv3x3_wgrad_wgmma.cu): out[i] = sum over k in split order of
// part[k * n + i]. No atomics, so the result repeats bit for bit.

#pragma once

#include <cuda_runtime.h>

namespace {

__global__ void conv3x3_wgrad_reduce_kernel(const float* __restrict__ part,
                                            float* __restrict__ out, long long n, int splits) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[k * n + i];
  out[i] = s;
}

}  // namespace
