// Batched 2-D transpose (S, R, C) -> (S, C, R), any element of 2 or 4 bytes.
//
// Replaces unet_bssfp_tpu/ops/pallas/conv3d.py:pack_hw (_pack_kernel) and
// unpack_hw (_unpack_kernel). On the TPU the NDHWC <-> (B, D, C, H*W)
// relayout ran as identity GEMMs on the matrix unit, and only for 8 <= C
// <= 256; here one tiled shared-memory transpose serves both directions for
// every C: pack_hw is (B*D, H*W, C) -> (B*D, C, H*W), unpack_hw the reverse.
//
// What bounds it on an H100: it moves every byte twice (read once, write
// once) and computes nothing, so memory bandwidth bounds it. Design: a
// block of 256 threads moves one TR x TC tile through shared memory padded
// by one column, so both the global read (along C) and the global write
// (along R) are coalesced and the transposed read of the tile is free of
// bank conflicts. The tile is 32 x 32, or 256 x 32 / 32 x 256 where one side
// is at most 32 wide (the generator's 6- and 24-channel tensors), so every
// block moves at least 8 K elements. Where the tile spans whole rows of a
// side, that side is one contiguous run and is read or written linearly.
// All loops have compile-time trip counts (unrolled, loads in flight
// together). Elements are copied as raw bits (bf16 and f32 alike).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <typename T, int TR, int TC>
__global__ void __launch_bounds__(THREADS)
transpose_kernel(const T* __restrict__ in, T* __restrict__ out, int R, int C) {
  constexpr int ITERS = TR * TC / THREADS;
  __shared__ T tile[TR][TC + 1];  // [input row][input col]
  const long long slice = static_cast<long long>(blockIdx.z) * R * C;
  in += slice;
  out += slice;
  const int c0 = blockIdx.x * TC;
  const int r0 = blockIdx.y * TR;
  const int nc = min(TC, C - c0);
  const int nr = min(TR, R - r0);
  const int tid = threadIdx.x;

  if (nc == C) {  // whole input rows: in[r0*C, (r0+nr)*C) is contiguous
    const T* src = in + static_cast<long long>(r0) * C;
#pragma unroll
    for (int i = 0; i < ITERS; ++i) {
      const int k = tid + i * THREADS;
      if (k < nr * C) tile[k / C][k % C] = src[k];
    }
  } else {
#pragma unroll
    for (int i = 0; i < ITERS; ++i) {
      const int k = tid + i * THREADS;
      const int j = k / TC, c = k % TC;
      if (j < nr && c < nc) tile[j][c] = in[static_cast<long long>(r0 + j) * C + c0 + c];
    }
  }
  __syncthreads();
  if (nr == R) {  // whole output rows: out[c0*R, (c0+nc)*R) is contiguous
    T* dst = out + static_cast<long long>(c0) * R;
#pragma unroll
    for (int i = 0; i < ITERS; ++i) {
      const int k = tid + i * THREADS;
      if (k < nc * R) dst[k] = tile[k % R][k / R];
    }
  } else {
#pragma unroll
    for (int i = 0; i < ITERS; ++i) {
      const int k = tid + i * THREADS;
      const int c = k / TR, j = k % TR;
      if (j < nr && c < nc) out[static_cast<long long>(c0 + c) * R + r0 + j] = tile[j][c];
    }
  }
}

template <typename T, int TR, int TC>
int launch_tiles(const void* in, void* out, int S, int R, int C, void* stream) {
  const dim3 grid((C + TC - 1) / TC, (R + TR - 1) / TR, S);
  transpose_kernel<T, TR, TC><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in), static_cast<T*>(out), R, C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* in, void* out, int S, int R, int C, void* stream) {
  if (C <= 32) return launch_tiles<T, 256, 32>(in, out, S, R, C, stream);
  if (R <= 32) return launch_tiles<T, 32, 256>(in, out, S, R, C, stream);
  return launch_tiles<T, 32, 32>(in, out, S, R, C, stream);
}

}  // namespace

extern "C" {

// in: (S, R, C) contiguous, out: (S, C, R) contiguous; itemsize 2 or 4.
// Returns the cudaError_t of the launch.
int transpose_last2(const void* in, void* out, int S, int R, int C,
                    int itemsize, void* stream) {
  if (itemsize == 2) return launch<uint16_t>(in, out, S, R, C, stream);
  if (itemsize == 4) return launch<uint32_t>(in, out, S, R, C, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
