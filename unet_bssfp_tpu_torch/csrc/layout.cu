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
// is at most 32 wide (the generator's 24-channel tensors), so every block
// moves at least 8 K elements. Where the tile spans whole rows of a side,
// that side is one contiguous run and is read or written linearly. All loops
// have compile-time trip counts (unrolled, loads in flight together).
// Elements are copied as raw bits (bf16 and f32 alike).
//
// A narrow side (NC <= 16 channels: the generator's 6-channel output, K3b,
// and its gradient through pack_hw, K3a) takes the narrow path instead: one
// thread moves V = 16 / itemsize pixels of all NC channels, reading NC
// 16-byte vectors of one side and writing NC of the other, the permutation
// done in registers (NC is a template parameter, so every index is known at
// compile time). No shared memory, no idle thread at any NC, and a block of
// 256 threads moves 256 * 16 * NC bytes each way (24 KB at NC 6; two groups
// per thread at NC 1). The 256 x 32 tile at C 6 left 26 of its 32 rows idle
// and moved 2 bytes per access. Which path a shape takes is decided by the
// caller (ops/kernels/layout.py:transpose_path) and checked here.

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

// in: (S, NC, P) planar -> out: (S, P, NC) interleaved (TO_PLANAR false), or
// the reverse; P a multiple of V, both pointers 16-byte aligned. Thread g of
// the grid moves pixels g*V .. g*V + V - 1 of the flattened (S*P) pixels.
template <typename T, int NC, bool TO_PLANAR>
__global__ void __launch_bounds__(THREADS)
narrow_transpose_kernel(const T* __restrict__ in, T* __restrict__ out, long long groups,
                        long long P) {
  constexpr int V = 16 / sizeof(T);
  constexpr int G = NC == 1 ? 2 : 1;  // groups per thread
  union Vec {
    uint4 u;
    T e[V];
  };
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const long long g = (static_cast<long long>(blockIdx.x) * G + k) * THREADS + threadIdx.x;
    if (g >= groups) return;
    const long long gp = g * V, s = gp / P, p = gp % P;
    const long long planar = s * NC * P + p;  // channel c's V pixels at + c * P
    const long long inter = gp * NC;          // NC * V contiguous elements
    Vec a[NC], b[NC];
    if (!TO_PLANAR) {
#pragma unroll
      for (int c = 0; c < NC; ++c) a[c].u = *reinterpret_cast<const uint4*>(in + planar + c * P);
#pragma unroll
      for (int e = 0; e < NC * V; ++e) b[e / V].e[e % V] = a[e % NC].e[e / NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) *reinterpret_cast<uint4*>(out + inter + c * V) = b[c].u;
    } else {
#pragma unroll
      for (int c = 0; c < NC; ++c) a[c].u = *reinterpret_cast<const uint4*>(in + inter + c * V);
#pragma unroll
      for (int e = 0; e < NC * V; ++e) b[e % NC].e[e / NC] = a[e / V].e[e % V];
#pragma unroll
      for (int c = 0; c < NC; ++c) *reinterpret_cast<uint4*>(out + planar + c * P) = b[c].u;
    }
  }
}

template <typename T, int NC, bool TO_PLANAR>
int launch_narrow_nc(const void* in, void* out, long long groups, long long P,
                     cudaStream_t stream) {
  constexpr int G = NC == 1 ? 2 : 1;
  const long long blocks = (groups + G * THREADS - 1) / (G * THREADS);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  narrow_transpose_kernel<T, NC, TO_PLANAR>
      <<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(static_cast<const T*>(in),
                                                              static_cast<T*>(out), groups, P);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool TO_PLANAR, int NC = 1>
int launch_narrow(int nc, const void* in, void* out, long long groups, long long P,
                  cudaStream_t stream) {
  if (nc == NC) return launch_narrow_nc<T, NC, TO_PLANAR>(in, out, groups, P, stream);
  if constexpr (NC < 16) {
    return launch_narrow<T, TO_PLANAR, NC + 1>(nc, in, out, groups, P, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int TR, int TC>
int launch_tiles(const void* in, void* out, int S, int R, int C, void* stream) {
  const dim3 grid((C + TC - 1) / TC, (R + TR - 1) / TR, S);
  transpose_kernel<T, TR, TC><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in), static_cast<T*>(out), R, C);
  return static_cast<int>(cudaGetLastError());
}

constexpr int PATH_TILES = 0;     // the tiles of transpose_kernel
constexpr int PATH_NARROW_C = 1;  // (S, R, C) -> (S, C, R) with C <= 16: pack_hw
constexpr int PATH_NARROW_R = 2;  // (S, R, C) -> (S, C, R) with R <= 16: unpack_hw
constexpr int NARROW = 16;

template <typename T>
int launch(const void* in, void* out, int S, int R, int C, int path, void* stream) {
  constexpr int V = 16 / sizeof(T);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (path == PATH_NARROW_C) {  // planar side C channels of R pixels on the output
    if (!(C >= 1 && C <= NARROW && R % V == 0 && aligned))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_narrow<T, true>(C, in, out, static_cast<long long>(S) * R / V, R, st);
  }
  if (path == PATH_NARROW_R) {
    if (!(R >= 1 && R <= NARROW && C % V == 0 && aligned))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_narrow<T, false>(R, in, out, static_cast<long long>(S) * C / V, C, st);
  }
  if (path != PATH_TILES) return static_cast<int>(cudaErrorInvalidValue);
  if (C <= 32) return launch_tiles<T, 256, 32>(in, out, S, R, C, stream);
  if (R <= 32) return launch_tiles<T, 32, 256>(in, out, S, R, C, stream);
  return launch_tiles<T, 32, 32>(in, out, S, R, C, stream);
}

}  // namespace

extern "C" {

// in: (S, R, C) contiguous, out: (S, C, R) contiguous; itemsize 2 or 4;
// path one of the PATH_ codes above, as layout.py:transpose_path chose it
// (a narrow path that does not fit the shape is refused). Returns the
// cudaError_t of the launch.
int transpose_last2(const void* in, void* out, int S, int R, int C,
                    int itemsize, int path, void* stream) {
  if (itemsize == 2) return launch<uint16_t>(in, out, S, R, C, path, stream);
  if (itemsize == 4) return launch<uint32_t>(in, out, S, R, C, path, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
