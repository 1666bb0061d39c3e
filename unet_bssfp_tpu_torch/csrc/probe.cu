// The probe kernels of scripts/torch_port_pallas_probe.py.
//
// K9a, lane_roll_f32: y[r, c] = x[r, (c - shift) mod C] for a (R, C) f32
// tile, through shared memory (torch.roll(x, shift, 1), bit for bit). It
// replaces scripts/pallas_probe.py:probe_roll (the pallas_call at :45), a
// check of pltpu.roll's direction. One block of 256 threads; bound by its
// launch (4 KB at (8, 128)).
//
// K9b, conv3x3_probe_bf16: K1's bf16 loop (conv3x3_packed.cuh, the same
// template) under three modes, to split K1's time into the staging of its
// tiles and its mma.sync product loop. It replaces
// scripts/pallas_probe.py:probe_perf_ablation (the pallas_call at :144),
// which split the TPU kernel's B-operand build the same way. Geometry: the
// SAME conv, x (B, D, Cin, H*W) packed -> y (B, D, Cout, H*W) bf16, w (3,
// 3, 3, Cin, Cout) bf16, bias f32. With n(d) = the number of kd whose slice
// d + kd - 1 lies in [0, D) and m(d) = n(d) * ceil(Cin / 16), the loop
// trip count of K1 at slice d:
//
//   mode 0, full:   K1 itself,
//       y[b,d,co,h,w] = bias[co] + sum_{kd,kh,kw,ci} w[kd,kh,kw,ci,co]
//                                   * x[b, d+kd-1, ci, h+kh-1, w+kw-1];
//   mode 1, centre: full staging, every (kh, kw) tap reads the unshifted
//       tile: a (3, 1, 1) conv with the weights summed over (kh, kw),
//       y = bias + sum_{kd,ci} (sum_{kh,kw} w[kd,kh,kw,ci,co]) * x[b,d+kd-1,ci,h,w];
//   mode 2, fixed:  one stage (input channels 0..15 of slice d, the weights
//       of kd = 1) before the loop, then K1's whole loop on that tile, with
//       no global load and no barrier inside:
//       y = bias + m(d) * sum_{kh,kw,ci<min(16,Cin)} w[1,kh,kw,ci,co]
//                                                   * x[b, d, ci, h+kh-1, w+kw-1].
//
// full - fixed is the cost of staging (global loads, shared-memory stores,
// barriers); fixed is the loop alone; full - centre is what the (kh, kw)
// shifts cost, which on this card are address offsets.
// Measured on an H100 (700 W) at B 8 x 64^3, 24 -> 32: full 1.29 ms,
// centre 1.26, fixed 0.44: staging is about two thirds of K1's time.

#include "conv3x3_packed.cuh"

namespace {

constexpr int ROLL_THREADS = 256;

__global__ void __launch_bounds__(ROLL_THREADS)
lane_roll_kernel(const float* __restrict__ x, float* __restrict__ y, int R, int C,
                 int shift) {
  extern __shared__ float tile[];  // [R][C]
  const int n = R * C;
  for (int i = threadIdx.x; i < n; i += ROLL_THREADS) tile[i] = x[i];
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += ROLL_THREADS) {
    const int r = i / C, c = i % C;
    y[i] = tile[r * C + ((c - shift) % C + C) % C];
  }
}

template <int MODE>
int launch_probe(const void* x, const void* w, const void* bias, void* y, int B, int D,
                 int Cin, int Cout, int H, int W, void* stream) {
  conv3x3_bf16_kernel<false, MODE><<<grid_for(B, D, Cout, H, W), BF_THREADS, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), D, D, 0, Cin, Cout, H,
      W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, y: (R, C) f32 contiguous, R * C <= 12288 (48 KB of shared memory).
int lane_roll_f32(const void* x, void* y, int R, int C, int shift, void* stream) {
  if (R * C > 12288 || R * C < 1) return static_cast<int>(cudaErrorInvalidValue);
  lane_roll_kernel<<<1, ROLL_THREADS, R * C * sizeof(float),
                     static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(x),
                                                          static_cast<float*>(y), R, C, shift);
  return static_cast<int>(cudaGetLastError());
}

// mode 0 full, 1 centre, 2 fixed, as in the header.
int conv3x3_probe_bf16(const void* x, const void* w, const void* bias, void* y, int B, int D,
                       int Cin, int Cout, int H, int W, int mode, void* stream) {
  switch (mode) {
    case MODE_FULL: return launch_probe<MODE_FULL>(x, w, bias, y, B, D, Cin, Cout, H, W, stream);
    case MODE_CENTRE:
      return launch_probe<MODE_CENTRE>(x, w, bias, y, B, D, Cin, Cout, H, W, stream);
    case MODE_FIXED: return launch_probe<MODE_FIXED>(x, w, bias, y, B, D, Cin, Cout, H, W, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
