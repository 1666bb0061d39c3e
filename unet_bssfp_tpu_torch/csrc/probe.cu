// The probe kernels of scripts/torch_port_pallas_probe.py.
//
// K9a, lane_roll_f32: y[r, c] = x[r, (c - shift) mod C] for a (R, C) f32
// tile (torch.roll(x, shift, 1), bit for bit). It replaces
// scripts/pallas_probe.py:probe_roll (the pallas_call at :45), a check of
// pltpu.roll's direction. Bound by its launch: at the probe's (8, 128) it
// moves 8 KB. So the kernel is one gather per thread, straight from x (the
// tile sits in L2), no shared memory and no barrier, and the shift arrives
// normalised to [0, C) from the host, so each element costs one compare and
// one add instead of two modulos. The grid covers R * C (any size in int
// range). Its cost per call is the host's: ops/kernels/probe.py keeps the
// wrapper's Python to the cheap checks and one ctypes call.
//
// K9b, conv3x3_probe_wgmma: K1's wgmma kernel (conv3x3_wgmma.cuh) in its
// three MODEs, to split K1's time into its products and epilogue (fixed),
// its staging (full - fixed: TMA waits, transpose, barrier, refill) and its
// shifted descriptor addresses (full - centre). conv3x3_wgmma.cuh's MODE
// note states each mode's function. It replaces scripts/pallas_probe.py:probe_perf_ablation
// (the pallas_call at :144), which split the TPU kernel's B-operand build the
// same way. Only the SAME conv on the packed layout, x (B, D, Cin, H*W) ->
// y (B, D, Cout, H*W) bf16, and only the (N, RW) pairs the probe's shapes
// reach (ops/kernels/probe.py:PAIRS) are compiled here, so that
// conv3x3_wgmma.cu's own build does not grow. Measured on an H100 (700 W)
// at B 8 x 64^3, 24 -> 32 (scripts/torch_port_pallas_probe.py and
// chip_smoke.py): full 0.35 ms (K1 0.36, bit for bit), centre 0.33-0.35,
// fixed 0.29-0.30: the products and epilogue take 81-87 % of K1's time,
// the staging 13-19 %, the shifted addresses no more than the noise.

#include "conv3x3_wgmma.cuh"

namespace {

constexpr int ROLL_THREADS = 256;

__global__ void __launch_bounds__(ROLL_THREADS)
lane_roll_kernel(const float* __restrict__ x, float* __restrict__ y, int n, int C, int shift) {
  // n <= INT_MAX, so at most 2^23 blocks and i <= 2^31 - 1: no wrap
  const unsigned i = blockIdx.x * ROLL_THREADS + threadIdx.x;
  if (i >= static_cast<unsigned>(n)) return;
  const unsigned r = i / C;
  int c = static_cast<int>(i - r * C) - shift;  // shift in [0, C)
  if (c < 0) c += C;
  y[i] = x[r * C + c];
}

template <int N, int RW>
int launch_mode(int mode, const Launch& L, cudaStream_t s) {
  switch (mode) {
    case MODE_FULL: return launch<N, RW, false, MODE_FULL>(L, s);
    case MODE_CENTRE: return launch<N, RW, false, MODE_CENTRE>(L, s);
    case MODE_FIXED: return launch<N, RW, false, MODE_FIXED>(L, s);
  }
  return ERR_PLAN;
}

}  // namespace

extern "C" {

// x, y: (R, C) f32 contiguous; 0 <= shift < C; R * C in int range.
// Returns 0 or a cudaError_t.
int lane_roll_f32(const void* x, void* y, int R, int C, int shift, void* stream) {
  const long long total = static_cast<long long>(R) * C;
  if (R < 1 || C < 1 || total > 0x7fffffff || shift < 0 || shift >= C)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned blocks = static_cast<unsigned>((total + ROLL_THREADS - 1) / ROLL_THREADS);
  lane_roll_kernel<<<blocks, ROLL_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(y), static_cast<int>(total), C, shift);
  return static_cast<int>(cudaGetLastError());
}

// The SAME conv's operands and plan (conv_wgmma.py:wgmma_plan at Din = Dout
// = D, shift 0, no guard columns) as prepare() takes them; mode 0 full, 1
// centre, 2 fixed. A plan outside the compiled pairs returns ERR_PLAN.
int conv3x3_probe_wgmma(const void* x, const void* wimg, const void* bias, void* y, int B,
                        int d, int cin, int cout, int h, int wdim, int n, int cin_pad, int rows,
                        int stages, int seg_len, int segments, int mode, void* stream) {
  Launch L;
  const int rc = prepare(L, x, wimg, bias, y, B, d, d, 0, cin, cout, h, wdim, 0, 0, 0, n,
                         cin_pad, rows, stages, seg_len, segments, 1);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 32 && rows == 4) return launch_mode<32, 2>(mode, L, s);
  if (n == 64 && rows == 2) return launch_mode<64, 1>(mode, L, s);
  return ERR_PLAN;
}

const char* kernel_error_string(int code) { return wgmma_error_string(code); }

}  // extern "C"
