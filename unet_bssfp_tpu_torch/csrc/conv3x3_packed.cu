// K1's f32 kernel (the gradient-check path) and the mma.sync bf16 kernel
// that the wgmma kernel (conv3x3_wgmma.cu) replaced on K1's bf16 routes; the
// latter still runs K7a's routed shapes and the check-only conv3x3_packed_mma.
//
// 3x3x3 SAME convolution + bias on the packed layout (B, D, Cin, H*W) ->
// (B, D, Cout, H*W), or on the phase-major w-folded layout (B, D, 4*Cin,
// H*W/4) -> (B, D, 4*Cout, H*W/4), f32 accumulation, f32 or bf16 activations.
//
// Replaces unet_bssfp_tpu/ops/pallas/conv3d.py:_conv_fwd_impl (kernel bodies
// _conv_kernel / _conv_kernel_kstack, reached through conv3x3_packed). The
// TPU kernel computes each output d-slice as one GEMM over (kd, ci) and then
// combines the nine (kh, kw) taps with masked lane rolls of the f32 result;
// here the same function is one direct (implicit-GEMM) convolution:
//
//   y[b, d, co, h, w] = bias[co] + sum_{kd,kh,kw,ci}
//       w[kd, kh, kw, ci, co] * x[b, d+kd-1, ci, h+kh-1, w+kw-1]
//
// with out-of-range neighbours read as zero (SAME padding is bounds masks,
// no padded copy in memory, no channel padding in memory).
//
// The d geometry is a launch parameter (Din input slices, Dout output
// slices, shift): output slice d reads input slices d + kd - 1 + shift, and
// one that falls outside [0, Din) reads as zero. That makes one kernel of
//   - the SAME conv:            Din = Dout = D,       shift =  0;
//   - the conv on an input that carries a real one-slice d halo per side
//     (conv3d.py:conv3x3_packed_halo, pad_d=False; the d-sharded path):
//                               Din = D + 2, Dout = D, shift = +1, so every
//     slice is in range and none is skipped;
//   - that conv's input gradient, D + 2 slices from D slices of dy with the
//     flipped, transposed weight:  Din = D, Dout = D + 2, shift = -1. The TPU
//     version pads dy by two slices per side in memory (a full copy); here
//     the out-of-range slices are bounds, as the SAME pad is.
//
// The layout is a template parameter FOLD (fold4.cuh). FOLD true is K7a,
// which replaces conv3d.py:_pfold_fwd_impl (kernel body _conv_kernel_pfold,
// reached through conv3x3_pfold, its dx, conv3x3_pfold_halo and its dx: the
// same four d geometries). The TPU kernel puts the four w-phases into the
// GEMM's M (4 * Cout = 128 MXU rows) with 50 %-dense weight blocks, a device
// of the MXU; here the folded tensor is read and written in place through
// the index function, and the product loop is K1's, so K7a's result is K1's
// on the same volume bit for bit. It is a template, not a launch parameter,
// so K1's own code stays as it was (a launch parameter changed K2's code and
// time: see conv3x3_wgrad.cu's header). Measured on an H100, bf16, B 8: K7a
// costs 1.07-1.21x K1 at the same shapes, since one tile row's staging loads
// fall into four phase runs of 8-9 elements instead of one run of 34.
//
// What bounds it on an H100: at the generator's stage shapes (Cin 24..96,
// Cout 32) the conv does 2*27*Cin*Cout FLOPs per output voxel against
// (Cin + Cout) * itemsize bytes, i.e. 370-650 FLOP/B in bf16: above the
// tensor-core ridge (~295 FLOP/B), so it is bound by operations.
//
// Both kernels walk the same loop: one block owns an 8 x 32 (h, w) tile of
// one (b, d) output slice and 32 output channels; it walks kd (a slice whose
// input d lies outside [0, Din) is skipped) and Cin in chunks of 16, staging
// the input tile with its 1-voxel (h, w) halo and the chunk's 9 x 16 x 32
// weights in shared memory, so the 166 KB bf16 weight of the Cin-96 conv
// never has to sit in shared memory whole.
//
// bf16: tensor cores through mma.sync m16n8k16 (bf16
// in, f32 accumulate). Each of the 8 warps owns one h row: 32 pixels (two
// m16 tiles) x 32 channels (four n8 tiles). Shared memory holds pixels x
// channels with the channel run padded from 16 to 24 elements (48 B), which
// makes every 32-bit fragment load of a warp hit 32 distinct banks. The
// nine (kh, kw) taps are nine K=16 steps reading the same staged tile at
// shifted pixel offsets. wgmma/TMA and a multi-stage cp.async ring are
// later work: here each stage is loaded, synchronised and consumed.
//
// f32: the FP32 FMA pipes (the tensor cores have no exact f32 product).
// Each thread owns one w column x 8 h rows x 8 output channels (64 f32
// accumulators); per (ci, kw) it reads 10 input values and reuses them for
// the three kh taps. Weights arrive rounded to the activation dtype by the
// caller (the TPU kernel casts w to x's dtype).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fold4.cuh"

namespace {

constexpr int TH = 8;        // output h rows per block
constexpr int TW = 32;       // output w columns per block
constexpr int CO_T = 32;     // output channels per block
constexpr int CK = 16;       // input channels per shared-memory stage

constexpr int BF_THREADS = 32 * TH;  // one warp per output h row: 256
constexpr int CPAD = 24;             // smem channel stride (bf16 elements)
constexpr int XCOLS = TW + 2;
constexpr int XROWS = TH + 2;

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One stage: input channels [c0, c0 + CK) of the x slice xsl over the
// tile's rows and columns with their 1-voxel halo, and the chunk's 9 x CK x
// CO_T weights of tap kd. Out-of-range voxels and channels read as zero.
template <bool FOLD>
__device__ __forceinline__ void stage_bf16(uint16_t* xs, uint16_t* ws,
                                           const uint16_t* __restrict__ xsl,
                                           const uint16_t* __restrict__ w, int kd, int c0,
                                           int h0, int w0, int co0, int Cin, int Cout, int H,
                                           int W, long long HW) {
  for (int i = threadIdx.x; i < CK * XROWS * XCOLS; i += BF_THREADS) {
    const int col = i % XCOLS;
    const int row = (i / XCOLS) % XROWS;
    const int c = i / (XCOLS * XROWS);
    const int ci = c0 + c, hh = h0 + row - 1, ww = w0 + col - 1;
    uint16_t v = 0;
    if (ci < Cin && hh >= 0 && hh < H && ww >= 0 && ww < W)
      v = xsl[pix<FOLD>(ci, hh, ww, Cin, HW, W)];
    xs[(row * XCOLS + col) * CPAD + c] = v;
  }
  for (int i = threadIdx.x; i < 9 * CK * CO_T; i += BF_THREADS) {
    const int co = i % CO_T;
    const int c = (i / CO_T) % CK;
    const int tap = i / (CO_T * CK);
    const int ci = c0 + c, cc = co0 + co;
    uint16_t v = 0;
    if (ci < Cin && cc < Cout)
      v = w[((static_cast<long long>(kd) * 9 + tap) * Cin + ci) * Cout + cc];
    ws[(tap * CO_T + co) * CPAD + c] = v;
  }
}

template <bool FOLD>
__global__ void __launch_bounds__(BF_THREADS)
conv3x3_bf16_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ w,
                    const float* __restrict__ bias, __nv_bfloat16* __restrict__ y, int Din,
                    int Dout, int shift, int Cin, int Cout, int H, int W) {
  // xs: [row][col][ci], ws: [tap][co][ci]; ci runs padded to CPAD.
  __shared__ __align__(16) uint16_t xs[XROWS * XCOLS * CPAD];
  __shared__ __align__(16) uint16_t ws[9 * CO_T * CPAD];

  const int tiles_w = (W + TW - 1) / TW;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const long long bd = blockIdx.y;  // b * Dout + d
  const int d = static_cast<int>(bd % Dout);
  const long long bin = (bd / Dout) * Din;  // the batch's first input slice
  const int co0 = blockIdx.z * CO_T;
  const int warp = threadIdx.x / 32;  // output h row within the tile
  const int lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const long long HW = static_cast<long long>(H) * W;

  float acc[2][4][4];  // [m16 tile: w 0-15 / 16-31][n8 tile][fragment]
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[mt][nt][k] = 0.f;

  for (int kd = 0; kd < 3; ++kd) {
    const int di = d + kd - 1 + shift;
    if (di < 0 || di >= Din) continue;  // uniform over the block
    const uint16_t* xsl = x + (bin + di) * Cin * HW;
    for (int c0 = 0; c0 < Cin; c0 += CK) {
      __syncthreads();
      stage_bf16<FOLD>(xs, ws, xsl, w, kd, c0, h0, w0, co0, Cin, Cout, H, W, HW);
      __syncthreads();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int kh = tap / 3, kw = tap % 3;
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          // A[m][k]: pixel m = (row warp+kh, col mt*16 + m + kw), k = ci.
          const uint16_t* p0 =
              &xs[((warp + kh) * XCOLS + mt * 16 + gid + kw) * CPAD + tig * 2];
          const uint16_t* p1 = p0 + 8 * CPAD;
          a[mt][0] = lds32(p0);
          a[mt][1] = lds32(p1);
          a[mt][2] = lds32(p0 + 8);
          a[mt][3] = lds32(p1 + 8);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          // B[k][n]: k = ci, n = co.
          const uint16_t* q = &ws[(tap * CO_T + nt * 8 + gid) * CPAD + tig * 2];
          const uint32_t b0 = lds32(q), b1 = lds32(q + 8);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_bf16_16816(acc[mt][nt], a[mt], b0, b1);
        }
      }
    }
  }

  const int hh = h0 + warp;
  if (hh >= H) return;
  __nv_bfloat16* ysl = y + bd * Cout * HW;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ww = w0 + mt * 16 + gid + half * 8;
      if (ww >= W) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int co = co0 + nt * 8 + tig * 2 + j;
          if (co < Cout)
            ysl[pix<FOLD>(co, hh, ww, Cout, HW, W)] =
                __float2bfloat16(acc[mt][nt][half * 2 + j] + bias[co]);
        }
      }
    }
  }
}

inline dim3 grid_for(int B, int Dout, int Cout, int H, int W) {
  const int tiles = ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  return dim3(tiles, B * Dout, (Cout + CO_T - 1) / CO_T);
}

// ---------------------------------------------------------------- f32, FMA
constexpr int CO_PER = 8;    // output channels per thread
constexpr int F32_THREADS = TW * (CO_T / CO_PER);  // 128

template <bool FOLD>
__global__ void __launch_bounds__(F32_THREADS)
conv3x3_packed_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                          const float* __restrict__ bias, float* __restrict__ y,
                          int Din, int Dout, int shift, int Cin, int Cout, int H,
                          int W) {
  __shared__ float xs[CK][TH + 2][TW + 2];
  __shared__ __align__(16) float ws[9][CK][CO_T];

  const int tiles_w = (W + TW - 1) / TW;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const long long bd = blockIdx.y;  // b * Dout + d
  const int d = static_cast<int>(bd % Dout);
  const long long bin = (bd / Dout) * Din;  // the batch's first input slice
  const int co0 = blockIdx.z * CO_T;
  const int tx = threadIdx.x % TW;
  const int cg = threadIdx.x / TW;  // == warp index
  const long long HW = static_cast<long long>(H) * W;

  float acc[TH][CO_PER];
#pragma unroll
  for (int j = 0; j < CO_PER; ++j) {
    const int co = co0 + cg * CO_PER + j;
    const float bj = co < Cout ? bias[co] : 0.f;
#pragma unroll
    for (int r = 0; r < TH; ++r) acc[r][j] = bj;
  }

  for (int kd = 0; kd < 3; ++kd) {
    const int di = d + kd - 1 + shift;
    if (di < 0 || di >= Din) continue;  // uniform over the block
    const float* xsl = x + (bin + di) * Cin * HW;
    for (int c0 = 0; c0 < Cin; c0 += CK) {
      __syncthreads();
      for (int i = threadIdx.x; i < CK * (TH + 2) * (TW + 2); i += F32_THREADS) {
        const int col = i % (TW + 2);
        const int row = (i / (TW + 2)) % (TH + 2);
        const int c = i / ((TW + 2) * (TH + 2));
        const int ci = c0 + c, hh = h0 + row - 1, ww = w0 + col - 1;
        float v = 0.f;
        if (ci < Cin && hh >= 0 && hh < H && ww >= 0 && ww < W)
          v = xsl[pix<FOLD>(ci, hh, ww, Cin, HW, W)];
        xs[c][row][col] = v;
      }
      for (int i = threadIdx.x; i < 9 * CK * CO_T; i += F32_THREADS) {
        const int co = i % CO_T;
        const int c = (i / CO_T) % CK;
        const int tap = i / (CO_T * CK);  // kh * 3 + kw
        const int ci = c0 + c, cc = co0 + co;
        float v = 0.f;
        if (ci < Cin && cc < Cout)
          v = w[((static_cast<long long>(kd) * 9 + tap) * Cin + ci) * Cout + cc];
        ws[tap][c][co] = v;
      }
      __syncthreads();
#pragma unroll 2
      for (int c = 0; c < CK; ++c) {
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          float xv[TH + 2];
#pragma unroll
          for (int r = 0; r < TH + 2; ++r) xv[r] = xs[c][r][tx + kw];
#pragma unroll
          for (int kh = 0; kh < 3; ++kh) {
            const float4 wa =
                *reinterpret_cast<const float4*>(&ws[kh * 3 + kw][c][cg * CO_PER]);
            const float4 wb =
                *reinterpret_cast<const float4*>(&ws[kh * 3 + kw][c][cg * CO_PER + 4]);
            const float wv[CO_PER] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
            for (int r = 0; r < TH; ++r) {
#pragma unroll
              for (int j = 0; j < CO_PER; ++j)
                acc[r][j] = fmaf(xv[r + kh], wv[j], acc[r][j]);
            }
          }
        }
      }
    }
  }

  const int ww = w0 + tx;
  if (ww >= W) return;
  float* ysl = y + bd * Cout * HW;
#pragma unroll
  for (int r = 0; r < TH; ++r) {
    const int hh = h0 + r;
    if (hh >= H) break;
#pragma unroll
    for (int j = 0; j < CO_PER; ++j) {
      const int co = co0 + cg * CO_PER + j;
      if (co < Cout) ysl[pix<FOLD>(co, hh, ww, Cout, HW, W)] = acc[r][j];
    }
  }
}

template <bool FOLD>
int launch_f32(const void* x, const void* w, const void* bias, void* y, int B, int Din,
               int Dout, int shift, int Cin, int Cout, int H, int W, void* stream) {
  conv3x3_packed_f32_kernel<FOLD><<<grid_for(B, Dout, Cout, H, W), F32_THREADS, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(y), Din, Dout, shift, Cin, Cout,
      H, W);
  return static_cast<int>(cudaGetLastError());
}

template <bool FOLD>
int launch_bf16(const void* x, const void* w, const void* bias, void* y, int B, int Din,
                int Dout, int shift, int Cin, int Cout, int H, int W, void* stream) {
  conv3x3_bf16_kernel<FOLD><<<grid_for(B, Dout, Cout, H, W), BF_THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), Din, Dout, shift, Cin,
      Cout, H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: (B, Din, Cin, H*W), y: (B, Dout, Cout, H*W) contiguous (fold: x (B,
// Din, 4*Cin, H*W/4), y (B, Dout, 4*Cout, H*W/4), W a multiple of 4 and the
// unfolded width); w: (3, 3, 3, Cin, Cout) contiguous in the activation
// dtype; bias: (Cout,) f32; shift as in the header. Returns the launch's
// cudaError_t.
int conv3x3_packed_f32(const void* x, const void* w, const void* bias, void* y, int B,
                       int Din, int Dout, int shift, int fold, int Cin, int Cout, int H, int W,
                       void* stream) {
  auto launch = fold ? launch_f32<true> : launch_f32<false>;
  return launch(x, w, bias, y, B, Din, Dout, shift, Cin, Cout, H, W, stream);
}

int conv3x3_packed_bf16(const void* x, const void* w, const void* bias, void* y, int B,
                        int Din, int Dout, int shift, int fold, int Cin, int Cout, int H,
                        int W, void* stream) {
  auto launch = fold ? launch_bf16<true> : launch_bf16<false>;
  return launch(x, w, bias, y, B, Din, Dout, shift, Cin, Cout, H, W, stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
