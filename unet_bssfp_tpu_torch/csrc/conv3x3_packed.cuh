// The mma.sync bf16 kernel of the 3x3x3 conv (K1's loop until the wgmma
// kernel, conv3x3_wgmma.cu, took K1, K1's dgrad, K5 and K5's dgrad), shared
// by conv3x3_packed.cu (K7a, and the check-only conv3x3_packed_mma on the
// packed layout; its header describes the function, the d geometry and the
// design) and probe.cu (K9b). Two template parameters select what the loop
// is wrapped in:
//
//   FOLD  the activation layout, packed or phase-major w-folded (fold4.cuh);
//         it changes the staging loads and the output stores only.
//   MODE  MODE_FULL: the conv. The probe's ablations of the same loop
//         (csrc/probe.cu says what each computes): MODE_CENTRE stages as
//         FULL but every (kh, kw) tap reads the unshifted tile; MODE_FIXED
//         stages one tile before the loop and then runs the loop on it with
//         no global load and no barrier inside.

#pragma once

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

constexpr int MODE_FULL = 0;
constexpr int MODE_CENTRE = 1;
constexpr int MODE_FIXED = 2;

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

template <bool FOLD, int MODE>
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

  // MODE_CENTRE: a zero the compiler cannot see, so each tap's fragment
  // loads stay their own (as in FULL) instead of being merged into one.
  int opaque_zero = 0;
  if constexpr (MODE == MODE_CENTRE) asm volatile("mov.b32 %0, 0;" : "=r"(opaque_zero));
  if constexpr (MODE == MODE_FIXED) {
    stage_bf16<FOLD>(xs, ws, x + (bin + d + shift) * Cin * HW, w, 1, 0, h0, w0, co0, Cin,
                     Cout, H, W, HW);
    __syncthreads();
  }

  for (int kd = 0; kd < 3; ++kd) {
    const int di = d + kd - 1 + shift;
    if (di < 0 || di >= Din) continue;  // uniform over the block
    const uint16_t* xsl = x + (bin + di) * Cin * HW;
    for (int c0 = 0; c0 < Cin; c0 += CK) {
      if constexpr (MODE != MODE_FIXED) {
        __syncthreads();
        stage_bf16<FOLD>(xs, ws, xsl, w, kd, c0, h0, w0, co0, Cin, Cout, H, W, HW);
        __syncthreads();
      }
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int kh = MODE == MODE_CENTRE ? 1 + (opaque_zero & tap) : tap / 3;
        const int kw = MODE == MODE_CENTRE ? 1 + (opaque_zero & tap) : tap % 3;
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

}  // namespace
