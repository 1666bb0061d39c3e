// Weight gradient of the 3x3x3 SAME convolution on the packed layout:
//
//   dW[kd, kh, kw, ci, co] = sum_{b,d,h,w} x[b, d+kd-1, ci, h+kh-1, w+kw-1]
//                                          * dy[b, d, co, h, w]
//
// x: (B, D, Cin, H*W), dy: (B, D, Cout, H*W), both f32 or both bf16; dW is
// f32 (3, 3, 3, Cin, Cout). Out-of-range x neighbours read as zero (SAME
// padding as bounds masks).
//
// The d geometry is a template parameter HALO of both kernels. The SAME conv
// (HALO false) has x and dy of D slices each, and skips a kd whose x slice
// d + kd - 1 lies in the pad. The conv on an input with a real one-slice d
// halo per side (_dw_impl(pad_d=False), the d-sharded path; HALO true) has x
// of D + 2 slices: the product is x[d + kd] * dy[d] and nothing is skipped.
// D is dy's in both, and the split plan and the summation chain are sized
// from dy's (b, D, tiles). (A launch parameter instead, as conv3x3_packed.cu
// has it, changed the SAME kernel's code: measured on an H100, bf16 8 x 64^3,
// 96 -> 32 went from 7.01 to 8.69 ms and 24 -> 32 from 2.55 to 2.26 ms.)
//
// The activation layout is a second template parameter FOLD (fold4.cuh):
// FOLD true takes x and dy phase-major w-folded, (B, D, 4*C, H*W/4), and is
// K7b, which replaces conv3d.py:_pfold_dw_impl (kernel body
// _dw_kernel_pfold, and its halo form with pad_d=False). The TPU kernel
// multiplies 6-block operand strips and sums the four phase blocks to taps
// afterwards; here only the staging loads change, the product loop and the
// split plan are K2's, so K7b's dW is K2's on the same volume bit for bit.
// Measured on an H100, bf16, B 8 x 64^3: 1.05-1.14x K2 at 24/32/96 -> 32.
//
// Replaces unet_bssfp_tpu/ops/pallas/conv3d.py:_dw_impl (kernel bodies
// _dw_kernel / _dw_kernel_kstack). The TPU kernel keeps ONE accumulator for
// the whole grid and carries it across the grid's sequential steps. Hopper
// blocks run in parallel and in no order, and the accumulator (27*Cin*Cout
// f32, 324 KB at Cin 96) does not fit one block's registers, so:
//   - blocks split the output by (kd, Cin chunk of 16, Cout chunk of 32)
//     (grid y, z) and the pixels by a split count (grid x): split s owns a
//     fixed, contiguous run of (b, d, 8x32 (h, w) tile) items;
//   - each block writes its partial sums with plain stores to its own slice
//     of an f32 workspace (splits, 27*Cin*Cout) the caller allocates;
//   - conv3x3_wgrad_reduce_kernel (split_sum.cuh) sums the splits of every
//     output in split order. No atomics: the result repeats bit for bit run
//     to run.
//
// Summation chains. Each item's products go into a fresh accumulator (256
// products in bf16, 128 in f32), which is then added into the block's
// running f32 sum. The mma.sync accumulator does not round to nearest: it
// truncates, so over one long chain of K-steps its error is a bias that
// grows with the chain (unfolded, on an H100, bf16 strayed up to 16x
// further from the plain version than f32 did at Cin 96). Folding per item keeps
// that chain at 16 K-steps; the item and split sums are IEEE f32 adds. One
// product passes through at most conv3x3_wgrad_chain() roundings in a row.
//
// What bounds it on an H100: at the generator's shapes (Cin 24..96, Cout 32,
// 8 x 64^3) the contraction does 2*27*Cin*Cout operations per pixel against
// (Cin + Cout) * itemsize bytes, above the bf16 tensor-core ridge, so
// operations bound it in principle. This first version is bound by its
// staging: every block re-stages its dy tile from L2/HBM for each (kd, Cin
// chunk), with 2-byte loads and no cp.async pipeline. (Issuing all of a stage's
// loads before its stores, tried once, took 168 registers, spilled and ran
// slower.)
//
// bf16: mma.sync m16n8k16 (bf16 in, f32 accumulate). One warp per (kh, kw)
// tap (9 warps); per tap the block computes a (16 ci) x (32 co) product
// whose reduction runs over the tile's 256 pixels in 16 K-steps. Both
// operands are contiguous along the reduction (pixels), the row.col
// operand layout. The A operand (x) is the halo tile read at a (kh, kw)
// shift; an odd kw shift would make its 32-bit pixel pairs misaligned, so
// the tile is staged twice, once shifted left by one column, and kw = 1
// reads the shifted copy. Channel rows are padded so that every fragment
// load of a warp hits 32 distinct banks.
//
// f32: the FMA pipes (the tensor cores have no exact f32 product). The
// tile is 4 x 32 pixels; each lane of a tap's warp owns 4 ci x 4 co
// accumulators and reads its 4 co of dy as one float4 per pixel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "split_sum.cuh"
#include "fold4.cuh"

namespace {

constexpr int TW = 32;        // pixel tile width (w)
constexpr int CI_T = 16;      // input channels per block
constexpr int CO_T = 32;      // output channels per block
constexpr int THREADS = 9 * 32;  // one warp per (kh, kw) tap
constexpr int XCOLS = TW + 2;
constexpr int TARGET_BLOCKS = 4 * 132;  // about four blocks per H100 SM

constexpr int TH_BF = 8;      // bf16 tile: 8 x 32 = 256 pixels
constexpr int TH_F32 = 4;     // f32 tile: 4 x 32 = 128 pixels

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

// The x slice that meets dy's slice bd = b*D + d at tap kd: without a halo x
// has D slices per batch and the slice is d + kd - 1; with one it has D + 2
// and the slice is d + kd.
template <bool HALO>
__device__ __forceinline__ long long x_slice(long long bd, int d, int kd, int D) {
  if (HALO) return (bd - d) / D * (D + 2) + d + kd;
  return bd + (kd - 1);
}

// ------------------------------------------------------- bf16, tensor cores
constexpr int TILE_BF = TH_BF * TW;
constexpr int XROWS_BF = TH_BF + 2;
constexpr int XSTRIDE = 392;  // halfs per staged channel: 340 used; 196 words = 4 mod 32
constexpr int DSTRIDE = 264;  // halfs per staged dy row: 256 used; 132 words = 4 mod 32

template <bool HALO, bool FOLD>
__global__ void __launch_bounds__(THREADS)
conv3x3_wgrad_bf16_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ dy,
                          float* __restrict__ part, int D, int Cin, int Cout, int H, int W,
                          long long items, long long per) {
  __shared__ __align__(16) uint16_t xs0[CI_T * XSTRIDE];  // [ci][row][col]
  __shared__ __align__(16) uint16_t xs1[CI_T * XSTRIDE];  // xs0 shifted left one column
  __shared__ __align__(16) uint16_t dys[CO_T * DSTRIDE];  // [co][pixel]

  const int kd = blockIdx.y % 3;
  const int ci0 = (blockIdx.y / 3) * CI_T;
  const int co0 = blockIdx.z * CO_T;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kh = warp / 3, kw = warp % 3;
  const int gid = lane / 4, tig = lane % 4;
  const long long HW = static_cast<long long>(H) * W;
  // Items are (b*D + d, tile) pairs, tile-minor; this block's split owns
  // items [blockIdx.x * per, min((blockIdx.x + 1) * per, items)).
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles = ((H + TH_BF - 1) / TH_BF) * tiles_w;

  float sum[4][4];  // [n8 tile: co 8*nt..][fragment]
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int k = 0; k < 4; ++k) sum[nt][k] = 0.f;

  // kw = 1 reads the shifted copy at even columns; kw = 0, 2 the plain one.
  const uint16_t* xa = (kw == 1 ? xs1 : xs0) + gid * XSTRIDE + (kw == 2 ? 2 : 0) + tig * 2;

  const long long it0 = static_cast<long long>(blockIdx.x) * per;
  const long long it1 = it0 + per < items ? it0 + per : items;
  for (long long it = it0; it < it1; ++it) {
    const long long bd = it / tiles;
    const int t = static_cast<int>(it % tiles);
    const int d = static_cast<int>(bd % D);
    if (!HALO && (d + kd - 1 < 0 || d + kd - 1 >= D)) continue;  // uniform over the block
    const int h0 = (t / tiles_w) * TH_BF, w0 = (t % tiles_w) * TW;
    const uint16_t* xsl = x + x_slice<HALO>(bd, d, kd, D) * Cin * HW;
    const uint16_t* dsl = dy + bd * Cout * HW;
    __syncthreads();
    for (int i = threadIdx.x; i < CI_T * XROWS_BF * XCOLS; i += THREADS) {
      const int col = i % XCOLS;
      const int row = (i / XCOLS) % XROWS_BF;
      const int c = i / (XCOLS * XROWS_BF);
      const int ci = ci0 + c, hh = h0 + row - 1, ww = w0 + col - 1;
      uint16_t v = 0;
      if (ci < Cin && hh >= 0 && hh < H && ww >= 0 && ww < W)
        v = xsl[pix<FOLD>(ci, hh, ww, Cin, HW, W)];
      xs0[c * XSTRIDE + row * XCOLS + col] = v;
      if (col > 0) xs1[c * XSTRIDE + row * XCOLS + col - 1] = v;
    }
    for (int i = threadIdx.x; i < CO_T * TILE_BF; i += THREADS) {
      const int p = i % TILE_BF;
      const int co = i / TILE_BF;
      const int cc = co0 + co, hh = h0 + p / TW, ww = w0 + p % TW;
      uint16_t v = 0;  // pixels past the plane's edge carry no gradient
      if (cc < Cout && hh < H && ww < W)
        v = dsl[pix<FOLD>(cc, hh, ww, Cout, HW, W)];
      dys[co * DSTRIDE + p] = v;
    }
    __syncthreads();
    float acc[4][4] = {};  // this item's 256 products; folded into sum below
#pragma unroll 4
    for (int ks = 0; ks < TILE_BF / 16; ++ks) {
      // K-step ks covers pixels ks*16 .. ks*16+15: tile row ks/2, columns
      // (ks%2)*16 + k. A[m][k] = x(ci m, halo row + kh, column + kw).
      const uint16_t* p0 = xa + ((ks >> 1) + kh) * XCOLS + (ks & 1) * 16;
      const uint16_t* p1 = p0 + 8 * XSTRIDE;
      const uint32_t a[4] = {lds32(p0), lds32(p1), lds32(p0 + 8), lds32(p1 + 8)};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        // B[k][n] = dy(co n, pixel k), stored n-major with k contiguous.
        const uint16_t* q = dys + (nt * 8 + gid) * DSTRIDE + ks * 16 + tig * 2;
        mma_bf16_16816(acc[nt], a, lds32(q), lds32(q + 8));
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) sum[nt][k] += acc[nt][k];
  }

  float* out = part + static_cast<long long>(blockIdx.x) * 27 * Cin * Cout;
  const int tap = kd * 9 + kh * 3 + kw;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int ci = ci0 + gid + (k >= 2 ? 8 : 0);
      const int co = co0 + nt * 8 + tig * 2 + (k & 1);
      if (ci < Cin && co < Cout)
        out[(static_cast<long long>(tap) * Cin + ci) * Cout + co] = sum[nt][k];
    }
  }
}

// ---------------------------------------------------------------- f32, FMA
constexpr int TILE_F = TH_F32 * TW;
constexpr int XROWS_F = TH_F32 + 2;
constexpr int XSTRIDE_F = 206;  // floats per staged channel: 204 used; 4*206 = 24 mod 32
constexpr int DSTRIDE_F = 36;   // floats per staged pixel: 32 co used, float4-aligned

template <bool HALO, bool FOLD>
__global__ void __launch_bounds__(THREADS)
conv3x3_wgrad_f32_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                         float* __restrict__ part, int D, int Cin, int Cout, int H, int W,
                         long long items, long long per) {
  __shared__ float xs[CI_T * XSTRIDE_F];                 // [ci][row][col]
  __shared__ __align__(16) float dys[TILE_F * DSTRIDE_F];  // [pixel][co]

  const int kd = blockIdx.y % 3;
  const int ci0 = (blockIdx.y / 3) * CI_T;
  const int co0 = blockIdx.z * CO_T;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kh = warp / 3, kw = warp % 3;
  const int cg = lane / 8, og = lane % 8;  // ci 4*cg.., co 4*og..
  const long long HW = static_cast<long long>(H) * W;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles = ((H + TH_F32 - 1) / TH_F32) * tiles_w;

  float sum[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sum[i][j] = 0.f;

  const long long it0 = static_cast<long long>(blockIdx.x) * per;
  const long long it1 = it0 + per < items ? it0 + per : items;
  for (long long it = it0; it < it1; ++it) {
    const long long bd = it / tiles;
    const int t = static_cast<int>(it % tiles);
    const int d = static_cast<int>(bd % D);
    if (!HALO && (d + kd - 1 < 0 || d + kd - 1 >= D)) continue;  // uniform over the block
    const int h0 = (t / tiles_w) * TH_F32, w0 = (t % tiles_w) * TW;
    const float* xsl = x + x_slice<HALO>(bd, d, kd, D) * Cin * HW;
    const float* dsl = dy + bd * Cout * HW;
    __syncthreads();
    for (int i = threadIdx.x; i < CI_T * XROWS_F * XCOLS; i += THREADS) {
      const int col = i % XCOLS;
      const int row = (i / XCOLS) % XROWS_F;
      const int c = i / (XCOLS * XROWS_F);
      const int ci = ci0 + c, hh = h0 + row - 1, ww = w0 + col - 1;
      float v = 0.f;
      if (ci < Cin && hh >= 0 && hh < H && ww >= 0 && ww < W)
        v = xsl[pix<FOLD>(ci, hh, ww, Cin, HW, W)];
      xs[c * XSTRIDE_F + row * XCOLS + col] = v;
    }
    for (int i = threadIdx.x; i < CO_T * TILE_F; i += THREADS) {
      const int p = i % TILE_F;
      const int co = i / TILE_F;
      const int cc = co0 + co, hh = h0 + p / TW, ww = w0 + p % TW;
      float v = 0.f;
      if (cc < Cout && hh < H && ww < W)
        v = dsl[pix<FOLD>(cc, hh, ww, Cout, HW, W)];
      dys[p * DSTRIDE_F + co] = v;
    }
    __syncthreads();
    const float* xrow = xs + cg * 4 * XSTRIDE_F + kh * XCOLS + kw;
    float acc[4][4] = {};  // this item's 128 products; folded into sum below
#pragma unroll 4
    for (int p = 0; p < TILE_F; ++p) {
      const float4 g = *reinterpret_cast<const float4*>(&dys[p * DSTRIDE_F + og * 4]);
      const float gv[4] = {g.x, g.y, g.z, g.w};
      const int off = (p / TW) * XCOLS + p % TW;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float xv = xrow[i * XSTRIDE_F + off];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv, gv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sum[i][j] += acc[i][j];
  }

  float* out = part + static_cast<long long>(blockIdx.x) * 27 * Cin * Cout;
  const int tap = kd * 9 + kh * 3 + kw;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ci = ci0 + cg * 4 + i, co = co0 + og * 4 + j;
      if (ci < Cin && co < Cout)
        out[(static_cast<long long>(tap) * Cin + ci) * Cout + co] = sum[i][j];
    }
  }
}

// --------------------------------------- the split plan (sum: split_sum.cuh)
struct Plan {
  long long items, per;
  int splits;
  dim3 grid;
};

Plan plan_for(int B, int D, int Cin, int Cout, int H, int W, int th) {
  Plan p;
  const long long tiles = static_cast<long long>((H + th - 1) / th) * ((W + TW - 1) / TW);
  p.items = static_cast<long long>(B) * D * tiles;
  const int ci_chunks = (Cin + CI_T - 1) / CI_T, co_chunks = (Cout + CO_T - 1) / CO_T;
  const long long per_split = 3LL * ci_chunks * co_chunks;
  long long splits = (TARGET_BLOCKS + per_split - 1) / per_split;
  if (splits > p.items) splits = p.items;
  if (splits < 1) splits = 1;
  p.per = (p.items + splits - 1) / splits;
  p.splits = static_cast<int>((p.items + p.per - 1) / p.per);
  p.grid = dim3(p.splits, 3 * ci_chunks, co_chunks);
  return p;
}

template <typename Kernel, typename T>
int launch(Kernel kernel, int th, const void* x, const void* dy, void* part, void* out,
           int B, int D, int Cin, int Cout, int H, int W, void* stream) {
  const Plan p = plan_for(B, D, Cin, Cout, H, W, th);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<p.grid, THREADS, 0, s>>>(static_cast<const T*>(x), static_cast<const T*>(dy),
                                    static_cast<float*>(part), D, Cin, Cout, H, W,
                                    p.items, p.per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = 27LL * Cin * Cout;
  conv3x3_wgrad_reduce_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(out), n, p.splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The number of pixel splits a launch at this shape uses (D is dy's): the
// workspace ``part`` must hold splits * 27 * Cin * Cout floats.
int conv3x3_wgrad_splits(int B, int D, int Cin, int Cout, int H, int W, int bf16) {
  return plan_for(B, D, Cin, Cout, H, W, bf16 ? TH_BF : TH_F32).splits;
}

// The longest run of f32 roundings one product passes through at this
// shape: the item's accumulator, the split's sum of items, the sum of splits.
int conv3x3_wgrad_chain(int B, int D, int Cin, int Cout, int H, int W, int bf16) {
  const int th = bf16 ? TH_BF : TH_F32;
  const Plan p = plan_for(B, D, Cin, Cout, H, W, th);
  return th * TW + static_cast<int>(p.per) + p.splits;
}

// x: (B, D + 2*halo, Cin, H*W), dy: (B, D, Cout, H*W) contiguous, same
// dtype (fold: (B, D + 2*halo, 4*Cin, H*W/4) and (B, D, 4*Cout, H*W/4), W
// the unfolded width); halo 0 or 1 as in the header; part: f32 workspace;
// out: f32 (3, 3, 3, Cin, Cout). Returns the launches' cudaError_t.
int conv3x3_wgrad_bf16(const void* x, const void* dy, void* part, void* out, int B, int D,
                       int halo, int fold, int Cin, int Cout, int H, int W, void* stream) {
  auto kernel = halo ? (fold ? conv3x3_wgrad_bf16_kernel<true, true>
                             : conv3x3_wgrad_bf16_kernel<true, false>)
                     : (fold ? conv3x3_wgrad_bf16_kernel<false, true>
                             : conv3x3_wgrad_bf16_kernel<false, false>);
  return launch<decltype(kernel), uint16_t>(kernel, TH_BF, x, dy, part, out, B, D, Cin, Cout,
                                            H, W, stream);
}

int conv3x3_wgrad_f32(const void* x, const void* dy, void* part, void* out, int B, int D,
                      int halo, int fold, int Cin, int Cout, int H, int W, void* stream) {
  auto kernel = halo ? (fold ? conv3x3_wgrad_f32_kernel<true, true>
                             : conv3x3_wgrad_f32_kernel<true, false>)
                     : (fold ? conv3x3_wgrad_f32_kernel<false, true>
                             : conv3x3_wgrad_f32_kernel<false, false>);
  return launch<decltype(kernel), float>(kernel, TH_F32, x, dy, part, out, B, D, Cin, Cout,
                                         H, W, stream);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
