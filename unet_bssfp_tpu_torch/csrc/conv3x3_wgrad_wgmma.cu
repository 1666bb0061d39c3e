// The bf16 weight gradient of the 3x3x3 conv on the packed layout for
// Hopper: TMA loads into a shared-memory ring, dy's w-shifted copies built
// in shared memory, three warpgroups on wgmma.mma_async (bf16 in, f32
// accumulate).
//
//   dW[kd, kh, kw, ci, co] = sum_{b,d,h,w} x[b, d + kd - 1 + halo, ci, h + kh - 1, w + kw - 1]
//                                          * dy[b, d, co, h, w]
//
// x: (B, D + 2*halo, Cin, H*W), dy: (B, D, Cout, H*W), bf16; dW f32
// (3, 3, 3, Cin, Cout). halo 0 is the SAME conv (an x slice outside [0, D)
// reads as zero), halo 1 the conv on an input that carries one real d slice
// per side. Out-of-range h and w neighbours read as zero.
//
// Replaces unet_bssfp_tpu/ops/pallas/conv3d.py:_dw_impl (kernel bodies
// _dw_kernel / _dw_kernel_kstack, with pad_d True and False) on the bf16
// routes of the port: K2 (conv3x3_wgrad) and K5's weight gradient
// (conv3x3_wgrad_halo), ops/kernels/conv3d.py. The launch plan (row chunks,
// pixel splits, ring depth, shared memory) is made in Python
// (ops/kernels/wgrad_wgmma.py:wgrad_plan) and checked here; shapes it does
// not take run the mma.sync loop of conv3x3_wgrad.cu.
//
// Bound on an H100: 2*27*Cin*Cout operations per voxel against
// (Cin + Cout) * 2 bytes: above the bf16 ridge at the generator's stages, so
// operations bound it: 0.088 / 0.117 / 0.352 ms at 24 / 32 / 96 -> 32,
// B 8 x 64^3 (0.176 ms for 96 -> 32 at a D_local-32 shard).
//
// Design: the GEMM view of _dw_kernel. For one dy slice d and one tile of
// ROWS = 2 h rows x 64 w columns (an "item"):
// - A (M) is the x rows (kd, ci): x slices d-1, d, d+1 (halo: d, d+1, d+2),
//   K-major (pixels contiguous). Cin is cut into `chunks` of cpk <= 21
//   channels (as even as can be); a block owns one chunk, whose 3 * cpk
//   rows (kd, j), ci = chunk * cpk + j, fill one wgmma M of 64. Per h row
//   one TMA box over x viewed as (W, Cin, D, H, B), 64 pixels x cpk
//   channels x 3 slices, lands as exactly those rows, 128 B each, 128-byte
//   swizzled: the canonical K-major SW128 layout of wgmma. The box's d
//   start is d - 1 + halo, so the halo form is a coordinate and the SAME
//   pad (and the channels past Cin) is TMA's zero fill.
// - B (N) is dy's columns (kw, co) for each kh, N = 3 * 32 = 96. The shift
//   goes on dy: sum_p x(p + s) dy(p) = sum_p x(p) dy(p - s). A one-pixel w
//   shift is a 2-byte offset, which neither a TMA start (whole 16-byte
//   units only on the H100) nor a wgmma descriptor can take, so dy's rows
//   h0-1 .. h0+ROWS are loaded raw (boxes of 80 pixels from w0 - 8, no
//   swizzle) and all 384 threads build the three w-shifted copies, swizzled,
//   in shared memory: [dy row][kw][co][64 pixels]. kh is then a whole row.
// - Warpgroup kh (three of them) holds the 64 x 96 product of the block's
//   x rows with the (kw, co) columns at its kh: per item ROWS x 4 wgmma
//   m64n96k16. Each operand is read from L2 once per block and item: the x
//   tile once for all 27 taps, dy's copies once for all rows of the chunk.
// - Pixels are split over blocks as in conv3x3_wgrad.cu: split s owns a
//   contiguous run of items. Grid (chunks, splits), one block per SM. Each
//   block writes its f32 partial sums with plain stores to its own slice of
//   the workspace; conv3x3_wgrad_reduce_kernel (split_sum.cuh) sums the
//   splits of every output in split order. No atomics: the result repeats
//   bit for bit.
// - Summation chain: the tensor cores' f32 accumulation does not round to
//   nearest, so an item's accumulator restarts after its 8 K-steps (128
//   pixels) and is added into an IEEE f32 sum; the split sum is IEEE too.
//   One product passes through at most ROWS*64 + per + splits roundings
//   (wgrad_wgmma.py:WgradPlan.chain; conv3x3_wgrad_chain).
// - Ring: `stages` (4) stages of x tile + raw dy, 36,864 B each, guarded
//   by full/empty mbarriers, and a ring of 6 copy rows (12,288 B each). A
//   producer warp (lane 0) keeps the TMA loads `stages` items ahead; a
//   stage is refilled once all 12 consumer warps have arrived on its empty
//   barrier after their products. Items run h tile fastest, so item i + 1
//   shares two of its four dy rows with item i: the consumers issue item
//   i's products and, while they run, build only item i + 1's two new copy
//   rows, into the two slots item i does not read; one 384-thread barrier
//   per item orders that build before item i + 1's products and item i's
//   products before the next build (the first item of a new (b, d, w tile)
//   run builds all four rows after an extra barrier). No branch and no
//   register copy among the products (on the conv kernel either makes
//   ptxas serialise the wgmma pipeline). 222,272 B of shared memory.
// - Cout > 32 (the multi-stage backbone's 24 -> 48 and 48 -> 48): tiles of
//   32 output channels, a third grid dimension. Tile t's dy box starts at
//   channel 32t of the one dy map (no copy of dy, no second map): TMA's zero
//   fill stands for the channels past Cout, as it does for Cout < 32, and
//   the block writes dW's channels 32t .. 32t + 31 of its split's slice of
//   the workspace. The split sum is unchanged, so every dW element keeps
//   one fixed order of sums and reruns are bit for bit. x is read once per
//   tile (from L2 where the tiles' blocks run together).
// - Bytes pulled from L2 per call, 96 -> 32 at B 8 x 64^3: x 3 x 0.40 GB
//   (each slice is a row of three kd), dy 5 chunks x 0.13 GB (an item
//   loads only its two new dy rows, a run's first item four) = 0.67 GB;
//   1.9 GB in all. The mma.sync loop pulls x about 1.6 GB and dy 18 x 0.13
//   = 2.4 GB, with 2-byte loads. HBM: x and dy once. Per item 3 TMA boxes:
//   2 of x (7,680 B at cpk 20) and one of 10,240 B of dy.
// - What bounds it (scripts/torch_port_wgrad_ablation.py, parts switched
//   off, on an H100 at 700 W, 96 -> 32): 0.85 ms in all; without the
//   products and copies 0.45 ms, of which the x loads 0.22: L2 traffic for
//   the three kd rows of every x slice, then the per-item barriers. Earlier
//   designs lost more to issue work: one x box per 8 channels (17 boxes an
//   item) and 64-bit divides in the producer's item walk each cost as much
//   as the products.
// - Registers: 48 accumulators and 48 sums per thread; 123 in all, no spill
//   (-Xptxas -v for sm_90a, on the card); FOLD 128, 24 bytes spilled
//   (nvcc 12.8).
// - The phase-major w-folded layout (FOLD, K7b: the weight gradient of the
//   pfold conv, ops/kernels/pfold.py, replacing the dW kernel of
//   conv3d.py:conv3x3_pfold and conv3x3_pfold_halo),
//   xf[b, d, p*C + c, h*(W/4) + w4] = x[b, d, h, 4*w4 + p, c], enters only
//   where data is laid down: the sum over an item's pixels does not care
//   about their order, so K runs phase-major, k = 16p + (w4 - w0/4), in x's
//   rows and dy's copies alike; the products, the ring and the split sum
//   are the packed kernel's. Not bit for bit K2 (another order of sums);
//   held to K2's bound at its own plan's chain.
//   - x: a map over (H*W/4 lanes, Cin, D, 4 phases, B); per h row and
//     phase one box (16 w4, cpk, 3 slices) lands the chunk's rows (kd, j)
//     of that phase's 16 pixels, 32 B each, 32-byte swizzled: the canonical
//     K-major SW32 layout of one wgmma K-step, 2 KB a phase, so K-step p
//     reads plane p. 8 x boxes an item instead of 2. (A single box of all
//     4 phases has a 32-byte inner extent: on an H100, TMA's 128-byte
//     swizzle then does not lay it down as wgmma's SW128 layout (wrong
//     sums), and a pass that swizzled it in place cost 0.33 of 1.35 ms at
//     96 -> 32, B 8 x 64^3, 700 W.)
//     Needs W/4 % 16 == 0: a row's 16 w4 never run into the next h row.
//   - dy: a map over (W/4, 4 phases, H, Cout, B*D); per two rows one box
//     (16 w4, 4 phases, 2 rows, 32 co), so each (co, row) is one 128-byte
//     line of 64 pixels, phase-major, as K2's raw rows are lines of pixels
//     (the build's reads meet no bank twice), and two of 8 w4 from a second map,
//     phase 3 at w0/4-8 and phase 0 at w0/4+16: dy(w + 1 - kw) is phase
//     p + 1 - kw of the same w4, except p = 3, kw = 0 (phase 0, w4 + 1) and
//     p = 0, kw = 2 (phase 3, w4 - 1), built with the packed kernel's
//     funnel shifts. 3 boxes of dy per item instead of 1, the same bytes.
//   - 11 TMA boxes an item where K2 issues 3: K7b takes 1.08-1.15x K2's
//     time (H100, 700 W, bf16, B 8 x 64^3, 24/32/96 -> 32).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "split_sum.cuh"
#include "tma_wgmma.cuh"

namespace {

constexpr int ROWS = 2;             // h rows per item
constexpr int TILE_W = 64;          // w columns per item: 128 B of bf16, one swizzle span
constexpr int PX = TILE_W + 16;     // raw dy pixels per row: w0-8 .. w0+71
constexpr int M = 64;               // x rows per block (one wgmma M)
constexpr int N = 96;               // (kw, co): 3 x 32
constexpr int COUT_T = 32;
constexpr int WG = 3;               // consumer warpgroups, one per kh
constexpr int THREADS = WG * 128;
constexpr int ATOM = 1024;          // 8 rows x 128 B: one swizzle atom
constexpr int MAX_CPK = M / 3;      // channels per chunk: 3 kd x 21 rows fill M
constexpr int X_ROW_BYTES = M * 128;                       // one h row of the chunk
constexpr int X_BYTES = ROWS * X_ROW_BYTES;                // 16,384
constexpr int DY_HALF = COUT_T * ROWS * PX * 2;            // one dy box: 10,240
constexpr int DY_BYTES = 2 * DY_HALF;                       // rows h0-1, h0 | h0+1, h0+2
constexpr int STAGE_BYTES = X_BYTES + DY_BYTES;            // 36,864
constexpr int COPY_ROW_BYTES = N * 128;                    // one dy row's shifted copies
constexpr int SLOTS = 2 * ROWS + 2;                         // copy rows in the ring
constexpr int COPY_BYTES = SLOTS * COPY_ROW_BYTES;          // 73,728
constexpr int MAX_STAGES = 4;
constexpr int SLACK = 1024;         // the 1024-byte alignment of the swizzled tiles
constexpr int BAR_BYTES = 16 * MAX_STAGES;
constexpr int SMEM_LIMIT = 232448;

// The folded raw dy of two rows (FOLD): [32 co][2 rows][4 phases][16 w4],
// then the left and right boxes [32 co][2 rows][8 w4]: DY_HALF as packed.
constexpr int FOLD_DY_MAIN = 4 * COUT_T * ROWS * 16 * 2;  // 8,192
constexpr int FOLD_DY_SIDE = COUT_T * ROWS * 8 * 2;       // 1,024
static_assert(FOLD_DY_MAIN + 2 * FOLD_DY_SIDE == DY_HALF, "folded dy = packed dy");

struct Params {
  float* part;  // (splits, 27 * Cin * Cout)
  int d, halo, cin, cout, h, wdim, cpk, chunks, stages, tiles_h, tiles_w, items, per;
};

// K-major, 128-byte swizzle: rows of 128 B, 8-row atoms 1024 B apart (SBO);
// the K-step's 16 elements are 32 B on from the row's start.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(ATOM >> 4) << 32) | (1ull << 62);
}

// FOLD's x planes: K-major, 32-byte swizzle: rows of 32 B (one K-step),
// 8-row atoms 256 B apart (SBO).
__device__ __forceinline__ uint64_t desc_sw32(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32) | (3ull << 62);
}
constexpr int FOLD_X_PLANE = M * 32;  // one phase's 64 rows of 16 pixels

// Byte offset of 16-byte chunk c of row n in a 128-byte-swizzled tile.
__device__ __forceinline__ uint32_t sw128(int n, int c) {
  return n * 128 + ((c ^ (n & 7)) << 4);
}

// An item: batch b, dy slice d, h tile th (rows 2 th, 2 th + 1), w tile tw.
// Items run h tile fastest, then w tile, dy slice, batch, so item it + 1 is
// the next h tile of item it unless its th is 0. The producer walks them
// with `advance`: a divide per item, 64-bit above all, held it up.
struct Item {
  int b, d, th, tw;
};

__device__ __forceinline__ Item item_at(const Params& p, int it) {
  const int tiles = p.tiles_h * p.tiles_w;
  const int bd = it / tiles, t = it % tiles;
  return {bd / p.d, bd % p.d, t % p.tiles_h, t / p.tiles_h};
}

__device__ __forceinline__ void advance(const Params& p, Item& t) {
  if (++t.th < p.tiles_h) return;
  t.th = 0;
  if (++t.tw < p.tiles_w) return;
  t.tw = 0;
  if (++t.d < p.d) return;
  t.d = 0;
  ++t.b;
}

// The producer: the TMA loads of item `it` into ring stage `dst`: per h row
// one box of the chunk's x rows (kd, j), 64 pixels each, and dy's raw rows
// in two boxes of two rows, h0-1, h0 and h0+1, h0+2, of which an item that
// `follows` the one before it (the next h tile) needs only the second.
// (FOLD: per h row and phase an x box at lane h*W/4 + w0/4, and per two dy
// rows the main box and the two 8-w4 side boxes.)
template <bool FOLD>
__device__ __forceinline__ void load_item(const Params& p, const CUtensorMap* xmap,
                                          const CUtensorMap* dymap, const CUtensorMap* dyside,
                                          uint32_t dst, uint32_t bar, const Item& t,
                                          bool follows) {
  const int h0 = t.th * ROWS, w0 = t.tw * TILE_W;
  mbar_expect_tx(bar, ROWS * 3 * p.cpk * 128 + (follows ? DY_HALF : DY_BYTES));
  if (FOLD) {
    const int w4dim = p.wdim / 4, w4 = w0 / 4, bd = t.b * p.d + t.d;
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int ph = 0; ph < 4; ++ph)
        tma_load_5d(dst + r * X_ROW_BYTES + ph * FOLD_X_PLANE, xmap, bar,
                    (h0 + r) * w4dim + w4, blockIdx.x * p.cpk, t.d - 1 + p.halo, ph, t.b);
    for (int half = follows ? 1 : 0; half < 2; ++half) {
      const uint32_t dh = dst + X_BYTES + half * DY_HALF;
      const int hh = h0 - 1 + 2 * half;
      tma_load_5d(dh, dymap, bar, w4, 0, hh, 0, bd);
      tma_load_5d(dh + FOLD_DY_MAIN, dyside, bar, w4 - 8, 3, hh, 0, bd);
      tma_load_5d(dh + FOLD_DY_MAIN + FOLD_DY_SIDE, dyside, bar, w4 + 16, 0, hh, 0, bd);
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    tma_load_5d(dst + r * X_ROW_BYTES, xmap, bar, w0, blockIdx.x * p.cpk, t.d - 1 + p.halo,
                h0 + r, t.b);
  const int co0 = blockIdx.z * COUT_T;  // the block's co tile
  if (!follows) tma_load_5d(dst + X_BYTES, dymap, bar, w0 - 8, h0 - 1, co0, t.d, t.b);
  tma_load_5d(dst + X_BYTES + DY_HALF, dymap, bar, w0 - 8, h0 + 1, co0, t.d, t.b);
}

// Elements 1..8 of the 16 that a then b hold (one bf16 step up), and
// elements 7..14 (one step down).
__device__ __forceinline__ uint4 shift_up(uint4 a, uint4 b) {
  return make_uint4(__funnelshift_r(a.x, a.y, 16), __funnelshift_r(a.y, a.z, 16),
                    __funnelshift_r(a.z, a.w, 16), __funnelshift_r(a.w, b.x, 16));
}

__device__ __forceinline__ uint4 shift_down(uint4 a, uint4 b) {
  return make_uint4(__funnelshift_r(a.w, b.x, 16), __funnelshift_r(b.x, b.y, 16),
                    __funnelshift_r(b.y, b.z, 16), __funnelshift_r(b.z, b.w, 16));
}

// dy's shifted copies of an item's rows t0 .. ROWS + 1: copy[row t][kw][co][k]
// = dy(co, h0 - 1 + t, w0 + k - kw + 1), from the raw rows [t / 2][co][t % 2][PX]
// (pixel w0 - 8 + i at i), row t into ring slot (slot0 + t) % SLOTS. FOLD: k
// is 16p + i for pixel w0 + 4i + p, from the folded raw rows (FOLD_DY_MAIN).
template <bool FOLD>
__device__ __forceinline__ void build_copies(const uint8_t* raw, uint8_t* copies, int slot0,
                                             int t0) {
  const int units = (ROWS + 2 - t0) * COUT_T * (TILE_W / 8);  // 16-byte chunks per kw
  for (int u = threadIdx.x; u < units; u += THREADS) {
    const int c = u % 8, co = (u / 8) % COUT_T, t = t0 + u / (8 * COUT_T);
    uint8_t* row = copies + (slot0 + t) % SLOTS * COPY_ROW_BYTES;
    if (FOLD) {
      // chunk c: 8 w4 (g) of phase ph; a (phase, w4 group) chunk of dy's row
      const uint8_t* half = raw + (t / ROWS) * DY_HALF;
      const int r = t % ROWS, ph = c >> 1, g = c & 1;
      auto at = [&](int q, int gg) {
        return *reinterpret_cast<const uint4*>(half + ((co * ROWS + r) * 4 + q) * 32 +
                                               gg * 16);
      };
      auto edge = [&](int side) {  // 0: w4 w0/4-8.. of phase 3, 1: w0/4+16.. of phase 0
        return *reinterpret_cast<const uint4*>(half + FOLD_DY_MAIN + side * FOLD_DY_SIDE +
                                               (co * ROWS + r) * 16);
      };
      const uint4 s1 = at(ph, g);  // kw = 1: the pixel itself
      // kw = 0: pixel + 1, phase ph + 1 (ph 3: phase 0 of the next w4)
      const uint4 s0 = ph < 3 ? at(ph + 1, g) : shift_up(at(0, g), g ? edge(1) : at(0, 1));
      // kw = 2: pixel - 1, phase ph - 1 (ph 0: phase 3 of the w4 before)
      const uint4 s2 = ph > 0 ? at(ph - 1, g) : shift_down(g ? at(3, 0) : edge(0), at(3, g));
      *reinterpret_cast<uint4*>(row + sw128(co, c)) = s0;
      *reinterpret_cast<uint4*>(row + sw128(COUT_T + co, c)) = s1;
      *reinterpret_cast<uint4*>(row + sw128(2 * COUT_T + co, c)) = s2;
      continue;
    }
    const uint8_t* line = raw + (t / ROWS) * DY_HALF + (co * ROWS + t % ROWS) * PX * 2;
    const uint4* src = reinterpret_cast<const uint4*>(line) + c;
    const uint4 q0 = src[0], q1 = src[1], q2 = src[2];  // pixels k - 8 .. k + 16
    const uint32_t a[6] = {q0.w, q1.x, q1.y, q1.z, q1.w, q2.x};
    // kw = 1: pixel k + 8, chunk q1; kw = 0: k + 9, one pixel on; kw = 2: k + 7
    uint4 s0, s2;
    s0.x = __funnelshift_r(a[1], a[2], 16);
    s0.y = __funnelshift_r(a[2], a[3], 16);
    s0.z = __funnelshift_r(a[3], a[4], 16);
    s0.w = __funnelshift_r(a[4], a[5], 16);
    s2.x = __funnelshift_r(a[0], a[1], 16);
    s2.y = __funnelshift_r(a[1], a[2], 16);
    s2.z = __funnelshift_r(a[2], a[3], 16);
    s2.w = __funnelshift_r(a[3], a[4], 16);
    *reinterpret_cast<uint4*>(row + sw128(co, c)) = s0;
    *reinterpret_cast<uint4*>(row + sw128(COUT_T + co, c)) = q1;
    *reinterpret_cast<uint4*>(row + sw128(2 * COUT_T + co, c)) = s2;
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

template <bool FOLD>
__global__ void __launch_bounds__(THREADS + 32, 1)
conv3x3_wgrad_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                           const __grid_constant__ CUtensorMap dymap,
                           const __grid_constant__ CUtensorMap dyside, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + SLACK - 1) & ~static_cast<uintptr_t>(SLACK - 1));
  uint8_t* copies = base + p.stages * STAGE_BYTES;
  const uint32_t ring = smem_u32(base);
  const uint32_t copy_s = smem_u32(copies);
  const uint32_t full = copy_s + COPY_BYTES;  // stage s loaded: TMA bytes
  const uint32_t empty = full + 8 * MAX_STAGES;   // stage s free: one arrival per warp

  const int warp = __shfl_sync(0xffffffff, static_cast<int>(threadIdx.x / 32), 0);
  const int kh = warp / 4;
  const int it0 = blockIdx.y * p.per;
  const int n = min(p.per, p.items - it0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, WG * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == WG * 4) {  // the producer warp: lane 0 keeps the ring `stages` items ahead
    if (threadIdx.x % 32 == 0) {
      Item t = item_at(p, it0);
      for (int j = 0, s = 0, phase = 0; j < n; ++j) {
        if (j >= p.stages) mbar_wait(empty + 8 * s, phase ^ 1);
        load_item<FOLD>(p, &xmap, &dymap, &dyside, ring + s * STAGE_BYTES, full + 8 * s, t,
                        j > 0 && t.th != 0);
        advance(p, t);
        if (++s == p.stages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  float acc[N / 2], sum[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = sum[i] = 0.f;
  hold(acc);

  // copy rows: item i's row t in slot (slot0 + t) % SLOTS; the next h tile
  // reuses rows 2, 3 as its rows 0, 1 (slot0 + 2) and builds two new ones
  int slot0 = 0;
  if (n > 0) {
    mbar_wait(full, 0);
    build_copies<FOLD>(base + X_BYTES, copies, slot0, 0);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  named_sync(1, THREADS);
  int stage = 0, s1 = 1 % p.stages, phase1 = p.stages == 1, th1 = (it0 + 1) % p.tiles_h;
  for (int i = 0; i < n; ++i) {
    // item i's copy rows are built, and every warpgroup is done with item i - 1;
    // item i + 1 is in stage s1 (parity phase1) and has h tile th1
    const uint32_t x_s = ring + stage * STAGE_BYTES;
    uint32_t b_s[ROWS];  // x row h0 + r meets dy row h0 + r + 1 - kh: copy row r + 2 - kh
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      b_s[r] = copy_s + (slot0 + r + 2 - kh) % SLOTS * COPY_ROW_BYTES;
    __syncwarp();
    wgmma_fence();
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
#pragma unroll
      for (int k = 0; k < TILE_W / 16; ++k)
        wgmma_tile<N>(acc, FOLD ? desc_sw32(x_s + r * X_ROW_BYTES + k * FOLD_X_PLANE)
                                : desc_sw128(x_s + r * X_ROW_BYTES + k * 32),
                      desc_sw128(b_s[r] + k * 32));
    }
    wgmma_commit();
    const int next = (slot0 + ROWS) % SLOTS;
    const bool more = i + 1 < n;
    const bool follows = more && th1 != 0;
    // while the products run, the next h tile's two new copy rows into
    // slots no product of item i reads
    if (follows) {
      mbar_wait(full + 8 * s1, phase1);
      build_copies<FOLD>(base + s1 * STAGE_BYTES + X_BYTES, copies, next, 2);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
    wgmma_wait0();
    hold(acc);
#pragma unroll
    for (int j = 0; j < N / 2; ++j) {
      sum[j] += acc[j];
      acc[j] = 0.f;
    }
    hold(acc);  // zeroed here, not inside the next products
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(empty + 8 * stage);  // x tile of item i read
    if (more && !follows) {  // a new (b, d, w tile) run: all four rows, once item i is done
      named_sync(1, THREADS);
      mbar_wait(full + 8 * s1, phase1);
      build_copies<FOLD>(base + s1 * STAGE_BYTES + X_BYTES, copies, next, 0);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
    named_sync(1, THREADS);
    slot0 = next;
    stage = s1;
    if (++s1 == p.stages) {
      s1 = 0;
      phase1 ^= 1;
    }
    if (++th1 == p.tiles_h) th1 = 0;
  }

  // rows m (kd, ci) of the chunk, columns (kw, co) at this warpgroup's kh
  const int lane = threadIdx.x % 32, wq = warp % 4;
  const long long ncc = static_cast<long long>(p.cin) * p.cout;
  float* out = p.part + static_cast<long long>(blockIdx.y) * 27 * ncc;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = wq * 16 + lane / 4 + 8 * (e >> 1);
      const int col = 8 * j + 2 * (lane % 4) + (e & 1);
      const int kd = m / p.cpk, ci = blockIdx.x * p.cpk + m % p.cpk;
      const int kw = col / COUT_T, co = (FOLD ? 0 : blockIdx.z * COUT_T) + col % COUT_T;
      if (kd < 3 && ci < p.cin && co < p.cout)
        out[(kd * 9 + kh * 3 + kw) * ncc + static_cast<long long>(ci) * p.cout + co] =
            sum[4 * j + e];
    }
  }
}

// Errors of this launcher's own, beside cudaError_t's (kernel_error_string).
constexpr int ERR_PLAN = -1;       // the plan does not fit the kernel
constexpr int ERR_ENTRY = -2;      // cuTensorMapEncodeTiled not found
constexpr int ERR_TENSORMAP = -3;  // a tensor map was refused

int smem_bytes(int stages) { return SLACK + stages * STAGE_BYTES + COPY_BYTES + BAR_BYTES; }

// A 5-d bf16 tensor map over dims (innermost first) with element strides
// `str` (dim 0 contiguous), box `box`, swizzle `swizzle`.
CUresult encode_5d(EncodeTiled encode, CUtensorMap* map, const void* ptr, const long long* dim,
                   const long long* str, const int* box, CUtensorMapSwizzle swizzle) {
  cuuint64_t dims[5], strides[4];
  cuuint32_t boxes[5], estr[5];
  for (int i = 0; i < 5; ++i) {
    dims[i] = static_cast<cuuint64_t>(dim[i]);
    boxes[i] = static_cast<cuuint32_t>(box[i]);
    estr[i] = 1;
    if (i > 0) strides[i - 1] = static_cast<cuuint64_t>(str[i]) * 2;
  }
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(ptr), dims, strides,
                boxes, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace

extern "C" {

// x: (B, D + 2*halo, Cin, H*wdim), dy: (B, D, Cout, H*wdim), bf16,
// contiguous, 16-byte aligned (fold: both folded, (B, ., 4*C, H*wdim/4),
// wdim = W); part: f32 (splits, 27 * Cin * Cout); out: f32 (3, 3, 3, Cin,
// Cout). The plan's numbers (cpk, chunks, stages, splits, per, co_tiles)
// come from wgrad_plan and are checked here. Returns 0, a cudaError_t, or
// one of the ERR_ codes above.
int conv3x3_wgrad_wgmma_bf16(const void* x, const void* dy, void* part, void* out, int B, int D,
                             int halo, int fold, int cin, int cout, int h, int wdim, int cpk,
                             int chunks, int stages, int splits, long long per, int co_tiles,
                             void* stream) {
  const int tiles_h = (h + ROWS - 1) / ROWS, tiles_w = (wdim + TILE_W - 1) / TILE_W;
  const long long items = static_cast<long long>(B) * D * tiles_h * tiles_w;
  const int smem = smem_bytes(stages);
  const bool ok = B >= 1 && D >= 1 && (halo == 0 || halo == 1) && cin >= 1 &&
                  co_tiles >= 1 && co_tiles <= 65535 && (!fold || co_tiles == 1) &&
                  cout > (co_tiles - 1) * COUT_T && cout <= co_tiles * COUT_T && h >= 1 &&
                  wdim >= 1 && wdim % 8 == 0 && cpk >= 1 &&
                  cpk <= MAX_CPK && chunks == (cin + cpk - 1) / cpk && stages >= 2 &&
                  stages <= MAX_STAGES && smem <= SMEM_LIMIT && splits >= 1 && splits <= 65535 &&
                  per >= 1 && items <= 0x7fffffff && (splits - 1) * per < items &&
                  splits * per >= items && (!fold || wdim % TILE_W == 0) &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  if (!ok) return ERR_PLAN;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return ERR_ENTRY;
  // x as (W, Cin, D, H, B): one box of 64 pixels x cpk channels x 3 slices
  // lands as the chunk's rows (kd, j) of one h row, 128 B each; dy as (W, H,
  // Cout, D, B): 80 pixels x 2 rows x 32 channels, [co][row][pixel]
  const long long hw = static_cast<long long>(h) * wdim, dx = D + 2 * halo;
  CUtensorMap xmap, dymap, dyside;
  if (fold) {
    // x as (H*W/4 lanes, Cin, D, 4 phases, B): one box of 16 w4 x cpk
    // channels x 3 slices lands as the chunk's rows (kd, j) of one h row and
    // phase, 32 B each, 32-byte swizzled; dy as (W/4, 4 phases, H, Cout, B*D): the
    // main box 16 w4 x 4 phases x 2 rows x 32 channels, the side boxes 8 w4
    // of one phase
    const long long w4 = wdim / 4, hw4 = hw / 4;
    const long long xdim[5] = {h * w4, cin, dx, 4, B};
    const long long xstr[5] = {1, hw4, hw * cin, hw4 * cin, hw * cin * dx};
    const long long ddim[5] = {w4, 4, h, cout, static_cast<long long>(B) * D};
    const long long dstr[5] = {1, hw4 * cout, w4, hw4, hw * cout};
    const int xbox[5] = {16, cpk, 3, 1, 1}, dbox[5] = {16, 4, ROWS, COUT_T, 1};
    const int sbox[5] = {8, 1, ROWS, COUT_T, 1};
    if (encode_5d(encode, &xmap, x, xdim, xstr, xbox, CU_TENSOR_MAP_SWIZZLE_32B) !=
            CUDA_SUCCESS ||
        encode_5d(encode, &dymap, dy, ddim, dstr, dbox, CU_TENSOR_MAP_SWIZZLE_NONE) !=
            CUDA_SUCCESS ||
        encode_5d(encode, &dyside, dy, ddim, dstr, sbox, CU_TENSOR_MAP_SWIZZLE_NONE) !=
            CUDA_SUCCESS)
      return ERR_TENSORMAP;
  } else {
    // x as (W, Cin, D, H, B): one box of 64 pixels x cpk channels x 3 slices
    // lands as the chunk's rows (kd, j) of one h row, 128 B each; dy as (W,
    // H, Cout, D, B): 80 pixels x 2 rows x 32 channels, [co][row][pixel]
    const long long xdim[5] = {wdim, cin, dx, h, B};
    const long long xstr[5] = {1, hw, hw * cin, wdim, hw * cin * dx};
    const long long ddim[5] = {wdim, h, cout, D, B};
    const long long dstr[5] = {1, wdim, hw, hw * cout, hw * cout * D};
    const int xbox[5] = {TILE_W, cpk, 3, 1, 1}, dbox[5] = {PX, ROWS, COUT_T, 1, 1};
    if (encode_5d(encode, &xmap, x, xdim, xstr, xbox, CU_TENSOR_MAP_SWIZZLE_128B) !=
            CUDA_SUCCESS ||
        encode_5d(encode, &dymap, dy, ddim, dstr, dbox, CU_TENSOR_MAP_SWIZZLE_NONE) !=
            CUDA_SUCCESS)
      return ERR_TENSORMAP;
    dyside = dymap;  // unread
  }

  Params p;
  p.part = static_cast<float*>(part);
  p.d = D;
  p.halo = halo;
  p.cin = cin;
  p.cout = cout;
  p.h = h;
  p.wdim = wdim;
  p.cpk = cpk;
  p.chunks = chunks;
  p.stages = stages;
  p.tiles_h = tiles_h;
  p.tiles_w = tiles_w;
  p.items = static_cast<int>(items);
  p.per = static_cast<int>(per);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kernel = fold ? conv3x3_wgrad_wgmma_kernel<true> : conv3x3_wgrad_wgmma_kernel<false>;
  cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<dim3(chunks, splits, co_tiles), THREADS + 32, smem, s>>>(xmap, dymap, dyside, p);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const long long nout = 27LL * cin * cout;
  conv3x3_wgrad_reduce_kernel<<<static_cast<unsigned>((nout + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(out), nout, splits);
  return static_cast<int>(cudaGetLastError());
}

// The shared memory a launch with this ring depth takes (the plan's own
// number is held to it by the tests on the card).
int conv3x3_wgrad_wgmma_smem(int stages) { return smem_bytes(stages); }

const char* kernel_error_string(int code) {
  if (code == ERR_PLAN) return "the launch plan does not fit the wgmma wgrad kernel";
  if (code == ERR_ENTRY) return "cuTensorMapEncodeTiled not found in the driver";
  if (code == ERR_TENSORMAP) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
