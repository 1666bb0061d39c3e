// The bf16 wgmma conv kernel of conv3x3_wgmma.cu (K1, K1's dgrad, K5, K5's
// dgrad, K7a), as a header so that probe.cu (K9b) compiles its ablation
// modes (template parameter MODE) in its own library; conv3x3_wgmma.cu's
// header says what the kernel replaces and what bounds it.
//
// Design.
// - GEMM view: M = 64 output pixels of one h row (w0 .. w0+63), N = Cout
//   padded to 32/64/96 (one wgmma covers every output channel, so the dgrad
//   reads each dy tile once), K = 16 input channels per wgmma. Two more N:
//   24, for Cout <= 24 where N 32's weights would not fit (the multi-stage
//   backbone's upcat_1 conv 144 -> 24: 186,624 B of weights beside a
//   2-stage ring, 232,360 B in all); and N tiles of 72 for Cout > 96 (its
//   dgrad 24 -> 144: two tiles), a grid dimension: the block of tile nt
//   holds only output channels 72nt .. 72nt + 71 of the weights and writes
//   only that channel range of the one output, at the full channel stride
//   (no second tensor, no cat). The tiles of one column are neighbouring
//   blocks, so the second reads the input tile from L2. Each output element
//   still has one fixed order of sums. Only the N-72 instance is TILED: in
//   the others the tile's offset is the constant 0, so their code (and
//   registers: two more live ones cost 2-8 % of K1's time) is as before.
// - A block owns a column: one batch, ROWS = 2*RW output h rows, one 64-wide
//   w tile, and a segment of output d slices, which it WALKS: step j loads
//   input slice j once (all channels, 16 per ring stage) and applies all three
//   kd taps to it, into three rolling accumulators (outputs j+1, j, j-1 in
//   input coordinates); after the step output j-1 is complete and stored. So
//   each input slice is read once per column, not three times.
// - Weights: the wrapper lays them out as the wgmma B operand wants them
//   (K-major, no swizzle, 8x8 core matrices; conv_wgmma.py:weight_image); one
//   bulk copy per block puts all 27*Cin_pad*N of them in shared memory, where
//   they stay for the whole walk (at most 166 KB on the main path).
// - Activations: TMA loads (cp.async.bulk.tensor, out-of-bounds zero fill)
//   stay in flight in a ring of 2-4 stages, each stage one input slice's 16
//   channels over ROWS+2 h rows, one box of PX = 80 pixels per row. Thread 0
//   issues them: the ring's first loads at the start, then each stage again
//   as soon as all warps have transposed it (no producer warp: its 32
//   threads would cap the warpgroups' registers at 168, which spills the
//   three N-96 accumulators). The zero fill is the SAME padding in h, w and d, the
//   missing slices of the D -> D+2 geometry and the Cin tail (24 = 16 + 8):
//   no bounds test anywhere in the loop.
// - The (kh, kw) shift. TMA takes an innermost start coordinate of whole
//   16-byte units only (a box started one pixel off is an illegal
//   instruction on the H100), and a one-pixel w shift of a pixel-contiguous
//   tile is a 2-byte offset, no legal wgmma descriptor base either. So the
//   row's box starts 8-aligned at or below the pixel that output pixel w0
//   reads at kw = 0 (w0 - 8 under the rows map), and the 8 consumer warps
//   transpose each stage with ldmatrix.trans + stmatrix (8 x 8 blocks, 16
//   bytes a row) into pixel-major rows of 8 channels: [channel half][h row]
//   [pixel][8 channels]. There a pixel is 16 bytes, so the kw shift (and the
//   row's skew) is a 16-byte step of a K-major, unswizzled descriptor (8 x 8
//   core matrices 128 B apart, SBO; the second 8 channels one plane on, LBO),
//   and the kh shift a row of PX pixels. Two transposed tiles alternate, so
//   one barrier of the 256 threads per stage orders the transpose before the
//   products, and the raw stage is refilled at once.
// - Tensor maps, encoded on the host per launch and passed as a
//   __grid_constant__ CUtensorMap (cuTensorMapEncodeTiled reached through
//   cudaGetDriverEntryPoint: the library links no -lcuda):
//     rows  (wdim, H, Cin, Din, B), box (80, 1, 16, 1, 1); needs wdim % 8 == 0
//           (TMA strides are multiples of 16 B);
//     lanes (H*wdim, Cin, Din, B), box (80, 16, 1, 1), one box per h row,
//           each at its own skew (row_skew); taken where wdim % 8 != 0 and
//           wguard >= 1 (K1W: wdim 66): a w neighbour past the row's end is
//           then a zero guard column of the next or previous row, exactly the
//           SAME pad. The box starts at most 7 lanes below pixel w0 - 1, so
//           its 80 lanes reach pixel w0 + 64 (at the last data tile of a
//           row, the row's first guard: w = W).
// - Guard columns (1 <= wguard <= 8: K1W and its dgrad, template GUARD): the
//   w tiles cover the data columns only, ceil((wdim - wguard) / 64) a row
//   (one at 64 + 2, two at 128 + 2), and the block of a row's last data tile
//   also writes that row's guard columns as zero: every guard voxel written
//   once, no block computing products for guards alone, no pre-zeroed output.
// - Epilogue: per 16 output channels, the f32 accumulators + bias, rounded to
//   bf16 go through a 16 x 64 staging tile in shared memory; each thread then
//   stores 16 bytes (8 pixels of one channel) along w. GUARD
//   (store_slice_guarded): a row starts at hh * wdim lanes, only 4-byte
//   aligned at wdim 66 and 130, so a channel's output goes through the
//   staging in flat spans of the channel plane, data and zero guards
//   together, each at its start's lane mod 8, and is stored by 16-byte units
//   of the plane: a unit wholly inside the span in one 16-byte store, the
//   partial units at its two ends in the widest stores their alignment
//   allows (8, 4, 2 bytes). Where the block owns every column of its rows
//   (one data tile a row) its ROWS rows are one span, staged and stored by
//   both warpgroups: 4 * 66 lanes at N 32 (528 B from a 16-byte boundary,
//   33 whole units, no partial one), 2 * 66 at RW 1 (264 B from a multiple
//   of 8 bytes: 16 whole units and half of one). Else (two data tiles a row)
//   each warpgroup stores a span a row. 16 channels a pass at RW 1, 8 at RW 2;
//   a shape whose spans the staging does not hold has no plan
//   (guard_staging_fits). The bias is the accumulators' start value, so the
//   epilogue loads nothing. The unguarded instances' code is as before.
// - Sizes (wgmma_plan): N 32: RW 2 (4 rows), stages of 15,360 B; N 24/64/
//   72/96: RW 1 (2 rows), stages of 10,240 B; the deepest ring up to 4 that fits
//   beside two transposed tiles and the weight (96 -> 32: 2 stages, 232,104
//   B in all). 256 threads, one block per SM. Registers: the accumulators
//   take 3 * RW * N / 2 per thread (96 at N 32 RW 2, 144 at N 96); in all
//   (-Xptxas -v, nvcc 12.9 for sm_90a) 190 at N 32 RW 2, 126 at N 32 RW 1,
//   175 at N 64, 228 at N 96, none spilled (FOLD, nvcc 12.8: 196 / 110 /
//   171 / 238, none spilled; N 24 113 and the TILED N 72 194, nvcc 12.8,
//   none spilled; GUARD, nvcc 12.8: 190 at N 32 RW 2, 162 at N 32 RW 1, 193
//   at N 64, 238 at N 96, 150 at N 24, 244 at the TILED N 72, none
//   spilled). The walk is unrolled by three so that each output's
//   accumulator is fixed at compile time, and every tap runs even for an
//   output outside the block's
//   d segment (never stored): a register copy or a branch among the products
//   makes ptxas serialise the wgmma pipeline.
// - The phase-major w-folded layout (FOLD, K7a: the pfold conv of
//   ops/kernels/pfold.py, replacing conv3d.py:conv3x3_pfold and
//   conv3x3_pfold_halo), xf[b, d, p*C + c, h*(W/4) + w4] = x[b, d, h, 4*w4 + p, c],
//   enters only where data is laid down or read back; the transposed tile,
//   the descriptors, the products, the d walk and the weights are the
//   packed kernel's, so on the same volume K7a's result is K1's bit for bit.
//   - Loads: a 5-d map over (W/4, Cin, H, 4 phases, B*Din) (d and b merge:
//     the walk loads no slice outside [0, Din); channels before rows, so
//     the 8 channels a transpose reads are 32 B apart, as in K1); per stage
//     one box (16 w4, 16 channels, ROWS+2 rows, 4 phases) holds the tile's
//     64 pixels of every row, and two boxes of 8 w4 from a second map (box
//     (8, 16, ROWS+2, 1)) the w neighbours: pixel w0-1 is phase 3 at w4 w0/4-1, pixel
//     w0+64 phase 0 at w0/4+16. Every box starts 8-aligned, 2560 B a row
//     as K1's, and the zero fill is still the SAME pad in h and w and the
//     Cin tail (channels and phases are separate dimensions). Needs
//     W/4 % 8 == 0 (TMA row strides are multiples of 16 B).
//   - Transpose: an 8 x 8 block read by ldmatrix.trans is 8 w4 of one
//     (phase, channel), pixels 4*w4 + p; stmatrix takes one row address per
//     lane, so the fold is only other row addresses: block (p, g) lands at
//     transposed pixels 8 + 32g + 4i + p, the left box's last w4 at pixel
//     7 and the right box's first at 72 (their other rows at 0..6 and
//     73..79, which no product reads). 10 blocks a row half, as K1's.
//   - Epilogue: each thread stores 16 bytes, 8 consecutive w4 of one
//     (phase, channel), read from the staging tile at stride 4.
//   - Cost over K1: a transpose block's 8 stored rows lie 4 pixels (64 B)
//     apart, 4-way bank conflicts where K1's rows are adjacent; inherent,
//     since a 16-byte raw row holds one phase. K7a takes 1.01-1.14x K1's
//     time (H100, 700 W, bf16, B 8 x 64^3, 24/32/96 -> 32 and the dgrads).
// - Bytes pulled from L2 per call, 96 -> 32 at B 8 x 64^3: activations
//   6 rows / 4 output rows x 96 channels x 160 B per 64 pixels of each input
//   slice, 0.75 GB; weights 128 blocks x 166 KB, 0.02 GB. K1's mma.sync loop
//   (conv3x3_packed.cu) pulls about 1.6 GB of activations and 1.36 GB of
//   weights. HBM: the input once and the output once (0.40 + 0.13 GB), the
//   reuse between neighbouring columns being served from L2.
// - MODE (probe.cu only, K9b: the ablations that split this kernel's time;
//   ops/kernels/probe.py states each mode's function in plain PyTorch). It
//   enters only step() and the prologue; the plan, maps, weights, d walk and
//   epilogue are MODE_FULL's:
//     MODE_FULL    the conv itself (K1's instances are this mode);
//     MODE_CENTRE  the same staging (ring, transpose, barriers), but every
//                  (kh, kw) tap's A descriptor reads the unshifted pixel (h
//                  row r + 1 of the tile, kw = 1): a (3, 1, 1) conv with the
//                  weights summed over (kh, kw),
//                    y = bias + sum_{kd,ci} (sum_{kh,kw} w[kd,kh,kw,ci,co])
//                                 * x[b, e+kd-1, ci, h, w];
//                  the 27 products stay 27 (wgmma is asm volatile);
//     MODE_FIXED   no staging inside the walk: before it, each block loads
//                  chunk 0 of input slice 0 once (the same map, zero fill)
//                  and transposes it once; every step then runs FULL's
//                  products on that tile with FULL's resident weights for
//                  (kd, tap, chunk), then FULL's epilogue, with no mbarrier
//                  wait, transpose, barrier or refill inside the walk:
//                    y[b,e,co,h,w] = bias[co] + sum_{kd: 0 <= e+kd-1 < D}
//                      sum_{kh,kw} sum_{ci < min(16, Cin)}
//                      (sum_c w[kd,kh,kw,16c+ci,co]) * x[b, 0, ci, h+kh-1, w+kw-1]
//                  (weights past Cin zero): slice 0's conv repeated over d,
//                  the weights' 16-channel chunks summed; no longer
//                  dependent on the d segments.
//   fixed is the products and the epilogue, full - fixed the staging (TMA
//   waits, transpose, barrier, refill), full - centre what the shifted
//   descriptor addresses cost.

#pragma once

#include <cuda.h>  // CUtensorMap and the driver's enums (header only, no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_wgmma.cuh"

namespace {

constexpr int TILE_W = 64;       // output w columns per tile: one wgmma M
constexpr int PX = TILE_W + 16;  // pixels per loaded row: w0-8 .. w0+71
constexpr int CK = 16;           // input channels per ring stage: one wgmma K
constexpr int CONSUMERS = 2;     // consumer warpgroups
constexpr int THREADS = CONSUMERS * 128;
constexpr int ROW_BYTES = CK * PX * 2;  // one (h row, 16 channels) box: 2560 B
constexpr int EPI_STRIDE = 72;   // bf16 per channel row of the staging tile
constexpr int EPI_BYTES = 16 * EPI_STRIDE * 2;  // per consumer warpgroup
constexpr int MAX_STAGES = 4;
constexpr int BAR_BYTES = 8 * (MAX_STAGES + 1);
constexpr int SLACK = 128;       // alignment of the dynamic shared memory base
constexpr int SMEM_LIMIT = 232448;
constexpr int WCHUNK = 32768;    // bytes per bulk copy of the weight image
constexpr int MODE_FULL = 0, MODE_CENTRE = 1, MODE_FIXED = 2;  // MODE (above)
constexpr int MAX_GUARD = 8;     // guard columns a row (guard_cols gives 2 to 8)

// The folded stage (FOLD): per 16-channel chunk, the main box [4 phases]
// [ROWS+2 rows][16 ch][16 w4], then the left and right boxes [ROWS+2 rows]
// [16 ch][8 w4]; a row's share is ROW_BYTES, as in the packed stage.
constexpr int FOLD_MAIN_ROW = 4 * CK * 16 * 2;  // 2048 B per row
constexpr int FOLD_SIDE_ROW = CK * 8 * 2;       // 256 B per row and side
static_assert(FOLD_MAIN_ROW + 2 * FOLD_SIDE_ROW == ROW_BYTES, "folded stage = packed stage");

struct Params {
  const uint8_t* w;   // weight image (conv_wgmma.py:weight_image)
  const float* bias;  // (Cout,) f32
  __nv_bfloat16* y;   // (B, Dout, Cout, H*wdim)
  int din, dout, shift, cin, cout, h, wdim, wdata, lanes_map;
  int chunks, stages, seg_len, segments, tiles_h, tiles_w, wbytes;  // wbytes: one N tile's
  int n_tiles;
};

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// A: 64 pixels x 16 channels, K-major, no swizzle: pixel rows of 8 channels
// (16 B) one after another, so 8 x 8 core matrices 128 B apart (SBO), the
// second 8 channels a plane of the transposed tile further on (LBO).
__device__ __forceinline__ uint64_t desc_a(uint32_t saddr, uint32_t plane) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(plane >> 4) << 16) | (static_cast<uint64_t>(128 >> 4) << 32);
}

// B: 16 channels x N, K-major, no swizzle: 8 x 8 core matrices of 128 B, the
// second 8 channels 128 B on (LBO), the next 8 output channels 256 B on (SBO).
__device__ __forceinline__ uint64_t desc_b(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) | (static_cast<uint64_t>(256 >> 4) << 32);
}

// One 8 x 8 block of 16-bit values per lane group, four per instruction:
// read as rows of the raw tile (8 pixels of one channel), transposed into
// rows of the transposed tile (8 channels of one pixel).
__device__ __forceinline__ void transpose_x4(uint32_t from, uint32_t to) {
  uint32_t r0, r1, r2, r3;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(from));
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};" ::"r"(to),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

// Where in its loaded row (of PX pixels) the pixel w0 - 1 of h row hh lies:
// rows are boxes of whole 16-byte units, w0 - 8 .. w0 + 71 under the rows
// map; under the lanes map a row starts at hh * wdim, so the box starts at
// the multiple of 8 lanes at or below hh * wdim + w0 - 1.
__device__ __forceinline__ int row_skew(const Params& p, int hh, int w0) {
  return p.lanes_map ? ((hh * p.wdim + w0 - 1) & 7) : 7;
}

// One complete output slice of this warpgroup's RW rows: + bias, bf16,
// through the staging tile, 16 channels at a time (N 24: the second pass
// holds 8); TILED: the block's N tile is output channels co0 .. co0 +
// cout_t - 1, at y's full channel stride p.cout. The unguarded instances'
// epilogue: a guarded launch takes store_slice_guarded, so the lanes-map
// branch below runs for none (kept so that these instances' code is as it
// was).
template <int N, int RW, bool FOLD, bool TILED>
__device__ __forceinline__ void store_slice(const float (&acc)[RW][N / 2], const Params& p,
                                           uint16_t* stg, int wg, int b, int d, int h0,
                                           int w0) {
  const int co0 = TILED ? static_cast<int>(blockIdx.x % p.n_tiles) * N : 0;
  const int cout_t = TILED ? min(N, p.cout - co0) : p.cout;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, gid = lane / 4, tig = lane % 4;
  const long long hw = static_cast<long long>(p.h) * p.wdim;
  uint16_t* out = reinterpret_cast<uint16_t*>(p.y);
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int hh = h0 + wg * RW + r;
#pragma unroll
    for (int pass = 0; pass < (N + 15) / 16; ++pass) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        if (2 * pass + jj >= N / 8) continue;  // N 24: the last pass's second 8 columns
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int px = warp * 16 + gid + 8 * (i >> 1);
          const int chl = jj * 8 + 2 * tig + (i & 1);
          const int co = pass * 16 + chl;
          float v = acc[r][4 * (2 * pass + jj) + i] +
                    (co < cout_t ? __ldg(&p.bias[co0 + co]) : 0.f);
          if (w0 + px >= p.wdata) v = 0.f;  // guard columns (and past the row)
          stg[chl * EPI_STRIDE + px] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
        }
      }
      named_sync(1 + wg, 128);
      const int chl = tid / 8, seg = tid % 8;
      const int co = pass * 16 + chl, ww = w0 + seg * 8;
      if (FOLD) {
        // 8 consecutive w4 of phase ph: pixels w0 + 32g + 4k + ph
        const int ph = seg >> 1, g = seg & 1, w4 = w0 / 4 + 8 * g, w4dim = p.wdim / 4;
        if (hh < p.h && co < cout_t && w4 < w4dim) {
          const uint16_t* src = stg + chl * EPI_STRIDE + 32 * g + ph;
          uint4 v;
          v.x = src[0] | (static_cast<uint32_t>(src[4]) << 16);
          v.y = src[8] | (static_cast<uint32_t>(src[12]) << 16);
          v.z = src[16] | (static_cast<uint32_t>(src[20]) << 16);
          v.w = src[24] | (static_cast<uint32_t>(src[28]) << 16);
          uint16_t* dst = out + ((static_cast<long long>(b) * p.dout + d) * 4 * p.cout +
                                 ph * p.cout + co0 + co) * (hw / 4) +
                          static_cast<long long>(hh) * w4dim + w4;
          *reinterpret_cast<uint4*>(dst) = v;
        }
      } else if (hh < p.h && co < cout_t && ww < p.wdim) {
        const uint16_t* src = stg + chl * EPI_STRIDE + seg * 8;
        uint16_t* dst = out + ((static_cast<long long>(b) * p.dout + d) * p.cout + co0 + co) * hw +
                        static_cast<long long>(hh) * p.wdim + ww;
        if (!p.lanes_map) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
#pragma unroll
          for (int k = 0; k < 8; ++k)
            if (ww + k < p.wdim) dst[k] = src[k];
        }
      }
      named_sync(1 + wg, 128);
    }
  }
}

// Lanes [a, e) of one 16-byte unit (0 <= a < e <= 8, not the whole unit),
// src and dst at the unit's start: the widest stores their alignment allows.
__device__ __forceinline__ void store_part(const uint16_t* src, uint16_t* dst, int a, int e) {
  while (a < e) {
    if ((a & 3) == 0 && a + 4 <= e) {
      *reinterpret_cast<uint2*>(dst + a) = *reinterpret_cast<const uint2*>(src + a);
      a += 4;
    } else if ((a & 1) == 0 && a + 2 <= e) {
      *reinterpret_cast<uint32_t*>(dst + a) = *reinterpret_cast<const uint32_t*>(src + a);
      a += 2;
    } else {
      dst[a] = src[a];
      ++a;
    }
  }
}

// Whether the guarded epilogue's staging holds a shape's spans (GUARD):
// 2 * RW = `rows` rows of even width wdim; 16 channels a pass at RW 1, 8 at
// RW 2, the lanes of a span from its start's lane mod 8 (at most 6). The
// block's rows are one span (both warpgroups' staging tiles) where it owns
// every column of them (one data tile a row, at least 64 columns), else a
// row's columns are one (a warpgroup's tile): all columns of a one-tile row,
// the last tile's 64 + its guards of a longer one.
__host__ __device__ constexpr int round8(int x) { return (x + 7) & ~7; }

__host__ __device__ constexpr int guard_cpp(int rows) { return rows == 2 ? 16 : 8; }

__host__ __device__ constexpr bool guard_merged(int rows, int wdim, int cols) {
  return cols == wdim && cols >= TILE_W &&
         guard_cpp(rows) * round8(rows * wdim + 6) <= CONSUMERS * (EPI_BYTES / 2);
}

bool guard_staging_fits(int rows, int wdim, int wguard) {
  const int tiles = (wdim - wguard + TILE_W - 1) / TILE_W;
  const int cols = wdim - TILE_W * (tiles - 1);  // the last data tile's columns
  return wdim % 2 == 0 &&
         (guard_merged(rows, wdim, cols) ||
          guard_cpp(rows) * round8(6 + (cols > TILE_W ? cols : TILE_W)) <= EPI_BYTES / 2);
}

// store_slice on a guarded layout (GUARD; the header's epilogue). The block
// writes, of each of its rows, columns [w0, w0 + cols): its tile's 64 (those
// at or past wdata zero), and at a row's last data tile the row's guard
// columns after them (zero). The bias is in the accumulators' start value
// (init_acc_bias). Where guard_merged, the block's ROWS rows are one span of the
// channel plane, staged and stored by all 256 threads (barrier 4); else each
// warpgroup stores a span a row (barrier 1 + wg). A span is `len` lanes from
// lane s_lane, staged at [channel][off + i], off = s_lane mod 8, `stride`
// lanes a channel (at least off + 64: the fill writes all 64 pixels of a
// row, those past `cols` into lanes no store reads), CPP channels a pass. A
// channel plane starts 16-byte aligned ((H*wdim) % 8 == 0), so a lane's
// alignment in y is its alignment in the span; the store gives a channel's
// 16-byte units to 2^lg threads, at most two each.
template <int N, int RW, bool TILED>
__device__ __forceinline__ void store_slice_guarded(const float (&acc)[RW][N / 2],
                                                   const Params& p, uint16_t* stg, int wg, int b,
                                                   int d, int h0, int w0) {
  constexpr int ROWS = CONSUMERS * RW;
  constexpr int CAP = EPI_BYTES / 2;  // staging lanes of a warpgroup
  constexpr int CPP = guard_cpp(ROWS);
  const int co0 = TILED ? static_cast<int>(blockIdx.x % p.n_tiles) * N : 0;
  const int cout_t = TILED ? min(N, p.cout - co0) : p.cout;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, gid = lane / 4, tig = lane % 4;
  const int hw = p.h * p.wdim;
  const int cols = (w0 + TILE_W >= p.wdata ? p.wdim : w0 + TILE_W) - w0;  // columns a row
  const int extra = cols - TILE_W;  // guards past the 64 (at most 8)
  const bool merged = w0 == 0 && guard_merged(ROWS, p.wdim, cols);
  const int nth = merged ? 2 * 128 : 128;  // threads storing a span
  const int t = merged ? static_cast<int>(threadIdx.x) : tid;
  uint16_t* const base = merged ? stg - wg * CAP : stg;
  const int bar = merged ? 4 : 1 + wg;
  const int h_first = merged ? h0 : h0 + wg * RW;
  const int lg = (merged ? 8 : 7) - (CPP == 16 ? 4 : 3);  // log2 of nth / CPP
  const int sc = t >> lg, su = t & ((1 << lg) - 1);
#pragma unroll 1
  for (int r0 = 0; r0 < (merged ? 1 : RW); ++r0) {
    const int rows = merged ? min(ROWS, p.h - h0) : (h_first + r0 < p.h ? 1 : 0);
    if (rows <= 0) break;  // the tile's rows past H: nothing to store
    const int s_lane = (h_first + r0) * p.wdim + w0;
    const int len = rows * cols;
    const int off = s_lane & 7;
    const int stride = round8(off + max(len, TILE_W));
    const int units = (off + len + 7) >> 3;
    uint16_t* const row_out = reinterpret_cast<uint16_t*>(p.y) +
                              ((static_cast<long long>(b) * p.dout + d) * p.cout + co0) * hw +
                              (s_lane - off);
#pragma unroll
    for (int pass = 0; pass < (N + CPP - 1) / CPP; ++pass) {
#pragma unroll
      for (int j = 0; j < CPP / 8 && pass * CPP / 8 + j < N / 8; ++j) {
        const int nb = pass * CPP / 8 + j;
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const int rr = merged ? wg * RW + r : r - r0;
          if ((!merged && r != r0) || rr >= rows) continue;
          uint16_t* const row = base + j * 8 * stride + off + rr * cols;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int px = warp * 16 + gid + 8 * (i >> 1);
            const int c = 2 * tig + (i & 1);
            const float v = w0 + px < p.wdata ? acc[r][4 * nb + i] : 0.f;
            row[c * stride + px] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
          }
          if (warp == 3 && gid < extra) {  // the row's guard columns past the 64
            row[2 * tig * stride + TILE_W + gid] = 0;
            row[(2 * tig + 1) * stride + TILE_W + gid] = 0;
          }
        }
      }
      named_sync(bar, nth);
      if (sc < cout_t - pass * CPP) {
        const uint16_t* src = base + sc * stride;
        uint16_t* dst = row_out + static_cast<long long>(pass * CPP + sc) * hw;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          // the second round from the last thread down: the span's two
          // partial units go to two threads
          const int u = m ? (2 << lg) - 1 - su : su;
          if (u < units) {
            const int a = max(off - 8 * u, 0), e = min(off + len - 8 * u, 8);
            if (a == 0 && e == 8) {
              *reinterpret_cast<uint4*>(dst + 8 * u) = *reinterpret_cast<const uint4*>(src + 8 * u);
            } else {
              store_part(src + 8 * u, dst + 8 * u, a, e);
            }
          }
        }
      }
      named_sync(bar, nth);
    }
  }
}

// GUARD: an output slice's accumulators before its first product hold the
// bias of each channel (added first, not after the sums: the epilogue then
// issues no load; the f32 sums round in another order than the unguarded
// kernel's, within its bound).
template <int N, int RW, bool TILED>
__device__ __forceinline__ void init_acc_bias(float (&a)[RW][N / 2], const Params& p) {
  const int co0 = TILED ? static_cast<int>(blockIdx.x % p.n_tiles) * N : 0;
  const int cout_t = TILED ? min(N, p.cout - co0) : p.cout;
  const int tig = threadIdx.x % 4;
#pragma unroll
  for (int nb = 0; nb < N / 8; ++nb)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int co = nb * 8 + 2 * tig + q;
      const float v = co < cout_t ? __ldg(&p.bias[co0 + co]) : 0.f;
#pragma unroll
      for (int r = 0; r < RW; ++r) a[r][4 * nb + q] = a[r][4 * nb + 2 + q] = v;
    }
#pragma unroll
  for (int r = 0; r < RW; ++r) hold(a[r]);
}

// A block's constants, as the consumer warps use them.
struct Block {
  int e_lo, e_hi, b, h0, w0, warp, lane;
  uint32_t ring, xt, wsm, bars;
  uint16_t* stg;
  const CUtensorMap* tmap;
  const CUtensorMap* side;  // FOLD: the map of the 8-w4 neighbour boxes
  int j_end;  // the last input slice the block loads
};

// The next (input slice, 16-channel chunk) to load; thread 0 keeps it.
struct Loader {
  int j, c;
};

// Thread 0: TMA of the loader's (slice, chunk) into ring stage `stage`, one
// box per h row, then the loader moves on. Each row's box starts at the
// multiple of 8 pixels at or below the pixel output pixel w0 reads at
// kw = 0 (TMA takes an innermost start of whole 16-byte units only).
template <int ROWS, bool FOLD>
__device__ __forceinline__ void load_stage(const Params& p, const Block& k, Loader& ld,
                                           int stage) {
  constexpr int STAGE_BYTES = (ROWS + 2) * ROW_BYTES;
  const uint32_t full = k.bars + 8 * stage;
  const uint32_t dst = k.ring + stage * STAGE_BYTES;
  mbar_expect_tx(full, STAGE_BYTES);
  if (FOLD) {  // three boxes: all rows and phases, then pixels w0-1 and w0+64
    constexpr int MAIN = (ROWS + 2) * FOLD_MAIN_ROW, SIDE = (ROWS + 2) * FOLD_SIDE_ROW;
    const int w4 = k.w0 / 4, bd = k.b * p.din + ld.j;
    tma_load_5d(dst, k.tmap, full, w4, ld.c * CK, k.h0 - 1, 0, bd);
    tma_load_5d(dst + MAIN, k.side, full, w4 - 8, ld.c * CK, k.h0 - 1, 3, bd);
    tma_load_5d(dst + MAIN + SIDE, k.side, full, w4 + 16, ld.c * CK, k.h0 - 1, 0, bd);
  } else {
#pragma unroll
    for (int rr = 0; rr < ROWS + 2; ++rr) {
      const int hh = k.h0 - 1 + rr;
      if (p.lanes_map) {
        const int s0 = hh * p.wdim + k.w0 - 1;
        tma_load_4d(dst + rr * ROW_BYTES, k.tmap, full, s0 - (s0 & 7), ld.c * CK, ld.j, k.b);
      } else {
        tma_load_5d(dst + rr * ROW_BYTES, k.tmap, full, k.w0 - 8, hh, ld.c * CK, ld.j, k.b);
      }
    }
  }
  if (++ld.c == p.chunks) {
    ld.c = 0;
    ++ld.j;
  }
}

// Where a consumer warp is in the ring: stage, its phase, transposed tile.
struct Pipe {
  int stage;
  uint32_t phase;
  int tbuf;
};

// Lane `lane`'s rows of transpose block q of a stage: the raw row it reads
// (16 bytes: 8 pixels of one channel) and the transposed row it writes (one
// pixel's 8 channels); block q is (row, channel half, 8-pixel group pg).
template <int ROWS, bool FOLD>
__device__ __forceinline__ void xpose_rows(uint32_t rs, uint32_t xs, int q, int i,
                                           uint32_t& from, uint32_t& to) {
  constexpr int PLANE = (ROWS + 2) * PX * 16;
  const int pg = q % (PX / 8), half = (q / (PX / 8)) % 2, rr = q / (2 * (PX / 8));
  const int ch = half * 8 + i;
  int px = pg * 8 + i;  // transposed pixel index: pixel w0 - 8 + px
  if (!FOLD) {
    from = rs + ((rr * CK + ch) * PX + pg * 8) * 2;
  } else if (pg == 0) {  // left box, w4 w0/4-8+i of phase 3: pixel w0-1 at i = 7
    from = rs + (ROWS + 2) * FOLD_MAIN_ROW + (rr * CK + ch) * 16;
  } else if (pg == PX / 8 - 1) {  // right box, phase 0 from w4 w0/4+16: pixel w0+64 at i = 0
    from = rs + (ROWS + 2) * (FOLD_MAIN_ROW + FOLD_SIDE_ROW) + (rr * CK + ch) * 16;
    px = 72 + i;
  } else {  // main box, w4 w0/4 + 8g + i of phase ph: pixel w0 + 32g + 4i + ph
    const int ph = (pg - 1) >> 1, g = (pg - 1) & 1;
    from = rs + (((ph * (ROWS + 2) + rr) * CK + ch) * 16 + g * 8) * 2;
    px = 8 + 32 * g + 4 * i + ph;
  }
  to = xs + half * PLANE + (rr * PX + px) * 16;
}

// The stage's raw tile [row][channel][pixel] at rs into the transposed tile
// [channel half][row][pixel][8 channels] at xs, by all 8 consumer warps;
// block q of an op is (row, channel half, 8-pixel group).
template <int ROWS, bool FOLD>
__device__ __forceinline__ void xpose_stage(const Block& k, uint32_t rs, uint32_t xs) {
  constexpr int XPOSE_OPS = (ROWS + 2) * 2 * (PX / 8) / 4;
  for (int op = k.warp; op < XPOSE_OPS; op += CONSUMERS * 4) {
    uint32_t from, to;
    xpose_rows<ROWS, FOLD>(rs, xs, op * 4 + k.lane / 8, k.lane % 8, from, to);
    transpose_x4(from, to);
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Step j of a block's d walk: input slice j (all its 16-channel stages)
// into the three outputs it feeds, e = j + 1 - kd held in accumulator
// (ROT - kd) mod 3, ROT = the step's index mod 3; then output j - 1, complete,
// is stored and its accumulator zeroed for output j + 2.
template <int N, int RW, bool FOLD, int MODE, int ROT, bool TILED, bool GUARD>
__device__ __forceinline__ void step(float (&acc)[3][RW][N / 2], const Params& p,
                                     const Block& k, Pipe& pipe, Loader& ld, int j) {
  constexpr int ROWS = CONSUMERS * RW;
  constexpr int STAGE_BYTES = (ROWS + 2) * ROW_BYTES;
  constexpr int PLANE = (ROWS + 2) * PX * 16;
  constexpr int BLOCK_B = N * 32;
  // MODE_CENTRE: every tap reads the unshifted pixel (kh = kw = 1)
  constexpr bool CENTRE = MODE == MODE_CENTRE;
  const int wg = k.warp / 4;
  if (j >= 0 && j < p.din) {
    for (int c = 0; c < p.chunks; ++c) {
      uint32_t xs = k.xt;  // MODE_FIXED: the one tile transposed before the walk
      if constexpr (MODE != MODE_FIXED) {
        mbar_wait(k.bars + 8 * pipe.stage, pipe.phase);
        xs = k.xt + pipe.tbuf * 2 * PLANE;
        xpose_stage<ROWS, FOLD>(k, k.ring + pipe.stage * STAGE_BYTES, xs);
        named_sync(3, CONSUMERS * 128);
        // every warp is done with the raw tile: refill its stage, `stages`
        // loads ahead of the products
        if (threadIdx.x == 0 && ld.j <= k.j_end) load_stage<ROWS, FOLD>(p, k, ld, pipe.stage);
        if (++pipe.stage == p.stages) {
          pipe.stage = 0;
          pipe.phase ^= 1;
        }
      }
      __syncwarp();
      wgmma_fence();
      // all three taps, also where e = j + 1 - kd lies outside the segment:
      // such an output is never stored and its accumulator is zeroed before
      // reuse, and a branch here would serialise the wgmma pipeline
#pragma unroll
      for (int kd = 0; kd < 3; ++kd) {
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int kh = CENTRE ? 1 : tap / 3, kw = CENTRE ? 1 : tap % 3;
          const uint64_t bd = desc_b(k.wsm + ((kd * 9 + tap) * p.chunks + c) * BLOCK_B);
          // output pixel m reads pixel w0 + m + kw - 1: transposed row
          // skew + kw + m of its h row
#pragma unroll
          for (int r = 0; r < RW; ++r) {
            const int rr = wg * RW + r + kh;
            const int skew = row_skew(p, k.h0 - 1 + rr, k.w0);
            wgmma_tile<N>(acc[(ROT - kd + 3) % 3][r],
                          desc_a(xs + (rr * PX + skew + kw) * 16, PLANE), bd);
          }
        }
      }
      wgmma_commit_wait();
#pragma unroll
      for (int s = 0; s < 3; ++s)
#pragma unroll
        for (int r = 0; r < RW; ++r) hold(acc[s][r]);
      if constexpr (MODE != MODE_FIXED) pipe.tbuf ^= 1;
    }
  }
  constexpr int DONE = (ROT + 1) % 3;  // output j - 1's accumulator (kd = 2)
  const int e = j - 1;
  if (e >= k.e_lo && e <= k.e_hi) {
    if constexpr (GUARD)
      store_slice_guarded<N, RW, TILED>(acc[DONE], p, k.stg, wg, k.b, e - p.shift, k.h0, k.w0);
    else
      store_slice<N, RW, FOLD, TILED>(acc[DONE], p, k.stg, wg, k.b, e - p.shift, k.h0, k.w0);
  }
  __syncwarp();
  if constexpr (GUARD) {
    init_acc_bias<N, RW, TILED>(acc[DONE], p);  // here, not inside the next products
  } else {
#pragma unroll
    for (int r = 0; r < RW; ++r) {
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[DONE][r][i] = 0.f;
      hold(acc[DONE][r]);  // zeroed here, not inside the next products
    }
  }
}

template <int N, int RW, bool FOLD, int MODE, bool TILED, bool GUARD>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap tmap,
                     const __grid_constant__ CUtensorMap side, const Params p) {
  constexpr int ROWS = CONSUMERS * RW;  // output h rows per block
  constexpr int STAGE_BYTES = (ROWS + 2) * ROW_BYTES;  // raw: [row][16 ch][PX]
  constexpr int PLANE = (ROWS + 2) * PX * 16;  // transposed: [8-ch half][row][PX][8 ch]

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + SLACK - 1) & ~static_cast<uint32_t>(SLACK - 1);
  const uint32_t xt = ring + p.stages * STAGE_BYTES;  // two transposed tiles
  const uint32_t wsm = xt + 2 * 2 * PLANE;
  const uint32_t epi = wsm + p.wbytes;
  const uint32_t bars = epi + CONSUMERS * EPI_BYTES;
  const uint32_t wbar = bars + 8 * MAX_STAGES;

  int blk = blockIdx.x;  // (b, segment, w tile, h tile[, N tile]), the fastest last
  const int nt = TILED ? blk % p.n_tiles : 0;
  if (TILED) blk /= p.n_tiles;
  const int ht = blk % p.tiles_h;
  blk /= p.tiles_h;
  const int wt = blk % p.tiles_w;
  blk /= p.tiles_w;
  const int seg = blk % p.segments;
  const int b = blk / p.segments;
  const int h0 = ht * ROWS, w0 = wt * TILE_W;
  const int d_lo = seg * p.seg_len;
  const int d_hi = min(d_lo + p.seg_len, p.dout);       // outputs [d_lo, d_hi)
  const int e_lo = d_lo + p.shift, e_hi = d_hi - 1 + p.shift;  // input coordinates

  const int warp = __shfl_sync(0xffffffff, static_cast<int>(threadIdx.x / 32), 0);
  Block blk_ctx;
  blk_ctx.e_lo = e_lo;
  blk_ctx.e_hi = e_hi;
  blk_ctx.b = b;
  blk_ctx.h0 = h0;
  blk_ctx.w0 = w0;
  blk_ctx.warp = warp;
  blk_ctx.lane = threadIdx.x % 32;
  blk_ctx.ring = ring;
  blk_ctx.xt = xt;
  blk_ctx.wsm = wsm;
  blk_ctx.bars = bars;
  blk_ctx.stg = reinterpret_cast<uint16_t*>(smem_raw + (epi - raw)) + (warp / 4) * (EPI_BYTES / 2);
  blk_ctx.tmap = &tmap;
  blk_ctx.side = &side;
  blk_ctx.j_end = min(e_hi + 1, p.din - 1);
  Loader ld = {max(e_lo - 1, 0), 0};

  // thread 0: the barriers (stage s full: one arrival and the TMA bytes),
  // the weights, and the ring's first `stages` loads (MODE_FIXED: chunk 0
  // of input slice 0, once)
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) mbar_init(bars + 8 * s, 1);
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(wbar, p.wbytes);
    for (int off = 0; off < p.wbytes; off += WCHUNK)
      bulk_load(wsm + off, p.w + static_cast<long long>(nt) * p.wbytes + off,
                min(WCHUNK, p.wbytes - off), wbar);
    if constexpr (MODE == MODE_FIXED) {
      Loader first = {0, 0};
      load_stage<ROWS, FOLD>(p, blk_ctx, first, 0);
    } else {
      for (int s = 0; s < p.stages && ld.j <= blk_ctx.j_end; ++s)
        load_stage<ROWS, FOLD>(p, blk_ctx, ld, s);
    }
  }
  __syncthreads();

  float acc[3][RW][N / 2];
  if constexpr (GUARD) {
#pragma unroll
    for (int k = 0; k < 3; ++k) init_acc_bias<N, RW, TILED>(acc[k], p);
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int i = 0; i < N / 2; ++i) acc[k][r][i] = 0.f;

#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int r = 0; r < RW; ++r) hold(acc[k][r]);
  }

  mbar_wait(wbar, 0);
  if constexpr (MODE == MODE_FIXED) {  // the walk's one tile, transposed once
    mbar_wait(bars, 0);
    xpose_stage<ROWS, FOLD>(blk_ctx, ring, xt);
    named_sync(3, CONSUMERS * 128);
  }
  Pipe pipe = {0, 0, 0};
  // three steps per trip, so that which accumulator holds which output is
  // known at compile time (no register copies between steps)
  for (int j = e_lo - 1; j <= e_hi + 1; j += 3) {
    step<N, RW, FOLD, MODE, 0, TILED, GUARD>(acc, p, blk_ctx, pipe, ld, j);
    if (j + 1 <= e_hi + 1)
      step<N, RW, FOLD, MODE, 1, TILED, GUARD>(acc, p, blk_ctx, pipe, ld, j + 1);
    if (j + 2 <= e_hi + 1)
      step<N, RW, FOLD, MODE, 2, TILED, GUARD>(acc, p, blk_ctx, pipe, ld, j + 2);
  }
}

// Errors of the launchers' own, beside cudaError_t's (kernel_error_string).
constexpr int ERR_PLAN = -1;      // the plan does not fit the kernel
constexpr int ERR_ENTRY = -2;     // cuTensorMapEncodeTiled not found
constexpr int ERR_TENSORMAP = -3;  // the tensor map was refused

const char* wgmma_error_string(int code) {
  if (code == ERR_PLAN) return "the launch plan does not fit the wgmma conv kernel";
  if (code == ERR_ENTRY) return "cuTensorMapEncodeTiled not found in the driver";
  if (code == ERR_TENSORMAP) return "cuTensorMapEncodeTiled refused the tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int smem_bytes(int rows, int stages, int wbytes) {
  return SLACK + (stages + 2) * (rows + 2) * ROW_BYTES + wbytes + CONSUMERS * EPI_BYTES +
         BAR_BYTES;
}

// One launch: its tensor maps, parameters, grid and shared memory.
struct Launch {
  CUtensorMap map, side;
  Params p;
  int grid, smem;
};

// Check a plan (the numbers of conv_wgmma.py:wgmma_plan) and encode its
// launch into L. x: (B, Din, Cin, H*wdim) bf16, contiguous, 16-byte aligned
// (fold: the folded (B, Din, 4*Cin, H*wdim/4), wdim = W); wimg: the weight
// image of conv_wgmma.py:weight_image (n_tiles * 27 * cin_pad * n bf16);
// bias: (Cout,) f32; y: (B, Dout, Cout, H*wdim) bf16 (fold: folded). Returns
// 0 or one of the ERR_ codes.
int prepare(Launch& L, const void* x, const void* wimg, const void* bias, void* y, int B,
            int din, int dout, int shift, int cin, int cout, int h, int wdim, int wguard,
            int lanes_map, int fold, int n, int cin_pad, int rows, int stages, int seg_len,
            int segments, int n_tiles) {
  const int chunks = cin_pad / CK;
  const int wbytes = 27 * cin_pad * n * 2;
  const int smem = smem_bytes(rows, stages, wbytes);
  // N 24 (rows 2), 32, 64, 96 in one tile; N 72 in n_tiles >= 1; none folded but 32-96
  const bool n_ok = n == 72 ? n_tiles >= 1 && !fold
                            : n_tiles == 1 && (n == 24 ? rows == 2 && !fold
                                                       : n == 32 || n == 64 || n == 96);
  const bool ok = n_ok && cout > (n_tiles - 1) * n && cout <= n_tiles * n &&
                  cin >= 1 && cin_pad % CK == 0 && cin_pad >= cin && cin_pad < cin + CK &&
                  (rows == 2 || (rows == 4 && n == 32)) && stages >= 2 &&
                  stages <= MAX_STAGES && smem <= SMEM_LIMIT && seg_len >= 1 &&
                  segments >= 1 && (segments - 1) * seg_len < dout && segments * seg_len >= dout &&
                  wguard >= 0 && wguard < wdim && wguard <= MAX_GUARD && (h * wdim) % 8 == 0 &&
                  (wguard == 0 || guard_staging_fits(rows, wdim, wguard)) &&
                  (lanes_map ? wguard >= 1 : wdim % 8 == 0) &&
                  (!fold || (wdim % 32 == 0 && wguard == 0 && !lanes_map)) &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(wimg) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (!ok) return ERR_PLAN;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return ERR_ENTRY;

  CUtensorMap& map = L.map;
  CUtensorMap& side = L.side;
  const cuuint64_t hw = static_cast<cuuint64_t>(h) * wdim;
  CUresult rc;
  if (fold) {
    // (W/4, Cin, H, 4 phases, B*Din): main box (16, 16, rows+2, 4), side box
    // (8, 16, rows+2, 1)
    const cuuint64_t w4 = wdim / 4, hw4 = hw / 4;
    const cuuint64_t dims[5] = {w4, static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(h), 4,
                                static_cast<cuuint64_t>(B) * din};
    const cuuint64_t strides[4] = {hw4 * 2, w4 * 2, hw4 * cin * 2, hw4 * cin * 4 * 2};
    const cuuint32_t box[5] = {16, CK, static_cast<cuuint32_t>(rows + 2), 4, 1};
    const cuuint32_t sbox[5] = {8, CK, static_cast<cuuint32_t>(rows + 2), 1, 1};
    const cuuint32_t estr[5] = {1, 1, 1, 1, 1};
    rc = encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(x), dims, strides,
                box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (rc == CUDA_SUCCESS)
      rc = encode(&side, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(x), dims,
                  strides, sbox, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  } else if (lanes_map) {
    const cuuint64_t dims[4] = {hw, static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(din),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[3] = {hw * 2, hw * cin * 2, hw * cin * din * 2};
    const cuuint32_t box[4] = {PX, CK, 1, 1};
    const cuuint32_t estr[4] = {1, 1, 1, 1};
    rc = encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides,
                box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  } else {
    const cuuint64_t dims[5] = {static_cast<cuuint64_t>(wdim), static_cast<cuuint64_t>(h),
                                static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(din),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[4] = {static_cast<cuuint64_t>(wdim) * 2, hw * 2, hw * cin * 2,
                                   hw * cin * din * 2};
    const cuuint32_t box[5] = {PX, 1, CK, 1, 1};
    const cuuint32_t estr[5] = {1, 1, 1, 1, 1};
    rc = encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(x), dims, strides,
                box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
  if (rc != CUDA_SUCCESS) return ERR_TENSORMAP;
  if (!fold) side = map;  // unread

  Params& p = L.p;
  p.w = static_cast<const uint8_t*>(wimg);
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.din = din;
  p.dout = dout;
  p.shift = shift;
  p.cin = cin;
  p.cout = cout;
  p.h = h;
  p.wdim = wdim;
  p.wdata = wdim - wguard;
  p.lanes_map = lanes_map;
  p.chunks = chunks;
  p.stages = stages;
  p.seg_len = seg_len;
  p.segments = segments;
  p.tiles_h = (h + rows - 1) / rows;
  p.tiles_w = (p.wdata + TILE_W - 1) / TILE_W;  // data columns only (GUARD: the header)
  p.wbytes = wbytes;
  p.n_tiles = n_tiles;
  const long long grid = static_cast<long long>(B) * segments * p.tiles_w * p.tiles_h * n_tiles;
  if (grid < 1 || grid > 0x7fffffff) return ERR_PLAN;
  L.grid = static_cast<int>(grid);
  L.smem = smem;
  return 0;
}

template <int N, int RW, bool FOLD, int MODE, bool TILED = false, bool GUARD = false>
int launch(const Launch& L, cudaStream_t stream) {
  auto kernel = conv3x3_wgmma_kernel<N, RW, FOLD, MODE, TILED, GUARD>;
  cudaError_t rc =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<L.grid, THREADS, L.smem, stream>>>(L.map, L.side, L.p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
