// The bf16 3x3x3 SAME conv + bias on the packed layout (B, Din, Cin, H*wdim)
// -> (B, Dout, Cout, H*wdim) for Hopper: TMA loads into a shared-memory ring,
// two warpgroups on wgmma.mma_async (bf16 in, f32 accumulate), the whole
// weight resident in shared memory.
//
// Replaces unet_bssfp_tpu/ops/pallas/conv3d.py:_conv_fwd_impl (kernel bodies
// _conv_kernel / _conv_kernel_kstack, reached through conv3x3_packed, its VJP's
// dx, conv3x3_packed_halo and its VJP's dx, with and without wguard) on the
// bf16 routes of the port: K1, K1's dgrad, K5 and K5's dgrad
// (ops/kernels/conv3d.py). The d geometry is conv3x3_packed.cu's: output
// slice d reads input slices d + kd - 1 + shift, one outside [0, Din) reading
// as zero (SAME: Din = Dout, shift 0; halo: Din = Dout + 2, shift +1; the
// halo dgrad: Dout = Din + 2, shift -1). The launch plan (tile, ring depth,
// shared memory, d segments, grid) is made in Python
// (ops/kernels/conv_wgmma.py:wgmma_plan) and checked here.
//
// Bound on an H100: 2*27*Cin*Cout operations per output voxel against
// (Cin + Cout) * 2 bytes, 370-650 per byte at the generator's stages
// (24/32/96 -> 32 and their dgrads 32 -> 24/32/96): above the bf16 ridge
// (~295), bound by operations. At 96 -> 32, B 8 x 64^3: 348 GFLOP, 0.352 ms.
// The multi-stage backbone's full-resolution convs (24 -> 48, 48 -> 48,
// 144 -> 24, 24 -> 24 and their dgrads) sit at 324-648 per byte: bound by
// operations too, 0.132 / 0.264 / 0.396 / 0.066 ms at B 8 x 64^3.
//
// The kernel, its design, its launch checks and its tensor maps live in
// conv3x3_wgmma.cuh, which probe.cu also compiles (K9b's MODE instances);
// this file builds the conv's own instances (MODE_FULL, packed and FOLD) and
// their entry points.

#include "conv3x3_wgmma.cuh"

namespace {

template <bool FOLD>
int launch_n(int n, int rows, const Launch& L, cudaStream_t s) {
  if (n == 32 && rows == 4) return launch<32, 2, FOLD, MODE_FULL>(L, s);
  if (n == 32) return launch<32, 1, FOLD, MODE_FULL>(L, s);
  if (n == 64) return launch<64, 1, FOLD, MODE_FULL>(L, s);
  return launch<96, 1, FOLD, MODE_FULL>(L, s);
}

// N 24 and the N-72 tiles: packed only (prepare() refuses them folded).
int launch_packed(int n, int rows, const Launch& L, cudaStream_t s) {
  if (n == 24) return launch<24, 1, false, MODE_FULL>(L, s);
  if (n == 72) return launch<72, 1, false, MODE_FULL, true>(L, s);
  return launch_n<false>(n, rows, L, s);
}

// Guard columns (K1W and its dgrad): the GUARD instances, packed only
// (prepare() refuses guards folded).
int launch_guarded(int n, int rows, const Launch& L, cudaStream_t s) {
  if (n == 24) return launch<24, 1, false, MODE_FULL, false, true>(L, s);
  if (n == 72) return launch<72, 1, false, MODE_FULL, true, true>(L, s);
  if (n == 32 && rows == 4) return launch<32, 2, false, MODE_FULL, false, true>(L, s);
  if (n == 32) return launch<32, 1, false, MODE_FULL, false, true>(L, s);
  if (n == 64) return launch<64, 1, false, MODE_FULL, false, true>(L, s);
  return launch<96, 1, false, MODE_FULL, false, true>(L, s);
}

}  // namespace

extern "C" {

// The operands and the plan's numbers (n, cin_pad, rows, stages, seg_len,
// segments, n_tiles: from wgmma_plan) as prepare() in conv3x3_wgmma.cuh
// takes them. Returns 0, a cudaError_t, or one of the ERR_ codes there.
int conv3x3_wgmma_bf16(const void* x, const void* wimg, const void* bias, void* y, int B,
                       int din, int dout, int shift, int cin, int cout, int h, int wdim,
                       int wguard, int lanes_map, int fold, int n, int cin_pad, int rows,
                       int stages, int seg_len, int segments, int n_tiles, void* stream) {
  Launch L;
  const int rc = prepare(L, x, wimg, bias, y, B, din, dout, shift, cin, cout, h, wdim, wguard,
                         lanes_map, fold, n, cin_pad, rows, stages, seg_len, segments, n_tiles);
  if (rc != 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fold) return launch_n<true>(n, rows, L, s);
  return wguard ? launch_guarded(n, rows, L, s) : launch_packed(n, rows, L, s);
}

// The shared memory a launch of this plan takes (the plan's own number is
// held to it by the tests on the card).
int conv3x3_wgmma_smem(int rows, int stages, int cin_pad, int n) {
  return smem_bytes(rows, stages, 27 * cin_pad * n * 2);
}

const char* kernel_error_string(int code) { return wgmma_error_string(code); }

}  // extern "C"
