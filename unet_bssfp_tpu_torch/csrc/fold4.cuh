// The two activation layouts of the 3x3x3 conv kernels, as one index
// function: the element offset of pixel (h, w) of channel c within one
// (b, d) slice of C channels, H * W pixels (HW = H * W).
//
//   packed (FOLD false), (B, D, C, H*W):         c * HW + h * W + w
//   phase-major w-folded (FOLD true), (B, D, 4*C, H*W/4), the layout of
//   unet_bssfp_tpu/ops/pallas/conv3d.py:conv3x3_pfold:
//       xf[b, d, p*C + c, h*(W/4) + w4] = x[b, d, h, 4*w4 + p, c]
//     so pixel (h, w) lies at phase p = w mod 4, lane h*(W/4) + w/4:
//                                                ((w & 3) * C + c) * HW/4 + h * W/4 + (w >> 2)
//
// A slice holds C * HW elements in both, so slice offsets are shared. The
// kernels take the layout as a template parameter and use it only where
// they stage inputs and store outputs: their product loops are one code.

#pragma once

template <bool FOLD>
__device__ __forceinline__ long long pix(int c, int h, int w, int C, long long HW, int W) {
  if (FOLD)
    return (static_cast<long long>((w & 3) * C + c) * (HW >> 2) +
            static_cast<long long>(h) * (W >> 2) + (w >> 2));
  return c * HW + static_cast<long long>(h) * W + w;
}
