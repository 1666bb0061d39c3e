"""K7a and K7b: the 3x3x3 SAME conv + bias on the phase-major w-folded
layout, under autograd, with its halo form.

Replaces ``unet_bssfp_tpu/ops/pallas/conv3d.py::conv3x3_pfold`` and
``conv3x3_pfold_halo`` with their custom VJPs. The folded layout is

    xf (B, D, 4·C, H·W/4),   xf[b, d, p·C + c, h·(W/4) + w4] = x[b, d, h, 4·w4 + p, c],

which :func:`fold4_pack` makes from NDHWC (``w4dim`` = W/4 throughout).

- forward: K7a (``_pfold_fwd_impl``), K1's kernel reading and writing the
  folded tensor in place, so its result is K1's on the same volume bit for
  bit;
- dx: K7a again on ``dy`` with the weight flipped in (kd, kh, kw) and
  transposed in (ci, co), zero bias (:func:`conv3x3_pfold_dgrad`);
- dw: K7b (``_pfold_dw_impl``), K2's kernel on the folded operands, f32
  (:func:`conv3x3_pfold_wgrad`);
- db: ``Σ dy`` in f32 over (b, d, phase, lane).

Which CUDA kernel runs them, static by dtype and shape as for K1 and K2
(:mod:`.conv3d`): in bf16 the wgmma conv kernel (``csrc/conv3x3_wgmma.cu``,
the layout a template parameter ``FOLD``) wherever
:func:`.conv3d.conv_plan` takes the folded shape (W/4 a multiple of 8), and
the wgmma wgrad kernel (``csrc/conv3x3_wgrad_wgmma.cu``, ``FOLD``) wherever
:func:`.conv3d.wgrad_plan` does (W/4 a multiple of 16, Cout ≤ 32); there K7a
is K1's wgmma kernel bit for bit and K7b sums each item's pixels
phase-major, so it is held to K2's bound at its own plan's chain. Any other
bf16 shape runs the ``mma.sync`` loops with the folded layout
(``csrc/fold4.cuh``), each launch counted in
``conv3x3_packed_mma_routed`` / ``conv3x3_wgrad_mma_routed``; f32 runs the
FMA kernels with the folded layout.

The halo form (``pad_d=False``) takes one real d slice of halo per side,
and its three parts are the same kernels at K5's d geometries. The TPU's
sublane pad of odd channel counts (``_pfold_pad_channels``) has no
counterpart: the kernels mask channels by bounds.

``*_plain`` are the same functions in plain PyTorch: they unfold to the
packed layout, call K1's and K2's plain versions and fold back. A CPU tensor
takes them; a CUDA tensor launches the kernel or raises. The JAX package
reaches pfold only from ``scripts/pfold_probe.py`` and its tests; so does
the port (``scripts/torch_port_pfold_probe.py``).
"""

from __future__ import annotations

import torch

from unet_bssfp_tpu_torch.ops.kernels.conv3d import (
    _acc,
    _conv_cuda,
    _flip_t,
    _wgrad_cuda,
    conv3x3_packed_halo_dgrad_plain,
    conv3x3_packed_halo_plain,
    conv3x3_packed_plain,
    conv3x3_wgrad_chain,
    conv3x3_wgrad_halo_plain,
    conv3x3_wgrad_plain,
)
from unet_bssfp_tpu_torch.ops.kernels.layout import pack_hw, unpack_hw

FOLD = 4  # w-fold factor: phases per lane


def pfold_supported(shape) -> bool:
    """Static gate: NDHWC shape (B, D, H, W, C) the pfold kernel takes (the
    JAX package's gate, ``conv3d.py:1048-1055``)."""
    if len(shape) != 5:
        return False
    _, d, h, w, c = shape
    return (w % FOLD == 0 and (h * w // FOLD) % 128 == 0 and w // FOLD >= 2
            and h >= 3 and d >= 1 and FOLD * c <= 512)


def fold4_pack(x: torch.Tensor) -> torch.Tensor:
    """NDHWC (B, D, H, W, C) → folded (B, D, 4·C, H·W/4): K3a on the free
    reshape (B, D, H, W/4, 4·C); differentiable through K3."""
    b, d, h, w, c = x.shape
    if w % FOLD:
        raise ValueError(f"fold4_pack: W={w} is not a multiple of {FOLD}")
    return pack_hw(x.reshape(b, d, h, w // FOLD, FOLD * c))


def unfold4_unpack(xf: torch.Tensor, w4dim: int) -> torch.Tensor:
    """Inverse of :func:`fold4_pack`: K3b, then a free reshape."""
    b, d, fc, lanes = xf.shape
    return unpack_hw(xf, w4dim).reshape(b, d, lanes // w4dim, FOLD * w4dim, fc // FOLD)


def _to_packed(xf: torch.Tensor, w4dim: int) -> torch.Tensor:
    """Folded (B, D, 4·C, H·W/4) → packed (B, D, C, H·W), plain PyTorch."""
    b, d, fc, lanes = xf.shape
    c, h = fc // FOLD, lanes // w4dim
    return (xf.reshape(b, d, FOLD, c, h, w4dim).permute(0, 1, 3, 4, 5, 2)
            .reshape(b, d, c, FOLD * lanes))


def _to_folded(xk: torch.Tensor, wdim: int) -> torch.Tensor:
    """Packed (B, D, C, H·W) → folded (B, D, 4·C, H·W/4), plain PyTorch."""
    b, d, c, hw = xk.shape
    return (xk.reshape(b, d, c, hw // wdim, wdim // FOLD, FOLD).permute(0, 1, 5, 2, 3, 4)
            .reshape(b, d, FOLD * c, hw // FOLD))


def conv3x3_pfold_plain(xf: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                        w4dim: int) -> torch.Tensor:
    """Plain version of K7a: :func:`conv3x3_packed_plain` on the unfolded
    tensor, folded back."""
    wdim = FOLD * w4dim
    return _to_folded(conv3x3_packed_plain(_to_packed(xf, w4dim), w, bias, wdim), wdim)


def conv3x3_pfold_halo_plain(xp: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                             w4dim: int) -> torch.Tensor:
    """Plain version of K7a's halo form: (B, D+2, 4·Cin, H·W/4) → (B, D,
    4·Cout, H·W/4), no d padding."""
    wdim = FOLD * w4dim
    return _to_folded(conv3x3_packed_halo_plain(_to_packed(xp, w4dim), w, bias, wdim), wdim)


def conv3x3_pfold_dgrad_plain(dy: torch.Tensor, w: torch.Tensor,
                              w4dim: int) -> torch.Tensor:
    """Plain version of the dgrad: the conv of ``dy`` with the flipped,
    transposed weight, zero bias."""
    zero = torch.zeros(w.shape[3], dtype=torch.float32, device=dy.device)
    return conv3x3_pfold_plain(dy, _flip_t(w, dy.dtype), zero, w4dim)


def conv3x3_pfold_halo_dgrad_plain(dy: torch.Tensor, w: torch.Tensor,
                                   w4dim: int) -> torch.Tensor:
    """Plain version of the halo dgrad: D+2 slices of dxp from D of dy."""
    wdim = FOLD * w4dim
    return _to_folded(conv3x3_packed_halo_dgrad_plain(_to_packed(dy, w4dim), w, wdim), wdim)


def conv3x3_pfold_wgrad_plain(xf: torch.Tensor, dy: torch.Tensor,
                              w4dim: int) -> torch.Tensor:
    """Plain version of K7b: f32 dw (3, 3, 3, Cin, Cout) by autograd."""
    return conv3x3_wgrad_plain(_to_packed(xf, w4dim), _to_packed(dy, w4dim), FOLD * w4dim)


def conv3x3_pfold_wgrad_halo_plain(xp: torch.Tensor, dy: torch.Tensor,
                                   w4dim: int) -> torch.Tensor:
    """Plain version of K7b's halo form: ``xp`` has D+2 slices, ``dy`` D."""
    return conv3x3_wgrad_halo_plain(_to_packed(xp, w4dim), _to_packed(dy, w4dim),
                                    FOLD * w4dim)


def _dgrad(dy: torch.Tensor, w: torch.Tensor, w4dim: int, halo: bool) -> torch.Tensor:
    wt = _flip_t(w, dy.dtype)
    zero = torch.zeros(wt.shape[4], dtype=torch.float32, device=dy.device)
    fn = conv3x3_pfold_halo_dgrad if halo else conv3x3_pfold_dgrad
    dx = _conv_cuda(dy, wt, zero, w4dim, fn.__name__, grow=2 if halo else 0, fold=True)
    fn.launches += 1
    return dx


def conv3x3_pfold_dgrad(dy: torch.Tensor, w: torch.Tensor, w4dim: int) -> torch.Tensor:
    """dx of :func:`conv3x3_pfold`: K7a on ``dy`` (B, D, 4·Cout, H·W/4) with
    ``w`` flipped and transposed → (B, D, 4·Cin, H·W/4) in ``dy``'s dtype."""
    if dy.device.type == "cpu":
        return conv3x3_pfold_dgrad_plain(dy, w, w4dim)
    return _dgrad(dy, w, w4dim, halo=False)


def conv3x3_pfold_halo_dgrad(dy: torch.Tensor, w: torch.Tensor,
                             w4dim: int) -> torch.Tensor:
    """dxp of :func:`conv3x3_pfold_halo`: D+2 slices from D of ``dy``, a dy
    slice outside [0, D) reading as zero by bounds (no padded copy)."""
    if dy.device.type == "cpu":
        return conv3x3_pfold_halo_dgrad_plain(dy, w, w4dim)
    return _dgrad(dy, w, w4dim, halo=True)


def conv3x3_pfold_wgrad(xf: torch.Tensor, dy: torch.Tensor, w4dim: int) -> torch.Tensor:
    """K7b: f32 dw (3, 3, 3, Cin, Cout) from the folded input and cotangent."""
    if xf.device.type == "cpu":
        return conv3x3_pfold_wgrad_plain(xf, dy, w4dim)
    dw = _wgrad_cuda(xf, dy, w4dim, "conv3x3_pfold_wgrad", halo=0, fold=True)
    conv3x3_pfold_wgrad.launches += 1
    return dw


def conv3x3_pfold_wgrad_halo(xp: torch.Tensor, dy: torch.Tensor, w4dim: int) -> torch.Tensor:
    """K7b's halo form: ``xp`` (B, D+2, 4·Cin, H·W/4), ``dy`` (B, D, 4·Cout,
    H·W/4), no slice skipped."""
    if xp.device.type == "cpu":
        return conv3x3_pfold_wgrad_halo_plain(xp, dy, w4dim)
    dw = _wgrad_cuda(xp, dy, w4dim, "conv3x3_pfold_wgrad_halo", halo=1, fold=True)
    conv3x3_pfold_wgrad_halo.launches += 1
    return dw


def conv3x3_pfold_wgrad_chain(xf: torch.Tensor, dy: torch.Tensor, w4dim: int) -> int:
    """K7b's longest f32 rounding chain for these operands, in the kernel
    they route to: the wgmma wgrad plan's where it takes the folded shape
    (no card needed), else the ``mma.sync`` loop's at the unfolded shape."""
    return conv3x3_wgrad_chain(xf, dy, w4dim, fold=True)


class _Conv3x3Pfold(torch.autograd.Function):
    """The custom VJPs of ``conv3x3_pfold`` (``conv3d.py:971-988``) and
    ``conv3x3_pfold_halo`` (``:1003-1022``)."""

    @staticmethod
    def forward(ctx, xf, w, bias, w4dim, halo):
        ctx.save_for_backward(xf, w)
        ctx.w4dim, ctx.halo, ctx.bias_dtype = w4dim, halo, bias.dtype
        if xf.device.type == "cpu":
            plain = conv3x3_pfold_halo_plain if halo else conv3x3_pfold_plain
            return plain(xf, w, bias, w4dim)
        fn = conv3x3_pfold_halo if halo else conv3x3_pfold
        y = _conv_cuda(xf, w, bias, w4dim, fn.__name__, grow=-2 if halo else 0, fold=True)
        fn.launches += 1
        return y

    @staticmethod
    def backward(ctx, dy):
        xf, w = ctx.saved_tensors
        dy = dy.to(xf.dtype).contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dgrad = conv3x3_pfold_halo_dgrad if ctx.halo else conv3x3_pfold_dgrad
            dx = dgrad(dy, w, ctx.w4dim).to(xf.dtype)
        if ctx.needs_input_grad[1]:
            wgrad = conv3x3_pfold_wgrad_halo if ctx.halo else conv3x3_pfold_wgrad
            dw = wgrad(xf, dy, ctx.w4dim).to(w.dtype)
        if ctx.needs_input_grad[2]:
            b, d, fco, lanes = dy.shape
            db = (dy.to(_acc(dy.dtype)).reshape(b, d, FOLD, fco // FOLD, lanes)
                  .sum(dim=(0, 1, 2, 4)).to(ctx.bias_dtype))
        return dx, dw, db, None, None


def conv3x3_pfold(xf: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                  w4dim: int) -> torch.Tensor:
    """SAME 3x3x3 conv of the folded ``xf`` (B, D, 4·Cin, H·W/4) with ``w``
    (3, 3, 3, Cin, Cout) and ``bias`` (Cout,) → (B, D, 4·Cout, H·W/4) in
    ``xf``'s dtype, differentiable in all three; ``w4dim`` = W/4."""
    return _Conv3x3Pfold.apply(xf, w, bias, w4dim, False)


def conv3x3_pfold_halo(xp: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                       w4dim: int) -> torch.Tensor:
    """:func:`conv3x3_pfold` on an input that carries one d slice of halo
    per side: (B, D+2, 4·Cin, H·W/4) → (B, D, 4·Cout, H·W/4)."""
    return _Conv3x3Pfold.apply(xp, w, bias, w4dim, True)


conv3x3_pfold.launches = 0
conv3x3_pfold_dgrad.launches = 0
conv3x3_pfold_wgrad.launches = 0
conv3x3_pfold_halo.launches = 0
conv3x3_pfold_halo_dgrad.launches = 0
conv3x3_pfold_wgrad_halo.launches = 0
