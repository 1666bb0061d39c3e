"""K1, K2 and K5: the 3x3x3 SAME conv + bias on the packed ``(B, D, C, H·W)``
layout, under autograd, unsharded and d-sharded over a mesh.

Replaces ``unet_bssfp_tpu/ops/pallas/conv3d.py::conv3x3_packed`` and its
custom VJP (``_vjp_bwd``):

- forward: K1 (``_conv_fwd_impl``);
- dx: K1 again, on ``dy`` with the weight flipped in (kd, kh, kw) and
  transposed in (ci, co), zero bias (:func:`conv3x3_packed_dgrad`);
- dw: K2 (``_dw_impl``), f32 (:func:`conv3x3_wgrad`);
- db: ``Σ dy`` in f32.

K5 replaces ``conv3x3_packed_halo`` (the same TPU kernel with
``pad_d=False``) and its VJP ``_halo_vjp_bwd``: the conv on an input that
carries a real one-slice d halo per side, which a d-sharded volume gets from
its neighbours (:func:`conv3x3_packed_auto`): :func:`conv3x3_packed_halo`
forward, :func:`conv3x3_packed_halo_dgrad` (D+2 slices of dx from D of dy,
the out-of-range dy slices being bounds, not a padded copy) and
:func:`conv3x3_wgrad_halo` (K2 at the halo's d geometry).

Which CUDA kernel runs a conv (K1, its dgrad, K5, its dgrad), static by
dtype and shape:

- bf16 → ``csrc/conv3x3_wgmma.cu`` (TMA ring, ``wgmma``, resident weights;
  :mod:`.conv_wgmma` plans the launch), wherever
  :func:`.conv_wgmma.wgmma_plan` takes the shape: W a multiple of 8 or
  guard columns present, the weight (of one N tile: Cout > 96 is cut into
  N tiles, the multi-stage dgrad 24 → 144 into two of 72) resident beside
  a 2-stage ring (N 24 where Cout ≤ 24 and N 32's does not fit: the
  multi-stage 144 → 24). Every shape of the serving, training, multi-stage
  and mesh paths is taken. Any other
  bf16 shape runs the ``mma.sync`` loop of ``csrc/conv3x3_packed.cu``,
  and each such launch adds one to
  ``conv3x3_packed_mma_routed.launches`` besides the wrapper's own count;
- f32 (the gradient-check path) → the FMA kernel of ``conv3x3_packed.cu``.

Which CUDA kernel runs a weight gradient (K2, K5's), the same way:

- bf16 → ``csrc/conv3x3_wgrad_wgmma.cu`` (TMA ring, dy's shifted copies in
  shared memory, ``wgmma``; :mod:`.wgrad_wgmma` plans the launch), wherever
  :func:`wgrad_plan` takes the shape: W a multiple of 8 (Cout in tiles of
  32: the multi-stage Cout 48 takes two). Every shape of the training and
  multi-stage steps and the mesh backward is taken, guarded ones through
  the strip below. Any other bf16 shape (W 35) runs the ``mma.sync``
  loop of ``csrc/conv3x3_wgrad.cu``, and each such launch adds one to
  ``conv3x3_wgrad_mma_routed.launches`` besides the wrapper's own count;
- f32 → the FMA kernel of ``conv3x3_wgrad.cu``.

:func:`conv3x3_packed_mma` and :func:`conv3x3_wgrad_mma` launch the two
``mma.sync`` loops on the packed layout at any d geometry: check-only entry
points (the routed shapes of K7a and K7b are held bit for bit to them,
and the pallas probe times the conv loop beside K9b); nothing on a model
path calls them. Every kernel here takes the
phase-major w-folded layout too (``fold``): K7a and K7b, the pfold conv of
:mod:`.pfold`, route by the same rules, their plans made at the unfolded
shape.

``wguard`` (the JAX package's ``wguard``): the last ``wguard`` columns of
every w-row are zero guard columns. The forward and the dgrad write them as
zero; the backward first zeroes ``dy``'s guard columns (the JAX package's
``_project_guard_cotangent``), in plain torch. The weight gradient (K2W)
runs K2, or K5's wgrad, on the guard-stripped operands ``x[..., :W]`` and
``dy[..., :W]`` at ``W = wdim - wguard`` (:func:`strip_guards`), in both
dtypes. That is the same function: x's guard columns are zero (the layout's
invariant, which the modules keep) and dy's were just zeroed, so no product
with a guard position adds anything, and the zero guard a tap reads at
w = -1 (the previous row's last guard) or at w = W stands where the SAME
padding's zero stands. The stripped shape routes as any such W does (W 64:
the wgmma kernel), so no model path sends a guarded wgrad to the loop.

Each source's header says what bounds it on the card and how it is laid
out. ``*_plain`` are the same functions in plain PyTorch: the CPU path, and
the references the kernels are held to. :func:`conv3x3_packed` is the same
``autograd.Function`` on both devices; what it launches inside picks the
kernel or the plain version by the tensor's device.
"""

from __future__ import annotations

import ctypes
from typing import Mapping, Optional, Union

import torch
import torch.nn.functional as F

from unet_bssfp_tpu_torch.ops.kernels import _build, conv_wgmma, wgrad_wgmma
from unet_bssfp_tpu_torch.parallel.mesh import Mesh, Sharded, gather_batch, place, shard_batch

_DTYPES = (torch.float32, torch.bfloat16)


def packed_supported(shape) -> bool:
    """Static gate: NDHWC shape (B, D, H, W, C) the packed path takes (the
    JAX package's gate, so both packages pick the same branch)."""
    if len(shape) != 5:
        return False
    _, d, h, w, c = shape
    return (h * w) % 128 == 0 and h >= 3 and w >= 3 and d >= 1 and c <= 128


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The plain versions' accumulation dtype: f32, or f64 for f64 operands
    (CPU only: the tests' well-conditioned gradient comparisons)."""
    return torch.promote_types(dtype, torch.float32)


def _conv_plain(xk: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                wdim: int, pad_d: int) -> torch.Tensor:
    b, d, cin, hw = xk.shape
    cout = w.shape[4]
    acc = _acc(xk.dtype)
    x = xk.reshape(b, d, cin, hw // wdim, wdim).permute(0, 2, 1, 3, 4)
    wt = w.to(xk.dtype).to(acc).permute(4, 3, 0, 1, 2)  # (O, I, kd, kh, kw)
    y = F.conv3d(x.to(acc), wt, bias.to(acc), padding=(pad_d, 1, 1))
    return y.permute(0, 2, 1, 3, 4).reshape(b, -1, cout, hw).to(xk.dtype)


def guard_mask(t: torch.Tensor, wdim: int, wguard: int) -> torch.Tensor:
    """``t`` (…, H·wdim) with the last ``wguard`` columns of every w-row
    set to zero (``t`` itself where ``wguard`` is 0)."""
    if not wguard:
        return t
    keep = torch.arange(wdim, device=t.device) < wdim - wguard
    rows = t.reshape(*t.shape[:-1], -1, wdim)
    return torch.where(keep, rows, torch.zeros((), dtype=t.dtype, device=t.device)
                       ).reshape(t.shape)


def strip_guards(t: torch.Tensor, wdim: int, wguard: int) -> torch.Tensor:
    """``t`` (…, H·wdim) without the last ``wguard`` columns of every w-row:
    (…, H·(wdim - wguard)), contiguous (``t`` itself where ``wguard`` is 0)."""
    if not wguard:
        return t
    return t.unflatten(-1, (-1, wdim))[..., :wdim - wguard].flatten(-2).contiguous()


def conv3x3_packed_plain(xk: torch.Tensor, w: torch.Tensor,
                         bias: torch.Tensor, wdim: int, wguard: int = 0) -> torch.Tensor:
    """Plain version: ``w`` rounded to ``xk``'s dtype, f32 products and sums,
    f32 bias, result cast to ``xk``'s dtype (as the TPU kernel does); with
    ``wguard``, the output's guard columns then set to zero."""
    return guard_mask(_conv_plain(xk, w, bias, wdim, 1), wdim, wguard)


def conv3x3_packed_halo_plain(xp: torch.Tensor, w: torch.Tensor,
                              bias: torch.Tensor, wdim: int, wguard: int = 0) -> torch.Tensor:
    """Plain version of K5: as :func:`conv3x3_packed_plain` with no d padding
    (padding (0, 1, 1)): (B, D+2, Cin, H·W) → (B, D, Cout, H·W)."""
    return guard_mask(_conv_plain(xp, w, bias, wdim, 0), wdim, wguard)


def _wgrad_plain(xk: torch.Tensor, dy: torch.Tensor, wdim: int,
                 pad_d: int) -> torch.Tensor:
    cin, cout = xk.shape[2], dy.shape[2]
    acc = _acc(xk.dtype)
    w = torch.zeros((3, 3, 3, cin, cout), dtype=acc, device=xk.device,
                    requires_grad=True)
    zero = torch.zeros(cout, dtype=acc, device=xk.device)
    with torch.enable_grad():
        y = _conv_plain(xk.detach().to(acc), w, zero, wdim, pad_d)
        (dw,) = torch.autograd.grad(y, w, dy.to(acc))
    return dw


def conv3x3_wgrad_plain(xk: torch.Tensor, dy: torch.Tensor,
                        wdim: int) -> torch.Tensor:
    """Plain version of K2: the f32 gradient of :func:`conv3x3_packed_plain`
    with respect to ``w`` (3, 3, 3, Cin, Cout), by autograd, for the
    cotangent ``dy`` (B, D, Cout, H·W)."""
    return _wgrad_plain(xk, dy, wdim, 1)


def conv3x3_wgrad_halo_plain(xp: torch.Tensor, dy: torch.Tensor,
                             wdim: int) -> torch.Tensor:
    """Plain version of the halo wgrad: the f32 gradient of
    :func:`conv3x3_packed_halo_plain` with respect to ``w`` for ``xp``
    (B, D+2, Cin, H·W) and the cotangent ``dy`` (B, D, Cout, H·W)."""
    return _wgrad_plain(xp, dy, wdim, 0)


def conv3x3_packed_halo_dgrad_plain(dy: torch.Tensor, w: torch.Tensor,
                                    wdim: int, wguard: int = 0) -> torch.Tensor:
    """Plain version of the halo dgrad: the gradient of
    :func:`conv3x3_packed_halo_plain` with respect to ``xp`` (B, D+2, Cin,
    H·W), by autograd, for the cotangent ``dy`` (B, D, Cout, H·W), with
    ``w`` rounded to ``dy``'s dtype and the result in ``dy``'s dtype; with
    ``wguard``, ``dy``'s guard columns zeroed first and the result's after."""
    if wguard:
        return guard_mask(conv3x3_packed_halo_dgrad_plain(
            guard_mask(dy, wdim, wguard), w, wdim), wdim, wguard)
    b, d, cout, hw = dy.shape
    acc = _acc(dy.dtype)
    xp = torch.zeros((b, d + 2, w.shape[3], hw), dtype=acc, device=dy.device,
                     requires_grad=True)
    zero = torch.zeros(cout, dtype=acc, device=dy.device)
    with torch.enable_grad():
        y = _conv_plain(xp, w.detach().to(dy.dtype).to(acc), zero, wdim, 0)
        (dxp,) = torch.autograd.grad(y, xp, dy.to(acc))
    return dxp.to(dy.dtype)


def _check_packed(what: str, xk: torch.Tensor, wdim: int) -> None:
    if xk.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {xk.dtype} not supported")
    if not xk.is_contiguous():
        raise ValueError(f"{what}: input must be contiguous")
    if xk.shape[3] % wdim:
        raise ValueError(f"{what}: H·W={xk.shape[3]} is not a multiple of W={wdim}")
    if xk.shape[0] * xk.shape[1] > 65535:
        raise ValueError(f"{what}: B·D exceeds the grid limit 65535")


def _conv_shape(xk: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                wdim: int, what: str, grow: int, fold: bool = False):
    """Check a CUDA conv's operands; (B, Din, Cin, lanes, Dout)."""
    if xk.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {xk.device}")
    f = 4 if fold else 1
    b, din, fcin, lanes = xk.shape
    if fcin % f:
        raise ValueError(f"{what}: {fcin} channels are not 4 phases of Cin")
    cin = fcin // f
    d = din + grow
    if d < 1:
        raise ValueError(f"{what}: input {tuple(xk.shape)} has no d slice "
                         f"besides its halo")
    if w.shape[:4] != (3, 3, 3, cin) or bias.shape != (w.shape[4],):
        raise ValueError(f"{what}: weight {tuple(w.shape)} / bias "
                         f"{tuple(bias.shape)} do not fit input {tuple(xk.shape)}")
    _check_packed(what, xk, wdim)
    if b * d > 65535:
        raise ValueError(f"{what}: B·D exceeds the grid limit 65535")
    if w.device != xk.device or bias.device != xk.device:
        raise ValueError(f"{what}: weight, bias and input on different devices")
    return b, din, cin, lanes, d


def _conv_launch(xk: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                 wdim: int, what: str, grow: int = 0, fold: bool = False) -> torch.Tensor:
    """One launch of ``csrc/conv3x3_packed.cu`` (the ``mma.sync`` loop in
    bf16, the FMA kernel in f32) on a CUDA tensor. ``grow`` is the d
    geometry: 0 the SAME conv (D → D slices), -2 the conv on an input with
    its d halo (D+2 → D, every slice real), +2 that conv's input gradient
    (D → D+2, the missing slices zero by bounds). ``fold``: ``xk`` is
    phase-major w-folded, (B, D, 4·Cin, H·W/4), ``wdim`` is W/4 and the
    output is folded too (K7a)."""
    b, din, cin, lanes, d = _conv_shape(xk, w, bias, wdim, what, grow, fold)
    f = 4 if fold else 1
    cout = w.shape[4]
    wk = w.detach().to(xk.dtype).contiguous()  # rounded as the TPU kernel does
    bk = bias.detach().float().contiguous()
    y = torch.empty((b, d, f * cout, lanes), dtype=xk.dtype, device=xk.device)
    lib = _lib("conv3x3_packed")
    fn = (lib.conv3x3_packed_bf16 if xk.dtype == torch.bfloat16
          else lib.conv3x3_packed_f32)
    with torch.cuda.device(xk.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(xk.data_ptr(), wk.data_ptr(), bk.data_ptr(), y.data_ptr(),
                b, din, d, -grow // 2, int(fold), cin, cout, lanes // wdim, f * wdim,
                stream)
    _build.check(lib, rc, what)
    return y


def conv_plan(xk: torch.Tensor, cout: int, wdim: int, grow: int = 0,
              wguard: int = 0, fold: bool = False) -> Optional[conv_wgmma.WgmmaPlan]:
    """The wgmma kernel's plan for a bf16 conv of ``xk`` (B, Din, Cin, H·W)
    to ``cout`` channels at d geometry ``grow``, or ``None`` where the shape
    runs the ``mma.sync`` loop (see the module's docstring). ``fold``: ``xk``
    is phase-major w-folded, (B, Din, 4·Cin, H·W/4), and ``wdim`` is W/4."""
    b, din, cin, lanes = xk.shape
    f = 4 if fold else 1
    sms = (conv_wgmma.device_sms(xk.device) if xk.device.type == "cuda"
           else conv_wgmma.SMS)
    return conv_wgmma.wgmma_plan(b, din, din + grow, -grow // 2, cin // f, cout,
                                 lanes // wdim, f * wdim, wguard, sms, fold)


def _conv_cuda(xk: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, wdim: int,
               what: str, grow: int = 0, wguard: int = 0, fold: bool = False) -> torch.Tensor:
    """The conv on a CUDA tensor, by the kernel its dtype and shape route
    to; raises where no kernel takes it. ``fold``: the folded layout of
    :func:`_conv_launch` (K7a; no guard columns)."""
    _conv_shape(xk, w, bias, wdim, what, grow, fold)
    if xk.dtype == torch.float32:
        return guard_mask(_conv_launch(xk, w, bias, wdim, what, grow, fold), wdim, wguard)
    plan = conv_plan(xk, w.shape[4], wdim, grow, wguard, fold)
    if plan is None:
        return conv3x3_packed_mma_routed(xk, w, bias, wdim, what, grow, wguard, fold)
    return conv_wgmma.launch(plan, xk, w, bias, what)


def conv3x3_packed_mma_routed(xk: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                              wdim: int, what: str, grow: int = 0,
                              wguard: int = 0, fold: bool = False) -> torch.Tensor:
    """A bf16 conv of this module's or :mod:`.pfold`'s wrappers whose shape
    :func:`conv_plan` does not take: the ``mma.sync`` loop, the guard columns
    zeroed after, counted in its own ``launches``."""
    y = guard_mask(_conv_launch(xk, w, bias, wdim, what, grow, fold), wdim, wguard)
    conv3x3_packed_mma_routed.launches += 1
    return y


def conv3x3_packed_mma(xk: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                       wdim: int, grow: int = 0) -> torch.Tensor:
    """The ``mma.sync`` loop of ``csrc/conv3x3_packed.cu`` on the packed
    layout, bf16, at d geometry ``grow`` (0, -2 or +2, as
    :func:`_conv_launch`): a check-only entry point (K7a's routed shapes
    are bit for bit its result), on no model path. A
    CPU tensor takes the plain version."""
    if xk.dtype != torch.bfloat16:
        raise TypeError(f"conv3x3_packed_mma: bf16 only, not {xk.dtype}")
    if xk.device.type == "cpu":
        return _conv_plain(xk, w, bias, wdim, 1 + grow // 2)
    y = _conv_launch(xk, w, bias, wdim, "conv3x3_packed_mma", grow)
    conv3x3_packed_mma.launches += 1
    return y


def _conv_fwd(xk: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
              wdim: int, what: str, wguard: int = 0) -> torch.Tensor:
    """One K1 launch (CUDA) or the plain version (CPU); no autograd."""
    if xk.device.type == "cpu":
        return conv3x3_packed_plain(xk, w, bias, wdim, wguard)
    return _conv_cuda(xk, w, bias, wdim, what, 0, wguard)


def _flip_t(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``w`` flipped in (kd, kh, kw), transposed to (3, 3, 3, Cout, Cin)."""
    return w.detach().flip(0, 1, 2).transpose(3, 4).to(dtype).contiguous()


def conv3x3_packed_dgrad(dy: torch.Tensor, w: torch.Tensor,
                         wdim: int, wguard: int = 0) -> torch.Tensor:
    """dx of the packed conv: K1 on ``dy`` (B, D, Cout, H·W) with ``w``
    flipped in (kd, kh, kw), transposed to (3, 3, 3, Cout, Cin) and cast to
    ``dy``'s dtype, zero bias → (B, D, Cin, H·W) in ``dy``'s dtype; with
    ``wguard``, its guard columns zero."""
    wt = _flip_t(w, dy.dtype)
    zero = torch.zeros(wt.shape[4], dtype=torch.float32, device=dy.device)
    dx = _conv_fwd(dy, wt, zero, wdim, "conv3x3_packed_dgrad", wguard)
    if dy.device.type == "cuda":
        conv3x3_packed_dgrad.launches += 1
    return dx


def conv3x3_packed_halo_dgrad(dy: torch.Tensor, w: torch.Tensor,
                              wdim: int, wguard: int = 0) -> torch.Tensor:
    """dxp of :func:`conv3x3_packed_halo`: ``dxp[j] = Σ_kd w[kd]ᵀ · dy[j-kd]``
    for j in [0, D+2), from ``dy`` (B, D, Cout, H·W) → (B, D+2, Cin, H·W) in
    ``dy``'s dtype: the conv kernel with the flipped, transposed weight and
    zero bias, a ``dy`` slice outside [0, D) reading as zero; with
    ``wguard``, its guard columns zero. A CPU tensor takes
    :func:`conv3x3_packed_halo_dgrad_plain`; a CUDA tensor launches the
    kernel or raises."""
    if dy.device.type == "cpu":
        return conv3x3_packed_halo_dgrad_plain(dy, w, wdim, wguard)
    wt = _flip_t(w, dy.dtype)
    zero = torch.zeros(wt.shape[4], dtype=torch.float32, device=dy.device)
    dxp = _conv_cuda(dy, wt, zero, wdim, "conv3x3_packed_halo_dgrad", 2, wguard)
    conv3x3_packed_halo_dgrad.launches += 1
    return dxp


def wgrad_plan(xk: torch.Tensor, dy: torch.Tensor, wdim: int,
               fold: bool = False) -> Optional[wgrad_wgmma.WgradPlan]:
    """The wgmma wgrad kernel's plan for bf16 operands ``xk`` (B, D + 2·halo,
    Cin, H·W) and ``dy`` (B, D, Cout, H·W), the halo read from their d
    counts, or ``None`` where the shape runs the ``mma.sync`` loop (see the
    module's docstring). ``fold``: both are phase-major w-folded, (B, .,
    4·C, H·W/4), and ``wdim`` is W/4."""
    b, d, cout, lanes = dy.shape
    f = 4 if fold else 1
    sms = (conv_wgmma.device_sms(xk.device) if xk.device.type == "cuda"
           else wgrad_wgmma.SMS)
    return wgrad_wgmma.wgrad_plan(b, d, (xk.shape[1] - d) // 2, xk.shape[2] // f, cout // f,
                                  lanes // wdim, f * wdim, sms, fold)


def _wgrad_cuda(xk: torch.Tensor, dy: torch.Tensor, wdim: int, what: str,
                halo: int, fold: bool = False) -> torch.Tensor:
    """The weight gradient on CUDA tensors, by the kernel their dtype and
    shape route to; raises where no kernel takes them. ``fold``: the folded
    layout of :func:`_wgrad_launch` (K7b)."""
    _wgrad_shape(xk, dy, wdim, what, halo, fold)
    if xk.dtype == torch.float32:
        return _wgrad_launch(xk, dy, wdim, what, halo, fold)
    plan = wgrad_plan(xk, dy, wdim, fold)
    if plan is None:
        return conv3x3_wgrad_mma_routed(xk, dy, wdim, what, halo, fold)
    return wgrad_wgmma.launch(plan, xk, dy, what)


def conv3x3_wgrad(xk: torch.Tensor, dy: torch.Tensor, wdim: int) -> torch.Tensor:
    """K2: f32 dw (3, 3, 3, Cin, Cout) of the packed conv from its input
    ``xk`` (B, D, Cin, H·W) and cotangent ``dy`` (B, D, Cout, H·W), both of
    one dtype. A CPU tensor takes :func:`conv3x3_wgrad_plain`; a CUDA tensor
    launches the kernel or raises."""
    if xk.device.type == "cpu":
        return conv3x3_wgrad_plain(xk, dy, wdim)
    dw = _wgrad_cuda(xk, dy, wdim, "conv3x3_wgrad", halo=0)
    conv3x3_wgrad.launches += 1
    return dw


def conv3x3_wgrad_halo(xp: torch.Tensor, dy: torch.Tensor, wdim: int) -> torch.Tensor:
    """f32 dw (3, 3, 3, Cin, Cout) of :func:`conv3x3_packed_halo` from its
    input ``xp`` (B, D+2, Cin, H·W) and cotangent ``dy`` (B, D, Cout, H·W):
    the product ``xp[d+kd] · dy[d]``, no slice skipped (K2 with
    ``pad_d=False``). A CPU tensor takes :func:`conv3x3_wgrad_halo_plain`; a
    CUDA tensor launches the kernel or raises."""
    if xp.device.type == "cpu":
        return conv3x3_wgrad_halo_plain(xp, dy, wdim)
    dw = _wgrad_cuda(xp, dy, wdim, "conv3x3_wgrad_halo", halo=1)
    conv3x3_wgrad_halo.launches += 1
    return dw


def conv3x3_wgrad_mma_routed(xk: torch.Tensor, dy: torch.Tensor, wdim: int, what: str,
                             halo: int, fold: bool = False) -> torch.Tensor:
    """A bf16 weight gradient of this module's or :mod:`.pfold`'s wrappers
    whose shape :func:`wgrad_plan` does not take: the ``mma.sync`` loop,
    counted in its own ``launches``."""
    dw = _wgrad_launch(xk, dy, wdim, what, halo, fold)
    conv3x3_wgrad_mma_routed.launches += 1
    return dw


def conv3x3_wgrad_mma(xk: torch.Tensor, dy: torch.Tensor, wdim: int,
                      halo: int = 0) -> torch.Tensor:
    """The bf16 ``mma.sync`` loop of ``csrc/conv3x3_wgrad.cu`` on the packed
    layout, ``xk`` carrying ``halo`` more d slices per side than ``dy``: a
    check-only entry point (K7b's routed shapes, its halo form's too, are
    bit for bit its result), on no model path. A CPU tensor takes the
    plain version."""
    if xk.dtype != torch.bfloat16:
        raise TypeError(f"conv3x3_wgrad_mma: bf16 only, not {xk.dtype}")
    if xk.device.type == "cpu":
        return _wgrad_plain(xk, dy, wdim, 1 - halo)
    dw = _wgrad_launch(xk, dy, wdim, "conv3x3_wgrad_mma", halo)
    conv3x3_wgrad_mma.launches += 1
    return dw


def _wgrad_shape(xk: torch.Tensor, dy: torch.Tensor, wdim: int, what: str, halo: int,
                 fold: bool = False):
    """Check a CUDA weight gradient's operands; (B, D, Cin, Cout, lanes)."""
    if xk.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {xk.device}")
    f = 4 if fold else 1
    b, dx_, fcin, lanes = xk.shape
    d = dx_ - 2 * halo
    cin, cout = fcin // f, dy.shape[2] // f
    if (dy.shape != (b, d, f * cout, lanes) or fcin % f or dy.dtype != xk.dtype
            or dy.device != xk.device):
        raise ValueError(f"{what}: dy {tuple(dy.shape)} {dy.dtype} does not "
                         f"fit x {tuple(xk.shape)} {xk.dtype}")
    _check_packed(what, xk, wdim)
    _check_packed(what, dy, wdim)
    return b, d, cin, cout, lanes


def _wgrad_launch(xk: torch.Tensor, dy: torch.Tensor, wdim: int, what: str,
                  halo: int, fold: bool = False) -> torch.Tensor:
    """One launch of the ``mma.sync`` loop (bf16) or the FMA kernel (f32) of
    ``csrc/conv3x3_wgrad.cu`` and its split sum on CUDA tensors; ``xk``
    carries ``halo`` more d slices per side than ``dy``. ``fold``: both are
    phase-major w-folded and ``wdim`` is W/4 (K7b)."""
    b, d, cin, cout, lanes = _wgrad_shape(xk, dy, wdim, what, halo, fold)
    f = 4 if fold else 1
    lib = _lib("conv3x3_wgrad")
    bf16 = xk.dtype == torch.bfloat16
    h, wd = lanes // wdim, f * wdim
    splits = lib.conv3x3_wgrad_splits(b, d, cin, cout, h, wd, int(bf16))
    part = torch.empty((splits, 27 * cin * cout), dtype=torch.float32, device=xk.device)
    dw = torch.empty((3, 3, 3, cin, cout), dtype=torch.float32, device=xk.device)
    fn = lib.conv3x3_wgrad_bf16 if bf16 else lib.conv3x3_wgrad_f32
    with torch.cuda.device(xk.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(xk.data_ptr(), dy.data_ptr(), part.data_ptr(), dw.data_ptr(),
                b, d, halo, int(fold), cin, cout, h, wd, stream)
    _build.check(lib, rc, what)
    return dw


def conv3x3_wgrad_chain(xk: torch.Tensor, dy: torch.Tensor, wdim: int,
                        fold: bool = False) -> int:
    """The longest run of f32 roundings one product passes through in the
    kernel that :func:`conv3x3_wgrad` (or its halo form, or with ``fold``
    K7b) launches for these operands: the length that bounds its rounding
    error. bf16 operands that :func:`wgrad_plan` takes report the wgmma
    kernel's (its plan's, no card needed); f32 and routed ones the
    ``mma.sync`` loop's (:func:`conv3x3_wgrad_mma_chain`, at the unfolded
    shape)."""
    if xk.dtype == torch.bfloat16:
        plan = wgrad_plan(xk, dy, wdim, fold)
        if plan is not None:
            return plan.chain
    if fold:
        def packed(t):  # the unfolded shape, through a free reshape
            return t.reshape(t.shape[0], t.shape[1], t.shape[2] // 4, -1)
        return conv3x3_wgrad_mma_chain(packed(xk), packed(dy), 4 * wdim)
    return conv3x3_wgrad_mma_chain(xk, dy, wdim)


def conv3x3_wgrad_mma_chain(xk: torch.Tensor, dy: torch.Tensor, wdim: int) -> int:
    """The longest f32 rounding chain of ``csrc/conv3x3_wgrad.cu`` (the
    ``mma.sync`` loop in bf16, the FMA kernel in f32) for these CUDA
    operands: the item's accumulator, the split's sum of items, the sum of
    splits. Sized from ``dy``, so it holds for the halo variant too."""
    b, d, cout, hw = dy.shape
    return _lib("conv3x3_wgrad").conv3x3_wgrad_chain(
        b, d, xk.shape[2], cout, hw // wdim, wdim, int(xk.dtype == torch.bfloat16))


def _stripped(xk: torch.Tensor, dy: torch.Tensor, ctx):
    """The weight gradient's operands and width: K2W's guard-stripped ones
    where the conv has guard columns (the module's docstring)."""
    return (strip_guards(xk, ctx.wdim, ctx.wguard), strip_guards(dy, ctx.wdim, ctx.wguard),
            ctx.wdim - ctx.wguard)


class _Conv3x3Packed(torch.autograd.Function):
    """``conv3x3_packed``'s custom VJP (``conv3d.py:573-591``)."""

    @staticmethod
    def forward(ctx, xk, w, bias, wdim, wguard):
        ctx.save_for_backward(xk, w)
        ctx.wdim, ctx.wguard = wdim, wguard
        ctx.bias_dtype = bias.dtype
        y = _conv_fwd(xk, w, bias, wdim, "conv3x3_packed", wguard)
        if xk.device.type == "cuda":
            conv3x3_packed.launches += 1
        return y

    @staticmethod
    def backward(ctx, dy):
        xk, w = ctx.saved_tensors
        dy = guard_mask(dy.to(xk.dtype), ctx.wdim, ctx.wguard).contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3_packed_dgrad(dy, w, ctx.wdim, ctx.wguard).to(xk.dtype)
        if ctx.needs_input_grad[1]:
            dw = conv3x3_wgrad(*_stripped(xk, dy, ctx)).to(w.dtype)
        if ctx.needs_input_grad[2]:
            db = dy.to(_acc(dy.dtype)).sum(dim=(0, 1, 3)).to(ctx.bias_dtype)
        return dx, dw, db, None, None


def conv3x3_packed(xk: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                   wdim: int, wguard: int = 0) -> torch.Tensor:
    """SAME 3x3x3 conv of ``xk`` (B, D, Cin, H·W) with ``w`` (3, 3, 3, Cin,
    Cout) and ``bias`` (Cout,) → (B, D, Cout, H·W) in ``xk``'s dtype,
    differentiable in all three. ``wguard``: the last ``wguard`` of the
    ``wdim`` columns of every w-row are zero guard columns (the module's
    docstring). ``dw`` then assumes ``xk``'s guard columns are zero: the
    forward reads them and K2W strips them, so with nonzero guards ``dw``
    is not the forward's gradient. On a CPU tensor every part (forward, dx,
    dw) takes its plain version; on a CUDA tensor each launches its kernel
    or raises."""
    return _Conv3x3Packed.apply(xk, w, bias, wdim, wguard)


class _Conv3x3PackedHalo(torch.autograd.Function):
    """``conv3x3_packed_halo``'s custom VJP (``conv3d.py:608-630``)."""

    @staticmethod
    def forward(ctx, xp, w, bias, wdim, wguard):
        ctx.save_for_backward(xp, w)
        ctx.wdim, ctx.wguard = wdim, wguard
        ctx.bias_dtype = bias.dtype
        if xp.device.type == "cpu":
            return conv3x3_packed_halo_plain(xp, w, bias, wdim, wguard)
        y = _conv_cuda(xp, w, bias, wdim, "conv3x3_packed_halo", -2, wguard)
        conv3x3_packed_halo.launches += 1
        return y

    @staticmethod
    def backward(ctx, dy):
        xp, w = ctx.saved_tensors
        dy = guard_mask(dy.to(xp.dtype), ctx.wdim, ctx.wguard).contiguous()
        dxp = dw = db = None
        if ctx.needs_input_grad[0]:
            dxp = conv3x3_packed_halo_dgrad(dy, w, ctx.wdim, ctx.wguard).to(xp.dtype)
        if ctx.needs_input_grad[1]:
            dw = conv3x3_wgrad_halo(*_stripped(xp, dy, ctx)).to(w.dtype)
        if ctx.needs_input_grad[2]:
            db = dy.to(_acc(dy.dtype)).sum(dim=(0, 1, 3)).to(ctx.bias_dtype)
        return dxp, dw, db, None, None


def conv3x3_packed_halo(xp: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                        wdim: int, wguard: int = 0) -> torch.Tensor:
    """:func:`conv3x3_packed` on an input that already carries one d slice of
    halo per side: ``xp`` (B, D+2, Cin, H·W) → (B, D, Cout, H·W) in ``xp``'s
    dtype; no d padding is added and no d slice is skipped. Differentiable in
    ``xp``, ``w`` and ``bias``; ``wguard`` as in :func:`conv3x3_packed`, and
    ``dw`` likewise assumes ``xp``'s guard columns are zero. On a CPU tensor
    every part takes its plain version; on a CUDA tensor each launches its
    kernel or raises."""
    return _Conv3x3PackedHalo.apply(xp, w, bias, wdim, wguard)


Replicas = Union[torch.Tensor, Mapping[torch.device, torch.Tensor]]


def _on(t: Replicas, device: torch.device) -> torch.Tensor:
    """The replica of a parameter on ``device``: of a mapping its entry; of
    one tensor the tensor itself, copied over where it lies elsewhere (a
    copy autograd sums back)."""
    return t[device] if isinstance(t, Mapping) else t.to(device)


def conv3x3_packed_auto(xk: Union[torch.Tensor, Sharded], w: Replicas,
                        bias: Replicas, wdim: int, mesh: Optional[Mesh] = None,
                        wguard: int = 0) -> Union[torch.Tensor, Sharded]:
    """:func:`conv3x3_packed` of a volume that may be split over a mesh,
    ``wguard`` passed on to whichever conv runs.

    ``xk`` is one tensor (with ``mesh``: split here by the rules below and
    gathered again) or a :class:`Sharded` value (shards in, shards out).
    ``w`` and ``bias`` are one tensor each or one replica per device (keyed
    by the mesh's entries, :func:`~unet_bssfp_tpu_torch.parallel.mesh.place`). The
    route, per conv (the JAX package's ``_active_conv_mesh``):

    - no mesh, or a mesh of one position → K1 on the whole tensor;
    - a ``space`` axis of size n > 1 that divides D → each shard takes one d
      slice from each ``space`` neighbour (zeros at the volume's two ends:
      exactly the SAME pad) and runs K5, :func:`conv3x3_packed_halo`;
    - D not divisible by n → the batch is split over ``data`` only and every
      shard runs K1; a batch that ``data`` does not divide → K1 unsplit.
    """
    if isinstance(xk, torch.Tensor):
        plan = mesh.plan(xk.shape[0], xk.shape[1]) if mesh is not None else None
        if plan is None or plan.positions == 1:
            return conv3x3_packed(xk, _on(w, place(xk)), _on(bias, place(xk)), wdim, wguard)
        ys = conv3x3_packed_auto(shard_batch(plan, xk), w, bias, wdim, wguard=wguard)
        return gather_batch(ys, xk.device)
    if xk.mesh.size("space") == 1:
        return xk.map(lambda t: conv3x3_packed(
            t, _on(w, place(t)), _on(bias, place(t)), wdim, wguard))
    return xk.halo_d().map(lambda t: conv3x3_packed_halo(
        t, _on(w, place(t)), _on(bias, place(t)), wdim, wguard))


conv3x3_packed.launches = 0
conv3x3_packed_dgrad.launches = 0
conv3x3_packed_mma.launches = 0
conv3x3_packed_mma_routed.launches = 0
conv3x3_wgrad.launches = 0
conv3x3_wgrad_mma.launches = 0
conv3x3_wgrad_mma_routed.launches = 0
conv3x3_packed_halo.launches = 0
conv3x3_packed_halo_dgrad.launches = 0
conv3x3_wgrad_halo.launches = 0

_ARGTYPES = {
    "conv3x3_packed": {
        name: ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        for name in ("conv3x3_packed_f32", "conv3x3_packed_bf16")},
    "conv3x3_wgrad": {
        **{name: ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
           for name in ("conv3x3_wgrad_f32", "conv3x3_wgrad_bf16")},
        "conv3x3_wgrad_splits": [ctypes.c_int] * 7,
        "conv3x3_wgrad_chain": [ctypes.c_int] * 7},
}


def _lib(source: str) -> ctypes.CDLL:
    lib = _build.load(source)
    if not getattr(lib, "_typed", False):
        for name, argtypes in _ARGTYPES[source].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib
