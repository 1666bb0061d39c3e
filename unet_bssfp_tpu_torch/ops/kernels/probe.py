"""K9a and K9b: the probe kernels of ``scripts/torch_port_pallas_probe.py``.

Replace the two ``pl.pallas_call`` sites of ``scripts/pallas_probe.py``:

- K9a, :func:`lane_roll` (``probe_roll``): a (R, C) f32 tile rolled along
  its last axis, a check of the roll's direction; ``csrc/probe.cu``, one
  gather per element. Plain version: slices and a ``cat``. Its cost is the
  host's, so the wrapper does only the cheap checks, normalises the shift
  (:func:`roll_shift`) and makes one ``ctypes`` call through
  :func:`._build.launch`.
- K9b (``probe_perf_ablation``): K1's wgmma kernel
  (``csrc/conv3x3_wgmma.cuh``) in three modes, a template parameter of the
  kernel compiled in the probe's own library (``csrc/probe.cu``), to split
  K1's time into its products and epilogue, its staging and its shifted
  addresses: :func:`conv3x3_probe_full` (K1 itself, bit for bit),
  :func:`conv3x3_probe_centre` (every (kh, kw) tap reads the unshifted tile:
  a (3, 1, 1) conv of the weights summed over (kh, kw)) and
  :func:`conv3x3_probe_fixed` (one tile staged before the d walk, no staging
  inside it: slice 0's conv repeated over d, the weights' 16-channel chunks
  summed). :func:`conv3x3_probe_plain` computes each mode's function. The
  launch is K1's (:func:`.conv3d.conv_plan`, the weight image, the tensor
  maps encoded in C); a shape whose plan is not one of :data:`PAIRS` raises.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from unet_bssfp_tpu_torch.ops.kernels import _build, conv_wgmma
from unet_bssfp_tpu_torch.ops.kernels.conv3d import (
    _check_packed,
    conv3x3_packed_plain,
    conv_plan,
)

MODES = ("full", "centre", "fixed")
CK = conv_wgmma.CK  # input channels per ring stage: the chunks fixed sums
# The (N, rows) of the wgmma plans the probe library compiles: PROBE_CONV
# (24 → 32: N 32, 4 rows) and N 64 (2 rows) for Cout 33..64.
PAIRS = ((32, 4), (64, 2))


def roll_shift(shift: int, c: int) -> int:
    """``shift`` as the kernel takes it: in [0, ``c``)."""
    return shift % c


def lane_roll_plain(x: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """``y[r, c] = x[r, (c - shift) mod C]``."""
    s = roll_shift(shift, x.shape[1])
    return torch.cat([x[:, x.shape[1] - s:], x[:, :x.shape[1] - s]], 1)


def lane_roll(x: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """K9a: ``x`` (R, C) f32 rolled by ``shift`` along its last axis."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return lane_roll_plain(x, shift)
        raise ValueError(f"lane_roll: unsupported device {x.device}")
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"lane_roll: needs a contiguous 2-D f32 tile, got "
                         f"{tuple(x.shape)} {x.dtype}")
    r, c = x.shape
    y = torch.empty_like(x)
    lib = _lib()
    rc = _build.launch(lib.lane_roll_f32, x, x.data_ptr(), y.data_ptr(), r, c,
                       roll_shift(shift, c))
    if rc:
        _build.check(lib, rc, "lane_roll")
    lane_roll.launches += 1
    return y


def conv3x3_probe_plain(xk: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                        wdim: int, mode: str) -> torch.Tensor:
    """The function K9b computes in ``mode``, with ``w`` rounded to
    ``xk``'s dtype, f32 sums and the result in ``xk``'s dtype, as K1's plain
    version. With e the output slice and D the slices:

    - ``full``: the SAME conv, :func:`.conv3d.conv3x3_packed_plain`;
    - ``centre``: ``y = bias + Σ_{kd,ci} (Σ_{kh,kw} w[kd,kh,kw,ci,co])
      · x[b, e+kd-1, ci, h, w]``, a (3, 1, 1) conv;
    - ``fixed``: ``y = bias + Σ_{kd: 0 ≤ e+kd-1 < D} Σ_{kh,kw}
      Σ_{ci < min(16, Cin)} (Σ_c w[kd,kh,kw,16c+ci,co])
      · x[b, 0, ci, h+kh-1, w+kw-1]`` (weights past Cin zero): slice 0's
      conv repeated over d, the weights' 16-channel chunks summed."""
    if mode == "full":
        return conv3x3_packed_plain(xk, w, bias, wdim)
    b, d, cin, hw = xk.shape
    acc = torch.promote_types(xk.dtype, torch.float32)
    x = xk.reshape(b, d, cin, hw // wdim, wdim).permute(0, 2, 1, 3, 4).to(acc)
    wr = w.to(xk.dtype).to(acc).permute(4, 3, 0, 1, 2)  # (O, I, kd, kh, kw)
    if mode == "centre":
        y = F.conv3d(x, wr.sum(dim=(3, 4), keepdim=True), padding=(1, 0, 0))
    elif mode == "fixed":
        c, chunks = min(CK, cin), -(-cin // CK)
        ws = F.pad(wr, (0, 0, 0, 0, 0, 0, 0, chunks * CK - cin))
        ws = ws.reshape(wr.shape[0], chunks, CK, 3, 3, 3).sum(1)[:, :c]
        e = torch.arange(d, device=xk.device)
        y = 0
        for kd in range(3):
            valid = ((e + kd - 1 >= 0) & (e + kd - 1 < d)).to(acc).view(1, 1, d, 1, 1)
            y = y + valid * F.conv3d(x[:, :c, :1], ws[:, :, kd:kd + 1], padding=(0, 1, 1))
    else:
        raise ValueError(f"conv3x3_probe: mode {mode!r} not in {MODES}")
    y = y + bias.to(acc).view(1, -1, 1, 1, 1)
    return y.permute(0, 2, 1, 3, 4).reshape(b, d, -1, hw).to(xk.dtype)


def probe_plan(xk: torch.Tensor, cout: int, wdim: int) -> conv_wgmma.WgmmaPlan:
    """K1's wgmma plan for the SAME conv of ``xk`` to ``cout`` channels;
    raises where the wgmma kernel or the probe library does not take it."""
    plan = conv_plan(xk, cout, wdim)
    if plan is None or (plan.n, plan.rows) not in PAIRS or plan.n_tiles > 1:
        raise ValueError(f"conv3x3_probe: {tuple(xk.shape)} → {cout} channels (W {wdim}) "
                         f"has no wgmma plan in {PAIRS} (plan: {plan})")
    return plan


def _probe(fn, xk: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, wdim: int,
           mode: str) -> torch.Tensor:
    if xk.device.type == "cpu":
        return conv3x3_probe_plain(xk, w, bias, wdim, mode)
    what = fn.__name__
    if xk.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {xk.device}")
    if xk.dtype != torch.bfloat16:
        raise TypeError(f"{what}: the wgmma kernel takes bf16, got {xk.dtype}")
    _check_packed(what, xk, wdim)
    b, d, cin, hw = xk.shape
    if w.shape[:4] != (3, 3, 3, cin) or bias.shape != (w.shape[4],):
        raise ValueError(f"{what}: weight {tuple(w.shape)} / bias {tuple(bias.shape)} "
                         f"do not fit input {tuple(xk.shape)}")
    if xk.data_ptr() % 16:
        raise ValueError(f"{what}: input not 16-byte aligned")
    plan = probe_plan(xk, w.shape[4], wdim)
    img = conv_wgmma.weight_image(w, plan.n, plan.cin_pad)
    bk = bias.detach().float().contiguous()
    y = torch.empty((b, d, plan.cout, hw), dtype=xk.dtype, device=xk.device)
    lib = _lib()
    rc = _build.launch(lib.conv3x3_probe_wgmma, xk, xk.data_ptr(), img.data_ptr(),
                       bk.data_ptr(), y.data_ptr(), b, d, cin, plan.cout, plan.h, wdim,
                       plan.n, plan.cin_pad, plan.rows, plan.stages, plan.seg_len,
                       plan.segments, MODES.index(mode))
    _build.check(lib, rc, what)
    fn.launches += 1
    return y


def conv3x3_probe_full(xk, w, bias, wdim):
    """K9b, mode full: K1's wgmma kernel, instanced in the probe's library."""
    return _probe(conv3x3_probe_full, xk, w, bias, wdim, "full")


def conv3x3_probe_centre(xk, w, bias, wdim):
    """K9b, mode centre: full staging, the nine (kh, kw) taps unshifted."""
    return _probe(conv3x3_probe_centre, xk, w, bias, wdim, "centre")


def conv3x3_probe_fixed(xk, w, bias, wdim):
    """K9b, mode fixed: one tile staged before the walk, full's products."""
    return _probe(conv3x3_probe_fixed, xk, w, bias, wdim, "fixed")


PROBE_MODES = {"full": conv3x3_probe_full, "centre": conv3x3_probe_centre,
               "fixed": conv3x3_probe_fixed}

lane_roll.launches = 0
conv3x3_probe_full.launches = 0
conv3x3_probe_centre.launches = 0
conv3x3_probe_fixed.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("probe")
    if not getattr(lib, "_typed", False):
        lib.lane_roll_f32.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                                      + [ctypes.c_void_p])
        lib.conv3x3_probe_wgmma.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 13
                                            + [ctypes.c_void_p])
        for fn in (lib.lane_roll_f32, lib.conv3x3_probe_wgmma):
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib
