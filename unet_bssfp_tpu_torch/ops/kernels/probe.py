"""K9a and K9b: the probe kernels of ``scripts/torch_port_pallas_probe.py``.

Replace the two ``pl.pallas_call`` sites of ``scripts/pallas_probe.py``:

- K9a, :func:`lane_roll` (``probe_roll``): a (R, C) f32 tile rolled along
  its last axis through shared memory, a check of the roll's direction;
  ``csrc/probe.cu``. Plain version: slices and a ``cat``.
- K9b (``probe_perf_ablation``): K1's bf16 loop in three modes, a template
  parameter of K1's own kernel (``csrc/conv3x3_packed.cuh``), to split K1's
  time into staging and product loop: :func:`conv3x3_probe_full` (K1
  itself), :func:`conv3x3_probe_centre` (every (kh, kw) tap reads the
  unshifted tile: a (3, 1, 1) conv of the weights summed over (kh, kw)) and
  :func:`conv3x3_probe_fixed` (one tile staged once, the whole loop on it).
  ``csrc/probe.cu``'s header states each mode's function;
  :func:`conv3x3_probe_plain` computes it in plain PyTorch.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from unet_bssfp_tpu_torch.ops.kernels import _build
from unet_bssfp_tpu_torch.ops.kernels.conv3d import _check_packed, conv3x3_packed_plain

MODES = ("full", "centre", "fixed")
CK = 16  # input channels per stage of the mma.sync loop


def lane_roll_plain(x: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """``y[r, c] = x[r, (c - shift) mod C]``."""
    s = shift % x.shape[1]
    return torch.cat([x[:, x.shape[1] - s:], x[:, :x.shape[1] - s]], 1)


def lane_roll(x: torch.Tensor, shift: int = 1) -> torch.Tensor:
    """K9a: ``x`` (R, C) f32 rolled by ``shift`` along its last axis."""
    if x.device.type == "cpu":
        return lane_roll_plain(x, shift)
    if x.device.type != "cuda":
        raise ValueError(f"lane_roll: unsupported device {x.device}")
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"lane_roll: needs a contiguous 2-D f32 tile, got "
                         f"{tuple(x.shape)} {x.dtype}")
    y = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        rc = lib.lane_roll_f32(x.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1], shift,
                               torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, "lane_roll")
    lane_roll.launches += 1
    return y


def conv3x3_probe_plain(xk: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                        wdim: int, mode: str) -> torch.Tensor:
    """The function K9b computes in ``mode`` (``csrc/probe.cu``'s header),
    with ``w`` rounded to ``xk``'s dtype, f32 sums and the result in
    ``xk``'s dtype, as K1's plain version."""
    if mode == "full":
        return conv3x3_packed_plain(xk, w, bias, wdim)
    b, d, cin, hw = xk.shape
    acc = torch.promote_types(xk.dtype, torch.float32)
    x = xk.reshape(b, d, cin, hw // wdim, wdim).permute(0, 2, 1, 3, 4).to(acc)
    wr = w.to(xk.dtype).to(acc).permute(4, 3, 0, 1, 2)  # (O, I, kd, kh, kw)
    if mode == "centre":
        y = F.conv3d(x, wr.sum(dim=(3, 4), keepdim=True), padding=(1, 0, 0))
    elif mode == "fixed":
        c = min(CK, cin)
        y = F.conv3d(x[:, :c], wr[:, :c, 1:2], padding=(0, 1, 1))
        dd = torch.arange(d, device=xk.device)
        n = sum(((dd + kd - 1 >= 0) & (dd + kd - 1 < d)).to(acc) for kd in range(3))
        y = y * (n * -(-cin // CK)).view(1, 1, d, 1, 1)
    else:
        raise ValueError(f"conv3x3_probe: mode {mode!r} not in {MODES}")
    y = y + bias.to(acc).view(1, -1, 1, 1, 1)
    return y.permute(0, 2, 1, 3, 4).reshape(b, d, -1, hw).to(xk.dtype)


def _probe(fn, xk: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, wdim: int,
           mode: str) -> torch.Tensor:
    if xk.device.type == "cpu":
        return conv3x3_probe_plain(xk, w, bias, wdim, mode)
    what = fn.__name__
    if xk.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {xk.device}")
    if xk.dtype != torch.bfloat16:
        raise TypeError(f"{what}: K1's bf16 loop takes bf16, got {xk.dtype}")
    _check_packed(what, xk, wdim)
    b, d, cin, hw = xk.shape
    if w.shape[:4] != (3, 3, 3, cin) or bias.shape != (w.shape[4],):
        raise ValueError(f"{what}: weight {tuple(w.shape)} / bias {tuple(bias.shape)} "
                         f"do not fit input {tuple(xk.shape)}")
    cout = w.shape[4]
    wk = w.detach().to(xk.dtype).contiguous()
    bk = bias.detach().float().contiguous()
    y = torch.empty((b, d, cout, hw), dtype=xk.dtype, device=xk.device)
    lib = _lib()
    with torch.cuda.device(xk.device):
        rc = lib.conv3x3_probe_bf16(xk.data_ptr(), wk.data_ptr(), bk.data_ptr(), y.data_ptr(),
                                    b, d, cin, cout, hw // wdim, wdim, MODES.index(mode),
                                    torch.cuda.current_stream().cuda_stream)
    _build.check(lib, rc, what)
    fn.launches += 1
    return y


def conv3x3_probe_full(xk, w, bias, wdim):
    """K9b, mode full: K1's kernel instance in the probe's library."""
    return _probe(conv3x3_probe_full, xk, w, bias, wdim, "full")


def conv3x3_probe_centre(xk, w, bias, wdim):
    """K9b, mode centre: full staging, the nine (kh, kw) taps unshifted."""
    return _probe(conv3x3_probe_centre, xk, w, bias, wdim, "centre")


def conv3x3_probe_fixed(xk, w, bias, wdim):
    """K9b, mode fixed: one staged tile, K1's whole loop on it."""
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
        lib.conv3x3_probe_bf16.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                                           + [ctypes.c_void_p])
        for fn in (lib.lane_roll_f32, lib.conv3x3_probe_bf16):
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib
