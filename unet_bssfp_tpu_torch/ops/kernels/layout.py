"""K3: the NDHWC ↔ packed ``(B, D, C, H·W)`` relayout.

Replaces ``unet_bssfp_tpu/ops/pallas/conv3d.py::pack_hw`` / ``unpack_hw``
(``_pack_kernel`` / ``_unpack_kernel``). Both directions are one CUDA
transpose of the last two dims of ``(B·D, ·, ·)``, ``csrc/layout.cu``; its
header says what bounds it and how it is laid out. A side of at most 16
channels (the generator's 6-channel output and its gradient) takes the
kernel's narrow path, the others its tiles: :func:`transpose_path` makes
that choice here, from the shape, so the CPU tests check it. The plain versions are
``permute().contiguous()``: the CPU path and the kernel's reference. Each
direction is the other's backward, as in the JAX package's custom VJPs, so
the gradient runs through the kernels too.
"""

from __future__ import annotations

import ctypes
from typing import Union

import torch

from unet_bssfp_tpu_torch.ops.kernels import _build
from unet_bssfp_tpu_torch.parallel.mesh import Sharded, apply_local

_DTYPES = (torch.float32, torch.bfloat16)
NARROW = 16  # the widest side the narrow path takes
PATH_TILES, PATH_NARROW_C, PATH_NARROW_R = 0, 1, 2


def transpose_path(r: int, c: int, itemsize: int, aligned: bool = True) -> int:
    """The kernel path of a transpose (S, R, C) → (S, C, R): the narrow
    path where C (``pack_hw``'s channels) or else R (``unpack_hw``'s) is at
    most 16 and the other side a whole number of 16-byte vectors (both
    pointers 16-byte aligned), else the tiles."""
    v = 16 // itemsize
    if aligned and 1 <= c <= NARROW and r % v == 0:
        return PATH_NARROW_C
    if aligned and 1 <= r <= NARROW and c % v == 0:
        return PATH_NARROW_R
    return PATH_TILES


def narrow_groups(s: int, r: int, c: int, itemsize: int, path: int) -> list:
    """What the narrow path's threads move, as the kernel indexes it: for
    each thread group g, the (slice, pixel) of its first pixel; each group
    moves 16 // itemsize pixels of every channel."""
    v = 16 // itemsize
    pixels = r if path == PATH_NARROW_C else c
    return [divmod(g * v, pixels) for g in range(s * pixels // v)]


def pack_hw_plain(x: torch.Tensor) -> torch.Tensor:
    b, d, h, w, c = x.shape
    return x.permute(0, 1, 4, 2, 3).reshape(b, d, c, h * w).contiguous()


def unpack_hw_plain(xk: torch.Tensor, wdim: int) -> torch.Tensor:
    b, d, c, hw = xk.shape
    return xk.reshape(b, d, c, hw // wdim, wdim).permute(0, 1, 3, 4, 2).contiguous()


def _transpose(x: torch.Tensor, s: int, r: int, c: int, out_shape,
               what: str) -> torch.Tensor:
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {x.dtype} not supported")
    if not x.is_contiguous():
        raise ValueError(f"{what}: input must be contiguous")
    if s > 65535 or -(-r // 32) > 65535:
        raise ValueError(f"{what}: shape {tuple(x.shape)} exceeds the grid limits")
    out = torch.empty(out_shape, dtype=x.dtype, device=x.device)
    path = transpose_path(r, c, x.element_size(),
                          x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.transpose_last2(x.data_ptr(), out.data_ptr(), s, r, c,
                                 x.element_size(), path, stream)
    _build.check(lib, rc, what)
    return out


def _pack(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return pack_hw_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"pack_hw: unsupported device {x.device}")
    b, d, h, w, c = x.shape
    out = _transpose(x, b * d, h * w, c, (b, d, c, h * w), "pack_hw")
    pack_hw.launches += 1
    return out


def _unpack(xk: torch.Tensor, wdim: int) -> torch.Tensor:
    if xk.device.type == "cpu":
        return unpack_hw_plain(xk, wdim)
    if xk.device.type != "cuda":
        raise ValueError(f"unpack_hw: unsupported device {xk.device}")
    b, d, c, hw = xk.shape
    if hw % wdim:
        raise ValueError(f"unpack_hw: H·W={hw} is not a multiple of W={wdim}")
    out = _transpose(xk, b * d, c, hw, (b, d, hw // wdim, wdim, c), "unpack_hw")
    unpack_hw.launches += 1
    return out


class _PackHW(torch.autograd.Function):
    """A permutation: its cotangent is the inverse permutation
    (``conv3d.py:1309-1318``)."""

    @staticmethod
    def forward(ctx, x):
        ctx.wdim = x.shape[3]
        return _pack(x)

    @staticmethod
    def backward(ctx, dy):
        return unpack_hw(dy.contiguous(), ctx.wdim)


class _UnpackHW(torch.autograd.Function):
    """``conv3d.py:1321-1329``."""

    @staticmethod
    def forward(ctx, xk, wdim):
        return _unpack(xk, wdim)

    @staticmethod
    def backward(ctx, dy):
        return pack_hw(dy.contiguous()), None


def pack_hw(x: torch.Tensor) -> torch.Tensor:
    """NDHWC (B, D, H, W, C) → packed (B, D, C, H·W), differentiable (the
    backward is :func:`unpack_hw`). A CPU tensor takes :func:`pack_hw_plain`;
    a CUDA tensor launches the kernel or raises."""
    return _PackHW.apply(x)


def unpack_hw(xk: torch.Tensor, wdim: int) -> torch.Tensor:
    """Inverse of :func:`pack_hw`: (B, D, C, H·W) → (B, D, H, W, C); its
    backward is :func:`pack_hw`."""
    return _UnpackHW.apply(xk, wdim)


def pack_hw_auto(x: Union[torch.Tensor, Sharded]) -> Union[torch.Tensor, Sharded]:
    """:func:`pack_hw` of a tensor or of every shard of a sharded value: the
    relayout works on each (b, d) slice alone, so it needs no halo on either
    mesh axis (one launch per shard)."""
    return apply_local(pack_hw, x)


def unpack_hw_auto(xk: Union[torch.Tensor, Sharded],
                   wdim: int) -> Union[torch.Tensor, Sharded]:
    """:func:`unpack_hw` of a tensor or of every shard of a sharded value."""
    return apply_local(lambda t: unpack_hw(t, wdim), xk)


pack_hw.launches = 0
unpack_hw.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("layout")
    if not getattr(lib, "_typed", False):
        lib.transpose_last2.argtypes = ([ctypes.c_void_p] * 2
                                        + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.transpose_last2.restype = ctypes.c_int
        lib._typed = True
    return lib
