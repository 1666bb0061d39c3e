"""K1: 3x3x3 SAME conv + bias on the packed ``(B, D, C, H·W)`` layout.

Replaces ``unet_bssfp_tpu/ops/pallas/conv3d.py::conv3x3_packed`` (forward;
the backward kernels come with the training slice). The CUDA kernel is
``csrc/conv3x3_packed.cu``; its header says what bounds it on the card and
how it is laid out. :func:`conv3x3_packed_plain` is the same function in
plain PyTorch: the CPU path, and the reference the kernel is held to.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from unet_bssfp_tpu_torch.ops.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)


def packed_supported(shape) -> bool:
    """Static gate: NDHWC shape (B, D, H, W, C) the packed path takes (the
    JAX package's gate, so both packages pick the same branch)."""
    if len(shape) != 5:
        return False
    _, d, h, w, c = shape
    return (h * w) % 128 == 0 and h >= 3 and w >= 3 and d >= 1 and c <= 128


def conv3x3_packed_plain(xk: torch.Tensor, w: torch.Tensor,
                         bias: torch.Tensor, wdim: int) -> torch.Tensor:
    """Plain version: ``w`` rounded to ``xk``'s dtype, f32 products and sums,
    f32 bias, result cast to ``xk``'s dtype (as the TPU kernel does)."""
    b, d, cin, hw = xk.shape
    cout = w.shape[4]
    x = xk.reshape(b, d, cin, hw // wdim, wdim).permute(0, 2, 1, 3, 4)
    wt = w.to(xk.dtype).float().permute(4, 3, 0, 1, 2)  # (O, I, kd, kh, kw)
    y = F.conv3d(x.float(), wt, bias.float(), padding=1)
    return y.permute(0, 2, 1, 3, 4).reshape(b, d, cout, hw).to(xk.dtype)


def conv3x3_packed(xk: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                   wdim: int) -> torch.Tensor:
    """SAME 3x3x3 conv of ``xk`` (B, D, Cin, H·W) with ``w`` (3, 3, 3, Cin,
    Cout) and ``bias`` (Cout,) → (B, D, Cout, H·W) in ``xk``'s dtype.

    A CPU tensor takes :func:`conv3x3_packed_plain`; a CUDA tensor launches
    the kernel (forward only) or raises."""
    if xk.device.type == "cpu":
        return conv3x3_packed_plain(xk, w, bias, wdim)
    if xk.device.type != "cuda":
        raise ValueError(f"conv3x3_packed: unsupported device {xk.device}")
    b, d, cin, hw = xk.shape
    if w.shape[:4] != (3, 3, 3, cin) or bias.shape != (w.shape[4],):
        raise ValueError(f"conv3x3_packed: weight {tuple(w.shape)} / bias "
                         f"{tuple(bias.shape)} do not fit input {tuple(xk.shape)}")
    if hw % wdim:
        raise ValueError(f"conv3x3_packed: H·W={hw} is not a multiple of W={wdim}")
    if xk.dtype not in _DTYPES:
        raise TypeError(f"conv3x3_packed: dtype {xk.dtype} not supported")
    if not xk.is_contiguous():
        raise ValueError("conv3x3_packed: input must be contiguous")
    if b * d > 65535:
        raise ValueError("conv3x3_packed: B·D exceeds the grid limit 65535")
    if w.device != xk.device or bias.device != xk.device:
        raise ValueError("conv3x3_packed: weight, bias and input on different devices")
    if torch.is_grad_enabled() and (xk.requires_grad or w.requires_grad
                                    or bias.requires_grad):
        raise NotImplementedError(
            "conv3x3_packed: the CUDA kernel is forward-only")
    cout = w.shape[4]
    wk = w.detach().to(xk.dtype).contiguous()  # rounded as the TPU kernel does
    bk = bias.detach().float().contiguous()
    y = torch.empty((b, d, cout, hw), dtype=xk.dtype, device=xk.device)
    lib = _lib()
    fn = (lib.conv3x3_packed_bf16 if xk.dtype == torch.bfloat16
          else lib.conv3x3_packed_f32)
    with torch.cuda.device(xk.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(xk.data_ptr(), wk.data_ptr(), bk.data_ptr(), y.data_ptr(),
                b, d, cin, cout, hw // wdim, wdim, stream)
    _build.check(lib, rc, "conv3x3_packed")
    conv3x3_packed.launches += 1
    return y


conv3x3_packed.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("conv3x3_packed")
    if not getattr(lib, "_typed", False):
        for fn in (lib.conv3x3_packed_f32, lib.conv3x3_packed_bf16):
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        lib._typed = True
    return lib
