"""K1 and K2: the 3x3x3 SAME conv + bias on the packed ``(B, D, C, H·W)``
layout, under autograd.

Replaces ``unet_bssfp_tpu/ops/pallas/conv3d.py::conv3x3_packed`` and its
custom VJP (``_vjp_bwd``):

- forward: K1, ``csrc/conv3x3_packed.cu`` (``_conv_fwd_impl``);
- dx: K1 again, on ``dy`` with the weight flipped in (kd, kh, kw) and
  transposed in (ci, co), zero bias (:func:`conv3x3_packed_dgrad`);
- dw: K2, ``csrc/conv3x3_wgrad.cu`` (``_dw_impl``), f32
  (:func:`conv3x3_wgrad`);
- db: ``Σ dy`` in f32.

Each source's header says what bounds it on the card and how it is laid
out. ``*_plain`` are the same functions in plain PyTorch: the CPU path, and
the references the kernels are held to. :func:`conv3x3_packed` is the same
``autograd.Function`` on both devices; what it launches inside picks the
kernel or the plain version by the tensor's device.
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


def conv3x3_wgrad_plain(xk: torch.Tensor, dy: torch.Tensor,
                        wdim: int) -> torch.Tensor:
    """Plain version of K2: the f32 gradient of :func:`conv3x3_packed_plain`
    with respect to ``w`` (3, 3, 3, Cin, Cout), by autograd, for the
    cotangent ``dy`` (B, D, Cout, H·W)."""
    cin, cout = xk.shape[2], dy.shape[2]
    w = torch.zeros((3, 3, 3, cin, cout), dtype=torch.float32,
                    device=xk.device, requires_grad=True)
    zero = torch.zeros(cout, dtype=torch.float32, device=xk.device)
    with torch.enable_grad():
        y = conv3x3_packed_plain(xk.detach().float(), w, zero, wdim)
        (dw,) = torch.autograd.grad(y, w, dy.float())
    return dw


def _check_packed(what: str, xk: torch.Tensor, wdim: int) -> None:
    if xk.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {xk.dtype} not supported")
    if not xk.is_contiguous():
        raise ValueError(f"{what}: input must be contiguous")
    if xk.shape[3] % wdim:
        raise ValueError(f"{what}: H·W={xk.shape[3]} is not a multiple of W={wdim}")
    if xk.shape[0] * xk.shape[1] > 65535:
        raise ValueError(f"{what}: B·D exceeds the grid limit 65535")


def _conv_fwd(xk: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
              wdim: int, what: str) -> torch.Tensor:
    """One K1 launch (CUDA) or the plain version (CPU); no autograd."""
    if xk.device.type == "cpu":
        return conv3x3_packed_plain(xk, w, bias, wdim)
    if xk.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {xk.device}")
    b, d, cin, hw = xk.shape
    if w.shape[:4] != (3, 3, 3, cin) or bias.shape != (w.shape[4],):
        raise ValueError(f"{what}: weight {tuple(w.shape)} / bias "
                         f"{tuple(bias.shape)} do not fit input {tuple(xk.shape)}")
    _check_packed(what, xk, wdim)
    if w.device != xk.device or bias.device != xk.device:
        raise ValueError(f"{what}: weight, bias and input on different devices")
    cout = w.shape[4]
    wk = w.detach().to(xk.dtype).contiguous()  # rounded as the TPU kernel does
    bk = bias.detach().float().contiguous()
    y = torch.empty((b, d, cout, hw), dtype=xk.dtype, device=xk.device)
    lib = _lib("conv3x3_packed")
    fn = (lib.conv3x3_packed_bf16 if xk.dtype == torch.bfloat16
          else lib.conv3x3_packed_f32)
    with torch.cuda.device(xk.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(xk.data_ptr(), wk.data_ptr(), bk.data_ptr(), y.data_ptr(),
                b, d, cin, cout, hw // wdim, wdim, stream)
    _build.check(lib, rc, what)
    return y


def conv3x3_packed_dgrad(dy: torch.Tensor, w: torch.Tensor,
                         wdim: int) -> torch.Tensor:
    """dx of the packed conv: K1 on ``dy`` (B, D, Cout, H·W) with ``w``
    flipped in (kd, kh, kw), transposed to (3, 3, 3, Cout, Cin) and cast to
    ``dy``'s dtype, zero bias → (B, D, Cin, H·W) in ``dy``'s dtype."""
    wt = w.detach().flip(0, 1, 2).transpose(3, 4).to(dy.dtype).contiguous()
    zero = torch.zeros(wt.shape[4], dtype=torch.float32, device=dy.device)
    dx = _conv_fwd(dy, wt, zero, wdim, "conv3x3_packed_dgrad")
    if dy.device.type == "cuda":
        conv3x3_packed_dgrad.launches += 1
    return dx


def conv3x3_wgrad(xk: torch.Tensor, dy: torch.Tensor, wdim: int) -> torch.Tensor:
    """K2: f32 dw (3, 3, 3, Cin, Cout) of the packed conv from its input
    ``xk`` (B, D, Cin, H·W) and cotangent ``dy`` (B, D, Cout, H·W), both of
    one dtype. A CPU tensor takes :func:`conv3x3_wgrad_plain`; a CUDA tensor
    launches the kernel or raises."""
    if xk.device.type == "cpu":
        return conv3x3_wgrad_plain(xk, dy, wdim)
    if xk.device.type != "cuda":
        raise ValueError(f"conv3x3_wgrad: unsupported device {xk.device}")
    b, d, cin, hw = xk.shape
    cout = dy.shape[2]
    if dy.shape != (b, d, cout, hw) or dy.dtype != xk.dtype or dy.device != xk.device:
        raise ValueError(f"conv3x3_wgrad: dy {tuple(dy.shape)} {dy.dtype} does not "
                         f"fit x {tuple(xk.shape)} {xk.dtype}")
    _check_packed("conv3x3_wgrad", xk, wdim)
    _check_packed("conv3x3_wgrad", dy, wdim)
    lib = _lib("conv3x3_wgrad")
    bf16 = xk.dtype == torch.bfloat16
    h = hw // wdim
    splits = lib.conv3x3_wgrad_splits(b, d, cin, cout, h, wdim, int(bf16))
    part = torch.empty((splits, 27 * cin * cout), dtype=torch.float32, device=xk.device)
    dw = torch.empty((3, 3, 3, cin, cout), dtype=torch.float32, device=xk.device)
    fn = lib.conv3x3_wgrad_bf16 if bf16 else lib.conv3x3_wgrad_f32
    with torch.cuda.device(xk.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(xk.data_ptr(), dy.data_ptr(), part.data_ptr(), dw.data_ptr(),
                b, d, cin, cout, h, wdim, stream)
    _build.check(lib, rc, "conv3x3_wgrad")
    conv3x3_wgrad.launches += 1
    return dw


def conv3x3_wgrad_chain(xk: torch.Tensor, dy: torch.Tensor, wdim: int) -> int:
    """The longest run of f32 roundings one product passes through in K2
    for these CUDA operands (the item's accumulator, the split's sum of
    items, the sum of splits): the length that bounds K2's rounding error."""
    b, d, cin, hw = xk.shape
    return _lib("conv3x3_wgrad").conv3x3_wgrad_chain(
        b, d, cin, dy.shape[2], hw // wdim, wdim, int(xk.dtype == torch.bfloat16))


class _Conv3x3Packed(torch.autograd.Function):
    """``conv3x3_packed``'s custom VJP (``conv3d.py:573-591``)."""

    @staticmethod
    def forward(ctx, xk, w, bias, wdim):
        ctx.save_for_backward(xk, w)
        ctx.wdim = wdim
        ctx.bias_dtype = bias.dtype
        y = _conv_fwd(xk, w, bias, wdim, "conv3x3_packed")
        if xk.device.type == "cuda":
            conv3x3_packed.launches += 1
        return y

    @staticmethod
    def backward(ctx, dy):
        xk, w = ctx.saved_tensors
        dy = dy.to(xk.dtype).contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3_packed_dgrad(dy, w, ctx.wdim).to(xk.dtype)
        if ctx.needs_input_grad[1]:
            dw = conv3x3_wgrad(xk, dy, ctx.wdim).to(w.dtype)
        if ctx.needs_input_grad[2]:
            db = dy.float().sum(dim=(0, 1, 3)).to(ctx.bias_dtype)
        return dx, dw, db, None


def conv3x3_packed(xk: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                   wdim: int) -> torch.Tensor:
    """SAME 3x3x3 conv of ``xk`` (B, D, Cin, H·W) with ``w`` (3, 3, 3, Cin,
    Cout) and ``bias`` (Cout,) → (B, D, Cout, H·W) in ``xk``'s dtype,
    differentiable in all three. On a CPU tensor every part (forward, dx,
    dw) takes its plain version; on a CUDA tensor each launches its kernel
    or raises."""
    return _Conv3x3Packed.apply(xk, w, bias, wdim)


conv3x3_packed.launches = 0
conv3x3_packed_dgrad.launches = 0
conv3x3_wgrad.launches = 0

_ARGTYPES = {
    "conv3x3_packed": {
        name: ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        for name in ("conv3x3_packed_f32", "conv3x3_packed_bf16")},
    "conv3x3_wgrad": {
        **{name: ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
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
