"""K10: the packed stages' InstanceNorm → dropout → LeakyReLU/PReLU → cast
chain after each packed conv, forward and backward, in hand-written CUDA.

No TPU kernel is replaced: in the JAX package XLA fused this chain
(``unet_bssfp_tpu/models/packed_layers.py:76-135``). The kernels are
``csrc/packed_norm_act.cu`` (its header says what bounds them and how the
two launches of each direction split the work); :func:`plan` is their launch
plan. :func:`packed_norm_act` routes by its input: a CUDA tensor in bf16 or
f32 takes the kernels (through :class:`_PackedNormAct` where a gradient is
taken, else the forward alone); a CPU tensor takes
:func:`packed_norm_act_plain`, the chain as the port ran it before the
kernels, whose backward is autograd's. The dropout draw is the caller's:
``torch.empty(shape).bernoulli_(keep, generator)`` of the packed shape, as
``models.layers.Dropout.draw`` makes it, so that the kernels drop exactly
the elements the plain chain drops.

:func:`packed_norm_act_model` runs :class:`_PackedNormAct` with the
kernels' formulas written in PyTorch (the moments kept, the backward in
closed form): on the CPU it holds those formulas against autograd of the
plain chain.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from unet_bssfp_tpu_torch.ops.kernels import _build
from unet_bssfp_tpu_torch.ops.kernels.conv3d import guard_mask

# Elements of one CTA's chunk (csrc/packed_norm_act.cu: THREADS · PER_THREAD).
CHUNK = 8192
# csrc/packed_norm_act.cu's flags
_PRELU, _DROP, _SAVE, _DX, _PARAMS = 1, 2, 4, 8, 16
_IN_DTYPES = (torch.bfloat16, torch.float32)

Slope = Union[float, torch.Tensor]


# --- the chain as the port ran it before the kernels (the CPU path) ---

def _f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32 (an f64 tensor, which only tests pass, stays f64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _var_mean(xf: torch.Tensor, dims, guard=None):
    """The biased variance and the mean of ``xf`` over ``dims``, kept as
    size-1 dims. ``guard`` = ``(wdim, wguard)`` for a packed tensor whose
    last dim (one of ``dims``) is H·wdim lanes, the last ``wguard`` of every
    w-row zero guard columns: the moments are then those of the data
    columns alone, taken over a view without the guards (the JAX package
    counts the data columns and subtracts the guards' share; the two agree
    up to rounding)."""
    if not guard or not guard[1]:
        return torch.var_mean(xf, dim=dims, correction=0, keepdim=True)
    wdim, wguard = guard
    if xf.ndim - 1 not in dims:
        raise ValueError(f"guarded moments over dims {dims}: the lane dim is not one")
    view = xf.unflatten(-1, (-1, wdim))[..., :wdim - wguard]
    var, mean = torch.var_mean(view, dim=tuple(dims) + (xf.ndim,), correction=0,
                               keepdim=True)
    return var.squeeze(-1), mean.squeeze(-1)


def _norm_affine(xf, mean, var, scale, bias, epsilon, channel_dim):
    shape = [1] * xf.ndim
    shape[channel_dim] = -1
    mul = torch.rsqrt(var + epsilon) * _f32(scale).reshape(shape)
    return torch.addcmul(_f32(bias).reshape(shape), xf - mean, mul)


def instance_norm_f32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      epsilon: float, dims, channel_dim: int, guard=None) -> torch.Tensor:
    """f32 per-(sample, channel) moments over ``dims`` (biased, as
    ``jnp.var``), then the affine; returns f32. Written as few full-size
    passes as eager PyTorch allows: the stats in one reduction, the affine
    folded into one per-channel multiplier. ``guard``: see
    :func:`_var_mean`."""
    xf = _f32(x)
    var, mean = _var_mean(xf, dims, guard)
    return _norm_affine(xf, mean, var, scale, bias, epsilon, channel_dim)


def activation(x: torch.Tensor, slope: Slope, channel_dim: int) -> torch.Tensor:
    """LeakyReLU(``slope``) for a float; for a tensor, PReLU with the slope
    of the channels on ``channel_dim`` (``where(x >= 0, x, slope·x)``), in
    ``x``'s dtype."""
    if not isinstance(slope, torch.Tensor):
        return F.leaky_relu(x, slope)
    shape = [1] * x.ndim
    shape[channel_dim] = -1
    return torch.where(x >= 0, x, slope.to(x.dtype).reshape(shape) * x)


def drop(x: torch.Tensor, draw: Optional[torch.Tensor], keep: float) -> torch.Tensor:
    """Dropout by a draw of ``bernoulli_(keep)``: kept elements scaled by
    ``1 / keep``, the others zero (``x`` itself without a draw)."""
    if draw is None:
        return x
    return torch.where(draw.bool(), x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def packed_norm_act_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                          slope: Slope, wdim: int, wguard: int = 0,
                          draw: Optional[torch.Tensor] = None, keep: float = 1.0,
                          epsilon: float = 1e-5,
                          out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The chain in plain PyTorch on packed ``x`` (B, D, C, H·wdim): f32
    moments over (d, lanes), the data columns' alone, and the affine; the
    dropout; the activation (:func:`activation`); the guards zeroed; the
    result in ``out_dtype`` (default: f32, f64 for f64 ``x``)."""
    y = instance_norm_f32(x, scale, bias, epsilon, dims=(1, 3), channel_dim=2,
                          guard=(wdim, wguard))
    y = guard_mask(activation(drop(y, draw, keep), slope, channel_dim=2), wdim, wguard)
    return y.to(out_dtype or y.dtype)


# --- the launch plan ---

class PlanC(ctypes.Structure):
    """The plan as ``csrc/packed_norm_act.cu`` reads it."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "in_bf16", "out_bf16", "vec", "b", "d", "c", "wdim", "wguard", "k", "grid")] + [
        ("lanes", ctypes.c_longlong)]


@dataclasses.dataclass(frozen=True)
class Plan:
    """One call of K10 on packed (b, d, c, lanes): instance (sample,
    channel) is d rows of ``lanes`` elements; ``k`` chunks of :data:`CHUNK`
    consecutive elements of its d·lanes an instance, one CTA a chunk
    (``grid`` = b·c·k), partials in slots (sample, channel, chunk). ``vec``
    elements a load (8: 16-byte loads of bf16, where ``lanes`` and every
    pointer allow; else 1)."""
    b: int
    d: int
    c: int
    lanes: int
    wdim: int
    wguard: int
    in_bf16: bool
    out_bf16: bool
    vec: int

    @property
    def k(self) -> int:
        return -(-self.d * self.lanes // CHUNK)

    @property
    def grid(self) -> int:
        return self.b * self.c * self.k

    @property
    def count(self) -> int:
        """Data elements of an instance (the guards left out)."""
        return self.d * (self.lanes // self.wdim) * (self.wdim - self.wguard)

    def as_c(self) -> PlanC:
        return PlanC(int(self.in_bf16), int(self.out_bf16), self.vec, self.b, self.d, self.c,
                     self.wdim, self.wguard, self.k, self.grid, self.lanes)


@functools.lru_cache(maxsize=None)
def _plan(shape: Tuple[int, ...], wdim: int, wguard: int, in_bf16: bool, out_bf16: bool,
          aligned: bool) -> Tuple[Plan, PlanC]:
    b, d, c, lanes = shape
    if lanes % wdim or not 0 <= wguard < wdim:
        raise ValueError(f"packed_norm_act: {lanes} lanes are not rows of {wdim} columns "
                         f"with {wguard} guards")
    vec = 8 if aligned and lanes % 8 == 0 else 1
    p = Plan(b, d, c, lanes, wdim, wguard, in_bf16, out_bf16, vec)
    return p, p.as_c()


def plan(shape, wdim: int, wguard: int = 0, in_dtype=torch.bfloat16,
         out_dtype=torch.bfloat16, aligned: bool = True) -> Plan:
    """K10's plan for packed ``shape`` (B, D, C, H·wdim)."""
    return _plan(tuple(shape), wdim, wguard, in_dtype == torch.bfloat16,
                 out_dtype == torch.bfloat16, aligned)[0]


@functools.lru_cache(maxsize=None)
def _inv_keep(keep: float) -> float:
    """``1 / keep`` as ATen's division of an f32 tensor by a CPU scalar
    computes it: the f32 reciprocal, multiplied in."""
    return float(np.float32(1.0) / np.float32(keep))


_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("packed_norm_act")
        lib.packed_norm_act_fwd.argtypes = (
            [ctypes.POINTER(PlanC)] + [ctypes.c_void_p] * 5
            + [ctypes.c_float] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 6)
        lib.packed_norm_act_fwd.restype = ctypes.c_int
        lib.packed_norm_act_bwd.argtypes = (
            [ctypes.POINTER(PlanC)] + [ctypes.c_void_p] * 6
            + [ctypes.c_float] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 8)
        lib.packed_norm_act_bwd.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _aligned(*ts) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in ts)


@dataclasses.dataclass(frozen=True)
class _Spec:
    """What a call fixes besides its tensors."""
    wdim: int
    wguard: int
    keep: float
    epsilon: float
    out_dtype: torch.dtype
    slope_const: float  # LeakyReLU's slope; 0 with a PReLU slope vector


def _check(x: torch.Tensor, draw: Optional[torch.Tensor],
           *params: Optional[torch.Tensor]) -> None:
    if x.dtype not in _IN_DTYPES:
        raise TypeError(f"packed_norm_act: dtype {x.dtype} on {x.device} not supported "
                        "(bf16 or f32)")
    if x.ndim != 4:
        raise ValueError(f"packed_norm_act: needs a packed (B, D, C, H·W) tensor, got "
                         f"{tuple(x.shape)}")
    for p in params:
        if p is not None and (p.shape != (x.shape[2],) or p.device != x.device
                              or p.dtype != torch.float32 or not p.is_contiguous()):
            raise ValueError("packed_norm_act: scale, bias and slope must be contiguous "
                             "(C,) f32 on x's device")
    if draw is not None and (draw.shape != x.shape or draw.device != x.device
                             or draw.dtype != torch.float32 or not draw.is_contiguous()):
        raise ValueError("packed_norm_act: the draw must be a contiguous f32 tensor of x's "
                         "shape on x's device")


# --- the kernels (CUDA) ---

def _cuda_forward(x, scale, bias, slope, draw, spec: _Spec, save: bool):
    """The forward kernels: ``(y, mean, rstd, mask)``; the last three None
    unless ``save`` (mask: None without a draw too)."""
    _check(x, draw, scale, bias, slope)
    x = x.contiguous()
    dev = x.device
    y = torch.empty(x.shape, dtype=spec.out_dtype, device=dev)
    mask = (torch.empty(x.shape, dtype=torch.uint8, device=dev)
            if save and draw is not None else None)
    p, cplan = _plan(tuple(x.shape), spec.wdim, spec.wguard, x.dtype == torch.bfloat16,
                     spec.out_dtype == torch.bfloat16, _aligned(x, draw, y, mask))
    mean = rstd = None
    if save:
        mean, rstd = torch.empty((2, p.b * p.c), dtype=torch.float32, device=dev)
    if x.numel():
        part = torch.empty(3 * p.grid, dtype=torch.float32, device=dev)
        flags = ((_PRELU if slope is not None else 0) | (_DROP if draw is not None else 0)
                 | (_SAVE if save else 0))
        lib = _lib()
        rc = _build.launch(lib.packed_norm_act_fwd, x, ctypes.byref(cplan), x.data_ptr(),
                           _ptr(draw), scale.data_ptr(), bias.data_ptr(), _ptr(slope),
                           spec.slope_const, _inv_keep(spec.keep), spec.epsilon, flags,
                           y.data_ptr(), _ptr(mask), part.data_ptr(), _ptr(mean), _ptr(rstd))
        _build.check(lib, rc, "packed_norm_act")
    packed_norm_act.launches += 1
    return y, mean, rstd, mask


def packed_norm_act_backward(dy, x, scale, bias, slope, mean, rstd, mask, spec: _Spec,
                             want_dx: bool, want_params: bool):
    """The backward kernels on the forward's saved tensors: ``(dx, dscale,
    dbias, dslope)``, None where not wanted."""
    x, dy = x.contiguous(), dy.contiguous()
    dev = x.device
    dx = torch.empty_like(x) if want_dx else None
    p, cplan = _plan(tuple(x.shape), spec.wdim, spec.wguard, x.dtype == torch.bfloat16,
                     spec.out_dtype == torch.bfloat16, _aligned(x, dy, mask, dx))
    dscale = dbias = dslope = None
    if want_params:
        dscale, dbias, dslope = torch.empty((3, p.c), dtype=torch.float32, device=dev)
        if slope is None:
            dslope = None
    if x.numel():
        part = torch.empty(3 * p.grid, dtype=torch.float32, device=dev)
        flags = ((_PRELU if slope is not None else 0) | (_DROP if mask is not None else 0)
                 | (_DX if want_dx else 0) | (_PARAMS if want_params else 0))
        lib = _lib()
        rc = _build.launch(lib.packed_norm_act_bwd, x, ctypes.byref(cplan), x.data_ptr(),
                           dy.data_ptr(), _ptr(mask), scale.data_ptr(), bias.data_ptr(),
                           _ptr(slope), spec.slope_const, _inv_keep(spec.keep),
                           1.0 / p.count, flags, mean.data_ptr(), rstd.data_ptr(),
                           part.data_ptr(), _ptr(dx), _ptr(dscale), _ptr(dbias), _ptr(dslope))
        _build.check(lib, rc, "packed_norm_act_backward")
    packed_norm_act_backward.launches += 1
    return dx, dscale, dbias, dslope


# --- the kernels' formulas in PyTorch (CPU tests of the backward) ---

def _model_forward(x, scale, bias, slope, draw, spec: _Spec, save: bool):
    xf = _f32(x)
    var, mean = _var_mean(xf, (1, 3), (spec.wdim, spec.wguard))
    rstd = torch.rsqrt(var + spec.epsilon)
    z = torch.addcmul(_f32(bias).reshape(1, 1, -1, 1), xf - mean,
                      rstd * _f32(scale).reshape(1, 1, -1, 1))
    y = _tail(z, slope, draw, spec)
    mask = draw.bool() if save and draw is not None else None
    return y, mean, rstd, mask


def _tail(z, slope, draw, spec: _Spec):
    """Dropout, activation, guards and cast of the norm's output ``z``."""
    y = guard_mask(activation(drop(z, draw, spec.keep), slope if slope is not None
                              else spec.slope_const, channel_dim=2), spec.wdim, spec.wguard)
    return y.to(spec.out_dtype)


def _model_backward(dy, x, scale, bias, slope, mean, rstd, mask, spec: _Spec,
                    want_dx: bool, want_params: bool):
    """The closed form the backward kernels compute: g at the norm's output
    from the saved moments and mask, then dx = γ·rstd·(g − mean(g) −
    x̂·mean(g·x̂)) over the data elements, zero at the guards."""
    xf = _f32(x)
    ch = (1, 1, -1, 1)
    xhat = (xf - mean) * rstd
    u = torch.addcmul(_f32(bias).reshape(ch), xf - mean, rstd * _f32(scale).reshape(ch))
    keep = mask if mask is not None else torch.ones((), dtype=torch.bool, device=x.device)
    zero = torch.zeros((), dtype=u.dtype, device=x.device)
    u = torch.where(keep, u / spec.keep, zero)
    ga = guard_mask(dy.to(u.dtype), spec.wdim, spec.wguard)
    s = slope.to(u.dtype).reshape(ch) if slope is not None else spec.slope_const
    pos = u >= 0 if slope is not None else u > 0
    gu = torch.where(pos, ga, ga * s)
    g = torch.where(keep, gu / spec.keep, zero)
    dims = (1, 3)
    n = xf.shape[1] * (xf.shape[3] // spec.wdim) * (spec.wdim - spec.wguard)
    dx = dscale = dbias = dslope = None
    if want_dx:
        dx = _f32(scale).reshape(ch) * rstd * (
            g - g.sum(dims, keepdim=True) / n - xhat * (g * xhat).sum(dims, keepdim=True) / n)
        dx = guard_mask(dx, spec.wdim, spec.wguard).to(x.dtype)
    if want_params:
        dscale = (g * xhat).sum((0, 1, 3)).to(scale.dtype)
        dbias = g.sum((0, 1, 3)).to(bias.dtype)
        if slope is not None:
            dslope = torch.where(u < 0, ga * u, zero).sum(
                (0, 1, 3)).to(slope.dtype)
    return dx, dscale, dbias, dslope


class _PackedNormAct(torch.autograd.Function):
    """The chain with a gradient: the forward saves x, the per-(sample,
    channel) mean and rstd and the 1-byte mask; the backward computes only
    what the inputs ask for (dx; dscale and dbias; dslope for PReLU)."""

    @staticmethod
    def forward(ctx, x, scale, bias, slope, draw, spec, model):
        fwd = _model_forward if model else _cuda_forward
        y, mean, rstd, mask = fwd(x, scale, bias, slope, draw, spec, True)
        ctx.spec, ctx.model = spec, model
        ctx.save_for_backward(x, scale, bias, slope, mean, rstd, mask)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, scale, bias, slope, mean, rstd, mask = ctx.saved_tensors
        need = ctx.needs_input_grad
        bwd = _model_backward if ctx.model else packed_norm_act_backward
        dx, dscale, dbias, dslope = bwd(dy, x, scale, bias, slope, mean, rstd, mask, ctx.spec,
                                        need[0], any(need[1:4]))
        return (dx, dscale if need[1] else None, dbias if need[2] else None,
                dslope if need[3] else None, None, None, None)


def _spec(x, slope, wdim, wguard, draw, keep, epsilon, out_dtype) -> _Spec:
    """The call's constants; ``keep`` counts only with a draw (eval mode
    scales nothing)."""
    return _Spec(wdim, wguard, float(keep) if draw is not None else 1.0, float(epsilon),
                 out_dtype or torch.promote_types(x.dtype, torch.float32),
                 0.0 if isinstance(slope, torch.Tensor) else float(slope))


def packed_norm_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, slope: Slope,
                    wdim: int, wguard: int = 0, draw: Optional[torch.Tensor] = None,
                    keep: float = 1.0, epsilon: float = 1e-5,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The packed stages' norm → dropout → activation → guards → cast on
    ``x`` (B, D, C, H·wdim), as :func:`packed_norm_act_plain` computes it.
    ``slope``: LeakyReLU's float, or PReLU's (C,) parameter; ``draw``: the
    f32 ``bernoulli_(keep)`` draw of ``x``'s shape, or None (no dropout).
    A CPU tensor takes :func:`packed_norm_act_plain`; a CUDA tensor in bf16
    or f32 the kernels (once forward, once backward where a gradient is
    taken), any other raises."""
    if x.device.type == "cpu":
        return packed_norm_act_plain(x, scale, bias, slope, wdim, wguard, draw, keep, epsilon,
                                     out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"packed_norm_act: unsupported device {x.device}")
    spec = _spec(x, slope, wdim, wguard, draw, keep, epsilon, out_dtype)
    vec = slope if isinstance(slope, torch.Tensor) else None
    if spec.out_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"packed_norm_act: {x.dtype} → {spec.out_dtype} not supported")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, scale, bias, vec)):
        return _PackedNormAct.apply(x, scale, bias, vec, draw, spec, False)
    return _cuda_forward(x, scale, bias, vec, draw, spec, False)[0]


def packed_norm_act_model(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                          slope: Slope, wdim: int, wguard: int = 0,
                          draw: Optional[torch.Tensor] = None, keep: float = 1.0,
                          epsilon: float = 1e-5,
                          out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """:func:`packed_norm_act`'s autograd function on any device with the
    kernels' formulas in PyTorch: the saved moments and mask, the backward
    in closed form."""
    spec = _spec(x, slope, wdim, wguard, draw, keep, epsilon, out_dtype)
    vec = slope if isinstance(slope, torch.Tensor) else None
    return _PackedNormAct.apply(x, scale, bias, vec, draw, spec, True)


packed_norm_act.launches = 0
packed_norm_act_backward.launches = 0
