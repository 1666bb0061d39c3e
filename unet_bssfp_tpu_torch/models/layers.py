"""Building-block 3D conv modules on NDHWC activations.

Counterpart of ``unet_bssfp_tpu/models/layers.py``. Activations are
physically NDHWC: ``x.permute(0, 4, 1, 2, 3)`` is then a zero-copy
``channels_last_3d`` view that ``F.conv3d`` takes as is. Parameters are f32
and carry the Flax names (``conv``, ``norm``, ``bn``, ``upsample``; kernels as
torch's ``weight``); each module computes in ``compute_dtype`` as its Flax
twin does with ``dtype``. ``module.train()`` / ``.eval()`` take the place of
Flax's ``train`` argument: BatchNorm normalises with the batch's moments and
updates its running statistics in train mode, and Dropout draws its masks in
train mode only, from the ``torch.Generator`` bound to it
(:func:`bind_dropout_generator`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from unet_bssfp_tpu_torch.ops.kernels import fused_instance_norm_leaky_relu


def to_ncdhw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3)


def to_ndhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1).contiguous()


def instance_norm_f32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      epsilon: float, dims, channel_dim: int) -> torch.Tensor:
    """f32 per-(sample, channel) moments over ``dims`` (biased, as
    ``jnp.var``), then the affine; returns f32. Written as few full-size
    passes as eager PyTorch allows: the stats in one reduction, the affine
    folded into one per-channel multiplier."""
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=dims, correction=0, keepdim=True)
    shape = [1] * x.ndim
    shape[channel_dim] = -1
    mul = torch.rsqrt(var + epsilon) * scale.float().reshape(shape)
    return torch.addcmul(bias.float().reshape(shape), xf - mean, mul)


class Conv(nn.Conv3d):
    """Flax ``nn.Conv`` on NDHWC: input, kernel and bias cast to
    ``compute_dtype`` (default: the input's dtype)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, compute_dtype: Optional[torch.dtype] = None):
        super().__init__(cin, cout, kernel, stride, padding)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype or x.dtype
        y = F.conv3d(to_ncdhw(x).to(dtype), self.weight.to(dtype),
                     self.bias.to(dtype), self.stride, self.padding)
        return to_ndhwc(y)


class ConvTranspose(nn.ConvTranspose3d):
    """Flax ``nn.ConvTranspose`` (k2/s2) on NDHWC. The Flax kernel maps onto
    torch's ``weight`` with a spatial flip (``weights.from_flax``)."""

    def __init__(self, cin: int, cout: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(cin, cout, 2, 2)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype or x.dtype
        y = F.conv_transpose3d(to_ncdhw(x).to(dtype), self.weight.to(dtype),
                               self.bias.to(dtype), self.stride)
        return to_ndhwc(y)


class InstanceNorm(nn.Module):
    """InstanceNorm3d(affine) with f32 moments, eps 1e-5 (Flax param
    ``scale`` is ``weight`` here). ``fused_slope``: apply LeakyReLU(slope)
    too, through the fused kernel on CUDA (``ops.kernels.norm_act``)."""

    def __init__(self, features: int, epsilon: float = 1e-5,
                 compute_dtype: Optional[torch.dtype] = None,
                 fused_slope: Optional[float] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.epsilon = epsilon
        self.compute_dtype = compute_dtype
        self.fused_slope = fused_slope

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype or x.dtype
        if self.fused_slope is not None:
            return fused_instance_norm_leaky_relu(
                x.contiguous(), self.weight, self.bias, self.fused_slope,
                self.epsilon).to(dtype)
        y = instance_norm_f32(x, self.weight, self.bias, self.epsilon,
                              dims=(1, 2, 3), channel_dim=-1)
        return y.to(dtype)


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``: f32 math, result in
    ``compute_dtype``. Train mode normalises with the batch's mean and biased
    variance over every axis but the channel (last) one, and updates the
    running statistics as ``0.9·running + 0.1·batch`` with that same biased
    variance (``F.batch_norm`` would store the unbiased one). Eval mode uses
    the running statistics."""

    momentum = 0.9

    def __init__(self, features: int, epsilon: float = 1e-5,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.epsilon = epsilon
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype or x.dtype
        xf = x.float()
        if self.training:
            var, mean = torch.var_mean(xf, dim=tuple(range(x.ndim - 1)),
                                       correction=0)
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_(mean, alpha=1 - self.momentum)
                self.running_var.mul_(self.momentum).add_(var, alpha=1 - self.momentum)
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        mul = torch.rsqrt(var + self.epsilon) * self.weight.float()
        y = (xf - mean) * mul + self.bias.float()
        return y.to(dtype)


class Dropout(nn.Module):
    """Flax ``nn.Dropout``: in train mode keep each element with probability
    ``1 - rate`` and scale the kept ones by ``1 / (1 - rate)``. The mask is
    drawn from ``self.generator`` (a ``torch.Generator`` on the input's
    device, bound by :func:`bind_dropout_generator`), never from the global
    RNG; an unbound module in train mode with ``rate > 0`` raises."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("Dropout in train mode needs a torch.Generator: "
                               "call bind_dropout_generator(model, generator)")
        keep = 1.0 - self.rate
        mask = torch.empty(x.shape, device=x.device).bernoulli_(
            keep, generator=self.generator).bool()
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


def bind_dropout_generator(model: nn.Module,
                           generator: Optional[torch.Generator]) -> None:
    """Point every :class:`Dropout` of ``model`` at ``generator``."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


class ConvBlock(nn.Module):
    """Conv3d + optional BatchNorm + LeakyReLU (the reference
    ``DownSampleConv``); the generator's input head uses k1/s1/p0."""

    def __init__(self, cin: int, features: int, kernel: int = 4,
                 stride: int = 2, padding: int = 1, activation: bool = True,
                 batchnorm: bool = True, negative_slope: float = 0.2,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = Conv(cin, features, kernel, stride, padding, compute_dtype)
        self.bn = BatchNorm(features, compute_dtype=compute_dtype) if batchnorm else None
        self.activation = activation
        self.negative_slope = negative_slope

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.activation:
            x = F.leaky_relu(x, self.negative_slope)
        return x


class ConvNormAct(nn.Module):
    """Conv3d(k3, p1) → InstanceNorm(affine) → Dropout → LeakyReLU.
    ``use_fused`` folds norm and activation into the fused kernel and drops
    out after the activation (the two commute: LeakyReLU is positively
    homogeneous and the dropout mask non-negative)."""

    def __init__(self, cin: int, features: int, dropout: float = 0.0,
                 negative_slope: float = 0.1,
                 compute_dtype: Optional[torch.dtype] = None,
                 use_fused: bool = False):
        super().__init__()
        self.conv = Conv(cin, features, 3, 1, 1, compute_dtype)
        self.norm = InstanceNorm(
            features, compute_dtype=compute_dtype,
            fused_slope=negative_slope if use_fused else None)
        self.drop = Dropout(dropout)
        self.use_fused = use_fused
        self.negative_slope = negative_slope
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm(self.conv(x))
        x = self.drop(x)
        if self.use_fused:
            return x
        return F.leaky_relu(x, self.negative_slope)


class TwoConv(nn.Module):
    """Two stacked ConvNormAct blocks (MONAI ``TwoConv``)."""

    block = ConvNormAct

    def __init__(self, cin: int, features: int, dropout: float = 0.0,
                 negative_slope: float = 0.1,
                 compute_dtype: Optional[torch.dtype] = None,
                 use_fused: bool = False):
        super().__init__()
        self.conv_0 = self.block(cin, features, dropout, negative_slope,
                                 compute_dtype, use_fused)
        self.conv_1 = self.block(features, features, dropout, negative_slope,
                                 compute_dtype, use_fused)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_1(self.conv_0(x))


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2×2×2 max-pool, stride 2, on NDHWC."""
    return to_ndhwc(F.max_pool3d(to_ncdhw(x), 2, 2))


class Down(nn.Module):
    """Max-pool(2) then TwoConv (MONAI ``Down``)."""

    convs_cls = TwoConv

    def __init__(self, cin: int, features: int, dropout: float = 0.0,
                 negative_slope: float = 0.1,
                 compute_dtype: Optional[torch.dtype] = None,
                 use_fused: bool = False):
        super().__init__()
        self.convs = self.convs_cls(cin, features, dropout, negative_slope,
                                    compute_dtype, use_fused)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.convs(max_pool2(x))


class UpCat(nn.Module):
    """Transpose-conv ×2 → edge-pad to the skip's size → concat(skip, up) →
    TwoConv (MONAI ``UpCat``, mode 'deconv')."""

    convs_cls = TwoConv

    def __init__(self, cin: int, skip_channels: int, features: int,
                 up_features: int, dropout: float = 0.0,
                 negative_slope: float = 0.1,
                 compute_dtype: Optional[torch.dtype] = None,
                 use_fused: bool = False):
        super().__init__()
        self.upsample = ConvTranspose(cin, up_features, compute_dtype)
        self.convs = self.convs_cls(skip_channels + up_features, features,
                                    dropout, negative_slope, compute_dtype,
                                    use_fused)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = self.upsample(x)
        pads = []
        for ax in (3, 2, 1):  # F.pad lists the last dim first
            diff = skip.shape[ax] - x.shape[ax]
            pads += [diff // 2, diff - diff // 2]
        if any(pads):
            x = to_ndhwc(F.pad(to_ncdhw(x), pads, mode="replicate"))
        return self.convs(torch.cat([skip, x], dim=-1))
