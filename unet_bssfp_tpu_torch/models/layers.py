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

Every module also takes a ``parallel.mesh.Sharded`` value (a volume split
over a mesh's ``data`` and ``space`` axes) and returns one. Under a
``space`` split of d, what is local runs on each shard with the shard's
device's replica of the module (1³ and k2s2 convs, eval-mode BatchNorm,
pools, concat, activations); a 3³ conv first takes one d slice from each
``space`` neighbour (``halo_d``) and then pads only (h, w); InstanceNorm
sums its shards' moments over ``space`` (``all_sum``). In the JAX package
XLA inserts these exchanges from the sharding annotations. Train-mode
BatchNorm and strided 4³ convs (the discriminator) are not sharded yet and
raise.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from unet_bssfp_tpu_torch.ops.kernels import fused_instance_norm_leaky_relu
from unet_bssfp_tpu_torch.parallel.mesh import Sharded, apply_local, local


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
    xf = _f32(x)
    var, mean = torch.var_mean(xf, dim=dims, correction=0, keepdim=True)
    return _norm_affine(xf, mean, var, scale, bias, epsilon, channel_dim)


def _f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32 (an f64 tensor, which only tests pass, stays f64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _norm_affine(xf, mean, var, scale, bias, epsilon, channel_dim):
    shape = [1] * xf.ndim
    shape[channel_dim] = -1
    mul = torch.rsqrt(var + epsilon) * _f32(scale).reshape(shape)
    return torch.addcmul(_f32(bias).reshape(shape), xf - mean, mul)


def instance_norm(x, norm: "InstanceNorm", dims, channel_dim: int):
    """:func:`instance_norm_f32` with ``norm``'s affine, of a tensor or of a
    sharded volume, whose moments are those of the *whole* volume. Under a
    ``space`` split each shard takes its own f32 mean and biased variance
    over ``dims`` (the same two moments, by the same reduction, as the
    unsharded function); the shards of one data row, all of one size, are
    combined exactly (Chan et al.): ``mean = Σ mean_i / n`` and ``var =
    Σ (var_i + (mean_i - mean)²) / n``, two ``all_sum`` s of (B, C)-sized
    tensors over ``space``. Against the unsharded result only the order of
    summation differs. Returns f32."""
    def affine(t, *moments):
        mod = local(norm, t.device)
        if not moments:
            return instance_norm_f32(t, mod.weight, mod.bias, norm.epsilon, dims,
                                     channel_dim)
        return _norm_affine(t, *moments, mod.weight, mod.bias, norm.epsilon, channel_dim)

    if not isinstance(x, Sharded) or x.mesh.size("space") == 1:
        return apply_local(affine, x)
    n = x.mesh.size("space")
    xf = x.map(_f32)
    stats = xf.map(lambda t: torch.stack(torch.var_mean(
        t, dim=dims, correction=0, keepdim=True)))  # [var_i, mean_i]
    mean = stats.map(lambda s: s[1]).all_sum("space").map(lambda m: m / n)
    var = stats.map(lambda s, m: s[0] + (s[1] - m) ** 2, mean
                    ).all_sum("space").map(lambda v: v / n)
    return xf.map(affine, mean, var)


def _on_shards(module: nn.Module, x: Sharded, method: str = "forward") -> Sharded:
    """A module's local op on every shard, by the shard's device's replica."""
    return x.map(lambda t: getattr(local(module, t.device), method)(t))


class Conv(nn.Conv3d):
    """Flax ``nn.Conv`` on NDHWC: input, kernel and bias cast to
    ``compute_dtype`` (default: the input's dtype)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, compute_dtype: Optional[torch.dtype] = None):
        super().__init__(cin, cout, kernel, stride, padding)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        if not isinstance(x, Sharded):
            return self._conv(x, self.padding)
        # windows that do not overlap (1³, k2s2) are local to a shard
        local_windows = self.kernel_size == self.stride and self.padding == (0, 0, 0)
        if local_windows or x.mesh.size("space") == 1:
            return _on_shards(self, x)
        if (self.kernel_size, self.stride, self.padding) != (
                (3, 3, 3), (1, 1, 1), (1, 1, 1)):
            raise NotImplementedError(
                f"Conv k{self.kernel_size} s{self.stride} p{self.padding} under a "
                f"space split of d: only 3³ SAME and non-overlapping convs are sharded")
        return _on_shards(self, x.halo_d(), "_conv_halo")

    def _conv(self, x: torch.Tensor, padding) -> torch.Tensor:
        dtype = self.compute_dtype or x.dtype
        y = F.conv3d(to_ncdhw(x).to(dtype), self.weight.to(dtype),
                     self.bias.to(dtype), self.stride, padding)
        return to_ndhwc(y)

    def _conv_halo(self, xp: torch.Tensor) -> torch.Tensor:
        """The 3³ conv on a shard that carries its d halo: pad (h, w) only."""
        return self._conv(xp, (0, 1, 1))


class ConvTranspose(nn.ConvTranspose3d):
    """Flax ``nn.ConvTranspose`` (k2/s2) on NDHWC. The Flax kernel maps onto
    torch's ``weight`` with a spatial flip (``weights.from_flax``)."""

    def __init__(self, cin: int, cout: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(cin, cout, 2, 2)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        if isinstance(x, Sharded):
            return _on_shards(self, x)  # k2s2: local
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

    def forward(self, x):
        dtype = self.compute_dtype or x.dtype
        if self.fused_slope is None:
            y = instance_norm(x, self, dims=(1, 2, 3), channel_dim=-1)
            return apply_local(lambda t: t.to(dtype), y)
        if isinstance(x, Sharded):
            if x.mesh.positions > 1:
                raise ValueError(
                    "the fused InstanceNorm+LeakyReLU kernel (use_pallas) has no "
                    "sharded route: it takes one whole volume")
            return _on_shards(self, x)
        return fused_instance_norm_leaky_relu(
            x.contiguous(), self.weight, self.bias, self.fused_slope,
            self.epsilon).to(dtype)


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

    def forward(self, x):
        if isinstance(x, Sharded):
            if self.training:
                raise NotImplementedError(
                    "train-mode BatchNorm on a sharded batch (moments over the "
                    "global batch) is not ported yet")
            return _on_shards(self, x)
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


def remat(module: nn.Module, fn, *args):
    """``fn(*args)`` (a block of ``module``) under
    ``torch.utils.checkpoint``: its activations are dropped after the
    forward and recomputed in the backward (the JAX package's ``nn.remat``).
    ``checkpoint``'s own RNG stash covers only the global generators, not
    the one bound to ``module``'s :class:`Dropout` s: so the recompute sets
    that generator back to its state before the forward, draws the same
    masks, and leaves it where it was found, as if nothing had been
    recomputed."""
    gens = list({id(m.generator): m.generator for m in module.modules()
                 if isinstance(m, Dropout) and m.generator is not None}.values())
    before = [g.get_state() for g in gens]

    @contextlib.contextmanager
    def replay():
        now = [g.get_state() for g in gens]
        for g, s in zip(gens, before):
            g.set_state(s)
        try:
            yield
        finally:
            for g, s in zip(gens, now):
                g.set_state(s)

    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(), replay()))


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

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.activation:
            x = apply_local(lambda t: F.leaky_relu(t, self.negative_slope), x)
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

    def forward(self, x):
        x = self.norm(self.conv(x))
        if isinstance(x, Sharded):
            return _on_shards(self, x, "_drop_act")
        return self._drop_act(x)

    def _drop_act(self, x: torch.Tensor) -> torch.Tensor:
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

    def forward(self, x):
        return self.conv_1(self.conv_0(x))


def max_pool2(x):
    """2×2×2 max-pool, stride 2, on NDHWC; local on the shards of a sharded
    volume, whose local D must be even (no window spans two shards)."""
    if isinstance(x, Sharded):
        if x.shape[1] % 2 and x.mesh.size("space") > 1:
            raise ValueError(f"max-pool of shards {tuple(x.shape)}: the local D is "
                             f"odd, a window would span two shards of {x.mesh}")
        return x.map(max_pool2)
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

    def forward(self, x):
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

    def forward(self, x, skip):
        return self.convs(apply_local(pad_cat, self.upsample(x), skip))


def pad_cat(x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
    """Edge-pad ``x`` to ``skip``'s size and concat (skip, x) on channels.
    Local on shards: under a ``space`` split the local D is even at every
    level, so d is never padded."""
    pads = []
    for ax in (3, 2, 1):  # F.pad lists the last dim first
        diff = skip.shape[ax] - x.shape[ax]
        pads += [diff // 2, diff - diff // 2]
    if any(pads):
        x = to_ndhwc(F.pad(to_ncdhw(x), pads, mode="replicate"))
    return torch.cat([skip, x], dim=-1)
