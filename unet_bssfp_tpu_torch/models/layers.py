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
``space`` split of d, what is local runs on each shard with the replica of
the module on the shard's mesh entry (``parallel.mesh.place``) (1³ and k2s2 convs, eval-mode BatchNorm,
pools, concat, activations); a 3³ conv first takes one d slice from each
``space`` neighbour (``halo_d``) and then pads only (h, w); InstanceNorm
sums its shards' moments over ``space`` (``all_sum``); the
discriminator's k4 s2 p1 conv takes one d slice from each neighbour too and
pads (h, w) only. Train-mode BatchNorm takes its moments over the global
batch, every shard's combined over both mesh axes (or, inside
:func:`row_moments`, over each data row's ``space`` shards: the
``ddp_parity`` mode), and updates its running statistics once per forward.
In the JAX package XLA inserts these exchanges from the sharding
annotations.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from unet_bssfp_tpu_torch.ops.kernels import fused_instance_norm_leaky_relu
from unet_bssfp_tpu_torch.ops.kernels.packed_norm_act import (
    _f32,
    _norm_affine,
    _var_mean,
    activation,
    drop,
    instance_norm_f32,
)
from unet_bssfp_tpu_torch.parallel import distributed
from unet_bssfp_tpu_torch.parallel.mesh import (
    AXES,
    Sharded,
    apply_local,
    local,
    place,
    replica_seed,
    replicas,
)


def to_ncdhw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3)


def to_ndhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1).contiguous()


def instance_norm(x, norm: "InstanceNorm", dims, channel_dim: int, guard=None):
    """:func:`instance_norm_f32` with ``norm``'s affine, of a tensor or of a
    sharded volume, whose moments are those of the *whole* volume. Under a
    ``space`` split each shard takes its own f32 mean and biased variance
    over ``dims`` (the same two moments, by the same reduction, as the
    unsharded function); the shards of one data row, all of one size, are
    combined exactly (Chan et al.): ``mean = Σ mean_i / n`` and ``var =
    Σ (var_i + (mean_i - mean)²) / n``, two ``all_sum`` s of (B, C)-sized
    tensors over ``space``. Against the unsharded result only the order of
    summation differs. ``guard`` (the packed layout's guard columns, see
    :func:`_var_mean`): every moment, a shard's too, counts the data
    columns alone; each shard holds as many as the next, so the combination
    stays exact. Returns f32."""
    def affine(t, *moments):
        mod = local(norm, place(t))
        if not moments:
            return instance_norm_f32(t, mod.weight, mod.bias, norm.epsilon, dims,
                                     channel_dim, guard)
        return _norm_affine(t, *moments, mod.weight, mod.bias, norm.epsilon, channel_dim)

    if not isinstance(x, Sharded) or x.mesh.size("space") == 1:
        return apply_local(affine, x)
    xf, mean, var = _chan_moments(x, dims, "space", x.mesh.size("space"), guard)
    return xf.map(affine, mean, var)


def _chan_moments(x: Sharded, dims, axes, n: int, guard=None):
    """The f32 mean and biased variance over ``dims`` of the union of ``n``
    equal-sized shards, each shard's own moments (over its data columns
    alone with ``guard``: :func:`_var_mean`) combined exactly (Chan et
    al.) by two ``all_sum`` s over ``axes``: ``mean = Σ mean_i / n``,
    ``var = Σ (var_i + (mean_i - mean)²) / n``. Returns ``(x in f32, mean,
    var)``, the moments as sharded values of equal bits at every member."""
    xf = x.map(_f32)
    stats = xf.map(lambda t: torch.stack(_var_mean(t, dims, guard)))  # [var_i, mean_i]
    mean = stats.map(lambda s: s[1]).all_sum(axes).map(lambda m: m / n)
    var = stats.map(lambda s, m: s[0] + (s[1] - m) ** 2, mean
                    ).all_sum(axes).map(lambda v: v / n)
    return xf, mean, var


def _on_shards(module: nn.Module, x: Sharded, method: str = "forward") -> Sharded:
    """A module's local op on every shard, by the shard's device's replica."""
    return x.map(lambda t: getattr(local(module, place(t)), method)(t))


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


class Conv(nn.Conv3d):
    """Flax ``nn.Conv`` on NDHWC: input, kernel and bias cast to
    ``compute_dtype`` (default: the input's dtype); ``bias=False``: none."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, compute_dtype: Optional[torch.dtype] = None,
                 bias: bool = True):
        super().__init__(cin, cout, kernel, stride, padding, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        if not isinstance(x, Sharded):
            return self._conv(x, self.padding)
        # windows that do not overlap (1³, k2s2) are local to a shard
        local_windows = self.kernel_size == self.stride and self.padding == (0, 0, 0)
        if local_windows or x.mesh.size("space") == 1:
            return _on_shards(self, x)
        geometry = (self.kernel_size, self.stride, self.padding)
        if geometry == ((4, 4, 4), (2, 2, 2), (1, 1, 1)):
            # output slice o reads input slices 2o-1 .. 2o+2: a shard of even
            # D covers its D/2 outputs with one neighbour slice a side
            if x.shape[1] % 2:
                nd, ns = x.mesh.size("data"), x.mesh.size("space")
                whole = (x.shape[0] * nd, x.shape[1] * ns) + tuple(x.shape[2:])
                raise ValueError(
                    f"k4 s2 conv of volume {whole} on {x.mesh}: the local D "
                    f"{x.shape[1]} is odd, a stride-2 window would span two shards")
        elif geometry != ((3, 3, 3), (1, 1, 1), (1, 1, 1)):
            raise NotImplementedError(
                f"Conv k{self.kernel_size} s{self.stride} p{self.padding} under a "
                f"space split of d: only 3³ SAME, k4 s2 p1 and non-overlapping "
                f"convs are sharded")
        return _on_shards(self, x.halo_d(), "_conv_halo")

    def _conv(self, x: torch.Tensor, padding) -> torch.Tensor:
        dtype = self.compute_dtype or x.dtype
        y = F.conv3d(to_ncdhw(x).to(dtype), self.weight.to(dtype),
                     _cast(self.bias, dtype), self.stride, padding)
        return to_ndhwc(y)

    def _conv_halo(self, xp: torch.Tensor) -> torch.Tensor:
        """The conv (3³ or k4 s2, both p1) on a shard that carries its d
        halo: pad (h, w) only."""
        return self._conv(xp, (0, 1, 1))


class ConvTranspose(nn.ConvTranspose3d):
    """Flax ``nn.ConvTranspose`` (k2/s2) on NDHWC. The Flax kernel maps onto
    torch's ``weight`` with a spatial flip (``weights.from_flax``).
    ``bias=False``: none."""

    def __init__(self, cin: int, cout: int,
                 compute_dtype: Optional[torch.dtype] = None, bias: bool = True):
        super().__init__(cin, cout, 2, 2, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        if isinstance(x, Sharded):
            return _on_shards(self, x)  # k2s2: local
        dtype = self.compute_dtype or x.dtype
        y = F.conv_transpose3d(to_ncdhw(x).to(dtype), self.weight.to(dtype),
                               _cast(self.bias, dtype), self.stride)
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


_ROW_MOMENTS = contextvars.ContextVar("row_moments", default=False)


@contextlib.contextmanager
def row_moments():
    """Inside it, train-mode :class:`BatchNorm` on a sharded batch takes its
    moments per data row (over that row's ``space`` shards), as each device
    of the JAX package's ``ddp_parity`` ``shard_map`` does, and updates its
    running statistics with the mean over rows of each row's update (the
    ``pmean`` of ``batch_stats``)."""
    token = _ROW_MOMENTS.set(True)
    try:
        yield
    finally:
        _ROW_MOMENTS.reset(token)


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``: f32 math, result in
    ``compute_dtype``. Train mode normalises with the batch's mean and biased
    variance over every axis but the channel (last) one, and updates the
    running statistics as ``0.9·running + 0.1·batch`` with that same biased
    variance (``F.batch_norm`` would store the unbiased one). Eval mode uses
    the running statistics.

    On a sharded batch, eval mode is local to each shard; train mode takes
    the moments of the global batch, every shard's combined exactly over
    both mesh axes (as the JAX package's ``jit`` takes them over its sharded
    batch), or per data row inside :func:`row_moments`, and updates the
    running statistics once (on every replica), not once per shard. In a
    process group the global batch spans the processes: the moments
    combine every process's (``distributed.moments``, or the mesh's
    ``all_sum`` over ``data``), and inside :func:`row_moments` each
    process's rows keep their own while the update is the mean over every
    process's rows."""

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
            if not self.training:
                return _on_shards(self, x)
            return self._forward_sharded(x)
        xf = _f32(x)
        if self.training:
            dims = tuple(range(x.ndim - 1))
            if _ROW_MOMENTS.get():  # the process's batch is one data row
                var, mean = torch.var_mean(xf, dim=dims, correction=0)
                self._update(*(_process_mean(m.detach()) for m in (mean, var)))
            else:
                mean, var = (m.flatten() for m in distributed.moments(xf, dims))
                self._update(mean, var)
        else:
            mean, var = _f32(self.running_mean), _f32(self.running_var)
        return self._normalise(xf, mean, var, x.dtype)

    def _normalise(self, xf, mean, var, dtype):
        mul = torch.rsqrt(var + self.epsilon) * _f32(self.weight)
        y = (xf - mean) * mul + _f32(self.bias)
        return y.to(self.compute_dtype or dtype)

    def _update(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """The running statistics' update from one forward's moments, on
        every replica of the module (the moments copied to its device)."""
        with torch.no_grad():
            for mod in replicas(self):
                m, v = mean.to(mod.running_mean.device), var.to(mod.running_var.device)
                mod.running_mean.mul_(self.momentum).add_(m, alpha=1 - self.momentum)
                mod.running_var.mul_(self.momentum).add_(v, alpha=1 - self.momentum)

    def _forward_sharded(self, x: Sharded) -> Sharded:
        mesh, per_row = x.mesh, _ROW_MOMENTS.get()
        axes, n = (("space", mesh.size("space")) if per_row
                   else (AXES, mesh.positions * distributed.process_count()))
        xf, mean, var = _chan_moments(x, tuple(range(len(x.shape) - 1)), axes, n)
        # one update: with the global moments, or with the mean over data
        # rows of each row's (the mean of the rows' updates), every
        # process's rows in a group
        rows = range(mesh.size("data")) if per_row else (0,)
        dev = mean.parts[0][0].device
        moments = (sum(m.parts[i][0].detach().to(dev) for i in rows).flatten() / len(rows)
                   for m in (mean, var))
        self._update(*(_process_mean(m) if per_row else m for m in moments))
        return xf.map(lambda t, m, v: local(self, place(t))._normalise(t, m, v, x.dtype),
                      mean, var)


def _process_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the processes (``t`` without a group)."""
    n = distributed.process_count()
    return t if n == 1 else distributed.sum_in_place(t.clone()) / n


class Dropout(nn.Module):
    """Flax ``nn.Dropout``: in train mode keep each element with probability
    ``1 - rate`` and scale the kept ones by ``1 / (1 - rate)``. The mask is
    drawn from ``self.generator`` (a ``torch.Generator`` on the input's
    device, bound by :func:`bind_dropout_generator`; each replica on a
    mesh has its own, :func:`bind_dropout_generators`), never from the
    global RNG; an unbound module in train mode with ``rate > 0`` raises."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    @property
    def keep(self) -> float:
        return 1.0 - self.rate

    def draw(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        """The next f32 ``bernoulli_(keep)`` draw of ``x``'s shape from the
        bound generator (1 keeps the element), or None where nothing drops
        (eval mode, rate 0)."""
        if not self.training or self.rate == 0.0:
            return None
        if self.generator is None:
            raise RuntimeError("Dropout in train mode needs a torch.Generator: "
                               "call bind_dropout_generator(model, generator)")
        return torch.empty(x.shape, device=x.device).bernoulli_(
            self.keep, generator=self.generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return drop(x, self.draw(x), self.keep)


def bind_dropout_generator(model: nn.Module,
                           generator: Optional[torch.Generator]) -> None:
    """Point every :class:`Dropout` of ``model`` at ``generator``."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


def bind_dropout_generators(model: nn.Module, seed: int) -> Tuple[torch.Generator, ...]:
    """One dropout generator per replica of ``model`` (``model`` alone if
    it has none), each on its replica's device and bound to its
    :class:`Dropout` s: the k-th replica's (in the mesh's device order, the
    master first) seeded from ``parallel.mesh.replica_seed(seed, rank ·
    replicas + k)``, so process 0's master's from ``seed`` and every
    process's replicas from seeds of their own. Returns them in that
    order."""
    gens, twins = [], replicas(model)
    for k, twin in enumerate(twins):
        dev = next(twin.parameters()).device
        index = distributed.process_index() * len(twins) + k
        gens.append(torch.Generator(device=dev).manual_seed(replica_seed(seed, index)))
        bind_dropout_generator(twin, gens[-1])
    return tuple(gens)


def remat(module: nn.Module, fn, *args):
    """``fn(*args)`` (a block of ``module``) under
    ``torch.utils.checkpoint``: its activations are dropped after the
    forward and recomputed in the backward (the JAX package's ``nn.remat``).
    ``checkpoint``'s own RNG stash covers only the global generators, not
    the one bound to ``module``'s :class:`Dropout` s: so the recompute sets
    that generator back to its state before the forward, draws the same
    masks, and leaves it where it was found, as if nothing had been
    recomputed: the generators of ``module``'s replicas too."""
    gens = list({id(m.generator): m.generator for twin in replicas(module)
                 for m in twin.modules()
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
    homogeneous and the dropout mask non-negative). ``prelu`` (the
    multi-stage backbone's activation): a learnable slope per channel,
    parameter ``prelu_slope`` initialised at ``negative_slope``, applied
    after the dropout as ``where(y >= 0, y, slope·y)``; the fused kernel
    takes a static slope, so ``prelu`` runs the norm unfused."""

    def __init__(self, cin: int, features: int, dropout: float = 0.0,
                 negative_slope: float = 0.1,
                 compute_dtype: Optional[torch.dtype] = None,
                 use_fused: bool = False, prelu: bool = False):
        super().__init__()
        use_fused = use_fused and not prelu
        self.conv = Conv(cin, features, 3, 1, 1, compute_dtype)
        self.norm = InstanceNorm(
            features, compute_dtype=compute_dtype,
            fused_slope=negative_slope if use_fused else None)
        self.drop = Dropout(dropout)
        if prelu:
            self.prelu_slope = nn.Parameter(torch.full((features,), float(negative_slope)))
        self.prelu = prelu
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
        return self._act(x, channel_dim=-1)

    def _slope(self):
        """LeakyReLU's float, or with ``prelu`` the learnable slope vector."""
        return self.prelu_slope if self.prelu else self.negative_slope

    def _act(self, x: torch.Tensor, channel_dim: int) -> torch.Tensor:
        """LeakyReLU, or with ``prelu`` the learnable slope of the channels
        on ``channel_dim``, in ``x``'s dtype."""
        return activation(x, self._slope(), channel_dim)


class TwoConv(nn.Module):
    """Two stacked ConvNormAct blocks (MONAI ``TwoConv``)."""

    block = ConvNormAct

    def __init__(self, cin: int, features: int, dropout: float = 0.0,
                 negative_slope: float = 0.1,
                 compute_dtype: Optional[torch.dtype] = None,
                 use_fused: bool = False, prelu: bool = False):
        super().__init__()
        self.conv_0 = self.block(cin, features, dropout, negative_slope,
                                 compute_dtype, use_fused, prelu)
        self.conv_1 = self.block(features, features, dropout, negative_slope,
                                 compute_dtype, use_fused, prelu)

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
                 use_fused: bool = False, prelu: bool = False):
        super().__init__()
        self.convs = self.convs_cls(cin, features, dropout, negative_slope,
                                    compute_dtype, use_fused, prelu)

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
                 use_fused: bool = False, prelu: bool = False):
        super().__init__()
        self.upsample = ConvTranspose(cin, up_features, compute_dtype)
        self.convs = self.convs_cls(skip_channels + up_features, features,
                                    dropout, negative_slope, compute_dtype,
                                    use_fused, prelu)

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
