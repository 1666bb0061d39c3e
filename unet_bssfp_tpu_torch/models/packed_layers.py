"""Packed variants of the full-resolution U-Net blocks.

Counterpart of ``unet_bssfp_tpu/models/packed_layers.py`` (and of
``folded_layers.PooledConvs``). The stage's activations live as
``(B, D, C, H·W)``; its convs run through the packed conv kernel
(``ops.kernels.conv3d``) and the relayouts through ``ops.kernels.layout``.
Each class subclasses its plain twin, so parameter names and shapes are the
plain ones (checkpoints are interchangeable), and the plain ``forward``
stays available for shapes the packed path does not take; the packed path
is the ``forward_packed`` method.

The ``wguard`` layout (the JAX package's, opt-in there and here with
``UNET_BSSFP_WGUARD=1``, read at forward time: :func:`guard_cols`): every
w-row of the packed activations carries ``g`` trailing zero guard columns,
``(B, D, C, H·(W+g))``, and the conv kernel's w taps need no SAME-padding
masks (K1W). The modules keep the guards zero: the input is zero-padded
before the pack, every conv block re-zeroes them after its activation
(and its backward zeroes their cotangents), the norm's moments count the
data columns alone, and the pool drops the pooled guards. Parameter names
and shapes do not change with the layout.

Every ``forward_packed`` also takes and returns a ``parallel.mesh.Sharded``
value: the convs go through ``conv3x3_packed_auto`` (a halo exchange over
``space`` and the halo kernel), the norm sums its moments over ``space``,
the rest is local to each shard.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from unet_bssfp_tpu_torch.models.layers import (
    Conv,
    ConvNormAct,
    Down,
    TwoConv,
    UpCat,
    _f32,
    _on_shards,
    instance_norm,
)
from unet_bssfp_tpu_torch.ops.kernels import (
    conv3x3_packed_auto,
    guard_mask,
    pack_hw_auto,
    packed_norm_act,
)
from unet_bssfp_tpu_torch.parallel.mesh import Sharded, apply_local, local, place


def guard_cols(h: int, w: int) -> int:
    """Zero guard columns appended to each w-row of the packed layout (the
    JAX package's rule, ``packed_layers.py:41-62``): 0 unless the
    environment sets ``UNET_BSSFP_WGUARD=1``, else the first ``g`` in
    (2, 4, 6, 8) that keeps the row width even (the pool's pairs) and
    ``h·(w + g)`` a multiple of 128 (0 where none does). Read on every call,
    as the JAX package reads it at trace time."""
    if os.environ.get("UNET_BSSFP_WGUARD") != "1":
        return 0
    for g in (2, 4, 6, 8):
        if (w + g) % 2 == 0 and (h * (w + g)) % 128 == 0:
            return g
    return 0


def _pad_guards(x, g: int):
    """NDHWC ``x`` (tensor or shards) with ``g`` zero columns appended to w."""
    return apply_local(lambda t: F.pad(t, (0, 0, 0, g)), x) if g else x


class PackedConvNormAct(ConvNormAct):
    """ConvNormAct on a packed (B, D, C, H·wdim) tensor; ``wdim`` = W plus
    ``wguard`` guard columns. After the conv, the chain (the norm's f32
    moments over (d, lanes), the data columns' alone; the affine; the
    dropout; LeakyReLU, or with ``prelu`` the learnable slope on channel
    dim 2; the guards zeroed; the cast) is one call of
    ``ops.kernels.packed_norm_act``: the hand-written kernels on the card,
    the plain chain on the CPU. A volume split over ``space`` takes its
    moments over the shards (``instance_norm``), then the dropout and the
    activation in plain PyTorch."""

    def forward_packed(self, xk, wdim: int, wguard: int = 0):
        dtype = self.compute_dtype or xk.dtype
        xk = apply_local(lambda t: t.to(dtype).contiguous(), xk)
        devices = xk.mesh.distinct if isinstance(xk, Sharded) else (place(xk),)
        convs = {dev: local(self.conv, dev) for dev in devices}
        yk = conv3x3_packed_auto(
            xk, {dev: c.weight.permute(2, 3, 4, 1, 0)  # (kd, kh, kw, I, O)
                 for dev, c in convs.items()},
            {dev: _f32(c.bias) for dev, c in convs.items()}, wdim, None, wguard)
        if isinstance(yk, Sharded) and yk.mesh.size("space") > 1:
            y = instance_norm(yk, self.norm, dims=(1, 3), channel_dim=2,
                              guard=(wdim, wguard))
            return apply_local(
                lambda t: local(self, place(t))._drop_act_packed(t, wdim, wguard), y)
        return apply_local(
            lambda t: local(self, place(t))._norm_drop_act_packed(t, wdim, wguard), yk)

    def _norm_drop_act_packed(self, yk: torch.Tensor, wdim: int, wguard: int) -> torch.Tensor:
        return packed_norm_act(yk, self.norm.weight, self.norm.bias, self._slope(), wdim,
                               wguard, self.drop.draw(yk), self.drop.keep, self.norm.epsilon,
                               self.compute_dtype)

    def _drop_act_packed(self, y: torch.Tensor, wdim: int, wguard: int) -> torch.Tensor:
        # the JAX package's _guard_zero: the norm's bias and the activation
        # made the guards non-zero; a torch.where on the lane's column, whose
        # backward zeroes their cotangents (the conv's backward relies on it)
        y = guard_mask(self._act(self.drop(y), channel_dim=2), wdim, wguard)
        return y.to(self.compute_dtype or y.dtype)


class PackedTwoConv(TwoConv):
    """TwoConv taking NDHWC and returning the packed (B, D, features,
    H·(W+g)), ``g`` = ``wguard`` or, where it is ``None``,
    :func:`guard_cols` of the input."""

    block = PackedConvNormAct

    def forward_packed(self, x, wguard=None):
        h, w = x.shape[2], x.shape[3]
        g = guard_cols(h, w) if wguard is None else wguard
        dtype = self.conv_0.compute_dtype or x.dtype
        xk = pack_hw_auto(_pad_guards(apply_local(lambda t: t.to(dtype).contiguous(), x), g))
        xk = self.conv_0.forward_packed(xk, w + g, g)
        return self.conv_1.forward_packed(xk, w + g, g)


class _PackedMaxPool2(torch.autograd.Function):
    """``packed_max_pool2``'s custom VJP (``packed_layers.py:177-221``): the
    whole gradient of a window goes to its first maximal position in
    (d, h, w) row-major order, as XLA's select-and-scatter does. Plain
    PyTorch (XLA in the JAX package). With guard columns the pool runs over
    the whole row (no window mixes data and guard columns: both widths are
    even) and drops the pooled guards; the backward zero-pads ``dy`` back to
    the whole row first."""

    @staticmethod
    def forward(ctx, xk, wdim, wguard):
        b, d, c, hw = xk.shape
        h = hw // wdim
        x = xk.reshape(b, d // 2, 2, c, h // 2, 2, wdim // 2, 2).amax(dim=(2, 5, 7))
        y = x.permute(0, 1, 3, 4, 2).contiguous()  # (b, d/2, h/2, wdim/2, c)
        ctx.save_for_backward(xk, y)
        ctx.wdim, ctx.wguard = wdim, wguard
        return y[:, :, :, :(wdim - wguard) // 2].contiguous() if wguard else y

    @staticmethod
    def backward(ctx, dy):
        xk, y = ctx.saved_tensors
        b, d, c, hw = xk.shape
        w = ctx.wdim
        h = hw // w
        if ctx.wguard:
            dy = F.pad(dy, (0, 0, 0, ctx.wguard // 2))
        # windows last: (b, d/2, c, h/2, w/2, [dd, hh, ww])
        win = xk.reshape(b, d // 2, 2, c, h // 2, 2, w // 2, 2).permute(
            0, 1, 3, 4, 6, 2, 5, 7).reshape(b, d // 2, c, h // 2, w // 2, 8)
        ymax = y.permute(0, 1, 4, 2, 3).unsqueeze(-1)
        first = (win == ymax).to(torch.uint8).argmax(dim=-1, keepdim=True)
        g = dy.permute(0, 1, 4, 2, 3).unsqueeze(-1).float()
        dwin = torch.zeros(win.shape, dtype=torch.float32, device=xk.device)
        dwin.scatter_(-1, first, g)
        dx = dwin.reshape(b, d // 2, c, h // 2, w // 2, 2, 2, 2).permute(
            0, 1, 5, 2, 3, 6, 4, 7).reshape(b, d, c, hw)
        return dx.to(xk.dtype), None, None


def packed_max_pool2(xk, wdim: int, wguard: int = 0):
    """2×2×2 max-pool of the packed layout (``wdim`` columns a row, the last
    ``wguard`` of them guards) → NDHWC (B, D/2, H/2, (wdim - wguard)/2, C),
    with the first-match backward of the JAX package's custom VJP. Local on
    the shards of a sharded volume (their D is even)."""
    return apply_local(lambda t: _PackedMaxPool2.apply(t, wdim, wguard), xk)


class PooledConvs(Down):
    """``Down`` on an input the packed pool already pooled (same parameter
    path: one child ``convs``)."""

    def forward_pooled(self, x):
        return self.convs(x)


class _PackedPair(TwoConv):
    """Two PackedConvNormActs, packed in and out (the ``convs`` of
    PackedUpCat)."""

    block = PackedConvNormAct

    def forward_packed(self, xk, wdim: int, wguard: int = 0):
        xk = self.conv_0.forward_packed(xk, wdim, wguard)
        return self.conv_1.forward_packed(xk, wdim, wguard)


class PackedUpCat(UpCat):
    """UpCat whose TwoConv runs packed: transpose-conv upsample (NDHWC) →
    zero guard columns → pack → channel concat with the packed skip → two
    packed convs. ``wdim`` is the data width W; the skip carries the same
    ``g`` guard columns a row: ``wguard`` or, where it is ``None``,
    :func:`guard_cols` of the upsample."""

    convs_cls = _PackedPair

    def forward_packed(self, x, skip_k, wdim: int, wguard=None):
        up = self.upsample(x)
        g = guard_cols(up.shape[2], wdim) if wguard is None else wguard
        upk = pack_hw_auto(_pad_guards(up, g))
        cat = apply_local(lambda s, u: torch.cat([s, u], dim=2), skip_k, upk)
        return self.convs.forward_packed(cat, wdim + g, g)


class PackedFinalConv(Conv):
    """1³ conv; on the packed layout a channel GEMM in the compute dtype."""

    def forward_packed(self, xk):
        if isinstance(xk, Sharded):
            return _on_shards(self, xk, "forward_packed")
        dtype = self.compute_dtype or xk.dtype
        k = self.weight.reshape(self.out_channels, self.in_channels).to(dtype)
        y = torch.einsum("fc,bdcl->bdfl", k, xk.to(dtype))
        return (y + self.bias.to(dtype).reshape(1, 1, -1, 1)).contiguous()
