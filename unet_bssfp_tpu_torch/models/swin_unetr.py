"""SwinUNETR-3D backbone on NDHWC (MONAI ``monai/networks/nets/swin_unetr.py``,
v1; Hatamizadeh et al., arXiv:2201.01266).

A Swin encoder (``swin``) and UNETR residual conv blocks:

  swin: 2³ stride-2 patch embedding (conv with bias) → hidden 0; four
        stages of ``depths[i]`` blocks (LayerNorm → window attention over
        windows of ``window_size``³, every second block shifted by half a
        window, + residual; LayerNorm → GELU MLP of ``mlp_ratio`` + residual),
        each followed by patch merging (MONAI's ``downsample="merging"``,
        the v0.9 layout) → hiddens 1..4; each hidden through an affine-free
        LayerNorm (``normalize``);
  encoder1 on the input, encoder2..4 on hiddens 0..2, encoder10 on hidden 4:
        residual blocks (conv → InstanceNorm → LeakyReLU 0.01 → conv →
        InstanceNorm, + the input, through a 1³ conv and norm where the
        channels differ, → LeakyReLU 0.01; convs without bias, norms without
        affine);
  decoder5..1: k2 s2 transpose conv (no bias), concat (up, skip), residual
        block; decoder5's skip is hidden 3;
  out: 1³ conv with bias.

MONAI v1's details are kept: a stage no larger than the window takes a
window of its own size and no shift (stage 4 at 6³: 6³ windows, unshifted);
the relative-position index is built for the configured window and sliced
``[:n, :n]`` where the window is clamped; the tokens that pad a stage to
whole windows are zeros after ``norm1`` and attend unmasked, and the shift
mask's regions are taken on the padded sizes; patch merging concatenates
MONAI's eight strided slices in its order, two of which repeat (x5 = x2,
x6 = x3).

The port's work per block: the mask is built once per stage shape and
device and kept; the bias gathered once a block per forward; pad, roll and
window partition are one pad and one gather, and window reverse, roll back
and crop one gather; every window and head of a block is one
:func:`~unet_bssfp_tpu_torch.ops.window_attention.window_attention` call.
With ``packed`` (where the input's shape allows it, BasicUNet's gate), the
two full-resolution residual blocks, encoder1 and decoder1's, run on the
packed layout: K1 for their 3³ convs (decoder1's 96 → 48 conv as two 48 → 48
calls on the up and skip halves, summed: a 96 → 48 weight does not fit
K1's shared memory at N 64, and the concat is never built), a channel GEMM
for the 1³ conv, K10 for each norm (LeakyReLU 0.01 after the first, an
identity slope after the second and the residual's) and the residual add
and LeakyReLU in PyTorch. The packed blocks run without guard columns.
Parameters are f32 and computed in ``compute_dtype``.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from unet_bssfp_tpu_torch.models.layers import Conv, ConvTranspose
from unet_bssfp_tpu_torch.models.packed_layers import PackedFinalConv
from unet_bssfp_tpu_torch.models.unet import _can_pack
from unet_bssfp_tpu_torch.ops.kernels import (
    conv3x3_packed,
    pack_hw_auto,
    packed_norm_act,
    unpack_hw_auto,
)
from unet_bssfp_tpu_torch.ops.kernels.packed_norm_act import _f32
from unet_bssfp_tpu_torch.ops.window_attention import window_attention
from unet_bssfp_tpu_torch.parallel.mesh import Sharded

Dims = Tuple[int, int, int]
EPS = 1e-5
MASKED = -100.0  # MONAI's value for a pair of tokens from different shift regions
SLOPE = 0.01  # UnetResBlock's LeakyReLU


def stage_window(dims: Sequence[int], window: int, shifted: bool) -> Tuple[Dims, Dims]:
    """MONAI's ``get_window_size``: per axis the window, or the axis's size
    where that is no larger (and then no shift); the shift half the window
    in a shifted block, else 0."""
    ws = tuple(s if s <= window else window for s in dims)
    sh = tuple(0 if (s <= window or not shifted) else window // 2 for s in dims)
    return ws, sh


def padded(dims: Sequence[int], ws: Dims) -> Dims:
    return tuple(-(-s // w) * w for s, w in zip(dims, ws))


def relative_position_index(window: int) -> torch.Tensor:
    """(w³, w³) index into the (2w − 1)³ bias table: token pairs of a w³
    window, row-major over (d, h, w), as MONAI builds it."""
    c = torch.stack(torch.meshgrid(*[torch.arange(window)] * 3, indexing="ij")).flatten(1)
    rel = (c[:, :, None] - c[:, None, :]).permute(1, 2, 0) + (window - 1)
    side = 2 * window - 1
    return rel[..., 0] * side * side + rel[..., 1] * side + rel[..., 2]


def shift_mask(dims: Dims, ws: Dims, sh: Dims) -> torch.Tensor:
    """MONAI's ``compute_mask`` on the padded ``dims``: each token labelled
    by its shift region (three slices an axis), then for each window
    (nW, n, n): 0 where two tokens share a label, -100 elsewhere. Float32,
    on the CPU."""
    img = torch.zeros(dims)
    cnt = 0
    cuts = [(slice(-w), slice(-w, -s), slice(-s, None)) for w, s in zip(ws, sh)]
    for d, h, w in itertools.product(*cuts):
        img[d, h, w] = cnt
        cnt += 1
    win = img.view(dims[0] // ws[0], ws[0], dims[1] // ws[1], ws[1], dims[2] // ws[2], ws[2])
    win = win.permute(0, 2, 4, 1, 3, 5).reshape(-1, math.prod(ws))
    diff = win.unsqueeze(1) - win.unsqueeze(2)
    return torch.where(diff != 0, torch.tensor(MASKED), torch.tensor(0.0))


def window_index(dims: Dims, ws: Dims, sh: Dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat token gathers on the CPU over a stage padded to ``dims``:
    ``fwd`` takes the padded tokens rolled by −``sh`` and partitioned into
    windows (windows row-major, then a window's tokens row-major), as
    ``torch.roll`` and MONAI's ``window_partition`` order them; ``inv`` is
    its inverse (a windowed token's place for each padded token)."""
    axes = [(torch.arange(n).view(n // w, w) + s) % n for n, w, s in zip(dims, ws, sh)]
    d, h, w = axes
    src = ((d[:, None, None, :, None, None] * dims[1] + h[None, :, None, None, :, None])
           * dims[2] + w[None, None, :, None, None, :])
    fwd = src.reshape(-1)
    inv = torch.empty_like(fwd)
    inv[fwd] = torch.arange(fwd.numel())
    return fwd, inv


class ResBlock(nn.Module):
    """MONAI ``UnetResBlock`` (3³ convs, stride 1, instance norm, LeakyReLU
    0.01) on NDHWC; ``conv3`` (1³) where the channels differ. The packed
    form (:meth:`forward_packed`) takes and returns (B, D, C, H·W) and its
    input as ``parts`` whose channels, concatenated, are the block's input."""

    def __init__(self, cin: int, cout: int, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = Conv(cin, cout, 3, 1, 1, compute_dtype, bias=False)
        self.conv2 = Conv(cout, cout, 3, 1, 1, compute_dtype, bias=False)
        self.conv3 = Conv(cin, cout, 1, 1, 0, compute_dtype, bias=False) if cin != cout else None
        self.compute_dtype = compute_dtype
        self.register_buffer("ones", torch.ones(cout), persistent=False)
        self.register_buffer("zeros", torch.zeros(cout), persistent=False)

    @staticmethod
    def _norm(y: torch.Tensor) -> torch.Tensor:
        """The affine-free InstanceNorm on NDHWC: f32 moments, ``y``'s dtype.
        (``instance_norm_f32`` with a scale of ones and a shift of zeros
        gives the same values with two more kernels a norm: 100 device ops
        a step, 0.3 % of its time.)"""
        yf = _f32(y)
        var, mean = torch.var_mean(yf, dim=(1, 2, 3), correction=0, keepdim=True)
        return ((yf - mean) * torch.rsqrt(var + EPS)).to(y.dtype)

    def forward(self, x):
        h = F.leaky_relu(self._norm(self.conv1(x)), SLOPE)
        h = self._norm(self.conv2(h))
        r = x if self.conv3 is None else self._norm(self.conv3(x))
        return F.leaky_relu(h + r.to(h.dtype), SLOPE)

    def _norm_act(self, yk: torch.Tensor, slope: float, wdim: int) -> torch.Tensor:
        """K10 on packed ``yk``: the affine-free norm, then ``slope``
        (1.0: none), in the compute dtype."""
        return packed_norm_act(yk, self.ones, self.zeros, slope, wdim, 0, None, 1.0, EPS,
                               self.compute_dtype or yk.dtype)

    def forward_packed(self, parts: Sequence[torch.Tensor], wdim: int) -> torch.Tensor:
        dtype = self.compute_dtype or parts[0].dtype
        parts = [p.to(dtype).contiguous() for p in parts]
        k1 = self.conv1.weight.permute(2, 3, 4, 1, 0)  # (kd, kh, kw, I, O)
        h = _over_parts(parts, lambda p, a, b: conv3x3_packed(p, k1[:, :, :, a:b], self.zeros,
                                                              wdim))
        h = self._norm_act(h, SLOPE, wdim)
        h = self._norm_act(conv3x3_packed(h, self.conv2.weight.permute(2, 3, 4, 1, 0),
                                          self.zeros, wdim), 1.0, wdim)
        if self.conv3 is None:
            (r,) = parts
        else:
            w3 = self.conv3.weight.reshape(self.conv3.out_channels, -1).to(dtype)
            r = _over_parts(parts, lambda p, a, b: torch.einsum("fc,bdcl->bdfl", w3[:, a:b], p))
            r = self._norm_act(r.contiguous(), 1.0, wdim)
        return F.leaky_relu(h + r, SLOPE)


def _over_parts(parts: Sequence[torch.Tensor], layer) -> torch.Tensor:
    """A linear layer over the channels of ``parts`` concatenated, as the sum
    of ``layer(part, a, b)`` over the parts, ``[a, b)`` a part's channels."""
    out, lo = None, 0
    for p in parts:
        y = layer(p, lo, lo + p.shape[2])
        out, lo = (y if out is None else out + y), lo + p.shape[2]
    return out


class UpBlock(nn.Module):
    """MONAI ``UnetrUpBlock`` with a residual block: k2 s2 transpose conv
    (``upsample``, no bias) → concat (up, skip) → :class:`ResBlock`."""

    def __init__(self, cin: int, cout: int, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.upsample = ConvTranspose(cin, cout, compute_dtype, bias=False)
        self.conv_block = ResBlock(2 * cout, cout, compute_dtype)

    def forward(self, x, skip):
        up = self.upsample(x)
        return self.conv_block(torch.cat([up, skip.to(up.dtype)], dim=-1))

    def forward_packed(self, x, skip_k: torch.Tensor) -> torch.Tensor:
        """NDHWC ``x`` up to the packed skip's resolution, packed; the
        residual block on (up, skip) without their concat."""
        up = self.upsample(x)
        return self.conv_block.forward_packed([pack_hw_auto(up.contiguous()), skip_k],
                                              up.shape[3])


class Mlp(nn.Module):
    """MONAI ``MLPBlock`` (swin mode, no dropout): linear1 → GELU → linear2."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.linear1 = nn.Linear(dim, hidden)
        self.linear2 = nn.Linear(hidden, dim)

    def forward(self, x, dtype):
        h = F.gelu(F.linear(x, self.linear1.weight.to(dtype), self.linear1.bias.to(dtype)))
        return F.linear(h, self.linear2.weight.to(dtype), self.linear2.bias.to(dtype))


class WindowAttention(nn.Module):
    """MONAI ``WindowAttention``'s parameters: ``qkv`` (with bias), ``proj``
    and the relative-position bias table of (2w − 1)³ × heads for the
    configured window w; its index (not saved) sliced ``[:n, :n]`` for a
    clamped window of n tokens."""

    def __init__(self, dim: int, num_heads: int, window: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=True)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 3, num_heads))
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        self.register_buffer("relative_position_index", relative_position_index(window),
                             persistent=False)

    def position_bias(self, n: int, dtype) -> torch.Tensor:
        """(heads, n, n) in ``dtype``: the table gathered once a block."""
        idx = self.relative_position_index[:n, :n].reshape(-1)
        b = self.relative_position_bias_table.index_select(0, idx).view(n, n, -1)
        return b.permute(2, 0, 1).to(dtype).contiguous()


class SwinBlock(nn.Module):
    """MONAI ``SwinTransformerBlock`` (drop rates 0): x + attn(norm1(x)),
    then x + mlp(norm2(x)), on (B, D, H, W, C)."""

    def __init__(self, dim: int, num_heads: int, window: int, shifted: bool,
                 mlp_ratio: float):
        super().__init__()
        self.window, self.shifted = window, shifted
        self.norm1 = nn.LayerNorm(dim, eps=EPS)
        self.attn = WindowAttention(dim, num_heads, window)
        self.norm2 = nn.LayerNorm(dim, eps=EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self._index: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def _indices(self, dims: Dims, ws: Dims, sh: Dims, device) -> Tuple[torch.Tensor, ...]:
        """The block's two token gathers on ``device``, made once a shape:
        pad → roll → partition (over the padded grid), and partition →
        roll back → crop (to ``dims``)."""
        key = (dims, ws, sh, str(device))
        if key not in self._index:
            pdims = padded(dims, ws)
            fwd, inv = window_index(pdims, ws, sh)
            grid = torch.stack(torch.meshgrid(*[torch.arange(s) for s in dims], indexing="ij"))
            rev = inv[((grid[0] * pdims[1] + grid[1]) * pdims[2] + grid[2]).reshape(-1)]
            self._index[key] = (fwd.to(device), rev.to(device))
        return self._index[key]

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor], dtype) -> torch.Tensor:
        b, d, h, w, c = x.shape
        ws, sh = stage_window((d, h, w), self.window, self.shifted)
        pdims, n = padded((d, h, w), ws), math.prod(ws)
        fwd, rev = self._indices((d, h, w), ws, sh, x.device)
        y = F.layer_norm(x, (c,), self.norm1.weight.to(dtype), self.norm1.bias.to(dtype), EPS)
        if pdims != (d, h, w):  # padding tokens are zeros after norm1
            y = F.pad(y, (0, 0, 0, pdims[2] - w, 0, pdims[1] - h, 0, pdims[0] - d))
        y = y.reshape(b, -1, c).index_select(1, fwd)  # (B, nW·n, C)
        a = self.attn
        heads = a.num_heads
        qkv = F.linear(y, a.qkv.weight.to(dtype), a.qkv.bias.to(dtype))
        nw = y.shape[1] // n
        qkv = qkv.view(b, nw, n, 3, heads, c // heads).permute(3, 0, 1, 4, 2, 5).contiguous()
        bias = a.position_bias(n, dtype)
        if any(sh):  # one bias a call: (1, nW·heads, n, n), the batch B
            bias = (bias.unsqueeze(0) + mask.unsqueeze(1)).view(1, nw * heads, n, n)
            q, k, v = (t.view(b, nw * heads, n, c // heads) for t in qkv)
        else:  # the same bias for every window: (1, heads, n, n), the batch B·nW
            bias = bias.unsqueeze(0)
            q, k, v = (t.view(b * nw, heads, n, c // heads) for t in qkv)
        o = window_attention(q, k, v, bias)
        o = o.view(b, nw, heads, n, c // heads).permute(0, 1, 3, 2, 4).reshape(b, nw * n, c)
        o = F.linear(o, a.proj.weight.to(dtype), a.proj.bias.to(dtype))
        x = x + o.index_select(1, rev).view(b, d, h, w, c)
        y = F.layer_norm(x, (c,), self.norm2.weight.to(dtype), self.norm2.bias.to(dtype), EPS)
        return x + self.mlp(y, dtype)


class PatchMerging(nn.Module):
    """MONAI ``PatchMerging`` (v0.9 layout): the eight strided slices in
    MONAI's order (two of them repeat) → LayerNorm(8C) → linear 8C → 2C
    without bias. Every side is even (SwinUNETR3D takes sides that are
    multiples of patch·2⁴), so MONAI's pad of an odd side never applies."""

    SLICES = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 0, 1), (0, 1, 0), (0, 0, 1),
              (1, 1, 1))

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(8 * dim, eps=EPS)
        self.reduction = nn.Linear(8 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        x = torch.cat([x[:, i::2, j::2, k::2, :] for i, j, k in self.SLICES], dim=-1)
        x = F.layer_norm(x, (x.shape[-1],), self.norm.weight.to(dtype),
                         self.norm.bias.to(dtype), EPS)
        return F.linear(x, self.reduction.weight.to(dtype))


class SwinStage(nn.Module):
    """MONAI ``BasicLayer``: ``depth`` blocks, every second one shifted,
    then patch merging. The shift mask is built once per shape and device
    and kept."""

    def __init__(self, dim: int, depth: int, num_heads: int, window: int, mlp_ratio: float):
        super().__init__()
        self.window = window
        self.blocks = nn.ModuleList(SwinBlock(dim, num_heads, window, i % 2 == 1, mlp_ratio)
                                    for i in range(depth))
        self.downsample = PatchMerging(dim)
        self._masks: Dict[tuple, torch.Tensor] = {}

    def mask(self, dims: Dims, dtype, device) -> Optional[torch.Tensor]:
        ws, sh = stage_window(dims, self.window, True)
        if not any(sh):
            return None
        key = (dims, str(dtype), str(device))
        if key not in self._masks:
            self._masks[key] = shift_mask(padded(dims, ws), ws, sh).to(device=device,
                                                                       dtype=dtype)
        return self._masks[key]

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        mask = self.mask(tuple(x.shape[1:4]), dtype, x.device)
        for blk in self.blocks:
            x = blk(x, mask, dtype)
        return self.downsample(x, dtype)


class SwinEncoder(nn.Module):
    """MONAI ``SwinTransformer`` (v1, no patch norm, no absolute position
    embedding): its five hidden states, each through the affine-free
    LayerNorm of ``proj_out`` (``normalize``)."""

    def __init__(self, in_channels: int, feature_size: int, depths: Sequence[int],
                 num_heads: Sequence[int], window: int, patch: int, mlp_ratio: float,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.patch_embed = Conv(in_channels, feature_size, patch, patch, 0, compute_dtype)
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            self.add_module(f"layers{i + 1}", SwinStage(feature_size * 2 ** i, depth, heads,
                                                        window, mlp_ratio))
        self.num_stages = len(depths)

    def forward(self, x: torch.Tensor):
        dtype = self.compute_dtype or x.dtype
        x = self.patch_embed(x)
        outs = [x]
        for i in range(self.num_stages):
            x = getattr(self, f"layers{i + 1}")(x, dtype)
            outs.append(x)
        return [F.layer_norm(t, (t.shape[-1],), eps=EPS) for t in outs]


class SwinUNETR3D(nn.Module):
    """SwinUNETR (MONAI v1) on NDHWC: (B, D, H, W, ``in_channels``) →
    (B, D, H, W, ``out_channels``); every side a multiple of
    ``patch_size``·2⁴. ``packed``: the full-resolution residual blocks on
    the packed layout where the input allows it (module docstring)."""

    def __init__(self, in_channels: int = 24, out_channels: int = 6, feature_size: int = 48,
                 depths: Sequence[int] = (2, 2, 2, 2), num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, patch_size: int = 2, mlp_ratio: float = 4.0,
                 compute_dtype: Optional[torch.dtype] = None, packed: bool = False):
        super().__init__()
        if len(depths) != 4 or len(num_heads) != 4:
            raise ValueError("SwinUNETR3D takes four stages (depths and num_heads of 4)")
        fs = feature_size
        if any(fs * 2 ** i % h for i, h in enumerate(num_heads)):
            raise ValueError(f"feature_size {fs} is not split evenly over heads {num_heads}")
        self.packed = packed
        self.feature_size = fs
        self.side = patch_size * 2 ** 4
        kw = dict(compute_dtype=compute_dtype)
        self.swin = SwinEncoder(in_channels, fs, depths, num_heads, window_size, patch_size,
                                mlp_ratio, compute_dtype)
        self.encoder1 = ResBlock(in_channels, fs, **kw)
        self.encoder2 = ResBlock(fs, fs, **kw)
        self.encoder3 = ResBlock(2 * fs, 2 * fs, **kw)
        self.encoder4 = ResBlock(4 * fs, 4 * fs, **kw)
        self.encoder10 = ResBlock(16 * fs, 16 * fs, **kw)
        self.decoder5 = UpBlock(16 * fs, 8 * fs, **kw)
        self.decoder4 = UpBlock(8 * fs, 4 * fs, **kw)
        self.decoder3 = UpBlock(4 * fs, 2 * fs, **kw)
        self.decoder2 = UpBlock(2 * fs, fs, **kw)
        self.decoder1 = UpBlock(fs, fs, **kw)
        self.out = PackedFinalConv(fs, out_channels, 1, compute_dtype=compute_dtype)

    def forward(self, x):
        if isinstance(x, Sharded):
            raise ValueError("SwinUNETR3D takes one device's tensor, not a sharded volume")
        if any(s % self.side for s in x.shape[1:4]):
            raise ValueError(f"SwinUNETR3D needs every side a multiple of {self.side}, "
                             f"got {tuple(x.shape[1:4])}")
        hs = self.swin(x)
        dec4 = self.encoder10(hs[4])
        dec3 = self.decoder5(dec4, hs[3])
        dec2 = self.decoder4(dec3, self.encoder4(hs[2]))
        dec1 = self.decoder3(dec2, self.encoder3(hs[1]))
        dec0 = self.decoder2(dec1, self.encoder2(hs[0]))
        if self.packed and _can_pack(x, 2 * self.feature_size):
            wdim = x.shape[3]
            enc0 = self.encoder1.forward_packed([pack_hw_auto(x.contiguous())], wdim)
            out = self.decoder1.forward_packed(dec0, enc0)
            return unpack_hw_auto(self.out.forward_packed(out), wdim)
        return self.out(self.decoder1(dec0, self.encoder1(x)))
