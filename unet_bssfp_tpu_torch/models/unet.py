"""BasicUNet-3D backbone on NDHWC (counterpart of
``unet_bssfp_tpu/models/unet.py``).

Channel plumbing for features (f0..f4, f5):
  conv_0: in → f0
  down_k: f_{k-1} → f_k              (k = 1..4)
  upcat_4: (f4 ↑ f4/2) ⊕ f3 → f3
  upcat_3: (f3 ↑ f3/2) ⊕ f2 → f2
  upcat_2: (f2 ↑ f2/2) ⊕ f1 → f1
  upcat_1: (f1 ↑ f1)   ⊕ f0 → f5    (no halving on the last stage)
  final:  f5 → out_channels (1³ conv)

``packed`` runs the two full-resolution stages (conv_0, upcat_1) on the
packed layout through the hand-written kernels, where the input shape
allows it (the JAX package's gate). ``prelu`` gives every conv block a
learnable slope per channel instead of the fixed LeakyReLU (the multi-stage
backbone, ``models.multi_input_unet.PReLUUNet``); it keeps ``packed`` and
turns ``use_fused`` off. ``remat`` recomputes each block's
activations in the backward instead of keeping them (``layers.remat``):
the blocks the JAX package wraps in ``nn.remat``, TwoConv, Down and UpCat,
and in the packed case the packed conv_0 and upcat_1 and the pooled
down_1. The pools before them, the head and the final 1³ conv stay
outside, as there. Under ``UNET_BSSFP_WGUARD=1`` the packed stages run
the ``wguard`` layout (``packed_layers.guard_cols``): its guard count is
decided once per forward and handed to both stages, so a recompute under
``remat`` uses the same layout; the output's guard columns are sliced off
after the unpack. The JAX package's ``folded`` and
``wpack_mid`` branches are TPU reformulations of the same convs with the
same parameters and are not ported.

The input may be a ``parallel.mesh.Sharded`` volume. Under a ``space``
split every level's local D must be even (four pools: the whole D a
multiple of 16·n_space), or the volume is refused with a ``ValueError``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from unet_bssfp_tpu_torch.models.layers import Conv, Down, TwoConv, UpCat, remat
from unet_bssfp_tpu_torch.models.packed_layers import (
    PackedFinalConv,
    PackedTwoConv,
    PackedUpCat,
    PooledConvs,
    guard_cols,
    packed_max_pool2,
)
from unet_bssfp_tpu_torch.ops.kernels import packed_supported, unpack_hw_auto
from unet_bssfp_tpu_torch.parallel.mesh import Sharded, apply_local


def _can_pack(x, f0: int) -> bool:
    """H·W % 128 == 0, even D/H/W (for the pool), channels ≤ 128. Of a
    sharded volume the shard's shape decides: it differs from the whole
    shape in B and D only, and its D is even where the whole volume's must
    be."""
    return (packed_supported(tuple(x.shape))
            and all(s % 2 == 0 for s in x.shape[1:4])
            and x.shape[-1] <= 128 and f0 <= 128)


class BasicUNet3D(nn.Module):
    def __init__(self, in_channels: int = 24, out_channels: int = 6,
                 features: Sequence[int] = (32, 64, 128, 256, 512, 32),
                 dropout: float = 0.05, negative_slope: float = 0.1,
                 compute_dtype: Optional[torch.dtype] = None,
                 use_fused: bool = False, packed: bool = False,
                 remat: bool = False, prelu: bool = False):
        super().__init__()
        f = tuple(features)
        if len(f) != 6:
            raise ValueError("BasicUNet3D needs 6 feature sizes")
        self.features = f
        self.packed = packed
        self.remat = remat
        kw = dict(dropout=dropout, negative_slope=negative_slope,
                  compute_dtype=compute_dtype, use_fused=use_fused, prelu=prelu)
        two_conv, down_1, upcat_1, final = (
            (PackedTwoConv, PooledConvs, PackedUpCat, PackedFinalConv)
            if packed else (TwoConv, Down, UpCat, Conv))
        self.conv_0 = two_conv(in_channels, f[0], **kw)
        self.down_1 = down_1(f[0], f[1], **kw)
        self.down_2 = Down(f[1], f[2], **kw)
        self.down_3 = Down(f[2], f[3], **kw)
        self.down_4 = Down(f[3], f[4], **kw)
        self.upcat_4 = UpCat(f[4], f[3], f[3], f[4] // 2, **kw)
        self.upcat_3 = UpCat(f[3], f[2], f[2], f[3] // 2, **kw)
        self.upcat_2 = UpCat(f[2], f[1], f[1], f[2] // 2, **kw)
        self.upcat_1 = upcat_1(f[1], f[0], f[5], f[1], **kw)
        self.final_conv = final(f[5], out_channels, 1,
                                compute_dtype=compute_dtype)

    def forward(self, x):
        if isinstance(x, Sharded) and x.mesh.size("space") > 1 and x.shape[1] % 16:
            ns, nd = x.mesh.size("space"), x.mesh.size("data")
            whole = (x.shape[0] * nd, x.shape[1] * ns) + tuple(x.shape[2:])
            raise ValueError(
                f"volume {whole} on {x.mesh}: D={whole[1]} must be a multiple of "
                f"16·n_space={16 * ns}, so that every level's shards pool locally")
        packed = self.packed and _can_pack(x, self.features[0])
        block = self._block
        if packed:
            wdim = x.shape[3]
            g0 = guard_cols(x.shape[2], wdim)
            xk0 = block(self.conv_0, self.conv_0.forward_packed, x, g0)
            x1 = block(self.down_1, self.down_1.forward_pooled,
                       packed_max_pool2(xk0, wdim + g0, g0))
        else:
            x0 = block(self.conv_0, self.conv_0, x)
            x1 = block(self.down_1, self.down_1, x0)
        x2 = block(self.down_2, self.down_2, x1)
        x3 = block(self.down_3, self.down_3, x2)
        x4 = block(self.down_4, self.down_4, x3)
        u4 = block(self.upcat_4, self.upcat_4, x4, x3)
        u3 = block(self.upcat_3, self.upcat_3, u4, x2)
        u2 = block(self.upcat_2, self.upcat_2, u3, x1)
        if packed:
            u1k = block(self.upcat_1, self.upcat_1.forward_packed, u2, xk0, wdim, g0)
            out = unpack_hw_auto(self.final_conv.forward_packed(u1k), wdim + g0)
            return apply_local(lambda t: t[:, :, :, :wdim].contiguous(), out) if g0 else out
        return self.final_conv(block(self.upcat_1, self.upcat_1, u2, x0))

    def _block(self, module: nn.Module, fn, *args):
        """``fn(*args)``, recomputed in the backward under ``remat`` (where
        gradients are taken: an eval or ``no_grad`` forward keeps nothing)."""
        if self.remat and torch.is_grad_enabled():
            return remat(module, fn, *args)
        return fn(*args)
