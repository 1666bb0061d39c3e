"""3D PatchGAN discriminator (counterpart of
``unet_bssfp_tpu/models/discriminator.py``).

concat(input, target-or-fake) on channels → a first k4s2 ConvBlock without
BatchNorm, named after its modality group (``d1_head6``/``d1_head24``,
``config.HEAD_GROUPS``) → k4s2 ConvBlocks with BatchNorm ``d2`` … → a 1³
``final`` conv to one channel of patch logits (2³ on 64³ patches). Plain
PyTorch/cuDNN: the JAX package leaves these convs to XLA (its opt-in
``disc_folded`` layout is not ported).

Both inputs may be ``parallel.mesh.Sharded`` volumes of one mesh: the
concat is local, each k4 s2 conv exchanges one d slice with its ``space``
neighbours and needs an even local D, so a ``space`` axis of n needs the
volume's D / 2^len(features) ≥ n (64³ with the default five blocks: n ≤ 2;
the JAX package's XLA reshards instead).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from unet_bssfp_tpu_torch.config import HEAD_GROUPS, MODALITY_CHANNELS
from unet_bssfp_tpu_torch.models.layers import Conv, ConvBlock
from unet_bssfp_tpu_torch.parallel.mesh import Sharded, apply_local


class Discriminator(nn.Module):
    def __init__(self, modality: str = "pc-bssfp", out_channels: int = 6,
                 features: Sequence[int] = (32, 64, 128, 256, 512),
                 negative_slope: float = 0.2,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.features = tuple(features)
        cin = MODALITY_CHANNELS[modality] + out_channels
        self.first_name = f"d1_{HEAD_GROUPS[modality]}"
        self.add_module(self.first_name, ConvBlock(
            cin, self.features[0], batchnorm=False,
            negative_slope=negative_slope, compute_dtype=compute_dtype))
        for i, (fin, fout) in enumerate(zip(self.features, self.features[1:]), start=2):
            self.add_module(f"d{i}", ConvBlock(fin, fout, negative_slope=negative_slope,
                                               compute_dtype=compute_dtype))
        self.final = Conv(self.features[-1], 1, 1, compute_dtype=compute_dtype)

    def forward(self, x, y):
        """``x``, ``y``: (B, D, H, W, C) tensors, or ``Sharded`` ones."""
        min_dim = 2 ** len(self.features)
        patch = tuple(x.shape[1:4])
        if isinstance(x, Sharded):  # the whole volume's D
            patch = (patch[0] * x.mesh.size("space"),) + patch[1:]
        if not all(s >= min_dim for s in patch):
            raise ValueError(f"patch {patch} too small for "
                             f"{len(self.features)} stride-2 blocks (needs >= {min_dim})")
        h = getattr(self, self.first_name)(
            apply_local(lambda a, b: torch.cat([a, b], dim=-1), x, y))
        for i in range(2, len(self.features) + 1):
            h = getattr(self, f"d{i}")(h)
        return self.final(h)
