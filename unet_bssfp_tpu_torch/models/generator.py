"""Generator: per-modality 1³-conv input head → BasicUNet3D backbone
(counterpart of ``unet_bssfp_tpu/models/generator.py``).

The head is named after its modality group (``head6``/``head24``,
``config.HEAD_GROUPS``), so weights trained on one modality load onto the
other member of its group, and only the active head exists.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from unet_bssfp_tpu_torch.config import HEAD_GROUPS, MODALITY_CHANNELS
from unet_bssfp_tpu_torch.models.layers import ConvBlock
from unet_bssfp_tpu_torch.models.unet import BasicUNet3D


class Generator(nn.Module):
    def __init__(self, modality: str = "pc-bssfp", unet_in_channels: int = 24,
                 out_channels: int = 6,
                 features: Sequence[int] = (32, 64, 128, 256, 512, 32),
                 dropout: float = 0.05, unet_negative_slope: float = 0.1,
                 head_negative_slope: float = 0.2,
                 compute_dtype: Optional[torch.dtype] = None,
                 use_fused: bool = False, packed: bool = False,
                 remat: bool = False):
        super().__init__()
        self.modality = modality
        self.in_channels = MODALITY_CHANNELS[modality]
        self.head_name = HEAD_GROUPS[modality]
        self.add_module(self.head_name, ConvBlock(
            self.in_channels, unet_in_channels, kernel=1, stride=1, padding=0,
            negative_slope=head_negative_slope, compute_dtype=compute_dtype))
        self.unet = BasicUNet3D(
            unet_in_channels, out_channels, features, dropout,
            unet_negative_slope, compute_dtype, use_fused, packed, remat)

    def forward(self, x):
        """``x``: (B, D, H, W, C_in) or a ``parallel.mesh.Sharded`` of it."""
        if x.shape[-1] != self.in_channels:
            raise ValueError(f"{self.modality} expects {self.in_channels} "
                             f"channels, got {x.shape[-1]}")
        return self.unet(getattr(self, self.head_name)(x))
