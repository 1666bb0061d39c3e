"""MultiInputUNet and the stages of the multi-stage regime (counterpart of
``unet_bssfp_tpu/models/multi_input_unet.py``).

The thesis's supervised regime (``doc/thesis/03-methods.tex``, Architecture
and Training), which the published finetune metrics come from:

- backbone: :class:`PReLUUNet`, the BasicUNet-3D with learnable per-channel
  PReLU slopes (initialised at 0.25) and the feature maps 48/96/192/384/768
  (decoder mirrored, final 24), named ``unet``;
- an input head per modality group: :class:`ResNetHead`, three 3³ convs,
  6 or 24 → 24 channels, InstanceNorm and ReLU, a residual from the first
  block, named ``head_{HEAD_GROUPS[modality]}`` (``head_head6``,
  ``head_head24``), so one group's weights load onto the other member;
- stages: PRETRAIN (autoencode the DT) → TRANSFER (only the new head
  trains, the backbone frozen: :func:`trainable_mask`) → FINE_TUNE
  (everything at lr 1e-5: :func:`stage_lr`).

Parameter names are the JAX package's paths joined by ``.`` with its leaf
names mapped as ``weights.from_flax`` maps them (``kernel``/``scale`` →
``weight``; ``prelu_slope`` stays), so its ``params`` load strictly.
"""

from __future__ import annotations

import enum
from typing import Dict, Iterable, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from unet_bssfp_tpu_torch.config import HEAD_GROUPS, MODALITY_CHANNELS
from unet_bssfp_tpu_torch.models.layers import Conv, InstanceNorm
from unet_bssfp_tpu_torch.models.unet import BasicUNet3D
from unet_bssfp_tpu_torch.parallel.mesh import apply_local

THESIS_FEATURES = (48, 96, 192, 384, 768, 24)
HEAD_FEATURES = 24


class TrainingState(enum.Enum):
    PRETRAIN = "pretrain"
    TRANSFER = "transfer"
    FINE_TUNE = "finetune"


class ResNetHead(nn.Module):
    """The 3-conv residual input head: conv → InstanceNorm → ReLU three
    times, the first block's output added before the last ReLU (thesis: "a
    ResNet block with 6 input channels, 24 output channels and 3
    convolutional layers with ReLU activations, and batch normalization with
    a batch size of 1, which boils down to instance normalization")."""

    def __init__(self, cin: int, features: int = HEAD_FEATURES,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        for name, c in (("in", cin), ("mid", features), ("out", features)):
            self.add_module(f"conv_{name}", Conv(c, features, 3, 1, 1, compute_dtype))
            self.add_module(f"norm_{name}", InstanceNorm(features, compute_dtype=compute_dtype))

    def forward(self, x):
        h = apply_local(F.relu, self.norm_in(self.conv_in(x)))
        skip = h
        h = apply_local(F.relu, self.norm_mid(self.conv_mid(h)))
        h = self.norm_out(self.conv_out(h))
        return apply_local(lambda a, b: F.relu(a + b), h, skip)


class PReLUUNet(BasicUNet3D):
    """BasicUNet3D with the thesis's widths and learnable per-channel PReLU
    slopes initialised at torch's PReLU default 0.25."""

    def __init__(self, in_channels: int = HEAD_FEATURES, out_channels: int = 6,
                 features: Sequence[int] = THESIS_FEATURES, dropout: float = 0.05,
                 negative_slope: float = 0.25,
                 compute_dtype: Optional[torch.dtype] = None,
                 use_fused: bool = False, packed: bool = False, remat: bool = False):
        super().__init__(in_channels, out_channels, features, dropout, negative_slope,
                         compute_dtype, use_fused, packed, remat, prelu=True)


class MultiInputUNet(nn.Module):
    """``head_{group}`` → ``unet`` on NDHWC (or a ``parallel.mesh.Sharded``
    volume); only the modality's head exists."""

    def __init__(self, modality: str = "dwi-tensor", out_channels: int = 6,
                 features: Sequence[int] = THESIS_FEATURES, dropout: float = 0.05,
                 compute_dtype: Optional[torch.dtype] = None,
                 use_fused: bool = False, packed: bool = False):
        super().__init__()
        self.modality = modality
        self.in_channels = MODALITY_CHANNELS[modality]
        self.head_name = f"head_{HEAD_GROUPS[modality]}"
        self.add_module(self.head_name, ResNetHead(self.in_channels, HEAD_FEATURES,
                                                   compute_dtype))
        self.unet = PReLUUNet(HEAD_FEATURES, out_channels, features, dropout,
                              compute_dtype=compute_dtype, use_fused=use_fused,
                              packed=packed)

    def forward(self, x):
        if x.shape[-1] != self.in_channels:
            raise ValueError(f"{self.modality} expects {self.in_channels} "
                             f"channels, got {x.shape[-1]}")
        return self.unet(getattr(self, self.head_name)(x))


def trainable_mask(params: Union[nn.Module, Iterable[str]],
                   state: TrainingState) -> Dict[str, bool]:
    """Which parameters a stage updates, by name (``params``: a module's
    parameters or their names). PRETRAIN and FINE_TUNE: all; TRANSFER: only
    the input head's (thesis: "training the ResNet input block, while the
    rest of the parameters in the NN remain frozen")."""
    names = ([n for n, _ in params.named_parameters()] if isinstance(params, nn.Module)
             else list(params))
    if state == TrainingState.TRANSFER:
        return {n: n.startswith("head") for n in names}
    return dict.fromkeys(names, True)


def stage_lr(state: TrainingState, base_lr: float, finetune_lr: float) -> float:
    """The stage's learning rate (thesis: finetune at 1e-5)."""
    return finetune_lr if state == TrainingState.FINE_TUNE else base_lr
