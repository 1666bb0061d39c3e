"""Deterministic preprocessing (counterpart of
``unet_bssfp_tpu/data/transforms.py::crop_or_pad``). Volumes are
``(D, H, W, C)``."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def crop_or_pad(volume: torch.Tensor, target: Tuple[int, int, int],
                fill: float = 0.0) -> torch.Tensor:
    """Centre crop-or-pad to ``target`` spatial shape with constant fill
    (TorchIO ``CropOrPad``: symmetric, the extra voxel on the trailing
    side)."""
    out = volume
    for ax in range(3):
        cur, tgt = out.shape[ax], target[ax]
        if cur > tgt:
            start = (cur - tgt) // 2
            out = out.narrow(ax, start, tgt)
        elif cur < tgt:
            before = (tgt - cur) // 2
            pads = [0, 0] * out.ndim
            # F.pad lists the last dim first.
            k = 2 * (out.ndim - 1 - ax)
            pads[k], pads[k + 1] = before, tgt - cur - before
            out = F.pad(out, pads, value=fill)
    return out.contiguous()
