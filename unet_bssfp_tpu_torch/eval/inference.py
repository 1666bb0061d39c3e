"""Whole-volume and grid-stitched inference (counterpart of
``unet_bssfp_tpu/eval/inference.py::predict_volume``)."""

from __future__ import annotations

from typing import Callable

import torch

from unet_bssfp_tpu_torch.data.sampler import GridAggregator, extract_patches


def predict_volume(predict_fn: Callable[[torch.Tensor], torch.Tensor],
                   volume: torch.Tensor, patch_size: int = 64,
                   out_channels: int = 6, batch_size: int = 8,
                   mode: str = "average",
                   whole_volume: bool = False) -> torch.Tensor:
    """Run the generator over one ``(D, H, W, C)`` volume: once on the whole
    volume, or over the grid of patches in batches of ``batch_size`` (the
    last batch zero-padded to full size) and stitched."""
    if whole_volume:
        return predict_fn(volume[None])[0]
    agg = GridAggregator(volume.shape[:3], out_channels, patch_size, mode=mode)
    patches = extract_patches(volume, agg.starts, patch_size)
    preds = []
    for i in range(0, patches.shape[0], batch_size):
        chunk = patches[i:i + batch_size]
        n = chunk.shape[0]
        if n < batch_size:
            chunk = torch.cat([chunk, chunk.new_zeros((batch_size - n,) + chunk.shape[1:])])
        preds.append(predict_fn(chunk)[:n])
    return agg.stitch(torch.cat(preds))
