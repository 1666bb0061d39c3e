"""Whole-volume and grid-stitched inference (counterpart of
``unet_bssfp_tpu/eval/inference.py::predict_volume``)."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from unet_bssfp_tpu_torch.data.sampler import GridAggregator, extract_patches
from unet_bssfp_tpu_torch.parallel.mesh import Mesh


def predict_volume(predict_fn: Callable[[torch.Tensor], torch.Tensor],
                   volume: torch.Tensor, patch_size: int = 64,
                   out_channels: int = 6, batch_size: int = 8,
                   mode: str = "average",
                   whole_volume: bool = False,
                   mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Run the generator over one ``(D, H, W, C)`` volume: once on the whole
    volume, or over the grid of patches in batches of ``batch_size`` (the
    last batch zero-padded to full size) and stitched.

    ``mesh``: the mesh ``predict_fn`` was made for
    (``make_predict_fn(gen, mesh)``), which does the splitting: the whole
    volume's d over ``space`` (one volume has no batch to split, so ``data``
    must be 1); each patch batch over ``data`` and each patch's d over
    ``space``. What the mesh cannot split is refused here, before any
    work."""
    if mesh is not None:
        nd, ns = mesh.size("data"), mesh.size("space")
        d = volume.shape[0] if whole_volume else patch_size
        if whole_volume and nd != 1:
            raise ValueError(f"whole-volume inference on {mesh}: one volume has "
                             f"no batch to split over data={nd}")
        if not whole_volume and batch_size % nd:
            raise ValueError(f"batch_size {batch_size} does not split over "
                             f"data={nd} of {mesh}")
        if ns > 1 and d % (16 * ns):
            raise ValueError(
                f"{'volume' if whole_volume else 'patch'} of D={d} "
                f"(shape {tuple(volume.shape)}) on {mesh}: D must be a multiple "
                f"of 16·n_space={16 * ns}")
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
