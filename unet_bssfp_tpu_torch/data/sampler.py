"""Patch sampling and stitching on device (counterpart of
``unet_bssfp_tpu/data/sampler.py``): uniform random corners for training
patches, a static grid and its aggregator for stitched inference. Volumes
are ``(D, H, W, C)``."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from unet_bssfp_tpu_torch.utils.profiling import span


def uniform_patch_starts(generator: torch.Generator, volume_shape: Sequence[int],
                         patch_size: int, num_patches: int) -> np.ndarray:
    """``(num_patches, 3)`` int32 patch corners, uniform over the valid
    starts of each axis (TorchIO ``UniformSampler``): floor(U · (dim − p +
    1)) with U ~ U[0, 1) in f32, drawn from ``generator`` (a CPU generator:
    the corners are host numbers)."""
    maxs = torch.tensor([volume_shape[i] - patch_size + 1 for i in range(3)],
                        dtype=torch.float32)
    u = torch.rand((num_patches, 3), generator=generator, dtype=torch.float32)
    return torch.floor(u * maxs).to(torch.int32).numpy()


def grid_patch_starts(volume_shape: Sequence[int], patch_size: int) -> np.ndarray:
    """Static grid of patch corners covering the volume (TorchIO
    ``GridSampler`` with patch_overlap=0): stride = patch size, the last patch
    shifted flush to the boundary when the dim is not divisible. For
    (96, 128, 128)/64 this gives 2×2×2 = 8 corners, overlapping by 32 on D."""
    axes = []
    for dim in volume_shape[:3]:
        if dim < patch_size:
            raise ValueError(
                f"volume dim {dim} smaller than patch size {patch_size}; "
                f"crop_or_pad the volume up or reduce the patch size")
        starts = list(range(0, dim - patch_size + 1, patch_size))
        if starts[-1] != dim - patch_size:
            starts.append(dim - patch_size)
        axes.append(starts)
    grid = [(z, y, x) for z in axes[0] for y in axes[1] for x in axes[2]]
    return np.asarray(grid, np.int32)


def extract_patches(volume: torch.Tensor, starts: np.ndarray,
                    patch_size: int) -> torch.Tensor:
    """``(P, p, p, p, C)`` patches of a ``(D, H, W, C)`` volume at ``starts``."""
    p = patch_size
    with span("bssfp.extract"):
        return torch.stack([volume[z:z + p, y:y + p, x:x + p]
                            for z, y, x in np.asarray(starts).tolist()])


class GridAggregator:
    """Stitch patch predictions back into a volume on the patches' device.

    ``mode='average'``: overlap averaging by summing patches and dividing by
    the per-voxel count. ``mode='overwrite'``: later patches overwrite
    earlier ones (TorchIO's crop mode with patch_overlap=0)."""

    def __init__(self, volume_shape: Tuple[int, int, int], channels: int,
                 patch_size: int, mode: str = "average"):
        if mode not in ("average", "overwrite"):
            raise ValueError(f"unknown aggregation mode {mode!r}")
        self.volume_shape = tuple(volume_shape)
        self.channels = channels
        self.patch_size = patch_size
        self.mode = mode
        self.starts = grid_patch_starts(volume_shape, patch_size)

    def stitch(self, patches: torch.Tensor) -> torch.Tensor:
        """``(P, p, p, p, C)`` patches ordered like ``starts`` → the
        ``(D, H, W, C)`` volume."""
        if patches.shape[0] != len(self.starts):
            raise ValueError(f"{patches.shape[0]} patches for {len(self.starts)} starts")
        p = self.patch_size
        with span("bssfp.stitch"):
            acc = patches.new_zeros(self.volume_shape + (self.channels,))
            cnt = patches.new_zeros(self.volume_shape + (1,))
            for (z, y, x), patch in zip(self.starts.tolist(), patches):
                if self.mode == "average":
                    acc[z:z + p, y:y + p, x:x + p] += patch
                    cnt[z:z + p, y:y + p, x:x + p] += 1.0
                else:
                    acc[z:z + p, y:y + p, x:x + p] = patch
            if self.mode == "average":
                acc = acc / cnt.clamp_min(1.0)
            return acc
