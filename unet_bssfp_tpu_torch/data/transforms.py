"""Deterministic preprocessing (counterpart of
``unet_bssfp_tpu/data/transforms.py``): the crop-or-pad the pipeline runs,
and the offline rescale, Z-normalisation and resampling steps of the
thesis' preprocessing chain. Volumes are ``(D, H, W, C)``."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from unet_bssfp_tpu_torch.ops.metrics import znorm


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


def rescale_intensity(volume: torch.Tensor, in_min: torch.Tensor,
                      in_max: torch.Tensor) -> torch.Tensor:
    """Min/max rescale to [0, 1] given dataset-wide per-channel bounds (the
    offline normalisation the ``rescale_args_*.txt`` constants encode;
    inverted at eval time by ``ops.scalar_maps.invert_dwi_tensor_norm``). A
    channel whose bounds are equal is only shifted."""
    in_min = torch.as_tensor(in_min, dtype=volume.dtype, device=volume.device)
    in_max = torch.as_tensor(in_max, dtype=volume.dtype, device=volume.device)
    scale = torch.where(in_max == in_min, torch.ones_like(in_max), in_max - in_min)
    return (volume - in_min) / scale


def znormalize(volume: torch.Tensor) -> torch.Tensor:
    """Whole-volume Z-normalisation (TorchIO ``ZNormalization``)."""
    return znorm(volume)


def _linear_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """``(n_in, n_out)`` f32 weights of ``jax.image.resize``'s linear
    method on one axis (``jax/_src/image/scale.py:compute_weight_mat``, no
    translation): half-pixel centres, sample i at (i + 0.5)·n_in/n_out −
    0.5; a triangle kernel widened by n_in/n_out when the axis shrinks
    (antialiasing), each output's weights normalised to sum 1, and none for
    a sample outside [−0.5, n_in − 0.5]."""
    inv_scale = torch.tensor(1.0 / (n_out / n_in), dtype=torch.float32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs() / kernel_scale
    w = torch.clamp(1.0 - x.abs(), min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def resample_trilinear(volume: torch.Tensor, target: Tuple[int, int, int]) -> torch.Tensor:
    """Trilinear resample of a ``(D, H, W, C)`` volume to a target spatial
    shape (the offline 'Resample to a common grid' step), as
    ``jax.image.resize(method="trilinear")`` computes it: half-pixel
    centres and, where an axis shrinks, an antialiasing triangle filter
    (``F.interpolate`` does neither on a shrinking axis). An axis of
    unchanged size is left as it is."""
    out = volume.to(torch.promote_types(volume.dtype, torch.float32))
    for ax in range(3):
        n_in, n_out = out.shape[ax], target[ax]
        if n_in == n_out:
            continue
        w = _linear_weights(n_in, n_out, out.device).to(out.dtype)
        out = torch.movedim(torch.tensordot(out, w, dims=([ax], [0])), -1, ax)
    return out.contiguous()
