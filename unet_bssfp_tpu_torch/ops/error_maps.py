"""Per-voxel relative and angular error maps plus ROI aggregation
(counterpart of ``unet_bssfp_tpu/ops/error_maps.py``)."""

from __future__ import annotations

from typing import Dict

import torch


def relative_error_map(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``|pred - target| / target``: the denominator keeps its sign and has
    no epsilon (reference parity); its infs and nans are zeroed at ROI
    aggregation."""
    return torch.abs(pred - target) / target


def relative_error_map_floored(pred: torch.Tensor, target: torch.Tensor,
                               floor_frac: float = 0.1) -> torch.Tensor:
    """:func:`relative_error_map` with the denominator floored at
    ``floor_frac`` × the mean |target| over nonzero-target voxels (per
    channel of an ``S + (C,)`` map, over the whole of an ``S`` map), so a
    vanishing target cannot make the error explode. The mean is summed in
    f64 (the JAX package sums in f32), so it is free of summation order and
    the card and the CPU give the same floor."""
    at = torch.abs(target)
    spatial = (0, 1, 2) if at.ndim > 3 else tuple(range(at.ndim))
    at64 = at.to(torch.float64)
    nz = (at64 > 0).to(torch.float64)
    scale = (torch.sum(at64 * nz, dim=spatial, keepdim=True)
             / torch.clamp_min(torch.sum(nz, dim=spatial, keepdim=True), 1.0)).to(at.dtype)
    return torch.abs(pred - target) / torch.maximum(at, floor_frac * scale)


def angular_error_map(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Absolute angular error in degrees with 360° wraparound:
    ``d = (pred - target) mod 360`` (floored, as ``jnp.mod``: the result
    takes the divisor's sign), then ``min(d, 360 - d)``."""
    diff = torch.remainder(pred - target, 360.0)
    return torch.where(diff < 180.0, diff, 360.0 - diff)


def roi_weighted_mean_errors(diff_map: torch.Tensor, mask: torch.Tensor,
                             probseg: torch.Tensor) -> torch.Tensor:
    """Probseg-weighted mean |error| per (ROI, channel): the error map is
    |·|'d, zeroed outside the brain mask, then where inf, then where nan;
    for each ROI r, ``sum(probseg_r · err_c) / sum(probseg_r)``.

    ``diff_map`` ``S + (C,)``, ``mask`` ``S``, ``probseg`` ``S + (R,)`` →
    ``(R, C)`` f32. The two contractions sum in f64 (the JAX package sums in
    f32): the result is then free of summation order, so the card (no TF32
    in a f64 GEMM) and the CPU agree to the f32 rounding of the output."""
    err = torch.abs(diff_map)
    err = torch.where(mask[..., None] > 0, err, 0.0)
    err = torch.where(torch.isinf(err), 0.0, err)
    err = torch.where(torch.isnan(err), 0.0, err)
    axes = tuple(range(err.ndim - 1))
    p64 = probseg.to(torch.float64)
    num = torch.tensordot(p64, err.to(torch.float64), dims=(axes, axes))
    den = torch.sum(p64, dim=axes)[:, None]
    return (num / torch.where(den == 0, 1.0, den)).to(torch.float32)


def masked_probseg(mask: torch.Tensor, probseg: torch.Tensor) -> torch.Tensor:
    """Zero the probabilistic segmentations outside the brain mask and below
    1e-5."""
    p = torch.where(mask[..., None] > 0, probseg, 0.0)
    return torch.where(p > 1e-5, p, 0.0)


def error_dict_from_maps(pred_maps: Dict[str, torch.Tensor],
                         target_maps: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """Per-scalar error maps keyed like the eval tables: angular error for
    azimuth/inclination, relative error for the rest."""
    out = {}
    for k, p in pred_maps.items():
        t = target_maps[k]
        if k in ("azimuth", "inclination"):
            out[k] = angular_error_map(p, t)
        else:
            out[k] = relative_error_map(p, t)
    return out
