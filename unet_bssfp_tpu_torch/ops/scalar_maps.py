"""Diffusion-tensor scalar maps (counterpart of
``unet_bssfp_tpu/ops/scalar_maps.py``).

:func:`compute_scalar_maps` launches K8 (``ops/kernels/scalar_maps.py``,
``csrc/scalar_maps.cu``) on a CUDA tensor and runs
:func:`compute_scalar_maps_plain` on a CPU tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from unet_bssfp_tpu_torch.ops.kernels.scalar_maps import scalar_maps, scalar_maps_plain


class ScalarMaps(NamedTuple):
    """Per-voxel DT-derived scalars. Spatial shape ``S``; rgb is ``S+(3,)``."""

    fa: torch.Tensor
    md: torch.Tensor
    ad: torch.Tensor
    rd: torch.Tensor
    azimuth: torch.Tensor
    inclination: torch.Tensor
    rgb: torch.Tensor


def compute_scalar_maps_plain(d6: torch.Tensor) -> ScalarMaps:
    """All DT scalar maps of a channels-last ``(..., 6)`` tensor volume in
    plain PyTorch (``scalar_maps.py:33-72``); see
    :func:`ops.kernels.scalar_maps.scalar_maps_plain`."""
    return ScalarMaps(*scalar_maps_plain(d6))


def compute_scalar_maps(d6: torch.Tensor) -> ScalarMaps:
    """K8 on a CUDA tensor (f32; any float input is cast), the plain version
    on a CPU tensor."""
    return ScalarMaps(*scalar_maps(d6))


def load_rescale_args(path: str) -> np.ndarray:
    """A ``rescale_args_*.txt`` file → ``(C, 2)`` per-channel (min, max).
    Takes both layouts: one (min, max) pair per row (``rescale_args_dwi.txt``)
    and alternating min/max lines (``rescale_args_bssfp.txt``/``_t1w.txt``)."""
    mat = np.loadtxt(path)
    if mat.ndim == 1:
        if mat.size % 2 != 0:
            raise ValueError(f"odd number of rescale constants in {path}")
        mat = mat.reshape(-1, 2)
    if mat.shape[-1] != 2:
        raise ValueError(f"expected (C,2) rescale constants, got {mat.shape}")
    return mat


def invert_dwi_tensor_norm(data: torch.Tensor, minmax: np.ndarray) -> torch.Tensor:
    """Invert the per-channel min/max rescale: ``x·|max − min| + min`` on a
    channels-last ``(..., C)`` tensor; ``minmax`` is ``(C, 2)`` or ``(1, 2)``
    (broadcast), taken in f32 as the JAX package does."""
    minmax = torch.from_numpy(np.asarray(minmax, dtype=np.float32)).to(data.device)
    min_v, max_v = minmax[:, 0], minmax[:, 1]
    return data * torch.abs(max_v - min_v) + min_v
