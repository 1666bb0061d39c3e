"""Image-quality metrics on NDHWC volumes: PSNR, MAE, 3D SSIM and the
whole-tensor z-normalisation (counterpart of ``unet_bssfp_tpu/ops/metrics.py``;
its FID comes with the MedicalNet slice).

The SSIM window is applied as explicit shifted, weighted sums in the input's
(at least f32) precision: no convolution library call, so no TF32 on the
card, as the JAX package asks for ``Precision.HIGHEST``.
"""

from __future__ import annotations

import torch


def _flatten_per_item(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def psnr(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    """Per-item PSNR in dB with a fixed peak (MONAI ``PSNRMetric(1)``) →
    shape (N,)."""
    mse = torch.mean((_flatten_per_item(pred) - _flatten_per_item(target)) ** 2, dim=-1)
    return 10.0 * torch.log10(max_val ** 2 / torch.where(mse == 0, 1e-30, mse))


def mae(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-item mean absolute error (MONAI ``MAEMetric``) → shape (N,)."""
    return torch.mean(torch.abs(_flatten_per_item(pred) - _flatten_per_item(target)), dim=-1)


def znorm(volume: torch.Tensor) -> torch.Tensor:
    """Whole-tensor z-normalisation (reference ``src/model.py:222-226``):
    the population standard deviation, as ``jnp.std`` takes it."""
    return (volume - torch.mean(volume)) / torch.std(volume, correction=0)


def _gaussian_kernel1d(win_size: int, sigma: float, dtype, device) -> torch.Tensor:
    coords = torch.arange(win_size, dtype=dtype, device=device) - (win_size - 1) / 2.0
    g = torch.exp(-(coords ** 2) / (2.0 * sigma ** 2))
    return g / torch.sum(g)


def _blur3d(x: torch.Tensor, kernel1d: torch.Tensor) -> torch.Tensor:
    """Separable 'valid' gaussian filter over the three spatial dims of
    NDHWC ``x``."""
    k = kernel1d.shape[0]
    for axis in (1, 2, 3):
        n = x.shape[axis] - k + 1
        x = sum(kernel1d[i] * x.narrow(axis, i, n) for i in range(k))
    return x


def ssim3d(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0,
           win_size: int = 11, sigma: float = 1.5, k1: float = 0.01,
           k2: float = 0.03) -> torch.Tensor:
    """Per-item 3D SSIM with a gaussian window (MONAI ``SSIMMetric(3,
    data_range=1)`` defaults) → shape (N,). The window shrinks to the
    smallest spatial dim (odd) for small patches."""
    dtype = torch.promote_types(pred.dtype, torch.float32)
    x, y = pred.to(dtype), target.to(dtype)
    min_dim = min(pred.shape[1:4])
    if win_size > min_dim:
        win_size = min_dim if min_dim % 2 == 1 else min_dim - 1
    kern = _gaussian_kernel1d(win_size, sigma, dtype, x.device)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_x, mu_y = _blur3d(x, kern), _blur3d(y, kern)
    var_x = _blur3d(x * x, kern) - mu_x * mu_x
    var_y = _blur3d(y * y, kern) - mu_y * mu_y
    cov_xy = _blur3d(x * y, kern) - mu_x * mu_y
    num = (2 * mu_x * mu_y + c1) * (2 * cov_xy + c2)
    den = (mu_x ** 2 + mu_y ** 2 + c1) * (var_x + var_y + c2)
    return torch.mean(_flatten_per_item(num / den), dim=-1)
