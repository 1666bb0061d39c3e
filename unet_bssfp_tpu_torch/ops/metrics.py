"""Image-quality metrics on NDHWC volumes: PSNR, MAE, 3D SSIM, the
whole-tensor z-normalisation and the Frechet distance of feature
populations (counterpart of ``unet_bssfp_tpu/ops/metrics.py``).

The SSIM window is applied as explicit shifted, weighted sums in the input's
(at least f32) precision: no convolution library call, so no TF32 on the
card, as the JAX package asks for ``Precision.HIGHEST``.
"""

from __future__ import annotations

import torch

from unet_bssfp_tpu_torch.parallel import distributed


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
    the population standard deviation, as ``jnp.std`` takes it. Inside a
    training step's loss in a process group (``distributed.split_batch``)
    the whole tensor is the global batch: the moments are every process's
    share's, combined (``distributed.moments``)."""
    if distributed.batch_is_split():
        mean, var = distributed.moments(volume, tuple(range(volume.ndim)))
        return (volume - mean) / torch.sqrt(var)
    return (volume - torch.mean(volume)) / torch.std(volume, correction=0)


def spatial_average(feats: torch.Tensor) -> torch.Tensor:
    """Average ``(N, D, H, W, C)`` features over the spatial dims → ``(N, C)``
    (reference ``src/model.py:228-230``)."""
    return torch.mean(feats, dim=(1, 2, 3))


def _cov(feats: torch.Tensor) -> torch.Tensor:
    """Unbiased feature covariance, features as columns: feats (N, F)."""
    x = feats - torch.mean(feats, dim=0, keepdim=True)
    return (x.T @ x) / max(feats.shape[0] - 1, 1)


def fid(feats_pred: torch.Tensor, feats_target: torch.Tensor) -> torch.Tensor:
    """Frechet distance ``|mu_x - mu_y|² + tr(Sx + Sy - 2 (Sx Sy)^{1/2})``
    between two feature populations ``(N, F)`` (MONAI ``FIDMetric``,
    reference ``src/model.py:163,257``), in f32.

    Through the N × N Gram reduction, as the JAX package takes it: with
    centred features A, B, the nonzero eigenvalues of ``Sx Sy`` are those of
    ``C^T C / (n-1)²`` with ``C = B A^T``, so ``tr (Sx Sy)^{1/2}`` is the sum
    of the square roots of ``eigvalsh(C^T C)`` (clamped at 0) over ``n - 1``.
    Exact where an F × F eigendecomposition of a rank-N covariance is not.
    With N = 1 both covariances are 0 and the distance is ``|mu_x - mu_y|²``.
    """
    fx, fy = feats_pred.float(), feats_target.float()
    denom = max(fx.shape[0] - 1, 1)
    a = fx - torch.mean(fx, dim=0, keepdim=True)
    b = fy - torch.mean(fy, dim=0, keepdim=True)
    tr_sx = torch.sum(a * a) / denom
    tr_sy = torch.sum(b * b) / denom
    c = b @ a.T
    tr_sqrt = torch.sum(torch.sqrt(torch.linalg.eigvalsh(c.T @ c).clamp(min=0.0))) / denom
    diff = torch.mean(fx, dim=0) - torch.mean(fy, dim=0)
    # mathematically >= 0; clamp away f32 cancellation
    return torch.clamp(diff @ diff + tr_sx + tr_sy - 2.0 * tr_sqrt, min=0.0)


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
