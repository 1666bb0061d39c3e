"""Loss primitives: L1, adversarial BCE-with-logits, SSIM loss (counterpart
of ``unet_bssfp_tpu/ops/losses.py``)."""

from __future__ import annotations

import torch

from unet_bssfp_tpu_torch.ops.metrics import ssim3d


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean absolute error (``torch.nn.L1Loss``)."""
    return torch.mean(torch.abs(pred - target))


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid cross-entropy, mean-reduced:
    ``max(z, 0) - z·y + log(1 + exp(-|z|))``."""
    z, y = logits, labels
    return torch.mean(torch.clamp(z, min=0.0) - z * y + torch.log1p(torch.exp(-torch.abs(z))))


def ssim_loss(pred: torch.Tensor, target: torch.Tensor,
              data_range: float = 1.0) -> torch.Tensor:
    """``1 - SSIM`` (mean over the batch)."""
    return 1.0 - torch.mean(ssim3d(pred, target, data_range=data_range))
