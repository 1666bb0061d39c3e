"""The objectives in float32: L1, BCE on logits, 3-D SSIM with a gaussian
window (MONAI ``SSIMMetric(3)``'s defaults: window 11, sigma 1.5, K1 0.01,
K2 0.03, data range 1, 'valid' filtering)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def l1(a, b):
    return torch.mean(torch.abs(a - b))


def bce_with_logits(z, target: float):
    return F.binary_cross_entropy_with_logits(z, torch.full_like(z, target))


def _gauss(win: int, sigma: float, dtype, device):
    c = torch.arange(win, dtype=dtype, device=device) - (win - 1) / 2.0
    g = torch.exp(-(c ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def ssim3d(a, b, win: int = 11, sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03):
    """Per-item SSIM of NDHWC ``a`` against ``b`` → (N,); the window shrinks
    to the smallest spatial side (made odd) for small patches."""
    side = min(a.shape[1:4])
    if win > side:
        win = side if side % 2 else side - 1
    x, y = a.permute(0, 4, 1, 2, 3), b.permute(0, 4, 1, 2, 3)
    ch = x.shape[1]
    g = _gauss(win, sigma, x.dtype, x.device)
    kernels = [g.view(1, 1, win, 1, 1), g.view(1, 1, 1, win, 1), g.view(1, 1, 1, 1, win)]

    def blur(t):
        for k in kernels:
            t = F.conv3d(t, k.expand(ch, 1, *k.shape[2:]), groups=ch)
        return t

    c1, c2 = k1 ** 2, k2 ** 2
    mx, my = blur(x), blur(y)
    vx = blur(x * x) - mx * mx
    vy = blur(y * y) - my * my
    cxy = blur(x * y) - mx * my
    s = ((2 * mx * my + c1) * (2 * cxy + c2)) / ((mx * mx + my * my + c1) * (vx + vy + c2))
    return s.reshape(s.shape[0], -1).mean(dim=1)
