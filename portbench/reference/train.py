"""The reference's training steps, AdamW and patch-stitched serving.

A training step follows the configuration's description:

- GAN (``src/model.py``, manual optimisation): the generator's loss is
  ``BCE(D(x, G(x)), 1) + recon_factor · L1(G(x), y)`` with D's weights
  held, then one AdamW step of G; the fake is drawn again by the updated
  generator in train mode without gradients, D's loss is
  ``(BCE(D(x, y), 1) + BCE(D(x, ŷ), 0)) / 2`` (fake first), then one AdamW
  step of D.
- Supervised (the thesis's multi-stage regime): ``L1 + (1 − SSIM)`` and one
  AdamW step of the stage's trainable leaves (TRANSFER: the input head).

Each run returns a :class:`Record`: every step's losses, each leaf's
gradient norm at the first step, and each leaf's parameter change after the
last step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import torch

from portbench.reference import losses
from portbench.reference.models import (
    Masks,
    Params,
    Quant,
    discriminator,
    generator,
    multi_input_unet,
)


@dataclasses.dataclass
class Record:
    losses: List[List[float]]         # per step: the step's losses
    grad1: Dict[str, float]           # leaf -> gradient norm at step 1
    delta: Dict[str, float]           # leaf -> |parameter change| after the steps


class AdamW:
    """Decoupled weight decay, then Adam with bias corrections (Loshchilov
    and Hutter): ``p ← p(1 − lr·wd)``; ``m ← b1 m + (1 − b1) g``; ``v ← b2 v +
    (1 − b2) g²``; ``p ← p − lr/(1 − b1ᵗ) · m / (√v/√(1 − b2ᵗ) + eps)``."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, b1: float, b2: float,
                 wd: float, eps: float = 1e-8):
        self.params, self.lr, self.b1, self.b2, self.wd, self.eps = params, lr, b1, b2, wd, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in self.params.items():
            g = p.grad
            p.mul_(1 - self.lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = self.v[k].sqrt() / bc2 ** 0.5 + self.eps
            p.addcdiv_(self.m[k], denom, value=-self.lr / bc1)
            p.grad = None


def _leaves(p: Params, names: Sequence[str]) -> Dict[str, torch.Tensor]:
    return {k: p[k].detach().clone().requires_grad_(True) for k in names}


def gan_steps(gen_p: Params, disc_p: Params, gen_train: Sequence[str],
              disc_train: Sequence[str], batches, cfg: dict, tcfg: dict,
              masks: Masks, packed: bool, quant: Quant = None) -> Record:
    """``len(batches)`` GAN steps from the given weights (float32 copies:
    the inputs are not changed). ``gen_train``/``disc_train``: the leaves
    each optimizer updates; the rest of each dict is held."""
    gp = {k: v.detach().float().clone() for k, v in gen_p.items()}
    dp = {k: v.detach().float().clone() for k, v in disc_p.items()}
    gp.update(_leaves(gp, gen_train))
    dp.update(_leaves(dp, disc_train))
    opts = [AdamW({k: gp[k] for k in gen_train}, tcfg["lr"], tcfg["b1"], tcfg["b2"],
                  tcfg["weight_decay"]),
            AdamW({k: dp[k] for k in disc_train}, tcfg["lr"], tcfg["b1"], tcfg["b2"],
                  tcfg["weight_decay"])]
    start = {**{f"gen.{k}": gp[k].detach().clone() for k in gen_train},
             **{f"disc.{k}": dp[k].detach().clone() for k in disc_train}}
    out = Record([], {}, {})
    for i, (x, y) in enumerate(batches):
        x, y = x.float(), y.float()
        y_hat = generator(gp, x, cfg, True, masks, packed, quant)
        for v in dp.values():
            v.requires_grad_(False)
        g_loss = (losses.bce_with_logits(discriminator(dp, x, y_hat, cfg, quant), 1.0)
                  + tcfg["recon_factor"] * losses.l1(y_hat, y))
        g_loss.backward()
        grads = {f"gen.{k}": gp[k].grad.norm().item() for k in gen_train}
        opts[0].step()
        for k in disc_train:
            dp[k].requires_grad_(True)
        with torch.no_grad():
            y_fake = generator(gp, x, cfg, True, masks, packed, quant)
        logits_hat = discriminator(dp, x, y_fake, cfg, quant)
        logits_real = discriminator(dp, x, y, cfg, quant)
        d_loss = (losses.bce_with_logits(logits_real, 1.0)
                  + losses.bce_with_logits(logits_hat, 0.0)) / 2.0
        d_loss.backward()
        grads.update({f"disc.{k}": dp[k].grad.norm().item() for k in disc_train})
        opts[1].step()
        if i == 0:
            out.grad1 = grads
        out.losses.append([g_loss.item(), d_loss.item()])
    now = {**{f"gen.{k}": gp[k] for k in gen_train}, **{f"disc.{k}": dp[k] for k in disc_train}}
    out.delta = {k: (now[k].detach() - start[k]).norm().item() for k in start}
    return out


def supervised_steps(p: Params, train: Sequence[str], batches, cfg: dict, tcfg: dict,
                     lr: float, masks: Masks, packed: bool, quant: Quant = None) -> Record:
    """``len(batches)`` steps of the thesis's loss ``L1 + (1 − SSIM)`` on
    the MultiInputUNet; AdamW at ``lr`` over the ``train`` leaves."""
    q = {k: v.detach().float().clone() for k, v in p.items()}
    q.update(_leaves(q, train))
    opt = AdamW({k: q[k] for k in train}, lr, tcfg["b1"], tcfg["b2"], tcfg["weight_decay"])
    start = {k: q[k].detach().clone() for k in train}
    out = Record([], {}, {})
    for i, (x, y) in enumerate(batches):
        x, y = x.float(), y.float()
        y_hat = multi_input_unet(q, x, cfg, True, masks, packed, quant)
        loss = losses.l1(y_hat, y) + (1.0 - losses.ssim3d(y_hat, y).mean())
        loss.backward()
        if i == 0:
            out.grad1 = {k: q[k].grad.norm().item() for k in train}
        opt.step()
        out.losses.append([loss.item()])
    out.delta = {k: (q[k].detach() - start[k]).norm().item() for k in train}
    return out


def grid_starts(shape: Sequence[int], patch: int) -> List[tuple]:
    """Patch corners covering a volume: stride ``patch``, the last one of
    an axis moved flush to its end (TorchIO's grid without overlap)."""
    axes = []
    for n in shape[:3]:
        s = list(range(0, n - patch + 1, patch))
        if s[-1] != n - patch:
            s.append(n - patch)
        axes.append(s)
    return [(a, b, c) for a in axes[0] for b in axes[1] for c in axes[2]]


@torch.no_grad()
def serve_volume(p: Params, volume, cfg: dict, patch: int, quant: Quant = None,
                 predict: Optional[Callable] = None):
    """One (D, H, W, C) volume through the eval-mode generator on its grid
    of patches, stitched by averaging where patches overlap."""
    starts = grid_starts(volume.shape, patch)
    xs = torch.stack([volume[a:a + patch, b:b + patch, c:c + patch] for a, b, c in starts])
    ys = (predict or (lambda t: generator(p, t.float(), cfg, False, quant=quant)))(xs)
    acc = torch.zeros(tuple(volume.shape[:3]) + (ys.shape[-1],), device=ys.device)
    cnt = torch.zeros(tuple(volume.shape[:3]) + (1,), device=ys.device)
    for (a, b, c), y in zip(starts, ys):
        acc[a:a + patch, b:b + patch, c:c + patch] += y.float()
        cnt[a:a + patch, b:b + patch, c:c + patch] += 1.0
    return acc / cnt
