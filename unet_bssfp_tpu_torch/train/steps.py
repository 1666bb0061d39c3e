"""The GAN train and eval steps and the serving step (counterpart of
``unet_bssfp_tpu/train/steps.py``).

The train step keeps the reference's update order and semantics
(``steps.py:61-213``, Lightning manual optimisation):

1. Generator phase: ``loss = BCE(D(x, G(x)), 1) + mean(L1[, pf·Perceptual])
   · rf`` with the discriminator's gradients off (Lightning's
   ``toggle_optimizer``) → AdamW step of G.
2. Discriminator phase: the fake is recomputed by the *updated* generator
   in train mode under ``no_grad`` (``reuse_fake`` reuses the generator
   phase's fake, detached), ``loss = (BCE(D(x, y), 1) + BCE(D(x, ŷ), 0)) / 2``
   → AdamW step of D.

BatchNorm statistics update on every train-mode forward (G twice, D three
times per step). The parameters live in the modules, so the step updates
``state`` in place and returns only the metrics (as 0-d tensors: reading
them is the caller's synchronisation). The losses are taken in f32.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from unet_bssfp_tpu_torch.config import TrainConfig
from unet_bssfp_tpu_torch.models.medicalnet import medicalnet_features
from unet_bssfp_tpu_torch.ops.losses import bce_with_logits, l1_loss
from unet_bssfp_tpu_torch.ops.metrics import fid, mae, psnr, spatial_average, ssim3d, znorm
from unet_bssfp_tpu_torch.parallel.mesh import Mesh, gather_batch, replicas, shard_batch
from unet_bssfp_tpu_torch.train.state import GANTrainState

PerceptualFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _recon_loss(y_hat: torch.Tensor, y: torch.Tensor, tcfg: TrainConfig,
                perceptual_fn: Optional[PerceptualFn]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean of the loss terms (perceptual pre-scaled by
    ``perceptual_factor``), scaled by ``recon_factor``."""
    terms = {"L1": l1_loss(y_hat, y)}
    if perceptual_fn is not None:
        terms["Perceptual"] = perceptual_fn(y_hat, y) * tcfg.perceptual_factor
    total = sum(terms.values()) / len(terms) * tcfg.recon_factor
    return total, terms


def make_train_step(gen: nn.Module, disc: nn.Module, tcfg: TrainConfig,
                    perceptual_fn: Optional[PerceptualFn] = None,
                    reuse_fake: bool = False
                    ) -> Callable[[GANTrainState, torch.Tensor, torch.Tensor],
                                  Dict[str, torch.Tensor]]:
    """``step(state, x, y) -> metrics`` for the state that holds ``gen`` and
    ``disc``. ``x``: input patches (B, p, p, p, C_in); ``y``: the DT target
    (B, p, p, p, 6)."""

    def step(state: GANTrainState, x: torch.Tensor,
             y: torch.Tensor) -> Dict[str, torch.Tensor]:
        if state.gen is not gen or state.disc is not disc:
            raise ValueError("the state does not hold this step's models")
        gen.train()
        disc.train()

        # ---- generator phase (discriminator gradients off) ------------
        disc.requires_grad_(False)
        y_hat = gen(x)
        logits = disc(x, y_hat).float()
        adv = bce_with_logits(logits, torch.ones_like(logits))
        recon, terms = _recon_loss(y_hat.float(), y.float(), tcfg, perceptual_fn)
        gen_loss = adv + recon
        state.gen_opt.zero_grad(set_to_none=True)
        gen_loss.backward()
        state.gen_opt.step()
        disc.requires_grad_(True)

        # ---- discriminator phase (detached fake) -----------------------
        if reuse_fake:
            y_hat2 = y_hat.detach()
        else:
            with torch.no_grad():
                y_hat2 = gen(x)  # the updated generator, train mode
        logits_hat = disc(x, y_hat2).float()
        logits_real = disc(x, y).float()
        disc_loss = (bce_with_logits(logits_real, torch.ones_like(logits_real))
                     + bce_with_logits(logits_hat, torch.zeros_like(logits_hat))) / 2.0
        state.disc_opt.zero_grad(set_to_none=True)
        disc_loss.backward()
        state.disc_opt.step()
        state.step += 1

        metrics = {
            "train_gen_loss": gen_loss.detach(),
            "train_gen_loss_adversarial": adv.detach(),
            "train_gen_loss_recon": recon.detach(),
            "train_discr_loss": disc_loss.detach(),
        }
        for name, val in terms.items():
            metrics[f"train_gen_loss_recon_{name}"] = val.detach()
        return metrics

    return step


def make_eval_step(gen: nn.Module, disc: nn.Module, tcfg: TrainConfig,
                   perceptual_fn: Optional[PerceptualFn] = None,
                   with_metrics: bool = True, fid_fn: Optional[PerceptualFn] = None
                   ) -> Callable[[GANTrainState, torch.Tensor, torch.Tensor],
                                 Tuple[Dict[str, torch.Tensor], torch.Tensor]]:
    """Validation step (reference ``validation_step``, ``src/model.py:283-289``):
    eval-mode generator loss and, with ``with_metrics``, PSNR/SSIM/L1 and
    the FID where ``fid_fn`` is given (``val_metric_{fid_fn.label}``, the
    reference's MedicalNet FID, ``src/model.py:158-163``; build one with
    :func:`make_medicalnet_fid_fn`) → ``(metrics, y_hat)``."""

    def step(state: GANTrainState, x: torch.Tensor, y: torch.Tensor):
        if state.gen is not gen or state.disc is not disc:
            raise ValueError("the state does not hold this step's models")
        gen.eval()
        disc.eval()
        with torch.no_grad():
            y_hat = gen(x)
            logits = disc(x, y_hat).float()
            adv = bce_with_logits(logits, torch.ones_like(logits))
            y_hat32, y32 = y_hat.float(), y.float()
            recon, terms = _recon_loss(y_hat32, y32, tcfg, perceptual_fn)
            metrics = {
                "val_loss": adv + recon,
                "val_gen_loss_adversarial": adv,
                "val_gen_loss_recon": recon,
            }
            for name, val in terms.items():
                metrics[f"val_gen_loss_recon_{name}"] = val
            if with_metrics:
                metrics["val_metric_PSNR"] = torch.mean(psnr(y_hat32, y32))
                metrics["val_metric_SSIM"] = torch.mean(ssim3d(y_hat32, y32))
                metrics["val_metric_L1"] = torch.mean(mae(y_hat32, y32))
                if fid_fn is not None:
                    label = getattr(fid_fn, "label", "FID")
                    metrics[f"val_metric_{label}"] = fid_fn(y_hat32, y32)
        return metrics, y_hat

    return step


def make_medicalnet_fid_fn(net: nn.Module, pretrained: bool = False) -> PerceptualFn:
    """The reference's FID (``compute_fid_medicalnet``, ``src/model.py:235-257``):
    whole-tensor z-norm → each channel's MedicalNet features → spatial
    average → Frechet distance, without gradients. ``.label`` is ``"FID"``
    with ``pretrained`` (pass ``medicalnet_is_pretrained(path)``), else
    ``"FID_random_features"``, so a random-feature value is never mixed with
    the reference-comparable metric."""
    def fid_fn(y_hat: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return fid(spatial_average(medicalnet_features(net, znorm(y_hat))),
                       spatial_average(medicalnet_features(net, znorm(y))))

    fid_fn.label = "FID" if pretrained else "FID_random_features"
    return fid_fn


def make_predict_fn(gen: nn.Module, mesh: Optional[Mesh] = None
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Eval-mode generator forward ``x -> y_hat`` under
    ``torch.inference_mode()``. The weights live in ``gen``, so the JAX
    signature's ``state`` argument has no counterpart.

    With a ``mesh`` (``gen`` from ``build_models(..., mesh=mesh)``) the batch
    is split over it (dim 0 over ``data``, d over ``space``), the generator
    runs on the shards, exchanging d halos and norm moments over ``space``,
    and the result is gathered on the mesh's first device. A batch or a D
    the mesh does not divide raises."""
    for twin in replicas(gen):  # gen and its copies on the mesh's other devices
        twin.eval()

    def predict(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            if mesh is None:
                return gen(x)
            return gather_batch(gen(shard_batch(mesh, x)))

    return predict
