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
them is the caller's synchronisation). The losses are taken in f32 (f64
for f64 operands).

On a mesh (``mesh=``, the models built with it) the batch is split over
``data`` and the volume's d over ``space``, G and D run on the shards (d
halos, norm moments over the mesh), and the losses and metrics are taken on
the gathered outputs, as the JAX package's ``jit`` takes them over its
sharded batch. Each position runs its device's replica of the models;
positions on one device share its ``Parameter`` s, so autograd sums their
gradients there. Over several devices each phase's backward leaves every
replica's gradients on its own device: they are summed onto the master's
(``reduce_gradients``), the master takes the AdamW step, and its weights
and BatchNorm buffers are copied into every replica (``broadcast``), the
generator's before the discriminator phase recomputes the fake. Only the
order of summation differs from the same step on one device.
``ddp_parity`` takes BatchNorm's moments per data row
(``layers.row_moments``) and the loss as the mean over data rows of each
row's loss: the JAX package's ``shard_map`` with its ``pmean`` of the
gradients, metrics and ``batch_stats``.

In a process group (``parallel.distributed``) each process steps on its
share of the global batch, every share of one size: BatchNorm's moments
are the global batch's, each process backpropagates its share of each
batch-mean loss (its batch's mean over the process count), the gradients
are summed over the processes before the one AdamW step every process
takes, and the metrics are the shares' sums. Gathering the outputs with
autograd instead would give every process the whole loss, and the
gradients' sum would count it once per process. ``ddp_parity`` there is
per data row over every process's rows (without a local mesh a process's
batch is one row). The eval step gathers ``y_hat``, the logits and ``y``
from every process exactly and takes its metrics, the FID among them, on
the global batch.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple, Union

import torch
from torch import nn

from unet_bssfp_tpu_torch.config import TrainConfig
from unet_bssfp_tpu_torch.models.layers import row_moments
from unet_bssfp_tpu_torch.models.medicalnet import medicalnet_features
from unet_bssfp_tpu_torch.ops.losses import bce_with_logits, l1_loss
from unet_bssfp_tpu_torch.ops.metrics import fid, mae, psnr, spatial_average, ssim3d, znorm
from unet_bssfp_tpu_torch.parallel import distributed
from unet_bssfp_tpu_torch.parallel.mesh import (
    Mesh,
    Sharded,
    apply_local,
    broadcast,
    check_replicas,
    each_replica,
    gather_batch,
    gather_rows,
    reduce_gradients,
    shard_batch,
)
from unet_bssfp_tpu_torch.train.state import GANTrainState
from unet_bssfp_tpu_torch.utils.profiling import span

PerceptualFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
Batch = Union[torch.Tensor, Sharded]


def _acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in f32 (f64 stays f64): the losses' precision."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def check_training_mesh(mesh: Optional[Mesh], *modules: nn.Module, what: str) -> None:
    """Each of ``modules`` must lie on ``mesh``'s first device with a
    replica on each other device of it (``check_replicas``)."""
    if mesh is None:
        return
    for m in modules:
        check_replicas(mesh, m, what)


def update(module: nn.Module, opt: torch.optim.Optimizer) -> None:
    """After a backward: the replicas' gradients summed onto ``module``'s
    (the master's), ``opt``'s step, the new weights and buffers copied
    into the replicas."""
    reduce_gradients(module)
    opt.step()
    broadcast(module)


def shard_inputs(mesh: Optional[Mesh], *values: Batch) -> Tuple[Batch, ...]:
    """Each value split over ``mesh`` (``shard_batch``), or kept where it is
    already split over that mesh; without a mesh the values as they are."""
    if mesh is None:
        if any(isinstance(v, Sharded) for v in values):
            raise ValueError("a sharded batch needs the step built with its mesh")
        return values
    out = []
    for v in values:
        if isinstance(v, Sharded):
            if v.mesh.devices != mesh.devices:
                raise ValueError(f"a batch sharded over {v.mesh} given to a step on {mesh}")
            out.append(v)
        else:
            out.append(shard_batch(mesh, v))
    return tuple(out)


def gather_whole(*values: Batch) -> Tuple[torch.Tensor, ...]:
    """Each value whole: a sharded one gathered (``gather_batch``)."""
    return tuple(gather_batch(v) if isinstance(v, Sharded) else v for v in values)


def gather_global(*values: Batch) -> Tuple[torch.Tensor, ...]:
    """Each value whole over the mesh and over the processes (every
    process's in rank order, exactly, without autograd): the global
    batch, as the eval steps take it."""
    return tuple(distributed.gather(v) for v in gather_whole(*values))


def local_rows(v: Batch) -> int:
    """The batch size this process holds of ``v``."""
    return v.shape[0] * v.mesh.size("data") if isinstance(v, Sharded) else v.shape[0]


def over_batch(fn: Callable[..., Dict[str, torch.Tensor]], *values: Batch,
               per_row: bool = False) -> Dict[str, torch.Tensor]:
    """``fn`` (a dict of 0-d losses, each a batch mean) of the whole batch:
    of tensors as given, of sharded values gathered (autograd runs through
    the gather); with ``per_row``, the mean over data rows of ``fn`` of
    each row. In a process group, this process's share of each
    (``distributed.shares``), ``fn`` running under
    ``distributed.split_batch``."""
    with distributed.split_batch():
        if not isinstance(values[0], Sharded):
            out = fn(*values)
        elif not per_row:
            out = fn(*gather_whole(*values))
        else:
            outs = [fn(*row) for row in zip(*(gather_rows(v) for v in values))]
            out = {k: sum(o[k] for o in outs) / len(outs) for k in outs[0]}
    return distributed.shares(out)


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
                    mesh: Optional[Mesh] = None, reuse_fake: bool = False,
                    ddp_parity: bool = False
                    ) -> Callable[[GANTrainState, Batch, Batch], Dict[str, torch.Tensor]]:
    """``step(state, x, y) -> metrics`` for the state that holds ``gen`` and
    ``disc``. ``x``: input patches (B, p, p, p, C_in); ``y``: the DT target
    (B, p, p, p, 6); with a ``mesh`` either may also come split over it.
    ``ddp_parity`` (needs a mesh): BatchNorm moments and the loss per data
    row (the module's docstring)."""
    if ddp_parity and mesh is None and distributed.process_count() == 1:
        raise ValueError("ddp_parity requires a mesh or a process group")
    check_training_mesh(mesh, gen, disc, what="make_train_step")
    moments = row_moments if ddp_parity else contextlib.nullcontext

    def gen_losses(logits, y_hat, y):
        logits = _acc(logits)
        adv = bce_with_logits(logits, torch.ones_like(logits))
        recon, terms = _recon_loss(_acc(y_hat), _acc(y), tcfg, perceptual_fn)
        return {"loss": adv + recon, "adv": adv, "recon": recon,
                **{f"term_{k}": v for k, v in terms.items()}}

    def disc_losses(logits_real, logits_hat):
        logits_real, logits_hat = _acc(logits_real), _acc(logits_hat)
        return {"loss": (bce_with_logits(logits_real, torch.ones_like(logits_real))
                         + bce_with_logits(logits_hat, torch.zeros_like(logits_hat))) / 2.0}

    def step(state: GANTrainState, x: Batch, y: Batch) -> Dict[str, torch.Tensor]:
        if state.gen is not gen or state.disc is not disc:
            raise ValueError("the state does not hold this step's models")
        with span("bssfp.step"):
            x, y = shard_inputs(mesh, x, y)
            each_replica(gen, "train")
            each_replica(disc, "train")
            with moments():
                # ---- generator phase (discriminator gradients off) --------
                each_replica(disc, "requires_grad_", False)
                with span("bssfp.gen.forward"):
                    y_hat = gen(x)
                    logits = disc(x, y_hat)
                with span("bssfp.gen.loss"):
                    g = over_batch(gen_losses, logits, y_hat, y, per_row=ddp_parity)
                with span("bssfp.gen.backward"):
                    each_replica(gen, "zero_grad")
                    g["loss"].backward()
                with span("bssfp.gen.optimizer"):
                    update(gen, state.gen_opt)  # before the fake is recomputed
                each_replica(disc, "requires_grad_", True)

                # ---- discriminator phase (detached fake) -------------------
                with span("bssfp.disc.forward"):
                    if reuse_fake:
                        y_hat2 = apply_local(torch.Tensor.detach, y_hat)
                    else:
                        with torch.no_grad():
                            y_hat2 = gen(x)  # the updated generator, train mode
                    logits_hat = disc(x, y_hat2)
                    logits_real = disc(x, y)
                with span("bssfp.disc.loss"):
                    d = over_batch(disc_losses, logits_real, logits_hat, per_row=ddp_parity)
                with span("bssfp.disc.backward"):
                    each_replica(disc, "zero_grad")
                    d["loss"].backward()
                with span("bssfp.disc.optimizer"):
                    update(disc, state.disc_opt)
            state.step += 1

            metrics = {
                "train_gen_loss": g["loss"].detach(),
                "train_gen_loss_adversarial": g["adv"].detach(),
                "train_gen_loss_recon": g["recon"].detach(),
                "train_discr_loss": d["loss"].detach(),
            }
            for name, val in g.items():
                if name.startswith("term_"):
                    metrics[f"train_gen_loss_recon_{name[5:]}"] = val.detach()
            return distributed.global_metrics(metrics, local_rows(x))

    return step


def make_eval_step(gen: nn.Module, disc: nn.Module, tcfg: TrainConfig,
                   perceptual_fn: Optional[PerceptualFn] = None,
                   mesh: Optional[Mesh] = None,
                   with_metrics: bool = True, fid_fn: Optional[PerceptualFn] = None
                   ) -> Callable[[GANTrainState, Batch, Batch],
                                 Tuple[Dict[str, torch.Tensor], torch.Tensor]]:
    """Validation step (reference ``validation_step``, ``src/model.py:283-289``):
    eval-mode generator loss and, with ``with_metrics``, PSNR/SSIM/L1 and
    the FID where ``fid_fn`` is given (``val_metric_{fid_fn.label}``, the
    reference's MedicalNet FID, ``src/model.py:158-163``; build one with
    :func:`make_medicalnet_fid_fn`) → ``(metrics, y_hat)``. With a ``mesh``
    G and D run on the shards and everything after them on the gathered
    outputs (``y_hat`` whole, on the mesh's device); in a process group on
    the global batch, every process's outputs gathered (``y_hat`` the
    global batch's)."""
    check_training_mesh(mesh, gen, disc, what="make_eval_step")

    def step(state: GANTrainState, x: Batch, y: Batch):
        if state.gen is not gen or state.disc is not disc:
            raise ValueError("the state does not hold this step's models")
        x, = shard_inputs(mesh, x)
        each_replica(gen, "eval")
        each_replica(disc, "eval")
        with torch.no_grad():
            y_hat = gen(x)
            logits = disc(x, y_hat)
            y_hat, logits, y = gather_global(y_hat, logits, y)
            logits = _acc(logits)
            adv = bce_with_logits(logits, torch.ones_like(logits))
            y_hat32, y32 = _acc(y_hat), _acc(y)
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
    each_replica(gen, "eval")  # gen and its copies on the mesh's other devices

    def predict(x: torch.Tensor) -> torch.Tensor:
        with span("bssfp.predict"), torch.inference_mode():
            if mesh is None:
                return gen(x)
            return gather_batch(gen(shard_batch(mesh, x)))

    return predict
