"""The epoch loop: the ``trainer.fit`` equivalent (counterpart of
``unet_bssfp_tpu/train/loop.py``).

The reference's Lightning orchestration (``src/train.py:15-77``): at most
50 epochs, early stopping on ``val_gen_loss_recon`` (patience 10), top-10
checkpoints by ``val_loss``, CSV/W&B metric logging, wall-time prints and
resume from a checkpoint, driving the GAN step on one device (``cuda``
unless the caller passes another) or on a mesh (``mesh=``; with neither
given, every visible card that the batch divides, as the JAX loop's default
mesh: ``parallel.mesh.default_mesh``): every batch is trimmed to a multiple
of the mesh's positions and split over it, as the JAX loop's
``batch_divisor`` and ``shard_batch`` do.

In a process group (``parallel.distributed``) every process runs the loop
on its own device (or mesh) and its share of the data; the decisions the
processes must share are process 0's, broadcast: the run's name (picked
by looking at the disk), the checkpoint ``--ckpt auto`` resumes, and early
stopping. Process 0 alone writes the logs and checkpoints.
"""

from __future__ import annotations

import contextlib
import datetime
import itertools
import logging
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from unet_bssfp_tpu_torch.config import Config
from unet_bssfp_tpu_torch.models.medicalnet import (
    load_medicalnet,
    medicalnet_is_pretrained,
    perceptual_distance,
)
from unet_bssfp_tpu_torch.parallel import distributed
from unet_bssfp_tpu_torch.parallel.mesh import Mesh, default_mesh, same_device
from unet_bssfp_tpu_torch.train.checkpoint import (
    CheckpointManager,
    find_latest_checkpoint,
    load_checkpoint,
)
from unet_bssfp_tpu_torch.train.logging import EarlyStopping, MetricLogger
from unet_bssfp_tpu_torch.train.state import GANTrainState, create_gan_state, resolve_device
from unet_bssfp_tpu_torch.train.steps import make_eval_step, make_train_step
from unet_bssfp_tpu_torch.utils.debug import enable_nan_checks
from unet_bssfp_tpu_torch.utils.profiling import span, trace

#: Highest ``perceptual_factor`` at which ``with_perceptual=None`` (auto)
#: may turn the perceptual term on: the JAX package's bound, 0.0. The
#: reference's 1e3 with non-pretrained features collapsed training, and a
#: structural fingerprint cannot tell the published Med3D file from any
#: same-shaped one, so auto enables the term only at factors with a
#: non-degrading convergence record behind them: none yet. An explicit
#: ``with_perceptual=True`` forces it on at any factor.
PERCEPTUAL_AUTO_MAX_FACTOR = 0.0
#: Steps of the first epoch that ``debug=True`` traces.
DEBUG_TRACE_STEPS = 5


def resolve_with_perceptual(tcfg) -> bool:
    """The ``with_perceptual`` tri-state: an explicit True or False wins;
    None (auto) is on iff a converted Med3D checkpoint passes the pinned
    fingerprint AND ``perceptual_factor`` is at most
    :data:`PERCEPTUAL_AUTO_MAX_FACTOR`, and otherwise off with the JAX
    package's warning."""
    if tcfg.with_perceptual is not None:
        return tcfg.with_perceptual
    log = logging.getLogger(__name__)
    if medicalnet_is_pretrained(tcfg.medicalnet_weights):
        if tcfg.perceptual_factor <= PERCEPTUAL_AUTO_MAX_FACTOR:
            return True
        log.warning(
            "with_perceptual=None (auto): converted Med3D weights resolve but "
            "perceptual_factor=%g exceeds the validated auto bound %g (the full objective "
            "at 1e3 with non-pretrained features collapsed training). Training with the "
            "L1+BCE objective; set with_perceptual=true to force the term on at this factor.",
            tcfg.perceptual_factor, PERCEPTUAL_AUTO_MAX_FACTOR)
        return False
    log.warning(
        "with_perceptual=None (auto) and no converted Med3D weights found: training with "
        "the L1+BCE objective. The reference's perceptual term needs pretrained features; "
        "the random-feature term at perceptual_factor=1e3 hurts voxel fidelity. Set "
        "with_perceptual=true to force it on.")
    return False


def build_perceptual_fn(config: Config, device=None):
    """The MedicalNet perceptual distance (reference ``PerceptualL1Loss``,
    ``src/model.py:123-138``) as ``fn(y_hat, y)``: the converted Med3D
    weights where ``train.medicalnet_weights`` resolves to them, else random
    features; the net in ``train.perceptual_dtype`` or else
    ``model.compute_dtype``, on ``device`` (default ``cuda``), its slabs in
    groups of ``train.perceptual_chunk``."""
    name = config.train.perceptual_dtype or config.model.compute_dtype
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"perceptual dtype {name!r} is not a torch floating-point dtype")
    net = load_medicalnet(config.train.medicalnet_weights, dtype=dtype,
                          device=resolve_device(device))
    chunk = config.train.perceptual_chunk

    def perceptual_fn(y_hat: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return perceptual_distance(net, y_hat, y, chunk=chunk)

    return perceptual_fn


def epoch_seeds(seed: int, epoch: int) -> Tuple[int, int]:
    """The train and val streams' seeds of ``epoch``, derived from ``seed``
    (the loop passes ``train.seed + 1``, as the JAX loop splits its epoch
    key from ``PRNGKey(seed + 1)``)."""
    a, b = np.random.SeedSequence([seed, epoch]).generate_state(2, np.uint32)
    return int(a), int(b)


def synchronize(device: torch.device, mesh: Optional[Mesh] = None) -> None:
    """Wait for the cards a run uses: ``device``, or each CUDA device of
    ``mesh``."""
    for dev in (mesh.distinct if mesh is not None else (device,)):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _run_name(config: Config, modality: str) -> str:
    """``{modality}-{stamp}``, with a suffix where a run of the same second
    already has a log or checkpoint directory (sorted after it, so it is
    still the newest)."""
    base = f"{modality}-{datetime.datetime.now():%Y%m%d-%H%M%S}"
    name, n = base, 0
    while any(os.path.exists(os.path.join(d, name))
              for d in (config.train.log_dir, config.train.checkpoint_dir)):
        n += 1
        name = f"{base}-{n}"
    return name


class Trainer:
    """The loop of one modality's GAN. ``mesh``: train on its positions,
    the models' masters on its first device, the Trainer's (a ``device``
    other than it raises). With neither ``device`` nor ``mesh``, the mesh
    is ``default_mesh(data.batch_size)``: every visible card that the batch
    divides, or none (one card: ``cuda``)."""

    def __init__(self, config: Config, modality: str, device=None,
                 mesh: Optional[Mesh] = None, perceptual_fn=None, debug: bool = False):
        self.config = config
        self.modality = modality
        if mesh is None and device is None:
            mesh = default_mesh(config.data.batch_size)
        if mesh is not None:
            first = mesh.devices[0][0]
            if device is not None and not same_device(device, first):
                raise ValueError(f"device {device} is not the first device of {mesh}")
            device = first
        self.mesh = mesh
        self.batch_divisor = mesh.positions if mesh is not None else 1
        self.device = resolve_device(device)
        if perceptual_fn is None and resolve_with_perceptual(config.train):
            perceptual_fn = build_perceptual_fn(config, self.device)
        self.perceptual_fn = perceptual_fn
        self.debug = debug
        run_name = distributed.on_first(lambda: _run_name(config, modality))
        self.logger = MetricLogger(os.path.join(config.train.log_dir, run_name),
                                   wandb_project=config.train.wandb_project,
                                   run_name=run_name)
        self.ckpt = CheckpointManager(
            os.path.join(config.train.checkpoint_dir, run_name),
            monitor=config.train.checkpoint_monitor, top_k=config.train.checkpoint_top_k,
            config_json=config.to_json())
        self.early_stop = EarlyStopping(config.train.early_stop_monitor,
                                        patience=config.train.early_stop_patience)

    def init_state(self, seed: Optional[int] = None) -> GANTrainState:
        return create_gan_state(self.config.train.seed if seed is None else seed,
                                self.modality, self.config.model, self.config.train,
                                self.device, mesh=self.mesh)

    def train_step(self, state: GANTrainState, x: torch.Tensor, y: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
        """One GAN step on ``state``'s models (``steps.make_train_step``)."""
        return make_train_step(state.gen, state.disc, self.config.train, self.perceptual_fn,
                               mesh=self.mesh,
                               reuse_fake=self.config.train.reuse_fake)(state, x, y)

    def eval_step(self, state: GANTrainState, x: torch.Tensor, y: torch.Tensor):
        """``(metrics, y_hat)`` of ``state``'s models (``steps.make_eval_step``)."""
        return make_eval_step(state.gen, state.disc, self.config.train,
                              self.perceptual_fn, mesh=self.mesh)(state, x, y)

    def _val_pass(self, data, state, seed, keys, augment: bool, prefix: str) -> None:
        for batch in data.val_batches(seed, keys=keys, batch_divisor=self.batch_divisor,
                                      augment=augment, device=self.device):
            metrics, _ = self.eval_step(state, batch[self.modality], batch["dwi-tensor_orig"])
            self.logger.log_step({k.replace("val_", prefix, 1): v for k, v in metrics.items()})

    def fit(self, data, state: Optional[GANTrainState] = None,
            max_epochs: Optional[int] = None) -> Tuple[GANTrainState, Optional[str]]:
        """Train ``state`` (default: a fresh one from ``train.seed``) for at
        most ``max_epochs`` on ``data``'s streams; each epoch: the train
        stream, the (augmented) val pass, with ``log_clean_val`` a second,
        un-augmented val pass logged as ``val_clean_*``, the epoch's row,
        its checkpoint, then early stopping. Returns ``(state, the best
        checkpoint's path)``."""
        cfg = self.config
        if state is None:
            state = self.init_state()
        data.setup()
        keys = (self.modality, "dwi-tensor")
        max_epochs = max_epochs or cfg.train.max_epochs
        uploaded = set()  # checkpoints pushed to W&B during the run
        with contextlib.ExitStack() as run:
            if self.debug:  # autograd's anomaly mode for the run (jax_debug_nans)
                run.enter_context(enable_nan_checks())
            for epoch in range(max_epochs):
                epoch_start = time.perf_counter()
                train_seed, val_seed = epoch_seeds(cfg.train.seed + 1, epoch)
                tracing = contextlib.ExitStack()
                if self.debug and epoch == 0:
                    tracing.enter_context(trace(os.path.join(cfg.train.log_dir, "trace")))
                with tracing:
                    batches = iter(data.train_batches(
                        train_seed, keys=keys, batch_divisor=self.batch_divisor,
                        device=self.device))
                    for i in itertools.count():
                        with span("bssfp.data_wait"):
                            batch = next(batches, None)
                        if batch is None:
                            break
                        self.logger.log_step(self.train_step(
                            state, batch[self.modality], batch["dwi-tensor_orig"]))
                        if i + 1 == DEBUG_TRACE_STEPS:
                            tracing.close()
                self._val_pass(data, state, val_seed, keys, True, "val_")
                if cfg.train.log_clean_val:
                    # the same checkpoint on clean inputs: the cost of the
                    # reference's augmented-val convention; early stop and
                    # checkpoint selection still key on val_*
                    self._val_pass(data, state, val_seed, keys, False, "val_clean_")
                synchronize(self.device, self.mesh)
                elapsed = time.perf_counter() - epoch_start
                row = self.logger.end_epoch(epoch, extra={"epoch_seconds": elapsed})
                self.ckpt.save(epoch, state, row)
                if self.logger.wandb_enabled:
                    # the reference's WandbLogger(log_model='all'): each
                    # checkpoint as it is saved, so a crash loses nothing
                    step_dir = os.path.join(self.ckpt.directory, str(epoch))
                    if os.path.isdir(step_dir):
                        self.logger.log_artifact(step_dir, name=f"{self.modality}-ckpt-{epoch}")
                        uploaded.add(epoch)
                if distributed.on_first(lambda: self.early_stop.update(row)):
                    break
        for step in self.ckpt.steps:
            if step not in uploaded:
                self.logger.log_artifact(os.path.join(self.ckpt.directory, str(step)),
                                         name=f"{self.modality}-ckpt-{step}")
        return state, self.ckpt.best_path()


def build_trainer_args(debug: bool, modality: str, config: Optional[Config] = None) -> dict:
    """The keyword set :class:`Trainer` takes (reference
    ``build_trainer_args``, ``src/train.py:15-43``): ``config`` (default
    ``Config()``), ``modality`` and ``debug``."""
    return {"config": config or Config(), "modality": modality, "debug": debug}


def train_model(data, modality: str, ckpt_path: Optional[str] = None, debug: bool = False,
                config: Optional[Config] = None, max_epochs: Optional[int] = None,
                device=None) -> Optional[str]:
    """``train_model`` (reference ``src/train.py:46-77``): builds the
    trainer, resumes from ``ckpt_path`` (``"auto"``: the newest whole
    checkpoint of the newest run of ``modality``), fits, and returns the
    best checkpoint's path."""
    config = config or Config()
    start = datetime.datetime.now()
    trainer = Trainer(config, modality, device=device, debug=debug)
    state = trainer.init_state()
    if ckpt_path == "auto":
        ckpt_path = distributed.on_first(
            lambda: find_latest_checkpoint(config.train.checkpoint_dir, modality))
        if ckpt_path:
            print(f"Auto-resuming from {ckpt_path}")
    if ckpt_path:
        state = load_checkpoint(ckpt_path, state)
    print(f"Training for modality {modality} started at {start}")
    state, best = trainer.fit(data, state, max_epochs=max_epochs)
    end = datetime.datetime.now()
    print(f"Training finished at {end}.\nTook: {end - start}")
    trainer.logger.finish()
    return best
