"""The multi-stage regime: pretrain → transfer → finetune of
:class:`~unet_bssfp_tpu_torch.models.multi_input_unet.MultiInputUNet`
(counterpart of ``unet_bssfp_tpu/train/multistage.py``).

Supervised training with the thesis's loss ``L1 + (1 − SSIM) +
perceptual·factor`` (the perceptual term as ``Trainer`` resolves it), in
three stages:

- PRETRAIN: autoencode the DT (input and target ``dwi-tensor``);
- TRANSFER: the target modality's input head on the pretrained backbone,
  only the head trained (the frozen parameters take ``requires_grad=False``:
  no gradient, no update, no decay — optax's ``set_to_zero``; the packed
  conv's backward then launches no weight gradient for them);
- FINE_TUNE: every parameter trained at ``finetune_lr``.

On one device (``cuda`` unless the caller passes another), or on a mesh
(``mesh=``; by default every visible card, ``parallel.mesh.default_mesh``):
the batch split over it as the GAN step splits it, the loss terms (SSIM's
window too) taken on the gathered output, the replicas' gradients reduced
onto the master and its weights broadcast back as the GAN step does. In a
process group each process backpropagates its share of the global batch's
loss and the gradients are summed over the processes, as in the GAN step
(``train/steps.py``). The port draws its own numbers: weights and the dropout
generator from per-stage seeds, the epochs' streams from ``epoch_seeds(seed
+ 17, epoch)`` where the JAX package splits ``PRNGKey(seed + 17)``.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch

from unet_bssfp_tpu_torch import weights
from unet_bssfp_tpu_torch.config import Config, ModelConfig, TrainConfig
from unet_bssfp_tpu_torch.models.layers import bind_dropout_generators
from unet_bssfp_tpu_torch.models.multi_input_unet import (
    MultiInputUNet,
    TrainingState,
    stage_lr,
    trainable_mask,
)
from unet_bssfp_tpu_torch.ops.losses import l1_loss, ssim_loss
from unet_bssfp_tpu_torch.ops.metrics import mae, psnr, ssim3d
from unet_bssfp_tpu_torch.parallel import distributed
from unet_bssfp_tpu_torch.parallel.mesh import (
    Mesh,
    broadcast,
    default_mesh,
    each_replica,
    replicas,
    replicate,
    same_device,
)
from unet_bssfp_tpu_torch.train.checkpoint import CheckpointManager
from unet_bssfp_tpu_torch.train.logging import EarlyStopping, MetricLogger
from unet_bssfp_tpu_torch.train.loop import (
    build_perceptual_fn,
    epoch_seeds,
    resolve_with_perceptual,
    synchronize,
)
from unet_bssfp_tpu_torch.train.state import _DTYPES, auto_packed, mesh_device, resolve_device
from unet_bssfp_tpu_torch.train.steps import (
    check_training_mesh,
    gather_global,
    local_rows,
    over_batch,
    shard_inputs,
    update,
)
from unet_bssfp_tpu_torch.utils.profiling import span

PerceptualFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
STAGES = (TrainingState.PRETRAIN, TrainingState.TRANSFER, TrainingState.FINE_TUNE)


@dataclasses.dataclass
class SupervisedState:
    """A stage's mutable state: the net holds the parameters, ``rng`` draws
    every dropout mask (``replica_rngs`` those of the net's replicas on a
    mesh's other devices), ``opt`` updates the stage's trainable parameters
    of the master. ``epoch_seconds``: each epoch's wall time, the cards
    synchronised at its end (not saved with a checkpoint)."""

    step: int
    rng: torch.Generator
    net: MultiInputUNet
    opt: torch.optim.AdamW
    stage: TrainingState
    epoch_seconds: List[float] = dataclasses.field(default_factory=list)
    replica_rngs: Tuple[torch.Generator, ...] = ()


def build_multi_input_unet(modality: str, mcfg: ModelConfig, device=None,
                           state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                           mesh: Optional[Mesh] = None) -> MultiInputUNet:
    """The net for ``modality`` on ``device`` (default ``cuda``), or on a
    ``mesh``'s first device with a replica on each other one (as
    ``build_models``): ``multistage_features`` (default the thesis's),
    ``compute_dtype``, ``use_pallas`` and ``packed`` through
    ``auto_packed``; ``state_dict`` loaded strictly where given."""
    if mcfg.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype {mcfg.compute_dtype!r} not in {tuple(_DTYPES)}")
    dev = mesh_device(mcfg, device, mesh)
    kw = {}
    if mcfg.multistage_features is not None:
        kw["features"] = tuple(mcfg.multistage_features)
    net = MultiInputUNet(modality=modality, out_channels=mcfg.out_channels,
                         dropout=mcfg.dropout, compute_dtype=_DTYPES[mcfg.compute_dtype],
                         use_fused=mcfg.use_pallas, packed=auto_packed(mcfg, dev, mesh), **kw)
    if state_dict is not None:
        net.load_state_dict(state_dict, strict=True)
    if mesh is not None:
        replicate(net, mesh)
    return net.to(dev)


def make_stage_optimizer(net: MultiInputUNet, tcfg: TrainConfig,
                         stage: TrainingState) -> torch.optim.AdamW:
    """AdamW at the stage's lr over the master's trainable parameters
    only; the others are frozen (``requires_grad=False``) on every
    replica."""
    mask = trainable_mask(net, stage)
    for twin in replicas(net):
        for name, p in twin.named_parameters():
            p.requires_grad_(mask[name])
    params = [p for name, p in net.named_parameters() if mask[name]]
    return torch.optim.AdamW(params, lr=stage_lr(stage, tcfg.lr, tcfg.finetune_lr),
                             betas=(tcfg.b1, tcfg.b2), eps=1e-8,
                             weight_decay=tcfg.weight_decay)


def create_supervised_state(seed: int, net: MultiInputUNet, tcfg: TrainConfig,
                            stage: TrainingState,
                            state_dict: Optional[Mapping[str, torch.Tensor]] = None
                            ) -> SupervisedState:
    """The stage's state on ``net``'s device: ``state_dict`` loaded (default:
    Flax's initialisation drawn from ``seed``) and broadcast to the net's
    replicas, the stage's optimizer, and a dropout generator per replica
    seeded from ``seed + 2`` (as ``create_gan_state`` seeds the
    generator's)."""
    if state_dict is None:
        state_dict = weights.init_state_dict(net, seed)
    net.load_state_dict(state_dict, strict=True)
    broadcast(net)
    rng, *replica_rngs = bind_dropout_generators(net, seed + 2)
    return SupervisedState(step=0, rng=rng, net=net,
                           opt=make_stage_optimizer(net, tcfg, stage), stage=stage,
                           replica_rngs=tuple(replica_rngs))


def _loss_terms(y_hat: torch.Tensor, y: torch.Tensor, tcfg: TrainConfig,
                perceptual_fn: Optional[PerceptualFn]) -> Dict[str, torch.Tensor]:
    """The thesis loss's terms in f32 (f64 for f64 operands)."""
    acc = torch.promote_types(y_hat.dtype, torch.float32)
    y_hat, y = y_hat.to(acc), y.to(acc)
    terms = {"L1": l1_loss(y_hat, y), "SSIM": ssim_loss(y_hat, y)}
    if perceptual_fn is not None:
        terms["Perceptual"] = perceptual_fn(y_hat, y) * tcfg.perceptual_factor
    return terms


def make_supervised_train_step(net: MultiInputUNet, tcfg: TrainConfig,
                               perceptual_fn: Optional[PerceptualFn] = None,
                               mesh: Optional[Mesh] = None
                               ) -> Callable[[SupervisedState, torch.Tensor, torch.Tensor],
                                             Dict[str, torch.Tensor]]:
    """``step(state, x, y) -> metrics``: one AdamW step of the state's
    stage on ``L1 + (1 − SSIM) [+ perceptual·factor]``; metrics
    ``train_loss`` and ``train_loss_{L1,SSIM[,Perceptual]}`` (0-d tensors).
    With a ``mesh`` (the net built with it) the net runs on the shards, the
    terms on the gathered output, and the update as the GAN step's
    (``steps.update``); in a process group the terms are this process's
    shares (``steps.over_batch``) and the metrics their sums."""
    check_training_mesh(mesh, net, what="make_supervised_train_step")

    def losses(y_hat, y):
        terms = _loss_terms(y_hat, y, tcfg, perceptual_fn)
        return {"train_loss": sum(terms.values()),
                **{f"train_loss_{name}": val for name, val in terms.items()}}

    def step(state: SupervisedState, x: torch.Tensor, y: torch.Tensor
             ) -> Dict[str, torch.Tensor]:
        if state.net is not net:
            raise ValueError("the state does not hold this step's net")
        with span("bssfp.step"):
            x, = shard_inputs(mesh, x)
            each_replica(net, "train")
            with span("bssfp.net.forward"):
                y_hat = net(x)
            with span("bssfp.net.loss"):
                out = over_batch(losses, y_hat, y)
            with span("bssfp.net.backward"):
                each_replica(net, "zero_grad")
                out["train_loss"].backward()
            with span("bssfp.net.optimizer"):
                update(net, state.opt)
            state.step += 1
            return distributed.global_metrics({k: v.detach() for k, v in out.items()},
                                              local_rows(y))

    return step


def make_supervised_eval_step(net: MultiInputUNet, tcfg: TrainConfig,
                              perceptual_fn: Optional[PerceptualFn] = None,
                              mesh: Optional[Mesh] = None):
    """``step(state, x, y) -> (metrics, y_hat)`` in eval mode without
    gradients: ``val_loss``, ``val_loss_{L1,SSIM[,Perceptual]}`` and
    ``val_metric_{PSNR,SSIM,L1}``; with a ``mesh`` as the train step, in
    a process group on the global batch (every process's ``y_hat`` and
    ``y`` gathered)."""
    check_training_mesh(mesh, net, what="make_supervised_eval_step")

    def step(state: SupervisedState, x: torch.Tensor, y: torch.Tensor):
        if state.net is not net:
            raise ValueError("the state does not hold this step's net")
        x, = shard_inputs(mesh, x)
        each_replica(net, "eval")
        with torch.no_grad():
            y_hat, y = gather_global(net(x), y)
            terms = _loss_terms(y_hat, y, tcfg, perceptual_fn)
            acc = torch.promote_types(y_hat.dtype, torch.float32)
            y_hat32, y32 = y_hat.to(acc), y.to(acc)
            metrics = {"val_loss": sum(terms.values())}
            for name, val in terms.items():
                metrics[f"val_loss_{name}"] = val
            metrics["val_metric_PSNR"] = torch.mean(psnr(y_hat32, y32))
            metrics["val_metric_SSIM"] = torch.mean(ssim3d(y_hat32, y32))
            metrics["val_metric_L1"] = torch.mean(mae(y_hat32, y32))
        return metrics, y_hat

    return step


def transfer_params(pretrained: Mapping[str, torch.Tensor], target_net: MultiInputUNet,
                    seed: int) -> Dict[str, torch.Tensor]:
    """The TRANSFER head swap: ``target_net``'s initialisation from
    ``seed`` with every top-level subtree that ``pretrained`` also has
    grafted from it: the backbone ``unet`` always, the head only where its
    group (``head_head6`` / ``head_head24``) matches."""
    fresh = weights.init_state_dict(target_net, seed)
    have = {k.split(".", 1)[0] for k in pretrained}
    return {k: (pretrained[k] if k.split(".", 1)[0] in have else v) for k, v in fresh.items()}


def run_multistage(data, target_modality: str, config: Optional[Config] = None,
                   perceptual_fn: Optional[PerceptualFn] = None,
                   epochs_per_stage: Optional[Dict[TrainingState, int]] = None,
                   device=None, pretrain_data=None, mesh: Optional[Mesh] = None
                   ) -> Tuple[Dict[TrainingState, SupervisedState], Dict[str, float]]:
    """The three stages for one target modality on ``device`` (default
    ``cuda``): PRETRAIN on ``dwi-tensor`` (on ``pretrain_data`` where given:
    the thesis pretrains on a large cohort), then TRANSFER and FINE_TUNE on
    ``target_modality``, each for ``epochs_per_stage[stage]`` epochs
    (default ``train.max_epochs``) with its own ``MetricLogger``,
    ``CheckpointManager`` (``multistage-{modality}-{stage}``, monitor
    ``val_loss``, top-k) and early stopping on ``val_loss``. ``mesh`` (a
    ``device`` other than its first raises; with neither given,
    ``default_mesh``: every visible card that ``data.batch_size`` divides):
    every stage's steps on it, batches trimmed to a multiple of its
    positions. Returns the stages' final states and the last epoch's
    row."""
    config = config or Config()
    tcfg = config.train
    divisor = 1
    if mesh is None and device is None:
        mesh = default_mesh(config.data.batch_size)
    if mesh is not None:
        first = mesh.devices[0][0]
        if device is not None and not same_device(device, first):
            raise ValueError(f"device {device} is not the first device of {mesh}")
        device, divisor = first, mesh.positions
    dev = resolve_device(device)
    if perceptual_fn is None and resolve_with_perceptual(tcfg):
        perceptual_fn = build_perceptual_fn(config, dev)
    epochs_per_stage = epochs_per_stage or {}
    states: Dict[TrainingState, SupervisedState] = {}
    row: Dict[str, float] = {}
    params: Optional[Dict[str, torch.Tensor]] = None
    for index, stage in enumerate(STAGES):
        pretrain = stage == TrainingState.PRETRAIN
        modality = "dwi-tensor" if pretrain else target_modality
        stage_data = pretrain_data if pretrain and pretrain_data is not None else data
        stage_data.setup()
        net = build_multi_input_unet(modality, config.model, dev, mesh=mesh)
        seed = tcfg.seed + 3 * index  # weights from seed, dropout from seed + 2
        if stage == TrainingState.TRANSFER and params is not None:
            params = transfer_params(params, net, seed)
        state = create_supervised_state(seed, net, tcfg, stage, state_dict=params)
        train_step = make_supervised_train_step(net, tcfg, perceptual_fn, mesh)
        eval_step = make_supervised_eval_step(net, tcfg, perceptual_fn, mesh)
        name = f"multistage-{target_modality}-{stage.value}"
        logger = MetricLogger(os.path.join(tcfg.log_dir, name))
        ckpt = CheckpointManager(os.path.join(tcfg.checkpoint_dir, name), monitor="val_loss",
                                 top_k=tcfg.checkpoint_top_k, config_json=config.to_json())
        stopper = EarlyStopping("val_loss", patience=tcfg.early_stop_patience)
        keys = tuple(dict.fromkeys((modality, "dwi-tensor")))  # PRETRAIN loads one
        for epoch in range(epochs_per_stage.get(stage, tcfg.max_epochs)):
            start = time.perf_counter()
            train_seed, val_seed = epoch_seeds(tcfg.seed + 17, epoch)
            # logged sorted by name: the JAX package's jitted steps return
            # their metrics so, which orders its metrics.csv's columns
            for batch in stage_data.train_batches(train_seed, keys=keys,
                                                  batch_divisor=divisor, device=dev):
                metrics = train_step(state, batch[modality], batch["dwi-tensor_orig"])
                logger.log_step(dict(sorted(metrics.items())))
            for batch in stage_data.val_batches(val_seed, keys=keys,
                                                batch_divisor=divisor, device=dev):
                metrics, _ = eval_step(state, batch[modality], batch["dwi-tensor_orig"])
                logger.log_step(dict(sorted(metrics.items())))
            synchronize(dev, mesh)
            state.epoch_seconds.append(time.perf_counter() - start)
            row = logger.end_epoch(epoch)
            ckpt.save(epoch, state, row)
            if distributed.on_first(lambda: stopper.update(row)):
                break
        logger.finish()
        params = {k: v.detach().clone() for k, v in net.state_dict().items()}
        states[stage] = state
    return states, row
