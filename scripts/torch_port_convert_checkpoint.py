#!/usr/bin/env python3
"""Convert a JAX package checkpoint (Orbax, one step of a
``CheckpointManager`` run) into the port's ``state.pt``.

  python scripts/torch_port_convert_checkpoint.py JAX_STEP_DIR OUT_RUN_DIR \
      [--modality pc-bssfp] [--config cfg.json]

``JAX_STEP_DIR`` is ``checkpoint_dir/{modality}-{stamp}/{epoch}`` (a GAN
run) or ``checkpoint_dir/multistage-{modality}-{stage}/{epoch}`` (a stage
of the multi-stage regime); the result is ``OUT_RUN_DIR/{epoch}/state.pt``
with the run's ``config.json`` copied to ``OUT_RUN_DIR`` (the port's
checkpoint tree, so ``--ckpt auto`` finds a GAN step where ``OUT_RUN_DIR``
lies under the port's ``checkpoint_dir`` with the modality prefix, and
``load_supervised_checkpoint`` takes a stage's). The modality is read from
the run directory's name unless ``--modality`` is given; the config is the
run's ``config.json`` unless ``--config`` is given.

The state is restored through ``unet_bssfp_tpu.train.checkpoint.load_checkpoint``
into the abstract shape of ``create_gan_state``'s; both models' parameters
and batch statistics map through ``weights.from_flax``, and optax AdamW's
``mu``/``nu`` leaf by leaf through the same layout conversion to torch
AdamW's ``exp_avg``/``exp_avg_sq``; optax's one ``count`` becomes every
parameter's ``step`` (torch's bias correction takes the same number). The
JAX RNG key has no torch counterpart: the converted state's dropout
generator is seeded from ``train.seed + 2``, as ``create_gan_state`` seeds
a fresh one, so dropout masks after a resume differ from the JAX run's.

A multi-stage step (``SupervisedState``) is restored into the abstract
shape of ``create_supervised_state(build_multi_input_unet(...))``'s; its
``params`` map through ``weights.from_flax``, and AdamW's moments come from
the ``"train"`` inner state of optax's ``multi_transform`` (frozen leaves
hold masked nodes there and have no moments), onto the stage optimizer's
parameters: the trainable ones in ``named_parameters`` order. The dropout
generator is seeded from ``train.seed + 3·stage + 2``, the port's stage
seed (``run_multistage``).

This script imports both packages (and so needs JAX and Orbax); the port's
runtime imports neither.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Mapping, Optional, Sequence, Tuple

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import orbax.checkpoint as ocp  # noqa: E402
import torch  # noqa: E402

from unet_bssfp_tpu.config import Config as JaxConfig  # noqa: E402
from unet_bssfp_tpu.train import checkpoint as jax_checkpoint  # noqa: E402
from unet_bssfp_tpu.train import multistage as jax_multistage  # noqa: E402
from unet_bssfp_tpu.train.state import create_gan_state as jax_create_gan_state  # noqa: E402
from unet_bssfp_tpu_torch import weights  # noqa: E402
from unet_bssfp_tpu_torch.config import MODALITIES, Config  # noqa: E402
from unet_bssfp_tpu_torch.models.multi_input_unet import TrainingState  # noqa: E402
from unet_bssfp_tpu_torch.train import multistage  # noqa: E402
from unet_bssfp_tpu_torch.train.checkpoint import (  # noqa: E402
    STATE_FILE,
    atomic_save,
    state_payload,
    supervised_payload,
)
from unet_bssfp_tpu_torch.train.state import create_gan_state  # noqa: E402


def modality_of(run_dir: str) -> str:
    """The modality a ``{modality}-{stamp}`` run directory was named for."""
    name = os.path.basename(os.path.normpath(run_dir))
    for m in sorted(MODALITIES, key=len, reverse=True):
        if name.startswith(m + "-"):
            return m
    raise ValueError(f"{run_dir}: no modality prefix in the run's name; pass --modality")


def multistage_run_of(run_dir: str) -> Optional[Tuple[str, TrainingState]]:
    """``(modality, stage)`` of a ``multistage-{modality}-{stage}`` run
    directory (``run_multistage``'s name), else ``None``."""
    name = os.path.basename(os.path.normpath(run_dir))
    for m in sorted(MODALITIES, key=len, reverse=True):
        for stage in TrainingState:
            if name == f"multistage-{m}-{stage.value}":
                return m, stage
    return None


def _adam_state(opt_state):
    """optax AdamW's ``ScaleByAdamState`` (count, mu, nu) in its chain."""
    for part in opt_state:
        if hasattr(part, "mu") and hasattr(part, "nu") and hasattr(part, "count"):
            return part
    raise ValueError("no ScaleByAdamState in the optimizer state")


def torch_optimizer_state(opt: torch.optim.AdamW, names, count, mu, nu) -> dict:
    """torch AdamW's ``state_dict`` holding optax's moments: the optimizer's
    parameter i, named ``names[i]``, takes the leaf of the same path in
    ``mu``/``nu`` (numpy trees), converted as its weight is; optax's one
    ``count`` is every parameter's ``step`` (torch's bias correction takes
    the same number)."""
    mu, nu = weights.from_flax(mu), weights.from_flax(nu)
    if set(names) != set(mu) or set(names) != set(nu):
        raise KeyError(f"optimizer moments do not cover the optimizer's parameters: "
                       f"{sorted(set(names) ^ set(mu))}")
    sd = opt.state_dict()
    sd["state"] = {i: {"step": torch.tensor(float(np.asarray(count))), "exp_avg": mu[n],
                       "exp_avg_sq": nu[n]} for i, n in enumerate(names)}
    return sd


def _trained_moments(opt_state):
    """optax AdamW's ``ScaleByAdamState`` inside the ``"train"`` inner state
    of ``make_stage_optimizer``'s ``multi_transform``, its ``mu``/``nu``
    trees without the masked (frozen) leaves."""
    inner = opt_state.inner_states["train"]
    adam = _adam_state(getattr(inner, "inner_state", inner))

    def kept(tree):
        if isinstance(tree, Mapping):
            out = {k: kept(v) for k, v in tree.items()}
            return {k: v for k, v in out.items() if v is not None}
        return None if isinstance(tree, optax.MaskedNode) else np.asarray(tree)

    return adam.count, kept(adam.mu), kept(adam.nu)


def _saved_leaf(jax_step_dir: str, name: str) -> jax.ShapeDtypeStruct:
    """The shape and dtype of the top-level leaf ``name`` of an Orbax step."""
    item = os.path.join(jax_step_dir, "default")
    meta = ocp.StandardCheckpointer().metadata(item if os.path.isdir(item) else jax_step_dir)
    leaf = meta.item_metadata.tree[name]
    return jax.ShapeDtypeStruct(tuple(leaf.shape), leaf.dtype)


def convert_multistage(jax_step_dir: str, modality: str, stage: TrainingState,
                       config_json: str) -> dict:
    """The port's ``supervised_payload`` of a multi-stage JAX step: the net
    (``dwi-tensor``'s in PRETRAIN) with ``params``, the stage optimizer with
    the trained leaves' moments, the step, the dropout generator's seed."""
    jcfg = JaxConfig.from_json(config_json)
    net_modality = "dwi-tensor" if stage == TrainingState.PRETRAIN else modality
    jnet = jax_multistage.build_multi_input_unet(net_modality, jcfg.model)
    jstage = jax_multistage.TrainingState(stage.value)
    template = jax.eval_shape(lambda: jax_multistage.create_supervised_state(
        jax.random.PRNGKey(jcfg.train.seed), jnet, jcfg.train, jstage, jcfg.data.patch_size))
    # run_multistage draws its keys with the process's default PRNG
    # implementation: the saved key's shape is read from the step
    jstate = jax_checkpoint.load_checkpoint(jax_step_dir, template.replace(
        rng=_saved_leaf(jax_step_dir, "rng")))

    cfg = Config.from_json(config_json)
    seed = cfg.train.seed + 3 * list(TrainingState).index(stage)
    net = multistage.build_multi_input_unet(net_modality, cfg.model, "cpu")
    state = multistage.create_supervised_state(
        seed, net, cfg.train, stage,
        state_dict=weights.from_flax(jax.tree.map(np.asarray, jstate.params)))
    # the stage optimizer's parameters: the trainable ones in
    # named_parameters order (make_stage_optimizer)
    trainable = [n for n, p in net.named_parameters() if p.requires_grad]
    state.opt.load_state_dict(torch_optimizer_state(state.opt, trainable,
                                                    *_trained_moments(jstate.opt_state)))
    state.step = int(np.asarray(jstate.step))
    payload = supervised_payload(state)
    # the JAX key has no torch counterpart: seeded as run_multistage seeds
    # the stage's generator
    payload["rng"] = {"seed": seed + 2}
    return payload


def convert(jax_step_dir: str, out_run_dir: str, modality: Optional[str] = None,
            config_json: Optional[str] = None) -> str:
    """Write the port's checkpoint of ``jax_step_dir``; returns its path."""
    jax_step_dir = os.path.abspath(jax_step_dir)
    run_dir = os.path.dirname(jax_step_dir)
    config_json = config_json or jax_checkpoint.load_config_for_checkpoint(jax_step_dir)
    if config_json is None:
        raise FileNotFoundError(f"no config.json beside {jax_step_dir}; pass --config")
    staged = multistage_run_of(run_dir)
    if staged is not None:
        payload = convert_multistage(jax_step_dir, modality or staged[0], staged[1],
                                     config_json)
        return _write(payload, jax_step_dir, out_run_dir, config_json)
    modality = modality or modality_of(run_dir)
    jcfg = JaxConfig.from_json(config_json)
    # a raw key of the configured implementation's shape, so that
    # create_gan_state has no key to re-seed while it is traced
    key = jax.random.PRNGKey(jcfg.train.seed, impl=jcfg.train.rng_impl or None)
    template = jax.eval_shape(lambda: jax_create_gan_state(
        key, modality, jcfg.model, jcfg.train, patch_size=jcfg.data.patch_size))
    jstate = jax_checkpoint.load_checkpoint(jax_step_dir, template)

    cfg = Config.from_json(config_json)
    state = create_gan_state(cfg.train.seed, modality, cfg.model, cfg.train, "cpu")
    weights.state_from_flax(state.gen, state.disc, {
        k: jax.tree.map(np.asarray, getattr(jstate, k))
        for k in ("gen_params", "gen_batch_stats", "disc_params", "disc_batch_stats")})
    for module, opt, jopt in ((state.gen, state.gen_opt, jstate.gen_opt_state),
                              (state.disc, state.disc_opt, jstate.disc_opt_state)):
        adam = _adam_state(jopt)
        opt.load_state_dict(torch_optimizer_state(
            opt, [n for n, _ in module.named_parameters()], adam.count,
            *(jax.tree.map(np.asarray, t) for t in (adam.mu, adam.nu))))
    state.step = int(np.asarray(jstate.step))
    payload = state_payload(state)
    # the JAX key has no torch counterpart: seeded as create_gan_state does,
    # on whichever device the checkpoint is loaded to
    payload["rng"] = {"seed": cfg.train.seed + 2}
    return _write(payload, jax_step_dir, out_run_dir, config_json)


def _write(payload: dict, jax_step_dir: str, out_run_dir: str, config_json: str) -> str:
    """``payload`` as ``OUT_RUN_DIR/{epoch}/state.pt`` and the config beside it."""
    out_step = os.path.join(out_run_dir, os.path.basename(jax_step_dir))
    os.makedirs(out_step, exist_ok=True)
    path = os.path.join(out_step, STATE_FILE)
    atomic_save(payload, path)
    with open(os.path.join(out_run_dir, "config.json"), "w") as f:
        f.write(config_json)
    return path


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("jax_step_dir", help="checkpoint_dir/{modality}-{stamp}/{epoch} or "
                    "checkpoint_dir/multistage-{modality}-{stage}/{epoch}")
    ap.add_argument("out_run_dir", help="the port's run directory to write into")
    ap.add_argument("--modality", choices=MODALITIES, default=None)
    ap.add_argument("--config", default=None, help="JSON config (default: the run's)")
    args = ap.parse_args(argv)
    config_json = None
    if args.config:
        with open(args.config) as f:
            config_json = f.read()
    path = convert(args.jax_step_dir, args.out_run_dir, args.modality, config_json)
    print(f"wrote {path} (dropout generator seeded as the port seeds a fresh one: "
          f"the JAX RNG key has no torch counterpart)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
