"""Checkpoints on ``torch.save`` with top-k retention (counterpart of
``unet_bssfp_tpu/train/checkpoint.py``, which keeps them with Orbax).

The tree keeps the JAX package's shape: ``checkpoint_dir/{modality}-{stamp}/``
holds ``config.json`` and one directory per saved epoch, ``{epoch}/state.pt``.
A step's file holds the whole :class:`~unet_bssfp_tpu_torch.train.state.GANTrainState`:
both models' ``state_dict`` s (parameters and BatchNorm buffers), both AdamW
``state_dict`` s, ``step`` and the dropout generator's state; or, for a
multi-stage run (``train/multistage.py``), the whole ``SupervisedState``:
``kind`` ``"supervised"``, the stage, the net's and its AdamW's
``state_dict`` s, ``step`` and the generator's state. On a mesh over
several devices the models are the masters (the first device's) and the
file also holds each replica's dropout generator state
(``replica_rngs``); a load copies the loaded weights into the replicas
(``broadcast``), and the file loads on one device too. It is written
to a temporary name, flushed to disk and renamed into place, so a step
directory holds a ``state.pt`` only once the whole file is there: a crash
mid-save never becomes ``find_latest_checkpoint``'s pick.

Retention is Orbax's ``CheckpointManagerOptions(max_to_keep=top_k,
best_fn=monitor, best_mode=mode)`` as the JAX package sets it: after each
save, the ``top_k`` best rows by the monitored metric stay, a row without
the metric ranking worst (``inf`` in min mode); of rows that tie, the later
ones stay.

In a process group every process holds the same state, so process 0 alone
writes the directory, ``config.json`` and each step (and retires steps);
the others keep the same bookkeeping and wait at a barrier after each save.
Every process loads the same step.
"""

from __future__ import annotations

import math
import os
import shutil
from typing import Dict, List, Optional, Tuple

import torch

from unet_bssfp_tpu_torch.parallel import distributed
from unet_bssfp_tpu_torch.parallel.mesh import broadcast
from unet_bssfp_tpu_torch.train.state import GANTrainState

STATE_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, directory: str, monitor: str = "val_loss", mode: str = "min",
                 top_k: int = 10, config_json: Optional[str] = None):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.directory = os.path.abspath(directory)
        self._writes = distributed.process_index() == 0
        if self._writes:
            os.makedirs(self.directory, exist_ok=True)
        if config_json is not None and self._writes:
            # the config rides with the checkpoints (the reference's
            # save_hyperparameters): a run is rebuilt from its directory
            with open(os.path.join(self.directory, "config.json"), "w") as f:
                f.write(config_json)
        self.monitor = monitor
        self.mode = mode
        self.top_k = top_k
        self._kept: List[Tuple[int, float]] = []  # (step, value), by step

    def save(self, step: int, state, metrics: Dict[str, float]) -> None:
        """Write ``state`` (a ``GANTrainState`` or a ``SupervisedState``) as
        step ``step``, then retire what falls out of the top k."""
        value = float(metrics.get(self.monitor, math.inf if self.mode == "min" else -math.inf))
        if self._writes:
            step_dir = os.path.join(self.directory, str(step))
            os.makedirs(step_dir, exist_ok=True)
            payload = (state_payload(state) if isinstance(state, GANTrainState)
                       else supervised_payload(state))
            atomic_save(payload, os.path.join(step_dir, STATE_FILE))
        self._kept.append((step, value))
        retired = self._retired()
        for gone in retired if self._writes else ():
            shutil.rmtree(os.path.join(self.directory, str(gone)), ignore_errors=True)
        self._kept = [(s, v) for s, v in self._kept if s not in retired]
        distributed.barrier()

    def _rank(self, value: float) -> float:
        """The value sorted on: a NaN row ranks worst."""
        if math.isnan(value):
            return math.inf if self.mode == "min" else -math.inf
        return value

    def _retired(self) -> List[int]:
        """Orbax's BestN: order the kept rows from worst to best (a stable
        sort, so rows that tie stay in step order) and keep the last
        ``top_k``."""
        if len(self._kept) <= self.top_k:
            return []
        ranked = sorted(self._kept, key=lambda sv: self._rank(sv[1]),
                        reverse=self.mode == "min")
        keep = {s for s, _ in ranked[len(ranked) - self.top_k:]} if self.top_k else set()
        return [s for s, _ in self._kept if s not in keep]

    @property
    def steps(self) -> List[int]:
        """The steps on disk, oldest first."""
        return [s for s, _ in self._kept]

    @property
    def best_step(self) -> Optional[int]:
        """The first step, among those kept, whose monitored value is the
        best (the step the JAX package's manager names, except where that
        one was retired for a later row that ties with it)."""
        if not self._kept:
            return None
        pick = min if self.mode == "min" else max
        best = pick(self._rank(v) for _, v in self._kept)
        return next(s for s, v in self._kept if self._rank(v) == best)

    def best_path(self) -> Optional[str]:
        step = self.best_step
        return None if step is None else os.path.join(self.directory, str(step))

    def restore(self, state, step: Optional[int] = None):
        """Load ``step`` (default: the best) into ``state`` (either kind)."""
        if step is None:
            step = self.best_step
        if step is None:
            raise FileNotFoundError(f"no checkpoint saved under {self.directory}")
        load = load_checkpoint if isinstance(state, GANTrainState) else load_supervised_checkpoint
        return load(os.path.join(self.directory, str(step)), state)


def state_payload(state: GANTrainState) -> dict:
    """What a step's file holds."""
    return {"step": int(state.step),
            "gen": state.gen.state_dict(), "disc": state.disc.state_dict(),
            "gen_opt": state.gen_opt.state_dict(), "disc_opt": state.disc_opt.state_dict(),
            **_rng_payload(state)}


def supervised_payload(state) -> dict:
    """What a multi-stage step's file holds (``SupervisedState``)."""
    return {"kind": "supervised", "stage": state.stage.value, "step": int(state.step),
            "net": state.net.state_dict(), "opt": state.opt.state_dict(),
            **_rng_payload(state)}


def _rng_payload(state) -> dict:
    """The master's dropout generator state and, where the state has
    replicas on other devices, theirs in the mesh's order."""
    entry = lambda g: {"device_type": g.device.type, "state": g.get_state()}  # noqa: E731
    out = {"rng": entry(state.rng)}
    if state.replica_rngs:
        out["replica_rngs"] = [entry(g) for g in state.replica_rngs]
    return out


def atomic_save(obj, path: str) -> None:
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            torch.save(obj, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def find_latest_checkpoint(checkpoint_dir: str, modality: Optional[str] = None
                           ) -> Optional[str]:
    """The newest step, holding a whole ``state.pt``, of the newest run under
    ``checkpoint_dir`` (runs filtered by the modality prefix): what
    ``--ckpt auto`` resumes from."""
    root = os.path.abspath(checkpoint_dir)
    if not os.path.isdir(root):
        return None
    runs = sorted(d for d in os.listdir(root)
                  if os.path.isdir(os.path.join(root, d))
                  and (modality is None or d.startswith(modality)))
    for run in reversed(runs):
        run_dir = os.path.join(root, run)
        steps = sorted((int(s) for s in os.listdir(run_dir) if s.isdigit()), reverse=True)
        for step in steps:
            step_dir = os.path.join(run_dir, str(step))
            if os.path.isfile(os.path.join(step_dir, STATE_FILE)):
                return step_dir
    return None


def load_config_for_checkpoint(path: str) -> Optional[str]:
    """The ``config.json`` saved beside a checkpoint (walks up from the file
    or step directory to the run's directory)."""
    path = os.path.abspath(path)
    for _ in range(3):
        candidate = os.path.join(path, "config.json")
        if os.path.exists(candidate):
            with open(candidate) as f:
                return f.read()
        path = os.path.dirname(path)
    return None


def _state_file(path: str) -> str:
    return os.path.join(path, STATE_FILE) if os.path.isdir(path) else path


def generator_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The generator's weights and BatchNorm buffers of a step (its directory
    or its ``state.pt``), read on the host: what evaluation and serving load,
    strictly (``build_models(..., state_dict=)``), into a generator on any
    device. Nothing else of the file is used, so a checkpoint saved on the
    card evaluates on the CPU and the reverse (the dropout generator's state,
    which :func:`load_checkpoint` restores, is device-specific)."""
    return torch.load(_state_file(path), map_location="cpu", weights_only=True)["gen"]


def load_checkpoint(path: str, state: GANTrainState) -> GANTrainState:
    """Load a step (its directory or its ``state.pt``) into ``state``, in
    place, and return it. Tensors land on the state's devices; every model
    and optimizer entry must match (``strict``). The dropout generator takes
    the saved state where it was saved from a generator of the same device
    type, or is seeded where the file holds a seed (a converted checkpoint,
    ``scripts/torch_port_convert_checkpoint.py``); a state of another
    device type's generator raises (to evaluate or serve a step elsewhere,
    load the generator alone: :func:`generator_state_dict`). The replicas'
    generators take the file's replica states where it has them, pairwise
    in the mesh's order, and the loaded weights are broadcast to the
    replicas."""
    path = _state_file(path)
    # read on the host; load_state_dict copies each tensor to the device of
    # the entry it fills (AdamW keeps its step counts on the host, as fresh)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state.gen.load_state_dict(payload["gen"], strict=True)
    state.disc.load_state_dict(payload["disc"], strict=True)
    state.gen_opt.load_state_dict(payload["gen_opt"])
    state.disc_opt.load_state_dict(payload["disc_opt"])
    _restore_rngs(state, payload, path)
    broadcast(state.gen)
    broadcast(state.disc)
    state.step = int(payload["step"])
    return state


def load_supervised_checkpoint(path: str, state):
    """Load a multi-stage step (its directory or its ``state.pt``) into the
    ``SupervisedState`` ``state`` of the same stage, in place, and return
    it: the net and its AdamW strictly, the step, the dropout generator (as
    :func:`load_checkpoint` restores it)."""
    path = _state_file(path)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if payload.get("kind") != "supervised" or payload["stage"] != state.stage.value:
        raise ValueError(f"{path}: not a {state.stage.value} stage's multi-stage checkpoint")
    state.net.load_state_dict(payload["net"], strict=True)
    state.opt.load_state_dict(payload["opt"])
    _restore_rngs(state, payload, path)
    broadcast(state.net)
    state.step = int(payload["step"])
    return state


def _restore_rngs(state, payload: dict, path: str) -> None:
    """The master's dropout generator, then each replica's that the file
    holds."""
    _restore_rng(state.rng, payload["rng"], path)
    for gen, saved in zip(state.replica_rngs, payload.get("replica_rngs", ())):
        _restore_rng(gen, saved, path)


def _restore_rng(gen: torch.Generator, saved: dict, path: str) -> None:
    """The dropout generator from a checkpoint: the saved state where it is
    a generator's of the same device type, a seed where the file holds one;
    another device type's state raises."""
    if "seed" in saved:
        gen.manual_seed(int(saved["seed"]))
    elif saved["device_type"] == gen.device.type:
        gen.set_state(saved["state"])
    else:
        raise ValueError(
            f"{path}: its dropout generator state is a {saved['device_type']} "
            f"generator's; the state's generator is on {gen.device.type}")
