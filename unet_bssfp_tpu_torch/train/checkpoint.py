"""Checkpoints on ``torch.save`` with top-k retention (counterpart of
``unet_bssfp_tpu/train/checkpoint.py``, which keeps them with Orbax).

The tree keeps the JAX package's shape: ``checkpoint_dir/{modality}-{stamp}/``
holds ``config.json`` and one directory per saved epoch, ``{epoch}/state.pt``.
A step's file holds the whole :class:`~unet_bssfp_tpu_torch.train.state.GANTrainState`:
both models' ``state_dict`` s (parameters and BatchNorm buffers), both AdamW
``state_dict`` s, ``step`` and the dropout generator's state. It is written
to a temporary name, flushed to disk and renamed into place, so a step
directory holds a ``state.pt`` only once the whole file is there: a crash
mid-save never becomes ``find_latest_checkpoint``'s pick.

Retention is Orbax's ``CheckpointManagerOptions(max_to_keep=top_k,
best_fn=monitor, best_mode=mode)`` as the JAX package sets it: after each
save, the ``top_k`` best rows by the monitored metric stay, a row without
the metric ranking worst (``inf`` in min mode); of rows that tie, the later
ones stay.
"""

from __future__ import annotations

import math
import os
import shutil
from typing import Dict, List, Optional, Tuple

import torch

from unet_bssfp_tpu_torch.train.state import GANTrainState

STATE_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, directory: str, monitor: str = "val_loss", mode: str = "min",
                 top_k: int = 10, config_json: Optional[str] = None):
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        if config_json is not None:
            # the config rides with the checkpoints (the reference's
            # save_hyperparameters): a run is rebuilt from its directory
            with open(os.path.join(self.directory, "config.json"), "w") as f:
                f.write(config_json)
        self.monitor = monitor
        self.mode = mode
        self.top_k = top_k
        self._kept: List[Tuple[int, float]] = []  # (step, value), by step

    def save(self, step: int, state: GANTrainState, metrics: Dict[str, float]) -> None:
        value = float(metrics.get(self.monitor, math.inf if self.mode == "min" else -math.inf))
        step_dir = os.path.join(self.directory, str(step))
        os.makedirs(step_dir, exist_ok=True)
        atomic_save(state_payload(state), os.path.join(step_dir, STATE_FILE))
        self._kept.append((step, value))
        retired = self._retired()
        for gone in retired:
            shutil.rmtree(os.path.join(self.directory, str(gone)), ignore_errors=True)
        self._kept = [(s, v) for s, v in self._kept if s not in retired]

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

    def restore(self, state: GANTrainState, step: Optional[int] = None) -> GANTrainState:
        """Load ``step`` (default: the best) into ``state``."""
        if step is None:
            step = self.best_step
        if step is None:
            raise FileNotFoundError(f"no checkpoint saved under {self.directory}")
        return load_checkpoint(os.path.join(self.directory, str(step)), state)


def state_payload(state: GANTrainState) -> dict:
    """What a step's file holds."""
    return {"step": int(state.step),
            "gen": state.gen.state_dict(), "disc": state.disc.state_dict(),
            "gen_opt": state.gen_opt.state_dict(), "disc_opt": state.disc_opt.state_dict(),
            "rng": {"device_type": state.rng.device.type, "state": state.rng.get_state()}}


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
    load the generator alone: :func:`generator_state_dict`)."""
    path = _state_file(path)
    # read on the host; load_state_dict copies each tensor to the device of
    # the entry it fills (AdamW keeps its step counts on the host, as fresh)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state.gen.load_state_dict(payload["gen"], strict=True)
    state.disc.load_state_dict(payload["disc"], strict=True)
    state.gen_opt.load_state_dict(payload["gen_opt"])
    state.disc_opt.load_state_dict(payload["disc_opt"])
    rng = payload["rng"]
    if "seed" in rng:
        state.rng.manual_seed(int(rng["seed"]))
    elif rng["device_type"] == state.rng.device.type:
        state.rng.set_state(rng["state"])
    else:
        raise ValueError(
            f"{path}: its dropout generator state is a {rng['device_type']} "
            f"generator's; the state's generator is on {state.rng.device.type}")
    state.step = int(payload["step"])
    return state
