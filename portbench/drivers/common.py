"""What the drivers share: the program's configuration objects built from
a configuration file, the program's record of its first steps, the layout
in which the program draws dropout masks, and the reference's float32
mode."""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict, List

import torch

from portbench import check
from portbench import flops as pf
from portbench.reference.train import Record


def model_config(cfg: dict):
    from unet_bssfp_tpu_torch.config import ModelConfig

    kw = dict(dropout=cfg["dropout"], out_channels=cfg["out_channels"],
              compute_dtype=cfg["compute_dtype"], packed=cfg["packed"])
    if cfg["model"] == "gan":
        kw.update(features=tuple(cfg["features"]), unet_in_channels=cfg["unet_in_channels"],
                  unet_negative_slope=cfg["unet_negative_slope"],
                  disc_negative_slope=cfg["disc_negative_slope"],
                  disc_features=tuple(cfg["disc_features"]))
    else:
        kw.update(multistage_features=tuple(cfg["features"]))
    return ModelConfig(**kw)


def train_config(cfg: dict):
    from unet_bssfp_tpu_torch.config import TrainConfig

    t = cfg["train"]
    return TrainConfig(lr=t["lr"], weight_decay=t["weight_decay"], b1=t["b1"], b2=t["b2"],
                       recon_factor=t.get("recon_factor", 1e2),
                       finetune_lr=t.get("finetune_lr", 1e-5),
                       with_perceptual=t.get("with_perceptual", False),
                       reuse_fake=t.get("reuse_fake", False))


def packed_layout(cfg: dict, patch: int, device) -> bool:
    """Whether the program runs the full-resolution stages on the packed
    layout: ``packed`` as configured, or where it is ``null`` on a CUDA
    device; and the patch fits it (H·W a multiple of 128, even sides, at
    most 128 channels)."""
    packed = cfg["packed"] if cfg["packed"] is not None else torch.device(device).type == "cuda"
    widest = max(cfg["features"][0], cfg.get("unet_in_channels", cfg.get("head_features", 0)))
    return bool(packed and (patch * patch) % 128 == 0 and patch % 2 == 0 and widest <= 128)


def norm_act_work(cfg: dict, rows: int, patch: int, passes) -> Dict[str, dict]:
    """A driver's ``kernel_work`` entry for K10 (``norm_act_kernel_packed_*``),
    where the full-resolution stages run packed on a CUDA device: its least
    bytes an item (:func:`portbench.flops.norm_act_bytes`) and no FLOPs (a
    few f32 operations an element, far inside the CUDA cores' rate, which
    the bf16 peak does not measure)."""
    if not packed_layout(cfg, patch, "cuda"):
        return {}
    elem = torch.finfo(getattr(torch, cfg["compute_dtype"])).bits // 8
    return {"norm_act": {"keys": ["norm_act_kernel_packed"], "flops": 0.0,
                         "bytes": pf.norm_act_bytes(passes, rows, patch, cfg["features"], elem,
                                                    cfg["dropout"] > 0)}}


class Phases:
    """Seconds of each named part of a set-up, for the run's log."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self._t = time.perf_counter()

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = round(now - self._t, 3)
        self._t = now


class TrainLoop:
    """What the training drivers share: a step on the next resident batch
    (with the ``half`` fault, on its first half), the window's item, and
    the check of the program's record against the reference's.
    A subclass sets ``cfg``, ``traffic``, ``seed``, ``device``, ``fault``,
    ``state``, ``step``, ``x``, ``y`` and ``record``, and gives
    :meth:`reference`."""

    kind = "train"
    sync_each = False  # steps run back to back, as a training loop runs them

    def _step(self, i: int) -> Dict[str, torch.Tensor]:
        b = i % self.traffic["pool_batches"]
        x, y = self.x[b], self.y[b]
        if self.fault == "half":
            x, y = x[:len(x) // 2], y[:len(y) // 2]
        return self.step(self.state, x, y)

    def item(self, i: int, annotate: bool = False) -> None:
        """The window's ``i``-th step (after the checked ones)."""
        with torch.profiler.record_function("portbench.step") if annotate \
                else contextlib.nullcontext():
            self._step(self.traffic["checked_steps"] + i)

    def reference(self) -> Record:
        raise NotImplementedError

    def check(self) -> Dict[str, float]:
        """Free the program's state, run the reference over the checked
        steps, compare."""
        prog = self.record
        del self.state, self.step, self.x, self.y
        release()
        ref = self.reference()
        self.compared = prog, ref
        return check.training_gaps(prog, ref)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def release() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


@contextlib.contextmanager
def float32_reference():
    """TF32 off for matmuls and cuDNN convs while the reference runs."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def first_gradients(named: Dict[str, torch.nn.Parameter], opt, b1: float) -> Dict[str, float]:
    """Each leaf's gradient norm at the first step, from AdamW's state after
    it: ``exp_avg = (1 − b1)·g``; a leaf the optimizer holds no state for
    reads 0."""
    out = {}
    for name, p in named.items():
        st = opt.state.get(p, {})
        out[name] = (st["exp_avg"].norm() / (1.0 - b1)).item() if "exp_avg" in st else 0.0
    return out


def record(losses: List[List[torch.Tensor]], grad1: Dict[str, float],
           named: Dict[str, torch.nn.Parameter], start: Dict[str, torch.Tensor]) -> Record:
    """The program's record: the steps' losses, ``grad1``, and each leaf's
    change from ``start``."""
    with torch.no_grad():
        delta = {k: (p.detach().float() - start[k]).norm().item() for k, p in named.items()}
    return Record([[float(t) for t in step] for step in losses], grad1, delta)
