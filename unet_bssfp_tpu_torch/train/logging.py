"""Metric logging: CSV always, W&B when configured (counterpart of
``unet_bssfp_tpu/train/logging.py``).

Metric names follow the reference scheme
(``{step}_{gen|discr}_loss[_recon_{L1|Perceptual}]``,
``{step}_metric_{PSNR|SSIM|L1}``); an epoch's row is the mean of its step
values (Lightning's ``on_epoch=True``), written with the same columns, in
the same order and the same number formatting as the JAX package's logger.
"""

from __future__ import annotations

import csv
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

#: Minimum seconds between heartbeat-file touches in ``log_step``.
HEARTBEAT_INTERVAL_S = 15.0


class MetricLogger:
    def __init__(self, log_dir: str, wandb_project: Optional[str] = None,
                 run_name: Optional[str] = None):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._epoch_acc: Dict[str, list] = defaultdict(list)
        self._rows = []
        self._fieldnames = ["epoch"]
        self._csv_path = os.path.join(log_dir, "metrics.csv")
        self._heartbeat_path = os.path.join(log_dir, "heartbeat")
        self._heartbeat_last = float("-inf")
        self._wandb = None
        if wandb_project:
            try:
                import wandb

                self._wandb = wandb.init(project=wandb_project, name=run_name, dir=log_dir)
            except Exception:  # W&B is optional: the CSV is the record
                self._wandb = None

    def log_step(self, metrics: Dict[str, object]) -> None:
        """Keep the step's values as they come (0-d device tensors): reading
        one here would synchronise the host with the card every step and
        stall the data stream's prefetch; ``end_epoch`` copies them once."""
        for k, v in metrics.items():
            self._epoch_acc[k].append(v)
        # Step-granular liveness for the stall watchdog (utils/watchdog.py):
        # metrics.csv is rewritten only at epoch end.
        now = time.monotonic()
        if now - self._heartbeat_last >= HEARTBEAT_INTERVAL_S:
            self._heartbeat_last = now
            try:
                with open(self._heartbeat_path, "w") as f:
                    f.write(f"{time.time():.0f}\n")
            except OSError:
                pass

    def end_epoch(self, epoch: int, extra: Optional[Dict[str, float]] = None
                  ) -> Dict[str, float]:
        values = _to_floats(self._epoch_acc)
        row: Dict[str, float] = {k: float(sum(v) / len(v)) for k, v in values.items() if v}
        if extra:
            row.update({k: float(v) for k, v in extra.items()})
        self._epoch_acc.clear()
        row_out = {"epoch": epoch, **row}
        self._rows.append(row_out)
        for k in row_out:
            if k not in self._fieldnames:
                self._fieldnames.append(k)
        with open(self._csv_path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self._fieldnames)
            writer.writeheader()
            writer.writerows(self._rows)
        if self._wandb is not None:
            self._wandb.log(row, step=epoch)
        return row

    def write_table(self, name: str, row: Dict[str, float]) -> str:
        """Write a single-row CSV (e.g. ``test_metrics.csv``)."""
        path = os.path.join(self.log_dir, name)
        with open(path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(row.keys()))
            writer.writeheader()
            writer.writerow({k: float(v) for k, v in row.items()})
        return path

    @property
    def wandb_enabled(self) -> bool:
        """True when a live W&B run backs this logger."""
        return self._wandb is not None

    def log_artifact(self, path: str, name: str, type: str = "model",
                     metadata: Optional[Dict[str, float]] = None) -> None:
        """Push a checkpoint directory or file as a W&B artifact (the
        reference's ``WandbLogger(log_model='all')``). No-op without W&B."""
        if self._wandb is None:
            return
        try:
            import wandb

            art = wandb.Artifact(name, type=type, metadata=metadata or {})
            if os.path.isdir(path):
                art.add_dir(path)
            else:
                art.add_file(path)
            self._wandb.log_artifact(art)
        except Exception:  # an upload must never sink a training run
            pass

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()


def _to_floats(acc: Dict[str, list]) -> Dict[str, list]:
    """Every accumulated value as a Python float, in order. The tensors of
    each device are stacked (in f64, which holds an f32 or bf16 value
    exactly) and copied to the host in one transfer."""
    tensors: Dict[torch.device, list] = defaultdict(list)
    for vals in acc.values():
        for v in vals:
            if isinstance(v, torch.Tensor):
                tensors[v.device].append(v)
    host = {}
    for dev, ts in tensors.items():
        flat = torch.stack([t.detach().reshape(()).to(torch.float64) for t in ts]).cpu()
        host.update(zip(map(id, ts), flat.tolist()))
    return {k: [host[id(v)] if isinstance(v, torch.Tensor) else float(v) for v in vals]
            for k, vals in acc.items()}


class EarlyStopping:
    """Min-mode early stopping (reference
    ``EarlyStopping(monitor='val_gen_loss_recon', patience=10)``)."""

    def __init__(self, monitor: str, patience: int = 10, mode: str = "min"):
        self.monitor = monitor
        self.patience = patience
        self.mode = mode
        self.best: Optional[float] = None
        self.count = 0

    def update(self, metrics: Dict[str, float]) -> bool:
        """Returns True when training should stop."""
        value = metrics.get(self.monitor)
        if value is None:
            return False
        value = float(value)
        improved = self.best is None or (
            (value < self.best) if self.mode == "min" else (value > self.best))
        if improved:
            self.best = value
            self.count = 0
        else:
            self.count += 1
        return self.count >= self.patience
