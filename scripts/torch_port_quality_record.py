#!/usr/bin/env python3
"""The saturated quality run and its judged artifact, through the port
(counterpart of ``scripts/quality_record.py``).

One end-to-end pass on the linked synthetic fixture:

1. Train pc-bSSFP -> DT (the GAN, L1 + BCE) with the reference's early
   stop (monitor ``val_gen_loss_recon``, patience 10) until it triggers or
   ``--max-epochs`` runs out, logging the augmented val pass and a clean
   one each epoch (``TrainConfig.log_clean_val``).
2. Append the run to ``CONVERGENCE_TORCH.json`` (``saturated``: the early
   stop fired before the budget ran out).
3. Push the best checkpoint through the judged-artifact chain: test
   inference, scalar maps, difference maps, the probseg-weighted ROI table
   ``relative_errors.csv``, and the four report plots where matplotlib is
   installed (else a line says they did not run; the CSVs are written).
4. Append the summary (per-ROI median relative errors, the <= 10 % diagonal
   band verdict, the test metrics) to ``QUALITY_TORCH.json`` and keep the
   CSVs in ``quality_torch/``.

The records are the port's own; the JAX package's ``CONVERGENCE.json``,
``QUALITY.json`` and ``quality/`` are never written. The fixture's DT lives
natively in [0, 1], so the headline table is taken in fixture-native space
(identity de-normalisation); a second table through
``constants/rescale_args_dwi.txt`` exercises the full chain
(``denorm_per_roi_median_rel_err``), except under ``--smoke``.

Runs on ``cuda`` unless ``--device cpu`` is given; without a card and
without ``--device cpu`` it raises.

  python scripts/torch_port_quality_record.py --max-epochs 120
  python scripts/torch_port_quality_record.py --smoke --max-epochs 2 --device cpu
  # restarted from its last whole checkpoint when it stalls or crashes:
  python -m unet_bssfp_tpu_torch.utils.watchdog --stall-seconds 900 --restart-on-crash \\
      --heartbeat $TMPDIR/torch_port_quality_run/logs -- \\
      python scripts/torch_port_quality_record.py --resume auto
"""

from __future__ import annotations

import argparse
import csv
import datetime
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import zipfile
from typing import Dict, List, Optional

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CONVERGENCE_RECORD = os.path.join(REPO, "CONVERGENCE_TORCH.json")
QUALITY_RECORD = os.path.join(REPO, "QUALITY_TORCH.json")
QUALITY_DIR = os.path.join(REPO, "quality_torch")
RESCALE_ARGS = os.path.join(REPO, "constants", "rescale_args_dwi.txt")
SMOKE_VOLUME, FULL_VOLUME = (24, 32, 32), (96, 128, 128)
DIAG, OFFDIAG = ("dxx", "dyy", "dzz"), ("dxy", "dxz", "dyz")
#: The table's key columns; every other column is a relative error.
TABLE_KEYS = ("modality", "pred_id", "roi", "sub", "ses")
#: The judged summary's keys, as the JAX script writes them.
SUMMARY_KEYS = (
    "date", "git", "checkpoint", "modality", "smoke", "task", "space", "test_metrics",
    "per_roi_median_rel_err", "diag_median_rel_err", "diag_band_le_10pct",
    "offdiag_median_rel_err", "offdiag_median_rel_err_floored",
    "rd_median_rel_err_floored", "denorm_per_roi_median_rel_err", "artifacts")


#: The environment variable that names the revision where the checkout has
#: no ``.git`` (a ``git archive`` copy): ``UNET_BSSFP_GIT_REV=$(git rev-parse
#: --short HEAD)``.
GIT_REV_ENV = "UNET_BSSFP_GIT_REV"


def git_rev() -> str:
    """The revision a record names: ``$UNET_BSSFP_GIT_REV``, else ``git
    rev-parse --short HEAD``, else ``"unknown"``."""
    if os.environ.get(GIT_REV_ENV):
        return os.environ[GIT_REV_ENV]
    try:
        return subprocess.run(["git", "rev-parse", "--short", "HEAD"], cwd=REPO,
                              capture_output=True, text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"


def repo_path(path: str) -> str:
    """``path`` relative to the repository where it lies inside it (a
    record names no machine's directories), else as given."""
    rel = os.path.relpath(os.path.abspath(path), REPO)
    return path if rel.startswith("..") else rel


def device_label(device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them (its line for the
    device's index), or the device's type off the card."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        lines = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
        return lines[index].strip()
    except Exception:
        return f"{torch.cuda.get_device_name(index)}, power limit not read"


def append_record(path: str, entries: List[dict], indent: int = 2) -> int:
    """Append ``entries`` to the JSON list at ``path``; returns its length."""
    history = []
    if os.path.exists(path):
        with open(path) as f:
            history = json.load(f)
    history += entries
    with open(path, "w") as f:
        json.dump(history, f, indent=indent)
        f.write("\n")
    return len(history)


def cached_fixture(cache: str, subjects: int, volume_shape, seed: int,
                   link_tag_offset: int = 0) -> str:
    """The linked fixture's tree under ``cache`` (written once, marked
    ``.complete``); returns its BIDS root."""
    from unet_bssfp_tpu_torch.data.synthetic import make_synthetic_bids

    marker = os.path.join(cache, ".complete")
    bids = os.path.join(cache, "bids")
    if os.path.exists(marker):
        return bids
    shutil.rmtree(bids, ignore_errors=True)
    make_synthetic_bids(bids, subjects=tuple(f"{i:02d}" for i in range(1, subjects + 1)),
                        sessions=("1",), volume_shape=volume_shape, seed=seed, linked=True,
                        link_tag_offset=link_tag_offset)
    with open(marker, "w") as f:
        f.write("ok\n")
    return bids


def fixture_cache(smoke: bool, subjects: int, link_tag_offset: int = 0) -> str:
    """The port's default cache of a linked cohort (a name the JAX scripts'
    caches do not use, so neither package reads the other's files)."""
    suffix = f"_off{link_tag_offset}" if link_tag_offset else ""
    return os.path.join(tempfile.gettempdir(),
                        f"torch_port_convbench_{'smoke' if smoke else 'full'}"
                        f"_s{subjects}_linked{suffix}")


def build_config(args, bids):
    from unet_bssfp_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig

    if args.smoke:
        vol, patch, batch = SMOKE_VOLUME, 16, 4
        features, disc_features, dtype = (4, 8, 8, 16, 16, 4), (8, 8, 16), "float32"
    else:
        vol, patch, batch = FULL_VOLUME, 64, 8
        features = (32, 64, 128, 256, 512, 32)
        disc_features, dtype = (32, 64, 128, 256, 512), "bfloat16"
    return Config(
        data=DataConfig(data_dir=bids, batch_size=batch, patch_size=patch,
                        samples_per_vol=args.samples_per_vol, volume_shape=vol,
                        val_split=0.2, test_split=0.2, cache_volumes=True),
        model=ModelConfig(features=features, disc_features=disc_features, compute_dtype=dtype),
        train=TrainConfig(log_dir=os.path.join(args.workdir, "logs"),
                          checkpoint_dir=os.path.join(args.workdir, "ckpts"),
                          max_epochs=args.max_epochs,
                          with_perceptual=False,  # the benched L1 + BCE objective
                          log_clean_val=True, seed=42))


def make_fixture(args) -> str:
    """The 12-subject linked fixture (6 with ``--smoke``), seed 0, cached
    under ``CONVBENCH_DATA`` or the port's default."""
    subjects = 6 if args.smoke else 12
    cache = os.environ.get("CONVBENCH_DATA", fixture_cache(args.smoke, subjects))
    return cached_fixture(cache, subjects, SMOKE_VOLUME if args.smoke else FULL_VOLUME, seed=0)


def train(args, cfg, bids):
    """``Trainer.fit`` from a fresh state (or ``--resume``'s step). Returns
    the data module, the best checkpoint, the run's ``metrics.csv`` and its
    rows, the wall seconds and the device's label."""
    import time

    from unet_bssfp_tpu_torch.data.datamodule import DoveDataModule
    from unet_bssfp_tpu_torch.train.checkpoint import load_checkpoint
    from unet_bssfp_tpu_torch.train.loop import Trainer

    data = DoveDataModule(bids, config=cfg.data)
    trainer = Trainer(cfg, args.modality, device=args.device)
    state = None
    if args.resume:
        # A crashed run's last whole step: both models, both optimizers,
        # the BatchNorm buffers and the dropout generator. The early-stop
        # count starts afresh (it can only lengthen the run); the entry
        # carries resumed_from.
        state = load_checkpoint(args.resume, trainer.init_state())
        print(f"resumed state from {args.resume}")
    t0 = time.perf_counter()
    state, best_ckpt = trainer.fit(data, state=state, max_epochs=args.max_epochs)
    if trainer.device.type == "cuda":
        import torch

        torch.cuda.synchronize(trainer.device)
    wall = time.perf_counter() - t0
    trainer.logger.finish()
    metrics_csv = os.path.join(trainer.logger.log_dir, "metrics.csv")
    with open(metrics_csv) as f:
        rows = list(csv.DictReader(f))
    return data, best_ckpt, metrics_csv, rows, wall, device_label(trainer.device)


def convergence_entry(args, rows, wall, device: str) -> dict:
    def f(row, key):
        return round(float(row[key]), 4) if key in row and row[key] else None

    new_epochs = len(rows)
    if args.prior_metrics:
        with open(args.prior_metrics) as fh:
            rows = list(csv.DictReader(fh)) + rows
    first, last = rows[0], rows[-1]
    best_psnr = max(float(r["val_metric_PSNR"]) for r in rows)
    entry = {
        "date": datetime.datetime.now().isoformat(timespec="seconds"),
        "git": git_rev(),
        "device": device,
        "smoke": args.smoke,
        "full_objective": False,
        "linked": True,
        "samples_per_vol": args.samples_per_vol,
        "epochs": len(rows),
        "saturated": new_epochs < args.max_epochs,
        "wall_seconds": round(wall, 1),
        "train_L1_first": f(first, "train_gen_loss_recon_L1"),
        "train_L1_last": f(last, "train_gen_loss_recon_L1"),
        "val_psnr_last": f(last, "val_metric_PSNR"),
        "val_psnr_best": round(best_psnr, 3),
        "val_ssim_last": f(last, "val_metric_SSIM"),
        "val_clean_psnr_last": f(last, "val_clean_metric_PSNR"),
        "val_clean_ssim_last": f(last, "val_clean_metric_SSIM"),
    }
    if entry["val_clean_psnr_last"] is not None:
        entry["clean_minus_aug_psnr"] = round(
            entry["val_clean_psnr_last"] - entry["val_psnr_last"], 3)
    if args.resume:
        entry["resumed_from"] = repo_path(args.resume)
    return entry


def _median(values) -> float:
    """The median of the values that are not NaN (NaN where none is), as
    pandas' ``median`` skips missing values."""
    kept = [v for v in values if not math.isnan(v)]
    return float(np.median(np.asarray(kept, np.float64))) if kept else math.nan


def roi_medians(rows: List[Dict[str, object]]) -> Dict[str, Dict[str, float]]:
    """``table.groupby("roi").median(numeric_only=True)`` over the error
    table's rows (``eval.evaluate.calc_error_table``): per ROI, in sorted
    order, the median of each relative-error column over the table's files."""
    cols = [c for c in (rows[0] if rows else {}) if c not in TABLE_KEYS]
    by_roi: Dict[str, List[Dict[str, object]]] = {}
    for row in rows:
        by_roi.setdefault(str(row["roi"]), []).append(row)
    return {roi: {c: _median(float(r[c]) for r in group) for c in cols}
            for roi, group in sorted(by_roi.items())}


def table_summary(rows: List[Dict[str, object]]) -> dict:
    """The judged summary of an error table's rows, without pandas: the
    per-ROI medians (rounded to 4 places), the median of the diagonal
    elements' per-ROI medians and its <= 10 % verdict, the off-diagonal
    median, and the denominator-floored off-diagonal and RD medians where
    the table has those columns (RD and the off-diagonals cross zero
    voxel-wise, so their raw relative error is unbounded by construction)."""
    med = roi_medians(rows)

    def over(cols) -> float:
        return float(np.median(np.asarray([[m[c] for c in cols] for m in med.values()],
                                          np.float64)))

    present = set(next(iter(med.values()), {}))
    diag = over(DIAG)
    floored_off = [f"{c}_floored" for c in OFFDIAG]
    return {
        "per_roi_median_rel_err": {roi: {c: round(v, 4) for c, v in m.items()}
                                   for roi, m in med.items()},
        "diag_median_rel_err": round(diag, 4),
        "diag_band_le_10pct": bool(diag <= 0.10),
        "offdiag_median_rel_err": round(over(OFFDIAG), 4),
        "offdiag_median_rel_err_floored": (round(over(floored_off), 4)
                                           if set(floored_off) <= present else None),
        "rd_median_rel_err_floored": (round(over(("rd_floored",)), 4)
                                      if "rd_floored" in present else None),
    }


def write_plots(rel_csv: str, pred_base: str, quality_dir: str) -> bool:
    """The four report plots (reference ``src/plot_metrics_errors.py``);
    False, with a line that says so, where pandas or matplotlib is missing."""
    try:
        import matplotlib  # noqa: F401
        import pandas  # noqa: F401
    except ImportError as e:
        print(f"plots not written: {e.name} is not installed (the CSVs are)")
        return False
    from unet_bssfp_tpu_torch.eval.plots import (
        plot_nn_metrics,
        plot_rel_errors,
        plot_stacked_bar_scalars,
        plot_stacked_bar_tensors,
    )

    plot_rel_errors(rel_csv, quality_dir)
    plot_stacked_bar_tensors(rel_csv, quality_dir)
    plot_stacked_bar_scalars(rel_csv, quality_dir)
    plot_nn_metrics([pred_base], quality_dir)  # eval_model's test_metrics.csv
    return True


def judged_artifact(args, cfg, data, best_ckpt, quality_dir, denorm: Optional[bool] = None):
    """The full evaluation chain from the trained checkpoint (reference
    ``src/eval.py:261-317``): ``eval_model`` over the test cohort, the
    scalar and difference maps, the ROI table, the plots, and the summary.
    ``denorm`` (default: not ``--smoke``): also the table through the real
    rescale constants."""
    from unet_bssfp_tpu_torch.eval.evaluate import (
        calc_error_table,
        eval_dwi_tensors,
        eval_model,
    )

    denorm = (not args.smoke) if denorm is None else denorm
    device = getattr(args, "device", None)
    os.makedirs(quality_dir, exist_ok=True)
    pred_base = os.path.join(args.workdir, "preds")
    pred_dir = os.path.join(pred_base, args.modality)
    if args.skip_eval:
        # a crashed chain's eval_model output (predictions and its
        # test_metrics.csv) instead of test inference again
        with open(os.path.join(pred_dir, "test_metrics.csv")) as fh:
            row = next(csv.DictReader(fh))
        test_metrics = {k: float(v) for k, v in row.items() if k != "modality"}
    else:
        test_metrics = eval_model(data, best_ckpt, args.modality, pred_dir, config=cfg,
                                  device=device)
    # the headline: fixture-native space (identity de-normalisation)
    eval_dwi_tensors(pred_dir, None, device=device)
    rel_csv = os.path.join(quality_dir, "relative_errors.csv")
    table = calc_error_table(pred_base, cfg.data.data_dir, rel_csv, device=device)
    plotted = write_plots(rel_csv, pred_base, quality_dir)

    denorm_summary = None
    if denorm:
        # the real constants' inversion (reference invert_dwi_tensor_norm,
        # src/eval.py:39-70) end to end, on a copy of the predictions
        denorm_base = os.path.join(args.workdir, "preds_denorm")
        denorm_dir = os.path.join(denorm_base, args.modality)
        shutil.rmtree(denorm_dir, ignore_errors=True)
        shutil.copytree(pred_dir, denorm_dir, ignore=shutil.ignore_patterns(
            "*_denorm*", "*_fa*", "*_md*", "*_ad*", "*_rd*", "*_azimuth*",
            "*_inclination*", "*_rgb*", "diff-*", "dfloor-*"))
        eval_dwi_tensors(denorm_dir, RESCALE_ARGS, device=device)
        denorm_csv = os.path.join(quality_dir, "relative_errors_denorm.csv")
        denorm_table = calc_error_table(denorm_base, cfg.data.data_dir, denorm_csv,
                                        device=device)
        if denorm_table:
            denorm_summary = {roi: {c: round(v, 4) for c, v in m.items()}
                              for roi, m in roi_medians(denorm_table).items()}

    stats_csv = os.path.join(quality_dir, "sample_stats.csv")
    return {
        "date": datetime.datetime.now().isoformat(timespec="seconds"),
        "git": git_rev(),
        "checkpoint": repo_path(best_ckpt),
        "modality": args.modality,
        "smoke": bool(args.smoke),
        "task": (f"linked synthetic fixture ({6 if args.smoke else 12} subjects, "
                 f"{args.modality} -> DT)"),
        "space": "fixture-native (identity denorm; see torch_port_quality_record.py)",
        "test_metrics": {k: round(float(v), 4) for k, v in test_metrics.items()},
        **table_summary(table),
        "denorm_per_roi_median_rel_err": denorm_summary,
        "artifacts": {
            "relative_errors_csv": os.path.relpath(rel_csv, REPO),
            "sample_stats_csv": (os.path.relpath(stats_csv, REPO)
                                 if plotted and os.path.exists(stats_csv) else None),
        },
    }


def step_is_whole(step_dir: str) -> bool:
    """A step directory whose ``state.pt`` is a whole file: present and a
    complete zip archive (``torch.save``'s format; ``atomic_save`` renames
    a finished file into place, so a cut save leaves only its temporary)."""
    from unet_bssfp_tpu_torch.train.checkpoint import STATE_FILE

    path = os.path.join(step_dir, STATE_FILE)
    return os.path.isfile(path) and zipfile.is_zipfile(path)


def resolve_auto_resume(args) -> None:
    """``--resume auto``: the newest whole checkpoint (the newest run with
    one, its largest step) and every prior ``metrics.csv`` segment under
    ``--workdir``, spliced into one file for the entry, so the command can be
    run again as it stands under the watchdog. A fresh run where there is
    no whole checkpoint yet."""
    args.resume = None
    ckpt_root = os.path.join(args.workdir, "ckpts")
    if os.path.isdir(ckpt_root):
        for run in sorted(os.listdir(ckpt_root), reverse=True):
            run_dir = os.path.join(ckpt_root, run)
            epochs = ([int(d) for d in os.listdir(run_dir)
                       if d.isdigit() and step_is_whole(os.path.join(run_dir, d))]
                      if os.path.isdir(run_dir) else [])
            if epochs:
                args.resume = os.path.join(run_dir, str(max(epochs)))
                break
    log_root = os.path.join(args.workdir, "logs")
    segments = sorted(
        p for p in (os.path.join(log_root, run, "metrics.csv")
                    for run in (os.listdir(log_root) if os.path.isdir(log_root) else []))
        if os.path.exists(p) and os.path.getsize(p) > 0)
    if args.resume and segments:
        combined = os.path.join(args.workdir, "prior_metrics_combined.csv")
        with open(combined, "w") as out:
            for i, seg in enumerate(segments):
                with open(seg) as fh:
                    if i > 0:
                        next(fh, None)  # the repeated header
                    out.write(fh.read())
        args.prior_metrics = combined
    print(f"auto-resume: checkpoint={args.resume} "
          f"prior_segments={len(segments) if args.resume else 0}")


def device_startup_probe(grace_s: float, timeout_s: float, device=None) -> None:
    """One small op on the device under a hard ``os._exit(75)`` timer, so a
    device that does not answer ends the attempt quickly and the watchdog
    (``--restart-on-crash``) tries again. ``UNET_BSSFP_STARTUP_TIMEOUT``
    (seconds) overrides ``timeout_s``. ``grace_s`` idles before the first
    device op (0 by default here: a local card needs no quiet time; the
    JAX script waits for a remote device server to clear a dead client).
    Without a card, a device other than ``cpu`` raises."""
    import threading
    import time

    env = os.environ.get("UNET_BSSFP_STARTUP_TIMEOUT")
    if env:
        timeout_s = float(env)
    if grace_s > 0:
        print(f"startup: {grace_s:.0f}s grace before first device op", flush=True)
        time.sleep(grace_s)
    timer = threading.Timer(timeout_s, lambda: (
        print(f"startup: device probe exceeded {timeout_s:.0f}s — exiting for watchdog "
              "retry", flush=True),
        os._exit(75)))
    timer.daemon = True
    timer.start()
    try:
        import torch

        from unet_bssfp_tpu_torch.train.state import resolve_device

        dev = resolve_device(device)
        t0 = time.monotonic()
        x = torch.ones((128, 128), device=dev)
        out = float((x * x).sum())
    finally:
        timer.cancel()
    print(f"startup: device probe ok ({out:.0f}) on {device_label(dev)} in "
          f"{time.monotonic() - t0:.1f}s", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--max-epochs", type=int, default=120)
    ap.add_argument("--samples-per-vol", type=int, default=32)
    ap.add_argument("--modality", default="pc-bssfp")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--workdir", default=None,
                    help="run directory (checkpoints, logs, predictions); default "
                         "$TMPDIR/torch_port_quality_run[_smoke]")
    ap.add_argument("--skip-train", default=None, metavar="CKPT",
                    help="skip training; run the judged-artifact chain on this checkpoint")
    ap.add_argument("--skip-eval", action="store_true",
                    help="with --skip-train: reuse the predictions and test_metrics.csv "
                         "in the workdir instead of test inference again")
    ap.add_argument("--resume", default=None, metavar="CKPT",
                    help="resume training from this step directory; 'auto' finds the "
                         "newest whole checkpoint and the prior metrics under --workdir "
                         "(a fresh run when there is none), so the command can run again "
                         "as it stands under python -m unet_bssfp_tpu_torch.utils.watchdog")
    ap.add_argument("--prior-metrics", default=None, metavar="CSV",
                    help="with --resume: the crashed run's metrics.csv, spliced before "
                         "the new rows in the entry")
    ap.add_argument("--startup-grace", type=float, default=0.0,
                    help="seconds to idle before the first device op")
    ap.add_argument("--startup-probe-timeout", type=float, default=150.0,
                    help="exit(75) when the first device op takes longer than this "
                         "(0 disables the probe)")
    ap.add_argument("--device", default=None, help="default cuda; cpu to run on the CPU")
    args = ap.parse_args(argv)
    if args.workdir is None:
        args.workdir = os.path.join(
            tempfile.gettempdir(),
            "torch_port_quality_run_smoke" if args.smoke else "torch_port_quality_run")
    os.makedirs(args.workdir, exist_ok=True)
    if args.resume == "auto":
        resolve_auto_resume(args)
    if args.startup_probe_timeout > 0:
        device_startup_probe(args.startup_grace, args.startup_probe_timeout, args.device)
    else:
        from unet_bssfp_tpu_torch.train.state import resolve_device

        resolve_device(args.device)  # no card and no --device cpu: raise now
    os.makedirs(QUALITY_DIR, exist_ok=True)
    bids = make_fixture(args)
    cfg = build_config(args, bids)

    if args.skip_train:
        from unet_bssfp_tpu_torch.data.datamodule import DoveDataModule

        data = DoveDataModule(bids, config=cfg.data)
        data.setup()
        best_ckpt = args.skip_train
    else:
        data, best_ckpt, metrics_csv, rows, wall, device = train(args, cfg, bids)
        dst = os.path.join(QUALITY_DIR, "metrics.csv")
        if args.prior_metrics:
            # the crashed segments' rows before the resumed ones: the kept
            # curve is the whole trajectory
            with open(dst, "w") as out, open(args.prior_metrics) as a, \
                    open(metrics_csv) as b:
                out.write(a.read())
                next(b)  # the repeated header
                out.write(b.read())
        else:
            shutil.copy(metrics_csv, dst)
        entry = convergence_entry(args, rows, wall, device)
        print(json.dumps(entry, indent=2))
        append_record(CONVERGENCE_RECORD, [entry])
        print(f"recorded to {CONVERGENCE_RECORD}")

    print(f"judged-artifact chain from {best_ckpt}")
    summary = judged_artifact(args, cfg, data, best_ckpt, QUALITY_DIR)
    append_record(QUALITY_RECORD, [summary])
    print(json.dumps(summary, indent=2))
    print(f"recorded to {QUALITY_RECORD}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
