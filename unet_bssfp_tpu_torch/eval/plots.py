"""Reporting plots (counterpart of ``unet_bssfp_tpu/eval/plots.py``, the
``src/plot_metrics_errors.py`` surface), host work on pandas and matplotlib
(Agg).

The same artifacts as the reference (``src/plot_metrics_errors.py:10-144``)
and the JAX package, from the CSVs the port writes in the JAX format
(``eval/evaluate.py``'s ``relative_errors.csv`` with its ``modality``
column, ``test_metrics.csv``): ``test_loss.pdf``/``test_psnr.pdf``,
``sample_stats.csv`` + ``stats.pdf`` with the per-(roi, modality) statistics,
the diagonal/off-diagonal tensor error bars and the per-scalar error bars.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_nn_metrics(
    log_dirs: List[str], out_dir: str = ".", modalities: Optional[Dict[str, str]] = None
):
    """Collect ``test_metrics.csv`` from run dirs and bar-chart test loss and
    PSNR per modality (reference ``plot_nn_metrics``,
    ``src/plot_metrics_errors.py:10-44``)."""
    import pandas as pd

    plt = _plt()
    rows = []
    for d in log_dirs:
        for root, _, files in os.walk(d):
            for fn in files:
                if fn == "test_metrics.csv":
                    rows.append(pd.read_csv(os.path.join(root, fn)))
    if not rows:
        return None
    df = pd.concat(rows, ignore_index=True)

    os.makedirs(out_dir, exist_ok=True)
    loss_cols = [c for c in df.columns if "loss" in c.lower()]
    if loss_cols:
        ax = df.set_index("modality")[loss_cols].plot.bar(stacked=True)
        ax.set_ylabel("test loss")
        ax.figure.tight_layout()
        ax.figure.savefig(os.path.join(out_dir, "test_loss.pdf"))
        plt.close(ax.figure)

    psnr_cols = [c for c in df.columns if "PSNR" in c]
    if psnr_cols:
        ax = df.set_index("modality")[psnr_cols].plot.bar()
        ax.set_ylabel("PSNR (dB)")
        ax.figure.tight_layout()
        ax.figure.savefig(os.path.join(out_dir, "test_psnr.pdf"))
        plt.close(ax.figure)
    return df


def plot_rel_errors(
    rel_errors_csv: str, out_dir: str = ".", out_csv: str = "sample_stats.csv"
):
    """Groupby (roi, modality) median/quartiles/mean/std per column →
    ``sample_stats.csv`` + ``stats.pdf`` (reference ``plot_rel_errors``,
    ``src/plot_metrics_errors.py:47-86``)."""
    import pandas as pd

    plt = _plt()
    df = pd.read_csv(rel_errors_csv)
    value_cols = [
        c for c in df.columns
        if c not in ("modality", "pred_id", "sub", "ses", "roi")
    ]
    stats = df.groupby(["roi", "modality"])[value_cols].agg(
        ["median", lambda s: s.quantile(0.25), lambda s: s.quantile(0.75),
         "mean", "std"]
    )
    stats.columns = [
        f"{col}_{name if not name.startswith('<lambda') else ('q25' if i % 5 == 1 else 'q75')}"
        for i, (col, name) in enumerate(stats.columns)
    ]
    os.makedirs(out_dir, exist_ok=True)
    stats.to_csv(os.path.join(out_dir, out_csv))

    medians = df.groupby(["roi", "modality"])[value_cols].median()
    ax = medians.plot.bar(figsize=(12, 6), logy=True)
    ax.set_ylabel("median relative error")
    ax.figure.tight_layout()
    ax.figure.savefig(os.path.join(out_dir, "stats.pdf"))
    plt.close(ax.figure)
    return stats


def plot_stacked_bar_tensors(rel_errors_csv: str, out_dir: str = "."):
    """Diagonal vs off-diagonal median relative error (%) per roi/modality
    (reference ``plot_stacked_bar_tensors``,
    ``src/plot_metrics_errors.py:88-115``)."""
    import pandas as pd

    plt = _plt()
    df = pd.read_csv(rel_errors_csv)
    diag = ["dxx", "dyy", "dzz"]
    off = ["dxy", "dxz", "dyz"]
    present_diag = [c for c in diag if c in df.columns]
    present_off = [c for c in off if c in df.columns]
    med = df.groupby(["roi", "modality"])[present_diag + present_off].median()
    os.makedirs(out_dir, exist_ok=True)

    if present_diag:
        ax = (med[present_diag] * 100).plot.bar(figsize=(10, 5))
        ax.set_ylabel("median rel. error (%)")
        ax.set_title("diagonal tensor elements")
        ax.figure.tight_layout()
        ax.figure.savefig(os.path.join(out_dir, "diag_tensor_errs.pdf"))
        plt.close(ax.figure)
    if present_off:
        ax = (med[present_off] * 100).plot.bar(figsize=(10, 5), logy=True)
        ax.set_ylabel("median rel. error (%)")
        ax.set_title("off-diagonal tensor elements")
        ax.figure.tight_layout()
        ax.figure.savefig(os.path.join(out_dir, "offdiag_tensor_errs.pdf"))
        plt.close(ax.figure)
    return med


def plot_stacked_bar_scalars(rel_errors_csv: str, out_dir: str = "."):
    """Per-scalar bars: % for diffusivities/FA, degrees for angles
    (reference ``plot_stacked_bar_scalars``,
    ``src/plot_metrics_errors.py:118-144``)."""
    import pandas as pd

    plt = _plt()
    df = pd.read_csv(rel_errors_csv)
    os.makedirs(out_dir, exist_ok=True)
    outputs = {}
    for scalar in ("fa", "md", "ad", "rd", "azimuth", "inclination"):
        if scalar not in df.columns:
            continue
        med = df.groupby(["roi", "modality"])[scalar].median().unstack()
        scale = 1.0 if scalar in ("azimuth", "inclination") else 100.0
        unit = "deg" if scale == 1.0 else "%"
        ax = (med * scale).plot.bar(figsize=(8, 4))
        ax.set_ylabel(f"median error ({unit})")
        ax.set_title(scalar)
        ax.figure.tight_layout()
        path = os.path.join(out_dir, f"{scalar}_errs.pdf")
        ax.figure.savefig(path)
        plt.close(ax.figure)
        outputs[scalar] = path
    return outputs
