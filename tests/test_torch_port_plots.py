"""The port's report plots (``eval/plots.py`` and the ``plot_metrics_errors``
CLI) against the JAX package's on the same seeded ``relative_errors.csv``
and ``test_metrics.csv`` files: the same file names, ``sample_stats.csv``
frames equal, and equal returned frames. Host work only."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from unet_bssfp_tpu.eval import plots as jax_plots
from unet_bssfp_tpu_torch.eval import plots
from unet_bssfp_tpu_torch.plot_metrics_errors import main as plots_main

REPO = Path(__file__).resolve().parents[1]
TENSOR = ("dxx", "dxy", "dxz", "dyy", "dyz", "dzz")
SCALARS = ("md", "fa", "ad", "rd", "azimuth", "inclination")


@pytest.fixture(scope="module")
def csvs(tmp_path_factory):
    """A ``relative_errors.csv`` in the format ``eval/evaluate.py`` writes
    (2 modalities × 3 predictions × 3 ROIs, floored twins) and two runs'
    ``test_metrics.csv`` under a log directory, from a seed."""
    root = tmp_path_factory.mktemp("plots")
    rng = np.random.default_rng(11)
    rows = []
    for modality in ("pc-bssfp", "t1w"):
        for pred_id in range(3):
            for roi in ("CSF", "GM", "WM"):
                row = {"modality": modality, "pred_id": pred_id, "roi": roi,
                       "sub": f"0{pred_id + 1}", "ses": "1"}
                for c in TENSOR + SCALARS:
                    row[c] = float(rng.uniform(1.0, 30.0) if c in ("azimuth", "inclination")
                                   else rng.lognormal(-2.0, 0.7))
                for c in TENSOR + SCALARS[:4]:
                    row[f"{c}_floored"] = float(rng.lognormal(-2.5, 0.5))
                rows.append(row)
    rel = root / "relative_errors.csv"
    pd.DataFrame(rows).to_csv(rel, index=False)
    logs = root / "logs"
    for modality in ("pc-bssfp", "t1w"):
        run = logs / f"{modality}-20260101-000000"
        run.mkdir(parents=True)
        pd.DataFrame([{"modality": modality, "test_loss": rng.uniform(0.5, 2.0),
                       "test_gen_loss_recon": rng.uniform(0.1, 0.5),
                       "test_metric_PSNR": rng.uniform(20.0, 30.0),
                       "test_metric_SSIM": rng.uniform(0.5, 0.9)}]).to_csv(
            run / "test_metrics.csv", index=False)
    return dict(root=root, rel=str(rel), logs=str(logs))


def _both(csvs, name, *args):
    out = {}
    for key, mod in (("jax", jax_plots), ("port", plots)):
        d = csvs["root"] / key / name
        out[key] = (getattr(mod, name)(*args, out_dir=str(d)), sorted(os.listdir(d)))
    return out


def test_plot_nn_metrics_as_jax(csvs):
    out = _both(csvs, "plot_nn_metrics", [csvs["logs"]])
    (ref, ref_files), (got, got_files) = out["jax"], out["port"]
    assert got_files == ref_files == ["test_loss.pdf", "test_psnr.pdf"]
    pd.testing.assert_frame_equal(got, ref)
    assert plots.plot_nn_metrics([str(csvs["root"] / "nothing")]) is None


def test_plot_rel_errors_as_jax(csvs):
    out = _both(csvs, "plot_rel_errors", csvs["rel"])
    (ref, ref_files), (got, got_files) = out["jax"], out["port"]
    assert got_files == ref_files == ["sample_stats.csv", "stats.pdf"]
    pd.testing.assert_frame_equal(got, ref)
    read = {k: pd.read_csv(csvs["root"] / k / "plot_rel_errors" / "sample_stats.csv")
            for k in ("jax", "port")}
    pd.testing.assert_frame_equal(read["port"], read["jax"])
    assert "fa_q25" in read["port"].columns and len(read["port"]) == 6


def test_stacked_bars_as_jax(csvs):
    out = _both(csvs, "plot_stacked_bar_tensors", csvs["rel"])
    (ref, ref_files), (got, got_files) = out["jax"], out["port"]
    assert got_files == ref_files == ["diag_tensor_errs.pdf", "offdiag_tensor_errs.pdf"]
    pd.testing.assert_frame_equal(got, ref)
    out = _both(csvs, "plot_stacked_bar_scalars", csvs["rel"])
    (ref, ref_files), (got, got_files) = out["jax"], out["port"]
    assert got_files == ref_files == sorted(f"{s}_errs.pdf" for s in SCALARS)
    assert {k: os.path.basename(v) for k, v in got.items()} == {
        k: os.path.basename(v) for k, v in ref.items()}


def test_cli_writes_every_artifact(csvs, tmp_path):
    """The CLI in a subprocess, and in-process, writes the files the four
    functions write."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    subprocess.run([sys.executable, "-m", "unet_bssfp_tpu_torch.plot_metrics_errors",
                    csvs["rel"], "--log-dirs", csvs["logs"], "--out-dir", str(tmp_path / "cli")],
                   check=True, env=env, timeout=300, cwd=str(REPO))
    want = sorted(["test_loss.pdf", "test_psnr.pdf", "sample_stats.csv", "stats.pdf",
                   "diag_tensor_errs.pdf", "offdiag_tensor_errs.pdf"]
                  + [f"{s}_errs.pdf" for s in SCALARS])
    assert sorted(os.listdir(tmp_path / "cli")) == want
    plots_main([csvs["rel"], "--out-dir", str(tmp_path / "inproc")])
    assert sorted(os.listdir(tmp_path / "inproc")) == [
        f for f in want if not f.startswith("test_")]
    pd.testing.assert_frame_equal(pd.read_csv(tmp_path / "cli" / "sample_stats.csv"),
                                  pd.read_csv(tmp_path / "inproc" / "sample_stats.csv"))
