"""The port's quality scripts (``scripts/torch_port_{quality_record,
oracle_ceiling,multistage_bench}.py``) against the JAX package's scripts
(``scripts/{quality_record,oracle_ceiling,multistage_bench}.py``) and its
modules on the CPU, at small sizes.

- The oracle map against the JAX script's (tags 1 and 11: atol 1e-6, f32
  products on both sides, tanh and the 24-term sums rounded differently)
  and against the fixture's own numpy ``_linked_map`` on written trees
  (atol 1e-6); ``measure`` on one batch fed to both (each mean rounded as
  the scripts round it: PSNR and SSIM within 2e-4, L1 within 2e-5).
- The two-cohort fixture (seed 1, ``link_tag_offset`` 10) array for array
  against JAX's at 16³ (exact).
- One direct-arm step on the pc-bSSFP head from JAX's weights against
  ``jax.grad`` of JAX's PRETRAIN-stage loss on the same net in float64,
  every leaf to 1e-4 of its largest entry (the multi-stage step's test).
- The pandas-free judged summary against the JAX script's pandas arithmetic
  on one table of rows (the JAX ``judged_artifact`` itself, its chain
  stubbed): rounded medians within 1e-4, the verdict equal.
- ``resolve_auto_resume`` against JAX's on the same step names and metrics
  segments, and a step whose ``state.pt`` is cut or still a temporary.
- Each script's entries have the JAX script's keys; the records go to the
  port's files; the scripts import no JAX; they raise without a card unless
  asked for the CPU; one CPU run of ``--smoke --two-cohort --no-record``.
"""

import argparse
import csv
import json
import math
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import multistage_bench as jax_msb  # noqa: E402
import oracle_ceiling as jax_oracle  # noqa: E402
import quality_record as jax_qr  # noqa: E402
from scripts import torch_port_multistage_bench as msb  # noqa: E402
from scripts import torch_port_oracle_ceiling as oracle  # noqa: E402
from scripts import torch_port_quality_record as qr  # noqa: E402
from unet_bssfp_tpu.data.synthetic import make_synthetic_bids as jax_make_synthetic_bids  # noqa: E402
from unet_bssfp_tpu.models.multi_input_unet import MultiInputUNet as JaxMultiInputUNet  # noqa: E402
from unet_bssfp_tpu.ops.losses import l1_loss as jax_l1, ssim_loss as jax_ssim_loss  # noqa: E402
from unet_bssfp_tpu_torch import weights  # noqa: E402
from unet_bssfp_tpu_torch.config import Config, ModelConfig, TrainConfig  # noqa: E402
from unet_bssfp_tpu_torch.data.nifti import load_volume  # noqa: E402
from unet_bssfp_tpu_torch.data.synthetic import _linked_map, make_synthetic_bids  # noqa: E402
from unet_bssfp_tpu_torch.eval.evaluate import BASE_COLS  # noqa: E402
from test_torch_port_multistage import FEATURES, PATCH, _jax_params  # noqa: E402

torch.set_num_threads(1)


def _nifti_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files if f.endswith(".nii.gz"))


# ---------------------------------------------------------------------------
# the oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tag", [1, 11])
def test_linked_map_matches_jax_script(tag):
    x = np.random.default_rng(tag).random((2, 8, 8, 8, 24)).astype(np.float32)
    ref = np.asarray(jax_oracle.make_linked_map_fn(6, tag=tag)(jnp.asarray(x)))
    fn = oracle.make_linked_map_fn(6, tag=tag)
    for _ in range(2):  # the weights are drawn once: a later call maps the same
        got = fn(torch.from_numpy(x)).numpy()
        assert got.dtype == np.float32 and got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("offset", [0, 10])
def test_linked_map_matches_written_fixture(tmp_path, offset):
    """The oracle of tag 1 + offset reproduces the DT the fixture wrote."""
    root = make_synthetic_bids(str(tmp_path / "b"), subjects=("01",), sessions=("1",),
                               volume_shape=(8, 12, 16), seed=3, linked=True,
                               link_tag_offset=offset)
    dwi = os.path.join(root, "derivatives/preproc-dove/sub-01/ses-1/dwi")
    pc, _ = load_volume(os.path.join(dwi, "sub-01_ses-1_desc-normflatbet_bssfp.nii.gz"))
    dt, _ = load_volume(os.path.join(dwi, "sub-01_ses-1_desc-normtensor_dwi.nii.gz"))
    got = oracle.make_linked_map_fn(6, tag=1 + offset)(torch.from_numpy(pc)).numpy()
    np.testing.assert_allclose(got, dt, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, _linked_map(pc, 6, 1 + offset), rtol=0, atol=1e-6)


class _OneBatch:
    """A data module whose val pass is one fixed batch, for either package."""

    def __init__(self, batch, to):
        self.batch, self.to = batch, to

    def val_batches(self, seed, keys, augment=True, device=None):
        assert keys == ("pc-bssfp", "dwi-tensor")
        yield {k: self.to(v) for k, v in self.batch.items()}


def test_measure_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.random((2, 16, 16, 16, 24)).astype(np.float32)
    y = np.clip(_linked_map(x, 6, 1) + 0.02 * rng.standard_normal((2, 16, 16, 16, 6)),
                0, 1).astype(np.float32)
    y_aug = (y + 0.05 * rng.standard_normal(y.shape)).astype(np.float32)
    batch = {"pc-bssfp": x, "dwi-tensor": y_aug, "dwi-tensor_orig": y}
    ref = jax_oracle.measure(_OneBatch(batch, jnp.asarray), "pc-bssfp", 2)
    got = oracle.measure(_OneBatch(batch, torch.from_numpy), "pc-bssfp", 2, device="cpu")
    assert got.keys() == ref.keys()
    for key in ref:
        assert got[key]["n_patches"] == ref[key]["n_patches"]
        for m, tol in (("psnr", 2e-4), ("ssim", 2e-4), ("l1", 2e-5)):
            assert abs(got[key][m] - ref[key][m]) <= tol, (key, m, got[key], ref[key])
    assert 20 < ref["oracle_clean"]["psnr"] < 60


# ---------------------------------------------------------------------------
# the two-cohort fixture
# ---------------------------------------------------------------------------

def test_two_cohort_fixture_matches_jax(tmp_path):
    kw = dict(subjects=("01", "02"), sessions=("1",), volume_shape=(16, 16, 16), seed=1,
              linked=True, link_tag_offset=10)
    mine = make_synthetic_bids(str(tmp_path / "port"), **kw)
    theirs = jax_make_synthetic_bids(str(tmp_path / "jax"), **kw)
    files = _nifti_files(mine)
    assert files == _nifti_files(theirs) and len(files) == 12
    for rel in files:
        a, _ = load_volume(os.path.join(mine, rel))
        b, _ = load_volume(os.path.join(theirs, rel))
        np.testing.assert_array_equal(a, b, err_msg=rel)


# ---------------------------------------------------------------------------
# the direct arm's step
# ---------------------------------------------------------------------------

def test_direct_step_matches_jax_pretrain_step():
    """The direct arm is PRETRAIN-stage semantics on the target's head:
    every leaf trains at the base lr on L1 + (1 − SSIM)."""
    modality = "pc-bssfp"
    params = _jax_params(modality, 41)
    rng = np.random.default_rng(42)
    x = rng.standard_normal((2, PATCH, PATCH, PATCH, 24)).astype(np.float32)
    f64 = lambda tree: jax.tree.map(lambda a: np.asarray(a, np.float64), tree)  # noqa: E731
    with jax.enable_x64(True):
        jnet = JaxMultiInputUNet(modality=modality, features=FEATURES, dropout=0.0,
                                 dtype=jnp.float64, use_fused=False, packed=True)
        x64 = jnp.asarray(x, jnp.float64)
        y_hat0 = np.asarray(jax.jit(lambda p: jnet.apply({"params": p}, x64, train=True))(
            f64(params)))
        # every voxel ≥ 0.05 from the prediction: no L1 sign flips
        y = (y_hat0 + np.where(rng.random(y_hat0.shape) < 0.5, -1, 1)
             * (0.05 + 0.2 * rng.random(y_hat0.shape))).astype(np.float32)
        y64 = jnp.asarray(y, jnp.float64)

        def loss_fn(p):
            y_hat = jnet.apply({"params": p}, x64, train=True)
            return jax_l1(y_hat, y64) + jax_ssim_loss(y_hat, y64)

        ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(f64(params))
        ref = {k: v.numpy() for k, v in
               weights.from_flax(jax.tree.map(np.asarray, ref_grads)).items()}

    cfg = Config(model=ModelConfig(features=FEATURES, multistage_features=FEATURES,
                                   compute_dtype="float32", dropout=0.0, packed=True),
                 train=TrainConfig(seed=42))
    state, train_step, _ = msb.direct_state(cfg, modality, "cpu",
                                            state_dict=weights.from_flax(params))
    metrics = train_step(state, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(metrics["train_loss"]), float(ref_loss), rtol=1e-5)
    named = dict(state.net.named_parameters())
    assert named.keys() == ref.keys() and all(p.requires_grad for p in named.values())
    assert [g["lr"] for g in state.opt.param_groups] == [cfg.train.lr]
    assert sum(len(g["params"]) for g in state.opt.param_groups) == len(named)
    scale = max(float(np.abs(r).max()) for r in ref.values())
    for name, p in named.items():
        if name.endswith((".conv.bias", "conv_in.bias", "conv_mid.bias", "conv_out.bias")):
            # a conv bias before InstanceNorm: true gradient 0, f32 noise
            np.testing.assert_allclose(p.grad.numpy(), ref[name], rtol=0,
                                       atol=5e-5 * scale, err_msg=name)
        else:
            np.testing.assert_allclose(p.grad.numpy(), ref[name], rtol=0,
                                       atol=1e-4 * np.abs(ref[name]).max(), err_msg=name)


# ---------------------------------------------------------------------------
# the judged summary
# ---------------------------------------------------------------------------

def _table_rows():
    """An error table's rows as ``calc_error_table`` returns them: 2
    predictions × 2 subjects × 3 ROIs, every column of the table, one
    missing cell."""
    rng = np.random.default_rng(11)
    cols = list(BASE_COLS) + [f"{c}_floored" for c in BASE_COLS]
    rows = []
    for idx in ("0", "1"):
        for sub in ("01", "02"):
            for roi in ("CSF", "GM", "WM"):
                row = {"modality": "pc-bssfp", "pred_id": idx, "roi": roi, "sub": sub,
                       "ses": "1"}
                for c in cols:
                    row[c] = float(np.float32(rng.lognormal(-2.0, 0.8)))
                rows.append(row)
    rows[3]["dyy"] = math.nan
    return rows


def _jax_frame(rows):
    df = pd.DataFrame(rows)
    values = [c for c in df.columns if c not in qr.TABLE_KEYS]
    df[values] = df[values].astype(np.float32)
    return df.set_index(["modality", "pred_id", "roi"])


def _close(got, ref, tol=1e-4):
    if isinstance(ref, dict):
        assert got.keys() == ref.keys()
        for k in ref:
            _close(got[k], ref[k], tol)
    elif isinstance(ref, float) and not isinstance(ref, bool):
        assert (math.isnan(got) and math.isnan(ref)) or abs(got - ref) <= tol, (got, ref)
    else:
        assert got == ref, (got, ref)


@pytest.mark.parametrize("smoke", [True, False])
def test_judged_artifact_matches_jax_script(tmp_path, monkeypatch, smoke):
    """Both scripts' ``judged_artifact`` on one table (their chains stubbed to
    hand it over): the same summary keys and numbers, the denormalised
    table's medians too."""
    import unet_bssfp_tpu.eval.evaluate as jax_evaluate
    import unet_bssfp_tpu.eval.plots as jax_plots
    import unet_bssfp_tpu_torch.eval.evaluate as port_evaluate

    rows = _table_rows()
    metrics = {"test_metric_PSNR": 21.5, "test_metric_SSIM": 0.75, "test_metric_L1": 0.06}
    for mod, table in ((jax_evaluate, _jax_frame(rows)), (port_evaluate, rows)):
        monkeypatch.setattr(mod, "eval_model", lambda *a, **k: dict(metrics))
        monkeypatch.setattr(mod, "eval_dwi_tensors", lambda *a, **k: None)
        monkeypatch.setattr(mod, "calc_error_table", lambda *a, _t=table, **k: _t)
    for name in ("plot_nn_metrics", "plot_rel_errors", "plot_stacked_bar_scalars",
                 "plot_stacked_bar_tensors"):
        monkeypatch.setattr(jax_plots, name, lambda *a, **k: None)
    monkeypatch.setattr(qr, "write_plots", lambda *a, **k: False)
    out = {}
    for name, mod in (("jax", jax_qr), ("port", qr)):
        work = tmp_path / name
        os.makedirs(work / "preds" / "pc-bssfp")
        args = argparse.Namespace(workdir=str(work), modality="pc-bssfp", smoke=smoke,
                                  skip_eval=False, device="cpu")
        out[name] = mod.judged_artifact(args, types.SimpleNamespace(
            data=types.SimpleNamespace(data_dir="unused")), None, "ckpt/3", str(work / "q"))
    ref, got = out["jax"], out["port"]
    assert tuple(ref) == tuple(got) == qr.SUMMARY_KEYS
    assert (ref["denorm_per_roi_median_rel_err"] is None) == smoke
    for key in qr.SUMMARY_KEYS:
        if key not in ("date", "git", "space", "artifacts"):
            _close(got[key], ref[key])
    assert got["artifacts"].keys() == ref["artifacts"].keys()
    assert got["diag_median_rel_err"] > 0.1 and got["diag_band_le_10pct"] is False
    # the summary's own numbers, unrounded, against pandas on the same rows
    med = _jax_frame(rows).groupby("roi").median(numeric_only=True)
    mine = qr.roi_medians(rows)
    assert list(mine) == list(med.index)
    for roi, m in mine.items():
        np.testing.assert_allclose(list(m.values()), med.loc[roi][list(m)].to_numpy(),
                                   rtol=1e-6, err_msg=roi)


# ---------------------------------------------------------------------------
# --resume auto
# ---------------------------------------------------------------------------

def _metrics_segment(path, epochs):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["epoch", "val_metric_PSNR"])
        for e in epochs:
            w.writerow([e, 10.0 + e])


def _resume_tree(root, port: bool, partial: bool):
    """Runs A (steps 0-2) and B (steps 0-1), two metrics segments. With
    ``partial``: B's steps 2 and 3 are cut saves, and run C holds only a
    cut one. The port's complete steps hold a whole ``state.pt``; JAX's cut
    saves are Orbax's temporaries."""
    runs = {"pc-bssfp-20260101-000000": [0, 1, 2], "pc-bssfp-20260102-000000": [0, 1]}
    for run, steps in runs.items():
        for s in steps:
            d = os.path.join(root, "ckpts", run, str(s))
            os.makedirs(d)
            if port:
                torch.save({"step": s}, os.path.join(d, "state.pt"))
    if partial:
        cut = [("pc-bssfp-20260102-000000", 2), ("pc-bssfp-20260102-000000", 3),
               ("pc-bssfp-20260103-000000", 0)]
        for i, (run, s) in enumerate(cut):
            if port:
                d = os.path.join(root, "ckpts", run, str(s))
                os.makedirs(d)
                name = "state.pt" if i == 0 else "state.pt.tmp-123"
                with open(os.path.join(d, name), "wb") as f:
                    f.write(b"PK\x03\x04 a save cut short")
            else:
                os.makedirs(os.path.join(root, "ckpts", run, f"{s}.orbax-checkpoint-tmp-7"))
    _metrics_segment(os.path.join(root, "logs", "pc-bssfp-20260101-000000", "metrics.csv"),
                     [0, 1, 2])
    _metrics_segment(os.path.join(root, "logs", "pc-bssfp-20260102-000000", "metrics.csv"),
                     [0, 1])


@pytest.mark.parametrize("partial", [False, True])
def test_resolve_auto_resume_matches_jax(tmp_path, partial):
    out = {}
    for name, mod in (("jax", jax_qr), ("port", qr)):
        root = str(tmp_path / name)
        _resume_tree(root, name == "port", partial)
        args = argparse.Namespace(workdir=root, resume="auto", prior_metrics=None)
        mod.resolve_auto_resume(args)
        with open(args.prior_metrics) as f:
            out[name] = (os.path.relpath(args.resume, root), f.read())
    assert out["port"] == out["jax"]
    assert out["port"][0] == os.path.join("ckpts", "pc-bssfp-20260102-000000", "1")
    assert out["port"][1].count("epoch") == 1 and len(out["port"][1].splitlines()) == 6


def test_resolve_auto_resume_fresh_run(tmp_path):
    args = argparse.Namespace(workdir=str(tmp_path), resume="auto", prior_metrics=None)
    _metrics_segment(str(tmp_path / "logs" / "r" / "metrics.csv"), [0])
    qr.resolve_auto_resume(args)
    assert args.resume is None and args.prior_metrics is None


# ---------------------------------------------------------------------------
# the entries and the records
# ---------------------------------------------------------------------------

def _rows():
    return [{"epoch": str(e), "train_gen_loss_recon_L1": str(0.5 - 0.1 * e),
             "val_metric_PSNR": str(10.0 + e), "val_metric_SSIM": str(0.1 * e),
             "val_clean_metric_PSNR": str(11.0 + e), "val_clean_metric_SSIM": str(0.2 * e)}
            for e in range(3)]


@pytest.mark.parametrize("resumed", [False, True])
def test_convergence_entry_matches_jax(tmp_path, resumed):
    prior = None
    if resumed:
        prior = str(tmp_path / "prior.csv")
        with open(prior, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(_rows()[0]))
            w.writeheader()
            w.writerows(_rows()[:2])
    args = argparse.Namespace(prior_metrics=prior, smoke=False, samples_per_vol=32,
                              max_epochs=5, resume="ckpts/r/1" if resumed else None)
    ref = jax_qr.convergence_entry(args, _rows(), 12.34,
                                   types.SimpleNamespace(device_kind="cpu"))
    got = qr.convergence_entry(args, _rows(), 12.34, "cpu")
    assert list(got) == list(ref)
    assert {k: v for k, v in got.items() if k not in ("date", "git")} == \
        {k: v for k, v in ref.items() if k not in ("date", "git")}


@pytest.mark.parametrize("two_cohort", [False, True])
def test_multistage_entries_match_jax(monkeypatch, capsys, two_cohort):
    """The JAX script's main (its build, arms and probe stubbed) prints the
    entries the port's ``ab_entries`` makes of the same rows."""
    import unet_bssfp_tpu.train.multistage as jax_multistage

    ms_row = {"val_metric_PSNR": 16.5, "val_metric_SSIM": 0.6, "val_metric_L1": 0.1}
    direct_row = {"val_metric_PSNR": 19.25, "val_metric_SSIM": 0.7, "val_metric_L1": 0.08}
    data = types.SimpleNamespace(setup=lambda: None)
    monkeypatch.setattr(jax_msb, "build",
                        lambda args: (None, data, data if args.two_cohort else None))
    monkeypatch.setattr(jax_msb, "run_direct", lambda *a, **k: direct_row)
    monkeypatch.setattr(jax_multistage, "run_multistage", lambda *a, **k: (None, ms_row))
    monkeypatch.setattr(jax_qr, "device_startup_probe", lambda **k: None)
    argv = ["multistage_bench.py", "--no-record"] + (["--two-cohort"] if two_cohort else [])
    monkeypatch.setattr(sys, "argv", argv)
    assert jax_msb.main() == 0
    text = capsys.readouterr().out.split("\nmultistage - direct")[0]
    ref = json.loads(text[text.index("["):])
    args = argparse.Namespace(pretrain=8, transfer=4, finetune=8, samples_per_vol=32,
                              smoke=False, two_cohort=two_cohort)
    got = msb.ab_entries(args, "cpu", ms_row, 0.0, direct_row, 0.0)
    for g, r, own in zip(got, ref, (msb.MULTISTAGE_KEYS, msb.DIRECT_KEYS)):
        assert list(g) == list(r)
        want = msb.COMMON_KEYS + (msb.TWO_COHORT_KEYS if two_cohort else ()) + own
        assert set(g) == set(want)
        assert {k: v for k, v in g.items() if k not in ("date", "git", "wall_seconds")} == \
            {k: v for k, v in r.items() if k not in ("date", "git", "wall_seconds")}
    assert got[0]["multistage_minus_direct_psnr"] == -2.75


def test_oracle_entry_matches_jax(tmp_path, monkeypatch):
    import unet_bssfp_tpu.data.datamodule as jax_dm
    import unet_bssfp_tpu_torch.data.datamodule as port_dm

    res = {"oracle_aug": {"psnr": 30.0, "ssim": 0.9, "l1": 0.01, "n_patches": 8},
           "target_aug_vs_orig": {"psnr": 25.0, "ssim": 0.8, "l1": 0.02, "n_patches": 8},
           "oracle_clean": {"psnr": 150.0, "ssim": 1.0, "l1": 0.0, "n_patches": 4}}
    stub = type("Stub", (), {"__init__": lambda self, *a, **k: None, "setup": lambda self: None})
    for dm in (jax_dm, port_dm):
        monkeypatch.setattr(dm, "DoveDataModule", stub)
    for mod in (jax_qr, qr):
        monkeypatch.setattr(mod, "make_fixture", lambda args: "unused")
    monkeypatch.setattr(jax_oracle, "measure", lambda *a, **k: res)
    monkeypatch.setattr(oracle, "measure", lambda *a, **k: res)
    monkeypatch.setattr(sys, "argv", ["oracle_ceiling.py", "--out", str(tmp_path / "j.json")])
    jax_oracle.main()
    assert oracle.main(["--out", str(tmp_path / "p.json"), "--device", "cpu"]) == 0
    (ref,), (got,) = (json.load(open(tmp_path / f)) for f in ("j.json", "p.json"))
    assert tuple(got) == tuple(ref) and "oracle_clean" in got
    assert {k: v for k, v in got.items() if k not in ("date", "git")} == \
        {k: v for k, v in ref.items() if k not in ("date", "git")}


def test_records_are_the_ports(monkeypatch):
    """The default records: never the JAX package's CONVERGENCE.json,
    QUALITY.json or quality/."""
    paths = {qr.CONVERGENCE_RECORD, qr.QUALITY_RECORD, qr.QUALITY_DIR, msb.RECORD_PATH}
    assert {os.path.relpath(p, REPO) for p in paths} == {
        "CONVERGENCE_TORCH.json", "QUALITY_TORCH.json", "quality_torch"}
    assert msb.RECORD_PATH == qr.CONVERGENCE_RECORD
    seen = []
    monkeypatch.setattr(qr, "append_record", lambda path, entries, **k: seen.append(path))
    monkeypatch.setattr(oracle, "measure", lambda *a, **k: {})
    monkeypatch.setattr(qr, "make_fixture", lambda args: "unused")
    import unet_bssfp_tpu_torch.data.datamodule as port_dm

    monkeypatch.setattr(port_dm, "DoveDataModule", type(
        "Stub", (), {"__init__": lambda self, *a, **k: None, "setup": lambda self: None}))
    oracle.main(["--device", "cpu"])
    assert seen == [qr.QUALITY_RECORD]


@pytest.mark.parametrize("name", ["torch_port_quality_record", "torch_port_oracle_ceiling",
                                  "torch_port_multistage_bench"])
def test_script_source_imports_no_jax(name):
    """Every import statement of the script, those inside its functions
    too: nothing of JAX, nothing of the JAX package, none of the JAX
    scripts."""
    import ast

    tree = ast.parse(open(os.path.join(REPO, "scripts", f"{name}.py")).read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots |= {node.module} | {f"{node.module}.{a.name}" for a in node.names}
    forbidden = ("jax", "jaxlib", "flax", "optax", "orbax", "unet_bssfp_tpu")
    jax_scripts = {os.path.splitext(f)[0] for f in os.listdir(os.path.join(REPO, "scripts"))
                   if f.endswith(".py") and not f.startswith("torch_port_")}
    bad = {r for r in roots if r.split(".")[0] in forbidden
           or r.split(".")[-1] in jax_scripts or r in jax_scripts}
    assert not bad, sorted(bad)


def test_scripts_import_no_jax():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import argparse\n"
        "from scripts import torch_port_multistage_bench as msb, "
        "torch_port_oracle_ceiling as oc, torch_port_quality_record as qr\n"
        "import unet_bssfp_tpu_torch.eval.evaluate, unet_bssfp_tpu_torch.train.loop, "
        "unet_bssfp_tpu_torch.train.multistage, unet_bssfp_tpu_torch.data.datamodule\n"
        "qr.build_config(argparse.Namespace(smoke=True, samples_per_vol=2, workdir='w', "
        "max_epochs=1), 'b')\n"
        "oc.make_linked_map_fn()\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'unet_bssfp_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine without a card")
@pytest.mark.parametrize("script", ["quality_record", "oracle_ceiling", "multistage_bench"])
def test_scripts_raise_without_a_card(tmp_path, monkeypatch, script):
    """No card and no --device cpu: each script raises before any work."""
    monkeypatch.setenv("CONVBENCH_DATA", str(tmp_path / "never"))
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    mod = {"quality_record": qr, "oracle_ceiling": oracle, "multistage_bench": msb}[script]
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        mod.main(["--smoke"])
    assert not (tmp_path / "never").exists()


def test_two_cohort_smoke_on_the_cpu(tmp_path):
    """``--smoke --two-cohort --no-record --device cpu`` at 1/1/1 epochs, in a
    process of its own: both arms' entries finite, nothing recorded, no JAX
    imported on the way."""
    env = dict(os.environ, CONVBENCH_DATA=str(tmp_path / "a"),
               CONVBENCH_DATA_B=str(tmp_path / "b"), TMPDIR=str(tmp_path))
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from scripts import torch_port_multistage_bench as msb\n"
        "rc = msb.main(['--smoke', '--two-cohort', '--no-record', '--device', 'cpu', "
        "'--pretrain', '1', '--transfer', '1', '--finetune', '1', '--samples-per-vol', '2'])\n"
        "print(json.dumps({'rc': rc, 'jax': sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'unet_bssfp_tpu'))}))\n")
    before = os.path.getmtime(msb.RECORD_PATH) if os.path.exists(msb.RECORD_PATH) else None
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == {"rc": 0, "jax": []}
    text = out.stdout.split("\nmultistage - direct")[0]
    ms_entry, direct_entry = json.loads(text[text.index("["):])
    assert ms_entry["cohorts"] == direct_entry["cohorts"] == 2
    assert ms_entry["stage_epochs"] == {"pretrain": 1, "transfer": 1, "finetune": 1}
    assert direct_entry["epochs"] == 3 and ms_entry["device"] == "cpu"
    for e in (ms_entry, direct_entry):
        assert all(math.isfinite(e[k]) for k in ("val_psnr_last", "val_ssim_last",
                                                 "val_l1_last"))
    assert math.isfinite(ms_entry["multistage_minus_direct_psnr"])
    after = os.path.getmtime(msb.RECORD_PATH) if os.path.exists(msb.RECORD_PATH) else None
    assert after == before
    assert len(os.listdir(tmp_path / "a" / "bids" / "derivatives" / "preproc-dove")) == 6
    assert len(os.listdir(tmp_path / "b" / "bids" / "derivatives" / "preproc-dove")) == 4
