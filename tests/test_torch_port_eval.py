"""The port's evaluation path (error maps, name parsing, the synthetic BIDS
tree, the post-processing chain, the ROI error table, the eval CLI and
``predict --scalar-maps``) against the JAX package's, on the CPU."""

import csv
import os
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_bssfp_tpu.data.bids import parse_entities as jax_parse_entities
from unet_bssfp_tpu.data.synthetic import make_synthetic_bids as jax_make_synthetic_bids
from unet_bssfp_tpu.eval import evaluate as jax_eval
from unet_bssfp_tpu.ops import error_maps as jax_em
from unet_bssfp_tpu_torch.data.bids import parse_entities
from unet_bssfp_tpu_torch.data.nifti import load_volume, save_volume
from unet_bssfp_tpu_torch.data.synthetic import make_synthetic_bids
from unet_bssfp_tpu_torch.eval import evaluate
from unet_bssfp_tpu_torch.ops import error_maps as em
from unet_bssfp_tpu_torch.ops.scalar_maps import load_rescale_args
from unet_bssfp_tpu_torch.ops.scalar_maps_check import scalar_maps_tolerance

torch.set_num_threads(1)
U = 2.0 ** -24
RESCALE = str(Path(__file__).resolve().parents[1] / "constants" / "rescale_args_dwi.txt")
VOL = (16, 16, 16)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------------------
# error maps
# ---------------------------------------------------------------------------

def _pred_target():
    """Targets with exact zeros (inf and nan where pred equals them too),
    negative values and a nan."""
    rng = np.random.default_rng(7)
    t = rng.standard_normal((6, 5, 4, 3)).astype(np.float32)
    p = (t + 0.3 * rng.standard_normal(t.shape)).astype(np.float32)
    t[0, 0, 0] = 0.0
    p[0, 0, 0, 0] = 0.0           # 0/0 → nan; the other channels → inf
    t[1, 1, 1, 1] = np.nan
    return p, t


def test_relative_error_map_matches_jax_bitwise():
    p, t = _pred_target()
    got = em.relative_error_map(_t(p), _t(t)).numpy()
    ref = np.asarray(jax_em.relative_error_map(jnp.asarray(p), jnp.asarray(t)))
    assert np.isnan(got).sum() == 2 and np.isinf(got).sum() == 2
    # one subtraction, abs and division: the same roundings on both sides
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("ndim", [3, 4])
def test_relative_error_map_floored_matches_jax(ndim):
    p, t = _pred_target()
    t[1, 1, 1, 1] = 0.5
    if ndim == 3:
        p, t = p[..., 0], t[..., 0]
    got = em.relative_error_map_floored(_t(p), _t(t), 0.1).numpy()
    ref = np.asarray(jax_em.relative_error_map_floored(jnp.asarray(p), jnp.asarray(t), 0.1))
    assert np.isfinite(got).all()
    # the floor's mean |target| sums N values in f32 in another order: it
    # differs by at most N·u relative, and so does a floored denominator
    n = int(np.prod(t.shape[:3]))
    np.testing.assert_allclose(got, ref, rtol=(n + 4) * U, atol=0)


def test_angular_error_map_matches_jax_bitwise():
    rng = np.random.default_rng(3)
    p = rng.uniform(-400, 400, 4096).astype(np.float32)
    t = rng.uniform(-400, 400, 4096).astype(np.float32)
    p[:4] = [-350.0, 10.0, 190.0, 720.0]
    t[:4] = [0.0, 370.0, 0.0, 0.0]
    assert (p - t < 0).sum() > 1000  # negative differences: mod, not fmod
    got = em.angular_error_map(_t(p), _t(t)).numpy()
    ref = np.asarray(jax_em.angular_error_map(jnp.asarray(p), jnp.asarray(t)))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[:4], [10.0, 0.0, 170.0, 0.0])
    assert got.min() >= 0 and got.max() <= 180


def test_roi_weighted_mean_errors_and_masked_probseg_match_jax():
    rng = np.random.default_rng(9)
    p, t = _pred_target()
    diff = np.array(jax_em.relative_error_map(jnp.asarray(p), jnp.asarray(t)))
    diff[2, 2, 2, 0] = -np.inf
    mask = (rng.random(diff.shape[:3]) > 0.3).astype(np.float32)
    probs = rng.random(diff.shape[:3] + (3,)).astype(np.float32)
    probs[..., 2] *= 1e-5       # some below the 1e-5 cut
    probs[:, :, :, 1] = 0.0     # an ROI with no weight: den 0 → 1
    ps = em.masked_probseg(_t(mask), _t(probs))
    jps = jax_em.masked_probseg(jnp.asarray(mask), jnp.asarray(probs))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(jps))
    got = em.roi_weighted_mean_errors(_t(diff), _t(mask), ps).numpy()
    ref = np.asarray(jax_em.roi_weighted_mean_errors(jnp.asarray(diff),
                                                     jnp.asarray(mask), jps))
    assert got.shape == (3, 3) and got.dtype == np.float32
    assert np.isfinite(got).all() and np.all(got[1] == 0)
    # the port sums in f64; JAX's f32 sums of N nonnegative terms are within
    # N·u relative of the exact ones, and the port's output rounds once
    n = int(np.prod(diff.shape[:3]))
    np.testing.assert_allclose(got, ref, rtol=(2 * n + 1) * U, atol=0)


def test_error_dict_from_maps_matches_jax():
    rng = np.random.default_rng(4)
    maps = {k: rng.uniform(-180, 180, (4, 4, 4)).astype(np.float32)
            for k in ("fa", "azimuth", "inclination", "md")}
    tmaps = {k: rng.uniform(-180, 180, (4, 4, 4)).astype(np.float32) for k in maps}
    got = em.error_dict_from_maps({k: _t(v) for k, v in maps.items()},
                                  {k: _t(v) for k, v in tmaps.items()})
    ref = jax_em.error_dict_from_maps({k: jnp.asarray(v) for k, v in maps.items()},
                                      {k: jnp.asarray(v) for k, v in tmaps.items()})
    assert got.keys() == ref.keys()
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)


# ---------------------------------------------------------------------------
# names and the synthetic tree
# ---------------------------------------------------------------------------

PRED_NAMES = [
    "pred-3_mod-pc-bssfp_sub-01_ses-2_fa.nii.gz",
    "target-0_mod-dwi-tensor_sub-01_ses-1.nii.gz",
    "garbage.nii.gz",
    "pred-3_mod-pc-bssfp_20260816-141503_sub-01_ses-2_md.nii.gz",
    "diff-10_mod-t1w_sub-A7_ses-1_inclination.nii",
    "dfloor-2_mod-bssfp_sub-03_ses-1_denorm.nii.gz",
    "/some/preds_denorm/pred-0_mod-pc-bssfp_sub-01_ses-1_denorm.nii.gz",
]


@pytest.mark.parametrize("name", PRED_NAMES)
def test_parse_pred_name_matches_jax(name):
    assert evaluate.parse_pred_name(name) == jax_eval.parse_pred_name(name)


def test_parse_pred_name_cases():
    ents = evaluate.parse_pred_name(PRED_NAMES[3])
    assert (ents["mod"], ents["time"], ents["deriv"]) == ("pc-bssfp", "20260816-141503", "md")
    assert evaluate.parse_pred_name(PRED_NAMES[1])["deriv"] == ""
    assert evaluate.parse_pred_name(PRED_NAMES[2]) is None


@pytest.mark.parametrize("name", [
    "sub-001_ses-01_desc-normtensor_dwi.nii.gz",
    "sub-01_ses-1_desc-probseg_T1w.nii",
    "sub-02_desc-2mmiso_mask.json",
    "sub-02_ses-3_run-1",
    "plain.txt",
])
def test_parse_entities_matches_jax(name):
    assert parse_entities(name) == jax_parse_entities(name)


def _tree_arrays(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for fn in files:
            path = os.path.join(dirpath, fn)
            out[os.path.relpath(path, root)] = load_volume(path)
    return out


def test_make_synthetic_bids_matches_jax(tmp_path):
    for linked in (False, True):
        kw = dict(subjects=("01", "02"), sessions=("1", "2"), volume_shape=(6, 7, 5),
                  seed=3, linked=linked)
        ours = _tree_arrays(make_synthetic_bids(str(tmp_path / f"t{linked}"), **kw))
        theirs = _tree_arrays(jax_make_synthetic_bids(str(tmp_path / f"j{linked}"), **kw))
        assert sorted(ours) == sorted(theirs) and len(ours) == 2 * (3 * 2 + 3)
        for k in ours:
            np.testing.assert_array_equal(ours[k][0], theirs[k][0], err_msg=k)
            np.testing.assert_array_equal(ours[k][1], theirs[k][1], err_msg=k)


# ---------------------------------------------------------------------------
# the whole chain, both packages on twin copies
# ---------------------------------------------------------------------------

def _write_predictions(pred_dir, bids, seed=3):
    """pred/target pairs named as the reference names them, for two
    subjects: the target is the subject's DT, the prediction a noisy copy."""
    rng = np.random.default_rng(seed)
    os.makedirs(pred_dir, exist_ok=True)
    for i, sub in enumerate(("01", "02")):
        tgt, aff = load_volume(os.path.join(
            bids, "derivatives/preproc-dove", f"sub-{sub}", "ses-1", "dwi",
            f"sub-{sub}_ses-1_desc-normtensor_dwi.nii.gz"))
        pred = np.clip(tgt + 0.1 * rng.standard_normal(tgt.shape), 0, 1).astype(np.float32)
        for kind, data in (("pred", pred), ("target", tgt)):
            save_volume(os.path.join(pred_dir, f"{kind}-{i}_mod-pc-bssfp_sub-{sub}_ses-1.nii.gz"),
                        data, aff)


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_chain")
    bids = make_synthetic_bids(str(root / "bids"), subjects=("01", "02"),
                               sessions=("1",), volume_shape=VOL)
    _write_predictions(str(root / "port" / "pc-bssfp"), bids)
    shutil.copytree(root / "port", root / "jax")
    jax_eval.eval_dwi_tensors(str(root / "jax" / "pc-bssfp"), RESCALE)
    jax_eval.calc_error_table(str(root / "jax"), bids, str(root / "jax.csv"))
    evaluate.eval_dwi_tensors(str(root / "port" / "pc-bssfp"), RESCALE, num_workers=4,
                              device="cpu")
    rows = evaluate.calc_error_table(str(root / "port"), bids, str(root / "port.csv"),
                                     num_workers=4, device="cpu")
    return root, bids, rows


def _load_dir(d):
    return {fn: load_volume(os.path.join(d, fn))[0] for fn in sorted(os.listdir(d))}


def _relative_bound(p, t, dp, dt, den=None, dden=None):
    """Bound on |Δ(|p − t|/den)| for p, t known within dp, dt (den = |t| by
    default): first order in dp/den, dden/den, plus the output's rounding;
    inf where the denominator is within 2·dden of 0 (ill-conditioned)."""
    den = np.abs(t) if den is None else den
    dden = dt if dden is None else dden
    r = np.abs(p - t) / np.where(den == 0, 1, den)
    b = (dp + dt) / den + r * dden / np.maximum(den - dden, 1e-300) + 4 * U * r
    b = np.where(den > 2 * dden, b, np.inf)
    return np.where((dp == 0) & (dt == 0) & (dden == 0), 4 * U * r, b)


def _bounds(files, minmax):
    """Per-file bound on |port − JAX| for every file of the chain, from the
    bounds of its inputs (see each step)."""
    mm = np.asarray(minmax, np.float32)
    a, b = np.abs(mm[:, 1] - mm[:, 0]), mm[:, 0]
    bounds = {}
    for fn, x in files.items():
        ents = evaluate.parse_pred_name(fn)
        if ents["kind"] in ("pred", "target") and ents["deriv"] == "":
            bounds[fn] = np.zeros_like(x)            # the inputs, copied
        elif ents["kind"] in ("pred", "target") and ents["deriv"] == "denorm":
            raw = files[fn.replace("_denorm", "")]
            # x·a + b: XLA may fuse it into one FMA
            bounds[fn] = 2 * U * (np.abs(raw) * a + np.abs(b))
    for fn, x in files.items():
        ents = evaluate.parse_pred_name(fn)
        if ents["kind"] in ("pred", "target") and ents["deriv"] == "denorm":
            tol, _ = scalar_maps_tolerance(torch.from_numpy(x),
                                           input_err=torch.from_numpy(bounds[fn].max(-1)))
            for k, v in tol.items():
                mfn = fn.replace("_denorm", f"_{k}")
                bounds[mfn] = v.numpy().reshape(files[mfn].shape)
    for fn, x in files.items():
        ents = evaluate.parse_pred_name(fn)
        if ents["kind"] not in ("diff", "dfloor"):
            continue
        pfn = fn.replace(f"{ents['kind']}-", "pred-", 1)
        tfn = pfn.replace("pred-", "target-", 1)
        p, t = files[pfn].astype(np.float64), files[tfn].astype(np.float64)
        dp, dt = bounds[pfn], bounds[tfn]
        if ents["deriv"] in ("azimuth", "inclination"):
            bounds[fn] = dp + dt + 4 * U * 180
        elif ents["kind"] == "diff":
            bounds[fn] = _relative_bound(p, t, dp, dt)
        else:
            # floor = 0.1·mean|t| over t ≠ 0 (per channel): its sum of N
            # values rounds by N·u, and moves with the mean of dt
            at = np.abs(t)
            axes = (0, 1, 2)
            nz = at > 0
            scale = (at * nz).sum(axes, keepdims=True) / np.maximum(nz.sum(axes, keepdims=True), 1)
            dscale = ((dt * nz).sum(axes, keepdims=True) / np.maximum(nz.sum(axes, keepdims=True), 1)
                      + at[..., :1].size * U * scale)
            den = np.maximum(at, 0.1 * scale)
            dden = np.where(at >= 0.1 * scale, dt, 0.1 * dscale) + np.zeros_like(at)
            bounds[fn] = _relative_bound(p, t, dp, dt, den, dden)
    return bounds


def test_chain_writes_what_the_jax_chain_writes(chains):
    root, _, _ = chains
    port, ref = _load_dir(root / "port" / "pc-bssfp"), _load_dir(root / "jax" / "pc-bssfp")
    assert sorted(port) == sorted(ref)
    # per subject: pred/target, their denorm and 7 maps each, then diff and
    # dfloor of the tensor, denorm, fa, md, ad, rd and diff of the 2 angles
    assert len(port) == 2 * (2 + 2 + 2 * 7 + 2 * 6 + 2)
    bounds = _bounds(port, load_rescale_args(RESCALE))
    assert sorted(bounds) == sorted(port)
    left_out = {}
    for fn, x in port.items():
        y, bnd = ref[fn], bounds[fn]
        assert x.shape == y.shape, fn
        # the inf/nan pattern of the relative maps is part of parity
        np.testing.assert_array_equal(np.isnan(x), np.isnan(y), err_msg=fn)
        np.testing.assert_array_equal(np.isinf(x), np.isinf(y), err_msg=fn)
        fin = np.isfinite(x) & np.isfinite(bnd)
        ents = evaluate.parse_pred_name(fn)
        if ents["deriv"] in ("azimuth", "inclination"):
            err = np.asarray(jax_em.angular_error_map(jnp.asarray(x), jnp.asarray(y)))
        else:
            err = np.abs(x.astype(np.float64) - y)
        assert np.all(err[fin] <= bnd[fin]), (fn, float((err[fin] - bnd[fin]).max()))
        left_out[fn] = int((~np.isfinite(bnd) & np.isfinite(x)).sum())
    # left out: angles of near-degenerate tensors, and relative errors whose
    # denominator lies within its own bound of 0
    worst = max(left_out.items(), key=lambda kv: kv[1])
    assert worst[1] <= 0.05 * np.prod(VOL), worst


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def test_error_table_matches_jax(chains):
    root, bids, rows = chains
    header, body = _read_csv(root / "port.csv")
    jheader, jbody = _read_csv(root / "jax.csv")
    assert header == jheader == evaluate.table_columns(rows)
    assert len(body) == len(jbody) == 2 * 3
    assert [r[:5] for r in body] == [r[:5] for r in jbody]  # index, sub, ses, order
    assert [list(r.values())[:5] for r in rows] == [r[:5] for r in body]
    assert {c for c in header if c.endswith("_floored")} == {
        f"{c}_floored" for c in evaluate.TENSOR_COLS + ("md", "fa", "ad", "rd")}
    # each cell is Σ p·|diff| / Σ p over the subject's masked probseg: it
    # moves by the probseg-weighted mean of its diff map's bound (voxels left
    # out of that bound count with their measured difference), by N·u for
    # JAX's f32 sums and by one f32 rounding of the output
    port = _load_dir(root / "port" / "pc-bssfp")
    ref = _load_dir(root / "jax" / "pc-bssfp")
    bounds = _bounds(port, load_rescale_args(RESCALE))
    masks, probsegs = evaluate._load_masks(bids, ("01", "02"), "derivatives/preproc-dove",
                                           torch.device("cpu"))
    n = int(np.prod(VOL))
    for row, jrow in zip(rows, jbody):
        mask = masks[row["sub"]].numpy() > 0
        w = probsegs[row["sub"]].numpy()[..., ("CSF", "GM", "WM").index(row["roi"])]
        for c, col in enumerate(header[5:], start=5):
            got, want = row[col], float(jrow[c])
            base = col[: -len("_floored")] if col.endswith("_floored") else col
            kind = "dfloor" if col.endswith("_floored") else "diff"
            deriv = "" if base in evaluate.TENSOR_COLS else f"_{base}"
            fn = f"{kind}-{row['pred_id']}_mod-pc-bssfp_sub-{row['sub']}_ses-1{deriv}.nii.gz"
            x, y, bnd = port[fn], ref[fn], bounds[fn]
            if not deriv:
                ch = evaluate.TENSOR_COLS.index(base)
                x, y, bnd = x[..., ch], y[..., ch], bnd[..., ch]
            else:
                x, y, bnd = x[..., 0], y[..., 0], bnd.reshape(x.shape)[..., 0]
            keep = mask & np.isfinite(x)
            measured = np.abs(np.abs(x.astype(np.float64)) - np.abs(y))
            b = np.where(np.isfinite(bnd), bnd, measured)
            cell = float((w * np.where(keep, b, 0)).sum() / max(w.sum(), 1e-300))
            tol = cell + (n + 2) * U * abs(want)
            assert abs(got - want) <= tol, (row["sub"], row["roi"], col, got, want, tol)


def test_error_table_averages_duplicates_and_sorts_pred_id_as_text(tmp_path):
    """Files that differ only in their timestamp share a key and are
    averaged; pred_id sorts as text ("10" before "2"), as pandas sorts it."""
    bids = make_synthetic_bids(str(tmp_path / "bids"), subjects=("01",), sessions=("1",),
                               volume_shape=(4, 4, 4))
    d = tmp_path / "preds"
    d.mkdir()
    for idx, stamp, val in (("2", "", 1.0), ("10", "_20260101-000000", 2.0),
                            ("10", "_20260102-000000", 4.0)):
        save_volume(str(d / f"diff-{idx}_mod-x{stamp}_sub-01_ses-1_md.nii.gz"),
                    np.full((4, 4, 4), val, np.float32))
    rows = evaluate.calc_error_table(str(d), bids, str(tmp_path / "t.csv"), device="cpu")
    assert [(r["pred_id"], r["roi"]) for r in rows] == [
        ("10", "CSF"), ("10", "GM"), ("10", "WM"), ("2", "CSF"), ("2", "GM"), ("2", "WM")]
    assert [r["md"] for r in rows] == [3.0] * 3 + [1.0] * 3
    header, body = _read_csv(tmp_path / "t.csv")
    jax_eval.calc_error_table(str(d), bids, str(tmp_path / "j.csv"))
    jheader, jbody = _read_csv(tmp_path / "j.csv")
    assert header == jheader and [r[:5] for r in body] == [r[:5] for r in jbody]
    # JAX's f32 sums of 64 voxels: within 64·u relative of the exact mean
    np.testing.assert_allclose([float(r[5]) for r in body], [float(r[5]) for r in jbody],
                               rtol=66 * U, atol=0)


def test_eval_cli_on_empty_prediction_dir(tmp_path, capsys):
    from unet_bssfp_tpu_torch.eval.__main__ import main

    (tmp_path / "preds").mkdir()
    out_csv = tmp_path / "e.csv"
    assert main([str(tmp_path / "preds"), str(tmp_path / "missing_bids"),
                 "--out-csv", str(out_csv), "--device", "cpu"]) == 0
    assert "Empty table" in capsys.readouterr().out
    assert not out_csv.exists()  # as the JAX table: nothing written when empty
    with pytest.raises(SystemExit) as exc:
        main([str(tmp_path / "preds"), str(tmp_path), "--checkpoint", "pc-bssfp=x"])
    assert exc.value.code == 2


def test_eval_cli_prints_the_table(chains, capsys):
    from unet_bssfp_tpu_torch.eval.__main__ import main

    root, bids, rows = chains
    shutil.copytree(root / "port", root / "cli")
    out_csv = root / "cli.csv"
    assert main([str(root / "cli"), bids, "--rescale-args", RESCALE, "--out-csv",
                 str(out_csv), "--device", "cpu", "--num-workers", "2"]) == 0
    text = capsys.readouterr().out.splitlines()
    assert text[0].split() == evaluate.table_columns(rows) and len(text) == 1 + len(rows)
    assert _read_csv(out_csv) == _read_csv(root / "port.csv")


def test_predict_cli_writes_scalar_maps(tmp_path):
    from unet_bssfp_tpu_torch import weights
    from unet_bssfp_tpu_torch.config import Config
    from unet_bssfp_tpu_torch.ops.scalar_maps import (
        compute_scalar_maps,
        invert_dwi_tensor_norm,
    )
    from unet_bssfp_tpu_torch.predict import main
    from unet_bssfp_tpu_torch.train.state import build_models

    rng = np.random.default_rng(12)
    affine = np.diag([2.0, 2.0, 2.0, 1.0])
    inp = str(tmp_path / "sub-01_bssfp.nii.gz")
    save_volume(inp, rng.standard_normal((16, 16, 16, 24)).astype(np.float32), affine)
    cfg = Config.from_json(
        '{"data": {"volume_shape": [16, 16, 16], "patch_size": 16},'
        ' "model": {"features": [8, 16, 16, 32, 32, 8], "compute_dtype": "float32"}}')
    (tmp_path / "cfg.json").write_text(cfg.to_json())
    gen, _ = build_models("pc-bssfp", cfg.model, "cpu")
    weights.save(weights.random_state_dict(gen, 0), str(tmp_path / "w.pt"))
    out = main([inp, "--weights", str(tmp_path / "w.pt"), "--config", str(tmp_path / "cfg.json"),
                "--out-dir", str(tmp_path / "o"), "--device", "cpu", "--scalar-maps",
                "--rescale-args", RESCALE])
    pred = torch.from_numpy(load_volume(out)[0])
    maps = compute_scalar_maps(invert_dwi_tensor_norm(pred, load_rescale_args(RESCALE)))
    for name, want in zip(maps._fields, maps):
        got, aff = load_volume(str(tmp_path / "o" / f"sub-01_bssfp_{name}.nii.gz"))
        np.testing.assert_array_equal(got.reshape(want.shape), want.numpy(), err_msg=name)
        np.testing.assert_allclose(aff, affine)
