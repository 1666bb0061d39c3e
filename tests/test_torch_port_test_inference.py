"""The port's test inference and checkpoint-driven evaluation against the
JAX package's, on the CPU: ``run_test`` (``eval/inference.py``), a step's
generator loaded on any device (``train/checkpoint.py:generator_state_dict``),
``eval_model``/``gen_predictions`` (``eval/evaluate.py``) and the two CLIs'
``--checkpoint``. One synthetic BIDS tree at 16³, one JAX GAN state from
``PRNGKey(0)`` (f32, narrow features) carried into the port, and one
synthetic Med3D ``.npz`` named in ``train.medicalnet_weights``, so both
packages run their FID in pretrained mode."""

import csv
import dataclasses
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from unet_bssfp_tpu.config import Config as JaxConfig
from unet_bssfp_tpu.data.datamodule import DoveDataModule as JaxDoveDataModule
from unet_bssfp_tpu.eval import evaluate as jax_evaluate
from unet_bssfp_tpu.eval.inference import run_test as jax_run_test
from unet_bssfp_tpu.models.medicalnet import load_medicalnet as jax_load_medicalnet
from unet_bssfp_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from unet_bssfp_tpu.train.state import build_models as jax_build_models
from unet_bssfp_tpu.train.state import create_gan_state as jax_create_gan_state
from unet_bssfp_tpu.train.steps import make_medicalnet_fid_fn as jax_make_fid_fn
from unet_bssfp_tpu.train.steps import make_predict_fn as jax_make_predict_fn
from unet_bssfp_tpu_torch import weights
from unet_bssfp_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from unet_bssfp_tpu_torch.data.datamodule import DoveDataModule
from unet_bssfp_tpu_torch.data.nifti import load_volume
from unet_bssfp_tpu_torch.data.synthetic import make_synthetic_bids
from unet_bssfp_tpu_torch.eval import evaluate
from unet_bssfp_tpu_torch.eval.__main__ import main as eval_main
from unet_bssfp_tpu_torch.eval.inference import predict_volume, run_test
from unet_bssfp_tpu_torch.models.medicalnet import load_medicalnet, medicalnet_features
from unet_bssfp_tpu_torch.ops import metrics
from unet_bssfp_tpu_torch.predict import main as predict_main
from unet_bssfp_tpu_torch.train import checkpoint as ckpt
from unet_bssfp_tpu_torch.train.state import build_models, create_gan_state
from unet_bssfp_tpu_torch.train.steps import make_medicalnet_fid_fn, make_predict_fn
from test_medicalnet import _synthetic_med3d_state_dict

torch.set_num_threads(1)

MOD = "pc-bssfp"
VOL = (16, 16, 16)
RESCALE = str(Path(__file__).resolve().parents[1] / "constants" / "rescale_args_dwi.txt")
METRICS = ["test_metric_PSNR", "test_metric_SSIM", "test_metric_L1", "test_metric_FID"]


@pytest.fixture(autouse=True)
def _keep_prng_impl():
    """The JAX package's create_gan_state switches JAX's default PRNG
    implementation for the process; put it back for the next test."""
    impl = jax.config.jax_default_prng_impl
    yield
    jax.config.update("jax_default_prng_impl", impl)


def _config(root: Path) -> Config:
    """16³ volumes seen as one 16³ patch, a 5-subject split of 3 / 0 / 2 (two
    test volumes), narrow f32 models, the synthetic Med3D file."""
    return Config(
        data=DataConfig(batch_size=2, patch_size=16, samples_per_vol=2, volume_shape=VOL,
                        val_split=0.0, test_split=0.4, num_workers=2),
        model=ModelConfig(features=(4, 8, 8, 16, 16, 4), disc_features=(8, 8, 16),
                          compute_dtype="float32", dropout=0.0),
        train=TrainConfig(medicalnet_weights=str(root / "med3d.npz"), with_perceptual=False,
                          log_dir=str(root / "logs"), checkpoint_dir=str(root / "ckpts")))


@pytest.fixture(scope="module")
def twin(tmp_path_factory):
    """The tree, the config, the JAX state and its Orbax step, the port's
    twin state and its ``state.pt`` step, and each package's ``run_test``
    output."""
    root = tmp_path_factory.mktemp("test_inference")
    bids = make_synthetic_bids(str(root / "bids"), sessions=("1",), volume_shape=VOL, seed=5)
    np.savez(root / "med3d.npz", **_synthetic_med3d_state_dict(torch, seed=4))
    cfg = _config(root)
    jcfg = JaxConfig.from_json(cfg.to_json())
    jstate = jax_create_gan_state(jax.random.PRNGKey(0), MOD, jcfg.model, jcfg.train,
                                  patch_size=cfg.data.patch_size)
    jmgr = JaxCheckpointManager(str(root / "jax_ckpts" / f"{MOD}-20260101-000000"),
                                config_json=jcfg.to_json())
    jmgr.save(0, jstate, {"val_loss": 1.0})
    jmgr.wait()
    jmgr.close()

    state = create_gan_state(1, MOD, cfg.model, cfg.train, "cpu")
    weights.state_from_flax(state.gen, state.disc, {
        k: jax.tree.map(np.asarray, getattr(jstate, k))
        for k in ("gen_params", "gen_batch_stats", "disc_params", "disc_batch_stats")})
    mgr = ckpt.CheckpointManager(str(root / "ckpts" / f"{MOD}-20260101-000000"),
                                 config_json=cfg.to_json())
    mgr.save(0, state, {"val_loss": 1.0})

    jdata = JaxDoveDataModule(bids, config=jcfg.data)
    jdata.prepare_data()
    jgen, _ = jax_build_models(MOD, jcfg.model)
    jfid = jax_make_fid_fn(*jax_load_medicalnet(cfg.train.medicalnet_weights), pretrained=True)
    jref = jax_run_test(jax_make_predict_fn(jgen), jstate, jdata, MOD, str(root / "jax_test"),
                        fid_fn=jfid)
    data = DoveDataModule(bids, config=cfg.data)
    data.prepare_data()
    fid_fn = make_medicalnet_fid_fn(load_medicalnet(cfg.train.medicalnet_weights),
                                    pretrained=True)
    got = run_test(make_predict_fn(state.gen), data, MOD, str(root / "port_test"),
                   fid_fn=fid_fn, device="cpu")
    return dict(root=root, bids=bids, cfg=cfg, jcfg=jcfg, data=data, jdata=jdata,
                state=state, step=mgr.best_path(), jstep=os.path.join(str(jmgr.directory), "0"),
                got=got, ref=jref)


def _files(d):
    return {fn: load_volume(os.path.join(d, fn)) for fn in sorted(os.listdir(d))}


def _fid_scale(pred_dir):
    """tr Sx + tr Sy + |mu_x − mu_y|² of the FID of each written volume (one
    volume a population: both traces 0), averaged as ``run_test`` averages."""
    net = load_medicalnet(str(Path(pred_dir).parents[0] / "med3d.npz"))
    scales = []
    for fn in sorted(os.listdir(pred_dir)):
        if not fn.startswith("pred-"):
            continue
        feats = []
        for kind in ("pred-", "target-"):
            v = torch.from_numpy(load_volume(os.path.join(pred_dir, fn.replace("pred-", kind)))[0])
            with torch.no_grad():
                feats.append(metrics.spatial_average(
                    medicalnet_features(net, metrics.znorm(v[None]))))
        fx, fy = feats
        d = fx.mean(0) - fy.mean(0)
        scales.append(float(metrics._cov(fx).trace() + metrics._cov(fy).trace() + d @ d))
    return float(np.mean(scales))


def _assert_metrics_match(got, ref, fid_scale):
    """PSNR within 1e-3 dB; SSIM and L1 within 1e-4 relative; the FID within
    1e-4 of the scale of its terms (it is a difference of them)."""
    assert list(got) == list(ref) == METRICS
    assert got["test_metric_PSNR"] == pytest.approx(ref["test_metric_PSNR"], abs=1e-3)
    for k in ("test_metric_SSIM", "test_metric_L1"):
        assert got[k] == pytest.approx(ref[k], rel=1e-4), k
    assert abs(got["test_metric_FID"] - ref["test_metric_FID"]) <= 1e-4 * fid_scale
    assert all(np.isfinite(v) for v in got.values())


def test_run_test_matches_jax(twin):
    root = twin["root"]
    assert len(twin["data"].test_samples) == len(twin["jdata"].test_samples) == 2
    _assert_metrics_match(twin["got"], twin["ref"], _fid_scale(root / "port_test"))
    port, ref = _files(root / "port_test"), _files(root / "jax_test")
    assert sorted(port) == sorted(ref) and len(port) == 3 * 2
    for fn, (x, aff) in port.items():
        y, jaff = ref[fn]
        assert x.dtype == np.float32 and x.shape == y.shape, fn
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-5 * np.abs(y).max(), err_msg=fn)
        np.testing.assert_allclose(aff, jaff, rtol=0, atol=1e-5 * np.abs(jaff).max(), err_msg=fn)
    # the target's affine, on all three
    spec = twin["data"].test_samples[0]
    tgt_aff = load_volume(spec.path("dwi-tensor"))[1]
    for kind in ("input", "pred", "target"):
        name = next(fn for fn in port if fn.startswith(f"{kind}-0_"))
        np.testing.assert_array_equal(port[name][1], tgt_aff)


def test_save_predictions_names_and_entities(twin, tmp_path):
    from unet_bssfp_tpu.eval.inference import save_predictions as jax_save
    from unet_bssfp_tpu_torch.eval.inference import save_predictions

    spec, jspec = twin["data"].test_samples[0], twin["jdata"].test_samples[0]
    z = np.zeros(VOL + (6,), np.float32)
    got = save_predictions(str(tmp_path / "p"), 3, MOD, spec, z, z, z, timestamp="20260101-120000")
    ref = jax_save(str(tmp_path / "j"), 3, MOD, jspec, z, z, z, timestamp="20260101-120000")
    assert {k: os.path.basename(v) for k, v in got.items()} == {
        k: os.path.basename(v) for k, v in ref.items()}
    assert os.path.basename(got["pred"]).startswith(f"pred-3_mod-{MOD}_20260101-120000_sub-")
    assert evaluate.parse_pred_name(got["target"])["time"] == "20260101-120000"


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_eval_model_matches_jax_from_their_checkpoints(twin):
    """The port's ``eval_model`` from its ``state.pt`` (config from the run's
    ``config.json``) against the JAX package's from its Orbax step."""
    root = twin["root"]
    got = evaluate.eval_model(twin["data"], twin["step"], MOD, str(root / "em_port"),
                              device="cpu")
    ref = jax_evaluate.eval_model(twin["jdata"], twin["jstep"], MOD, str(root / "em_jax"))
    _assert_metrics_match(got, ref, _fid_scale(root / "em_port"))
    _assert_metrics_match(got, twin["got"], _fid_scale(root / "em_port"))
    rows, jrows = (_read_csv(root / d / "test_metrics.csv") for d in ("em_port", "em_jax"))
    assert rows[0] == jrows[0] == ["modality"] + METRICS
    assert rows[1][0] == jrows[1][0] == MOD and len(rows) == len(jrows) == 2
    _assert_metrics_match(dict(zip(METRICS, map(float, rows[1][1:]))),
                          dict(zip(METRICS, map(float, jrows[1][1:]))),
                          _fid_scale(root / "em_port"))
    assert sorted(os.listdir(root / "em_port")) == sorted(os.listdir(root / "em_jax"))


def test_eval_model_without_fid_and_with_an_explicit_config(twin, tmp_path):
    cfg = twin["cfg"]
    got = evaluate.eval_model(twin["data"], twin["step"], MOD, str(tmp_path / "p"),
                              config=cfg, with_fid=False, device="cpu")
    assert list(got) == METRICS[:3]
    for k in METRICS[:3]:
        assert got[k] == twin["got"][k], k  # the same weights, volumes and device


def test_generator_of_a_card_checkpoint_loads_on_the_cpu(twin, tmp_path):
    """A step saved from a state on the card holds a CUDA dropout generator's
    state; one cannot be made here, so the payload is built by hand. The
    generator alone loads on the CPU; resuming the whole state still
    refuses the foreign generator state."""
    state = twin["state"]
    payload = ckpt.state_payload(state)
    payload["rng"] = {"device_type": "cuda", "state": torch.zeros(16, dtype=torch.uint8)}
    step = tmp_path / "run" / "0"
    step.mkdir(parents=True)
    ckpt.atomic_save(payload, str(step / ckpt.STATE_FILE))
    gen, _ = build_models(MOD, twin["cfg"].model, "cpu",
                          state_dict=ckpt.generator_state_dict(str(step)))
    sd = gen.state_dict()
    assert sd.keys() == state.gen.state_dict().keys()
    assert all(torch.equal(v, state.gen.state_dict()[k]) for k, v in sd.items())
    assert ckpt.generator_state_dict(str(step / ckpt.STATE_FILE)).keys() == sd.keys()
    with pytest.raises(ValueError, match="generator"):
        ckpt.load_checkpoint(str(step), create_gan_state(0, MOD, twin["cfg"].model,
                                                         twin["cfg"].train, "cpu"))
    other = dataclasses.replace(twin["cfg"].model, features=(4, 8, 8, 16, 16, 8))
    with pytest.raises(RuntimeError, match="size mismatch"):
        build_models(MOD, other, "cpu", state_dict=ckpt.generator_state_dict(str(step)))


def test_eval_cli_with_checkpoint_writes_metrics_maps_and_table(twin, capsys):
    root = twin["root"]
    (root / "cfg.json").write_text(twin["cfg"].to_json())
    pred = root / "cli_preds"
    out_csv = root / "cli_errors.csv"
    assert eval_main([str(pred), twin["bids"], "--checkpoint", f"{MOD}={twin['step']}",
                      "--config", str(root / "cfg.json"), "--rescale-args", RESCALE,
                      "--out-csv", str(out_csv), "--device", "cpu", "--num-workers", "2"]) == 0
    text = capsys.readouterr().out.splitlines()
    rows = _read_csv(pred / MOD / "test_metrics.csv")
    assert rows == _read_csv(root / "em_port" / "test_metrics.csv")
    names = os.listdir(pred / MOD)
    for deriv in ("denorm", "fa", "md", "rgb"):
        assert sum(n.startswith("pred-") and n.endswith(f"_{deriv}.nii.gz") for n in names) == 2
    # diff- of the tensor, its denorm, fa, md, ad, rd and the two angles
    assert sum(n.startswith("diff-") for n in names) == 2 * 8
    table = _read_csv(out_csv)
    assert table[0][:5] == ["modality", "pred_id", "roi", "sub", "ses"]
    assert len(table) == 1 + 2 * 3 and text[0].split() == table[0]


@pytest.mark.parametrize("specs", [["pc-bssfp"], [f"{MOD}=somewhere", "t1w"]])
def test_eval_cli_refuses_a_bad_checkpoint_spec(twin, specs, capsys):
    """A spec without ``=`` is a parser error, before any work."""
    argv = [str(twin["root"] / "bad"), twin["bids"], "--device", "cpu"]
    for spec in specs:
        argv += ["--checkpoint", spec]
    with pytest.raises(SystemExit) as exc:
        eval_main(argv)
    assert exc.value.code == 2
    assert "MODALITY=PATH" in capsys.readouterr().err
    assert not (twin["root"] / "bad").exists()


def test_predict_cli_with_checkpoint_takes_the_run_config(twin, tmp_path, capsys):
    """No ``--config``: the run's ``config.json`` (16³ volumes, narrow f32
    models; ``Config()``'s full-width generator would not load). The
    prediction of a written test input is its ``pred-`` file, bit for bit."""
    root = twin["root"]
    inp = next(str(root / "port_test" / fn) for fn in sorted(os.listdir(root / "port_test"))
               if fn.startswith("input-0_"))
    out = predict_main([inp, "--checkpoint", twin["step"], "--out-dir", str(tmp_path / "o"),
                        "--device", "cpu"])
    assert "patch-stitched" in capsys.readouterr().out
    want = load_volume(inp.replace("input-0_", "pred-0_"))[0]
    np.testing.assert_array_equal(load_volume(out)[0], want)
    # and the same from the step's state.pt, with an explicit config
    (tmp_path / "cfg.json").write_text(twin["cfg"].to_json())
    out2 = predict_main([inp, "--checkpoint", os.path.join(twin["step"], ckpt.STATE_FILE),
                         "--config", str(tmp_path / "cfg.json"), "--out-dir",
                         str(tmp_path / "o2"), "--device", "cpu", "--whole-volume"])
    gen, _ = build_models(MOD, twin["cfg"].model, "cpu", state_dict=twin["state"].gen.state_dict())
    ref = predict_volume(make_predict_fn(gen), torch.from_numpy(load_volume(inp)[0]),
                         patch_size=16, whole_volume=True)
    np.testing.assert_array_equal(load_volume(out2)[0], ref.numpy())


def test_predict_cli_takes_exactly_one_weight_source(twin, tmp_path, capsys):
    inp = str(tmp_path / "x.nii.gz")
    for argv in ([inp, "--weights", "w.pt", "--checkpoint", twin["step"]], [inp]):
        with pytest.raises(SystemExit) as exc:
            predict_main(argv + ["--device", "cpu"])
        assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "not allowed with argument" in err and "one of the arguments" in err
