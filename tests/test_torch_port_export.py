"""The port's serving artifact (``eval/export.py``, the export CLI and
``predict --exported``) on the CPU: the save → load round trip, the
refusals of a file that is not the port's (a JAX ``.ubx`` by name), the
artifact against the JAX package's ``export_generator`` + ``load_exported``
on the same weights and input, the two CLIs end to end in subprocesses
against ``predict --checkpoint --whole-volume``, and ``predict
--exported``'s five refusals. Features 8/8/16/16/32/8, f32, 16³."""

import functools
import io
import os
import re
import struct
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_bssfp_tpu.config import ModelConfig as JaxModelConfig
from unet_bssfp_tpu.eval import export as jax_export
from unet_bssfp_tpu.train.state import build_models as jax_build_models
from unet_bssfp_tpu_torch import weights
from unet_bssfp_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from unet_bssfp_tpu_torch.data.nifti import load_volume, save_volume
from unet_bssfp_tpu_torch.eval import export
from unet_bssfp_tpu_torch.predict import main as predict_main
from unet_bssfp_tpu_torch.train import checkpoint as ckpt
from unet_bssfp_tpu_torch.train.state import build_models, create_gan_state
from unet_bssfp_tpu_torch.train.steps import make_predict_fn
from test_torch_port_models import random_variables

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
MOD = "pc-bssfp"
FEATURES = (8, 8, 16, 16, 32, 8)
DISC = (8, 8, 16)
VOL = (16, 16, 16)
SHAPE = (1, *VOL, 24)
MCFG = ModelConfig(features=FEATURES, disc_features=DISC, compute_dtype="float32",
                   dropout=0.0)
# tests/test_torch_port_models.py's model tolerance: f32, another summation
# order in every conv
TOL = dict(rtol=2e-4, atol=2e-5)


def _x(shape=SHAPE, seed=3):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def twin(tmp_path_factory):
    """JAX generator variables (seeded numpy values on ``jax.eval_shape``'s
    tree: traced, not compiled), the port's ``state_dict`` of them, the
    port's artifact and the JAX package's, both at ``SHAPE``."""
    root = tmp_path_factory.mktemp("export")
    jmcfg = JaxModelConfig(features=FEATURES, disc_features=DISC, compute_dtype="float32",
                           dropout=0.0, packed=False)
    jgen, _ = jax_build_models(MOD, jmcfg)
    shapes = jax.eval_shape(functools.partial(jgen.init, train=False), jax.random.PRNGKey(0),
                            jnp.zeros(SHAPE))
    variables = random_variables(jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes),
                                 5)
    sd = weights.from_flax(variables["params"], variables["batch_stats"])

    program, meta = export.export_generator(MOD, MCFG, sd, SHAPE, device="cpu",
                                            extra_meta={"git": "test"})
    path = str(root / "model.ubt")
    export.save_exported(program, meta, path)

    jstate = type("S", (), {"gen_params": variables["params"],
                            "gen_batch_stats": variables["batch_stats"]})
    jprog, jmeta = jax_export.export_generator(MOD, jmcfg, jstate, SHAPE, platforms=("cpu",))
    jpath = str(root / "model.ubx")
    jax_export.save_exported(jprog, jmeta, jpath)
    return dict(root=root, sd=sd, path=path, meta=meta, jpath=jpath)


def test_round_trip_is_exact(twin):
    call, meta = export.load_exported(twin["path"], "cpu")
    assert meta == twin["meta"]
    assert meta["format"] == "unet_bssfp_tpu_torch.export" and meta["device"] == "cpu"
    assert meta["input_shape"] == list(SHAPE) and meta["modality"] == MOD
    assert meta["git"] == "test" and meta["torch_version"] == torch.__version__
    assert {k for k in meta if k != "git"} == {
        "format", "version", "modality", "input_shape", "in_dtype", "out_channels",
        "compute_dtype", "device", "torch_version"}
    with open(twin["path"], "rb") as f:
        assert f.read(8) == b"UBSSFPT1"
    x = torch.from_numpy(_x())
    got = call(x)
    gen, _ = build_models(MOD, MCFG, "cpu", state_dict=twin["sd"])
    want = make_predict_fn(gen)(x)
    assert got.shape == (*SHAPE[:4], 6) and got.dtype == torch.float32
    assert not got.requires_grad
    assert float((got - want).abs().max()) == 0.0


def test_the_program_holds_only_aten_ops(twin):
    """The plain layers only (``packed=False``, ``use_pallas=False``): no
    hand-written kernel's wrapper in the graph."""
    program = torch.export.load(io.BytesIO(export.read_exported(twin["path"])[1]))
    assert program.example_inputs is None  # the traced zeros are not saved
    targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert any("conv3d" in t for t in targets)
    assert all(t.startswith(("aten.", "<built-in")) for t in targets), targets


def _truncated(path, n):
    data = Path(path).read_bytes()
    return data[:n]


@pytest.mark.parametrize("case", ["junk", "jax", "no_length", "short_header"])
def test_a_file_not_the_ports_is_refused(twin, tmp_path, case):
    path = tmp_path / "bad.ubt"
    if case == "junk":
        path.write_bytes(b"NOTANEXPORT")
        match = "not a unet_bssfp_tpu_torch export"
    elif case == "jax":
        path = Path(twin["jpath"])  # the JAX package's real artifact
        match = "a JAX artifact .*UBSSFPX1.*python -m unet_bssfp_tpu_torch.export"
    elif case == "no_length":
        path.write_bytes(_truncated(twin["path"], 10))
        match = "missing header length"
    else:
        (hlen,) = struct.unpack("<I", Path(twin["path"]).read_bytes()[8:12])
        path.write_bytes(_truncated(twin["path"], 12 + hlen - 1))
        match = f"header {hlen - 1}/{hlen} bytes"
    with pytest.raises(ValueError, match=match):
        export.load_exported(str(path), "cpu")


def test_an_artifact_of_another_device_type_is_refused(twin, tmp_path):
    """An artifact whose header names the card is refused on the CPU (the
    program asserts its device type in its graph)."""
    program, meta = export.export_generator(MOD, MCFG, twin["sd"], SHAPE, device="cpu")
    meta["device"] = "cuda"
    path = str(tmp_path / "card.ubt")
    export.save_exported(program, meta, path)
    with pytest.raises(ValueError, match="re-export on the serving device"):
        export.load_exported(path, "cpu")


def test_artifact_matches_the_jax_artifact(twin):
    """The port's artifact against JAX's ``export_generator`` +
    ``load_exported`` (platform cpu) on the same weights and input."""
    x = _x()
    jcall, jmeta = jax_export.load_exported(twin["jpath"])
    ref = np.asarray(jcall(jnp.asarray(x)))
    call, meta = export.load_exported(twin["path"], "cpu")
    got = call(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)
    for k in ("modality", "input_shape", "in_dtype", "out_channels", "compute_dtype"):
        assert meta[k] == jmeta[k], k


def _config():
    return Config(data=DataConfig(patch_size=16, volume_shape=VOL),
                  model=ModelConfig(features=FEATURES, disc_features=DISC,
                                    compute_dtype="float32", dropout=0.0),
                  train=TrainConfig())


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A port checkpoint from ``CheckpointManager`` and a volume (15 × 16 ×
    14 × 24: padded to the artifact's 16³, the affine shifted)."""
    root = tmp_path_factory.mktemp("served")
    cfg = _config()
    mgr = ckpt.CheckpointManager(str(root / "ckpts" / f"{MOD}-20260101-000000"), top_k=1,
                                 config_json=cfg.to_json())
    mgr.save(0, create_gan_state(0, MOD, cfg.model, cfg.train, "cpu"), {"val_loss": 1.0})
    vol = str(root / "vol.nii.gz")
    affine = np.diag([1.5, 2.0, 2.5, 1.0])
    affine[:3, 3] = (10.0, -4.0, 7.0)
    save_volume(vol, _x((15, 16, 14, 24), 9), affine)
    return dict(root=root, cfg=cfg, step=mgr.best_path(), vol=vol)


def _run(args):
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    return subprocess.run([sys.executable, "-m", *args], check=True, env=env, timeout=600,
                          capture_output=True, text=True, cwd=str(REPO)).stdout


def test_cli_export_then_predict_exported_matches_the_checkpoint(served, tmp_path):
    """checkpoint → ``python -m unet_bssfp_tpu_torch.export --device cpu`` →
    ``predict --exported --device cpu`` (``--whole-volume`` ignored with a
    note; ``--scalar-maps``) → a NIfTI equal, within the model tolerance, to
    ``predict --checkpoint --whole-volume`` on the same volume, with the
    same affine."""
    art = str(tmp_path / "model.ubt")
    out = _run(["unet_bssfp_tpu_torch.export", "--checkpoint", served["step"], "--modality",
                MOD, "--out", art, "--device", "cpu"])
    assert f"wrote {art}" in out and "[1, 16, 16, 16, 24]" in out and "device cpu" in out
    meta, _ = export.read_exported(art)
    assert meta["checkpoint"] == os.path.abspath(served["step"]) and meta["git"]
    out = _run(["unet_bssfp_tpu_torch.predict", served["vol"], "--exported", art,
                "--device", "cpu", "--out-dir", str(tmp_path / "exported"),
                "--whole-volume", "--scalar-maps"])
    assert "note: --whole-volume is ignored with --exported" in out
    assert "(exported artifact, frozen input (16, 16, 16))" in out
    ref_path = predict_main([served["vol"], "--checkpoint", served["step"], "--whole-volume",
                             "--device", "cpu", "--out-dir", str(tmp_path / "checkpoint")])
    got, got_aff = load_volume(str(tmp_path / "exported" / os.path.basename(ref_path)))
    ref, ref_aff = load_volume(ref_path)
    assert got.shape == ref.shape == (*VOL, 6)
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_array_equal(got_aff, ref_aff)
    maps = [f for f in os.listdir(tmp_path / "exported") if not f.endswith("_pred-dt.nii.gz")]
    assert len(maps) == 7


@pytest.fixture(scope="module")
def artifacts(served):
    """Artifacts of the served checkpoint: batch 1 and batch 2, on 16³."""
    sd = ckpt.generator_state_dict(served["step"])
    out = {}
    for batch in (1, 2):
        program, meta = export.export_generator(MOD, served["cfg"].model, sd,
                                                (batch, *VOL, 24), device="cpu")
        out[batch] = str(served["root"] / f"b{batch}.ubt")
        export.save_exported(program, meta, out[batch])
    return out


REFUSALS = {
    "batch": (dict(batch=2), "frozen at batch=2.*re-export with --batch 1"),
    "modality": (dict(extra=["--modality", "bssfp"]),
                 "frozen for modality 'pc-bssfp', but --modality is 'bssfp'"),
    "channels": (dict(channels=6), "input has 6 channel\\(s\\).*frozen for 24-channel input"),
    "smaller": (dict(spatial=(20, 16, 16)),
                "input shape \\(16, 16, 16\\) is smaller than the volume \\(20, 16, 16\\)"),
    "mesh": (dict(extra=["--mesh", "1,2"]), "--mesh cannot split an exported artifact"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_predict_exported_refuses(served, artifacts, tmp_path, capsys, case):
    over, match = REFUSALS[case]
    vol = str(tmp_path / "v.nii.gz")
    save_volume(vol, _x((*over.get("spatial", VOL), over.get("channels", 24))))
    argv = [vol, "--exported", artifacts[over.get("batch", 1)], "--device", "cpu",
            "--out-dir", str(tmp_path / "o")] + over.get("extra", [])
    with pytest.raises(SystemExit) as exc:
        predict_main(argv)
    assert exc.value.code == 2
    assert re.search(match, capsys.readouterr().err), case
    assert not (tmp_path / "o").exists()
