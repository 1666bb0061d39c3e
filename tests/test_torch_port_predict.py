"""The port's serving path (sampler, crop, NIfTI, predict_volume, CLI)
against the JAX package's, plus the port's import hygiene."""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_bssfp_tpu.config import ModelConfig as JaxModelConfig
from unet_bssfp_tpu.data import nifti as jax_nifti
from unet_bssfp_tpu.data.sampler import GridAggregator as JaxGridAggregator
from unet_bssfp_tpu.data.transforms import crop_or_pad as jax_crop_or_pad
from unet_bssfp_tpu.eval.inference import predict_volume as jax_predict_volume
from unet_bssfp_tpu.train.state import build_models as jax_build_models
from unet_bssfp_tpu_torch import weights
from unet_bssfp_tpu_torch.config import Config, ModelConfig
from unet_bssfp_tpu_torch.data import nifti
from unet_bssfp_tpu_torch.data.sampler import GridAggregator, extract_patches
from unet_bssfp_tpu_torch.data.transforms import crop_or_pad
from unet_bssfp_tpu_torch.eval.inference import predict_volume
from unet_bssfp_tpu_torch.train.state import build_models
from unet_bssfp_tpu_torch.train.steps import make_predict_fn
from test_torch_port_models import FEATURES, TOL, random_variables

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def models():
    """JAX and port generators (packed) on the same seeded weights."""
    x = np.zeros((1, 16, 16, 16, 24), np.float32)
    mcfg = JaxModelConfig(features=FEATURES, compute_dtype="float32",
                          dropout=0.0, packed=True)
    gen, _ = jax_build_models("pc-bssfp", mcfg)
    variables = random_variables(
        gen.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False), 9)
    port, _ = build_models(
        "pc-bssfp", ModelConfig(features=FEATURES, compute_dtype="float32",
                                dropout=0.0, packed=True), "cpu",
        state_dict=weights.from_flax(variables["params"],
                                     variables["batch_stats"]))
    jax_fn = jax.jit(lambda v, x_: gen.apply(v, x_, train=False))
    return jax_fn, variables, make_predict_fn(port)


@pytest.mark.parametrize("whole_volume", [False, True])
def test_predict_volume_matches_jax(models, whole_volume):
    jax_fn, variables, port_fn = models
    # D 24 with 16³ patches: two patches overlapping by 8 on D; whole, the
    # bottleneck's odd D makes upcat_4 edge-pad to its skip.
    vol = np.random.default_rng(2).standard_normal((24, 16, 16, 24)).astype(np.float32)
    ref = jax_predict_volume(jax_fn, variables, jnp.asarray(vol), patch_size=16,
                             batch_size=2, whole_volume=whole_volume)
    got = predict_volume(port_fn, torch.from_numpy(vol), patch_size=16,
                         batch_size=2, whole_volume=whole_volume)
    assert got.shape == (24, 16, 16, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("mode", ["average", "overwrite"])
def test_grid_aggregator_matches_jax(mode):
    shape, p, c = (40, 24, 20), 16, 3
    rng = np.random.default_rng(4)
    vol = rng.standard_normal(shape + (c,)).astype(np.float32)
    jagg = JaxGridAggregator(shape, c, p, mode=mode)
    agg = GridAggregator(shape, c, p, mode=mode)
    np.testing.assert_array_equal(agg.starts, np.asarray(jagg.starts))
    patches = extract_patches(torch.from_numpy(vol), agg.starts, p)
    patches = patches + torch.from_numpy(
        rng.standard_normal(patches.shape).astype(np.float32))
    ref = jagg.stitch(jnp.asarray(patches.numpy()))
    np.testing.assert_allclose(agg.stitch(patches).numpy(), np.asarray(ref),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("src", [(90, 130, 127), (97, 128, 129), (96, 128, 128)])
def test_crop_or_pad_matches_jax_exactly(src):
    vol = np.random.default_rng(3).standard_normal(src + (2,)).astype(np.float32)
    ref = jax_crop_or_pad(jnp.asarray(vol), (96, 128, 128))
    got = crop_or_pad(torch.from_numpy(vol), (96, 128, 128))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_nifti_round_trips_across_packages(tmp_path):
    rng = np.random.default_rng(8)
    vol = rng.standard_normal((5, 6, 7, 3)).astype(np.float32)
    affine = np.array([[1.5, 0, 0, -10], [0, 2.0, 0, 4], [0, 0, 1.0, 2.5],
                       [0, 0, 0, 1]])
    path = str(tmp_path / "port.nii.gz")
    nifti.save_volume(path, vol, affine)
    data, aff = jax_nifti.load_volume(path)
    np.testing.assert_array_equal(data, vol)
    np.testing.assert_allclose(aff, affine, rtol=1e-6)
    path2 = str(tmp_path / "jax.nii")
    jax_nifti.save_volume(path2, vol[..., 0], affine)
    data2, aff2 = nifti.load_volume(path2)
    np.testing.assert_array_equal(data2, vol[..., :1])
    np.testing.assert_allclose(nifti.load_affine(path2), aff2)


def test_predict_cli_on_cpu(tmp_path, capsys):
    from unet_bssfp_tpu_torch.predict import main

    rng = np.random.default_rng(12)
    src = rng.standard_normal((20, 16, 18, 24)).astype(np.float32)
    affine = np.diag([2.0, 2.0, 2.0, 1.0])
    inp = str(tmp_path / "sub-01_bssfp.nii.gz")
    nifti.save_volume(inp, src, affine)
    cfg = Config.from_json(
        '{"data": {"volume_shape": [24, 16, 16], "patch_size": 16},'
        ' "model": {"features": [8, 16, 16, 32, 32, 8],'
        ' "compute_dtype": "float32"}}')
    (tmp_path / "cfg.json").write_text(cfg.to_json())
    gen, _ = build_models("pc-bssfp", cfg.model, "cpu")
    sd = weights.random_state_dict(gen, 0)
    weights.save(sd, str(tmp_path / "w.pt"))

    out = main([inp, "--weights", str(tmp_path / "w.pt"), "--config",
                str(tmp_path / "cfg.json"), "--out-dir", str(tmp_path / "o"),
                "--device", "cpu", "--patch"])
    assert "patch-stitched" in capsys.readouterr().out
    pred, aff = nifti.load_volume(out)
    assert pred.shape == (24, 16, 16, 6) and np.isfinite(pred).all()
    # pad 20→24 on D shifts by -2 voxels, crop 18→16 on W by +1.
    np.testing.assert_allclose(aff[:3, 3], [-4.0, 0.0, 2.0])
    gen.load_state_dict(sd)
    vol = crop_or_pad(torch.from_numpy(src), (24, 16, 16))
    ref = predict_volume(make_predict_fn(gen), vol, patch_size=16)
    np.testing.assert_allclose(pred, ref.numpy(), rtol=1e-6, atol=1e-6)


FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "unet_bssfp_tpu"}


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_or_jax_package():
    files = sorted((REPO / "unet_bssfp_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    bad = {f"{f.relative_to(REPO)}: {root}" for f in files
           for root in _imported_roots(f) if root in FORBIDDEN}
    assert not bad, sorted(bad)
