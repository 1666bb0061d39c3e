"""The port's generator modules against the JAX package's, on the same
weights (converted by ``weights.from_flax``) and inputs, in float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_bssfp_tpu.config import ModelConfig as JaxModelConfig
from unet_bssfp_tpu.models.layers import UpCat as JaxUpCat
from unet_bssfp_tpu.train.state import build_models as jax_build_models
from unet_bssfp_tpu_torch import weights
from unet_bssfp_tpu_torch.config import ModelConfig
from unet_bssfp_tpu_torch.models.layers import UpCat
from unet_bssfp_tpu_torch.train.state import build_models
from unet_bssfp_tpu_torch.train.steps import make_predict_fn

torch.set_num_threads(1)

FEATURES = (8, 16, 16, 32, 32, 8)
# tests/test_pallas_conv3d.py's packed-vs-plain model tolerance.
TOL = dict(rtol=2e-4, atol=2e-5)


def random_variables(variables, seed):
    """Every leaf of a Flax variables tree replaced by seeded numpy values
    (so every parameter and statistic is exercised, not its init value)."""
    rng = np.random.default_rng(seed)

    def one(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        if leaf.ndim == 5:
            fan_in = int(np.prod(leaf.shape[:-1]))
            return z / np.sqrt(fan_in)
        if "var" in name:
            return 1.0 + 0.1 * np.abs(z)
        if "scale" in name:
            return 1.0 + 0.1 * z
        return 0.1 * z

    return jax.tree_util.tree_map_with_path(one, jax.tree.map(np.asarray, variables))


def _jax_generator(packed, use_pallas, x, seed=0):
    mcfg = JaxModelConfig(features=FEATURES, compute_dtype="float32",
                          dropout=0.0, packed=packed, use_pallas=use_pallas)
    gen, _ = jax_build_models("pc-bssfp", mcfg)
    variables = gen.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    return gen, random_variables(variables, seed)


def _port_generator(packed, use_pallas, variables):
    mcfg = ModelConfig(features=FEATURES, compute_dtype="float32", dropout=0.0,
                       packed=packed, use_pallas=use_pallas)
    sd = weights.from_flax(variables["params"], variables["batch_stats"])
    return build_models("pc-bssfp", mcfg, "cpu", state_dict=sd)[0]


CASES = [((1, 16, 16, 16, 24), packed, use_pallas)
         for packed in (False, True) for use_pallas in (False, True)]
# The bottleneck InstanceNorm sees 2³ voxels only from 32³ up.
CASES.append(((1, 32, 32, 32, 24), False, False))


@pytest.mark.parametrize("shape,packed,use_pallas", CASES)
def test_generator_matches_jax(shape, packed, use_pallas):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    gen, variables = _jax_generator(packed, use_pallas, x)
    ref = gen.apply(variables, jnp.asarray(x), train=False)
    port = _port_generator(packed, use_pallas, variables)
    assert port.unet.packed == packed
    got = make_predict_fn(port)(torch.from_numpy(x))
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_packed_and_plain_share_parameter_names():
    x = np.zeros((1, 16, 16, 16, 24), np.float32)
    _, variables = _jax_generator(False, False, x)
    plain = _port_generator(False, False, variables)
    packed = _port_generator(True, False, variables)
    assert ({k: v.shape for k, v in plain.state_dict().items()}
            == {k: v.shape for k, v in packed.state_dict().items()})


def test_upcat_edge_pads_to_odd_skip():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 3, 3, 3, 8)).astype(np.float32)
    skip = rng.standard_normal((1, 7, 6, 7, 4)).astype(np.float32)
    mod = JaxUpCat(4, 4, dropout=0.0, dtype=jnp.float32, use_fused=False)
    variables = random_variables(
        mod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(skip),
                 train=False), 6)
    ref = mod.apply(variables, jnp.asarray(x), jnp.asarray(skip), train=False)
    port = UpCat(8, 4, 4, 4)
    port.load_state_dict(weights.from_flax(variables["params"]), strict=True)
    with torch.inference_mode():
        got = port(torch.from_numpy(x), torch.from_numpy(skip))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_from_flax_consumes_every_leaf_once_and_rejects_unknown():
    x = np.zeros((1, 16, 16, 16, 24), np.float32)
    _, variables = _jax_generator(True, False, x)
    sd = weights.from_flax(variables["params"], variables["batch_stats"])
    n_leaves = len(jax.tree.leaves(variables))
    assert len(sd) == n_leaves
    bad = {"params": {"conv": {"kernel_typo": np.zeros(3)}}}["params"]
    with pytest.raises(KeyError):
        weights.from_flax(bad)


def test_npz_and_pt_round_trip(tmp_path):
    x = np.zeros((1, 16, 16, 16, 24), np.float32)
    _, variables = _jax_generator(False, False, x, seed=3)
    sd = weights.from_flax(variables["params"], variables["batch_stats"])
    flat = {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(variables)}
    npz = tmp_path / "w.npz"
    np.savez(npz, **flat)
    pt = tmp_path / "w.pt"
    weights.save(sd, str(pt))
    for loaded in (weights.load(str(npz)), weights.load(str(pt))):
        assert loaded.keys() == sd.keys()
        for k in sd:
            assert torch.equal(loaded[k], sd[k]), k


def test_build_models_rejects_missing_cuda_and_bad_modality():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build_models("pc-bssfp", ModelConfig(features=FEATURES))
    with pytest.raises(ValueError, match="modality"):
        build_models("flair", ModelConfig(features=FEATURES), "cpu")
