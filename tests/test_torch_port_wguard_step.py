"""The ``wguard`` layout (``UNET_BSSFP_WGUARD=1``) in training, against the
JAX package on the CPU: the guarded generator's generator-phase gradients
(unsharded and on a (2, 2) mesh), one GAN step, and remat under the guards.
The modules' own tests are in ``test_torch_port_wguard_model.py``, the
steps on meshes in ``test_torch_port_wguard_sharded.py``; the widths,
batches and bounds are those of ``test_torch_port_train_grads.py`` and
``test_torch_port_train_step.py``. Dropout is 0 where JAX is held."""

import functools

import numpy as np
import pytest
import torch

import test_torch_port_train_grads as train_grads
from unet_bssfp_tpu_torch import weights
from unet_bssfp_tpu_torch.config import ModelConfig, TrainConfig
from unet_bssfp_tpu_torch.ops.losses import bce_with_logits, l1_loss
from unet_bssfp_tpu_torch.parallel.mesh import gather_batch, make_mesh, shard_batch
from unet_bssfp_tpu_torch.train.state import build_models, create_gan_state
from unet_bssfp_tpu_torch.train.steps import make_train_step
from test_torch_port_train_models import FEATURES, _cfgs
from test_torch_port_train_step import trajectory_matches_jax

torch.set_num_threads(1)

WGUARD = "UNET_BSSFP_WGUARD"


@pytest.fixture
def guarded(monkeypatch):
    monkeypatch.setenv(WGUARD, "1")


# --------------------------------------------------- generator-phase gradients
@functools.lru_cache(maxsize=None)
def _references():
    """``test_torch_port_train_grads``'s float64 ``jax.grad`` reference of
    the packed generator (its own cache, filled with the guards off) and the
    same traced with the guards on."""
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv(WGUARD, raising=False)
        plain = train_grads.jax_reference(True)
        mp.setenv(WGUARD, "1")
        return plain, train_grads.jax_reference.__wrapped__(True)


def _port_gradients(ref, mesh):
    """The guarded port's generator-phase backward (f32) on the reference's
    weights and batch, unsharded or on ``mesh``: (loss, {name: grad})."""
    x, y, gvars, dvars, _, _ = ref
    _, cfg = _cfgs(packed=True)
    gen, disc = build_models("pc-bssfp", cfg, "cpu", mesh=mesh)
    gen.load_state_dict(weights.from_flax(gvars["params"], gvars["batch_stats"]))
    disc.load_state_dict(weights.from_flax(dvars["params"], dvars["batch_stats"]))
    gen.train()
    disc.train()
    disc.requires_grad_(False)
    xt = torch.from_numpy(x)
    if mesh is None:
        y_hat = gen(xt)
        logits = disc(xt, y_hat)
    else:
        xs = shard_batch(mesh, xt)
        y_hat = gen(xs)
        logits, y_hat = gather_batch(disc(xs, y_hat)), gather_batch(y_hat)
    loss = (bce_with_logits(logits, torch.ones_like(logits))
            + l1_loss(y_hat, torch.from_numpy(y)) * TrainConfig().recon_factor)
    loss.backward()
    return float(loss.detach()), {n: p.grad.numpy() for n, p in gen.named_parameters()}


@pytest.mark.parametrize("mesh_shape", [None, (2, 2)], ids=["unsharded", "2x2"])
def test_generator_phase_gradients_with_guards_match_jax(monkeypatch, mesh_shape):
    """The guarded packed port's generator-phase gradients (f32) against the
    JAX package's float64 ``jax.grad``, every leaf to 1e-4 of its largest
    entry (a conv bias before a norm, true gradient 0, to 5e-5 of the net's
    largest), as ``test_torch_port_train_grads.py`` holds the unguarded
    port: against the float64 gradient of the same function traced without
    guards, and against the one traced with them within 1e-4 plus how far
    JAX's two float64 references lie apart (its guarded block takes the
    norm's moments in f32 as a sum less the guards' share, which moves its
    float64 gradient by up to 2.0e-3 of a leaf's largest entry); also on a
    (data, space) = (2, 2) mesh of CPU positions."""
    plain, guarded_ref = _references()
    monkeypatch.setenv(WGUARD, "1")
    mesh = None if mesh_shape is None else make_mesh(["cpu"] * 4, ("data", "space"), mesh_shape)
    loss, got = _port_gradients(plain, mesh)
    np.testing.assert_allclose(loss, plain[4], rtol=1e-5)
    assert got.keys() == plain[5].keys() == guarded_ref[5].keys()
    scale = max(float(np.abs(g).max()) for g in plain[5].values())
    for name, g in got.items():
        ref, gref = plain[5][name], guarded_ref[5][name]
        spread = float(np.abs(gref - ref).max())
        atol = 5e-5 * scale if name.endswith(".conv.bias") else 1e-4 * np.abs(ref).max()
        np.testing.assert_allclose(g, ref, rtol=0, atol=atol, err_msg=name)
        np.testing.assert_allclose(g, gref, rtol=0, atol=atol + spread, err_msg=name)


# ---------------------------------------------------------------- GAN steps
def test_train_step_with_guards_matches_jax(guarded):
    """One packed GAN step, both packages guarded, from the same weights and
    batch: the losses to 1e-3, the BatchNorm statistics after it."""
    trajectory_matches_jax(packed=True, n_steps=1)


def test_remat_with_guards_is_bit_equal_to_remat_off(guarded):
    """``ModelConfig.remat`` recomputes the packed stages in the backward with
    the guard count of their forward: one guarded step, dropout on, gives
    every parameter, buffer and the dropout generator bit for bit."""
    g = torch.Generator().manual_seed(8)
    x, y = torch.rand(1, 16, 16, 16, 24, generator=g), torch.rand(1, 16, 16, 16, 6, generator=g)
    out = []
    for remat in (False, True):
        cfg = ModelConfig(features=FEATURES, disc_features=(8, 16), compute_dtype="float32",
                          dropout=0.05, packed=True, remat=remat)
        state = create_gan_state(4, "pc-bssfp", cfg, TrainConfig(), "cpu")
        metrics = make_train_step(state.gen, state.disc, TrainConfig())(state, x, y)
        out.append((metrics, {**state.gen.state_dict(), **{
            f"disc.{k}": v for k, v in state.disc.state_dict().items()}},
            state.rng.get_state()))
    (ma, sa, ra), (mb, sb, rb) = out
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    assert torch.equal(ra, rb)
