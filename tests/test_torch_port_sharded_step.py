"""The port's sharded training step (train-mode BatchNorm over the global
batch, the discriminator's k4 s2 convs under a d split, the GAN train and
eval steps on a mesh, ``ddp_parity``) against its unsharded self in float64
and against the JAX package's mesh steps, on the CPU.

Eight mesh positions on the CPU stand where the JAX package has 8 virtual
CPU devices (``tests/conftest.py``). The port refuses a volume whose D is no
multiple of 16·n_space, so the batch is 8 × 32 × 16 × 16 (D 32) for every
mesh, where the JAX package's own mesh tests take 16³. Dropout is 0: the
port draws a mask per shard in position order, JAX one global mask
(``ROADMAP.md`` §3)."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_bssfp_tpu.config import ModelConfig as JaxModelConfig, TrainConfig as JaxTrainConfig
from unet_bssfp_tpu.parallel.mesh import make_mesh as jax_make_mesh, shard_batch as jax_shard
from unet_bssfp_tpu.train.state import build_models as jax_build_models
from unet_bssfp_tpu.train.state import GANTrainState as JaxGANTrainState
from unet_bssfp_tpu.train.state import make_optimizer as jax_make_optimizer
from unet_bssfp_tpu.train.steps import (
    make_eval_step as jax_make_eval_step,
    make_train_step as jax_make_train_step,
)
from unet_bssfp_tpu_torch import weights
from unet_bssfp_tpu_torch.config import ModelConfig, TrainConfig
from unet_bssfp_tpu_torch.models.discriminator import Discriminator
from unet_bssfp_tpu_torch.models.generator import Generator
from unet_bssfp_tpu_torch.models.layers import BatchNorm, ConvBlock, row_moments
from unet_bssfp_tpu_torch.ops.losses import bce_with_logits, l1_loss
from unet_bssfp_tpu_torch.parallel.mesh import (
    AXES,
    Mesh,
    Sharded,
    broadcast,
    gather_batch,
    gather_rows,
    make_mesh,
    shard_batch,
)
from unet_bssfp_tpu_torch.train.state import create_gan_state
from unet_bssfp_tpu_torch.train.steps import make_eval_step, make_train_step

torch.set_num_threads(1)
CPU8 = ["cpu"] * 8
FEATURES = (4, 8, 8, 16, 16, 4)
DISC_FEATURES = (8, 8, 16)
SHAPE = (8, 32, 16, 16)
# lr 3e-5 as tests/test_torch_port_train_step.py: early AdamW is close to
# sign descent, so at 1e-3 a near-zero gradient whose sign the two
# summation orders flip moves a weight by 2·lr, and the discriminator
# phase (which sees the updated generator) drifts with it
LR = 3e-5
MESHES = {"8": (("data",), (8,)), "4x2": (("data", "space"), (4, 2))}


def _mesh(name):
    axes, shape = MESHES[name]
    return make_mesh(CPU8, axes, shape)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random(SHAPE + (24,), dtype=np.float32),
            rng.random(SHAPE + (6,), dtype=np.float32))


def _f64_models(packed=False):
    """The generator and discriminator in float64 (no compute dtype: every
    module computes in its input's), seeded random weights."""
    gen = Generator("pc-bssfp", features=FEATURES, dropout=0.0, packed=packed).double()
    disc = Discriminator("pc-bssfp", features=DISC_FEATURES).double()
    gen.load_state_dict(weights.random_state_dict(gen, 3))
    disc.load_state_dict(weights.random_state_dict(disc, 4))
    return gen, disc


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


# ------------------------------------------------------- the mesh's new parts
def test_all_sum_over_both_axes_is_the_same_bits_everywhere():
    mesh = _mesh("4x2")
    x = Sharded(mesh, [[torch.tensor([float(3 ** (2 * i + j)) / 7]) for j in range(2)]
                       for i in range(4)])
    total = x.all_sum(AXES)
    want = sum(x.parts[i][j] for i in range(4) for j in range(2))
    assert all(torch.equal(t, want) for row in total.parts for t in row)
    rows = x.all_sum("space")
    assert torch.equal(rows.parts[2][1], x.parts[2][0] + x.parts[2][1])
    with pytest.raises(ValueError, match="unknown mesh axis"):
        x.all_sum(("data", "time"))


# ----------------------------------------------------------------- BatchNorm
@pytest.mark.parametrize("mesh_shape", [(4, 2), (8, 1)])
def test_batchnorm_train_on_a_mesh_matches_unsharded_in_float64(mesh_shape):
    """Forward, backward (x, scale, bias) and the running statistics after
    1 and 3 forwards: one update per forward, as unsharded."""
    mesh = make_mesh(CPU8, ("data", "space"), mesh_shape)
    g = torch.Generator().manual_seed(1)
    ref_bn = BatchNorm(5).double().train()
    with torch.no_grad():
        ref_bn.weight.normal_(generator=g)
        ref_bn.bias.normal_(generator=g)
    bn = copy.deepcopy(ref_bn)
    for n in range(3):
        x = (torch.randn(8, 4, 3, 3, 5, generator=g, dtype=torch.float64) * 3 + n)
        up = torch.randn(x.shape, generator=g, dtype=torch.float64)
        xa, xb = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
        ya, yb = ref_bn(xa), gather_batch(bn(shard_batch(mesh, xb)))
        np.testing.assert_allclose(yb.detach().numpy(), ya.detach().numpy(), rtol=0, atol=1e-12)
        ref_bn.zero_grad(set_to_none=True)
        bn.zero_grad(set_to_none=True)
        (ya * up).sum().backward()
        (yb * up).sum().backward()
        for a, b in ((xa.grad, xb.grad), (ref_bn.weight.grad, bn.weight.grad),
                     (ref_bn.bias.grad, bn.bias.grad)):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-12, atol=1e-12)
        if n in (0, 2):  # after 1 and after 3 forwards
            for name in ("running_mean", "running_var"):
                np.testing.assert_allclose(getattr(bn, name).numpy(),
                                           getattr(ref_bn, name).numpy(), rtol=1e-12,
                                           atol=1e-14, err_msg=name)


def test_batchnorm_row_moments_per_data_row_and_mean_update():
    """ddp_parity: each data row normalised by its own moments (its space
    shards together); the running statistics take the mean over rows of
    each row's update (JAX's pmean of batch_stats)."""
    mesh = _mesh("4x2")
    g = torch.Generator().manual_seed(2)
    x = torch.randn(8, 4, 3, 3, 5, generator=g, dtype=torch.float64) * 2
    x[4:] += 3.0  # rows with other moments
    bn = BatchNorm(5).double().train()
    rows = [copy.deepcopy(bn) for _ in range(4)]
    with row_moments():
        got = gather_rows(bn(shard_batch(mesh, x)))
    for i, (row_bn, y) in enumerate(zip(rows, got)):
        np.testing.assert_allclose(y.detach().numpy(),
                                   row_bn(x[2 * i:2 * i + 2]).detach().numpy(),
                                   rtol=0, atol=1e-12)
    for name in ("running_mean", "running_var"):
        want = sum(getattr(r, name) for r in rows) / 4
        np.testing.assert_allclose(getattr(bn, name).numpy(), want.numpy(), rtol=1e-12,
                                   err_msg=name)
    # equal rows: the mean of the rows' means is the global mean, but the
    # mean of their variances lacks the spread between the rows
    glob = BatchNorm(5).double().train()
    glob(shard_batch(mesh, x))
    assert torch.allclose(glob.running_mean, bn.running_mean, rtol=1e-12)
    assert bool((glob.running_var > bn.running_var + 1e-3).all())


# ---------------------------------------------- the k4 s2 conv, the discriminator
def test_k4s2_convblock_and_discriminator_on_a_space_split_in_float64():
    mesh = _mesh("4x2")
    g = torch.Generator().manual_seed(3)
    block = ConvBlock(6, 8).double().train()
    block.load_state_dict(weights.random_state_dict(block, 5))
    x = torch.randn(8, 16, 8, 8, 6, generator=g, dtype=torch.float64)
    _, disc = _f64_models()
    disc.train()
    xv = torch.randn(8, 16, 16, 16, 24, generator=g, dtype=torch.float64)
    yv = torch.randn(8, 16, 16, 16, 6, generator=g, dtype=torch.float64)
    for module, inputs in ((block, (x,)), (disc, (xv, yv))):
        twin = copy.deepcopy(module)
        ins_a = [t.clone().requires_grad_(True) for t in inputs]
        ins_b = [t.clone().requires_grad_(True) for t in inputs]
        ya = module(*ins_a)
        yb = gather_batch(twin(*(shard_batch(mesh, t) for t in ins_b)))
        assert yb.shape == ya.shape
        np.testing.assert_allclose(yb.detach().numpy(), ya.detach().numpy(), rtol=0,
                                   atol=1e-12)
        up = torch.randn(ya.shape, generator=g, dtype=torch.float64)
        (ya * up).sum().backward()
        (yb * up).sum().backward()
        for a, b in zip(ins_a, ins_b):
            assert _rel(b.grad, a.grad) < 1e-12
        scale = max(float(p.grad.abs().max()) for p in module.parameters())
        for (name, p), q in zip(module.named_parameters(), twin.parameters()):
            if name.endswith("conv.bias") and not name.startswith("d1_"):
                # a conv bias before a BatchNorm: true gradient 0, the
                # remainder cancellation noise of either summation order
                assert float((q.grad - p.grad).abs().max()) <= 1e-12 * scale, name
            else:
                assert _rel(q.grad, p.grad) < 1e-12, name
        for (name, b1), b2 in zip(module.named_buffers(), twin.buffers()):
            np.testing.assert_allclose(b2.numpy(), b1.numpy(), rtol=1e-12, atol=1e-14,
                                       err_msg=name)


def test_k4s2_conv_refuses_an_odd_local_d():
    mesh = make_mesh(["cpu"], ("data", "space"), (1, 2))
    block = ConvBlock(6, 8)
    with pytest.raises(ValueError, match=r"\(1, 6, 8, 8, 6\).*local D 3 is odd"):
        block(shard_batch(mesh, torch.zeros(1, 6, 8, 8, 6)))
    # five blocks on 64³ allow space ≤ 2: the fifth block's shard would have D 1
    disc = Discriminator("pc-bssfp", features=(4, 4, 4, 4, 4))
    four = make_mesh(["cpu"], ("data", "space"), (1, 4))
    xs = shard_batch(four, torch.zeros(1, 64, 32, 32, 24))
    with pytest.raises(ValueError, match="local D 1 is odd"):
        disc(xs, shard_batch(four, torch.zeros(1, 64, 32, 32, 6)))
    with pytest.raises(ValueError, match="too small"):
        disc(shard_batch(mesh, torch.zeros(1, 16, 32, 32, 24)),
             shard_batch(mesh, torch.zeros(1, 16, 32, 32, 6)))


# ------------------------------------------- generator-phase gradients, f64
@pytest.mark.parametrize("packed", [False, True])
def test_sharded_generator_phase_gradients_match_unsharded_in_float64(packed):
    """BCE(D(x, G(x)), 1) + L1·rf on mesh (4, 2) against the same loss
    unsharded: every generator leaf to 1e-9 relative L2; a conv bias
    before a norm (true gradient 0: cancellation noise either side) to
    1e-9 of the net's largest gradient. The head's and the discriminator's
    BatchNorms run in train mode; their statistics after it agree too."""
    mesh = _mesh("4x2")
    gen, disc = _f64_models(packed)
    x, y = (torch.from_numpy(a).double() for a in _batch(5))
    rf = TrainConfig().recon_factor

    def grads(sharded):
        g, d = copy.deepcopy(gen).train(), copy.deepcopy(disc).train()
        d.requires_grad_(False)
        if sharded:
            xs = shard_batch(mesh, x)
            y_hat = g(xs)
            logits, y_hat = gather_batch(d(xs, y_hat)), gather_batch(y_hat)
        else:
            y_hat = g(x)
            logits = d(x, y_hat)
        loss = bce_with_logits(logits, torch.ones_like(logits)) + l1_loss(y_hat, y) * rf
        loss.backward()
        stats = {**{f"g.{k}": v for k, v in g.named_buffers()},
                 **{f"d.{k}": v for k, v in d.named_buffers()}}
        return float(loss.detach()), {n: p.grad for n, p in g.named_parameters()}, stats

    (la, ga, sa), (lb, gb, sb) = grads(False), grads(True)
    assert lb == pytest.approx(la, rel=1e-12)
    scale = max(float(v.abs().max()) for v in ga.values())
    for name, ref in ga.items():
        if name.endswith(".conv.bias"):
            assert float((gb[name] - ref).abs().max()) <= 1e-9 * scale, name
        else:
            assert _rel(gb[name], ref) <= 1e-9, name
    for name, ref in sa.items():
        np.testing.assert_allclose(sb[name].numpy(), ref.numpy(), rtol=1e-12, atol=1e-14,
                                   err_msg=name)


# ------------------------------------------------ the GAN step against JAX
def _jax_state(jgen, jdisc, jtcfg, seed):
    """The JAX package's initial state, its inits jitted."""
    x, y = (np.zeros((1,) + SHAPE[1:] + (c,), np.float32) for c in (24, 6))
    k_gen, k_disc, k_state = jax.random.split(jax.random.PRNGKey(seed), 3)
    gv = jax.jit(jgen.init, static_argnames="train")(k_gen, x, train=False)
    dv = jax.jit(jdisc.init, static_argnames="train")(k_disc, x, y, train=False)
    opt = jax_make_optimizer(jtcfg)
    return JaxGANTrainState(
        step=jnp.zeros((), jnp.int32), rng=k_state,
        gen_params=gv["params"], gen_batch_stats=gv["batch_stats"],
        disc_params=dv["params"], disc_batch_stats=dv["batch_stats"],
        gen_opt_state=opt.init(gv["params"]), disc_opt_state=opt.init(dv["params"]))


@pytest.fixture(scope="module")
def jax_setup():
    assert len(jax.devices()) == 8, "conftest must provision 8 CPU devices"
    jcfg = JaxModelConfig(features=FEATURES, disc_features=DISC_FEATURES,
                          compute_dtype="float32", dropout=0.0, folded=False, packed=False)
    jtcfg = JaxTrainConfig(lr=LR)
    jgen, jdisc = jax_build_models("pc-bssfp", jcfg)
    return jgen, jdisc, jtcfg, _jax_state(jgen, jdisc, jtcfg, 11)


def _jax_mesh(name):
    axes, shape = MESHES[name]
    return jax_make_mesh(8, axes=axes, shape=shape)


def _run_jax(jax_setup, name, ddp_parity=False):
    jgen, jdisc, jtcfg, jstate = jax_setup
    mesh = _jax_mesh(name)
    step = jax_make_train_step(jgen, jdisc, jtcfg, mesh=mesh, donate=False,
                               ddp_parity=ddp_parity)
    x, y = _batch()
    batch = jax_shard(mesh, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    new, metrics = step(jstate, batch["x"], batch["y"])
    stats = {k: jax.tree.map(np.asarray, getattr(new, k))
             for k in ("gen_batch_stats", "disc_batch_stats")}
    return {k: float(v) for k, v in metrics.items()}, stats


@pytest.fixture(scope="module")
def jax_steps(jax_setup):
    """The JAX package's step on (8,), on (4, 2), and with ddp_parity on
    (8,): its metrics and BatchNorm statistics after the step."""
    return {"8": _run_jax(jax_setup, "8"), "4x2": _run_jax(jax_setup, "4x2"),
            "ddp": _run_jax(jax_setup, "8", ddp_parity=True)}


def _port_state(jstate, mesh, packed):
    cfg = ModelConfig(features=FEATURES, disc_features=DISC_FEATURES,
                      compute_dtype="float32", dropout=0.0, packed=packed)
    state = create_gan_state(0, "pc-bssfp", cfg, TrainConfig(lr=LR), "cpu", mesh=mesh)
    weights.state_from_flax(state.gen, state.disc, {
        k: jax.tree.map(np.asarray, getattr(jstate, k))
        for k in ("gen_params", "gen_batch_stats", "disc_params", "disc_batch_stats")})
    broadcast(state.gen)  # into the replicas, on a mesh over several devices
    broadcast(state.disc)
    return state


def _stats(stats):
    """JAX's BatchNorm statistics under the port's names."""
    return {**weights.from_flax({}, stats["gen_batch_stats"]),
            **{f"disc.{k}": v for k, v in
               weights.from_flax({}, stats["disc_batch_stats"]).items()}}


def _port_stats(state):
    return {**state.gen.state_dict(),
            **{f"disc.{k}": v for k, v in state.disc.state_dict().items()}}


def _check_against_jax(state, got, ref, ref_8):
    """The metrics against JAX's step on the same mesh (1e-4 relative, the
    discriminator loss 1e-2: tests/test_space_axis.py:70-71); the
    BatchNorm statistics within 1e-5 of JAX's step on (8,) and of JAX's on
    the same mesh, plus, for the latter, how far JAX's own two meshes lie
    apart (2.3e-5 on (4, 2), measured: JAX's space-sharded step rounds
    otherwise; the port's meshes lie within 5e-6 of each other). Within
    1e-5 at all: the conv bias before each BatchNorm has true gradient 0,
    so AdamW moves it by ±lr with the sign of either side's rounding noise,
    and the second forward's batch statistics with it."""
    metrics, stats = ref
    assert got.keys() == metrics.keys()
    for k, r in metrics.items():
        tol = 1e-2 if k == "train_discr_loss" else 1e-4
        assert float(got[k]) == pytest.approx(r, rel=tol, abs=1e-5), k
    want, want_8, have = _stats(stats), _stats(ref_8[1]), _port_stats(state)
    assert want.keys() == want_8.keys() and len(want) == 2 + 2 * (len(DISC_FEATURES) - 1)
    spread = max(float((want[k] - want_8[k]).abs().max()) for k in want)
    for name in want:
        got_stat = have[name].numpy()
        np.testing.assert_allclose(got_stat, want_8[name].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
        np.testing.assert_allclose(got_stat, want[name].numpy(), rtol=1e-5,
                                   atol=1e-5 + spread, err_msg=name)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("name", ["8", "4x2"])
def test_sharded_train_step_matches_jax_mesh_step(jax_setup, jax_steps, name, packed):
    """One GAN step on the mesh, whole batches given (the step shards them),
    against the JAX package's ``make_train_step(mesh=…)``."""
    mesh = _mesh(name)
    state = _port_state(jax_setup[3], mesh, packed)
    step = make_train_step(state.gen, state.disc, TrainConfig(lr=LR), mesh=mesh)
    x, y = _batch()
    got = step(state, torch.from_numpy(x), torch.from_numpy(y))
    assert state.step == 1
    _check_against_jax(state, got, jax_steps[name], jax_steps["8"])


def test_ddp_parity_matches_jax_and_differs_from_global(jax_setup, jax_steps):
    mesh = _mesh("8")
    state = _port_state(jax_setup[3], mesh, packed=False)
    step = make_train_step(state.gen, state.disc, TrainConfig(lr=LR), mesh=mesh,
                           ddp_parity=True)
    x, y = _batch()
    # the step takes batches already split over its mesh, too
    got = step(state, shard_batch(mesh, torch.from_numpy(x)),
               shard_batch(mesh, torch.from_numpy(y)))
    _check_against_jax(state, got, jax_steps["ddp"], jax_steps["ddp"])
    glob = jax_steps["8"][0]
    assert float(got["train_discr_loss"]) != glob["train_discr_loss"]
    # per-row moments: the statistics differ from global mode's
    have, glob_stats = _port_stats(state), _stats(jax_steps["8"][1])
    assert any(not np.allclose(have[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-4)
               for k, v in glob_stats.items())


def test_ddp_parity_needs_a_mesh_and_a_batch_its_mesh_splits():
    cfg = ModelConfig(features=FEATURES, disc_features=DISC_FEATURES, compute_dtype="float32")
    state = create_gan_state(0, "pc-bssfp", cfg, TrainConfig(), "cpu")
    with pytest.raises(ValueError, match="ddp_parity requires a mesh"):
        make_train_step(state.gen, state.disc, TrainConfig(), ddp_parity=True)
    step = make_train_step(state.gen, state.disc, TrainConfig())
    xs = shard_batch(_mesh("8"), torch.zeros(SHAPE + (24,)))
    with pytest.raises(ValueError, match="needs the step built with its mesh"):
        step(state, xs, xs)
    other = make_train_step(state.gen, state.disc, TrainConfig(), mesh=_mesh("4x2"))
    with pytest.raises(ValueError, match="given to a step on"):
        other(state, xs, xs)


def test_sharded_eval_step_matches_jax_mesh_eval_step(jax_setup):
    jgen, jdisc, jtcfg, jstate = jax_setup
    jmesh = _jax_mesh("4x2")
    x, y = _batch(7)
    batch = jax_shard(jmesh, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
    ref, ref_hat = jax_make_eval_step(jgen, jdisc, jtcfg, mesh=jmesh)(
        jstate, batch["x"], batch["y"])
    mesh = _mesh("4x2")
    state = _port_state(jstate, mesh, packed=True)
    got, y_hat = make_eval_step(state.gen, state.disc, TrainConfig(lr=LR), mesh=mesh)(
        state, torch.from_numpy(x), torch.from_numpy(y))
    assert got.keys() == ref.keys()
    assert tuple(y_hat.shape) == SHAPE + (6,)
    np.testing.assert_allclose(y_hat.numpy(), np.asarray(ref_hat), rtol=2e-4, atol=2e-5)
    for k in ref:
        assert float(got[k]) == pytest.approx(float(ref[k]), rel=1e-5, abs=1e-6), k
    # and the port's own unsharded eval step on the same state
    flat = _port_state(jstate, None, packed=True)
    own, _ = make_eval_step(flat.gen, flat.disc, TrainConfig(lr=LR))(
        flat, torch.from_numpy(x), torch.from_numpy(y))
    for k in own:
        assert float(got[k]) == pytest.approx(float(own[k]), rel=1e-5, abs=1e-7), k


# ------------------------------------------------------------ remat, refusals
def test_remat_on_a_mesh_is_bit_equal_to_remat_off():
    """ModelConfig.remat on a (4, 2) mesh, dropout on: every parameter,
    buffer and the dropout generator bit-equal after one step."""
    mesh = _mesh("4x2")
    x, y = (torch.from_numpy(a) for a in _batch(9))
    out = []
    for remat in (False, True):
        cfg = ModelConfig(features=FEATURES, disc_features=DISC_FEATURES,
                          compute_dtype="float32", dropout=0.05, packed=True, remat=remat)
        state = create_gan_state(4, "pc-bssfp", cfg, TrainConfig(), "cpu", mesh=mesh)
        metrics = make_train_step(state.gen, state.disc, TrainConfig(), mesh=mesh)(state, x, y)
        out.append((metrics, {**state.gen.state_dict(), **{
            f"disc.{k}": v for k, v in state.disc.state_dict().items()}},
            state.rng.get_state()))
    (ma, sa, ra), (mb, sb, rb) = out
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    assert torch.equal(ra, rb)


def test_a_training_mesh_over_two_devices_raises():
    """What the steps still refuse on a mesh over two devices (the host
    twice, ``cpu`` and ``cpu:0``: two replicas): models without a replica on
    the mesh's second device, models whose master lies on another device
    than the mesh's first, and ``use_pallas`` on more than one position."""
    cpu, cpu0 = torch.device("cpu"), torch.device("cpu", 0)
    two = Mesh([[cpu, cpu0]] * 4, ("data", "space"))
    cfg = ModelConfig(features=FEATURES, disc_features=DISC_FEATURES, compute_dtype="float32")
    state = create_gan_state(0, "pc-bssfp", cfg, TrainConfig(), "cpu", mesh=_mesh("4x2"))
    for build in (make_train_step, make_eval_step):
        with pytest.raises(ValueError, match=r"Generator has no replica on cpu:0 of Mesh"):
            build(state.gen, state.disc, TrainConfig(), mesh=two)
    flipped = Mesh([[cpu0, cpu]] * 4, ("data", "space"))
    state = create_gan_state(0, "pc-bssfp", cfg, TrainConfig(), "cpu", mesh=flipped)
    for build in (make_train_step, make_eval_step):
        with pytest.raises(ValueError, match="lies on cpu, not on the first device of"):
            build(state.gen, state.disc, TrainConfig(), mesh=two)
    pallas = dataclasses.replace(cfg, use_pallas=True)
    with pytest.raises(ValueError, match="use_pallas on Mesh"):
        create_gan_state(0, "pc-bssfp", pallas, TrainConfig(), "cpu", mesh=two)


def test_steps_refuse_models_built_elsewhere():
    cfg = ModelConfig(features=FEATURES, disc_features=DISC_FEATURES, compute_dtype="float32")
    state = create_gan_state(0, "pc-bssfp", cfg, TrainConfig(), "cpu")
    meta = Mesh([[torch.device("meta")]], ("data",))
    with pytest.raises(ValueError, match="lies on cpu"):
        make_train_step(state.gen, state.disc, TrainConfig(), mesh=meta)


# ------------------------------------------------ the wgmma plans at the shards
GAN_CONVS = ((24, 32), (32, 32), (96, 32), (32, 32))
THESIS_CONVS = ((24, 48), (48, 48), (144, 24), (24, 24))


@pytest.mark.parametrize("mesh_shape", [(2, 1), (2, 2), (1, 2), (8, 1), (4, 2)])
@pytest.mark.parametrize("convs", [GAN_CONVS, THESIS_CONVS], ids=["gan", "thesis"])
def test_wgmma_plans_take_every_shard_of_the_training_step(mesh_shape, convs):
    """A batch of 8 × 64³ on ``mesh_shape``: each full-resolution conv's
    forward (K1, or K5 on D + 2 → D), its dgrad (K1's, or K5-dgrad on D →
    D + 2) and its weight gradient (K2 or K5-wgrad) at the shard's shape
    have a wgmma plan (none routes to the mma.sync loops) that covers every
    output slice."""
    from unet_bssfp_tpu_torch.ops.kernels import conv_wgmma, wgrad_wgmma

    b, d = 8 // mesh_shape[0], 64 // mesh_shape[1]
    halo = int(mesh_shape[1] > 1)
    for cin, cout in convs:
        fwd = conv_wgmma.wgmma_plan(b, d + 2 * halo, d, halo, cin, cout, 64, 64)
        dgrad = conv_wgmma.wgmma_plan(b, d, d + 2 * halo, -halo, cout, cin, 64, 64)
        wgrad = wgrad_wgmma.wgrad_plan(b, d, halo, cin, cout, 64, 64)
        for plan, dout in ((fwd, d), (dgrad, d + 2 * halo)):
            assert plan is not None and plan.smem <= conv_wgmma.SMEM_LIMIT
            assert plan.seg_len * plan.segments >= dout > plan.seg_len * (plan.segments - 1)
        assert wgrad is not None and wgrad.smem <= wgrad_wgmma.SMEM_LIMIT
        assert wgrad.splits * wgrad.per >= wgrad.items == b * d * 32
