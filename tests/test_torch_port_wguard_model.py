"""The ``wguard`` layout on the model side (``UNET_BSSFP_WGUARD=1``) against
the JAX package's, on the CPU: ``guard_cols``, the guarded packed conv
block and pool, the packed generator and MultiInputUNet, K2W (the weight
gradient on guard-stripped operands) and the weights; the gradients and
the steps are in ``test_torch_port_wguard_step.py``. The variable goes to both
packages (each reads it when it builds or traces a forward); dropout is 0;
the widths are ``tests/test_torch_port_train_models.py``'s. A 32³ patch
takes g = 4 (row width 36), a 16³ one g = 8 (row width 24). With the
variable unset, or "0", nothing changes."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_bssfp_tpu.config import ModelConfig as JaxModelConfig
from unet_bssfp_tpu.models.multi_input_unet import MultiInputUNet as JaxMultiInputUNet
from unet_bssfp_tpu.models.packed_layers import (
    PackedConvNormAct as JaxPackedConvNormAct,
    guard_cols as jax_guard_cols,
    packed_max_pool2 as jax_packed_max_pool2,
)
from unet_bssfp_tpu.ops.pallas.conv3d import (
    conv3x3_packed as jax_conv3x3_packed,
    conv3x3_packed_halo as jax_conv3x3_packed_halo,
)
from unet_bssfp_tpu.train.state import build_models as jax_build_models
from unet_bssfp_tpu_torch import weights
from unet_bssfp_tpu_torch.config import ModelConfig
from unet_bssfp_tpu_torch.models.packed_layers import (
    PackedConvNormAct,
    guard_cols,
    packed_max_pool2,
)
from unet_bssfp_tpu_torch.ops import kernels as K
from unet_bssfp_tpu_torch.train.multistage import build_multi_input_unet
from unet_bssfp_tpu_torch.train.state import build_models
from unet_bssfp_tpu_torch.train.steps import make_predict_fn
from test_torch_port_models import random_variables
from test_torch_port_train_models import FEATURES, PATCH, TOL

torch.set_num_threads(1)

WGUARD = "UNET_BSSFP_WGUARD"
# (patch edge, g): PATCH 32 → row width 36; a 16³ patch → row width 24
SIZES = [(PATCH, 4), (16, 8)]


@pytest.fixture
def guarded(monkeypatch):
    monkeypatch.setenv(WGUARD, "1")


def _rows(t, wdim):
    return t.reshape(*t.shape[:-1], -1, wdim)


def _guarded_input(rng, b, d, c, h, w, g, scale=1.0):
    x = (rng.standard_normal((b, d, c, h, w + g)) * scale).astype(np.float32)
    x[..., w:] = 0.0  # the guard columns are zero
    return x.reshape(b, d, c, h * (w + g))


# ------------------------------------------------------------------ guard_cols
@pytest.mark.parametrize("value", [None, "0", "1", "true"])
def test_guard_cols_matches_jax(monkeypatch, value):
    if value is None:
        monkeypatch.delenv(WGUARD, raising=False)
    else:
        monkeypatch.setenv(WGUARD, value)
    grid = [(h, w) for h in (1, 3, 8, 16, 32, 64, 96, 128) for w in range(1, 131)]
    got = [guard_cols(h, w) for h, w in grid]
    assert got == [jax_guard_cols(h, w) for h, w in grid]
    assert any(got) == (value == "1")
    if value == "1":
        assert (guard_cols(64, 64), guard_cols(128, 128), guard_cols(32, 32),
                guard_cols(16, 16)) == (2, 2, 4, 8)


# ---------------------------------------------------- the guarded conv block
@pytest.mark.parametrize("prelu", [False, True], ids=["leaky", "prelu"])
@pytest.mark.parametrize("size,g", SIZES)
def test_packed_conv_norm_act_matches_jax(size, g, prelu):
    """One block (conv → InstanceNorm over the data columns → LeakyReLU or
    PReLU → guards zeroed) on a guarded packed input, against the JAX
    package's block with ``wguard=g``; the output's guards exactly 0."""
    cin, cout, b, d = 5, 8, 2, 4
    wdim = size + g
    x = _guarded_input(np.random.default_rng(size + prelu), b, d, cin, size, size, g)
    block = JaxPackedConvNormAct(cout, wdim, 0.0, 0.1, dtype=jnp.float32, prelu=prelu,
                                 wguard=g)
    variables = random_variables(
        jax.jit(block.init, static_argnames="train")(jax.random.PRNGKey(0), x, train=False),
        7 + prelu)
    ref = np.asarray(jax.jit(block.apply, static_argnames="train")(variables, x, train=True))
    port = PackedConvNormAct(cin, cout, 0.0, 0.1, torch.float32, prelu=prelu)
    port.load_state_dict(weights.from_flax(variables["params"]), strict=True)
    got = port.forward_packed(torch.from_numpy(x), wdim, g)
    np.testing.assert_allclose(got.detach().numpy(), ref, **TOL)
    assert (_rows(got, wdim)[..., size:] == 0).all()
    # the guard columns hold the norm's bias before they are zeroed: the
    # moments must count the data columns alone to agree
    assert float(np.abs(_rows(ref, wdim)[..., :size]).max()) > 0.5


# --------------------------------------------------------------- the pool
@pytest.mark.parametrize("size,g", SIZES)
def test_packed_max_pool2_with_guards_matches_jax(size, g):
    """Forward bit for bit; the first-match backward against ``jax.vjp`` of
    the JAX package's pool, on values with many ties."""
    b, d, c, wdim = 2, 4, 3, size + g
    rng = np.random.default_rng(size)
    x = np.round(_guarded_input(rng, b, d, c, size, size, g, 2.0)).astype(np.float32)
    ref, vjp = jax.vjp(lambda a: jax_packed_max_pool2(a, wdim, g), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = packed_max_pool2(xt, wdim, g)
    assert got.shape == ref.shape == (b, d // 2, size // 2, size // 2, c)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))
    dy = rng.standard_normal(ref.shape).astype(np.float32)
    (ref_dx,) = vjp(jnp.asarray(dy))
    got.backward(torch.from_numpy(dy))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(ref_dx))
    assert (_rows(xt.grad, wdim)[..., size:] == 0).all()


# ------------------------------------------------------------- whole models
def _jax_generator_vars(jgen, x, seed):
    init = jax.jit(jgen.init, static_argnames="train")
    return random_variables(init(jax.random.PRNGKey(0), x, train=False), seed)


def _port_generator(variables):
    mcfg = ModelConfig(features=FEATURES, compute_dtype="float32", dropout=0.0, packed=True)
    sd = weights.from_flax(variables["params"], variables["batch_stats"])
    return build_models("pc-bssfp", mcfg, "cpu", state_dict=sd)[0]


@pytest.mark.parametrize("size,g", SIZES)
def test_generator_with_guards_matches_jax_and_the_unguarded_port(monkeypatch, size, g):
    """The packed generator under ``UNET_BSSFP_WGUARD=1`` against the JAX
    package's, on the same weights; and against the port's own unguarded
    forward from the same weights (the same function: 1e-5 relative)."""
    monkeypatch.setenv(WGUARD, "1")
    assert guard_cols(size, size) == g
    x = np.random.default_rng(3).standard_normal((1, size, size, size, 24)).astype(np.float32)
    jcfg = JaxModelConfig(features=FEATURES, compute_dtype="float32", dropout=0.0,
                          folded=False, packed=True)
    jgen, _ = jax_build_models("pc-bssfp", jcfg)
    variables = _jax_generator_vars(jgen, x, 5)
    ref = np.asarray(jax.jit(jgen.apply, static_argnames="train")(variables, x, train=False))
    port = _port_generator(variables)
    got = make_predict_fn(port)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    monkeypatch.delenv(WGUARD)
    plain = make_predict_fn(port)(torch.from_numpy(x)).numpy()
    assert np.abs(got - plain).max() <= 1e-5 * np.abs(plain).max()


@pytest.mark.parametrize("size,g", SIZES)
def test_multi_input_unet_with_guards_matches_jax(monkeypatch, size, g):
    """The MultiInputUNet (ResNet head, PReLU backbone through BasicUNet3D)
    packed and guarded, slopes drawn away from their start, against the JAX
    package's guarded net run in float64 (its f32 forward of the narrower
    (4, 8, 8, 16, 16, 4) net lies up to 4.6e-5 from its float64 one at 32³,
    beyond the model tolerance, guarded or not), at the model tolerance; and
    against its own unguarded forward."""
    monkeypatch.setenv(WGUARD, "1")
    x = np.random.default_rng(6).standard_normal((2, size, size, size, 24)).astype(np.float32)
    jnet = functools.partial(JaxMultiInputUNet, modality="pc-bssfp", features=FEATURES,
                             dropout=0.0, use_fused=False, packed=True)
    shapes = jax.eval_shape(functools.partial(jnet(dtype=jnp.float32).init, train=False),
                            jax.random.PRNGKey(0), x)
    params = random_variables(jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes),
                              21)["params"]
    with jax.enable_x64(True):
        ref = np.asarray(jax.jit(jnet(dtype=jnp.float64).apply, static_argnames="train")(
            {"params": jax.tree.map(lambda a: np.asarray(a, np.float64), params)},
            jnp.asarray(x, jnp.float64), train=False))
    mcfg = ModelConfig(multistage_features=FEATURES, compute_dtype="float32", dropout=0.0,
                       packed=True)
    net = build_multi_input_unet("pc-bssfp", mcfg, "cpu", state_dict=weights.from_flax(params))
    assert net.unet.packed
    net.eval()
    with torch.inference_mode():
        got = net(torch.from_numpy(x)).numpy()
        monkeypatch.delenv(WGUARD)
        plain = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    assert np.abs(got - plain).max() <= 1e-5 * np.abs(plain).max()


# ----------------------------------------------------------------------- K2W
# (B, D, H, W, g, Cin, Cout), as tests/test_torch_port_wguard.py's cases
K2W_CASES = [(1, 3, 8, 14, 2, 4, 4), (2, 2, 8, 14, 2, 5, 8), (1, 2, 16, 64, 8, 3, 6)]


@pytest.mark.parametrize("halo", [False, True])
@pytest.mark.parametrize("case", K2W_CASES)
def test_k2w_stripped_wgrad_matches_jax(case, halo):
    """K2W: the weight gradient of the guarded conv as K2 (or K5's wgrad)
    of the guard-stripped operands at W, against the dw of ``jax.vjp`` of
    the Pallas conv with ``wguard=g`` (interpret mode), 3e-4, for a
    cotangent that is nonzero on the guard columns (projected to 0 first,
    as the conv's backward does)."""
    b, d, h, w, g, cin, cout = case
    wdim = w + g
    rng = np.random.default_rng(sum(case) + halo)
    x = _guarded_input(rng, b, d + 2 * halo, cin, h, w, g, 0.3)
    wt = (rng.standard_normal((3, 3, 3, cin, cout)) * 0.3).astype(np.float32)
    bias = np.zeros(cout, np.float32)
    dy = (rng.standard_normal((b, d, cout, h * wdim)) * 0.3).astype(np.float32)
    jfn = jax_conv3x3_packed_halo if halo else jax_conv3x3_packed
    _, vjp = jax.vjp(lambda w_: jfn(jnp.asarray(x), w_, jnp.asarray(bias), wdim, True, g),
                     jnp.asarray(wt))
    (ref,) = vjp(jnp.asarray(dy))
    dyt = K.guard_mask(torch.from_numpy(dy), wdim, g)
    xs, dys = (K.strip_guards(t, wdim, g) for t in (torch.from_numpy(x), dyt))
    assert xs.shape[-1] == dys.shape[-1] == h * w and xs.is_contiguous()
    wgrad = K.conv3x3_wgrad_halo if halo else K.conv3x3_wgrad
    np.testing.assert_allclose(wgrad(xs, dys, w).numpy(), np.asarray(ref),
                               rtol=3e-4, atol=3e-4)


# ------------------------------------------------------ unset, and weights
def test_unset_is_bit_for_bit_zero(monkeypatch):
    """With the variable unset the packed generator's output is bit for bit
    its output under "0" (no guard columns either way)."""
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (1, 16, 16, 16, 24)).astype(np.float32))
    mcfg = ModelConfig(features=FEATURES, compute_dtype="float32", dropout=0.0, packed=True)
    gen = build_models("pc-bssfp", mcfg, "cpu")[0]
    gen.load_state_dict(weights.random_state_dict(gen, 2))
    monkeypatch.delenv(WGUARD, raising=False)
    unset = make_predict_fn(gen)(x)
    monkeypatch.setenv(WGUARD, "0")
    assert torch.equal(make_predict_fn(gen)(x), unset)


def test_from_flax_of_a_guarded_jax_model_loads_unchanged(guarded):
    """A JAX generator built and initialised with the guards on has the
    unguarded tree's keys and shapes; ``from_flax`` of it loads strictly."""
    x = jnp.zeros((1, PATCH, PATCH, PATCH, 24))
    jcfg = JaxModelConfig(features=FEATURES, compute_dtype="float32", dropout=0.0,
                          folded=False, packed=True)
    jgen, _ = jax_build_models("pc-bssfp", jcfg)
    guarded_tree = jax.eval_shape(functools.partial(jgen.init, train=False),
                                  jax.random.PRNGKey(0), x)
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv(WGUARD)
        plain_tree = jax.eval_shape(functools.partial(jgen.init, train=False),
                                    jax.random.PRNGKey(0), x)
    shapes = lambda t: jax.tree.map(lambda a: a.shape, t)  # noqa: E731
    assert shapes(guarded_tree) == shapes(plain_tree)
    variables = random_variables(
        jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), guarded_tree), 4)
    sd = weights.from_flax(variables["params"], variables["batch_stats"])
    gen = _port_generator(variables)
    assert sd.keys() == gen.state_dict().keys()
    assert all(gen.state_dict()[k].shape == v.shape for k, v in sd.items())


# ------------------------------------------------------------------ the plans
# Every guarded conv of the model paths at full width: (B, D, H, W, Cin,
# Cout) of the forward conv, g = guard_cols(H, W) = 2. The GAN step and the
# multi-stage step at 8 × 64³ (row width 66), whole-volume serving at (96,
# 128, 128) (row width 130, forward only), and the GAN step's shards on
# (1, 2) (B 8, D 32 a shard, the halo forms).
GUARDED_CONVS = (
    [(8, 64, 64, 64, cin, cout) for cin, cout in ((24, 32), (32, 32), (96, 32))]
    + [(8, 64, 64, 64, cin, cout) for cin, cout in ((24, 48), (48, 48), (144, 24), (24, 24))])
WHOLE_VOLUME_CONVS = [(1, 96, 128, 128, cin, 32) for cin in (24, 32, 96)]


@pytest.mark.parametrize("halo", [0, 1], ids=["same", "halo"])
@pytest.mark.parametrize("shape", GUARDED_CONVS + WHOLE_VOLUME_CONVS)
def test_guarded_model_shapes_have_wgmma_plans(monkeypatch, shape, halo):
    """The forward (K1W, or K5 on a shard of D/2 + 2 slices) and, where the
    path trains, the dgrad have a ``lanes_map`` wgmma plan, and K2W's
    stripped operands a wgrad plan: a guarded model path never reaches an
    ``mma.sync`` loop, decided without a card."""
    from unet_bssfp_tpu_torch.ops.kernels import conv_wgmma, wgrad_wgmma

    monkeypatch.setenv(WGUARD, "1")
    b, d, h, w, cin, cout = shape
    g = guard_cols(h, w)
    assert g == 2
    d = d // 2 if halo else d
    fwd = conv_wgmma.wgmma_plan(b, d + 2 * halo, d, halo, cin, cout, h, w + g, g)
    assert fwd is not None and fwd.lanes_map and fwd.smem <= conv_wgmma.SMEM_LIMIT
    if b == 1:
        return  # serving: no backward
    dgrad = conv_wgmma.wgmma_plan(b, d, d + 2 * halo, -halo, cout, cin, h, w + g, g)
    assert dgrad is not None and dgrad.lanes_map and dgrad.smem <= conv_wgmma.SMEM_LIMIT
    assert (dgrad.n, dgrad.n_tiles) == ((72, 2) if cin == 144 else (dgrad.n, 1))
    wgrad = wgrad_wgmma.wgrad_plan(b, d, halo, cin, cout, h, w)
    assert wgrad is not None and wgrad.smem <= wgrad_wgmma.SMEM_LIMIT
    # the guarded width itself would have gone to the loop
    assert wgrad_wgmma.wgrad_plan(b, d, halo, cin, cout, h, w + g) is None
    # through the wrappers' own routing, on operands without data
    xk = torch.empty(b, d + 2 * halo, cin, h * (w + g), dtype=torch.bfloat16, device="meta")
    dy = torch.empty(b, d, cout, h * (w + g), dtype=torch.bfloat16, device="meta")
    assert K.conv_plan(xk, cout, w + g, -2 * halo, g) == fwd
    assert K.wgrad_plan(*(K.strip_guards(t, w + g, g) for t in (xk, dy)), w) == wgrad
