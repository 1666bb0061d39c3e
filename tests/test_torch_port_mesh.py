"""The port's mesh path (data × space) against the JAX package's, on the CPU.

The port's mesh is single-controller like the JAX package's: 8 mesh positions
on the CPU stand where the JAX tests have 8 virtual CPU devices
(``tests/conftest.py``). The packed convs run through their plain versions
here, the Pallas kernels in interpret mode. The port refuses a volume whose D
is no multiple of 16·n_space (its pools are local to a shard), so where the
JAX package's mesh tests use D 16 on a two-way ``space`` axis these use D 32.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_bssfp_tpu.config import ModelConfig as JaxModelConfig, TrainConfig as JaxTrainConfig
from unet_bssfp_tpu.models.unet import BasicUNet3D as JaxBasicUNet3D
from unet_bssfp_tpu.ops.pallas.conv3d import (
    conv3x3_packed_auto as jax_conv3x3_packed_auto,
    pack_hw as jax_pack_hw,
    packed_conv_mesh,
)
from unet_bssfp_tpu.parallel.mesh import make_mesh as jax_make_mesh
from unet_bssfp_tpu.train.state import (
    build_models as jax_build_models,
    create_gan_state as jax_create_gan_state,
)
from unet_bssfp_tpu.train.steps import make_predict_fn as jax_make_predict_fn
from unet_bssfp_tpu_torch import weights
from unet_bssfp_tpu_torch.config import ModelConfig
from unet_bssfp_tpu_torch.eval.inference import predict_volume
from unet_bssfp_tpu_torch.models.layers import ConvBlock, TwoConv
from unet_bssfp_tpu_torch.models.packed_layers import PackedTwoConv
from unet_bssfp_tpu_torch.models.unet import BasicUNet3D
from unet_bssfp_tpu_torch.ops import kernels as K
from unet_bssfp_tpu_torch.ops.kernels import conv3d as conv3d_mod
from unet_bssfp_tpu_torch.parallel.mesh import (
    Sharded,
    gather_batch,
    local,
    make_mesh,
    replicas,
    replicate,
    shard_batch,
)
from unet_bssfp_tpu_torch.train.state import auto_packed, build_models
from unet_bssfp_tpu_torch.train.steps import make_predict_fn
from test_torch_port_models import random_variables

torch.set_num_threads(1)
CPU8 = ["cpu"] * 8


def _np(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


@pytest.fixture(scope="module")
def mesh42():
    return make_mesh(CPU8, ("data", "space"), (4, 2))


@pytest.fixture(scope="module")
def jax_mesh42():
    assert len(jax.devices()) == 8, "conftest must provision 8 CPU devices"
    return jax_make_mesh(8, axes=("data", "space"), shape=(4, 2))


# --------------------------------------------------------------- the mesh
@pytest.mark.parametrize("axes,shape", [(("data",), None), (("data", "space"), (4, 2)),
                                        (("data", "space"), (1, 8)),
                                        (("data", "space"), (8, 1))])
def test_shard_gather_round_trip_on_8_positions(axes, shape):
    mesh = make_mesh(CPU8, axes, shape)
    assert mesh.positions == 8 and mesh.distinct == (torch.device("cpu"),)
    assert mesh.shape == (shape or (8,))
    x = torch.arange(8 * 16 * 3 * 5, dtype=torch.float32).reshape(8, 16, 3, 5)
    xs = shard_batch(mesh, x)
    nd, ns = mesh.size("data"), mesh.size("space")
    assert isinstance(xs, Sharded) and xs.shape == (8 // nd, 16 // ns, 3, 5)
    assert torch.equal(xs.parts[nd - 1][ns - 1], x[-(8 // nd):, -(16 // ns):])
    assert all(p.is_contiguous() for row in xs.parts for p in row)
    assert torch.equal(gather_batch(xs), x)
    tree = shard_batch(mesh, {"x": x, "pair": (x, 2 * x)})
    assert torch.equal(gather_batch(tree["pair"][1]), 2 * x)


def test_one_device_may_hold_several_positions_and_devices_repeat_in_turn():
    mesh = make_mesh(["cpu"], ("data", "space"), (2, 3))
    assert mesh.shape == (2, 3) and mesh.positions == 6 and len(mesh.distinct) == 1


def test_halo_exchange_values_and_its_backward():
    """Every shard gets its space neighbours' edge slices, zeros at the ends;
    backward, the halo's gradient is added to the neighbour's edge."""
    mesh = make_mesh(CPU8, ("data", "space"), (2, 4))
    x = torch.randn(2, 8, 3, 4, dtype=torch.float64, requires_grad=True)
    xs = shard_batch(mesh, x).halo_d()
    assert xs.shape == (1, 4, 3, 4)
    padded = torch.nn.functional.pad(x, (0, 0, 0, 0, 1, 1))
    for i in range(2):
        for j in range(4):
            assert torch.equal(xs.parts[i][j], padded[i:i + 1, 2 * j:2 * j + 4])
    g = torch.randn(2, 4, 4, 3, 4, dtype=torch.float64)  # per position (i, j)
    sum((p * g[i, j]).sum() for i, row in enumerate(xs.parts)
        for j, p in enumerate(row)).backward()
    want = torch.zeros(2, 10, 3, 4, dtype=torch.float64)
    for i in range(2):
        for j in range(4):
            want[i, 2 * j:2 * j + 4] += g[i, j]
    assert torch.allclose(x.grad, want[:, 1:-1], rtol=0, atol=1e-15)


def test_all_sum_is_the_same_bits_on_every_position():
    mesh = make_mesh(CPU8, ("data", "space"), (2, 4))
    x = torch.randn(2, 4, 5)
    s = shard_batch(mesh, x).all_sum("space")
    for i in range(2):
        want = x[i:i + 1, 0:1] + x[i:i + 1, 1:2] + x[i:i + 1, 2:3] + x[i:i + 1, 3:4]
        assert all(torch.equal(p, want) for p in s.parts[i])
    d = shard_batch(mesh, x).all_sum("data")
    assert torch.equal(d.parts[1][2], x[0:1, 2:3] + x[1:2, 2:3])


def test_refusals_unknown_device_and_indivisible_shapes(mesh42):
    with pytest.raises(ValueError, match="unknown device"):
        make_mesh(["cuda:99"])
    with pytest.raises(ValueError, match="unknown device"):
        make_mesh(["tpu:0"])
    with pytest.raises(ValueError, match="axes"):
        make_mesh(CPU8, ("space",))
    with pytest.raises(ValueError, match=r"\(6, 8, 3\)"):
        shard_batch(mesh42, torch.zeros(6, 8, 3))
    with pytest.raises(ValueError, match=r"\(8, 7, 3\)"):
        shard_batch(mesh42, torch.zeros(8, 7, 3))


# ------------------------------------------------------ conv3x3_packed_auto
def _conv_inputs(d, seed):
    rng = np.random.default_rng(seed)
    b, h, w, cin, cout = 8, 4, 32, 3, 4
    x = _np(rng, (b, d, h, w, cin), 0.3)
    return (np.asarray(jax_pack_hw(jnp.asarray(x))), _np(rng, (3, 3, 3, cin, cout), 0.3),
            _np(rng, (cout,), 0.3), w)


@pytest.mark.parametrize("d", [8, 6, 7])
def test_conv_auto_on_4x2_mesh_matches_jax(mesh42, jax_mesh42, d, monkeypatch):
    """Forward (rtol/atol 1e-5) and gradients (3e-4: the JAX tests' own
    bounds, test_packed_multichip.py:225,251) against the JAX function under
    ``packed_conv_mesh`` on the 8 virtual devices. D 8 and D 6 (three local
    slices: the JAX test of that shape is named a fall-back, but 2 divides 6)
    go through the halo exchange and K5; D 7 does not divide the space axis
    and routes to the data-only split and K1, as in the JAX package."""
    xk, wt, bias, w = _conv_inputs(d, 40 + d)

    def jax_loss(x_, w_, b_):
        with packed_conv_mesh(jax_mesh42, "data", space_axis="space"):
            y = jax_conv3x3_packed_auto(x_, w_, b_, w, True)
        return jnp.sum(y * y), y

    (_, ref), g_ref = jax.value_and_grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(xk), jnp.asarray(wt), jnp.asarray(bias))

    calls = {"halo": 0, "same": 0}
    halo, same = conv3d_mod.conv3x3_packed_halo, conv3d_mod.conv3x3_packed
    monkeypatch.setattr(conv3d_mod, "conv3x3_packed_halo",
                        lambda *a: calls.__setitem__("halo", calls["halo"] + 1) or halo(*a))
    monkeypatch.setattr(conv3d_mod, "conv3x3_packed",
                        lambda *a: calls.__setitem__("same", calls["same"] + 1) or same(*a))
    x_t, w_t, b_t = _t(xk, True), _t(wt, True), _t(bias, True)
    got = K.conv3x3_packed_auto(x_t, w_t, b_t, w, mesh=mesh42)
    assert calls == ({"halo": 0, "same": 4} if d == 7 else {"halo": 8, "same": 0})
    assert mesh42.plan(8, 8) is mesh42 and mesh42.plan(8, 6) is mesh42
    assert mesh42.plan(8, 7).shape == (4, 1) and mesh42.plan(6, 8) is None
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    (got * got).sum().backward()
    for g, r, name in zip((x_t.grad, w_t.grad, b_t.grad), g_ref, ("dx", "dw", "db")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=3e-4, atol=3e-4,
                                   err_msg=name)


def test_conv_auto_without_mesh_or_with_one_position_is_k1():
    xk, wt, bias, w = _conv_inputs(4, 3)
    ref = K.conv3x3_packed(_t(xk), _t(wt), _t(bias), w)
    one = make_mesh(["cpu"], ("data", "space"), (1, 1))
    for mesh in (None, one):
        assert torch.equal(K.conv3x3_packed_auto(_t(xk), _t(wt), _t(bias), w, mesh=mesh), ref)
    xs = K.pack_hw_auto(shard_batch(one, torch.randn(2, 4, 4, 32, 3)))
    assert isinstance(xs, Sharded) and xs.shape == (2, 4, 3, 128)
    assert K.unpack_hw_auto(xs, 32).shape == (2, 4, 4, 32, 3)


# ------------------------------------------------------------- the models
def test_packed_unet_on_4x2_mesh_matches_jax_plain(mesh42):
    """The packed U-Net on the sharded batch against the JAX plain model on
    the same weights (rtol 2e-4, atol 2e-5 and the widths of
    test_packed_unet_on_dp_sp_mesh_matches_plain; D 32 and H 16 instead of 16
    and 8: the port pools locally and torch refuses a pool of one voxel)."""
    x = _np(np.random.default_rng(50), (4, 32, 16, 16, 3), 0.3)
    feats = (4, 4, 4, 4, 8, 4)
    plain = JaxBasicUNet3D(out_channels=2, features=feats, dropout=0.0,
                           dtype=jnp.float32, use_fused=False, packed=False)
    variables = random_variables(
        plain.init(jax.random.PRNGKey(51), jnp.asarray(x), train=False), 52)
    ref = plain.apply(variables, jnp.asarray(x), train=False)
    port = BasicUNet3D(3, 2, feats, 0.0, compute_dtype=torch.float32, packed=True).eval()
    port.load_state_dict(weights.from_flax(variables["params"]), strict=True)
    with torch.inference_mode():
        got = gather_batch(port(shard_batch(mesh42, torch.from_numpy(x))))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module")
def generators():
    """The JAX package's unsharded predict function and the port's generator
    (packed and plain) on the same seeded weights."""
    feats = (4, 8, 8, 16, 16, 4)
    jcfg = JaxModelConfig(features=feats, disc_features=(8, 8, 16),
                          compute_dtype="float32", dropout=0.0)
    gen, _ = jax_build_models("pc-bssfp", jcfg)
    state = jax_create_gan_state(jax.random.PRNGKey(0), "pc-bssfp", jcfg,
                                 JaxTrainConfig(), patch_size=16)
    variables = random_variables({"params": state.gen_params,
                                  "batch_stats": state.gen_batch_stats}, 7)
    state = state.replace(gen_params=variables["params"],
                          gen_batch_stats=variables["batch_stats"])
    jax_fn = jax_make_predict_fn(gen)
    sd = weights.from_flax(variables["params"], variables["batch_stats"])
    return (lambda x: np.array(jax_fn(state, jnp.asarray(x)))), sd, feats


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("shape", [(4, 2), (8, 1), (2, 2)])
def test_predict_fn_on_mesh_matches_jax_unsharded(generators, packed, shape):
    """``make_predict_fn(gen, mesh)`` on a batch of 8 against the JAX
    package's unsharded ``make_predict_fn`` and against the port's own, both
    at rtol 1e-4, atol 1e-5·max|ref| (tests/test_space_axis.py holds sharded
    to unsharded at rtol 1e-4, atol 1e-5 on outputs of order 1). The absolute
    term is scaled by max|ref| = 8.4 because two f32 runs of this generator
    cannot meet at 1e-5 here: the unsharded port lies 6.0e-5 from the JAX
    output, each lies 3–4e-5 from the JAX package in float64, and the port
    sharded lies up to 3.1e-5 from the port unsharded (the CPU's conv library
    sums in another order at another batch size)."""
    jax_fn, sd, feats = generators
    x = np.random.default_rng(0).random((8, 32, 16, 16, 24)).astype(np.float32)
    ref = jax_fn(x)
    mesh = make_mesh(CPU8, ("data", "space"), shape)
    mcfg = ModelConfig(features=feats, compute_dtype="float32", dropout=0.0, packed=packed)
    gen, _ = build_models("pc-bssfp", mcfg, state_dict=sd, mesh=mesh)
    assert gen.unet.packed == packed
    got = make_predict_fn(gen, mesh)(torch.from_numpy(x))
    assert got.shape == ref.shape and got.device.type == "cpu"
    flat = make_predict_fn(gen)(torch.from_numpy(x))
    atol = 1e-5 * np.abs(ref).max()
    np.testing.assert_allclose(got.numpy(), flat.numpy(), rtol=1e-4, atol=atol)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=atol)


@pytest.mark.parametrize("whole_volume,shape", [(True, (1, 2)), (False, (2, 2)),
                                               (False, (2, 1))])
def test_predict_volume_on_mesh_matches_jax_unsharded(generators, whole_volume, shape):
    """``predict_volume(mesh=…)``: the whole volume's d over ``space``; each
    batch of patches over ``data`` and each patch's d over ``space``. Against
    the JAX package's generator on the same patches, stitched by the port;
    tolerances as in the test above."""
    jax_fn, sd, feats = generators
    vol = np.random.default_rng(3).random((64, 32, 32, 24)).astype(np.float32)
    mesh = make_mesh(CPU8[:shape[0] * shape[1]], ("data", "space"), shape)
    mcfg = ModelConfig(features=feats, compute_dtype="float32", dropout=0.0, packed=True)
    gen, _ = build_models("pc-bssfp", mcfg, state_dict=sd, mesh=mesh)
    kw = dict(patch_size=32, batch_size=2, whole_volume=whole_volume)
    got = predict_volume(make_predict_fn(gen, mesh), torch.from_numpy(vol), mesh=mesh, **kw)
    flat = predict_volume(make_predict_fn(gen), torch.from_numpy(vol), **kw)
    ref = predict_volume(lambda t: torch.from_numpy(jax_fn(t.numpy())),
                         torch.from_numpy(vol), **kw).numpy()
    assert got.shape == (64, 32, 32, 6)
    atol = 1e-5 * np.abs(ref).max()
    np.testing.assert_allclose(got.numpy(), flat.numpy(), rtol=1e-4, atol=atol)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=atol)


@pytest.mark.parametrize("block_cls", [TwoConv, PackedTwoConv])
def test_block_gradients_on_4x2_mesh_match_unsharded_in_float64(mesh42, block_cls):
    """Backward through the halo exchange and the summed norm moments: every
    gradient of a conv + norm block on the (4, 2) mesh equals the unsharded
    one in float64 (rtol 1e-7, atol 1e-10, tests/test_space_axis.py:123), for
    a non-uniform upstream gradient, so the boundary taps matter."""
    rng = np.random.default_rng(7)
    block = block_cls(4, 8, dropout=0.0).double()
    for p in block.parameters():
        p.data = torch.from_numpy(rng.standard_normal(tuple(p.shape)))
    x = torch.from_numpy(rng.random((8, 16, 16, 16, 4)))
    packed = block_cls is PackedTwoConv
    up = torch.from_numpy(rng.random((8, 16, 8, 256) if packed else (8, 16, 16, 16, 8)))
    fwd = block.forward_packed if packed else block

    def grads(sharded):
        xi = x.clone().requires_grad_(True)
        block.zero_grad(set_to_none=True)
        y = gather_batch(fwd(shard_batch(mesh42, xi))) if sharded else fwd(xi)
        (y * up).sum().backward()
        return [xi.grad] + [p.grad.clone() for p in block.parameters()]

    for a, b in zip(grads(True), grads(False)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-7, atol=1e-10)


# ------------------------------------------------------------ the refusals
def test_mesh_refuses_d_not_a_multiple_of_16_n_space(generators):
    _, sd, feats = generators
    mesh = make_mesh(["cpu"], ("data", "space"), (1, 2))
    mcfg = ModelConfig(features=feats, compute_dtype="float32", packed=True)
    gen, _ = build_models("pc-bssfp", mcfg, state_dict=sd, mesh=mesh)
    fn = make_predict_fn(gen, mesh)
    with pytest.raises(ValueError, match=r"\(1, 16, 16, 16, 24\).*multiple of 16·n_space=32"):
        fn(torch.zeros(1, 16, 16, 16, 24))
    with pytest.raises(ValueError, match=r"D=48.*multiple of 16·n_space=32"):
        predict_volume(fn, torch.zeros(48, 16, 16, 24), whole_volume=True, mesh=mesh)
    wide = make_mesh(["cpu"], ("data", "space"), (2, 1))
    with pytest.raises(ValueError, match="no batch to split"):
        predict_volume(fn, torch.zeros(32, 16, 16, 24), whole_volume=True, mesh=wide)
    with pytest.raises(ValueError, match="batch_size 3"):
        predict_volume(fn, torch.zeros(32, 16, 16, 24), batch_size=3, mesh=wide)


def test_mesh_refuses_use_pallas_and_sharded_training_parts():
    """use_pallas on a mesh of two positions still raises. Train-mode
    BatchNorm and the discriminator's k4 s2 conv, which raised before the
    sharded training step existed, now run on a space split and equal the
    unsharded modules (tests/test_torch_port_sharded_step.py holds them in
    float64)."""
    mesh = make_mesh(["cpu"], ("data", "space"), (1, 2))
    mcfg = ModelConfig(features=(4, 8, 8, 16, 16, 4), use_pallas=True)
    with pytest.raises(ValueError, match="use_pallas"):
        build_models("pc-bssfp", mcfg, mesh=mesh)
    one = make_mesh(["cpu"], ("data", "space"), (1, 1))
    build_models("pc-bssfp", mcfg, mesh=one)  # one position: nothing is split
    gen, _ = build_models("pc-bssfp", ModelConfig(features=(4, 8, 8, 16, 16, 4), dropout=0.0,
                                                compute_dtype="float32"),
                          mesh=mesh)
    x = torch.rand(2, 32, 16, 16, 24)
    flat = copy.deepcopy(gen).train()
    gen.train()
    got = gather_batch(gen(shard_batch(mesh, x)))
    want = flat(x)
    # f32, other summation orders in the norms' moments: within the mesh
    # serving bound, 1e-5 of the largest output
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    for name, buf in flat.named_buffers():  # the head's BatchNorm, updated once
        np.testing.assert_allclose(dict(gen.named_buffers())[name].numpy(), buf.numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    block = ConvBlock(24, 8).eval()  # the discriminator's k4 s2 conv
    np.testing.assert_allclose(
        gather_batch(block(shard_batch(mesh, x))).detach().numpy(),
        block(x).detach().numpy(), rtol=0, atol=1e-6)


def test_auto_packed_gate_is_mesh_aware():
    """Counterpart of test_auto_packed_gate_mesh_aware: an explicit setting
    wins; otherwise packed only where every device of the mesh is CUDA."""
    auto = ModelConfig()
    mesh = make_mesh(CPU8, ("data", "space"), (4, 2))
    assert auto_packed(ModelConfig(packed=True), "cpu", mesh) is True
    assert auto_packed(ModelConfig(packed=False), "cpu", None) is False
    assert auto_packed(auto, "cpu") is False and auto_packed(auto, "cpu", mesh) is False
    assert auto_packed(auto, "cuda") is True


def test_replicas_share_values_bit_for_bit():
    """One replica per distinct device (not per position), made after the
    weights are loaded; every submodule finds its twin."""
    mesh = make_mesh(CPU8, ("data", "space"), (4, 2))
    mcfg = ModelConfig(features=(4, 8, 8, 16, 16, 4), compute_dtype="float32")
    probe, _ = build_models("pc-bssfp", mcfg, "cpu")
    sd = weights.random_state_dict(probe, 3)
    gen, _ = build_models("pc-bssfp", mcfg, state_dict=sd, mesh=mesh)
    assert replicas(gen) == (gen,)  # 8 positions on one device: no copy
    assert local(gen.unet.conv_0, torch.device("cpu")) is gen.unet.conv_0
    assert all(torch.equal(v, sd[k]) for k, v in gen.state_dict().items())
    # the copy that replicate() puts on another device, made here on the CPU
    twin = copy.deepcopy(gen)
    table = {torch.device("cpu"): gen, torch.device("meta"): twin}
    for a, b in zip(gen.modules(), twin.modules()):
        a.__dict__["_replicas"] = b.__dict__["_replicas"] = {
            torch.device("cpu"): a, torch.device("meta"): b}
    assert replicas(gen) == tuple(table.values())
    assert local(gen.unet.conv_0, torch.device("meta")) is twin.unet.conv_0
    assert all(torch.equal(p, q) and p is not q
               for p, q in zip(gen.state_dict().values(), twin.state_dict().values()))
    with pytest.raises(ValueError, match="no replica"):
        local(gen.unet, torch.device("cuda:0"))
    assert replicate(gen, mesh) == {torch.device("cpu"): gen}
    assert replicas(gen) == (gen,)


def test_predict_cli_with_mesh_on_cpu(tmp_path, capsys):
    from unet_bssfp_tpu_torch.config import Config
    from unet_bssfp_tpu_torch.data import nifti
    from unet_bssfp_tpu_torch.predict import main, parse_mesh

    cfg = Config.from_json(
        '{"data": {"volume_shape": [32, 16, 16], "patch_size": 32},'
        ' "model": {"features": [4, 8, 8, 16, 16, 4], "compute_dtype": "float32"}}')
    (tmp_path / "cfg.json").write_text(cfg.to_json())
    gen, _ = build_models("pc-bssfp", cfg.model, "cpu")
    weights.save(weights.random_state_dict(gen, 0), str(tmp_path / "w.pt"))
    src = np.random.default_rng(1).standard_normal((32, 16, 16, 24)).astype(np.float32)
    inp = str(tmp_path / "v.nii.gz")
    nifti.save_volume(inp, src, np.eye(4))
    args = [inp, "--weights", str(tmp_path / "w.pt"), "--config", str(tmp_path / "cfg.json"),
            "--device", "cpu", "--whole-volume"]
    flat, _ = nifti.load_volume(main(args + ["--out-dir", str(tmp_path / "a")]))
    split, _ = nifti.load_volume(main(args + ["--out-dir", str(tmp_path / "b"),
                                              "--mesh", "1,2"]))
    assert "Mesh({'data': 1, 'space': 2}" in capsys.readouterr().out
    np.testing.assert_allclose(split, flat, rtol=1e-4, atol=1e-5)
    assert parse_mesh(None, torch.device("cpu")) is None
    for bad in ("2", "1,0", "a,b", "1,2,3"):
        with pytest.raises(ValueError, match="--mesh"):
            parse_mesh(bad, torch.device("cpu"))
