"""K10, the packed stages' norm → dropout → activation → guards → cast chain
(``ops/kernels/packed_norm_act.py``), on the CPU.

- The plain version, which CPU tensors take, against the chain as the
  packed block ran it before (``instance_norm`` then ``_drop_act_packed``,
  which a ``space``-split volume still runs): output and the gradients of x,
  scale, bias and ``prelu_slope``, bit for bit, LeakyReLU and PReLU, train
  (dropout 0.05, one seeded generator) and eval, guard columns 0 and 2, f32,
  bf16 and f64.
- The kernels' formulas (``packed_norm_act_model``: the autograd function
  with the saved moments and mask and the closed-form backward) against
  autograd of the plain version in f64.
- A ``remat`` recompute through that autograd function draws the same masks:
  gradients bit-equal to the step without remat.
- Routing: a CPU tensor takes the plain version, a volume split over
  ``space`` keeps the sharded norm, one split over ``data`` alone takes the
  fused call per shard; K10's launch plan at the cells' shapes.

The kernels themselves run on the card: ``tests/test_torch_port_gpu.py``.
"""

import dataclasses
import importlib

import pytest
import torch

from unet_bssfp_tpu_torch.config import ModelConfig, TrainConfig
from unet_bssfp_tpu_torch.models import packed_layers
from unet_bssfp_tpu_torch.models.layers import bind_dropout_generator, instance_norm
from unet_bssfp_tpu_torch.models.packed_layers import PackedConvNormAct, PackedTwoConv
from unet_bssfp_tpu_torch.ops import kernels as K
from unet_bssfp_tpu_torch.parallel.mesh import make_mesh, shard_batch
from unet_bssfp_tpu_torch.train.state import create_gan_state
from unet_bssfp_tpu_torch.train.steps import make_train_step

torch.set_num_threads(1)

PNA = importlib.import_module("unet_bssfp_tpu_torch.ops.kernels.packed_norm_act")
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float64": torch.float64}


def _block(prelu, dtype, cin=3, cout=4, seed=0):
    torch.manual_seed(seed)
    m = PackedConvNormAct(cin, cout, dropout=0.05, negative_slope=0.1, compute_dtype=dtype,
                          prelu=prelu)
    with torch.no_grad():
        m.norm.weight.uniform_(0.5, 1.5)
        m.norm.bias.uniform_(-0.3, 0.3)
        if prelu:
            m.prelu_slope.uniform_(0.05, 0.3)
    return m.to(torch.float64) if dtype == torch.float64 else m


def _conv_out(b, d, c, h, wdim, dtype, seed=1):
    g = torch.Generator().manual_seed(seed)
    off = torch.randn(1, 1, c, 1, generator=g, dtype=torch.float64)
    return (torch.randn(b, d, c, h * wdim, generator=g, dtype=torch.float64) + off).to(dtype)


def _run(m, yk, chain, dy, wdim, wguard):
    """The chain on conv output ``yk`` with gradients: (y, dx, dscale, dbias,
    dslope); the dropout generator set to seed 3 first."""
    bind_dropout_generator(m, torch.Generator().manual_seed(3))
    leaves = [m.norm.weight, m.norm.bias] + ([m.prelu_slope] if m.prelu else [])
    for p in leaves:
        p.grad = None
    x = yk.detach().requires_grad_(True)
    y = chain(m, x)
    y.backward(dy.to(y.dtype))
    return [y.detach(), x.grad] + [p.grad for p in leaves]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("wguard", [0, 2])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("prelu", [False, True])
def test_plain_equals_the_block_chain_it_replaces(prelu, train, wguard, dtype):
    dt = DTYPES[dtype]
    m = _block(prelu, dt).train(train)
    h, w = 4, 6
    wdim = w + wguard
    yk = _conv_out(2, 4, 4, h, wdim, dt)
    dy = torch.randn(yk.shape, dtype=torch.float64)

    def before(mod, x):
        y = instance_norm(x, mod.norm, dims=(1, 3), channel_dim=2, guard=(wdim, wguard))
        return mod._drop_act_packed(y, wdim, wguard)

    def now(mod, x):
        return mod._norm_drop_act_packed(x, wdim, wguard)

    ref = _run(m, yk, before, dy, wdim, wguard)
    got = _run(m, yk, now, dy, wdim, wguard)
    assert got[0].dtype == dt
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    if train:  # the dropout dropped some elements: zeros off the guards
        rows = got[0].unflatten(-1, (h, wdim))[..., :w]
        assert int((rows == 0).sum()) > 0


@pytest.mark.parametrize("wguard", [0, 2])
@pytest.mark.parametrize("drop", [True, False])
@pytest.mark.parametrize("prelu", [False, True])
def test_closed_form_backward_matches_autograd_in_f64(prelu, drop, wguard):
    b, d, c, h, w = 2, 3, 4, 4, 6
    wdim = w + wguard
    x = _conv_out(b, d, c, h, wdim, torch.float64)
    g = torch.Generator().manual_seed(5)
    scale = (1 + 0.3 * torch.randn(c, generator=g)).double()
    bias = (0.3 * torch.randn(c, generator=g)).double()
    slope = (0.1 + 0.05 * torch.randn(c, generator=g)).double() if prelu else 0.1
    draw = torch.empty(x.shape).bernoulli_(0.8, generator=g) if drop else None
    keep = 0.8  # as the blocks pass it in eval mode too: it scales only with a draw
    dy = torch.randn(x.shape, generator=g, dtype=torch.float64)
    outs = []
    for fn in (K.packed_norm_act_plain, K.packed_norm_act_model):
        leaves = [t.clone().requires_grad_(True) for t in
                  [x, scale, bias] + ([slope] if prelu else [])]
        y = fn(leaves[0], leaves[1], leaves[2], leaves[3] if prelu else slope, wdim, wguard,
               draw, keep)
        y.backward(dy)
        outs.append([y.detach()] + [t.grad for t in leaves])
    for a, r in zip(*outs[::-1]):
        torch.testing.assert_close(a, r, rtol=1e-12, atol=1e-12 * float(r.abs().max()))
    dx = outs[1][1].unflatten(-1, (h, wdim))
    if wguard:  # the guards' inputs take no gradient
        assert not dx[..., w:].any()


def test_model_skips_the_gradients_no_leaf_asks_for():
    x = _conv_out(2, 3, 4, 4, 6, torch.float64).requires_grad_(True)
    scale, bias = torch.ones(4, dtype=torch.float64), torch.zeros(4, dtype=torch.float64)
    y = K.packed_norm_act_model(x, scale, bias, 0.1, 6)
    y.sum().backward()
    assert x.grad is not None and scale.grad is None and bias.grad is None


def test_remat_recompute_through_the_autograd_function_draws_the_same_masks(monkeypatch):
    """The packed blocks' chain through ``_PackedNormAct`` (the kernels'
    autograd function, here with its formulas in PyTorch) under ``remat``:
    the recompute replays the dropout generator, so a GAN step with remat
    equals the step without it bit for bit."""
    monkeypatch.setattr(packed_layers, "packed_norm_act", K.packed_norm_act_model)
    mcfg = ModelConfig(features=(4, 8, 8, 16, 16, 4), disc_features=(8, 8, 16),
                       compute_dtype="float32", dropout=0.05, packed=True)
    g = torch.Generator().manual_seed(7)
    x, y = torch.rand(2, 16, 16, 16, 24, generator=g), torch.rand(2, 16, 16, 16, 6, generator=g)
    runs = []
    for remat in (False, True):
        state = create_gan_state(5, "pc-bssfp", dataclasses.replace(mcfg, remat=remat),
                                 TrainConfig(), "cpu")
        m = make_train_step(state.gen, state.disc, TrainConfig())(state, x, y)
        runs.append(({k: float(v) for k, v in m.items()},
                     {k: p.grad for k, p in state.gen.named_parameters()},
                     state.rng.get_state()))
    (m0, g0, r0), (m1, g1, r1) = runs
    assert m0 == m1 and torch.equal(r0, r1)
    assert g0.keys() == g1.keys() and all(torch.equal(g0[k], g1[k]) for k in g0)
    assert any(k.endswith("norm.weight") and g0[k].abs().sum() > 0 for k in g0)


def test_cpu_tensors_take_the_plain_version():
    m = _block(True, torch.float32).train()
    yk = _conv_out(2, 4, 4, 4, 6, torch.float32)
    K.reset_launches()
    bind_dropout_generator(m, torch.Generator().manual_seed(3))
    got = m._norm_drop_act_packed(yk, 6, 0)
    bind_dropout_generator(m, torch.Generator().manual_seed(3))
    ref = K.packed_norm_act_plain(yk, m.norm.weight, m.norm.bias, m.prelu_slope, 6, 0,
                                  m.drop.draw(yk), m.drop.keep, out_dtype=torch.float32)
    assert torch.equal(got, ref)
    assert K.launches()["packed_norm_act"] == K.launches()["packed_norm_act_backward"] == 0


def test_other_devices_are_refused():
    x = torch.empty(2, 3, 4, 24, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        K.packed_norm_act(x, torch.ones(4), torch.zeros(4), 0.1, 6)


@pytest.mark.parametrize("shape,fused_calls", [((1, 2), 0), ((2, 1), 4)])
def test_space_split_keeps_the_sharded_norm(monkeypatch, shape, fused_calls):
    """A volume split over ``space`` takes its moments over the shards and
    never reaches the fused call; one split over ``data`` alone takes it on
    each shard (2 shards × 2 blocks), with the result of the unsplit
    forward."""
    calls = []
    real = packed_layers.packed_norm_act
    monkeypatch.setattr(packed_layers, "packed_norm_act",
                        lambda *a: calls.append(1) or real(*a))
    torch.manual_seed(0)
    two = PackedTwoConv(3, 4, dropout=0.0, compute_dtype=torch.float32).eval()
    x = torch.randn(2, 4, 4, 8, 3)
    ref = two.forward_packed(x, 0)
    calls.clear()
    mesh = make_mesh(["cpu"] * 2, ("data", "space"), shape)
    got = two.forward_packed(shard_batch(mesh, x), 0)
    assert len(calls) == fused_calls
    whole = torch.cat([torch.cat(list(row), dim=1) for row in got.parts], dim=0)
    torch.testing.assert_close(whole, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,wdim,wguard,k,grid,vec,count", [
    ((16, 64, 32, 4096), 64, 0, 32, 16384, 8, 262144),      # gan-train-b16
    ((32, 64, 32, 4096), 64, 0, 32, 32768, 8, 262144),      # gan-serve-cohort-b32
    ((8, 64, 48, 4096), 64, 0, 32, 12288, 8, 262144),       # multi-stage conv_0
    ((1, 96, 32, 16384), 128, 0, 192, 6144, 8, 1572864),    # a whole volume
    ((8, 64, 32, 64 * 66), 66, 2, 33, 8448, 8, 262144),     # wguard
    ((2, 3, 5, 42), 7, 1, 1, 10, 1, 108),                   # rows of 42: no 16-byte loads
])
def test_plan_fills_the_card_at_the_cells_shapes(shape, wdim, wguard, k, grid, vec, count):
    p = PNA.plan(shape, wdim, wguard)
    assert (p.k, p.grid, p.vec, p.count) == (k, grid, vec, count)
    assert p.k * PNA.CHUNK >= shape[1] * shape[3] > (p.k - 1) * PNA.CHUNK
    assert PNA.plan(shape, wdim, wguard, aligned=False).vec == 1


def test_plan_refuses_lanes_that_are_not_rows():
    with pytest.raises(ValueError, match="not rows"):
        PNA.plan((2, 3, 4, 50), 8, 0)
