"""The port's CUDA kernels against their plain PyTorch versions, on
the card (``gpu`` marker; skipped without a CUDA device).

This file imports no JAX, so it runs where the port runs:

  python -m pytest tests/test_torch_port_gpu.py --noconftest -q
"""

import math
from pathlib import Path

import pytest
import torch

from unet_bssfp_tpu_torch.ops import kernels as K
from unet_bssfp_tpu_torch.ops import scalar_maps_check as chk


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("cin", [24, 32, 96])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_conv3x3_packed_matches_plain(cuda, cin, dtype):
    g = torch.Generator(device="cuda").manual_seed(cin)
    xk = torch.randn(2, 8, cin, 32 * 32, device=cuda, generator=g).to(dtype)
    w = torch.randn(3, 3, 3, cin, 32, device=cuda, generator=g) * 0.1
    b = torch.randn(32, device=cuda, generator=g)
    got = K.conv3x3_packed(xk, w, b, 32).float()
    ref = K.conv3x3_packed_plain(xk, w, b, 32).float()
    # f32: summation order only; bf16: one output rounding either side.
    tol = (dict(rtol=1e-5, atol=1e-4) if dtype == torch.float32
           else dict(rtol=2 ** -7, atol=1e-2))
    torch.testing.assert_close(got, ref, **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("b,d,cin,h,w,cout", [(1, 3, 5, 6, 48, 4),
                                              (2, 2, 40, 9, 35, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_conv3x3_packed_ragged_shapes(cuda, b, d, cin, h, w, cout, dtype):
    """Tiles that overhang H, W, Cin and Cout: the bounds masks."""
    xk = torch.randn(b, d, cin, h * w, device=cuda).to(dtype)
    wt = torch.randn(3, 3, 3, cin, cout, device=cuda) * 0.1
    bias = torch.randn(cout, device=cuda)
    got = K.conv3x3_packed(xk, wt, bias, w).float()
    ref = K.conv3x3_packed_plain(xk, wt, bias, w).float()
    tol = (dict(rtol=1e-5, atol=1e-4) if dtype == torch.float32
           else dict(rtol=2 ** -7, atol=1e-2))
    torch.testing.assert_close(got, ref, **tol)


# K2 and the conv's backward. K2 and its plain version both sum exact
# products of the same (bf16 or f32) values in f32, in other orders. A
# round-to-nearest chain of L adds whose partial sums stay below max|ref|
# strays about sqrt(L)·2^-24·max|ref|; L is K2's longest chain
# (conv3x3_wgrad_chain), and the factor 16 covers the plain side's order.
WGRAD_SHAPES = [(2, 8, 32, 32, 24, 32), (2, 8, 32, 32, 32, 32),
                (2, 8, 32, 32, 96, 32), (1, 3, 6, 48, 5, 4), (2, 2, 9, 35, 40, 40)]


def _close(got, ref, rtol, atol_frac):
    got, ref = got.float(), ref.float()
    atol = atol_frac * float(ref.abs().max())
    torch.testing.assert_close(got, ref, rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("b,d,h,w,cin,cout", WGRAD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_conv3x3_wgrad_matches_plain_and_repeats(cuda, b, d, h, w, cin, cout, dtype):
    g = torch.Generator(device="cuda").manual_seed(cin + h)
    xk = torch.randn(b, d, cin, h * w, device=cuda, generator=g).to(dtype)
    dy = torch.randn(b, d, cout, h * w, device=cuda, generator=g).to(dtype)
    K.reset_launches()
    got = K.conv3x3_wgrad(xk, dy, w)
    assert K.conv3x3_wgrad.launches == 1
    assert got.dtype == torch.float32 and got.shape == (3, 3, 3, cin, cout)
    chain = K.conv3x3_wgrad_chain(xk, dy, w)
    _close(got, K.conv3x3_wgrad_plain(xk, dy, w), 0.0, 16 * math.sqrt(chain) * 2 ** -24)
    # fixed-order split sum, no atomics: bit for bit the same
    assert torch.equal(got, K.conv3x3_wgrad(xk, dy, w))


@pytest.mark.gpu
@pytest.mark.parametrize("cin,cout", [(32, 24), (32, 32), (32, 96), (5, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_conv3x3_packed_autograd_matches_plain(cuda, cin, cout, dtype):
    """dx (K1 on flipped, transposed weights), dw (K2) and db against plain
    autograd. Here cin → cout is the forward conv; its dgrad runs K1 at
    cout → cin."""
    g = torch.Generator(device="cuda").manual_seed(cin * cout)
    b, d, h, w = 2, 6, 16, 32
    x0 = torch.randn(b, d, cin, h * w, device=cuda, generator=g).to(dtype)
    w0 = torch.randn(3, 3, 3, cin, cout, device=cuda, generator=g) / (27 * cin) ** 0.5
    b0 = torch.randn(cout, device=cuda, generator=g)
    dy = torch.randn(b, d, cout, h * w, device=cuda, generator=g).to(dtype)

    def grads(fn):
        x, wt, bias = (t.clone().requires_grad_(True) for t in (x0, w0, b0))
        fn(x, wt, bias, w).backward(dy)
        return x.grad, wt.grad, bias.grad

    K.reset_launches()
    dx, dw, db = grads(K.conv3x3_packed)
    assert (K.conv3x3_packed.launches, K.conv3x3_packed_dgrad.launches,
            K.conv3x3_wgrad.launches) == (1, 1, 1)
    rdx, rdw, rdb = grads(K.conv3x3_packed_plain)
    assert dx.dtype == dtype and dw.dtype == db.dtype == torch.float32
    # bf16: dx rounds once on both sides (one bf16 ulp apart at most); the
    # plain dw passes back through w's cast to bf16, so it is rounded.
    rtol = 1e-4 if dtype == torch.float32 else 2 ** -7
    _close(dx, rdx, rtol, 1e-4)
    _close(dw, rdw, rtol, 1e-4)
    _close(db, rdb, 1e-5, 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("c", [1, 3, 6, 8, 16, 24, 40, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_pack_unpack_exact(cuda, c, dtype):
    """Both relayouts are exact copies on both kernel paths: C ≤ 16 with
    whole 16-byte vectors of pixels takes the narrow path (H·W 512 and
    4096), the rest the tiles (H·W 95, and C 24 and up)."""
    from unet_bssfp_tpu_torch.ops.kernels import layout as L

    for h, w in ((16, 32), (5, 19), (64, 64)):
        x = torch.randn(2, 3, h, w, c, device=cuda).to(dtype)
        narrow = L.transpose_path(h * w, c, x.element_size()) != L.PATH_TILES
        assert narrow == (c <= 16 and h * w != 95)
        xk = K.pack_hw(x)
        assert torch.equal(xk, K.pack_hw_plain(x))
        assert torch.equal(K.unpack_hw(xk, w), x)
        assert torch.equal(K.unpack_hw_plain(xk, w), x)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 16, 16, 16, 64), (2, 4, 4, 4, 512)])
@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 0.0, 1e-4),
                                             (torch.bfloat16, 2 ** -7, 1e-2)])
def test_gpu_fused_norm_act_matches_plain(cuda, shape, dtype, rtol, atol):
    """Seeded inputs (as :func:`_norm_inputs`). f32: the moments summed in
    another order. bf16: the output rounds once on either side, so the two
    may land one bf16 ulp (at most 2^-7·|ref|) apart, + 1e-2 as in the
    smoke's phase 4."""
    g = torch.Generator(device="cuda").manual_seed(shape[-1] + shape[1])
    x = torch.randn(shape, device=cuda, generator=g).to(dtype)
    s = torch.randn(shape[-1], device=cuda, generator=g)
    b = torch.randn(shape[-1], device=cuda, generator=g)
    got = K.fused_instance_norm_leaky_relu(x, s, b, 0.1).float()
    ref = K.instance_norm_leaky_relu_plain(x, s, b, 0.1).float()
    torch.testing.assert_close(got, ref, rtol=rtol, atol=atol)


# K4 at the plain-layer stage shapes of serving under use_pallas (patch B 8,
# whole volume B 1) and at odd ones: C 3 and 24 (no 16-byte vector), S 1, 7
# and 513, B 1-8, and C past one channel group (f32 4100, bf16 8200).
NORM_SERVING = [(n,) + tuple(s >> level for s in base) + (c,)
                for n, base in ((8, (32, 32, 32)), (1, (48, 64, 64)))
                for level, c in enumerate((64, 128, 256, 512))]
NORM_ODD = [(1, 1, 1, 1, 3), (8, 1, 1, 1, 24), (3, 1, 1, 7, 3), (2, 7, 1, 1, 24),
            (1, 1, 27, 19, 24), (5, 1, 3, 171, 3), (4, 3, 3, 3, 40)]


def _norm_inputs(shape, dtype, device):
    c = shape[-1]
    g = torch.Generator(device="cuda").manual_seed(c + shape[0])
    x = (3 * torch.randn(shape, device=device, generator=g) + 1).to(dtype)
    s = 1 + 0.1 * torch.randn(c, device=device, generator=g)
    b = 0.1 * torch.randn(c, device=device, generator=g)
    return x, s, b


def _assert_norm_close(got, ref, dtype):
    # the smoke's bounds: f32, moments summed in another order; bf16, the
    # output rounds once, so the two may land one bf16 ulp apart
    rtol, atol = (1e-5, 1e-4) if dtype == torch.float32 else (2 ** -7, 1e-2)
    err = (got.float() - ref.float()).abs()
    assert bool((err <= atol + rtol * ref.float().abs()).all()), float(err.max())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", NORM_SERVING + NORM_ODD + [(1, 1, 1, 5, 4100), (1, 1, 1, 3, 8200)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_fused_norm_act_stage_and_odd_shapes(cuda, shape, dtype):
    x, s, b = _norm_inputs(shape, dtype, cuda)
    K.reset_launches()
    got = K.fused_instance_norm_leaky_relu(x, s, b, 0.1)
    assert K.fused_instance_norm_leaky_relu.launches == 1
    assert got.dtype == dtype and got.shape == x.shape
    _assert_norm_close(got, K.instance_norm_leaky_relu_plain(x, s, b, 0.1), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_fused_norm_act_reruns_bit_for_bit_and_raises(cuda, dtype):
    """Every sum runs in the plan's fixed order: a rerun gives the same bits.
    One launch per call; an input off the 16-byte alignment takes narrower
    vectors; a non-contiguous input, another dtype or a scale on another
    device raises (no fallback)."""
    x, s, b = _norm_inputs((8, 32, 32, 32, 64), dtype, cuda)
    K.reset_launches()
    first = K.fused_instance_norm_leaky_relu(x, s, b, 0.1)
    assert all(torch.equal(first, K.fused_instance_norm_leaky_relu(x, s, b, 0.1))
               for _ in range(3))
    assert K.fused_instance_norm_leaky_relu.launches == 4
    shape = (2, 5, 6, 7, 24)
    buf = torch.zeros(1 + math.prod(shape), device=cuda, dtype=dtype)
    odd = buf[1:].view(shape)
    odd.copy_(_norm_inputs(shape, dtype, cuda)[0])
    assert odd.is_contiguous() and odd.data_ptr() % 16
    sc, bc = s[:24].contiguous(), b[:24].contiguous()
    _assert_norm_close(K.fused_instance_norm_leaky_relu(odd, sc, bc, 0.2),
                       K.instance_norm_leaky_relu_plain(odd, sc, bc, 0.2), dtype)
    with pytest.raises(ValueError):
        K.fused_instance_norm_leaky_relu(x.transpose(1, 2), s, b)
    with pytest.raises(TypeError):
        K.fused_instance_norm_leaky_relu(x.half(), s, b)
    with pytest.raises(ValueError):
        K.fused_instance_norm_leaky_relu(x, s.cpu(), b)
    assert K.fused_instance_norm_leaky_relu.launches == 5


# K10, the packed stages' norm → dropout → activation → guards → cast
# (ops/kernels/packed_norm_act.py), at the cells' shapes: (B, D, C, H·wdim),
# wdim, wguard, PReLU, train (dropout 0.05, forward and backward) or eval.
PNA_CASES = {
    "gan-train-b16": ((16, 64, 32, 4096), 64, 0, False, True),
    "serve-cohort-b32": ((32, 64, 32, 4096), 64, 0, False, False),
    "multistage-48": ((8, 64, 48, 4096), 64, 0, True, True),
    "multistage-24": ((8, 64, 24, 4096), 64, 0, True, True),
    "whole-volume": ((1, 96, 32, 16384), 128, 0, False, False),
    "wguard": ((4, 64, 32, 64 * 66), 66, 2, False, True),
}


def _pna_operands(cuda, shape, prelu, train, dtype=torch.bfloat16, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[2]
    off = 2 * torch.randn(1, 1, c, 1, device=cuda, generator=g)
    x = (torch.randn(shape, device=cuda, generator=g) + off).to(dtype)
    scale = 1 + 0.2 * torch.randn(c, device=cuda, generator=g)
    bias = 0.2 * torch.randn(c, device=cuda, generator=g)
    slope = 0.1 + 0.05 * torch.randn(c, device=cuda, generator=g) if prelu else 0.1
    draw = torch.empty(shape, device=cuda).bernoulli_(0.95, generator=g) if train else None
    dy = torch.randn(shape, device=cuda, generator=g).to(dtype) if train else None
    return x, scale, bias, slope, draw, dy


def _pna_run(fn, x, scale, bias, slope, draw, dy, wdim, wguard, out_dtype):
    """(y, dx, dscale, dbias[, dslope]) of ``fn`` (the outputs alone in eval)."""
    prelu = isinstance(slope, torch.Tensor)
    leaves = [t.detach().requires_grad_(dy is not None)
              for t in [x, scale, bias] + ([slope] if prelu else [])]
    # keep 0.95 in eval too, as the blocks pass it: it scales only with a draw
    y = fn(leaves[0], leaves[1], leaves[2], leaves[3] if prelu else slope, wdim, wguard, draw,
           0.95, 1e-5, out_dtype)
    if dy is None:
        return [y.detach()]
    y.backward(dy.to(y.dtype))
    return [y.detach()] + [t.grad for t in leaves]


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(PNA_CASES))
def test_gpu_packed_norm_act_matches_plain_and_reruns_bit_for_bit(cuda, case):
    """K10 against the plain chain on the card, both measured against the
    plain chain in f64 on the card: y and dx in bf16 (each side rounds its
    result once, so the kernel may not stray more than twice the plain
    chain's error, or one bf16 rounding, 2^-8 of max|ref|); dscale, dbias
    and dslope in f32 (sums of up to 4.2 M terms in other fixed orders: twice
    the plain chain's error, or 2^-20 of max|ref|). A rerun gives equal
    bits; a call is one forward (and one backward) launch."""
    shape, wdim, wguard, prelu, train = PNA_CASES[case]
    ops = _pna_operands(cuda, shape, prelu, train)
    x = ops[0]
    K.reset_launches()
    got = _pna_run(K.packed_norm_act, *ops, wdim, wguard, torch.bfloat16)
    assert (K.packed_norm_act.launches, K.packed_norm_act_backward.launches) == (1, int(train))
    again = _pna_run(K.packed_norm_act, *ops, wdim, wguard, torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    plain = _pna_run(K.packed_norm_act_plain, *ops, wdim, wguard, torch.bfloat16)
    ref = _pna_run(K.packed_norm_act_plain, x.double(), *ops[1:], wdim, wguard, torch.float64)
    assert len(got) == (4 + prelu if train else 1)
    for a, p, r in zip(got, plain, ref):
        floor = (2 ** -8 if a.dtype == torch.bfloat16 else 2 ** -20) * float(r.abs().max())
        err = float((a.double() - r).abs().max())
        assert err <= max(2 * float((p.double() - r).abs().max()), floor)
    if wguard:
        for t in got[:2]:
            assert not t.unflatten(-1, (-1, wdim))[..., wdim - wguard:].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,out_dtype,shape,wdim,wguard", [
    (torch.float32, torch.float32, (2, 16, 24, 1024), 32, 0),
    (torch.bfloat16, torch.float32, (2, 3, 5, 42), 7, 1),      # rows of 42: no 16-byte loads
    (torch.float32, torch.float32, (1, 5, 3, 6 * 10), 10, 2),
])
def test_gpu_packed_norm_act_other_dtypes_and_odd_rows(cuda, dtype, out_dtype, shape, wdim,
                                                       wguard):
    """f32 in and out, and bf16 in with f32 out (``compute_dtype`` unset),
    at shapes whose rows take 1-element loads: PReLU, train, against the
    same bounds (f32: 2^-20 of max|ref|)."""
    ops = _pna_operands(cuda, shape, True, True, dtype)
    got = _pna_run(K.packed_norm_act, *ops, wdim, wguard, out_dtype)
    plain = _pna_run(K.packed_norm_act_plain, *ops, wdim, wguard, out_dtype)
    ref = _pna_run(K.packed_norm_act_plain, ops[0].double(), *ops[1:], wdim, wguard,
                   torch.float64)
    assert got[0].dtype == out_dtype and got[1].dtype == dtype
    for a, p, r in zip(got, plain, ref):
        floor = (2 ** -8 if a.dtype == torch.bfloat16 else 2 ** -20) * float(r.abs().max())
        err = float((a.double() - r).abs().max())
        assert err <= max(2 * float((p.double() - r).abs().max()), floor)


@pytest.mark.gpu
def test_gpu_packed_norm_act_refuses_what_the_kernels_do_not_take(cuda):
    """No fallback for a CUDA tensor: f16 or f64, a scale off the card or not
    f32, a draw of another shape raise before any launch."""
    x, scale, bias, _, draw, _ = _pna_operands(cuda, (2, 4, 8, 256), False, True)
    K.reset_launches()
    for bad in (x.half(), x.double()):
        with pytest.raises(TypeError):
            K.packed_norm_act(bad, scale, bias, 0.1, 16)
    with pytest.raises(ValueError):
        K.packed_norm_act(x, scale.cpu(), bias, 0.1, 16)
    with pytest.raises(ValueError):
        K.packed_norm_act(x, scale.double(), bias, 0.1, 16)
    with pytest.raises(ValueError):
        K.packed_norm_act(x, scale, bias, 0.1, 16, 0, draw[:1], 0.95)
    assert K.packed_norm_act.launches == 0


@pytest.mark.gpu
def test_gpu_packed_norm_act_masks_are_the_reference_draws(cuda):
    """The 1-byte mask K10 keeps for the backward is the benchmark
    reference's dropout mask (``portbench/reference/models.py::Masks``)
    drawn from the same generator state, element for element; it drops what
    the plain chain drops."""
    import importlib

    from portbench.reference.models import Masks

    pna = importlib.import_module("unet_bssfp_tpu_torch.ops.kernels.packed_norm_act")
    from unet_bssfp_tpu_torch.models.packed_layers import PackedConvNormAct

    b, d, c, h, w = 2, 16, 32, 16, 16
    block = PackedConvNormAct(24, c, dropout=0.05, compute_dtype=torch.bfloat16).to(cuda).train()
    x = torch.randn(b, d, c, h * w, device=cuda).bfloat16()
    gen = torch.Generator(device="cuda").manual_seed(11)
    block.drop.generator = gen
    state = gen.get_state()
    draw = block.drop.draw(x)
    spec = pna._spec(x, 0.1, w, 0, draw, block.drop.keep, 1e-5, torch.bfloat16)
    _, _, _, mask = pna._cuda_forward(x, block.norm.weight, block.norm.bias, None, draw,
                                      spec, True)
    gen.set_state(state)
    ref = Masks(gen, 0.05).draw((b, c, d, h, w), packed=True)  # NCDHW view
    assert torch.equal(mask.bool(), ref.permute(0, 2, 1, 3, 4).reshape(b, d, c, h * w))
    assert 0 < int((~mask.bool()).sum()) < mask.numel()


@pytest.mark.gpu
def test_gpu_cuda_tensors_never_reach_the_plain_chain(cuda, monkeypatch):
    """With the plain chain made to raise, a packed bf16 GAN step (dropout
    on), a FINE_TUNE step and a serving forward still run on the card: every
    packed block of every generator pass and its backward takes K10 (8 + 4
    a GAN step, 4 + 4 a supervised step, 4 a forward)."""
    import importlib

    from unet_bssfp_tpu_torch.config import ModelConfig, TrainConfig
    from unet_bssfp_tpu_torch.models import TrainingState
    from unet_bssfp_tpu_torch.train import multistage as ms
    from unet_bssfp_tpu_torch.train.state import create_gan_state
    from unet_bssfp_tpu_torch.train.steps import make_predict_fn, make_train_step

    pna = importlib.import_module("unet_bssfp_tpu_torch.ops.kernels.packed_norm_act")

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain chain")

    monkeypatch.setattr(pna, "packed_norm_act_plain", refuse)
    cfg = _loop_config(Path("."))
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.rand(2, 32, 32, 32, 24, device=cuda, generator=g)
    y = torch.rand(2, 32, 32, 32, 6, device=cuda, generator=g)
    st = create_gan_state(0, "pc-bssfp", cfg.model, cfg.train, cuda)
    K.reset_launches()
    make_train_step(st.gen, st.disc, cfg.train)(st, x, y)
    torch.cuda.synchronize()
    assert (K.packed_norm_act.launches, K.packed_norm_act_backward.launches) == (8, 4)
    K.reset_launches()
    make_predict_fn(st.gen)(x)
    assert (K.packed_norm_act.launches, K.packed_norm_act_backward.launches) == (4, 0)
    net = ms.build_multi_input_unet("pc-bssfp", ModelConfig(), cuda)
    state = ms.create_supervised_state(0, net, TrainConfig(), TrainingState.FINE_TUNE)
    K.reset_launches()
    ms.make_supervised_train_step(net, TrainConfig())(state, x[:1], y[:1])
    torch.cuda.synchronize()
    assert (K.packed_norm_act.launches, K.packed_norm_act_backward.launches) == (4, 4)


@pytest.mark.gpu
@pytest.mark.parametrize("use_pallas", [False, True])
def test_gpu_generator_packed_matches_plain(cuda, use_pallas):
    """The whole serving forward: packed kernels (K1, K3, K4) against the
    same weights on plain PyTorch/cuDNN, f32."""
    import dataclasses

    from unet_bssfp_tpu_torch import weights
    from unet_bssfp_tpu_torch.config import ModelConfig
    from unet_bssfp_tpu_torch.train.state import build_models
    from unet_bssfp_tpu_torch.train.steps import make_predict_fn

    mcfg = ModelConfig(features=(8, 16, 16, 32, 32, 8), compute_dtype="float32")
    plain, _ = build_models("pc-bssfp", dataclasses.replace(mcfg, packed=False), cuda)
    sd = weights.random_state_dict(plain, 0)
    plain.load_state_dict(sd)
    kern, _ = build_models("pc-bssfp", dataclasses.replace(
        mcfg, packed=True, use_pallas=use_pallas), cuda, state_dict=sd)
    x = torch.randn(2, 32, 32, 32, 24, device=cuda)
    K.reset_launches()
    got = make_predict_fn(kern)(x)
    assert K.conv3x3_packed.launches == 4 and K.unpack_hw.launches == 1
    assert (K.fused_instance_norm_leaky_relu.launches > 0) == use_pallas
    ref = make_predict_fn(plain)(x)
    torch.testing.assert_close(got, ref, rtol=1e-3, atol=1e-4)


@pytest.mark.gpu
def test_gpu_generator_phase_grads_packed_match_plain(cuda):
    """One generator-phase backward: kernels (f32, packed, use_pallas: K1,
    K1 dgrad, K2, K3 both ways, K4) against plain PyTorch/cuDNN in f32 on the
    same weights, every parameter, and the launch counts of that backward."""
    import dataclasses

    from unet_bssfp_tpu_torch import weights
    from unet_bssfp_tpu_torch.config import ModelConfig
    from unet_bssfp_tpu_torch.ops.losses import bce_with_logits, l1_loss
    from unet_bssfp_tpu_torch.train.state import build_models

    mcfg = ModelConfig(features=(8, 16, 16, 32, 32, 8), disc_features=(8, 16, 32),
                       compute_dtype="float32", dropout=0.0)
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(2, 32, 32, 32, 24, device=cuda, generator=g)
    y = torch.rand(2, 32, 32, 32, 6, device=cuda, generator=g) + 10.0  # no L1 sign flips
    grads = {}
    for kern in (False, True):
        gen, disc = build_models("pc-bssfp", dataclasses.replace(
            mcfg, packed=kern, use_pallas=kern), cuda)
        gen.load_state_dict(weights.random_state_dict(gen, 0))
        disc.load_state_dict(weights.random_state_dict(disc, 1))
        disc.requires_grad_(False)
        K.reset_launches()
        y_hat = gen(x)
        logits = disc(x, y_hat)
        (bce_with_logits(logits, torch.ones_like(logits)) + 100 * l1_loss(y_hat, y)).backward()
        grads[kern] = {n: p.grad for n, p in gen.named_parameters()}
    assert (K.conv3x3_packed.launches, K.conv3x3_packed_dgrad.launches,
            K.conv3x3_wgrad.launches, K.pack_hw.launches, K.unpack_hw.launches) == (4, 4, 4, 3, 3)
    scale = max(float(v.abs().max()) for v in grads[False].values())
    for name, ref in grads[False].items():
        got = grads[True][name]
        if name.endswith(".conv.bias"):
            # true gradient 0 under the following norm: noise, bounded absolutely
            assert float((got - ref).abs().max()) <= 1e-4 * scale, name
        else:
            # relative L2: f32 gradients of this net flip max-pool routing and
            # LeakyReLU kinks under rounding; measured on an H100, plain f32
            # strays from f64 by up to 1e-2
            # (scripts/torch_port_grad_conditioning.py). 5e-2 is five times
            # that and a twentieth of a cut graph's 1.0.
            err = float((got - ref).norm() / ref.norm())
            assert err <= 5e-2, (name, err)


# K8. The kernel follows its plain version step for step with correctly
# rounded division and square root, but contracts a·b + c into FMAs and
# takes 1/sqrt(t² + 1) as one correctly rounded reciprocal square root, so
# the two are not bit-equal: they are held to the bound two f32
# implementations of the maps obey (compare_scalar_maps, derived beside it),
# angles only where defined, zero voxels exactly.
def _edge_tensors():
    """Zero, diagonal, isotropic, repeated-eigenvalue and 1e-3/1e3-scaled
    matrices, (n, 6)."""
    g = torch.Generator().manual_seed(3)
    rnd = torch.randn(64, 6, generator=g)
    diag = torch.zeros(64, 6)
    diag[:, [0, 3, 5]] = torch.randn(64, 3, generator=g)
    q, _ = torch.linalg.qr(torch.randn(64, 3, 3, generator=g, dtype=torch.float64))
    lam = torch.rand(64, 3, generator=g, dtype=torch.float64) + 0.1
    lam[:32, 1] = lam[:32, 2]
    lam[32:, 0] = lam[32:, 1]
    lam[48:, 2] = lam[48:, 1]
    mats = q @ torch.diag_embed(lam) @ q.transpose(-1, -2)
    rep = mats[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]].float()
    return torch.cat([torch.zeros(8, 6), rnd, 1e-3 * rnd, 1e3 * rnd, diag, rep])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(5, 7, 3), (97, 33, 3), (96, 128, 128), "edge"])
def test_gpu_scalar_maps_matches_plain_and_repeats(cuda, shape):
    if shape == "edge":
        d6 = _edge_tensors().to(cuda)
    else:
        d6 = torch.from_numpy(chk.sample_dt_volume(shape, 7)).to(cuda)
    K.reset_launches()
    got = K.scalar_maps(d6)
    assert K.scalar_maps.launches == 1
    assert [tuple(f.shape) for f in got] == [tuple(d6.shape[:-1])] * 6 + [tuple(d6.shape[:-1]) + (3,)]
    res = chk.compare_scalar_maps(got, K.scalar_maps_plain(d6), d6)
    assert res["ok"], res
    zero = (d6 == 0).all(-1)
    assert zero.any()
    for f in got:
        assert torch.all(f[zero] == 0)
    # no reduction, each voxel's chain on its own: the same bits on a second
    # launch
    assert all(torch.equal(a, b) for a, b in zip(got, K.scalar_maps(d6)))


@pytest.mark.gpu
def test_gpu_scalar_maps_takes_bf16_and_strided_input(cuda):
    d6 = torch.from_numpy(chk.sample_dt_volume((6, 9, 11), 8)).to(cuda)
    wide = torch.zeros(6, 9, 11, 8, device=cuda)
    wide[..., 1:7] = d6
    # contiguous, but 4 bytes off the 8-byte alignment of the kernel's loads
    buf = torch.zeros(1 + d6.numel(), device=cuda)
    odd = buf[1:].view(d6.shape)
    odd.copy_(d6)
    assert odd.is_contiguous() and odd.data_ptr() % 8 == 4
    for x in (d6.to(torch.bfloat16), wide[..., 1:7], odd):
        got = K.scalar_maps(x)
        ref = K.scalar_maps(x.float().clone())  # a fresh, aligned copy
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    with pytest.raises(ValueError):
        K.scalar_maps(torch.zeros(4, 5, device=cuda))


@pytest.mark.gpu
def test_gpu_eval_chain_matches_cpu(cuda, tmp_path):
    """The eval chain on the card (K8) against the same chain on the CPU
    (plain versions), on a small synthetic tree: the written maps and the
    error table. Maps: the K8 bound above; every file: that bound carried
    through the chain (``chain_bounds``); table cells:
    ``compare_error_tables`` with each cell's share of its diff map's bound
    (K8 contracts a·b + c into FMAs, so its maps are not the CPU's bit for
    bit), on top of one f32 rounding of each f64 sum."""
    import os
    import shutil

    from unet_bssfp_tpu_torch.data.nifti import load_volume, save_volume
    from unet_bssfp_tpu_torch.data.synthetic import make_synthetic_bids
    from unet_bssfp_tpu_torch.eval import evaluate
    from unet_bssfp_tpu_torch.ops.scalar_maps import ScalarMaps

    bids = make_synthetic_bids(str(tmp_path / "bids"), subjects=("01", "02"),
                               sessions=("1",), volume_shape=(12, 16, 20))
    pred_dir = tmp_path / "cuda" / "pc-bssfp"
    pred_dir.mkdir(parents=True)
    g = torch.Generator().manual_seed(0)
    for i, sub in enumerate(("01", "02")):
        tgt, aff = load_volume(f"{bids}/derivatives/preproc-dove/sub-{sub}/ses-1/dwi/"
                               f"sub-{sub}_ses-1_desc-normtensor_dwi.nii.gz")
        pred = (torch.from_numpy(tgt) + 0.1 * torch.randn(tgt.shape, generator=g)).clamp(0, 1)
        save_volume(str(pred_dir / f"pred-{i}_mod-pc-bssfp_sub-{sub}_ses-1.nii.gz"),
                    pred.numpy(), aff)
        save_volume(str(pred_dir / f"target-{i}_mod-pc-bssfp_sub-{sub}_ses-1.nii.gz"), tgt, aff)
    shutil.copytree(tmp_path / "cuda", tmp_path / "cpu")
    rescale = str(Path(__file__).resolve().parents[1] / "constants" / "rescale_args_dwi.txt")
    tables = {}
    for dev in ("cuda", "cpu"):
        K.reset_launches()
        evaluate.eval_dwi_tensors(str(tmp_path / dev / "pc-bssfp"), rescale, device=dev)
        tables[dev] = evaluate.calc_error_table(str(tmp_path / dev), bids, device=dev)
        assert K.scalar_maps.launches == (4 if dev == "cuda" else 0)
    assert len(tables["cuda"]) == 6
    for i, sub in enumerate(("01", "02")):
        for kind in ("pred", "target"):
            base = f"{kind}-{i}_mod-pc-bssfp_sub-{sub}_ses-1"
            d6 = torch.from_numpy(load_volume(str(tmp_path / "cpu" / "pc-bssfp" /
                                                  f"{base}_denorm.nii.gz"))[0])
            # a 3-D map is read back with a trailing channel axis
            maps = {dev: [torch.from_numpy(load_volume(
                str(tmp_path / dev / "pc-bssfp" / f"{base}_{name}.nii.gz"))[0])
                .reshape(d6.shape[:-1] + (-1,)).squeeze(-1)
                for name in ScalarMaps._fields] for dev in ("cuda", "cpu")}
            res = chk.compare_scalar_maps(maps["cuda"], maps["cpu"], d6)
            assert res["ok"], (base, res)
    from unet_bssfp_tpu_torch.ops.scalar_maps import load_rescale_args

    files = {dev: {fn: load_volume(os.path.join(tmp_path, dev, "pc-bssfp", fn))[0]
                   for fn in sorted(os.listdir(tmp_path / dev / "pc-bssfp"))}
             for dev in ("cuda", "cpu")}
    bounds = chk.chain_bounds(files["cpu"], load_rescale_args(rescale))
    res = chk.compare_chain_files(files["cuda"], files["cpu"], bounds)
    assert res["ok"], res["failures"]
    masks, probsegs = evaluate._load_masks(bids, ("01", "02"), "derivatives/preproc-dove",
                                           torch.device("cpu"))
    cells = chk.table_cell_bounds(tables["cpu"], files["cuda"], files["cpu"], bounds, masks,
                                  probsegs)
    assert chk.compare_error_tables(tables["cuda"], tables["cpu"], cells) == []


# K5: the conv on an input with a real d halo, its dgrad and its wgrad, at
# odd shapes: Cin 3/24/96, Cout 4/32, one or two local d slices, a W that is
# no multiple of the kernel's 32-column tile. The halo slices are random, so
# an off-by-one between the D + 2 input slices and the D output slices shows.
HALO_SHAPES = [(2, 1, 6, 48, 3, 4), (1, 2, 9, 35, 24, 32), (2, 2, 8, 40, 96, 4),
               (2, 8, 32, 32, 24, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,d,h,w,cin,cout", HALO_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_halo_conv_autograd_matches_plain(cuda, b, d, h, w, cin, cout, dtype):
    g = torch.Generator(device="cuda").manual_seed(cin * cout + d)
    x0 = torch.randn(b, d + 2, cin, h * w, device=cuda, generator=g).to(dtype)
    w0 = torch.randn(3, 3, 3, cin, cout, device=cuda, generator=g) / (27 * cin) ** 0.5
    b0 = torch.randn(cout, device=cuda, generator=g)
    dy = torch.randn(b, d, cout, h * w, device=cuda, generator=g).to(dtype)

    def run(fn):
        x, wt, bias = (t.clone().requires_grad_(True) for t in (x0, w0, b0))
        y = fn(x, wt, bias, w)
        y.backward(dy)
        return y.detach(), x.grad, wt.grad, bias.grad

    K.reset_launches()
    y, dx, dw, db = run(K.conv3x3_packed_halo)
    assert (K.conv3x3_packed_halo.launches, K.conv3x3_packed_halo_dgrad.launches,
            K.conv3x3_wgrad_halo.launches, K.conv3x3_packed.launches) == (1, 1, 1, 0)
    ry, rdx, rdw, rdb = run(K.conv3x3_packed_halo_plain)
    assert y.shape == (b, d, cout, h * w) and dx.shape == x0.shape
    assert dx.dtype == dtype and dw.dtype == db.dtype == torch.float32
    # the tolerances of K1 and of its autograd test above
    tol = (dict(rtol=1e-5, atol=1e-4) if dtype == torch.float32
           else dict(rtol=2 ** -7, atol=1e-2))
    torch.testing.assert_close(y.float(), ry.float(), **tol)
    rtol = 1e-4 if dtype == torch.float32 else 2 ** -7
    _close(dx, rdx, rtol, 1e-4)
    _close(dw, rdw, rtol, 1e-4)
    _close(db, rdb, 1e-5, 1e-5)
    # the gradient kernels alone against their own plain versions
    _close(K.conv3x3_packed_halo_dgrad(dy, w0, w),
           K.conv3x3_packed_halo_dgrad_plain(dy, w0, w), rtol, 1e-4)
    chain = K.conv3x3_wgrad_chain(x0, dy, w)
    got = K.conv3x3_wgrad_halo(x0, dy, w)
    _close(got, K.conv3x3_wgrad_halo_plain(x0, dy, w), 0.0,
           16 * math.sqrt(chain) * 2 ** -24)
    assert torch.equal(got, K.conv3x3_wgrad_halo(x0, dy, w))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_halo_conv_of_zero_halo_is_k1(cuda, dtype):
    """Zero halo slices add only zero products in K1's order: bit-equal."""
    xk = torch.randn(2, 5, 24, 16 * 32, device=cuda).to(dtype)
    wt = torch.randn(3, 3, 3, 24, 32, device=cuda) * 0.1
    bias = torch.randn(32, device=cuda)
    zero = torch.zeros_like(xk[:, :1])
    got = K.conv3x3_packed_halo(torch.cat([zero, xk, zero], 1), wt, bias, 32)
    assert torch.equal(got, K.conv3x3_packed(xk, wt, bias, 32))


@pytest.mark.gpu
def test_gpu_halo_conv_raises_instead_of_falling_back(cuda):
    xp = torch.randn(1, 4, 3, 128, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        K.conv3x3_packed_halo(xp, torch.randn(3, 3, 3, 3, 4, device=cuda),
                              torch.zeros(4, device=cuda), 32)
    with pytest.raises(ValueError):  # nothing but halo
        K.conv3x3_packed_halo(torch.randn(1, 2, 3, 128, device=cuda),
                              torch.randn(3, 3, 3, 3, 4, device=cuda),
                              torch.zeros(4, device=cuda), 32)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,whole", [((1, 2), True), ((2, 2), False), ((1, 1), True)])
def test_gpu_mesh_serving_small_matches_unsharded(cuda, shape, whole):
    """A narrow generator serves a (32, 32, 32) volume on a mesh whose
    positions all lie on cuda:0: the f32 output within 1e-5·max|ref| of the
    unsharded one (only the norms' summation order differs), through K5
    exactly where the mesh has a space split."""
    import dataclasses

    from unet_bssfp_tpu_torch import weights
    from unet_bssfp_tpu_torch.config import Config
    from unet_bssfp_tpu_torch.eval.inference import predict_volume
    from unet_bssfp_tpu_torch.parallel.mesh import make_mesh
    from unet_bssfp_tpu_torch.train.state import build_models
    from unet_bssfp_tpu_torch.train.steps import make_predict_fn

    mcfg = dataclasses.replace(Config().model, features=(8, 16, 16, 32, 32, 8),
                               compute_dtype="float32", packed=True)
    gen, _ = build_models("pc-bssfp", mcfg, "cuda")
    sd = weights.random_state_dict(gen, 0)
    gen.load_state_dict(sd)
    vol = torch.randn(32, 32, 32, 24, generator=torch.Generator().manual_seed(1)).to(cuda)
    kw = dict(patch_size=16 * shape[1], batch_size=8, whole_volume=whole)
    ref = predict_volume(make_predict_fn(gen), vol, **kw)
    mesh = make_mesh(["cuda:0"], ("data", "space"), shape)
    gen_m, _ = build_models("pc-bssfp", mcfg, state_dict=sd, mesh=mesh)
    K.reset_launches()
    got = predict_volume(make_predict_fn(gen_m, mesh), vol, mesh=mesh, **kw)
    counts = K.launches()
    assert (counts["conv3x3_packed_halo"] > 0) == (shape[1] > 1)
    assert (counts["conv3x3_packed"] > 0) == (shape[1] == 1)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.gpu
def test_gpu_mesh_replicas_on_two_cards(cuda):
    """With two cards: one replica per card, bit-equal weights, and the
    (1, 2) mesh over both serves what one card serves."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    import dataclasses

    from unet_bssfp_tpu_torch.config import Config
    from unet_bssfp_tpu_torch.parallel.mesh import make_mesh, replicas
    from unet_bssfp_tpu_torch.train.state import build_models
    from unet_bssfp_tpu_torch.train.steps import make_predict_fn

    mcfg = dataclasses.replace(Config().model, features=(8, 16, 16, 32, 32, 8),
                               compute_dtype="float32", packed=True)
    mesh = make_mesh(["cuda:0", "cuda:1"], ("data", "space"), (1, 2))
    gen, _ = build_models("pc-bssfp", mcfg, mesh=mesh)
    a, b = replicas(gen)
    assert all(torch.equal(p.cpu(), q.cpu()) for p, q in
               zip(a.state_dict().values(), b.state_dict().values()))
    x = torch.randn(1, 32, 32, 32, 24, device=cuda)
    ref = make_predict_fn(gen)(x)
    got = make_predict_fn(gen, mesh)(x)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


# K7a/K7b: the conv on the phase-major w-folded layout, its halo form and
# their gradients, at odd shapes (Cin 3 and 5, W/4 2, 3 and 9, H 3, Cout past
# one 32-channel block), which run the mma.sync loops, and shapes the wgmma
# kernels take: W/4 8 and 24 (the conv kernel only), 16 and 32 (both; two w
# tiles at 32) and one stage shape. The halo slices are random.
PFOLD_SHAPES = [(2, 3, 3, 8, 3, 4), (1, 4, 7, 12, 5, 36), (1, 2, 3, 36, 24, 32),
                (2, 4, 16, 64, 96, 32), (1, 3, 5, 32, 24, 32), (1, 2, 4, 96, 5, 6),
                (1, 2, 5, 128, 32, 32)]


def _pfold_routes(b, d, h, w, cin, cout, dtype):
    """(conv, wgrad): whether the wgmma kernels take the folded shape (bf16
    only; the plans are static)."""
    if dtype != torch.bfloat16:
        return False, False
    xf = torch.empty(b, d, 4 * cin, h * w // 4, dtype=dtype)
    dy = torch.empty(b, d, 4 * cout, h * w // 4, dtype=dtype)
    return (K.conv_plan(xf, cout, w // 4, fold=True) is not None,
            K.wgrad_plan(xf, dy, w // 4, fold=True) is not None)


def _pfold_operands(b, d, h, w, cin, cout, dtype, halo):
    g = torch.Generator(device="cuda").manual_seed(cin * cout + d + h)
    x0 = torch.randn(b, d + 2 * halo, 4 * cin, h * w // 4, device="cuda", generator=g).to(dtype)
    w0 = torch.randn(3, 3, 3, cin, cout, device="cuda", generator=g) / (27 * cin) ** 0.5
    b0 = torch.randn(cout, device="cuda", generator=g)
    dy = torch.randn(b, d, 4 * cout, h * w // 4, device="cuda", generator=g).to(dtype)
    return x0, w0, b0, dy


@pytest.mark.gpu
@pytest.mark.parametrize("b,d,h,w,cin,cout", PFOLD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("halo", [False, True])
def test_gpu_pfold_autograd_matches_plain(cuda, b, d, h, w, cin, cout, dtype, halo):
    x0, w0, b0, dy = _pfold_operands(b, d, h, w, cin, cout, dtype, halo)
    conv, plain = ((K.conv3x3_pfold_halo, K.conv3x3_pfold_halo_plain) if halo
                   else (K.conv3x3_pfold, K.conv3x3_pfold_plain))

    def run(fn):
        x, wt, bias = (t.clone().requires_grad_(True) for t in (x0, w0, b0))
        y = fn(x, wt, bias, w // 4)
        y.backward(dy)
        return y.detach(), x.grad, wt.grad, bias.grad

    K.reset_launches()
    y, dx, dw, db = run(conv)
    counts = K.launches()
    names = (("conv3x3_pfold_halo", "conv3x3_pfold_halo_dgrad", "conv3x3_pfold_wgrad_halo")
             if halo else ("conv3x3_pfold", "conv3x3_pfold_dgrad", "conv3x3_pfold_wgrad"))
    # a bf16 shape the wgmma plans do not take also counts its mma.sync launches
    conv_wgmma_route, wgrad_wgmma_route = _pfold_routes(b, d, h, w, cin, cout, dtype)
    expected = dict.fromkeys(names, 1)
    if dtype == torch.bfloat16 and not conv_wgmma_route:
        expected["conv3x3_packed_mma_routed"] = 2
    if dtype == torch.bfloat16 and not wgrad_wgmma_route:
        expected["conv3x3_wgrad_mma_routed"] = 1
    assert {k: v for k, v in counts.items() if v} == expected
    ry, rdx, rdw, rdb = run(plain)
    assert y.shape == (b, d, 4 * cout, h * w // 4) and dx.shape == x0.shape
    assert dx.dtype == dtype and dw.dtype == db.dtype == torch.float32
    # K1's forward bound, and the bounds of K1's autograd test above
    tol = (dict(rtol=1e-5, atol=1e-4) if dtype == torch.float32
           else dict(rtol=2 ** -7, atol=1e-2))
    torch.testing.assert_close(y.float(), ry.float(), **tol)
    rtol = 1e-4 if dtype == torch.float32 else 2 ** -7
    _close(dx, rdx, rtol, 1e-4)
    _close(dw, rdw, rtol, 1e-4)
    _close(db, rdb, 1e-5, 1e-5)
    # K7b alone at K2's bound, and bit for bit on a second launch
    wgrad, wplain = ((K.conv3x3_pfold_wgrad_halo, K.conv3x3_pfold_wgrad_halo_plain) if halo
                     else (K.conv3x3_pfold_wgrad, K.conv3x3_pfold_wgrad_plain))
    got = wgrad(x0, dy, w // 4)
    chain = K.conv3x3_pfold_wgrad_chain(x0, dy, w // 4)
    _close(got, wplain(x0, dy, w // 4), 0.0, 16 * math.sqrt(chain) * 2 ** -24)
    assert torch.equal(got, wgrad(x0, dy, w // 4))


@pytest.mark.gpu
@pytest.mark.parametrize("b,d,h,w,cin,cout", PFOLD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_pfold_is_k1_and_k2_bit_for_bit(cuda, b, d, h, w, cin, cout, dtype):
    """K7a's four entries are, on the same volume, the packed conv's result
    folded, bit for bit, of the kernel the folded shape routes to: in bf16
    K1's wgmma kernel where the fold plan takes the shape (through K1's own
    entries), else the ``mma.sync`` loop (its check-only entry point
    ``conv3x3_packed_mma``); in f32 the FMA kernels. K7b on the wgmma
    kernel sums each item's pixels phase-major, so it is held to K2's bound
    (16·sqrt(L)·2^-24·max|ref|, L its plan's chain) of the plain version;
    on the loops (routed bf16, f32) it is their result bit for bit. A second
    launch of each is bit for bit the first."""
    from unet_bssfp_tpu_torch.ops.kernels.conv3d import _flip_t
    from unet_bssfp_tpu_torch.ops.kernels.pfold import _to_folded, _to_packed

    conv_wgmma_route, wgrad_wgmma_route = _pfold_routes(b, d, h, w, cin, cout, dtype)
    loop = dtype == torch.bfloat16 and not conv_wgmma_route

    def anchors(xk, dyk, wt, bias, halo):
        """The packed kernels K7a's forward and dgrad re-index."""
        wflip, zero = _flip_t(wt, dtype), torch.zeros(cin, device=cuda)
        if loop:
            return (K.conv3x3_packed_mma(xk, wt, bias, w, -2 if halo else 0),
                    K.conv3x3_packed_mma(dyk, wflip, zero, w, 2 if halo else 0))
        if halo:
            return (K.conv3x3_packed_halo(xk, wt, bias, w),
                    K.conv3x3_packed_halo_dgrad(dyk, wt, w))
        return K.conv3x3_packed(xk, wt, bias, w), K.conv3x3_packed_dgrad(dyk, wt, w)

    w4 = w // 4
    for halo in (False, True):
        xf, wt, bias, dyf = _pfold_operands(b, d, h, w, cin, cout, dtype, halo)
        xk, dyk = _to_packed(xf, w4).contiguous(), _to_packed(dyf, w4).contiguous()
        conv, dgrad, wgrad = ((K.conv3x3_pfold_halo, K.conv3x3_pfold_halo_dgrad,
                               K.conv3x3_pfold_wgrad_halo) if halo else
                              (K.conv3x3_pfold, K.conv3x3_pfold_dgrad, K.conv3x3_pfold_wgrad))
        y_pk, dx_pk = anchors(xk, dyk, wt, bias, halo)
        for folded, rerun, packed in ((conv(xf, wt, bias, w4), conv(xf, wt, bias, w4), y_pk),
                                      (dgrad(dyf, wt, w4), dgrad(dyf, wt, w4), dx_pk)):
            assert torch.equal(folded, _to_folded(packed, w)), halo
            assert torch.equal(folded, rerun), halo
        dw = wgrad(xf, dyf, w4)
        assert torch.equal(dw, wgrad(xf, dyf, w4)), halo
        if wgrad_wgmma_route:
            wplain = K.conv3x3_pfold_wgrad_halo_plain if halo else K.conv3x3_pfold_wgrad_plain
            chain = K.conv3x3_pfold_wgrad_chain(xf, dyf, w4)
            _close(dw, wplain(xf, dyf, w4), 0.0, 16 * math.sqrt(chain) * 2 ** -24)
        elif dtype == torch.bfloat16:
            assert torch.equal(dw, K.conv3x3_wgrad_mma(xk, dyk, w, int(halo))), halo
        else:
            ref = K.conv3x3_wgrad_halo(xk, dyk, w) if halo else K.conv3x3_wgrad(xk, dyk, w)
            assert torch.equal(dw, ref), halo


@pytest.mark.gpu
@pytest.mark.parametrize("b,d,h,w,cin,cout", PFOLD_SHAPES)
def test_gpu_pfold_routes_are_counted(cuda, b, d, h, w, cin, cout):
    """A bf16 folded launch the wgmma plans do not take runs the mma.sync
    loop and adds one to ``*_mma_routed`` besides its own count; one they
    take adds nothing there."""
    conv_wgmma_route, wgrad_wgmma_route = _pfold_routes(b, d, h, w, cin, cout, torch.bfloat16)
    for halo in (False, True):
        xf, wt, bias, dyf = _pfold_operands(b, d, h, w, cin, cout, torch.bfloat16, halo)
        conv, dgrad, wgrad = ((K.conv3x3_pfold_halo, K.conv3x3_pfold_halo_dgrad,
                               K.conv3x3_pfold_wgrad_halo) if halo else
                              (K.conv3x3_pfold, K.conv3x3_pfold_dgrad, K.conv3x3_pfold_wgrad))
        K.reset_launches()
        conv(xf, wt, bias, w // 4)
        dgrad(dyf, wt, w // 4)
        wgrad(xf, dyf, w // 4)
        counts = K.launches()
        assert (counts[conv.__name__], counts[dgrad.__name__], counts[wgrad.__name__]) == (1, 1, 1)
        assert counts["conv3x3_packed_mma_routed"] == 2 * (not conv_wgmma_route), halo
        assert counts["conv3x3_wgrad_mma_routed"] == int(not wgrad_wgmma_route), halo


@pytest.mark.gpu
def test_gpu_fold4_pack_unpack_exact(cuda):
    for c in (3, 24, 96):
        x = torch.randn(2, 3, 5, 12, c, device=cuda).bfloat16()
        xf = K.fold4_pack(x)
        assert torch.equal(xf, K.pack_hw_plain(x.reshape(2, 3, 5, 3, 4 * c)))
        assert torch.equal(K.unfold4_unpack(xf, 3), x)


@pytest.mark.gpu
def test_gpu_pfold_raises_instead_of_falling_back(cuda):
    xf = torch.randn(1, 4, 12, 64, device=cuda)
    wt, bias = torch.randn(3, 3, 3, 3, 4, device=cuda), torch.zeros(4, device=cuda)
    with pytest.raises(ValueError):  # not contiguous
        K.conv3x3_pfold(xf.transpose(2, 3).contiguous().transpose(2, 3), wt, bias, 4)
    with pytest.raises(ValueError):  # 13 channels are not 4 phases
        K.conv3x3_pfold(torch.randn(1, 4, 13, 64, device=cuda), wt, bias, 4)
    with pytest.raises(ValueError):  # lanes not a multiple of W/4
        K.conv3x3_pfold(xf, wt, bias, 5)
    with pytest.raises(TypeError):
        K.conv3x3_pfold(xf.half(), wt, bias, 4)
    with pytest.raises(ValueError):  # nothing but halo
        K.conv3x3_pfold_halo(xf[:, :2].contiguous(), wt, bias, 4)
    # shapes no kernel takes, in the dtype the wgmma kernels run: raised
    xb = torch.randn(1, 2, 4 * 24, 4 * 16, device=cuda).bfloat16()
    wb, bb = torch.randn(3, 3, 3, 24, 32, device=cuda), torch.zeros(32, device=cuda)
    with pytest.raises(ValueError):  # weight does not fit 24 channels
        K.conv3x3_pfold(xb, wb[:, :, :, :8].contiguous(), bb, 16)
    with pytest.raises(ValueError):  # dy does not fit x
        K.conv3x3_pfold_wgrad(xb, torch.randn(1, 2, 4 * 32, 60, device=cuda).bfloat16(), 16)
    with pytest.raises(ValueError):  # B·D past the grid
        K.conv3x3_pfold(torch.zeros(1, 65536, 4, 8, device=cuda).bfloat16(),
                        torch.zeros(3, 3, 3, 1, 1, device=cuda), torch.zeros(1, device=cuda), 2)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,shift", [((8, 128), 1), ((8, 128), -1), ((3, 50), 7),
                                         ((8, 128), 0), ((8, 128), 129), ((100, 200), -1),
                                         ((1000, 129), 129)])
def test_gpu_lane_roll_is_torch_roll(cuda, shape, shift):
    """Every shift the host normalises, and tiles past the 12,288 elements
    the shared-memory kernel took."""
    x = torch.arange(shape[0] * shape[1], dtype=torch.float32, device=cuda).reshape(shape)
    K.reset_launches()
    got = K.lane_roll(x, shift)
    assert K.lane_roll.launches == 1
    assert torch.equal(got, torch.roll(x, shift, 1))
    assert torch.equal(got, K.lane_roll_plain(x, shift))


@pytest.mark.gpu
def test_gpu_lane_roll_launches_on_the_current_stream(cuda):
    raw = torch._C._cuda_getCurrentRawStream  # what _build.launch passes
    x = torch.randn(8, 128, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        assert raw(x.get_device()) == side.cuda_stream
        got = K.lane_roll(x, 5)
    side.synchronize()
    assert torch.equal(got, torch.roll(x, 5, 1))
    assert raw(x.get_device()) == torch.cuda.current_stream().cuda_stream
    with pytest.raises(ValueError):
        K.lane_roll(x.t(), 1)  # not contiguous
    with pytest.raises(ValueError):
        K.lane_roll(x.double(), 1)
    with pytest.raises(ValueError):
        K.lane_roll(x.reshape(2, 4, 128), 1)


@pytest.mark.gpu
def test_gpu_lane_roll_int_range_edges(cuda):
    """The kernel's int range at both edges: a (1, INT_MAX) tile, whose
    last block ends on index INT_MAX, rolls exactly; one element more is
    refused before any launch."""
    from unet_bssfp_tpu_torch.ops.kernels import probe

    n = 2 ** 31 - 1
    x = torch.arange(n, dtype=torch.int32, device=cuda).remainder_(1 << 20).float()
    x = x.reshape(1, n)
    torch.cuda.empty_cache()
    y = K.lane_roll(x, 1)
    assert torch.equal(y[:, 1:], x[:, :-1]) and torch.equal(y[:, :1], x[:, -1:])
    del x, y
    torch.cuda.empty_cache()
    lib = probe._lib()
    invalid_value = 1  # cudaErrorInvalidValue
    assert lib.lane_roll_f32(None, None, 2, 2 ** 30, 0, None) == invalid_value


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["full", "centre", "fixed"])
@pytest.mark.parametrize("b,d,h,w,cin,cout", [(2, 4, 8, 64, 24, 32), (1, 3, 5, 40, 5, 36)])
def test_gpu_conv3x3_probe_modes_match_plain(cuda, mode, b, d, h, w, cin, cout):
    g = torch.Generator(device="cuda").manual_seed(cin + d)
    xk = torch.randn(b, d, cin, h * w, device=cuda, generator=g).bfloat16()
    wt = torch.randn(3, 3, 3, cin, cout, device=cuda, generator=g) / (27 * cin) ** 0.5
    bias = torch.randn(cout, device=cuda, generator=g)
    K.reset_launches()
    got = K.PROBE_MODES[mode](xk, wt, bias, w).float()
    assert getattr(K.PROBE_MODES[mode], "launches") == 1
    ref = K.conv3x3_probe_plain(xk, wt, bias, w, mode).float()
    # K1's bf16 bound: f32 sums in another order, one bf16 rounding each side
    torch.testing.assert_close(got, ref, rtol=2 ** -7, atol=1e-4 * float(ref.abs().max()))
    if mode == "full":  # K1's wgmma kernel, instanced in the probe's library
        assert torch.equal(K.PROBE_MODES[mode](xk, wt, bias, w),
                           K.conv3x3_packed(xk, wt, bias, w))
        assert K.conv3x3_packed_mma_routed.launches == 0
    with pytest.raises(TypeError):
        K.PROBE_MODES[mode](xk.float(), wt, bias, w)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["full", "centre", "fixed"])
def test_gpu_conv3x3_probe_raises_without_a_plan(cuda, mode):
    """Probe-only entry points: no routed fallback. Cout 128 has a wgmma
    plan of two N tiles and Cout 96 a plan of N 96, neither of which the
    probe library compiles; W 36 has none (no guard columns)."""
    fn = K.PROBE_MODES[mode]
    K.reset_launches()
    for w, cout in ((64, 128), (36, 32), (64, 96)):
        xk = torch.randn(1, 2, 8, 4 * w, device=cuda).bfloat16()
        wt, bias = torch.randn(3, 3, 3, 8, cout, device=cuda), torch.zeros(cout, device=cuda)
        with pytest.raises(ValueError):
            fn(xk, wt, bias, w)
    assert set(K.launches().values()) == {0}


# The wgmma kernel (csrc/conv3x3_wgmma.cu) that K1, K1's dgrad, K5 and K5's
# dgrad take in bf16: the stage shapes at a small batch and ragged shapes
# (Cin 3/5/24, Cout 6/24/96, W 8 and 40, wdim 66 and 16 with guard columns,
# H 3, D 1), each at the three d geometries (grow 0: SAME; -2: on an input
# with its d halo; +2: the halo dgrad's D → D+2). (B, D, H, wdim, g, Cin, Cout)
WGMMA_SHAPES = [(2, 4, 8, 64, 0, 24, 32), (2, 4, 8, 64, 0, 96, 32), (2, 4, 8, 64, 0, 32, 96),
                (1, 3, 4, 128, 0, 32, 24), (2, 3, 3, 8, 0, 3, 6), (1, 1, 3, 8, 0, 5, 24),
                (1, 2, 5, 40, 0, 24, 96), (1, 3, 8, 66, 2, 32, 32), (2, 2, 8, 16, 2, 5, 6)]


def _wgmma_operands(b, d, h, wd, g, cin, cout, grow):
    gen = torch.Generator(device="cuda").manual_seed(cin * cout + d + h)
    din = d + max(0, -grow)
    xk = torch.randn(b, din, cin, h * wd, device="cuda", generator=gen).bfloat16()
    xk = K.guard_mask(xk, wd, g).contiguous()
    wt = torch.randn(3, 3, 3, cin, cout, device="cuda", generator=gen) / (27 * cin) ** 0.5
    bias = torch.randn(cout, device="cuda", generator=gen)
    return xk, wt, bias


@pytest.mark.gpu
@pytest.mark.parametrize("grow", [0, -2, 2])
@pytest.mark.parametrize("b,d,h,wd,g,cin,cout", WGMMA_SHAPES)
def test_gpu_wgmma_conv_matches_plain_and_repeats(cuda, b, d, h, wd, g, cin, cout, grow):
    from unet_bssfp_tpu_torch.ops.kernels import conv3d as C, conv_wgmma

    xk, wt, bias = _wgmma_operands(b, d, h, wd, g, cin, cout, grow)
    plan = K.conv_plan(xk, cout, wd, grow, g)
    assert plan is not None and plan.lanes_map == (wd % 8 != 0)
    got = conv_wgmma.launch(plan, xk, wt, bias, "test")
    ref = K.guard_mask(C._conv_plain(xk, wt, bias, wd, 1 + grow // 2), wd, g).float()
    # K1's bf16 bound: f32 sums in another order, one bf16 rounding each side
    torch.testing.assert_close(got.float(), ref, rtol=2 ** -7, atol=1e-4 * float(ref.abs().max()))
    assert torch.equal(got, conv_wgmma.launch(plan, xk, wt, bias, "test"))
    assert conv_wgmma._lib().conv3x3_wgmma_smem(plan.rows, plan.stages, plan.cin_pad,
                                                plan.n) == plan.smem


@pytest.mark.gpu
@pytest.mark.parametrize("b,d,h,wd,g,cin,cout", WGMMA_SHAPES[:3] + WGMMA_SHAPES[-2:])
def test_gpu_wgmma_routes_and_wguard_autograd(cuda, b, d, h, wd, g, cin, cout):
    """Through the wrappers: the forward, dx (the wgmma kernel on the
    flipped weights, guard columns zero) and dw (K2) of K1 and K5 against
    plain autograd; no launch goes to the mma loop."""
    xk, wt, bias = _wgmma_operands(b, d, h, wd, g, cin, cout, 0)
    dy = K.guard_mask(torch.randn(b, d, cout, h * wd, device=cuda), wd, g).bfloat16()
    for conv, plain, x0 in (
            (K.conv3x3_packed, K.conv3x3_packed_plain, xk),
            (K.conv3x3_packed_halo, K.conv3x3_packed_halo_plain,
             torch.nn.functional.pad(xk, (0, 0, 0, 0, 1, 1)))):
        def grads(fn):
            x, w_, b_ = (t.clone().requires_grad_(True) for t in (x0, wt, bias))
            y = fn(x, w_, b_, wd, g)
            y.backward(dy)
            return y.detach(), x.grad, w_.grad
        K.reset_launches()
        y, dx, dw = grads(conv)
        assert K.launches()["conv3x3_packed_mma_routed"] == 0
        ry, rdx, rdw = grads(plain)
        _close(y, ry, 2 ** -7, 1e-4)
        _close(dx, K.guard_mask(rdx, wd, g), 2 ** -7, 1e-4)  # dx's guards: zero
        _close(dw, rdw, 2 ** -7, 1e-4)
        assert (dx.float().reshape(*dx.shape[:3], h, wd)[..., wd - g:] == 0).all()


# The guarded form (K1W and its dgrad: the GUARD instances, tiled over the
# data columns, the last data tile writing the row's guards): every N the
# model paths take it at (N 32 on 4 rows, 24, 64, 96, the N-72 tiles) at row
# width 66 and 130, and ragged widths: 68 (a second tile of 2 data columns,
# H 6 past the last 4-row tile), 70 with 8 guards (the most a plan takes), 72
# and 136 with 8 (the rows map). (B, D, H, wdim, g, Cin, Cout)
GUARDED_SHAPES = [(2, 4, 8, 66, 2, 96, 32), (2, 4, 8, 66, 2, 32, 96), (2, 4, 8, 66, 2, 24, 64),
                  (2, 4, 8, 66, 2, 144, 24), (2, 4, 8, 66, 2, 24, 144), (1, 3, 8, 130, 2, 32, 32),
                  (1, 3, 8, 130, 2, 32, 96), (2, 3, 6, 68, 2, 24, 32), (1, 2, 6, 68, 2, 5, 70),
                  (1, 2, 4, 72, 8, 16, 32), (1, 2, 4, 70, 8, 16, 32), (1, 2, 4, 136, 8, 16, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("grow", [0, -2, 2])
@pytest.mark.parametrize("b,d,h,wd,g,cin,cout", GUARDED_SHAPES)
def test_gpu_guarded_wgmma_conv_matches_plain_with_zero_guards(cuda, monkeypatch, b, d, h, wd,
                                                              g, cin, cout, grow):
    """K1W's launch against the plain conv with its guards masked, under
    K1's bound; the output allocated filled with NaN (torch.empty patched
    for the launch), so a guard or data voxel no block writes shows; a
    rerun bit for bit."""
    from unet_bssfp_tpu_torch.ops.kernels import conv3d as C, conv_wgmma

    xk, wt, bias = _wgmma_operands(b, d, h, wd, g, cin, cout, grow)
    plan = K.conv_plan(xk, cout, wd, grow, g)
    assert plan is not None and plan.tiles_w == -(-(wd - g) // 64)
    empty = torch.empty
    with monkeypatch.context() as m:
        m.setattr(torch, "empty", lambda *a, **k: empty(*a, **k).fill_(float("nan")))
        got = conv_wgmma.launch(plan, xk, wt, bias, "test")
    assert not bool(got.isnan().any())
    assert bool((got.reshape(*got.shape[:3], h, wd)[..., wd - g:] == 0).all())
    ref = K.guard_mask(C._conv_plain(xk, wt, bias, wd, 1 + grow // 2), wd, g).float()
    torch.testing.assert_close(got.float(), ref, rtol=2 ** -7, atol=1e-4 * float(ref.abs().max()))
    assert torch.equal(got, conv_wgmma.launch(plan, xk, wt, bias, "test"))


@pytest.mark.gpu
@pytest.mark.parametrize("b,d,h,wd,g,cin,cout", GUARDED_SHAPES[:7])
def test_gpu_guarded_dgrad_launches_the_wgmma_kernel(cuda, b, d, h, wd, g, cin, cout):
    """K1W's dgrad through its wrappers (SAME and halo): one launch each,
    none routed to the loop, dx's guards zero, against the plain dgrad."""
    gen = torch.Generator(device="cuda").manual_seed(cin + cout + wd)
    dy = K.guard_mask(torch.randn(b, d, cout, h * wd, device=cuda, generator=gen), wd, g)
    dy = dy.bfloat16().contiguous()
    wt = torch.randn(3, 3, 3, cin, cout, device=cuda, generator=gen) / (27 * cout) ** 0.5
    wflip = wt.flip(0, 1, 2).transpose(3, 4)
    for kern, plain, grow in (
            (K.conv3x3_packed_dgrad,
             lambda: K.conv3x3_packed_plain(dy, wflip, torch.zeros(cin, device=cuda), wd, g), 0),
            (K.conv3x3_packed_halo_dgrad,
             lambda: K.conv3x3_packed_halo_dgrad_plain(dy, wt, wd, g), 2)):
        K.reset_launches()
        got = kern(dy, wt, wd, g)
        counts = K.launches()
        assert (counts[kern.__name__], counts["conv3x3_packed_mma_routed"]) == (1, 0)
        assert got.shape == (b, d + grow, cin, h * wd)
        assert bool((got.reshape(*got.shape[:3], h, wd)[..., wd - g:] == 0).all())
        _close(got, plain(), 2 ** -7, 1e-4)


@pytest.mark.gpu
def test_gpu_shapes_outside_the_plan_take_the_mma_loop_counted(cuda):
    """W 12 and 36 without guard columns: static routes to the mma.sync
    loop, each counted; the result is K1's function all the same."""
    for wd, cout in ((12, 8), (36, 40)):
        xk = torch.randn(1, 3, 8, 8 * wd, device=cuda).bfloat16()
        wt = torch.randn(3, 3, 3, 8, cout, device=cuda) * 0.2
        bias = torch.randn(cout, device=cuda)
        assert K.conv_plan(xk, cout, wd) is None
        K.reset_launches()
        got = K.conv3x3_packed(xk, wt, bias, wd).float()
        counts = K.launches()
        assert (counts["conv3x3_packed"], counts["conv3x3_packed_mma_routed"]) == (1, 1)
        ref = K.conv3x3_packed_plain(xk, wt, bias, wd).float()
        torch.testing.assert_close(got, ref, rtol=2 ** -7, atol=1e-4 * float(ref.abs().max()))
        assert torch.equal(got, K.conv3x3_packed_mma(xk, wt, bias, wd).float())


@pytest.mark.gpu
def test_gpu_wgmma_refused_launch_raises(cuda):
    import dataclasses

    from unet_bssfp_tpu_torch.ops.kernels import conv_wgmma

    xk = torch.randn(1, 3, 16, 8 * 64, device=cuda).bfloat16()
    wt, bias = torch.randn(3, 3, 3, 16, 32, device=cuda), torch.zeros(32, device=cuda)
    plan = K.conv_plan(xk, 32, 64)
    for bad in (dataclasses.replace(plan, stages=5), dataclasses.replace(plan, n=128),
                dataclasses.replace(plan, seg_len=1, segments=1)):
        with pytest.raises(RuntimeError, match="launch plan"):
            conv_wgmma.launch(bad, xk, wt, bias, "test")
    with pytest.raises(ValueError):  # f32 is not this kernel's
        conv_wgmma.launch(plan, xk.float(), wt, bias, "test")


# The wgmma weight gradient (csrc/conv3x3_wgrad_wgmma.cu) that K2 and K5's
# weight gradient take in bf16: the stage shapes at a small batch and ragged
# ones (Cin 3/5/24/40/96, Cout 4/6/32, W 8/16/40/64/128, H 3/5/7, D 1/2),
# each in both d geometries, under K2's bound (16·sqrt(L)·2^-24·max|ref|, L
# the plan's chain). (B, D, H, W, Cin, Cout)
WGRAD_WGMMA_SHAPES = [(2, 4, 8, 64, 24, 32), (2, 4, 8, 64, 32, 32), (2, 4, 8, 64, 96, 32),
                      (2, 2, 3, 8, 3, 4), (1, 1, 5, 40, 5, 6), (1, 2, 7, 16, 40, 32),
                      (2, 3, 4, 128, 24, 6), (1, 1, 3, 64, 96, 4),
                      # co tiles: the multi-stage 24/48 → 48, ragged Cout 40 and 70
                      (2, 4, 8, 64, 24, 48), (2, 4, 8, 64, 48, 48), (1, 2, 5, 40, 5, 40),
                      (1, 1, 3, 16, 24, 70)]


def _wgrad_operands(b, d, h, w, cin, cout, halo):
    gen = torch.Generator(device="cuda").manual_seed(cin * cout + d + h + halo)
    xk = torch.randn(b, d + 2 * halo, cin, h * w, device="cuda", generator=gen).bfloat16()
    dy = torch.randn(b, d, cout, h * w, device="cuda", generator=gen).bfloat16()
    return xk, dy


@pytest.mark.gpu
@pytest.mark.parametrize("halo", [0, 1])
@pytest.mark.parametrize("b,d,h,w,cin,cout", WGRAD_WGMMA_SHAPES)
def test_gpu_wgmma_wgrad_matches_plain_and_repeats(cuda, b, d, h, w, cin, cout, halo):
    from unet_bssfp_tpu_torch.ops.kernels import wgrad_wgmma

    xk, dy = _wgrad_operands(b, d, h, w, cin, cout, halo)
    plan = K.wgrad_plan(xk, dy, w)
    assert plan is not None and plan.halo == halo
    wrapper = K.conv3x3_wgrad_halo if halo else K.conv3x3_wgrad
    plain = K.conv3x3_wgrad_halo_plain if halo else K.conv3x3_wgrad_plain
    K.reset_launches()
    got = wrapper(xk, dy, w)
    assert K.launches()[wrapper.__name__] == 1
    assert K.launches()["conv3x3_wgrad_mma_routed"] == 0
    assert got.dtype == torch.float32 and got.shape == (3, 3, 3, cin, cout)
    chain = K.conv3x3_wgrad_chain(xk, dy, w)
    assert chain == plan.chain
    _close(got, plain(xk, dy, w), 0.0, 16 * math.sqrt(chain) * 2 ** -24)
    # fixed-order split sum, no atomics: a second launch bit for bit the same
    assert torch.equal(got, wgrad_wgmma.launch(plan, xk, dy, "test"))
    assert wgrad_wgmma._lib().conv3x3_wgrad_wgmma_smem(plan.stages) == plan.smem


@pytest.mark.gpu
@pytest.mark.parametrize("b,d,h,w,cin,cout,halo", [
    (1, 2, 9, 35, 24, 32, 0), (1, 2, 3, 66, 32, 32, 1), (2, 1, 4, 12, 8, 40, 0),
    (1, 2, 5, 20, 5, 40, 1)])
def test_gpu_wgrad_shapes_outside_the_plan_take_the_mma_loop_counted(
        cuda, b, d, h, w, cin, cout, halo):
    """W 35, 12 and 20, the wguard width 66: static routes to the mma.sync loop,
    each counted; the result is that loop's (its check-only entry point's)
    bit for bit, within K2's bound of the plain version."""
    xk, dy = _wgrad_operands(b, d, h, w, cin, cout, halo)
    assert K.wgrad_plan(xk, dy, w) is None
    wrapper = K.conv3x3_wgrad_halo if halo else K.conv3x3_wgrad
    plain = K.conv3x3_wgrad_halo_plain if halo else K.conv3x3_wgrad_plain
    K.reset_launches()
    got = wrapper(xk, dy, w)
    counts = K.launches()
    assert (counts[wrapper.__name__], counts["conv3x3_wgrad_mma_routed"],
            counts["conv3x3_wgrad_mma"]) == (1, 1, 0)
    assert torch.equal(got, K.conv3x3_wgrad_mma(xk, dy, w, halo))
    chain = K.conv3x3_wgrad_chain(xk, dy, w)
    assert chain == K.conv3x3_wgrad_mma_chain(xk, dy, w)
    _close(got, plain(xk, dy, w), 0.0, 16 * math.sqrt(chain) * 2 ** -24)


# K2W: the weight gradient of a conv with wguard g, which the conv's backward
# runs as K2 (or K5's wgrad) on the guard-stripped operands at W = wdim - g:
# at wdim 66 the wgmma kernel at W 64, where the mma.sync loop at 66 took it
# before.
@pytest.mark.gpu
@pytest.mark.parametrize("halo", [0, 1])
@pytest.mark.parametrize("cin", [24, 32, 96])
def test_gpu_k2w_matches_plain_and_the_loop(cuda, cin, halo):
    """Through the conv's backward: one launch of the wgmma wgrad, none
    routed; the plain weight gradient of the guarded conv on whole rows and
    the loop's result at wdim 66 each within their chain's K2 bound; bit for
    bit K2 on the stripped operands."""
    b, d, h, w, g, cout = 2, 4, 8, 64, 2, 32
    wd = w + g
    gen = torch.Generator(device="cuda").manual_seed(cin + halo)
    xk = K.guard_mask(torch.randn(b, d + 2 * halo, cin, h * wd, device=cuda, generator=gen),
                      wd, g).bfloat16().contiguous()
    wt = (torch.randn(3, 3, 3, cin, cout, device=cuda, generator=gen) / (27 * cin) ** 0.5
          ).requires_grad_(True)
    # a cotangent nonzero on the guard columns: the backward zeroes them
    dy = torch.randn(b, d, cout, h * wd, device=cuda, generator=gen).bfloat16()
    conv = K.conv3x3_packed_halo if halo else K.conv3x3_packed
    wrapper = K.conv3x3_wgrad_halo if halo else K.conv3x3_wgrad
    plain = K.conv3x3_wgrad_halo_plain if halo else K.conv3x3_wgrad_plain
    K.reset_launches()
    conv(xk, wt, torch.zeros(cout, device=cuda), wd, g).backward(dy)
    counts = K.launches()
    assert (counts[wrapper.__name__], counts["conv3x3_wgrad_mma_routed"],
            counts["conv3x3_wgrad_mma"]) == (1, 0, 0)
    dym = K.guard_mask(dy, wd, g).contiguous()
    xs, dys = K.strip_guards(xk, wd, g), K.strip_guards(dym, wd, g)
    assert K.wgrad_plan(xs, dys, w) is not None and K.wgrad_plan(xk, dym, wd) is None
    ref = plain(xk, dym, wd)
    _close(wt.grad, ref, 0.0, 16 * math.sqrt(K.conv3x3_wgrad_chain(xs, dys, w)) * 2 ** -24)
    loop = K.conv3x3_wgrad_mma(xk, dym, wd, halo)
    _close(loop, ref, 0.0, 16 * math.sqrt(K.conv3x3_wgrad_mma_chain(xk, dym, wd)) * 2 ** -24)
    assert torch.equal(wt.grad, wrapper(xs, dys, w))


@pytest.mark.gpu
def test_gpu_guarded_packed_two_conv_launches_exactly(cuda, monkeypatch):
    """A bf16 PackedTwoConv forward and backward under UNET_BSSFP_WGUARD=1
    (row width 66): 1 pack, 2 convs, 2 dgrads, 2 wgrads, the pack's
    backward and K10 2 forward and 2 backward, nothing routed to a loop; its output's data columns and every
    gradient within bf16 noise (2e-2 relative L2) of the unguarded block's."""
    from unet_bssfp_tpu_torch.models.packed_layers import PackedTwoConv, guard_cols

    block = PackedTwoConv(24, 32, compute_dtype=torch.bfloat16).to(cuda)
    x = torch.randn(2, 8, 64, 64, 24, device=cuda,
                    generator=torch.Generator(device="cuda").manual_seed(5))
    runs = {}
    for on in (True, False):
        monkeypatch.setenv("UNET_BSSFP_WGUARD", "1" if on else "0")
        g = guard_cols(64, 64)
        xi = x.clone().requires_grad_(True)
        block.zero_grad(set_to_none=True)
        K.reset_launches()
        yk = block.forward_packed(xi)
        y = yk.float().reshape(2, 8, 32, 64, 64 + g)
        (y ** 2).sum().backward()
        runs[on] = (K.launches(), y[..., :64], xi.grad,
                    {n: q.grad.clone() for n, q in block.named_parameters()}, g, y[..., 64:])
    counts, y, dx, grads, g, guards = runs[True]
    assert g == 2 and bool((guards == 0).all())
    want = dict.fromkeys(counts, 0)
    want.update(conv3x3_packed=2, conv3x3_packed_dgrad=2, conv3x3_wgrad=2, pack_hw=1,
                unpack_hw=1, packed_norm_act=2, packed_norm_act_backward=2)
    assert counts == want and runs[False][0] == want

    def rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())

    assert rel(y, runs[False][1]) < 2e-2 and rel(dx, runs[False][2]) < 2e-2
    for name, ref in runs[False][3].items():
        if not name.endswith("conv.bias"):  # before a norm: true gradient 0
            assert rel(grads[name], ref) < 2e-2, name


@pytest.mark.gpu
def test_gpu_wgmma_wgrad_refused_launch_raises(cuda):
    import dataclasses

    from unet_bssfp_tpu_torch.ops.kernels import wgrad_wgmma

    xk, dy = _wgrad_operands(1, 3, 8, 64, 16, 32, 0)
    plan = K.wgrad_plan(xk, dy, 64)
    for bad in (dataclasses.replace(plan, stages=5), dataclasses.replace(plan, chunks=2),
                dataclasses.replace(plan, per=1, splits=1),
                dataclasses.replace(plan, cout=40)):
        with pytest.raises(RuntimeError, match="launch plan"):
            wgrad_wgmma.launch(bad, xk, dy, "test")
    with pytest.raises(ValueError):  # f32 is not this kernel's
        wgrad_wgmma.launch(plan, xk.float(), dy.float(), "test")
    with pytest.raises(ValueError):  # dy does not fit x: raised, not run elsewhere
        K.conv3x3_wgrad(xk, dy[:, :2].contiguous(), 64)


# The wgmma conv's two forms for the multi-stage backbone: N 24 (Cout ≤ 24
# where N 32's weights do not fit: upcat_1's 144 → 24) and N tiles (Cout > 96:
# its dgrad 24 → 144 on two tiles of 72; ragged 100 and 200), at the three
# d geometries, under K1's bound; a rerun bit for bit.
@pytest.mark.gpu
@pytest.mark.parametrize("grow", [0, -2, 2])
@pytest.mark.parametrize("cin,cout,n,n_tiles", [(144, 24, 24, 1), (24, 144, 72, 2),
                                                (24, 100, 72, 2), (5, 200, 72, 3)])
def test_gpu_wgmma_narrow_n_and_n_tiles_match_plain_and_repeat(cuda, grow, cin, cout, n,
                                                               n_tiles):
    from unet_bssfp_tpu_torch.ops.kernels import conv3d as C, conv_wgmma

    xk, wt, bias = _wgmma_operands(2, 4, 8, 64, 0, cin, cout, grow)
    plan = K.conv_plan(xk, cout, 64, grow)
    assert (plan.n, plan.n_tiles) == (n, n_tiles)
    got = conv_wgmma.launch(plan, xk, wt, bias, "test")
    ref = C._conv_plain(xk, wt, bias, 64, 1 + grow // 2).float()
    torch.testing.assert_close(got.float(), ref, rtol=2 ** -7, atol=1e-4 * float(ref.abs().max()))
    assert torch.equal(got, conv_wgmma.launch(plan, xk, wt, bias, "test"))
    assert conv_wgmma._lib().conv3x3_wgmma_smem(plan.rows, plan.stages, plan.cin_pad,
                                                plan.n) == plan.smem


@pytest.mark.gpu
@pytest.mark.parametrize("cin,cout", [(24, 48), (48, 48), (144, 24), (24, 24)])
def test_gpu_multistage_convs_autograd_on_wgmma_kernels(cuda, cin, cout):
    """The multi-stage backbone's four full-resolution convs through the
    wrappers: forward, dx (144 → two N tiles) and dw (Cout 48 → two co
    tiles) against plain autograd; one launch each, none to a loop."""
    xk, wt, bias = _wgmma_operands(2, 4, 8, 64, 0, cin, cout, 0)
    dy = torch.randn(2, 4, cout, 8 * 64, device=cuda).bfloat16()

    def grads(fn):
        x, w_, b_ = (t.clone().requires_grad_(True) for t in (xk, wt, bias))
        y = fn(x, w_, b_, 64)
        y.backward(dy)
        return y.detach(), x.grad, w_.grad

    K.reset_launches()
    y, dx, dw = grads(K.conv3x3_packed)
    counts = K.launches()
    assert (counts["conv3x3_packed"], counts["conv3x3_packed_dgrad"],
            counts["conv3x3_wgrad"]) == (1, 1, 1)
    assert counts["conv3x3_packed_mma_routed"] == counts["conv3x3_wgrad_mma_routed"] == 0
    ry, rdx, rdw = grads(K.conv3x3_packed_plain)
    _close(y, ry, 2 ** -7, 1e-4)
    _close(dx, rdx, 2 ** -7, 1e-4)
    _close(dw, rdw, 2 ** -7, 1e-4)


@pytest.mark.gpu
def test_gpu_multistage_steps_launch_exactly_and_transfer_freezes_the_backbone(cuda):
    """A supervised step of each stage at the thesis widths (bf16, packed,
    B 1 × 32³): K1 4, K1's dgrad 4, K10 4 and its backward 4, K2 4 — none in
    TRANSFER, whose backbone stays bit for bit —, K3a 3, K3b 3, no loop;
    finite losses."""
    from unet_bssfp_tpu_torch.config import ModelConfig, TrainConfig
    from unet_bssfp_tpu_torch.models import TrainingState
    from unet_bssfp_tpu_torch.train import multistage as ms

    g = torch.Generator(device="cuda").manual_seed(3)
    y = torch.rand(1, 32, 32, 32, 6, device=cuda, generator=g)
    for i, stage in enumerate(TrainingState):
        modality = "dwi-tensor" if stage == TrainingState.PRETRAIN else "pc-bssfp"
        x = torch.rand(1, 32, 32, 32, 6 if i == 0 else 24, device=cuda, generator=g)
        net = ms.build_multi_input_unet(modality, ModelConfig(), cuda)
        state = ms.create_supervised_state(i, net, TrainConfig(), stage)
        step = ms.make_supervised_train_step(net, TrainConfig())
        step(state, x, y)
        before = {k: v.clone() for k, v in net.state_dict().items() if k.startswith("unet.")}
        K.reset_launches()
        metrics = step(state, x, y)
        counts = {k: v for k, v in K.launches().items() if v}
        assert counts == {"conv3x3_packed": 4, "conv3x3_packed_dgrad": 4, "pack_hw": 3,
                          "unpack_hw": 3, "packed_norm_act": 4, "packed_norm_act_backward": 4,
                          **({} if stage == TrainingState.TRANSFER else {"conv3x3_wgrad": 4})}
        unchanged = all(torch.equal(v, before[k]) for k, v in net.state_dict().items()
                        if k.startswith("unet."))
        assert unchanged == (stage == TrainingState.TRANSFER)
        assert all(math.isfinite(float(v)) for v in metrics.values())


# The training data path (data/augment.py, data/datamodule.py): the seven
# applies on the card against their CPU applies on the same parameters
# (the elementwise ones and the rotation differ only in exp/pow/sin/cos
# roundings: 1e-5·max|ref|; the k-space ones also in cuFFT against
# pocketfft: 1e-4·max|ref|), the batch streams repeatable with prefetch on
# and off, and a packed GAN step fed from them with exact launches.
AUG_TOL = {"noise": 1e-5, "gamma": 1e-5, "blur": 1e-5, "bias_field": 1e-5,
           "rotate_trilinear": 1e-5, "spike": 1e-4, "ghosting": 1e-4, "motion": 1e-4}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(AUG_TOL))
@pytest.mark.parametrize("shape", [(32, 40, 48, 6), (17, 23, 29, 3)])
def test_gpu_augment_applies_match_cpu(cuda, name, shape):
    from unet_bssfp_tpu_torch.data import augment as aug

    g = torch.Generator().manual_seed(len(name))
    vol_cpu = torch.rand(shape, generator=g)
    vol = vol_cpu.to(cuda)
    draws = {n: draw(g, shape) for n, draw, _ in aug.CHAIN}
    if name == "noise":
        field = aug.noise_field(draws["noise"]["seed"], vol)
        assert field.is_cuda
        got = aug.apply_noise(vol, draws["noise"]["std"], field)
        ref = aug.apply_noise(vol_cpu, draws["noise"]["std"], field.cpu())
    elif name == "rotate_trilinear":
        got = aug.rotate_trilinear(vol, draws["motion"]["angles"][1])
        ref = aug.rotate_trilinear(vol_cpu, draws["motion"]["angles"][1])
    else:
        apply = dict((n, fn) for n, _, fn in aug.CHAIN)[name]
        got = apply(vol, **draws[name])
        ref = apply(vol_cpu, **draws[name])
    assert got.is_cuda and got.shape == ref.shape
    err = float((got.cpu() - ref).abs().max())
    assert err <= AUG_TOL[name] * float(ref.abs().max()), (name, err)


def _tree(tmp_path, shape, subjects=("01", "02", "03", "04")):
    from unet_bssfp_tpu_torch.data.synthetic import make_synthetic_bids

    return make_synthetic_bids(str(tmp_path / "bids"), subjects=subjects, sessions=("1",),
                               volume_shape=shape)


@pytest.mark.gpu
@pytest.mark.parametrize("prob", [0.1, 1.0])
def test_gpu_data_batches_repeat_with_prefetch_on_and_off(cuda, tmp_path, prob):
    from unet_bssfp_tpu_torch.data.datamodule import DoveDataModule

    dm = DoveDataModule(_tree(tmp_path, (32, 32, 32)), batch_size=4, samples_per_vol=4,
                        patch_size=16, volume_shape=(32, 32, 32), val_split=0.25,
                        test_split=0.25, augment_prob=prob)
    dm.prepare_data()
    runs = [list(dm.train_batches(3, keys=("pc-bssfp", "dwi-tensor"), device=cuda,
                                  prefetch=p)) for p in (True, False, True)]
    assert len(runs[0]) == 2
    for batches in runs:
        for b in batches:
            assert all(v.is_cuda for v in b.values())
            assert b["pc-bssfp"].shape == (4, 16, 16, 16, 24)
            assert b["dwi-tensor_orig"].shape == (4, 16, 16, 16, 6)
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.gpu
def test_gpu_packed_step_fed_from_data_launches_exactly(cuda, tmp_path):
    """The default GAN step (bf16, packed, full width) on batches of the data
    module at 64³, the pristine DT as the target (``unet_bssfp_tpu/train/
    loop.py:207``): one step's launches are the training step's."""
    from unet_bssfp_tpu_torch.config import Config
    from unet_bssfp_tpu_torch.data.datamodule import DoveDataModule
    from unet_bssfp_tpu_torch.train.state import create_gan_state
    from unet_bssfp_tpu_torch.train.steps import make_train_step

    cfg = Config()
    dm = DoveDataModule(_tree(tmp_path, (64, 64, 64)), config=cfg.data, batch_size=2,
                        samples_per_vol=2, volume_shape=(64, 64, 64), val_split=0.25,
                        test_split=0.25)
    dm.prepare_data()
    state = create_gan_state(0, "pc-bssfp", cfg.model, cfg.train, cuda)
    step = make_train_step(state.gen, state.disc, cfg.train)
    want = dict.fromkeys(K.launches(), 0)
    want.update(conv3x3_packed=8, conv3x3_packed_dgrad=4, conv3x3_wgrad=4, pack_hw=5,
                unpack_hw=4, packed_norm_act=8, packed_norm_act_backward=4)
    batches = list(dm.train_batches(0, keys=("pc-bssfp", "dwi-tensor"), device=cuda))
    assert len(batches) == 2
    for i, b in enumerate(batches):
        K.reset_launches()
        metrics = step(state, b["pc-bssfp"], b["dwi-tensor_orig"])
        torch.cuda.synchronize()
        assert K.launches() == want, i
        assert all(math.isfinite(float(v)) for v in metrics.values())


def _loop_config(tmp_path, **model):
    """A small-width loop on 16³ patches of a 4-subject (32, 32, 32) tree:
    bf16, packed (the card's default), top 2 of 2 epochs."""
    import dataclasses

    from unet_bssfp_tpu_torch.config import Config

    cfg = Config()
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, batch_size=4, samples_per_vol=4, patch_size=16,
                                      volume_shape=(32, 32, 32), val_split=0.25,
                                      test_split=0.25, num_workers=2),
        model=dataclasses.replace(cfg.model, features=(8, 16, 16, 32, 32, 8),
                                  disc_features=(8, 16, 32), **model),
        train=dataclasses.replace(cfg.train, max_epochs=1, checkpoint_top_k=2,
                                  log_dir=str(tmp_path / "logs"),
                                  checkpoint_dir=str(tmp_path / "ckpts")))


@pytest.mark.gpu
def test_gpu_trainer_fit_and_checkpoint_round_trip(cuda, tmp_path):
    """One epoch of ``Trainer.fit`` on the card (its launches: every train
    and eval step's, exactly); its ``state.pt``, saved from the card,
    restores into a fresh state bit for bit (weights, BatchNorm buffers,
    both AdamW states, step, the dropout generator), and both take the next
    step alike."""
    from unet_bssfp_tpu_torch.data.datamodule import DoveDataModule
    from unet_bssfp_tpu_torch.train.checkpoint import load_checkpoint
    from unet_bssfp_tpu_torch.train.loop import Trainer
    from unet_bssfp_tpu_torch.train.steps import make_train_step

    cfg = _loop_config(tmp_path)
    dm = DoveDataModule(_tree(tmp_path, (32, 32, 32)), config=cfg.data)
    trainer = Trainer(cfg, "pc-bssfp")
    assert trainer.device.type == "cuda"
    state = trainer.init_state()
    K.reset_launches()
    state, best = trainer.fit(dm, state)
    torch.cuda.synchronize()
    train_steps, eval_steps = 2, 1  # 2 subjects × 4 patches / 4; 1 × 4 / 4
    want = dict.fromkeys(K.launches(), 0)
    want.update(conv3x3_packed=8 * train_steps + 4 * eval_steps,
                conv3x3_packed_dgrad=4 * train_steps, conv3x3_wgrad=4 * train_steps,
                pack_hw=5 * train_steps + 2 * eval_steps, unpack_hw=4 * train_steps + eval_steps,
                packed_norm_act=8 * train_steps + 4 * eval_steps,
                packed_norm_act_backward=4 * train_steps)
    assert K.launches() == want
    assert state.step == train_steps and best.endswith("0")

    restored = load_checkpoint(best, trainer.init_state(seed=5))
    assert restored.rng.device.type == "cuda"
    for m in ("gen", "disc"):
        a, b = getattr(state, m).state_dict(), getattr(restored, m).state_dict()
        assert a.keys() == b.keys() and all(b[k].is_cuda and torch.equal(a[k], b[k]) for k in a)
    for o in ("gen_opt", "disc_opt"):
        a, b = getattr(state, o).state_dict()["state"], getattr(restored, o).state_dict()["state"]
        assert a.keys() == b.keys()
        assert all(torch.equal(a[i][k], b[i][k].to(a[i][k].device)) for i in a for k in a[i])
    assert torch.equal(state.rng.get_state(), restored.rng.get_state())
    assert restored.step == state.step
    x, y = (torch.rand(4, 16, 16, 16, c, device=cuda) for c in (24, 6))
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        got = make_train_step(restored.gen, restored.disc, cfg.train)(restored, x, y)
        ref = make_train_step(state.gen, state.disc, cfg.train)(state, x, y)
    finally:
        torch.backends.cudnn.deterministic = det
    assert {k: float(v) for k, v in got.items()} == {k: float(v) for k, v in ref.items()}


@pytest.mark.gpu
def test_gpu_remat_step_is_bit_equal_with_exact_launches(cuda):
    """``ModelConfig.remat`` on the card: a packed bf16 step with dropout on
    equals the step without remat bit for bit (every gradient, parameter,
    BatchNorm buffer and the dropout generator), and recomputes the packed
    conv_0 and upcat_1 blocks: 4 convs, 2 packs and 4 K10 forwards more."""
    import dataclasses

    from unet_bssfp_tpu_torch.train.state import create_gan_state
    from unet_bssfp_tpu_torch.train.steps import make_train_step

    cfg = _loop_config(Path("."))
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.rand(4, 32, 32, 32, 24, device=cuda, generator=g)
    y = torch.rand(4, 32, 32, 32, 6, device=cuda, generator=g)
    out = {}
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for remat in (False, True):
            st = create_gan_state(0, "pc-bssfp", dataclasses.replace(cfg.model, remat=remat),
                                  cfg.train, cuda)
            K.reset_launches()
            m = make_train_step(st.gen, st.disc, cfg.train)(st, x, y)
            torch.cuda.synchronize()
            out[remat] = (K.launches(), {k: float(v) for k, v in m.items()},
                          {f"{n}.{k}": p.grad for n in ("gen", "disc")
                           for k, p in getattr(st, n).named_parameters()},
                          {f"{n}.{k}": v for n in ("gen", "disc")
                           for k, v in getattr(st, n).state_dict().items()},
                          st.rng.get_state())
    finally:
        torch.backends.cudnn.deterministic = det
    (c0, m0, g0, s0, r0), (c1, m1, g1, s1, r1) = out[False], out[True]
    want = dict.fromkeys(c0, 0)
    want.update(conv3x3_packed=8, conv3x3_packed_dgrad=4, conv3x3_wgrad=4, pack_hw=5, unpack_hw=4,
                packed_norm_act=8, packed_norm_act_backward=4)
    assert c0 == want
    assert c1 == dict(want, conv3x3_packed=12, pack_hw=7, packed_norm_act=12)
    assert m0 == m1
    assert g0.keys() == g1.keys() and all(torch.equal(g0[k], g1[k]) for k in g0)
    assert s0.keys() == s1.keys() and all(torch.equal(s0[k], s1[k]) for k in s0)
    assert torch.equal(r0, r1)


# MedicalNet, its FID and the perceptual term on the card, against the CPU
# (stock cuDNN convs; TF32 off): f32 sums in other orders.

@pytest.mark.gpu
def test_gpu_medicalnet_features_and_fid_match_cpu(cuda):
    """Features of (2, 32, 40, 48, 3) within 1e-3 of max|ref|; the FID of one
    volume a population (as ``run_test`` takes it: |mu_x − mu_y|² exactly)
    within 1e-3 relative."""
    from unet_bssfp_tpu_torch.models.medicalnet import init_medicalnet, medicalnet_features
    from unet_bssfp_tpu_torch.train.steps import make_medicalnet_fid_fn

    host, card = init_medicalnet(0), init_medicalnet(0, device=cuda)
    g = torch.Generator().manual_seed(11)
    x = torch.randn(2, 32, 40, 48, 3, generator=g)
    with torch.no_grad():
        ref = medicalnet_features(host, x)
        got = medicalnet_features(card, x.to(cuda)).cpu()
    assert got.shape == ref.shape == (2, 4, 5, 6, 3 * 512)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-3 * float(ref.abs().max()))
    y = torch.rand(1, 32, 40, 48, 6, generator=g)
    y_hat = y + 0.2 * torch.randn(y.shape, generator=g)
    ref_fid = float(make_medicalnet_fid_fn(host)(y_hat, y))
    got_fid = float(make_medicalnet_fid_fn(card)(y_hat.to(cuda), y.to(cuda)))
    assert ref_fid > 0 and got_fid == pytest.approx(ref_fid, rel=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_perceptual_distance_and_grad_match_cpu(cuda, dtype):
    """The distance and its gradient with respect to ``pred`` on the card
    against f32 on the CPU: f32 within 1e-3 relative (distance) and 1e-3
    relative L2 (gradient); bf16 within 2e-2 and 0.3 (bf16 against f32 on
    the CPU itself: 0.18–0.29 % and 0.110–0.113 over three seeds at this
    shape). No gradient reaches the target."""
    from unet_bssfp_tpu_torch.models.medicalnet import init_medicalnet, perceptual_distance

    g = torch.Generator().manual_seed(5)
    p = torch.rand(2, 32, 32, 32, 6, generator=g)
    t = p + 0.3 * torch.rand(p.shape, generator=g)

    def run(net, device):
        pred = p.to(device, copy=True).requires_grad_(True)
        target = t.to(device, copy=True).requires_grad_(True)
        d = perceptual_distance(net, pred, target, chunk=4)
        d.backward()
        assert target.grad is None and d.dtype == torch.float32
        return float(d.detach()), pred.grad.float().cpu()

    d_ref, g_ref = run(init_medicalnet(0), "cpu")
    d_got, g_got = run(init_medicalnet(0, dtype=dtype, device=cuda), cuda)
    rel_d, rel_g = (1e-3, 1e-3) if dtype == torch.float32 else (2e-2, 0.3)
    assert d_got == pytest.approx(d_ref, rel=rel_d)
    assert torch.isfinite(g_got).all() and float(g_got.abs().sum()) > 0
    assert float((g_got - g_ref).norm() / g_ref.norm()) <= rel_g


@pytest.mark.gpu
def test_gpu_checkpoint_saved_on_the_card_evaluates_on_card_and_cpu(cuda, tmp_path):
    """A step saved from a state on the card (its dropout generator a CUDA
    one) evaluates with ``eval_model`` on the card (K1/K3 f32) and on the
    CPU (plain versions): the same files and metrics within f32 summation
    order (PSNR 1e-3 dB, SSIM and L1 1e-4 relative, FID 1e-3 relative, the
    files 1e-4 of max|ref|)."""
    import dataclasses
    import os

    from unet_bssfp_tpu_torch.data.datamodule import DoveDataModule
    from unet_bssfp_tpu_torch.data.nifti import load_volume
    from unet_bssfp_tpu_torch.eval.evaluate import eval_model
    from unet_bssfp_tpu_torch.train.checkpoint import CheckpointManager
    from unet_bssfp_tpu_torch.train.state import create_gan_state

    cfg = _loop_config(tmp_path, compute_dtype="float32")
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, patch_size=32))
    state = create_gan_state(0, "pc-bssfp", cfg.model, cfg.train, cuda)
    assert state.rng.device.type == "cuda"
    mgr = CheckpointManager(str(tmp_path / "ckpts" / "pc-bssfp-run"), config_json=cfg.to_json())
    mgr.save(0, state, {"val_loss": 1.0})
    dm = DoveDataModule(_tree(tmp_path, (32, 32, 32)), config=cfg.data)
    dm.prepare_data()
    K.reset_launches()
    got = eval_model(dm, mgr.best_path(), "pc-bssfp", str(tmp_path / "card"))
    torch.cuda.synchronize()
    assert K.launches()["conv3x3_packed"] == 4 * len(dm.test_samples) > 0
    ref = eval_model(dm, mgr.best_path(), "pc-bssfp", str(tmp_path / "host"), device="cpu")
    assert list(got) == list(ref) == ["test_metric_PSNR", "test_metric_SSIM", "test_metric_L1",
                                      "test_metric_FID_random_features"]
    assert got["test_metric_PSNR"] == pytest.approx(ref["test_metric_PSNR"], abs=1e-3)
    for k in ("test_metric_SSIM", "test_metric_L1"):
        assert got[k] == pytest.approx(ref[k], rel=1e-4), k
    assert got["test_metric_FID_random_features"] == pytest.approx(
        ref["test_metric_FID_random_features"], rel=1e-3)
    names = sorted(os.listdir(tmp_path / "card"))
    assert names == sorted(os.listdir(tmp_path / "host")) and "test_metrics.csv" in names
    for fn in (n for n in names if n.endswith(".nii.gz")):
        a, b = (load_volume(str(tmp_path / d / fn))[0] for d in ("card", "host"))
        assert abs(a - b).max() <= 1e-4 * abs(b).max(), fn


# The sharded training step (train/steps.py with mesh=; every position on
# cuda:0): the K5 forms' plans at the shards of a batch of 8 × 64³, and a
# full-width step on (2, 2) with exact launches and f32 parity.
GAN_FULL_RES_CONVS = ((24, 32), (32, 32), (96, 32), (32, 32))


@pytest.mark.gpu
@pytest.mark.parametrize("mesh_shape", [(2, 1), (2, 2), (8, 1)])
def test_gpu_sharded_step_shapes_take_the_wgmma_plans(cuda, mesh_shape):
    """The shards of a batch of 8 × 64³ on ``mesh_shape``: the forward, its
    dgrad and its weight gradient at the generator's full-resolution convs,
    in their halo forms (K5, K5-dgrad, K5-wgrad) on a space split, against
    the plain versions under K1's, K1-dgrad's and K2's bounds, each one
    launch on a wgmma plan, none routed to the mma.sync loops."""
    b, d = 8 // mesh_shape[0], 64 // mesh_shape[1]
    halo = int(mesh_shape[1] > 1)
    g = torch.Generator(device="cuda").manual_seed(b * d)
    for cin, cout in GAN_FULL_RES_CONVS:
        x = torch.randn(b, d + 2 * halo, cin, 4096, device=cuda, generator=g).bfloat16()
        w = torch.randn(3, 3, 3, cin, cout, device=cuda, generator=g) / (27 * cin) ** 0.5
        bias = torch.randn(cout, device=cuda, generator=g)
        dy = torch.randn(b, d, cout, 4096, device=cuda, generator=g).bfloat16()
        assert K.conv_plan(x, cout, 64, -2 * halo) is not None
        assert K.conv_plan(dy, cin, 64, 2 * halo) is not None
        assert K.wgrad_plan(x, dy, 64) is not None
        fwd, dgrad, wgrad = ((K.conv3x3_packed_halo, K.conv3x3_packed_halo_dgrad,
                              K.conv3x3_wgrad_halo) if halo else
                             (K.conv3x3_packed, K.conv3x3_packed_dgrad, K.conv3x3_wgrad))
        plains = ((K.conv3x3_packed_halo_plain, K.conv3x3_packed_halo_dgrad_plain,
                   K.conv3x3_wgrad_halo_plain) if halo else
                  (K.conv3x3_packed_plain, None, K.conv3x3_wgrad_plain))
        K.reset_launches()
        y = fwd(x, w, bias, 64)
        dx = dgrad(dy, w, 64)
        dw = wgrad(x, dy, 64)
        counts = {k: v for k, v in K.launches().items() if v}
        assert counts == {fwd.__name__: 1, dgrad.__name__: 1, wgrad.__name__: 1}
        torch.testing.assert_close(y.float(), plains[0](x, w, bias, 64).float(),
                                   rtol=2 ** -7, atol=1e-2)
        ref_dx = (plains[1](dy, w, 64) if halo else
                  K.conv3x3_packed_plain(dy, w.flip(0, 1, 2).transpose(3, 4),
                                         torch.zeros(cin, device=cuda), 64))
        _close(dx, ref_dx, 2 ** -7, 1e-4)
        chain = K.conv3x3_wgrad_chain(x, dy, 64)
        _close(dw, plains[2](x, dy, 64), 0.0, 16 * math.sqrt(chain) * 2 ** -24)
        del x, dy, y, dx, dw
    torch.cuda.empty_cache()


@pytest.mark.gpu
def test_gpu_sharded_train_step_on_2x2_launches_exactly_and_matches_unsharded(cuda):
    """The default generator and discriminator (full width, ``packed``,
    dropout 0) on a (2, 2) mesh on cuda:0, batch 4 × 64³: in bf16 each of
    the 4 shards launches the unsharded step's kernels in their halo forms
    (K5 8, K5-dgrad 4, K5-wgrad 4, K3a 5, K3b 4), nothing routed; in f32
    the losses within 1e-4 relative of the unsharded step's (the
    discriminator loss 1e-2) and every generator-phase gradient within 5e-2
    relative L2 (a conv bias before a norm: 1e-4 of the largest)."""
    import dataclasses

    from unet_bssfp_tpu_torch.config import Config
    from unet_bssfp_tpu_torch.parallel.mesh import make_mesh
    from unet_bssfp_tpu_torch.train.state import create_gan_state
    from unet_bssfp_tpu_torch.train.steps import make_train_step

    cfg = Config()
    mesh = make_mesh(["cuda:0"], ("data", "space"), (2, 2))
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.rand(4, 64, 64, 64, 24, device=cuda, generator=g)
    y = torch.rand(4, 64, 64, 64, 6, device=cuda, generator=g)

    def run(m, **over):
        mcfg = dataclasses.replace(cfg.model, dropout=0.0, **over)
        st = create_gan_state(0, "pc-bssfp", mcfg, cfg.train, cuda, mesh=m)
        K.reset_launches()
        metrics = make_train_step(st.gen, st.disc, cfg.train, mesh=m)(st, x, y)
        torch.cuda.synchronize()
        grads = {n: p.grad.detach().float().clone() for n, p in st.gen.named_parameters()}
        return {k: float(v) for k, v in metrics.items()}, grads, K.launches()

    metrics, _, counts = run(mesh)
    assert {k: v for k, v in counts.items() if v} == {
        "conv3x3_packed_halo": 32, "conv3x3_packed_halo_dgrad": 16,
        "conv3x3_wgrad_halo": 16, "pack_hw": 20, "unpack_hw": 16}
    assert all(math.isfinite(v) for v in metrics.values())
    got_m, got_g, _ = run(mesh, compute_dtype="float32", packed=True)
    ref_m, ref_g, _ = run(None, compute_dtype="float32", packed=True)
    for k, r in ref_m.items():
        assert abs(got_m[k] - r) <= (1e-2 if k == "train_discr_loss" else 1e-4) * abs(r), k
    scale = max(float(v.abs().max()) for v in ref_g.values())
    for name, r in ref_g.items():
        if name.endswith(".conv.bias"):
            assert float((got_g[name] - r).abs().max()) <= 1e-4 * scale, name
        else:
            assert float((got_g[name] - r).norm() / r.norm()) <= 5e-2, name


@pytest.mark.gpu
def test_gpu_gan_step_on_a_mesh_over_the_card_and_the_host(cuda):
    """A (2, 1) mesh over cuda:0 and the host (one replica each, the card's
    the masters), small widths, f32, ``packed``, dropout 0, batch 2 × 32³:
    one GAN step against the same step on a (2, 1) mesh of cuda:0 alone
    from the same weights and batch, under the 2 × 2 test's bounds; the
    card's position launches half of cuda:0 alone's kernels, the host's
    none; the host's replica bit-equal to the master after the step."""
    import dataclasses

    from unet_bssfp_tpu_torch.config import Config
    from unet_bssfp_tpu_torch.parallel.mesh import Mesh, make_mesh, replicas
    from unet_bssfp_tpu_torch.train.state import create_gan_state
    from unet_bssfp_tpu_torch.train.steps import make_train_step

    cfg = Config()
    mcfg = dataclasses.replace(cfg.model, features=(8, 16, 16, 32, 32, 8),
                               disc_features=(8, 8, 16), compute_dtype="float32",
                               dropout=0.0, packed=True)
    g = torch.Generator(device="cuda").manual_seed(6)
    x = torch.rand(2, 32, 32, 32, 24, device=cuda, generator=g)
    y = torch.rand(2, 32, 32, 32, 6, device=cuda, generator=g)
    runs = {}
    for key, mesh in (("alone", make_mesh(["cuda:0"], ("data",), (2,))),
                      ("mixed", Mesh([[torch.device("cuda", 0)], [torch.device("cpu")]],
                                     ("data",)))):
        st = create_gan_state(0, "pc-bssfp", mcfg, cfg.train, cuda, mesh=mesh)
        K.reset_launches()
        metrics = make_train_step(st.gen, st.disc, cfg.train, mesh=mesh)(st, x, y)
        torch.cuda.synchronize()
        grads = {n: p.grad.detach().float().clone() for n, p in st.gen.named_parameters()}
        runs[key] = ({k: float(v) for k, v in metrics.items()}, grads, K.launches(), st)
    (ref_m, ref_g, ref_c, _), (got_m, got_g, got_c, st) = runs["alone"], runs["mixed"]
    assert got_c["conv3x3_packed"] > 0
    assert {k: 2 * v for k, v in got_c.items()} == ref_c
    for k, r in ref_m.items():
        assert abs(got_m[k] - r) <= (1e-2 if k == "train_discr_loss" else 1e-4) * abs(r), k
    scale = max(float(v.abs().max()) for v in ref_g.values())
    for name, r in ref_g.items():
        if name.endswith(".conv.bias"):
            assert float((got_g[name] - r).abs().max()) <= 1e-4 * scale, name
        else:
            assert float((got_g[name] - r).norm() / r.norm()) <= 5e-2, name
    for mod in (st.gen, st.disc):
        master, twin = replicas(mod)
        assert next(twin.parameters()).device.type == "cpu"
        sd = twin.state_dict()
        assert all(torch.equal(v.cpu(), sd[k]) for k, v in master.state_dict().items())


# The serving artifact and the public surface (slice 16).

@pytest.mark.gpu
def test_gpu_exported_artifact_matches_the_packed_generator(cuda, tmp_path):
    """An artifact of the full-width generator exported on the card (f32,
    whole 32³ volume) against the packed generator's ``predict_volume`` on
    the same weights, within serving's 1e-3·max|ref|; calling it launches no
    hand-written kernel (ATen ops only)."""
    import dataclasses

    from unet_bssfp_tpu_torch import weights
    from unet_bssfp_tpu_torch.config import Config
    from unet_bssfp_tpu_torch.eval import export
    from unet_bssfp_tpu_torch.eval.inference import predict_volume
    from unet_bssfp_tpu_torch.train.state import build_models
    from unet_bssfp_tpu_torch.train.steps import make_predict_fn

    mcfg = dataclasses.replace(Config().model, compute_dtype="float32")
    gen, _ = build_models("pc-bssfp", mcfg, cuda)
    assert gen.unet.packed
    gen.load_state_dict(weights.random_state_dict(gen, 0))
    program, meta = export.export_generator("pc-bssfp", mcfg, gen.state_dict(),
                                            (1, 32, 32, 32, 24))
    assert meta["device"] == "cuda"
    path = str(tmp_path / "g.ubt")
    export.save_exported(program, meta, path)
    call, _ = export.load_exported(path)
    vol = torch.randn(32, 32, 32, 24, device=cuda, generator=torch.Generator(
        device="cuda").manual_seed(1))
    ref = predict_volume(make_predict_fn(gen), vol, whole_volume=True).float()
    K.reset_launches()
    got = call(vol[None])[0]
    torch.cuda.synchronize()
    assert not any(K.launches().values())
    assert got.is_cuda and got.dtype == torch.float32 and got.shape == ref.shape
    assert float((got - ref).abs().max()) <= 1e-3 * float(ref.abs().max())


@pytest.mark.gpu
def test_gpu_an_artifact_exported_on_the_cpu_does_not_run_on_the_card(cuda, tmp_path):
    """A program traced on the CPU asserts the CPU in its graph: moved to
    the card with ``.to("cuda")`` it raises on a card input, so
    ``load_exported`` refuses a CPU artifact for the card (and says to
    re-export on the serving device)."""
    import io

    from unet_bssfp_tpu_torch.config import ModelConfig
    from unet_bssfp_tpu_torch.eval import export

    mcfg = ModelConfig(features=(8, 8, 16, 16, 32, 8), compute_dtype="float32")
    program, meta = export.export_generator("pc-bssfp", mcfg, None, (1, 16, 16, 16, 24),
                                            device="cpu")
    path = str(tmp_path / "cpu.ubt")
    export.save_exported(program, meta, path)
    with pytest.raises(ValueError, match="re-export on the serving device"):
        export.load_exported(path, "cuda")
    moved = torch.export.load(io.BytesIO(export.read_exported(path)[1])).module().to(cuda)
    with pytest.raises(Exception):
        with torch.inference_mode():
            moved(torch.zeros(1, 16, 16, 16, 24, device=cuda))


@pytest.mark.gpu
def test_gpu_gan_wrapper_step_launches_and_losses_as_make_train_step(cuda):
    """``bSSFPToDWITensorModel`` on the card (its default device): a step
    launches what ``make_train_step`` launches (K1 8, K1-dgrad 4, K2 4, K3a
    5, K3b 4, K10 8 and its backward 4) and its losses are bit for bit those of ``make_train_step`` on
    a state drawn from the same seed (cuDNN deterministic)."""
    from unet_bssfp_tpu_torch.model import bSSFPToDWITensorModel
    from unet_bssfp_tpu_torch.train.state import create_gan_state
    from unet_bssfp_tpu_torch.train.steps import make_train_step

    cfg = _loop_config(Path("."))
    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.rand(4, 32, 32, 32, 24, device=cuda, generator=g)
    y = torch.rand(4, 32, 32, 32, 6, device=cuda, generator=g)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        wrapper = bSSFPToDWITensorModel("pc-bssfp", config=cfg, with_perceptual=False)
        wrapper.init(0)
        assert wrapper.device.type == "cuda" and wrapper.gen.unet.packed
        K.reset_launches()
        got = wrapper.train_step(wrapper.state, x, y)
        torch.cuda.synchronize()
        counts = K.launches()
        twin = create_gan_state(0, "pc-bssfp", cfg.model, wrapper.config.train, cuda)
        K.reset_launches()
        ref = make_train_step(twin.gen, twin.disc, wrapper.config.train)(twin, x, y)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = det
    assert counts == K.launches()
    assert {k: v for k, v in counts.items() if v} == {
        "conv3x3_packed": 8, "conv3x3_packed_dgrad": 4, "conv3x3_wgrad": 4, "pack_hw": 5,
        "unpack_hw": 4, "packed_norm_act": 8, "packed_norm_act_backward": 4}
    assert {k: float(v) for k, v in got.items()} == {k: float(v) for k, v in ref.items()}


# SwinUNETR (models/swin_unetr.py) on the card: its K1/K2 and K10 instances
# at the 96³ crops (4 × 96 × C × 96·96), and the generator (packed
# full-resolution blocks, SDPA's window attention) against the plain f32
# reference (portbench/reference/swin_unetr.py) at MONAI's BTCV widths.
SWIN_CFG = {"in_channels": 24, "out_channels": 6, "unet_in_channels": 24,
            "disc_negative_slope": 0.2, "disc_features": [32, 64, 128, 256, 512],
            "swin": {"feature_size": 48, "depths": [2, 2, 2, 2], "num_heads": [3, 6, 12, 24],
                     "window_size": 7, "patch_size": 2, "mlp_ratio": 4.0}}


@pytest.mark.gpu
@pytest.mark.parametrize("cin,cout", [(24, 48), (48, 48)])
def test_gpu_swin_96_convs_autograd_on_wgmma_kernels(cuda, cin, cout):
    """encoder1's and decoder1's 3³ convs at 96³ (decoder1's 96 → 48 runs as
    two 48 → 48 calls): forward, dx and dw through the wrappers against
    plain autograd in bf16, one launch each, none routed to a loop."""
    g = torch.Generator(device="cuda").manual_seed(cin + cout)
    xk = torch.randn(1, 96, cin, 96 * 96, device=cuda, generator=g).bfloat16()
    wt = torch.randn(3, 3, 3, cin, cout, device=cuda, generator=g) / (27 * cin) ** 0.5
    bias = torch.zeros(cout, device=cuda)
    dy = torch.randn(1, 96, cout, 96 * 96, device=cuda, generator=g).bfloat16()

    def grads(fn):
        x, w_ = (t.clone().requires_grad_(True) for t in (xk, wt))
        y = fn(x, w_, bias, 96)
        y.backward(dy)
        return y.detach(), x.grad, w_.grad

    K.reset_launches()
    y, dx, dw = grads(K.conv3x3_packed)
    counts = K.launches()
    assert (counts["conv3x3_packed"], counts["conv3x3_packed_dgrad"],
            counts["conv3x3_wgrad"]) == (1, 1, 1)
    assert counts["conv3x3_packed_mma_routed"] == counts["conv3x3_wgrad_mma_routed"] == 0
    ry, rdx, rdw = grads(K.conv3x3_packed_plain)
    # as the multi-stage instances: one bf16 rounding of y and dx a side; dw
    # in f32 over 884,736 positions, the plain one through w's bf16 cast
    _close(y, ry, 2 ** -7, 1e-4)
    _close(dx, rdx, 2 ** -7, 1e-4)
    _close(dw, rdw, 2 ** -7, 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("slope", [0.01, 1.0])
def test_gpu_packed_norm_act_swin_instances(cuda, slope):
    """K10 as the residual blocks call it at 96³ and 48 channels: no affine
    (scale 1, shift 0), no dropout, LeakyReLU 0.01 or the identity slope
    1.0, forward and backward in bf16, against the plain chain and both
    against it in f64 (the bounds of the cells' instances above)."""
    shape = (4, 96, 48, 96 * 96)
    g = torch.Generator(device="cuda").manual_seed(7)
    off = 2 * torch.randn(1, 1, 48, 1, device=cuda, generator=g)
    x = (torch.randn(shape, device=cuda, generator=g) + off).bfloat16()
    dy = torch.randn(shape, device=cuda, generator=g).bfloat16()
    scale, bias = torch.ones(48, device=cuda), torch.zeros(48, device=cuda)

    def run(fn, xin, out_dtype):
        xl = xin.detach().requires_grad_(True)
        y = fn(xl, scale, bias, slope, 96, 0, None, 1.0, 1e-5, out_dtype)
        y.backward(dy.to(y.dtype))
        return [y.detach(), xl.grad]

    K.reset_launches()
    got = run(K.packed_norm_act, x, torch.bfloat16)
    assert (K.packed_norm_act.launches, K.packed_norm_act_backward.launches) == (1, 1)
    plain = run(K.packed_norm_act_plain, x, torch.bfloat16)
    ref = run(K.packed_norm_act_plain, x.double(), torch.float64)
    for a, p, r in zip(got, plain, ref):
        floor = 2 ** -8 * float(r.abs().max())
        err = float((a.double() - r).abs().max())
        assert err <= max(2 * float((p.double() - r).abs().max()), floor)


def _swin_generator(cuda, dtype: str):
    from portbench.drivers.swin_gan_train import weights
    from unet_bssfp_tpu_torch.config import ModelConfig
    from unet_bssfp_tpu_torch.train.state import build_models

    s = SWIN_CFG["swin"]
    mcfg = ModelConfig(backbone="swin_unetr", dropout=0.0, compute_dtype=dtype, packed=True,
                       swin_feature_size=s["feature_size"])
    gen, _ = build_models("pc-bssfp", mcfg, cuda)
    w, _ = weights(SWIN_CFG, 11, cuda)
    gen.load_state_dict(w)
    return gen, w


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gpu_swin_generator_matches_reference(cuda, dtype):
    """The CUDA generator at full widths on 1 × 64³ (train-mode BatchNorm in
    the head, packed encoder1/decoder1, 8 window attention launches)
    against the plain f32 reference with TF32 off, by the output's
    ‖out − ref‖₂ / ‖ref‖₂. f32: the kernels and SDPA differ from the
    reference in summation order only, 1e-4. bf16: every layer's result
    rounds to 8 bits (2^-9 relative), over some 60 layers on the longest
    path; the GAN cell's serving readings of such a network reach 0.0178
    (PERF.md), held to 0.05."""
    from portbench.reference import swin_unetr as R

    gen, w = _swin_generator(cuda, dtype)
    x = torch.randn(1, 64, 64, 64, 24, device=cuda, generator=torch.Generator(
        device="cuda").manual_seed(3))
    K.reset_launches()
    with torch.no_grad():
        got = gen(x).float()
    assert K.launches()["window_attention"] == 8
    assert K.launches()["conv3x3_packed"] == 5 and K.launches()["packed_norm_act"] == 6
    with torch.no_grad():
        ref = R.generator(w, x, SWIN_CFG, True)
    rel = float((got - ref).norm() / ref.norm())
    assert rel <= (1e-4 if dtype == "float32" else 0.05), rel
