"""K7a/K7b in the port (``conv3x3_pfold``, ``conv3x3_pfold_halo``, their
VJPs, ``fold4_pack`` / ``unfold4_unpack``, ``pfold_supported``) against the
JAX package's, on the CPU; and K9's plain versions against the functions
they are stated to compute.

The port's wrappers take their plain versions here; the Pallas pfold kernels
run in interpret mode, as the JAX package's own tests run them. The CUDA
kernels are held to the plain versions on the card in
``test_torch_port_gpu.py``.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_bssfp_tpu.ops.pallas import conv3d as jc3
from unet_bssfp_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

# (B, D, H, W, Cin, Cout): the JAX package's PFOLD_SHAPES
# (tests/test_pallas_conv3d.py)
PFOLD_SHAPES = [(1, 4, 8, 64, 3, 4), (2, 4, 16, 32, 5, 4), (1, 4, 8, 64, 8, 8)]
# the halo form: D is the output's, the input has D + 2 slices, all random
HALO_SHAPES = [(2, 4, 8, 64, 5, 4), (1, 1, 16, 32, 8, 8)]


def _inputs(shape, seed, d_extra=0):
    rng = np.random.default_rng(seed)
    b, d, h, w, cin, cout = shape
    mk = lambda *s: (rng.standard_normal(s) * 0.3).astype(np.float32)  # noqa: E731
    return (mk(b, d + d_extra, h, w, cin), mk(3, 3, 3, cin, cout), mk(cout),
            mk(b, d, h, w, cout))


def _fold(a):
    """NDHWC numpy → the folded layout, through JAX's fold4_pack."""
    return np.asarray(jc3.fold4_pack(jnp.asarray(a)))


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


@pytest.mark.parametrize("shape", PFOLD_SHAPES)
def test_pfold_forward_matches_jax(shape):
    """f32, rtol/atol 1e-5: the JAX package's own pfold forward bound."""
    x, wt, bias, _ = _inputs(shape, sum(shape))
    w4 = shape[3] // 4
    xf = _fold(x)
    ref = jc3.conv3x3_pfold(jnp.asarray(xf), jnp.asarray(wt), jnp.asarray(bias), w4, True)
    got = K.conv3x3_pfold(_t(xf), _t(wt), _t(bias), w4)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def _vjp_check(jax_fn, port_fn, xf, wt, bias, dy, w4):
    _, vjp = jax.vjp(lambda a, b_, c: jax_fn(a, b_, c, w4, True),
                     jnp.asarray(xf), jnp.asarray(wt), jnp.asarray(bias))
    rdx, rdw, rdb = (np.asarray(g) for g in vjp(jnp.asarray(dy)))
    x_t, w_t, b_t = _t(xf, True), _t(wt, True), _t(bias, True)
    port_fn(x_t, w_t, b_t, w4).backward(_t(dy))
    assert x_t.grad.shape == xf.shape
    # the JAX package's pfold VJP bounds: dx rtol 1e-4 / atol 1e-5, dw and db 1e-4
    np.testing.assert_allclose(x_t.grad.numpy(), rdx, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(w_t.grad.numpy(), rdw, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(b_t.grad.numpy(), rdb, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", PFOLD_SHAPES[:2])
def test_pfold_vjp_matches_jax(shape):
    """dx (K7a on dy with the flipped, transposed weight), dw (K7b) and db
    against ``jax.vjp`` of the Pallas pfold conv."""
    x, wt, bias, dyn = _inputs(shape, sum(shape) + 1)
    _vjp_check(jc3.conv3x3_pfold, K.conv3x3_pfold, _fold(x), wt, bias, _fold(dyn),
               shape[3] // 4)


@pytest.mark.parametrize("shape", HALO_SHAPES)
def test_pfold_halo_forward_matches_jax(shape):
    x, wt, bias, _ = _inputs(shape, sum(shape) + 2, d_extra=2)
    w4 = shape[3] // 4
    xp = _fold(x)
    ref = jc3.conv3x3_pfold_halo(jnp.asarray(xp), jnp.asarray(wt), jnp.asarray(bias), w4, True)
    got = K.conv3x3_pfold_halo(_t(xp), _t(wt), _t(bias), w4)
    assert got.shape == ref.shape == (shape[0], shape[1], 4 * shape[5], shape[2] * w4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", HALO_SHAPES)
def test_pfold_halo_vjp_matches_jax(shape):
    """dxp (D + 2 slices from D of dy), dw and db of the halo form against
    ``jax.vjp`` of ``conv3x3_pfold_halo`` (dy padded by two slices per side
    there, bounds here), at the VJP bounds above."""
    x, wt, bias, dyn = _inputs(shape, sum(shape) + 3, d_extra=2)
    _vjp_check(jc3.conv3x3_pfold_halo, K.conv3x3_pfold_halo, _fold(x), wt, bias, _fold(dyn),
               shape[3] // 4)


def test_pfold_bf16_matches_jax():
    """bf16 in and out, f32 accumulation on both sides: each rounds its f32
    sum once, so they land at most one bf16 ulp apart (rtol 2^-7, atol 1e-2,
    the port's bf16 bound for K1)."""
    shape = PFOLD_SHAPES[0]
    x, wt, bias, dyn = _inputs(shape, 11)
    w4 = shape[3] // 4
    xj = jnp.asarray(_fold(x)).astype(jnp.bfloat16)
    ref, vjp = jax.vjp(lambda a, b_, c: jc3.conv3x3_pfold(a, b_, c, w4, True),
                       xj, jnp.asarray(wt), jnp.asarray(bias))
    x_t = _t(_fold(x)).to(torch.bfloat16).requires_grad_(True)
    w_t, b_t = _t(wt, True), _t(bias, True)
    got = K.conv3x3_pfold(x_t, w_t, b_t, w4)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(ref, np.float32),
                               rtol=2 ** -7, atol=1e-2)
    dy = _fold(dyn)
    rdx, rdw, _ = vjp(jnp.asarray(dy).astype(jnp.bfloat16))
    got.backward(_t(dy).to(torch.bfloat16))
    assert x_t.grad.dtype == torch.bfloat16 and w_t.grad.dtype == torch.float32
    np.testing.assert_allclose(x_t.grad.float().numpy(), np.asarray(rdx, np.float32),
                               rtol=2 ** -7, atol=1e-2)
    np.testing.assert_allclose(w_t.grad.numpy(), np.asarray(rdw, np.float32),
                               rtol=2 ** -7, atol=1e-2)


@pytest.mark.parametrize("shape", PFOLD_SHAPES)
def test_fold_unfold_exact_vs_jax(shape):
    b, d, h, w, cin, _ = shape
    x = np.random.default_rng(sum(shape)).standard_normal((b, d, h, w, cin)).astype(np.float32)
    ref = np.asarray(jc3.fold4_pack(jnp.asarray(x)))
    got = K.fold4_pack(_t(x))
    np.testing.assert_array_equal(got.numpy(), ref)
    back = np.asarray(jc3.unfold4_unpack(jnp.asarray(ref), w // 4))
    np.testing.assert_array_equal(K.unfold4_unpack(_t(ref), w // 4).numpy(), back)
    np.testing.assert_array_equal(back, x)


def test_fold_unfold_gradients_are_inverse_permutations():
    x = _t(np.random.default_rng(5).standard_normal((1, 2, 3, 8, 5)), True)
    g = torch.randn(1, 2, 20, 6)
    K.fold4_pack(x).backward(g)
    torch.testing.assert_close(x.grad, K.unfold4_unpack(g, 2), rtol=0, atol=0)


@pytest.mark.parametrize("c", [3, 96, 128, 129])
def test_pfold_supported_matches_jax(c):
    for d, h, w in itertools.product((0, 1, 4), (2, 3, 8, 16), (4, 6, 8, 12, 32, 64, 66, 256)):
        shape = (1, d, h, w, c)
        assert K.pfold_supported(shape) == jc3.pfold_supported(shape), shape
    assert not K.pfold_supported((1, 4, 8, 64)) and not jc3.pfold_supported((1, 4, 8, 64))


def test_pfold_cpu_path_counts_nothing_and_refuses_other_devices():
    K.reset_launches()
    xf = torch.randn(1, 4, 12, 32, requires_grad=True)
    wt = torch.randn(3, 3, 3, 3, 4, requires_grad=True)
    K.conv3x3_pfold(xf, wt, torch.zeros(4), 2).sum().backward()
    K.conv3x3_pfold_halo(xf, wt, torch.zeros(4), 2).sum().backward()
    assert set(K.launches().values()) == {0}
    with pytest.raises((ValueError, NotImplementedError, RuntimeError)):
        K.conv3x3_pfold(xf.detach().to("meta"), wt.detach().to("meta"),
                        torch.zeros(4, device="meta"), 2)


# K9b's plain versions against an independent statement of each mode's
# function (csrc/conv3x3_wgmma.cuh's MODE note): K1's plain conv with the
# weights rearranged. f32 on both sides; only the summation order differs.
# The fixed mode's statement is in test_torch_port_probe_plan.py.
def _probe_inputs(cin, seed):
    rng = np.random.default_rng(seed)
    b, d, h, w, cout = 2, 4, 5, 8, 6
    xk = _t(rng.standard_normal((b, d, cin, h * w)))
    wt = _t(rng.standard_normal((3, 3, 3, cin, cout)) * 0.3)
    return xk, wt, _t(rng.standard_normal(cout)), w


@pytest.mark.parametrize("cin", [5, 24])
def test_probe_centre_plain_is_summed_tap_conv(cin):
    xk, wt, bias, w = _probe_inputs(cin, cin)
    wc = torch.zeros_like(wt)
    wc[:, 1, 1] = wt.sum(dim=(1, 2))  # every tap's weight on the centre tap
    torch.testing.assert_close(K.conv3x3_probe_plain(xk, wt, bias, w, "centre"),
                               K.conv3x3_packed_plain(xk, wc, bias, w), rtol=1e-5, atol=1e-5)


def test_probe_full_plain_is_jax_reference_conv():
    """``probe_tiny_conv``'s shape: (1, 4, 4, 64, 3 → 4), zero bias, against
    the JAX package's packed reference conv."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((1, 4, 4, 64, 3)) * 0.3).astype(np.float32)
    wt = (rng.standard_normal((3, 3, 3, 3, 4)) * 0.3).astype(np.float32)
    xk = jc3.pack_hw(jnp.asarray(x))
    ref = jc3.conv3x3_reference_packed(xk, jnp.asarray(wt), jnp.zeros(4), 64)
    got = K.conv3x3_probe_plain(_t(np.asarray(xk)), _t(wt), torch.zeros(4), 64, "full")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shift", [1, -1, 129])
def test_lane_roll_plain_matches_torch_roll(shift):
    x = torch.arange(8 * 128, dtype=torch.float32).reshape(8, 128)
    assert torch.equal(K.lane_roll(x, shift), torch.roll(x, shift, 1))
