"""The training slice's kernel modules under autograd against the JAX
package's custom VJPs, on the CPU (the wrappers take their plain versions;
the Pallas kernels run in interpret mode, as the JAX package's own tests run
them). The CUDA kernels are held to the plain versions on the card in
``test_torch_port_gpu.py``."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_bssfp_tpu.models.packed_layers import packed_max_pool2 as jax_pool
from unet_bssfp_tpu.ops.pallas.conv3d import (
    _dw_impl,
    conv3x3_packed as jax_conv3x3_packed,
    pack_hw as jax_pack_hw,
    unpack_hw as jax_unpack_hw,
)
from unet_bssfp_tpu.ops.pallas.fused_norm_act import (
    fused_instance_norm_leaky_relu_vjp as jax_norm_vjp,
)
from unet_bssfp_tpu_torch.models.layers import max_pool2
from unet_bssfp_tpu_torch.models.packed_layers import packed_max_pool2
from unet_bssfp_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

# NDHWC (B, D, H, W, Cin) → Cout: tests/test_pallas_conv3d.py's VJP shapes,
# and the generator's dgrad directions (Cout 24 and 96 from Cin 32 is the
# dgrad of the 24→32 and 96→32 convs).
VJP_CASES = [((1, 4, 8, 64, 3), 4), ((2, 4, 6, 64, 5), 4),
             ((1, 3, 8, 16, 8), 24), ((1, 2, 4, 32, 32), 96)]


def _np(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


@pytest.mark.parametrize("shape,cout", VJP_CASES)
def test_conv3x3_packed_vjp_matches_jax(shape, cout):
    """dx, dw and db of the port's autograd Function (dx through the dgrad
    launch on flipped, transposed weights, dw through the wgrad launch)
    against ``jax.vjp`` of the Pallas conv; tolerances of
    tests/test_pallas_conv3d.py::test_vjp_matches_xla."""
    rng = np.random.default_rng(sum(shape) + cout)
    b, d, h, w, cin = shape
    xk = np.asarray(jax_pack_hw(jnp.asarray(_np(rng, shape, 0.3))))
    wt = _np(rng, (3, 3, 3, cin, cout), 0.3)
    bias = _np(rng, (cout,), 0.3)
    dy = _np(rng, (b, d, cout, h * w), 0.3)
    _, vjp = jax.vjp(lambda x_, w_, b_: jax_conv3x3_packed(x_, w_, b_, w, True),
                     jnp.asarray(xk), jnp.asarray(wt), jnp.asarray(bias))
    ref = [np.asarray(g) for g in vjp(jnp.asarray(dy))]

    x_t, w_t, b_t = _t(xk, True), _t(wt, True), _t(bias, True)
    K.conv3x3_packed(x_t, w_t, b_t, w).backward(_t(dy))
    for got, r, tol in ((x_t.grad, ref[0], dict(rtol=1e-4, atol=1e-5)),
                        (w_t.grad, ref[1], dict(rtol=1e-4, atol=1e-4)),
                        (b_t.grad, ref[2], dict(rtol=1e-4, atol=1e-4))):
        np.testing.assert_allclose(got.numpy(), r, **tol)


@pytest.mark.parametrize("shape,cout", [((1, 4, 8, 64, 3), 4),
                                        ((2, 3, 8, 16, 24), 32),
                                        ((1, 2, 4, 32, 96), 32)])
def test_wgrad_plain_matches_jax_dw_impl(shape, cout):
    """K2's plain version against the TPU kernel ``_dw_impl`` (interpret):
    the same f32 sum in another order."""
    rng = np.random.default_rng(3 + cout)
    b, d, h, w, cin = shape
    xk = _np(rng, (b, d, cin, h * w))
    dy = _np(rng, (b, d, cout, h * w))
    ref = np.asarray(_dw_impl(jnp.asarray(xk), jnp.asarray(dy), w, interpret=True))
    got = K.conv3x3_wgrad(_t(xk), _t(dy), w)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(1, 2, 4, 32, 3), (2, 3, 8, 16, 24)])
def test_pack_unpack_gradients_match_jax_exactly(shape):
    """Each relayout's backward is the other relayout: a permutation, so
    exact."""
    rng = np.random.default_rng(5)
    x = _np(rng, shape)
    b, d, h, w, c = shape
    dk = _np(rng, (b, d, c, h * w))
    _, vjp = jax.vjp(jax_pack_hw, jnp.asarray(x))
    x_t = _t(x, True)
    K.pack_hw(x_t).backward(_t(dk))
    np.testing.assert_array_equal(x_t.grad.numpy(), np.asarray(vjp(jnp.asarray(dk))[0]))

    xk = np.asarray(jax_pack_hw(jnp.asarray(x)))
    _, vjp = jax.vjp(lambda v: jax_unpack_hw(v, w), jnp.asarray(xk))
    xk_t = _t(xk, True)
    K.unpack_hw(xk_t, w).backward(_t(x))
    np.testing.assert_array_equal(xk_t.grad.numpy(), np.asarray(vjp(jnp.asarray(x))[0]))


@pytest.mark.parametrize("shape,slope", [((2, 4, 4, 4, 24), 0.1), ((1, 8, 8, 8, 16), 0.2)])
def test_fused_norm_act_gradients_match_jax(shape, slope):
    """K4's autograd (plain backward recomputed, as the JAX VJP does) against
    ``jax.vjp`` of ``fused_instance_norm_leaky_relu_vjp``: f32 reductions in
    another order."""
    rng = np.random.default_rng(9)
    c = shape[-1]
    x, scale, bias = _np(rng, shape), 1 + _np(rng, (c,), 0.1), _np(rng, (c,), 0.1)
    g = _np(rng, shape)
    _, vjp = jax.vjp(lambda *a: jax_norm_vjp(*a, slope, 1e-5),
                     jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    ref = vjp(jnp.asarray(g))
    ts = [_t(a, True) for a in (x, scale, bias)]
    K.fused_instance_norm_leaky_relu(*ts, slope).backward(_t(g))
    for t, r in zip(ts, ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5)


def _tied(rng, shape):
    """Values on a coarse grid: many exact ties inside each 2×2×2 window."""
    return (np.round(rng.standard_normal(shape) * 1.5) / 1.5).astype(np.float32)


def test_packed_max_pool2_gradient_is_first_match_on_ties():
    """The whole gradient of a window goes to its first maximal position in
    (d, h, w) row-major order, exactly as the JAX custom VJP (and XLA's
    select-and-scatter) route it."""
    rng = np.random.default_rng(7)
    xk = _tied(rng, (2, 8, 16, 8 * 8))
    y_ref, vjp = jax.vjp(lambda v: jax_pool(v, 8), jnp.asarray(xk))
    dy = _np(rng, y_ref.shape)
    xk_t = _t(xk, True)
    y = packed_max_pool2(xk_t, 8)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_ref))
    y.backward(_t(dy))
    np.testing.assert_array_equal(xk_t.grad.numpy(), np.asarray(vjp(jnp.asarray(dy))[0]))
    # every window routes its gradient to exactly one position
    assert int((xk_t.grad != 0).sum()) == int((dy != 0).sum())


def test_max_pool2_gradient_matches_flax_on_ties():
    """The plain pool (``F.max_pool3d``) against Flax ``nn.max_pool``'s
    gradient on tied inputs: the same first-match routing, exactly."""
    rng = np.random.default_rng(8)
    x = _tied(rng, (2, 8, 8, 8, 16))
    y_ref, vjp = jax.vjp(lambda v: fnn.max_pool(v, (2, 2, 2), strides=(2, 2, 2)),
                         jnp.asarray(x))
    dy = _np(rng, y_ref.shape)
    x_t = _t(x, True)
    y = max_pool2(x_t)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_ref))
    y.backward(_t(dy))
    np.testing.assert_array_equal(x_t.grad.numpy(), np.asarray(vjp(jnp.asarray(dy))[0]))


def test_cpu_backward_counts_no_launches():
    K.reset_launches()
    x = torch.randn(1, 2, 3, 128, requires_grad=True)
    w = torch.randn(3, 3, 3, 3, 4, requires_grad=True)
    b = torch.randn(4, requires_grad=True)
    y = K.conv3x3_packed(K.pack_hw(K.unpack_hw(x, 32)), w, b, 32)
    y.sum().backward()
    assert x.grad is not None and w.grad is not None and b.grad is not None
    assert set(K.launches().values()) == {0}
