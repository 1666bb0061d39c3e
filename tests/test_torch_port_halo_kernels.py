"""K5 in the port (``conv3x3_packed_halo``, its dgrad and its wgrad) against
the JAX package's ``conv3x3_packed_halo`` and its custom VJP, on the CPU.

The port's wrappers take their plain versions here; the Pallas kernel runs
in interpret mode, as the JAX package's own tests run it. The halo slices of
every input are random like the body, so a confusion between the D + 2 input
slices and the D output slices would show. The CUDA kernels are held to the
plain versions on the card in ``test_torch_port_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_bssfp_tpu.ops.pallas.conv3d import (
    _dw_impl,
    conv3x3_packed_halo as jax_conv3x3_packed_halo,
)
from unet_bssfp_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

# (B, D, H, W, Cin) → Cout, D the output's: the JAX tests' multichip shapes
# halved in d, one local slice, and the generator's channel counts.
CASES = [((8, 4, 4, 32, 3), 4), ((2, 1, 8, 16, 5), 4), ((1, 2, 4, 32, 24), 32),
         ((1, 3, 4, 32, 32), 24), ((1, 2, 4, 32, 96), 32)]


def _np(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


def _inputs(shape, cout, seed):
    rng = np.random.default_rng(seed)
    b, d, h, w, cin = shape
    return (_np(rng, (b, d + 2, cin, h * w), 0.3), _np(rng, (3, 3, 3, cin, cout), 0.3),
            _np(rng, (cout,), 0.3), _np(rng, (b, d, cout, h * w), 0.3))


@pytest.mark.parametrize("shape,cout", CASES)
def test_halo_conv_forward_matches_jax(shape, cout):
    """f32, rtol/atol 1e-5: the bound of the JAX package's own sharded conv
    test (tests/test_packed_multichip.py::test_conv_space_sharded_matches_plain)."""
    xp, wt, bias, _ = _inputs(shape, cout, sum(shape))
    w = shape[3]
    ref = jax_conv3x3_packed_halo(jnp.asarray(xp), jnp.asarray(wt), jnp.asarray(bias),
                                  w, True)
    got = K.conv3x3_packed_halo(_t(xp), _t(wt), _t(bias), w)
    assert got.shape == (shape[0], shape[1], cout, shape[2] * w)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,cout", CASES)
def test_halo_conv_vjp_matches_jax(shape, cout):
    """dxp (D + 2 slices), dw and db against ``jax.vjp`` of the Pallas halo
    conv, rtol/atol 3e-4 (test_conv_space_sharded_grads_match_plain)."""
    xp, wt, bias, dy = _inputs(shape, cout, sum(shape) + 1)
    w = shape[3]
    _, vjp = jax.vjp(lambda x_, w_, b_: jax_conv3x3_packed_halo(x_, w_, b_, w, True),
                     jnp.asarray(xp), jnp.asarray(wt), jnp.asarray(bias))
    ref = [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    x_t, w_t, b_t = _t(xp, True), _t(wt, True), _t(bias, True)
    K.conv3x3_packed_halo(x_t, w_t, b_t, w).backward(_t(dy))
    assert x_t.grad.shape == xp.shape
    for got, r in zip((x_t.grad, w_t.grad, b_t.grad), ref):
        np.testing.assert_allclose(got.numpy(), r, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("shape,cout", CASES)
def test_halo_gradient_wrappers_match_jax_parts(shape, cout):
    """The two gradient wrappers alone against the parts of the JAX VJP:
    ``_dw_impl(pad_d=False)``, and the halo conv of dy padded by two slices
    per side with the flipped, transposed weight."""
    xp, wt, _, dy = _inputs(shape, cout, sum(shape) + 2)
    w = shape[3]
    ref_dw = np.asarray(_dw_impl(jnp.asarray(xp), jnp.asarray(dy), w, True, pad_d=False))
    got_dw = K.conv3x3_wgrad_halo(_t(xp), _t(dy), w)
    assert got_dw.dtype == torch.float32
    np.testing.assert_allclose(got_dw.numpy(), ref_dw, rtol=3e-4, atol=3e-4)
    dyp = jnp.pad(jnp.asarray(dy), ((0, 0), (2, 2), (0, 0), (0, 0)))
    w_flip_t = jnp.transpose(jnp.asarray(wt)[::-1, ::-1, ::-1], (0, 1, 2, 4, 3))
    ref_dx = jax_conv3x3_packed_halo(dyp, w_flip_t, jnp.zeros((shape[4],)), w, True)
    got_dx = K.conv3x3_packed_halo_dgrad(_t(dy), _t(wt), w)
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(ref_dx), rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("shape,cout", CASES[:3])
def test_halo_conv_bf16_matches_jax(shape, cout):
    """bf16 in and out, f32 accumulation on both sides: each rounds its f32
    sum once, so they land at most one bf16 ulp apart (rtol 2^-7, atol 1e-2:
    the port's bf16 bound for K1 on the card)."""
    xp, wt, bias, dy = _inputs(shape, cout, sum(shape) + 3)
    w = shape[3]
    xj = jnp.asarray(xp).astype(jnp.bfloat16)
    ref, vjp = jax.vjp(lambda x_, w_, b_: jax_conv3x3_packed_halo(x_, w_, b_, w, True),
                       xj, jnp.asarray(wt), jnp.asarray(bias))
    x_t = _t(xp).to(torch.bfloat16).requires_grad_(True)
    w_t, b_t = _t(wt, True), _t(bias, True)
    got = K.conv3x3_packed_halo(x_t, w_t, b_t, w)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), rtol=2 ** -7, atol=1e-2)
    rdx, rdw, rdb = vjp(jnp.asarray(dy).astype(jnp.bfloat16))
    got.backward(_t(dy).to(torch.bfloat16))
    assert x_t.grad.dtype == torch.bfloat16 and w_t.grad.dtype == torch.float32
    np.testing.assert_allclose(x_t.grad.float().numpy(),
                               np.asarray(rdx.astype(jnp.float32)), rtol=2 ** -7, atol=1e-2)
    # dw and db are f32 sums of products of the same bf16 values
    np.testing.assert_allclose(w_t.grad.numpy(), np.asarray(rdw, np.float32),
                               rtol=2 ** -7, atol=1e-2)
    np.testing.assert_allclose(b_t.grad.numpy(), np.asarray(rdb), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_zero_halo_equals_same_conv(dtype):
    """K5 on cat(0, x, 0) is the SAME conv of x (the zero pad made real)."""
    rng = np.random.default_rng(4)
    xk = _t(_np(rng, (2, 3, 5, 128))).to(dtype)
    wt, bias = _t(_np(rng, (3, 3, 3, 5, 4), 0.3)), _t(_np(rng, (4,)))
    zero = torch.zeros_like(xk[:, :1])
    got = K.conv3x3_packed_halo(torch.cat([zero, xk, zero], 1), wt, bias, 32)
    ref = K.conv3x3_packed(xk, wt, bias, 32)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=2 ** -7, atol=1e-2)
    torch.testing.assert_close(got, ref, **tol)


def test_halo_cpu_path_counts_nothing_and_refuses_other_devices():
    K.reset_launches()
    xp = torch.randn(1, 4, 3, 128, requires_grad=True)
    wt = torch.randn(3, 3, 3, 3, 4, requires_grad=True)
    K.conv3x3_packed_halo(xp, wt, torch.zeros(4), 32).sum().backward()
    assert set(K.launches().values()) == {0}
    assert {"conv3x3_packed_halo", "conv3x3_packed_halo_dgrad",
            "conv3x3_wgrad_halo"} <= set(K.launches())
    with pytest.raises((ValueError, NotImplementedError, RuntimeError)):
        K.conv3x3_packed_halo(xp.detach().to("meta"), wt.detach().to("meta"),
                              torch.zeros(4, device="meta"), 32)
