"""The ``wguard`` form of the port's packed conv (K1W) and of its halo form
against the JAX package's ``conv3x3_packed(..., wguard=g)`` and
``conv3x3_packed_halo(..., wguard=g)`` in interpret mode, on the CPU:
forward, dx, dw and db, float32.

Under ``wguard`` the last g of the wdim columns of every w-row are zero guard
columns: inputs carry zeros there, the outputs and dx are zero there, and a
cotangent on them is ignored. The port's CPU path is its plain versions (the
conv, then the guard mask); the kernel is held to them on the card
(``test_torch_port_gpu.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_bssfp_tpu.ops.pallas.conv3d import (
    conv3x3_packed as jax_conv3x3_packed,
    conv3x3_packed_halo as jax_conv3x3_packed_halo,
)
from unet_bssfp_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

# (B, D, H, W, g, Cin, Cout): H·(W + g) a multiple of 128, as the JAX
# package's guard_cols picks g.
CASES = [(1, 3, 8, 14, 2, 4, 4), (2, 2, 8, 14, 2, 5, 8), (1, 2, 16, 64, 8, 3, 6)]


def _inputs(case, seed, halo):
    b, d, h, w, g, cin, cout = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, d + 2 * halo, cin, h, w + g)).astype(np.float32) * 0.3
    x[..., w:] = 0.0  # the guard columns are zero
    wt = rng.standard_normal((3, 3, 3, cin, cout)).astype(np.float32) * 0.3
    bias = rng.standard_normal((cout,)).astype(np.float32) * 0.3
    # a cotangent with nonzero guard entries: the VJP must ignore them
    dy = rng.standard_normal((b, d, cout, h * (w + g))).astype(np.float32) * 0.3
    return x.reshape(b, d + 2 * halo, cin, h * (w + g)), wt, bias, dy


def _pair(halo):
    return ((jax_conv3x3_packed_halo, K.conv3x3_packed_halo) if halo
            else (jax_conv3x3_packed, K.conv3x3_packed))


@pytest.mark.parametrize("halo", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_wguard_forward_matches_jax(case, halo):
    """f32, rtol/atol 1e-5 (the port's K1 and K5 parity bound); the guard
    columns of the output exactly zero."""
    x, wt, bias, _ = _inputs(case, sum(case), halo)
    wdim, g = case[3] + case[4], case[4]
    jfn, tfn = _pair(halo)
    ref = np.asarray(jfn(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias), wdim, True, g))
    got = tfn(torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(bias), wdim, g)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    rows = got.reshape(*got.shape[:3], -1, wdim)
    assert (rows[..., wdim - g:] == 0).all()


@pytest.mark.parametrize("halo", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_wguard_vjp_matches_jax(case, halo):
    """dx, dw and db against ``jax.vjp`` of the Pallas conv, rtol/atol 3e-4
    (the halo VJP's parity bound), for a cotangent that is nonzero on the
    guard columns."""
    x, wt, bias, dy = _inputs(case, sum(case) + 1, halo)
    wdim, g = case[3] + case[4], case[4]
    jfn, tfn = _pair(halo)
    _, vjp = jax.vjp(lambda a, w_, b_: jfn(a, w_, b_, wdim, True, g),
                     jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias))
    ref = [np.asarray(r) for r in vjp(jnp.asarray(dy))]
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, wt, bias)]
    tfn(*ts, wdim, g).backward(torch.from_numpy(dy))
    for t, r in zip(ts, ref):
        np.testing.assert_allclose(t.grad.numpy(), r, rtol=3e-4, atol=3e-4)
    dx_rows = ts[0].grad.reshape(*x.shape[:3], -1, wdim)
    assert (dx_rows[..., wdim - g:] == 0).all()


def test_wguard_vjp_ignores_guard_cotangents():
    """The port's counterpart of the JAX package's test of the same name: the
    primal's guard columns are constants, so gradients of a loss over all
    lanes equal those of the same loss over the data lanes only."""
    b, d, h, w, cin, cout, g = 1, 2, 16, 64, 4, 4, 8
    rng = np.random.default_rng(31)
    x = rng.standard_normal((b, d, cin, h, w + g)).astype(np.float32)
    x[..., w:] = 0.0
    xk = torch.from_numpy(x.reshape(b, d, cin, h * (w + g)))
    wt = torch.from_numpy(rng.standard_normal((3, 3, 3, cin, cout)).astype(np.float32) * 0.3)
    bias = torch.from_numpy(rng.standard_normal((cout,)).astype(np.float32))

    def data_lanes(y):
        return y.reshape(*y.shape[:3], h, w + g)[..., :w]

    for conv, xin in ((lambda a, ww, bb: K.conv3x3_packed(a, ww, bb, w + g, g), xk),
                      (lambda a, ww, bb: K.conv3x3_packed_halo(
                          torch.nn.functional.pad(a, (0, 0, 0, 0, 1, 1)), ww, bb, w + g, g),
                       xk)):
        grads = []
        for sel in (lambda y: y, data_lanes):
            ts = [t.clone().requires_grad_(True) for t in (xin, wt, bias)]
            ((sel(conv(*ts)) + 1.0) ** 2).sum().backward()
            grads.append([t.grad for t in ts])
        for a, c in zip(*grads):
            torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-5)
