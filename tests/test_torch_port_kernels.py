"""The port's kernel modules against the JAX package's kernels.

On the CPU each wrapper takes its plain PyTorch version; these tests hold
that version (through the wrapper) to the JAX function as the JAX package's
own tests run it here (Pallas in interpret mode). The CUDA/Triton kernels
themselves are held to the plain versions on the card in
``test_torch_port_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_bssfp_tpu.ops.pallas.conv3d import (
    conv3x3_packed as jax_conv3x3_packed,
    pack_hw as jax_pack_hw,
    unpack_hw as jax_unpack_hw,
)
from unet_bssfp_tpu.ops.pallas.fused_norm_act import (
    fused_instance_norm_leaky_relu as jax_fused_in_lrelu,
)
from unet_bssfp_tpu_torch.ops import kernels as K

torch.set_num_threads(1)

# NDHWC (B, D, H, W, Cin): tests/test_pallas_conv3d.py's shapes plus the
# generator's Cin 24 head-to-conv_0 case.
CONV_SHAPES = [
    (1, 4, 8, 64, 3),
    (2, 4, 6, 64, 5),
    (1, 4, 12, 32, 8),
    (1, 3, 4, 128, 3),
    (1, 4, 8, 32, 24),
]


def _np(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv3x3_packed_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    b, d, h, w, cin = shape
    cout = 4
    x = _np(rng, shape, 0.3)
    wt = _np(rng, (3, 3, 3, cin, cout), 0.3)
    bias = _np(rng, (cout,), 0.3)
    xk = np.array(jax_pack_hw(jnp.asarray(x)), copy=True)
    ref = jax_conv3x3_packed(jnp.asarray(xk), jnp.asarray(wt), jnp.asarray(bias),
                             w, True)
    got = K.conv3x3_packed(torch.from_numpy(xk), torch.from_numpy(wt),
                           torch.from_numpy(bias), w)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 2, 4, 32, 3), (2, 3, 8, 16, 24),
                                   (1, 2, 8, 16, 64), (1, 2, 4, 32, 6)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_unpack_match_jax_exactly(shape, dtype):
    rng = np.random.default_rng(7)
    x = _np(rng, shape)
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = K.pack_hw(xt)
    ref = jax_pack_hw(xj)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    back = K.unpack_hw(got, shape[3])
    np.testing.assert_array_equal(
        back.float().numpy(),
        np.asarray(jax_unpack_hw(ref, shape[3]).astype(jnp.float32)))
    assert back.is_contiguous() and back.dtype == xt.dtype


@pytest.mark.parametrize("shape,slope", [((2, 8, 8, 8, 128), 0.1),
                                         ((1, 4, 4, 4, 24), 0.2),
                                         ((2, 4, 4, 4, 64), 0.1)])
@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5), ("bfloat16", 3e-2)])
def test_fused_norm_act_matches_jax(shape, slope, dtype, atol):
    rng = np.random.default_rng(11)
    c = shape[-1]
    x = _np(rng, shape)
    scale = _np(rng, (c,))
    bias = _np(rng, (c,))
    ref = jax_fused_in_lrelu(jnp.asarray(x).astype(dtype), jnp.asarray(scale),
                             jnp.asarray(bias), slope, interpret=True)
    got = K.fused_instance_norm_leaky_relu(
        torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(scale),
        torch.from_numpy(bias), slope)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), atol=atol)


def test_cpu_path_uses_plain_version_and_counts_nothing():
    K.reset_launches()
    xk = torch.randn(1, 2, 3, 128)
    w = torch.randn(3, 3, 3, 3, 4)
    b = torch.randn(4)
    torch.testing.assert_close(K.conv3x3_packed(xk, w, b, 32),
                               K.conv3x3_packed_plain(xk, w, b, 32),
                               rtol=0, atol=0)
    K.pack_hw(torch.randn(1, 2, 4, 32, 3))
    K.fused_instance_norm_leaky_relu(torch.randn(1, 2, 2, 2, 3),
                                     torch.ones(3), torch.zeros(3))
    assert set(K.launches().values()) == {0}


def test_packed_gate_matches_jax():
    from unet_bssfp_tpu.ops.pallas.conv3d import packed_supported as jax_gate

    for shape in [(8, 64, 64, 64, 24), (1, 96, 128, 128, 24),
                  (8, 64, 64, 63, 24), (8, 16, 16, 16, 256), (1, 4, 2, 64, 3),
                  (1, 16, 16, 16, 24)]:
        assert K.packed_supported(shape) == jax_gate(shape), shape
