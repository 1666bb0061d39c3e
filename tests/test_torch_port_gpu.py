"""The port's CUDA/Triton kernels against their plain PyTorch versions, on
the card (``gpu`` marker; skipped without a CUDA device).

This file imports no JAX, so it runs where the port runs:

  python -m pytest tests/test_torch_port_gpu.py --noconftest -q
"""

import pytest
import torch

from unet_bssfp_tpu_torch.ops import kernels as K


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


@pytest.mark.gpu
@pytest.mark.parametrize("c", [6, 24, 40, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_pack_unpack_exact(cuda, c, dtype):
    for h, w in ((16, 32), (5, 19)):
        x = torch.randn(2, 4, h, w, c, device=cuda).to(dtype)
        xk = K.pack_hw(x)
        assert torch.equal(xk, K.pack_hw_plain(x))
        assert torch.equal(K.unpack_hw(xk, w), x)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 16, 16, 16, 64), (2, 4, 4, 4, 512)])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 3e-2)])
def test_gpu_fused_norm_act_matches_plain(cuda, shape, dtype, atol):
    x = torch.randn(shape, device=cuda).to(dtype)
    s = torch.randn(shape[-1], device=cuda)
    b = torch.randn(shape[-1], device=cuda)
    got = K.fused_instance_norm_leaky_relu(x, s, b, 0.1).float()
    ref = K.instance_norm_leaky_relu_plain(x, s, b, 0.1).float()
    torch.testing.assert_close(got, ref, rtol=0, atol=atol)


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
    plain = build_models("pc-bssfp", dataclasses.replace(mcfg, packed=False), cuda)
    sd = weights.random_state_dict(plain, 0)
    plain.load_state_dict(sd)
    kern = build_models("pc-bssfp", dataclasses.replace(
        mcfg, packed=True, use_pallas=use_pallas), cuda, state_dict=sd)
    x = torch.randn(2, 32, 32, 32, 24, device=cuda)
    K.reset_launches()
    got = make_predict_fn(kern)(x)
    assert K.conv3x3_packed.launches == 4 and K.unpack_hw.launches == 1
    assert (K.fused_instance_norm_leaky_relu.launches > 0) == use_pallas
    ref = make_predict_fn(plain)(x)
    torch.testing.assert_close(got, ref, rtol=1e-3, atol=1e-4)
