"""K9a and K9b (``ops/kernels/probe.py``) without a card: the function each
K9b mode's plain version computes, stated independently through K1's plain
conv; the launch plan the probe takes (K1's wgmma plan, in the pairs the
probe library compiles); K9a's host shift. The kernels are held to these
plain versions on the card in ``test_torch_port_gpu.py``."""

import numpy as np
import pytest
import torch

from unet_bssfp_tpu_torch.ops import kernels as K
from unet_bssfp_tpu_torch.ops.kernels import conv_wgmma, probe

torch.set_num_threads(1)

# The probe's shapes (B, D, H, W, Cin, Cout): PROBE_CONV (chip_smoke.py and
# scripts/pallas_probe.py's conv0) and the two of the card tests.
PROBE_SHAPES = [(8, 64, 64, 64, 24, 32), (2, 4, 8, 64, 24, 32), (1, 3, 5, 40, 5, 36)]


def _inputs(cin, seed):
    rng = np.random.default_rng(seed)
    b, d, h, w, cout = 2, 4, 5, 8, 6
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    xk = t(rng.standard_normal((b, d, cin, h * w)))
    wt = t(rng.standard_normal((3, 3, 3, cin, cout)) * 0.3)
    return xk, wt, t(rng.standard_normal(cout)), w


@pytest.mark.parametrize("cin", [5, 24, 40])
def test_probe_fixed_plain_is_slice0_conv_with_chunk_summed_weights(cin):
    """fixed: K1's conv of input slice 0 (channels 0..15) repeated over d,
    with the weights' 16-channel chunks summed (zero past Cin). f32 on both
    sides; only the summation order differs."""
    xk, wt, bias, w = _inputs(cin, cin + 1)
    b, d, _, hw = xk.shape
    c, chunks = min(16, cin), -(-cin // 16)
    wp = torch.zeros(3, 3, 3, chunks * 16, wt.shape[4])
    wp[:, :, :, :cin] = wt
    wsum = wp.reshape(3, 3, 3, chunks, 16, -1).sum(3)[:, :, :, :c].contiguous()
    x0 = xk[:, :1, :c].expand(b, d, c, hw).contiguous()
    torch.testing.assert_close(K.conv3x3_probe_plain(xk, wt, bias, w, "fixed"),
                               K.conv3x3_packed_plain(x0, wsum, bias, w), rtol=1e-5, atol=1e-5)


def test_probe_full_plain_is_k1_plain():
    xk, wt, bias, w = _inputs(24, 3)
    assert torch.equal(K.conv3x3_probe_plain(xk, wt, bias, w, "full"),
                       K.conv3x3_packed_plain(xk, wt, bias, w))


@pytest.mark.parametrize("shape", PROBE_SHAPES)
def test_probe_shapes_take_k1s_plan_in_the_compiled_pairs(shape):
    b, d, h, w, cin, cout = shape
    xk = torch.empty(b, d, cin, h * w, dtype=torch.bfloat16, device="meta")
    plan = probe.probe_plan(xk, cout, w)
    assert plan == conv_wgmma.wgmma_plan(b, d, d, 0, cin, cout, h, w)
    assert (plan.n, plan.rows) in probe.PAIRS and not plan.lanes_map


def test_probe_plan_refuses_a_shape_without_a_wgmma_plan():
    xk = torch.empty(2, 4, 24, 8 * 64, dtype=torch.bfloat16, device="meta")
    # Cout > 96: a plan of two N tiles, which the probe library does not compile
    assert conv_wgmma.wgmma_plan(2, 4, 4, 0, 24, 128, 8, 64).n_tiles == 2
    with pytest.raises(ValueError):
        probe.probe_plan(xk, 128, 64)
    with pytest.raises(ValueError):  # a plan (N 96), but not a compiled pair
        probe.probe_plan(xk, 96, 64)


@pytest.mark.parametrize("shift,want", [(-1, 127), (0, 0), (128, 0), (129, 1)])
def test_roll_shift_is_normalised_on_the_host(shift, want):
    assert probe.roll_shift(shift, 128) == want
    x = torch.arange(3 * 128, dtype=torch.float32).reshape(3, 128)
    assert torch.equal(K.lane_roll(x, shift), torch.roll(x, shift, 1))
