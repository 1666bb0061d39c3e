"""The wgmma kernels' plans at the multi-stage backbone's full-resolution
convs, on the CPU: the MultiInputUNet at the thesis widths runs conv_0
(24 → 48, 48 → 48) and upcat_1 ((48 + 96 =) 144 → 24, 24 → 24) packed, at
B 8 × 64³. Every forward, dgrad and weight gradient among them takes a
wgmma plan: K1 at 144 → 24 on N 24 (its weights beside a 2-stage ring),
K1's dgrad 24 → 144 on two N tiles of 72, K2 at Cout 48 on two co tiles
of 32. Each N tile's and co tile's share of the work, laid out as the
kernels take it, adds up to the plain version (f64: only the order of sums
differs), and K2's tiles to the JAX package's ``_dw_impl`` (interpret).
The kernels are held to their plain versions on the card
(``test_torch_port_gpu.py``, ``chip_smoke.py`` phase 15)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from unet_bssfp_tpu.ops.pallas.conv3d import _dw_impl
from unet_bssfp_tpu_torch.ops import kernels as K
from unet_bssfp_tpu_torch.ops.kernels import conv_wgmma as W
from unet_bssfp_tpu_torch.ops.kernels import wgrad_wgmma as G

torch.set_num_threads(1)

# (Cin, Cout) of the four full-resolution convs; each one's forward, its
# dgrad (Cout → Cin) and its weight gradient, at B 8 × 64³
CONVS = [(24, 48), (48, 48), (144, 24), (24, 24)]
# (Cin, Cout) → (N, N tiles, rows, stages, shared memory) of K1's plan
FORWARD = {(24, 48): (64, 1, 2, 4, 176_808), (48, 48): (64, 1, 2, 4, 232_104),
           (144, 24): (24, 1, 2, 2, 232_360), (24, 24): (32, 1, 4, 4, 152_232),
           (48, 24): (32, 1, 4, 4, 179_880), (24, 144): (72, 2, 2, 4, 190_632)}


@pytest.mark.parametrize("cin,cout", CONVS + [(48, 24), (24, 144)])
def test_forward_and_dgrad_shapes_take_the_wgmma_kernel(cin, cout):
    """The forward convs, and as (Cout, Cin) their dgrads (48 → 24, 24 →
    144 are dgrad-only), at the plans the header states."""
    plan = W.wgmma_plan(8, 64, 64, 0, cin, cout, 64, 64)
    assert plan is not None
    assert (plan.n, plan.n_tiles, plan.rows, plan.stages, plan.smem) == FORWARD[(cin, cout)]
    assert plan.smem == W.smem_bytes(plan.rows, plan.stages, plan.weight_bytes) <= W.SMEM_LIMIT
    assert plan.grid == 8 * plan.segments * plan.tiles_w * plan.tiles_h * plan.n_tiles
    # the wrapper's route is this plan: no mma.sync loop
    xk = torch.empty(8, 64, cin, 4096, dtype=torch.bfloat16, device="meta")
    assert K.conv_plan(xk, cout, 64) == plan


def test_narrow_n_only_where_n32_does_not_fit():
    """N 24 is the fallback of Cout ≤ 24 alone: 96 → 24 keeps N 32 and 4
    rows (the GAN's dgrad), 144 → 24 takes N 24; 144 → 32 has no plan."""
    assert W.wgmma_plan(8, 64, 64, 0, 96, 24, 64, 64).n == 32
    assert W.wgmma_plan(8, 64, 64, 0, 144, 24, 64, 64).n == 24
    assert W.wgmma_plan(8, 64, 64, 0, 144, 32, 64, 64) is None
    assert W.wgmma_plan(8, 64, 64, 0, 144, 24, 64, 64, fold=True) is None


@pytest.mark.parametrize("grow", [0, -2, 2])
@pytest.mark.parametrize("b,d,h,w,cin,cout", [(2, 3, 4, 64, 5, 144), (1, 5, 3, 72, 3, 100),
                                              (1, 3, 5, 40, 4, 200)])
def test_n_tiles_cover_each_output_once(b, d, h, w, cin, cout, grow):
    plan = W.wgmma_plan(b, d, d + grow, -grow // 2, cin, cout, h, w)
    assert plan.n == W.TILE_N and plan.n_tiles == -(-cout // W.TILE_N)
    seen = np.zeros((plan.b, plan.dout, plan.cout, plan.h, plan.wdim), np.int32)
    for block in range(plan.grid):
        bb, ds, hs, ws = W.block_outputs(plan, block)
        cs = W.block_channels(plan, block)
        assert len(ds) and len(hs) and len(ws) and len(cs)
        seen[bb, ds.start:ds.stop, cs.start:cs.stop, hs.start:hs.stop, ws.start:ws.stop] += 1
    assert (seen == 1).all()


def _tile_weights(img: torch.Tensor, n: int, cin_pad: int, n_tiles: int) -> torch.Tensor:
    """The weight image read back as the kernel's blocks read it: tile nt's
    B operand for tap t and chunk c at ``(nt·27·cin_pad/16 + t·cin_pad/16 +
    c)·16·n``, element ``((ng·2 + kg)·8 + r)·8 + k8`` → (tiles, 27, cin_pad, n)."""
    out = torch.empty(n_tiles, 27, cin_pad, n, dtype=img.dtype)
    chunks = cin_pad // 16
    for nt, t, c in itertools.product(range(n_tiles), range(27), range(chunks)):
        base = ((nt * 27 + t) * chunks + c) * 16 * n
        blk = img[base:base + 16 * n].reshape(n // 8, 2, 8, 8)  # (ng, kg, r, k8)
        out[nt, t, 16 * c:16 * c + 16] = blk.permute(1, 3, 0, 2).reshape(16, n)
    return out


@pytest.mark.parametrize("cin,cout,n,n_tiles", [(24, 144, 72, 2), (144, 24, 24, 1),
                                                (5, 100, 72, 2)])
def test_tiles_of_the_weight_image_add_up_to_the_conv(cin, cout, n, n_tiles):
    """Each block's resident weights are its N tile's columns of w (zero
    past Cin and Cout), and the tiles' convs, each written to its channel
    range of one output, are the plain conv (f64)."""
    rng = np.random.default_rng(cin + cout)
    w = torch.from_numpy(rng.standard_normal((3, 3, 3, cin, cout))).double()
    cin_pad = -(-cin // 16) * 16
    img = W.weight_image(w, n, cin_pad, n_tiles)
    assert img.dtype == torch.bfloat16 and img.numel() == n_tiles * 27 * cin_pad * n
    tiles = _tile_weights(img, n, cin_pad, n_tiles).double()
    wb = F.pad(w.to(torch.bfloat16).double().reshape(27, cin, cout),
               (0, n * n_tiles - cout, 0, cin_pad - cin))
    for nt in range(n_tiles):
        assert torch.equal(tiles[nt], wb[:, :, nt * n:(nt + 1) * n])
    b, d, h, wd = 1, 3, 4, 16
    xk = torch.from_numpy(rng.standard_normal((b, d, cin, h * wd))).double()
    bias = torch.from_numpy(rng.standard_normal(cout)).double()
    y = torch.zeros(b, d, cout, h * wd, dtype=torch.float64)
    for nt in range(n_tiles):
        wt = tiles[nt][:, :cin].reshape(3, 3, 3, cin, n)
        cs = range(nt * n, min((nt + 1) * n, cout))
        part = K.conv3x3_packed_plain(xk, wt, F.pad(bias, (0, n * n_tiles - cout))[
            nt * n:(nt + 1) * n], wd)
        y[:, :, cs.start:cs.stop] = part[:, :, :len(cs)]
    ref = K.conv3x3_packed_plain(xk, w.to(torch.bfloat16).double(), bias, wd)
    torch.testing.assert_close(y, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("cin,cout", CONVS)
def test_weight_gradients_take_the_wgmma_kernel(cin, cout):
    """K2 at each conv: Cout 48 in two co tiles of 32, one wave of blocks
    over (chunks, splits, co tiles); the chain the header states."""
    plan = G.wgrad_plan(8, 64, 0, cin, cout, 64, 64)
    assert plan is not None and plan.co_tiles == -(-cout // G.COUT_MAX)
    assert (plan.stages, plan.smem) == (4, 222_272)
    assert plan.chunks == -(-cin // G.MAX_CPK)
    blocks = plan.chunks * plan.splits * plan.co_tiles
    assert G.SMS - plan.chunks * plan.co_tiles < blocks <= G.SMS
    assert plan.grid == (plan.chunks, plan.splits, plan.co_tiles)
    assert plan.chain == G.ROWS * G.TILE_W + plan.per + plan.splits
    x = torch.empty(8, 64, cin, 4096, dtype=torch.bfloat16, device="meta")
    dy = torch.empty(8, 64, cout, 4096, dtype=torch.bfloat16, device="meta")
    assert K.wgrad_plan(x, dy, 64) == plan
    assert K.conv3x3_wgrad_chain(x, dy, 64) == plan.chain


def test_co_tiles_cover_each_output_channel_once():
    for cout in (1, 32, 33, 48, 70, 96):
        plan = G.wgrad_plan(1, 2, 0, 5, cout, 4, 64)
        chans = [c for t in range(plan.co_tiles) for c in G.tile_channels(plan, t)]
        assert chans == list(range(cout))


@pytest.mark.parametrize("halo", [0, 1])
@pytest.mark.parametrize("cin,cout", [(24, 48), (5, 40), (3, 70)])
def test_co_tiles_gemm_view_is_the_plain_wgrad(cin, cout, halo):
    """Each co tile's rows-by-shifted-copies product (dy's box from channel
    32t, zero past Cout) is its channels of K2's function (f64)."""
    rng = np.random.default_rng(cin + cout + halo)
    b, d, h, w = 2, 3, 4, 16
    xk = torch.from_numpy(rng.standard_normal((b, d + 2 * halo, cin, h * w))).double()
    dy = torch.from_numpy(rng.standard_normal((b, d, cout, h * w))).double()
    got = G.wgrad_gemm_plain(xk, dy, w, halo)
    plain = K.conv3x3_wgrad_halo_plain if halo else K.conv3x3_wgrad_plain
    torch.testing.assert_close(got, plain(xk, dy, w), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("pad_d", [True, False])
def test_co_tiles_gemm_view_matches_jax_dw_impl(pad_d):
    """At Cout 48 against the TPU kernel ``_dw_impl`` in interpret mode, f32
    on the CPU (the tolerance of the port's other ``_dw_impl``
    comparisons)."""
    b, d, h, w, cin, cout = 2, 3, 8, 16, 24, 48
    rng = np.random.default_rng(48 + pad_d)
    xk = rng.standard_normal((b, d + int(not pad_d) * 2, cin, h * w)).astype(np.float32)
    dy = rng.standard_normal((b, d, cout, h * w)).astype(np.float32)
    ref = np.asarray(_dw_impl(jnp.asarray(xk), jnp.asarray(dy), w, interpret=True,
                              pad_d=pad_d))
    got = G.wgrad_gemm_plain(torch.from_numpy(xk), torch.from_numpy(dy), w, int(not pad_d))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
