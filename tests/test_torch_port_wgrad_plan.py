"""The wgmma weight-gradient kernel's launch plan and GEMM view
(``ops/kernels/wgrad_wgmma.py``) and the relayout's path choice
(``ops/kernels/layout.py``) on the CPU: which kernel each shape routes to,
the row chunks, pixel splits, ring and shared memory at every training and
mesh-backward shape, each output and each pixel owned exactly once, the
summation chain, and the GEMM view against K2's plain version and the JAX
package's ``_dw_impl`` (interpret mode). The kernels themselves are held to
their plain versions on the card (``test_torch_port_gpu.py``)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_bssfp_tpu.ops.pallas.conv3d import _dw_impl
from unet_bssfp_tpu_torch.ops import kernels as K
from unet_bssfp_tpu_torch.ops.kernels import layout as L
from unet_bssfp_tpu_torch.ops.kernels import wgrad_wgmma as G

torch.set_num_threads(1)

# The bf16 weight gradients of the training step (24/32/96 → 32 at 8 × 64³)
# and of the sharded block backward / mesh shards (halo form at B 8 ×
# D_local 32 × 64² and B 1 × D_local 48 × 128²): (B, D, halo, Cin, Cout, H, W)
MAIN = ([(8, 64, 0, cin, 32, 64, 64) for cin in (24, 32, 96)]
        + [(8, 32, 1, cin, 32, 64, 64) for cin in (24, 32, 96)]
        + [(1, 48, 1, cin, 32, 128, 128) for cin in (24, 32, 96)])


@pytest.mark.parametrize("shape", MAIN)
def test_every_training_and_mesh_shape_takes_the_wgmma_kernel(shape):
    plan = G.wgrad_plan(*shape)
    assert plan is not None
    assert plan.smem == G.smem_bytes(plan.stages) <= G.SMEM_LIMIT
    # the deepest ring that fits beside the 6 copy rows: 4 stages, 222,272 B
    assert (plan.stages, plan.smem) == (4, 222_272)
    # Cin 24/32/96 in 2/2/5 chunks of 12/16/20 channels (36/48/60 of 64 rows)
    assert (plan.chunks, plan.cpk) == {24: (2, 12), 32: (2, 16), 96: (5, 20)}[plan.cin]
    # one wave: one block per SM
    assert plan.chunks * plan.splits <= G.SMS
    assert plan.chunks * plan.splits > G.SMS - plan.chunks
    # each block walks the same number of items but the last split's
    assert (plan.splits - 1) * plan.per < plan.items <= plan.splits * plan.per


# Ragged shapes: Cin 3/5/40, Cout 4/6, W 8 and 40 (tiles overhanging w), H
# 3/5/7 (overhanging h), D 1 and 2, both d geometries.
RAGGED = [(2, 1, 0, 3, 4, 3, 8), (1, 2, 1, 5, 6, 5, 40), (3, 3, 0, 24, 32, 7, 128),
          (1, 1, 1, 40, 32, 3, 16), (2, 2, 0, 96, 8, 4, 72)]


@pytest.mark.parametrize("shape", RAGGED + MAIN[:1])
def test_splits_cover_each_pixel_once(shape):
    plan = G.wgrad_plan(*shape)
    assert plan is not None
    seen = np.zeros((plan.b, plan.d, plan.h, plan.wdim), np.int32)
    owners = set()
    for s in range(plan.splits):
        items = G.split_items(plan, s)
        assert len(items) >= 1
        for it in items:
            assert it not in owners
            owners.add(it)
            b, d, h0, w0 = G.item_tile(plan, it)
            seen[b, d, h0:h0 + G.ROWS, w0:w0 + G.TILE_W] += 1
            # the kernel reuses two copy rows exactly where the next item is
            # the next h tile of the same (b, d, w tile)
            if it + 1 < plan.items and (it + 1) % plan.tiles_h:
                assert G.item_tile(plan, it + 1) == (b, d, h0 + G.ROWS, w0)
    assert owners == set(range(plan.items))
    assert (seen == 1).all()


@pytest.mark.parametrize("cin", [3, 5, 24, 32, 40, 96])
def test_row_chunks_write_each_output_once(cin):
    """Each (tap, ci, co) of dW is written by one block per split: its
    (kd, ci) row lies in exactly one chunk, and the chunk's warpgroup kh
    writes every (kw, co) of it."""
    plan = G.wgrad_plan(2, 3, 0, cin, 32, 8, 64)
    rows = [r for q in range(plan.chunks) for r in G.chunk_rows(plan, q)]
    assert sorted(rows) == list(itertools.product(range(3), range(cin)))
    assert len(G.chunk_rows(plan, plan.chunks - 1)) >= 1


@pytest.mark.parametrize("shape,reason", [
    # folded (K7b) only: the packed layout takes Cout in tiles of 32
    ((1, 4, 0, 32, 40, 8, 64, G.SMS, True), "Cout > 32"),
    ((1, 4, 0, 32, 64, 8, 256, G.SMS, True), "Cout > 32"),
    ((1, 4, 0, 32, 32, 64, 66), "the wguard width W + 2"),
    ((1, 4, 1, 24, 32, 9, 35), "W % 8"),
    ((1, 4, 2, 24, 32, 8, 64), "no such d geometry")])
def test_shapes_the_wgmma_wgrad_does_not_take(shape, reason):
    assert G.wgrad_plan(*shape) is None, reason


def test_route_of_a_tensor_is_its_shape():
    """The wrappers' plan reads the halo from the two d counts; the meta
    device stands for tensors of the real sizes (no memory)."""
    x = torch.empty(8, 34, 96, 4096, dtype=torch.bfloat16, device="meta")
    dy = torch.empty(8, 32, 32, 4096, dtype=torch.bfloat16, device="meta")
    plan = K.wgrad_plan(x, dy, 64)
    assert (plan.halo, plan.d, plan.chunks, plan.splits) == (1, 32, 5, 26)
    assert K.wgrad_plan(x[:, :32], dy, 64).halo == 0
    wide = torch.empty(1, 3, 32, 8 * 66, dtype=torch.bfloat16, device="meta")
    assert K.wgrad_plan(wide, torch.empty(1, 3, 32, 8 * 66, device="meta"), 66) is None


@pytest.mark.parametrize("shape,chain", [(MAIN[0], 128 + 249 + 66), (MAIN[1], 128 + 249 + 66),
                                         (MAIN[2], 128 + 631 + 26), (MAIN[5], 128 + 316 + 26),
                                         (MAIN[8], 128 + 237 + 26)])
def test_chain_is_the_headers_chain(shape, chain):
    """One product passes through the item's accumulator (2 rows × 64
    pixels: 8 K-steps), the split's sum of items and the sum of splits; the
    wrappers' ``conv3x3_wgrad_chain`` reports it for bf16 operands the plan
    takes, with no card."""
    plan = G.wgrad_plan(*shape)
    assert plan.chain == G.ROWS * G.TILE_W + plan.per + plan.splits == chain
    b, d, halo, cin, cout, h, w = shape
    x = torch.empty(b, d + 2 * halo, cin, h * w, dtype=torch.bfloat16, device="meta")
    dy = torch.empty(b, d, cout, h * w, dtype=torch.bfloat16, device="meta")
    assert K.conv3x3_wgrad_chain(x, dy, w) == chain


def test_copy_tile_offsets_are_a_swizzled_bijection():
    """dy's shifted copies: every (slot, kw, co, pixel) element at its own
    2 bytes of the copy ring, each 16-byte chunk inside its 128-byte row, the
    chunk order of a row permuted by the row's index mod 8."""
    offs = {G.copy_offset(t, kw, co, k) for t, kw, co, k in itertools.product(
        range(G.SLOTS), range(3), range(G.COUT_MAX), range(G.TILE_W))}
    assert offs == set(range(0, G.COPY_BYTES, 2))
    # item i reads slots slot0 .. slot0+3; the next item's two new rows go to
    # slot0+4, slot0+5, which item i does not read
    for slot0 in range(G.SLOTS):
        reads = {(slot0 + t) % G.SLOTS for t in range(G.ROWS + 2)}
        writes = {(slot0 + G.ROWS + t) % G.SLOTS for t in range(2, G.ROWS + 2)}
        assert not reads & writes
    for n in range(8):
        kw, co = divmod(n, G.COUT_MAX)
        chunks = [(G.copy_offset(0, kw, co, 8 * c) - n * 128) // 16 for c in range(8)]
        assert chunks == [c ^ n for c in range(8)]


def _operands(rng, b, d, halo, cin, cout, h, w):
    xk = rng.standard_normal((b, d + 2 * halo, cin, h * w)).astype(np.float32)
    dy = rng.standard_normal((b, d, cout, h * w)).astype(np.float32)
    return xk, dy


GEMM_SHAPES = [(2, 3, 8, 16, 5, 4), (2, 3, 8, 16, 24, 32), (1, 2, 3, 24, 3, 6),
               (1, 1, 5, 8, 8, 32)]


@pytest.mark.parametrize("halo", [0, 1])
@pytest.mark.parametrize("b,d,h,w,cin,cout", GEMM_SHAPES)
def test_gemm_view_is_the_plain_wgrad(b, d, h, w, cin, cout, halo):
    """The kernel's rows-by-shifted-copies product is K2's function: equal
    to autograd's weight gradient (f64, so only the order of sums differs)."""
    rng = np.random.default_rng(b + d + h + cin + cout + halo)
    xk, dy = (torch.from_numpy(a).double() for a in _operands(rng, b, d, halo, cin, cout, h, w))
    got = G.wgrad_gemm_plain(xk, dy, w, halo)
    plain = K.conv3x3_wgrad_halo_plain if halo else K.conv3x3_wgrad_plain
    assert got.shape == (3, 3, 3, cin, cout)
    torch.testing.assert_close(got, plain(xk, dy, w), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("pad_d", [True, False])
@pytest.mark.parametrize("cin,cout", [(5, 4), (24, 32)])
def test_gemm_view_matches_jax_dw_impl(cin, cout, pad_d):
    """Against the TPU kernel ``_dw_impl`` in interpret mode, f32 on the
    CPU, B 2 × D 3 × 8 × 16: the same f32 sum in another order (the
    tolerance of the port's other ``_dw_impl`` comparisons)."""
    b, d, h, w = 2, 3, 8, 16
    rng = np.random.default_rng(cin * cout + pad_d)
    xk, dy = _operands(rng, b, d, int(not pad_d), cin, cout, h, w)
    ref = np.asarray(_dw_impl(jnp.asarray(xk), jnp.asarray(dy), w, interpret=True,
                              pad_d=pad_d))
    got = G.wgrad_gemm_plain(torch.from_numpy(xk), torch.from_numpy(dy), w, int(not pad_d))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("halo", [0, 1])
def test_wgrad_mma_entry_point_on_cpu_is_the_plain_wgrad(halo):
    rng = np.random.default_rng(11 + halo)
    xk, dy = (torch.from_numpy(a).bfloat16() for a in _operands(rng, 1, 3, halo, 5, 6, 4, 32))
    plain = K.conv3x3_wgrad_halo_plain if halo else K.conv3x3_wgrad_plain
    got = K.conv3x3_wgrad_mma(xk, dy, 32, halo)
    assert got.dtype == torch.float32 and got.shape == (3, 3, 3, 5, 6)
    torch.testing.assert_close(got, plain(xk, dy, 32))
    with pytest.raises(TypeError):
        K.conv3x3_wgrad_mma(xk.float(), dy.float(), 32, halo)


@pytest.mark.parametrize("r,c,itemsize,path", [
    (4096, 6, 2, L.PATH_NARROW_C),     # pack_hw of the 6-channel gradient (K3a)
    (6, 4096, 2, L.PATH_NARROW_R),     # unpack_hw of the generator's output (K3b)
    (6, 4096, 4, L.PATH_NARROW_R),
    (4096, 16, 4, L.PATH_NARROW_C),
    (16, 4096, 2, L.PATH_NARROW_R),
    (4096, 24, 2, L.PATH_TILES),       # head → conv_0: 24 channels keep the tiles
    (4096, 64, 2, L.PATH_TILES),
    (17, 4096, 2, L.PATH_TILES),
    (95, 6, 2, L.PATH_TILES),          # pixels not a whole number of 16-byte vectors
    (6, 98, 4, L.PATH_TILES)])
def test_transpose_path_of_a_shape(r, c, itemsize, path):
    assert L.transpose_path(r, c, itemsize) == path
    assert L.transpose_path(r, c, itemsize, aligned=False) == L.PATH_TILES


@pytest.mark.parametrize("s,r,c,itemsize", [(3, 6, 64, 2), (2, 40, 3, 4), (4, 1, 16, 2),
                                            (1, 64, 16, 4)])
def test_narrow_path_moves_each_element_once(s, r, c, itemsize):
    """Each thread group moves 16 bytes of pixels of every channel: over the
    groups every (slice, channel, pixel) element is read and written once."""
    path = L.transpose_path(r, c, itemsize)
    assert path != L.PATH_TILES
    v = 16 // itemsize
    nc, pixels = (c, r) if path == L.PATH_NARROW_C else (r, c)
    seen = np.zeros((s, nc, pixels), np.int32)
    for sl, p in L.narrow_groups(s, r, c, itemsize, path):
        seen[sl, :, p:p + v] += 1
    assert (seen == 1).all()
