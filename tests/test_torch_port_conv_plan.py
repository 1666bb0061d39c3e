"""The launch plan of the wgmma conv kernel (``ops/kernels/conv_wgmma.py``)
on the CPU: which kernel each shape routes to, the tile, ring depth and
shared memory at every stage shape, each output voxel written by exactly one
block, and the weight's pre-layout. The kernel itself is held to its plain
version on the card (``test_torch_port_gpu.py``)."""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from unet_bssfp_tpu_torch.ops import kernels as K
from unet_bssfp_tpu_torch.ops.kernels import conv_wgmma as W

# The bf16 convs of the serving, training and mesh paths: (B, Din, grow,
# Cin, Cout, H, wdim). Forward 24/32/96 → 32 and the dgrads 32 → 24/32/96 at
# 8 × 64³; the whole volume; K5 and its dgrad at the shards of meshes (1, 2)
# and (2, 2).
MAIN = [(8, 64, 0, 24, 32, 64, 64), (8, 64, 0, 32, 32, 64, 64), (8, 64, 0, 96, 32, 64, 64),
        (8, 64, 0, 32, 24, 64, 64), (8, 64, 0, 32, 96, 64, 64),
        (1, 96, 0, 24, 32, 128, 128), (1, 96, 0, 96, 32, 128, 128),
        (1, 50, -2, 96, 32, 128, 128), (4, 34, -2, 24, 32, 64, 64),
        (8, 34, -2, 96, 32, 64, 64), (8, 32, 2, 32, 96, 64, 64), (1, 48, 2, 32, 24, 128, 128)]


def _plan(b, din, grow, cin, cout, h, wdim, wguard=0):
    return W.wgmma_plan(b, din, din + grow, -grow // 2, cin, cout, h, wdim, wguard)


@pytest.mark.parametrize("shape", MAIN)
def test_every_main_path_shape_takes_the_wgmma_kernel(shape):
    plan = _plan(*shape)
    assert plan is not None
    assert plan.smem <= W.SMEM_LIMIT
    assert plan.smem == W.smem_bytes(plan.rows, plan.stages, plan.weight_bytes)
    assert plan.n in W.N_PADS and plan.n >= plan.cout and plan.n - plan.cout < 32
    assert plan.cin_pad % W.CK == 0 and 0 <= plan.cin_pad - plan.cin < W.CK
    # four rows only at N 32 (the registers of three rolling slices); a
    # ring of two stages or more
    assert plan.rows == (4 if plan.n == 32 else 2) and plan.stages >= 2
    # the 166 KB weight of 96 → 32 leaves room for 2 stages of 4 rows; that
    # of 32 → 96 (N 96: 2 rows) for 4
    if plan.cin == 96:
        assert (plan.rows, plan.stages, plan.smem) == (4, 2, 232_104)
    else:
        assert plan.stages == 4


# Ragged shapes: W 8 and 40, wdim 66 and 16 with guards (the flattened-lanes
# map), H 3, D 1, the D → D+2 geometry, Cin 3/5/24, Cout 6/24/96.
RAGGED = [(2, 3, 0, 3, 6, 3, 8, 0), (1, 1, 0, 5, 24, 3, 8, 0), (1, 1, 2, 24, 96, 3, 8, 0),
          (2, 4, -2, 5, 6, 5, 40, 0), (1, 3, 0, 32, 32, 4, 66, 2), (2, 2, 2, 24, 32, 8, 16, 2),
          (1, 5, 0, 96, 32, 7, 128, 0), (3, 9, -2, 24, 96, 9, 72, 0)]


@pytest.mark.parametrize("shape", RAGGED)
def test_blocks_cover_each_output_voxel_once(shape):
    plan = _plan(*shape)
    assert plan is not None
    seen = np.zeros((plan.b, plan.dout, plan.h, plan.wdim), np.int32)
    for block in range(plan.grid):
        b, ds, hs, ws = W.block_outputs(plan, block)
        assert len(ds) and len(hs) and len(ws)
        seen[b, ds.start:ds.stop, hs.start:hs.stop, ws.start:ws.stop] += 1
    assert (seen == 1).all()
    assert plan.lanes_map == (plan.wdim % 8 != 0)


def test_d_segments_follow_the_wave_count():
    # 128 columns fill one wave of 132 SMs: no split; the whole volume's 64
    # columns of 4 rows split in two; a tiny call splits d down to slices
    assert _plan(8, 64, 0, 24, 32, 64, 64).segments == 1
    assert _plan(1, 96, 0, 24, 32, 128, 128).segments == 2
    tiny = _plan(1, 6, 0, 8, 8, 4, 64)
    assert (tiny.segments, tiny.seg_len, tiny.grid) == (6, 1, 6)


@pytest.mark.parametrize("shape,reason", [
    # Cout > 96 is cut into N tiles; at Cin 144 one tile's weights (N 72:
    # 27·144·72·2 bytes) do not fit
    ((1, 4, 0, 144, 144, 8, 64, 0), "Cout > 96"),
    ((1, 4, 0, 24, 32, 8, 12, 0), "W % 8 without guards"),
    ((1, 4, 0, 24, 32, 4, 36, 0), "W % 8 without guards"),
    ((1, 4, 0, 128, 96, 8, 64, 0), "weight too large"),
    ((1, 4, 0, 128, 32, 8, 64, 0), "weight too large")])
def test_shapes_the_wgmma_kernel_does_not_take(shape, reason):
    assert _plan(*shape) is None, reason


def test_route_of_a_tensor_is_its_shape():
    xk = torch.zeros(2, 4, 24, 8 * 12, dtype=torch.bfloat16)
    assert K.conv_plan(xk, 32, 12) is None
    assert K.conv_plan(xk, 32, 12, wguard=2).lanes_map
    plan = K.conv_plan(torch.zeros(2, 4, 24, 8 * 64), 96, 64, grow=2)
    assert (plan.din, plan.dout, plan.shift, plan.n) == (4, 6, -1, 96)


@pytest.mark.parametrize("cin,cout", [(3, 6), (24, 32), (32, 96)])
def test_weight_image_is_the_weight_under_its_index_map(cin, cout):
    rng = np.random.default_rng(cin + cout)
    w = torch.from_numpy(rng.standard_normal((3, 3, 3, cin, cout)).astype(np.float32))
    n = next(p for p in W.N_PADS if p >= cout)
    cin_pad = -(-cin // 16) * 16
    img = W.weight_image(w, n, cin_pad)
    assert img.dtype == torch.bfloat16 and img.numel() == 27 * cin_pad * n
    wb = w.to(torch.bfloat16).reshape(27, cin, cout)
    chunks = cin_pad // 16
    for t, c, ng, kg, r, k8 in itertools.product(range(27), range(chunks), range(n // 8),
                                                 range(2), range(8), range(8)):
        ci, co = 16 * c + 8 * kg + k8, 8 * ng + r
        got = img[(t * chunks + c) * 16 * n + ((ng * 2 + kg) * 8 + r) * 8 + k8]
        want = wb[t, ci, co] if ci < cin and co < cout else 0.0
        if t % 9 == 4 or (t, c) == (0, 0):  # a sample of taps keeps this quick
            assert float(got) == float(want)


@pytest.mark.parametrize("grow", [0, -2, 2])
def test_mma_entry_point_on_cpu_is_the_plain_conv(grow):
    rng = np.random.default_rng(7)
    xk = torch.from_numpy(rng.standard_normal((1, 4, 5, 4 * 32)).astype(np.float32))
    wt = torch.from_numpy(rng.standard_normal((3, 3, 3, 5, 6)).astype(np.float32)) * 0.2
    bias = torch.zeros(6)
    got = K.conv3x3_packed_mma(xk.bfloat16(), wt, bias, 32, grow)
    assert got.shape == (1, 4 + grow, 6, 128) and got.dtype == torch.bfloat16
    if grow == 0:
        torch.testing.assert_close(got, K.conv3x3_packed_plain(xk.bfloat16(), wt, bias, 32))
    if grow == -2:
        torch.testing.assert_close(got, K.conv3x3_packed_halo_plain(xk.bfloat16(), wt, bias, 32))
    with pytest.raises(TypeError):
        K.conv3x3_packed_mma(xk, wt, bias, 32, grow)


# Guarded shapes (B, Din, grow, Cin, Cout, H, wdim, wguard): the GAN step's
# convs and dgrads at row width 66 (N 32 on 4 rows, N 64, N 96), the
# multi-stage ones (N 24 at 144 → 24, two N-72 tiles at the dgrad 24 → 144),
# the whole volume at 130, both halo geometries, and ragged ones: wdim 68
# (a second tile of 2 data columns, H 6 past the last 4-row tile), 16, 72 and
# 136 (the rows map: wdim % 8 == 0), 70 and 136 with 8 guards (the most a
# plan takes).
GUARDED = [(8, 64, 0, 96, 32, 64, 66, 2), (8, 64, 0, 32, 96, 64, 66, 2),
           (8, 64, 0, 32, 64, 64, 66, 2), (8, 64, 0, 144, 24, 64, 66, 2),
           (8, 64, 0, 24, 144, 64, 66, 2), (1, 96, 0, 96, 32, 128, 130, 2),
           (1, 96, 0, 32, 96, 128, 130, 2), (2, 3, 2, 24, 32, 4, 66, 2),
           (1, 5, -2, 32, 32, 8, 130, 2), (1, 3, 2, 24, 144, 4, 66, 2),
           (2, 3, 0, 32, 32, 6, 68, 2), (1, 2, 0, 24, 96, 6, 68, 2),
           (2, 2, 2, 5, 6, 8, 16, 2), (1, 2, 0, 32, 32, 4, 72, 8), (1, 2, 0, 16, 32, 4, 70, 8),
           (1, 1, 0, 16, 32, 4, 136, 8)]


@pytest.mark.parametrize("shape", GUARDED)
def test_guarded_plans_tile_the_data_columns_only(shape):
    plan = _plan(*shape)
    assert plan is not None
    assert plan.tiles_w == -(-(plan.wdim - plan.wguard) // W.TILE_W)
    assert plan.grid == plan.b * plan.segments * plan.tiles_w * plan.tiles_h * plan.n_tiles
    assert plan.lanes_map == (plan.wdim % 8 != 0)
    if plan.wdim in (66, 130):
        # K1's plan at the data width, but for the width itself: the same
        # grid, tile, ring and d segments
        b, din, grow, cin, cout, h, wd, g = shape
        assert dataclasses.replace(plan, wdim=wd - g, wguard=0, lanes_map=False) == \
            _plan(b, din, grow, cin, cout, h, wd - g)
        assert plan.tiles_w == (1 if wd == 66 else 2)


def test_guarded_plans_refuse_what_the_guarded_epilogue_does_not_stage():
    # more guards than guard_cols gives; an odd row width; at 2 rows (N 96)
    # a one-tile row of 72 columns: neither the block's span (16 channels ×
    # 152 lanes) nor the row (16 × 80) fits the staging; at 4 rows (N 32,
    # 8 channels a pass) it does
    assert _plan(1, 1, 0, 16, 32, 4, 74, 10) is None
    assert _plan(1, 2, 0, 16, 32, 8, 67, 3) is None
    assert _plan(8, 4, 0, 32, 96, 8, 72, 8) is None
    assert _plan(1, 1, 0, 16, 32, 4, 72, 8) is not None
    assert not W.guard_staging_fits(2, 72, 8) and W.guard_staging_fits(4, 72, 8)
    assert W.guard_staging_fits(2, 66, 2) and W.guard_staging_fits(2, 130, 2)


@pytest.mark.parametrize("shape", GUARDED)
def test_guarded_blocks_cover_data_and_guards_once(shape):
    """Every data voxel and every guard voxel of every channel is written by
    exactly one block, the guard voxels by the block of their row's last
    data tile; no block has no data column."""
    plan = _plan(*shape)
    seen = np.zeros((plan.n_tiles, plan.b, plan.dout, plan.h, plan.wdim), np.int32)
    guards = np.zeros_like(seen)
    for block in range(plan.grid):
        b, ds, hs, ws = W.block_outputs(plan, block)
        gs = W.block_guards(plan, block)
        nt = block % plan.n_tiles
        assert ws.start < plan.wdim - plan.wguard and len(W.block_channels(plan, block))
        assert gs.stop == ws.stop and (not len(gs) or gs.stop == plan.wdim)
        seen[nt, b, ds.start:ds.stop, hs.start:hs.stop, ws.start:ws.stop] += 1
        guards[nt, b, ds.start:ds.stop, hs.start:hs.stop, gs.start:gs.stop] += 1
    assert (seen == 1).all()
    assert (guards[..., plan.wdim - plan.wguard:] == 1).all()
    assert (guards[..., :plan.wdim - plan.wguard] == 0).all()


@pytest.mark.parametrize("shape", GUARDED)
def test_guarded_epilogue_stores_are_aligned_and_write_each_lane_once(shape):
    """The guarded epilogue's stores (a Python statement of
    store_slice_guarded's addresses) in one (d, channel) plane: each aligned
    to its width (a channel plane starts 16-byte aligned); together the
    blocks of one (b, d segment, N tile) write each lane of the plane once;
    a 16-byte store's unit holds no other store; each span has at most two
    partial units. Where a block's span starts on a 16-byte boundary and
    fills whole units (N 32, 4 rows at width 66: 528 B a block), no two
    blocks write the same 16-byte unit; elsewhere (2 rows at width 66: 264 B
    from a multiple of 8 bytes; rows of 130) a span's end lies inside a
    unit, whose other part belongs to the neighbouring block."""
    plan = _plan(*shape)
    lanes = plan.h * plan.wdim
    assert lanes % 8 == 0  # the plane's 16-byte alignment
    count, owners = {}, {}
    for block in range(plan.grid):
        b, ds, _, _ = W.block_outputs(plan, block)
        key = (b, ds.start, block % plan.n_tiles)
        hits = count.setdefault(key, np.zeros(lanes, np.int32))
        units = owners.setdefault(key, {})
        partial = 0
        for lane, size in W.guarded_stores(plan, block):
            assert size in (1, 2, 4, 8) and lane % size == 0
            hits[lane:lane + size] += 1
            units.setdefault(lane // 8, []).append((block, size))
            partial += size < 8
        assert partial <= 2 * 3 * plan.rows  # ≤ 2 partial units a span, ≤ 3 stores a unit
    for key, hits in count.items():
        assert (hits == 1).all(), key
        for unit, stores in owners[key].items():
            assert all(size < 8 for _, size in stores) or len(stores) == 1
            if (plan.n, plan.rows, plan.wdim) == (32, 4, 66):
                assert len({blk for blk, _ in stores}) == 1


def test_guarded_epilogue_merges_whole_rows_where_the_block_owns_them():
    # width 66: the block's rows are one span, 4 × 66 lanes at N 32 (33
    # whole units), 2 × 66 at N 96 (16 whole units and half of one);
    # width 130: a span a row and tile
    n32 = _plan(8, 64, 0, 96, 32, 64, 66, 2)
    assert W.guarded_stores(n32, 0) == [(8 * u, 8) for u in range(33)]
    n96 = _plan(8, 64, 0, 32, 96, 64, 66, 2)
    assert W.guarded_stores(n96, 0) == [(8 * u, 8) for u in range(16)] + [(128, 4)]
    assert W.guarded_stores(n96, 1) == [(132, 4)] + [(136 + 8 * u, 8) for u in range(16)]
    whole = _plan(1, 96, 0, 96, 32, 128, 130, 2)
    spans = [W.guarded_stores(whole, blk) for blk in range(whole.tiles_h * whole.tiles_w)]
    assert sum(size for s in spans for _, size in s) == 128 * 130
    # the second tile of row 0: pixels 64 .. 129 (62 data, 2 guards)
    second = W.guarded_stores(whole, whole.tiles_h)
    assert second[0] == (64, 8) and sum(size for lane, size in second if lane < 130) == 66
