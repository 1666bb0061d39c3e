"""K7a and K7b on the wgmma kernels: the fold plans and index maps
(``ops/kernels/conv_wgmma.py``, ``ops/kernels/wgrad_wgmma.py``) on the CPU.

Which folded shapes the two wgmma kernels take (every case of the pfold
probe, in every d geometry; none of the odd shapes), that K7a's plan is K1's
at the unfolded shape, that the tensor maps the plans describe are legal
TMA maps, and the kernels' folded index maps written out in Python, each
element covered once: K7a's stage loads and transpose give K1's transposed
tile, its epilogue stores give the folded output, and K7b's item loads (x
in one 32-byte-swizzled plane per phase) and dy copy build, contracted as
the kernel contracts them, give the plain weight gradient. The folded operands come from the JAX
package's ``fold4_pack`` on seeded NDHWC arrays. The kernels themselves are
held to their plain versions on the card (``test_torch_port_gpu.py``)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_bssfp_tpu.ops.pallas import conv3d as jc3
from unet_bssfp_tpu_torch.ops import kernels as K
from unet_bssfp_tpu_torch.ops.kernels import conv_wgmma as C
from unet_bssfp_tpu_torch.ops.kernels import wgrad_wgmma as G
from unet_bssfp_tpu_torch.ops.kernels.pfold import _to_folded, _to_packed

torch.set_num_threads(1)

# The pfold probe's cases (scripts/torch_port_pfold_probe.py), B 8:
# (D, H = W, Cin, Cout, halo)
PROBE = [(64, 64, 24, 32, False), (64, 64, 32, 32, False), (64, 64, 96, 32, False),
         (96, 128, 24, 32, False), (32, 64, 96, 32, True)]
# chip_smoke.py's PFOLD_ODD: (B, D, H, W, Cin, Cout), W/4 2, 3 and 9
PFOLD_ODD = [(2, 3, 3, 8, 3, 4), (1, 4, 7, 12, 5, 36), (1, 2, 3, 36, 24, 32)]


def _conv_geometries(d, cin, cout, halo):
    """(din, dout, shift, Cin, Cout) of the forward and the dgrad."""
    if halo:
        return [(d + 2, d, 1, cin, cout), (d, d + 2, -1, cout, cin)]
    return [(d, d, 0, cin, cout), (d, d, 0, cout, cin)]


@pytest.mark.parametrize("case", PROBE)
def test_probe_cases_take_k1s_plan_folded(case):
    d, hw, cin, cout, halo = case
    for din, dout, shift, ci, co in _conv_geometries(d, cin, cout, halo):
        plan = C.wgmma_plan(8, din, dout, shift, ci, co, hw, hw, fold=True)
        packed = C.wgmma_plan(8, din, dout, shift, ci, co, hw, hw)
        assert plan is not None and plan.fold and not plan.lanes_map
        # K1's plan at the unfolded shape: its tile, ring, segments, smem
        assert plan == C.WgmmaPlan(**{**vars(packed), "fold": True})
        assert plan.smem <= C.SMEM_LIMIT


@pytest.mark.parametrize("case", PROBE)
def test_probe_cases_take_the_wgmma_wgrad_folded(case):
    d, hw, cin, cout, halo = case
    plan = G.wgrad_plan(8, d, int(halo), cin, cout, hw, hw, fold=True)
    packed = G.wgrad_plan(8, d, int(halo), cin, cout, hw, hw)
    assert plan is not None and plan.fold
    assert plan == G.WgradPlan(**{**vars(packed), "fold": True})
    # K7b's chain is its plan's, read from the operands' shapes alone
    xf = torch.empty(1, dtype=torch.bfloat16).expand(8, d + 2 * halo, 4 * cin, hw * hw // 4)
    dyf = torch.empty(1, dtype=torch.bfloat16).expand(8, d, 4 * cout, hw * hw // 4)
    assert K.conv3x3_pfold_wgrad_chain(xf, dyf, hw // 4) == plan.chain
    assert plan.chain == G.ROWS * G.TILE_W + plan.per + plan.splits


@pytest.mark.parametrize("shape", PFOLD_ODD)
def test_odd_shapes_run_the_mma_loops(shape):
    b, d, h, w, cin, cout = shape
    for halo in (False, True):
        for din, dout, shift, ci, co in _conv_geometries(d, cin, cout, halo):
            assert C.wgmma_plan(b, din, dout, shift, ci, co, h, w, fold=True) is None
        assert G.wgrad_plan(b, d, int(halo), cin, cout, h, w, fold=True) is None
    xf = torch.empty(b, d, 4 * cin, h * w // 4, dtype=torch.bfloat16)
    dyf = torch.empty(b, d, 4 * cout, h * w // 4, dtype=torch.bfloat16)
    assert K.conv_plan(xf, cout, w // 4, fold=True) is None
    assert K.wgrad_plan(xf, dyf, w // 4, fold=True) is None


def test_fold_gates():
    """W/4 % 8 for the conv (W 32 and 96 taken), W/4 % 16 for the wgrad (W 32
    and 96 not), no guard columns."""
    assert C.wgmma_plan(1, 3, 3, 0, 8, 8, 4, 32, fold=True) is not None
    assert C.wgmma_plan(1, 3, 3, 0, 8, 8, 4, 96, fold=True) is not None
    assert C.wgmma_plan(1, 3, 3, 0, 8, 8, 4, 40, fold=True) is None
    assert C.wgmma_plan(1, 3, 3, 0, 8, 8, 4, 64, wguard=2, fold=True) is None
    for w in (32, 96, 40):
        assert G.wgrad_plan(1, 3, 0, 8, 8, 4, w, fold=True) is None
    assert G.wgrad_plan(1, 3, 0, 8, 8, 4, 128, fold=True) is not None
    assert G.wgrad_plan(1, 3, 0, 8, 40, 4, 128, fold=True) is None  # Cout > 32


def _legal(tmap):
    """TMA's rules for a tiled map: at most 5 dims, strides multiples of 16
    bytes, a box of at most 256 per dim whose inner extent is a multiple of
    16 bytes; a swizzled box's inner extent is the swizzle's span, the one
    case in which TMA lays it down in wgmma's canonical layout (a 32-byte
    extent under the 128-byte swizzle does not: measured on the card)."""
    assert tmap.swizzle in (0, 32, 64, 128)
    assert not tmap.swizzle or 2 * tmap.box[0] == tmap.swizzle
    assert len(tmap.dims) <= 5 and len(tmap.box) == len(tmap.dims)
    assert len(tmap.strides) == len(tmap.dims) - 1
    assert all(s % 16 == 0 and s < 2 ** 40 for s in tmap.strides)
    assert all(1 <= b <= 256 for b in tmap.box) and (2 * tmap.box[0]) % 16 == 0
    assert all(1 <= d < 2 ** 32 for d in tmap.dims)


def _box_bytes(tmap):
    return 2 * math.prod(tmap.box)


@pytest.mark.parametrize("case", PROBE)
def test_fold_maps_are_legal_tma_maps(case):
    d, hw, cin, cout, halo = case
    for din, dout, shift, ci, co in _conv_geometries(d, cin, cout, halo):
        plan = C.wgmma_plan(8, din, dout, shift, ci, co, hw, hw, fold=True)
        maps = C.fold_maps(plan)
        for m in maps.values():
            _legal(m)
        # a stage's three loads fill exactly the packed stage's bytes
        loads = C.fold_stage_loads(plan, 7, din - 1, plan.cin_pad // C.CK - 1,
                                   plan.rows * (plan.tiles_h - 1), C.TILE_W * (plan.tiles_w - 1))
        assert sum(_box_bytes(maps[m]) for m, _, _ in loads) == plan.stage_bytes
        for m, start, at in loads:
            assert start[0] % 8 == 0 and at % 128 == 0  # 16-byte starts, aligned rows
    plan = G.wgrad_plan(8, d, int(halo), cin, cout, hw, hw, fold=True)
    maps = G.fold_maps(plan)
    for m in maps.values():
        _legal(m)
    for it in (0, 1, plan.items - 1):
        loads = G.fold_item_loads(plan, it, plan.chunks - 1, follows=False)
        x_bytes = sum(_box_bytes(maps[m]) for m, _, _ in loads if m == "x")
        assert x_bytes == G.ROWS * 3 * plan.cpk * 128  # the packed item's x bytes
        assert sum(_box_bytes(maps[m]) for m, _, _ in loads if m != "x") == G.DY_BYTES
        for m, start, at in loads:
            assert start[0] % 8 == 0 and at % 128 == 0


def _tma(flat, tmap, start):
    """One TMA load in plain PyTorch: the box at ``start`` of the tensor
    ``flat`` (elements) viewed through ``tmap``, out-of-range elements zero,
    flattened in shared-memory order (innermost dim fastest)."""
    rank = len(tmap.dims)
    strides = (1,) + tuple(s // 2 for s in tmap.strides)
    offset = torch.zeros((1,) * rank, dtype=torch.long)
    inside = torch.ones((1,) * rank, dtype=torch.bool)
    for k in range(rank):
        shape = [1] * rank
        shape[rank - 1 - k] = tmap.box[k]
        idx = torch.arange(start[k], start[k] + tmap.box[k]).reshape(shape)
        inside = inside & (idx >= 0) & (idx < tmap.dims[k])
        offset = offset + idx.clamp(0, tmap.dims[k] - 1) * strides[k]
    return torch.where(inside, flat[offset], torch.zeros((), dtype=flat.dtype)).reshape(-1)


def _folded(shape_ndhwc, seed):
    """A seeded NDHWC array folded by the JAX package's fold4_pack, f64."""
    x = np.random.default_rng(seed).standard_normal(shape_ndhwc).astype(np.float32)
    return torch.from_numpy(np.array(jc3.fold4_pack(jnp.asarray(x)))).double()


# Small folded convs: (B, Din, H, W, Cin, Cout); W 64 (one tile), 128 (two
# tiles, so a tile's left and right boxes read real neighbours), 96 (the last
# tile half past the row), H 5 and 3 (a block overhanging h), Cin 24 (a
# 16-channel tail) and 5.
STAGE_SHAPES = [(2, 3, 5, 64, 24, 32), (1, 2, 3, 128, 5, 64), (1, 2, 4, 96, 16, 96)]


@pytest.mark.parametrize("shape", STAGE_SHAPES)
def test_k7a_stage_and_transpose_give_k1s_tile(shape):
    """Every ring stage of every block, loaded by the folded maps and
    transposed by the folded row addresses, is the packed kernel's
    transposed tile at the pixels the products read (w0 - 1 .. w0 + 64), and
    each transposed element is written once."""
    b, din, h, w, cin, cout = shape
    plan = C.wgmma_plan(b, din, din, 0, cin, cout, h, w, fold=True)
    assert plan is not None
    xf = _folded((b, din, h, w, cin), sum(shape))
    xk = _to_packed(xf, w // 4)  # (B, D, Cin, H·W)
    flat = xf.reshape(-1)
    maps = C.fold_maps(plan)
    rows = plan.rows
    # the transpose as index arrays: stored row k of block q holds element k
    # of the row lane i reads, at (rr, px of lane k, channel 8·half + i)
    moves = []
    for q in range((rows + 2) * 2 * (C.PX // 8)):
        lanes = [C.fold_xpose_row(rows, q, i) for i in range(8)]
        moves += [(rr, px, 8 * half + i, src // 2 + k)
                  for i, (src, rr, half, _) in enumerate(lanes)
                  for k, (_, _, _, px) in enumerate(lanes)]
    rr_i, px_i, ch_i, src_i = (torch.tensor(v) for v in zip(*moves))
    writes = torch.zeros((rows + 2, C.PX, C.CK), dtype=torch.int32)
    writes.index_put_((rr_i, px_i, ch_i), torch.ones(len(moves), dtype=torch.int32),
                      accumulate=True)
    assert (writes == 1).all()
    read = slice(7, 7 + C.TILE_W + 2)  # skew 7, kw 0..2, m 0..63
    hh_of = torch.arange(rows + 2).reshape(-1, 1)
    px_of = torch.arange(C.PX).reshape(1, -1)
    for blk in range(plan.grid):
        bb, _, hs, ws = C.block_outputs(plan, blk)
        h0, w0 = hs.start, ws.start
        hh, ww = h0 - 1 + hh_of, w0 - 8 + px_of
        inside = (hh >= 0) & (hh < h) & (ww >= 0) & (ww < w)
        lane = (hh.clamp(0, h - 1) * w + ww.clamp(0, w - 1))
        for j in range(din):
            for c in range(plan.cin_pad // C.CK):
                stage = torch.full((plan.stage_bytes // 2,), float("nan"), dtype=torch.float64)
                for m, start, at in C.fold_stage_loads(plan, bb, j, c, h0, w0):
                    box = _tma(flat, maps[m], start)
                    stage[at // 2:at // 2 + box.numel()] = box
                tile = torch.full((rows + 2, C.PX, C.CK), float("nan"), dtype=torch.float64)
                tile[rr_i, px_i, ch_i] = stage[src_i]
                # K1's tile: pixel w0 - 8 + px of h row h0 - 1 + rr, zero outside
                ref = torch.zeros((rows + 2, C.PX, C.CK), dtype=torch.float64)
                chans = range(c * C.CK, min(cin, (c + 1) * C.CK))
                for n, ch in enumerate(chans):
                    ref[..., n] = torch.where(inside, xk[bb, j, ch][lane], 0.0)
                assert torch.equal(tile[:, read], ref[:, read])


@pytest.mark.parametrize("shape", STAGE_SHAPES)
def test_k7a_epilogue_stores_the_folded_output(shape):
    """The folded epilogue's 16-byte stores (8 w4 of one phase and channel,
    read from the staging row at stride 4), over every block, row and
    channel, write each element of the folded output once: the packed
    output, folded."""
    b, din, h, w, cin, cout = shape
    plan = C.wgmma_plan(b, din, din, 0, cin, cout, h, w, fold=True)
    y = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (b, din, cout, h * w))).double()
    out = torch.full((b, din, 4 * cout, h * w // 4), float("nan"), dtype=torch.float64)
    writes = torch.zeros(out.shape, dtype=torch.int32)
    w4dim = w // 4
    for blk in range(plan.grid):
        bb, ds, hs, ws = C.block_outputs(plan, blk)
        w0 = ws.start
        for d in ds:
            for hh in hs:
                row = torch.zeros((cout, C.TILE_W), dtype=torch.float64)  # the staging row
                n = min(C.TILE_W, w - w0)
                row[:, :n] = y[bb, d, :, hh * w + w0:hh * w + w0 + n]
                for seg in range(8):
                    for k in range(8):
                        px, ph, off = C.fold_store(seg, k)
                        if w0 // 4 + 8 * (seg & 1) >= w4dim:  # the kernel's bound
                            continue
                        lane = hh * w4dim + w0 // 4 + off
                        out[bb, d, ph * cout:(ph + 1) * cout, lane] = row[:, px]
                        writes[bb, d, ph * cout:(ph + 1) * cout, lane] += 1
    assert (writes == 1).all()
    assert torch.equal(out, _to_folded(y, w))


@pytest.mark.parametrize("case", PROBE)
def test_k7b_x_planes_are_one_k_step_each(case):
    """K7b's x boxes of one h row land one plane per phase, each one wgmma
    K-step of 64 rows × 32 bytes in the 32-byte swizzle (atoms of 8 rows,
    256 B), the chunk's 3·cpk rows (kd, j) first: 4 planes fill the packed
    kernel's h row of 64 rows × 128 B."""
    d, hw, cin, cout, halo = case
    plan = G.wgrad_plan(8, d, int(halo), cin, cout, hw, hw, fold=True)
    xmap = G.fold_maps(plan)["x"]
    assert 3 * plan.cpk <= G.M and 2 * xmap.box[0] == 32 == xmap.swizzle
    assert 2 * xmap.box[0] * xmap.box[1] * xmap.box[2] == 32 * 3 * plan.cpk
    loads = [(start, at) for m, start, at in
             G.fold_item_loads(plan, plan.items - 1, plan.chunks - 1, False) if m == "x"]
    assert sorted(at for _, at in loads) == [r * G.M * 128 + p * G.FOLD_X_PLANE
                                             for r in range(G.ROWS) for p in range(4)]
    assert all(at % 256 == 0 for _, at in loads) and 4 * G.FOLD_X_PLANE == G.M * 128
    assert sorted(start[3] for start, _ in loads) == [0, 0, 1, 1, 2, 2, 3, 3]


@pytest.mark.parametrize("kw", range(3))
def test_fold_copy_sources_cover_the_copy_once(kw):
    """Copy kw's 64 elements read 64 distinct (box, phase, element) places,
    each the pixel fold_k(k) + 1 - kw of the dy row."""
    seen = set()
    for k in range(64):
        box, ph, e = G.fold_copy_source(kw, k)
        assert (box, ph, e) not in seen
        seen.add((box, ph, e))
        pixel = G.fold_k(k) + 1 - kw  # relative to w0
        w4 = {"main": e, "left": e - 8, "right": 16 + e}[box]
        assert 4 * w4 + ph == pixel
    assert sorted(G.fold_k(k) for k in range(64)) == list(range(64))


# Small folded weight gradients: (B, D, halo, H, W, Cin, Cout); W 64 and 128
# (two w tiles), H 3 (an item overhanging h), Cin 5 and 24 (two row chunks),
# Cout 6 and 32.
GEMM_SHAPES = [(1, 2, 0, 3, 64, 5, 6), (1, 2, 1, 4, 128, 24, 32), (2, 1, 0, 2, 64, 3, 4),
               (1, 1, 1, 3, 64, 22, 32)]


@pytest.mark.parametrize("shape", GEMM_SHAPES)
def test_k7b_items_swizzle_and_copies_give_the_weight_gradient(shape):
    """Every item of every row chunk, loaded by the folded maps (x's K-step
    p from plane p: the 32-byte swizzle of TMA and of the descriptors is
    one map, so the planes are modelled dense), dy's copies built from the
    raw boxes by ``fold_copy_source``, and contracted as the kernel
    contracts them (x row (kd, ci) of h row r with copy row r + 2 - kh):
    the plain weight gradient of the folded operands."""
    b, d, halo, h, w, cin, cout = shape
    plan = G.wgrad_plan(b, d, halo, cin, cout, h, w, fold=True)
    assert plan is not None
    seed = sum(shape)
    xf = _folded((b, d + 2 * halo, h, w, cin), seed)
    dyf = _folded((b, d, h, w, cout), seed + 1)
    maps = G.fold_maps(plan)
    flats = {"x": xf.reshape(-1), "dy": dyf.reshape(-1), "dy_side": dyf.reshape(-1)}
    dw = torch.zeros((3, 3, 3, cin, cout), dtype=torch.float64)
    stage_elems = (G.X_BYTES + G.DY_BYTES) // 2
    for chunk in range(plan.chunks):
        for it in range(plan.items):
            stage = torch.zeros(stage_elems, dtype=torch.float64)
            for m, start, at in G.fold_item_loads(plan, it, chunk, follows=False):
                box = _tma(flats[m], maps[m], start)
                stage[at // 2:at // 2 + box.numel()] = box
            rows3 = 3 * plan.cpk
            planes = stage[:G.X_BYTES // 2].reshape(G.ROWS, 4, G.M, 16)  # [r][p][m][i]
            xr = planes.permute(0, 2, 1, 3).reshape(G.ROWS, G.M, 64)[:, :rows3]
            dyraw = stage[G.X_BYTES // 2:].reshape(2, G.DY_BYTES // 4)
            copies = torch.zeros((G.ROWS + 2, 3, G.COUT_MAX, 64), dtype=torch.float64)
            for t in range(G.ROWS + 2):
                half, r = dyraw[t // G.ROWS], t % G.ROWS
                main = half[:G.FOLD_DY_MAIN // 2].reshape(G.COUT_MAX, G.ROWS, 4, 16)
                side = half[G.FOLD_DY_MAIN // 2:].reshape(2, G.COUT_MAX, G.ROWS, 8)
                for kw in range(3):
                    for k in range(64):
                        box, ph, e = G.fold_copy_source(kw, k)
                        copies[t, kw, :, k] = (main[:, r, ph, e] if box == "main" else
                                               side[0 if box == "left" else 1, :, r, e])
            for r in range(G.ROWS):
                for kh in range(3):
                    part = torch.einsum("mk,wok->mwo", xr[r], copies[r + 2 - kh])
                    for m in range(rows3):
                        kd, ci = m // plan.cpk, chunk * plan.cpk + m % plan.cpk
                        if ci < cin:
                            dw[kd, kh, :, ci] += part[m, :, :cout]
    plain = K.conv3x3_pfold_wgrad_halo_plain if halo else K.conv3x3_pfold_wgrad_plain
    ref = plain(xf, dyf, w // 4)
    torch.testing.assert_close(dw, ref, rtol=1e-12, atol=1e-12)
