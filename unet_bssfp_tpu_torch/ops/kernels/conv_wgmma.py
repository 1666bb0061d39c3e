"""The launch plan, weight layout and launcher of the bf16 wgmma conv kernel
(``csrc/conv3x3_wgmma.cu``), which runs K1, K1's dgrad, K5 and K5's dgrad
on the card (:mod:`.conv3d` routes to it), and on the phase-major w-folded
layout K7a with its dgrad and halo forms (:mod:`.pfold`, ``fold``).

Everything about a launch that can be decided without the card is decided
here, in plain Python, so the CPU tests check it: which kernel a shape takes
(:func:`wgmma_plan` returns ``None`` where the wgmma kernel does not take
it), the tile, the ring depth, the shared memory, the d segments and the
grid (:class:`WgmmaPlan`), the output voxels each block writes
(:func:`block_outputs`, the guard columns among them :func:`block_guards`),
the guarded epilogue's stores (:func:`guarded_stores`), and the weight's
pre-layout (:func:`weight_image`).
The C launcher checks the plan's numbers again and refuses a plan that does
not fit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from unet_bssfp_tpu_torch.ops.kernels import _build

TILE_W = 64          # output w columns per tile (one wgmma M)
PX = TILE_W + 16     # pixels per loaded row: w0 - 8 .. w0 + 71
CK = 16              # input channels per ring stage (one wgmma K)
N_PADS = (32, 64, 96)  # wgmma N: Cout padded up to one of these
N_NARROW = 24        # N for Cout <= 24 where N 32's weights do not fit
TILE_N = 72          # N of each tile where Cout > 96 is cut into N tiles
CONSUMERS = 2        # consumer warpgroups per block
ROW_BYTES = CK * PX * 2  # one (h row, 16 channels) box
EPI_BYTES = 16 * 72 * 2
EPI_LANES = EPI_BYTES // 2  # a warpgroup's staging tile, in bf16 lanes
MAX_GUARD = 8        # guard columns a row the kernel takes (guard_cols gives 2 to 8)
MAX_STAGES = 4
BAR_BYTES = 8 * (MAX_STAGES + 1)
SLACK = 128          # alignment of the dynamic shared memory base
SMEM_LIMIT = 232_448  # shared memory one block may take on an H100
SMS = 132             # the H100 SXM's SMs: the default for the d segments
FOLD_MAIN_ROW = 4 * CK * 16 * 2  # folded stage: a row's share of the main box
FOLD_SIDE_ROW = CK * 8 * 2       # and of each 8-w4 side box (with it ROW_BYTES)


@dataclasses.dataclass(frozen=True)
class TensorMap:
    """A TMA tensor map as a launcher encodes it: ``dims`` innermost first,
    ``strides`` in bytes of dims 1.., ``box`` the extent of one load,
    ``swizzle`` the span in bytes of its shared-memory swizzle (0: none)."""
    dims: Tuple[int, ...]
    strides: Tuple[int, ...]
    box: Tuple[int, ...]
    swizzle: int = 0


@dataclasses.dataclass(frozen=True)
class WgmmaPlan:
    """One launch: the operands' geometry and the kernel's choices.

    ``rows``: output h rows per block (2 consumer warpgroups × 1 or 2);
    ``stages``: ring depth; ``seg_len``/``segments``: each block walks
    ``seg_len`` output d slices (the last segment may be shorter); blocks
    are numbered (b, segment, w tile, h tile) with the h tile fastest. The
    w tiles cover the data columns (``wdim - wguard``) only: the block of a
    row's last data tile also writes that row's guard columns (zero).
    ``fold``: the operands are phase-major w-folded, (B, D, 4·C, H·W/4);
    ``wdim`` is then the unfolded W, and every other number is the packed
    plan's at that shape. ``n_tiles``: Cout is cut into that many tiles of
    ``n`` channels (the last one ragged), one block per tile and column, each
    with its tile's weights resident and writing its channel range of the
    one output; blocks are numbered (b, segment, w tile, h tile, N tile)
    with the N tile fastest, so the tiles of one column read the same input
    tile from L2 at about the same time."""
    b: int
    din: int
    dout: int
    shift: int
    cin: int
    cout: int
    h: int
    wdim: int
    wguard: int
    lanes_map: bool
    n: int
    cin_pad: int
    rows: int
    stages: int
    seg_len: int
    segments: int
    fold: bool = False
    n_tiles: int = 1

    @property
    def tiles_h(self) -> int:
        return -(-self.h // self.rows)

    @property
    def wdata(self) -> int:
        return self.wdim - self.wguard

    @property
    def tiles_w(self) -> int:
        return -(-self.wdata // TILE_W)

    @property
    def grid(self) -> int:
        return self.b * self.segments * self.tiles_w * self.tiles_h * self.n_tiles

    @property
    def weight_bytes(self) -> int:
        """The weights one block holds: its N tile's."""
        return 27 * self.cin_pad * self.n * 2

    @property
    def stage_bytes(self) -> int:
        return (self.rows + 2) * ROW_BYTES

    @property
    def smem(self) -> int:
        return smem_bytes(self.rows, self.stages, self.weight_bytes)


def smem_bytes(rows: int, stages: int, weight_bytes: int) -> int:
    """Dynamic shared memory of one block: alignment slack, the ring of raw
    tiles, two transposed tiles (each a raw tile's size), the resident
    weights, two epilogue staging tiles, the barriers."""
    return (SLACK + (stages + 2) * (rows + 2) * ROW_BYTES + weight_bytes
            + CONSUMERS * EPI_BYTES + BAR_BYTES)


def _ring(n: int, wbytes: int) -> Optional[Tuple[int, int]]:
    """(rows, stages) for N ``n`` and ``wbytes`` of resident weights: 4
    output rows where N is 32 and a ring of 2 stages fits, else 2; the
    deepest ring up to 4 that fits; ``None`` where not even 2 stages do."""
    for rows in ((4, 2) if n == 32 else (2,)):
        free = SMEM_LIMIT - smem_bytes(rows, 0, wbytes)
        stages = min(MAX_STAGES, free // ((rows + 2) * ROW_BYTES))
        if stages >= 2:
            return rows, stages
    return None


def wgmma_plan(b: int, din: int, dout: int, shift: int, cin: int, cout: int,
               h: int, wdim: int, wguard: int = 0, sms: int = SMS,
               fold: bool = False) -> Optional[WgmmaPlan]:
    """The plan of one bf16 launch, or ``None`` where the wgmma kernel does
    not take the shape (static, by shape alone):

    - ``wdim % 8 != 0`` without guard columns (a TMA row stride must be a
      multiple of 16 bytes, and the flattened-lanes map needs zero guards to
      stand for the w padding); guard columns where the guarded epilogue's
      staging does not hold the spans (:func:`guard_staging_fits`: more
      than 8 guards, an odd row width, a last tile of more than 66 columns
      at 2 rows);
    - a weight (one N tile's) too large to stay in shared memory beside a
      2-stage ring;
    - with ``fold`` (W = ``wdim``), W/4 not a multiple of 8 (the folded
      map's row stride is W/4 elements), guard columns or Cout > 96.

    N: Cout padded up to 32, 64 or 96; where Cout ≤ 24 and N 32's weights
    do not fit, 24 (27·Cin_pad·24·2 bytes: the upcat_1 conv 144 → 24 of the
    multi-stage backbone). Cout > 96 (the accumulators of three rolling
    output slices at N = 128 exceed the registers) is cut into
    ``ceil(Cout / 72)`` N tiles of 72 (the dgrad 24 → 144: two; the kernel
    compiles its tile offsets into the N-72 instance alone).
    Tiles: 4 output rows (2 per consumer warpgroup) where N is 32 and a
    ring of 2 stages fits, else 2; the deepest ring up to 4 that fits. d
    segments: the count that takes the fewest block-steps per SM (waves of
    blocks over ``sms`` SMs × steps per block)."""
    if min(b, din, dout, cin, cout, h, wdim) < 1 or not 0 <= wguard < wdim:
        return None
    if wguard > MAX_GUARD:
        return None
    if fold and (wdim % 32 or wguard):
        return None
    n_tiles = 1
    n = next((p for p in N_PADS if p >= cout), None)
    if n is None:
        if fold:
            return None
        n, n_tiles = TILE_N, -(-cout // TILE_N)
    lanes_map = wdim % 8 != 0
    if lanes_map and (wguard < 1 or (h * wdim) % 8):
        return None
    cin_pad = -(-cin // CK) * CK
    choice = _ring(n, 27 * cin_pad * n * 2)
    if choice is None and n == 32 and cout <= N_NARROW and not fold:
        n = N_NARROW
        choice = _ring(n, 27 * cin_pad * n * 2)
    if choice is None:
        return None
    rows, stages = choice
    if wguard and not guard_staging_fits(rows, wdim, wguard):
        return None
    columns = b * -(-h // rows) * -(-(wdim - wguard) // TILE_W) * n_tiles
    # one block per SM: a block's time is its steps (seg_len + 2 input
    # slices), the call's time its waves of blocks times that
    segments = min(range(1, dout + 1), key=lambda s: (
        math.ceil(columns * s / sms) * (-(-dout // s) + 2), s))
    seg_len = -(-dout // segments)
    segments = -(-dout // seg_len)
    return WgmmaPlan(b, din, dout, shift, cin, cout, h, wdim, wguard, lanes_map,
                     n, cin_pad, rows, stages, seg_len, segments, fold, n_tiles)


def _round8(x: int) -> int:
    return (x + 7) & ~7


def guard_cpp(rows: int) -> int:
    """Channels a pass of the guarded epilogue: 16 at 2 rows, 8 at 4."""
    return 16 if rows == 2 else 8


def guard_merged(rows: int, wdim: int, cols: int) -> bool:
    """Whether a block's ``rows`` rows are one span of the guarded epilogue:
    it owns every column of them (``cols == wdim``, at least 64), and a
    pass's channels of the span fit both warpgroups' staging tiles (the
    span from its start's lane mod 8, at most 6 at an even width)."""
    return (cols == wdim and cols >= TILE_W
            and guard_cpp(rows) * _round8(rows * wdim + 6) <= CONSUMERS * EPI_LANES)


def guard_staging_fits(rows: int, wdim: int, wguard: int) -> bool:
    """``conv3x3_wgmma.cuh:guard_staging_fits``: the guarded epilogue takes
    the shape (an even width; the block's rows as one span, or a row's
    columns in one warpgroup's staging tile)."""
    tiles = -(-(wdim - wguard) // TILE_W)
    cols = wdim - TILE_W * (tiles - 1)  # the last data tile's columns
    return wdim % 2 == 0 and (guard_merged(rows, wdim, cols) or
                              guard_cpp(rows) * _round8(6 + max(cols, TILE_W)) <= EPI_LANES)


def fold_maps(plan: WgmmaPlan) -> Dict[str, TensorMap]:
    """The folded launch's two maps over (W/4, Cin, H, 4 phases, B·Din):
    ``main`` boxes of 16 w4 × 16 channels × all the block's rows × 4
    phases, ``side`` boxes of 8 w4 × 16 channels × rows of one phase."""
    w4, hw4 = plan.wdim // 4, plan.h * plan.wdim // 4
    dims = (w4, plan.cin, plan.h, 4, plan.b * plan.din)
    strides = (2 * hw4, 2 * w4, 2 * hw4 * plan.cin, 2 * hw4 * plan.cin * 4)
    return {"main": TensorMap(dims, strides, (16, CK, plan.rows + 2, 4, 1)),
            "side": TensorMap(dims, strides, (8, CK, plan.rows + 2, 1, 1))}


def fold_stage_loads(plan: WgmmaPlan, b: int, j: int, c: int, h0: int,
                     w0: int) -> List[Tuple[str, Tuple[int, ...], int]]:
    """The loads of one folded ring stage, as ``load_stage`` issues them:
    input slice j, channel chunk c, for the block at (b, h0, w0); each
    (map, start coordinates, byte offset in the stage)."""
    main = (plan.rows + 2) * FOLD_MAIN_ROW
    side = (plan.rows + 2) * FOLD_SIDE_ROW
    w4, bd = w0 // 4, b * plan.din + j
    return [("main", (w4, c * CK, h0 - 1, 0, bd), 0),
            ("side", (w4 - 8, c * CK, h0 - 1, 3, bd), main),
            ("side", (w4 + 16, c * CK, h0 - 1, 0, bd), main + side)]


def fold_xpose_row(rows: int, q: int, i: int) -> Tuple[int, int, int, int]:
    """Lane i of transpose block q of a folded stage (``xpose_rows``): the
    byte offset in the stage of the 8 elements it reads (channel 8·half + i
    of h row rr) and the transposed pixel index px its stored row holds
    (pixel w0 - 8 + px); (offset, rr, half, px)."""
    groups = PX // 8
    pg, half, rr = q % groups, (q // groups) % 2, q // (2 * groups)
    ch = half * 8 + i
    if pg == 0:
        return (rows + 2) * FOLD_MAIN_ROW + (rr * CK + ch) * 16, rr, half, i
    if pg == groups - 1:
        return ((rows + 2) * (FOLD_MAIN_ROW + FOLD_SIDE_ROW) + (rr * CK + ch) * 16,
                rr, half, 72 + i)
    ph, g = (pg - 1) >> 1, (pg - 1) & 1
    return (((ph * (rows + 2) + rr) * CK + ch) * 16 + g * 8) * 2, rr, half, 8 + 32 * g + 4 * i + ph


def fold_store(seg: int, k: int) -> Tuple[int, int, int]:
    """Element k of the 16 bytes epilogue thread segment ``seg`` stores,
    folded: (its pixel in the 64-pixel staging row, phase, w4 - w0/4)."""
    ph, g = seg >> 1, seg & 1
    return 32 * g + 4 * k + ph, ph, 8 * g + k


def _block_index(plan: WgmmaPlan, block: int) -> Tuple[int, int, int, int]:
    """(b, segment, h0, w0) of block ``block``, as the kernel decodes it."""
    block //= plan.n_tiles
    ht = block % plan.tiles_h
    block //= plan.tiles_h
    wt = block % plan.tiles_w
    block //= plan.tiles_w
    return block // plan.segments, block % plan.segments, ht * plan.rows, wt * TILE_W


def _w_end(plan: WgmmaPlan, w0: int) -> int:
    """The end of the columns the block at ``w0`` writes in each row: its
    tile's 64, and at a row's last data tile the guard columns after them."""
    return plan.wdim if w0 + TILE_W >= plan.wdata else w0 + TILE_W


def block_outputs(plan: WgmmaPlan, block: int) -> Tuple[int, range, range, range]:
    """The output voxels block ``block`` writes, as the kernel decodes its
    index: (b, d range, h range, w range), for the channels of
    :func:`block_channels`; the w range holds the guard columns it zeroes
    (:func:`block_guards`)."""
    b, seg, h0, w0 = _block_index(plan, block)
    d0 = seg * plan.seg_len
    return (b, range(d0, min(d0 + plan.seg_len, plan.dout)),
            range(h0, min(h0 + plan.rows, plan.h)), range(w0, _w_end(plan, w0)))


def block_guards(plan: WgmmaPlan, block: int) -> range:
    """The guard columns block ``block`` writes as zero in each of its rows:
    those of its w range at or past the data width (empty but at a row's
    last data tile)."""
    ws = block_outputs(plan, block)[3]
    return range(max(ws.start, plan.wdata), ws.stop)


def guarded_stores(plan: WgmmaPlan, block: int) -> List[Tuple[int, int]]:
    """The stores the guarded epilogue (``store_slice_guarded``) of block
    ``block`` issues for one (d, channel), in one channel plane of H·wdim
    lanes: (first lane, lanes), 8 lanes a 16-byte store. Where
    :func:`guard_merged`, the block's rows are one span of the plane; else
    each row is a span. A span is cut at the plane's 16-byte units, a unit wholly inside
    it one store, a partial unit at either end the widest stores its
    alignment allows."""
    _, _, h0, w0 = _block_index(plan, block)
    w_end = _w_end(plan, w0)
    cols = w_end - w0
    merged = w0 == 0 and guard_merged(plan.rows, plan.wdim, cols)
    if merged:
        spans = [(h0 * plan.wdim, min(plan.rows, plan.h - h0) * cols)]
    else:
        spans = [(hh * plan.wdim + w0, cols) for hh in range(h0, min(h0 + plan.rows, plan.h))]
    stores = []
    for start, length in spans:
        lane, end = start, start + length
        while lane < end:
            unit_end = min((lane // 8 + 1) * 8, end)
            if lane % 8 == 0 and unit_end - lane == 8:
                stores.append((lane, 8))
                lane += 8
                continue
            while lane < unit_end:  # store_part: 4, 2 or 1 lanes
                size = next(s for s in (4, 2, 1) if lane % s == 0 and lane + s <= unit_end)
                stores.append((lane, size))
                lane += size
    return stores


def block_channels(plan: WgmmaPlan, block: int) -> range:
    """The output channels block ``block`` writes: its N tile's."""
    co0 = block % plan.n_tiles * plan.n
    return range(co0, min(co0 + plan.n, plan.cout))


def weight_image(w: torch.Tensor, n: int, cin_pad: int, n_tiles: int = 1) -> torch.Tensor:
    """``w`` (3, 3, 3, Cin, Cout) as the kernel's shared memory holds it,
    bf16, flat: N tile ``nt`` (output channels ``nt·n`` on) at
    ``nt·27·cin_pad·n``; inside it block ``(t, c)`` for tap t = 9·kd + 3·kh
    + kw and channel chunk c (16 input channels) at ``(t·cin_pad/16 +
    c)·16·n``; inside a block element ``((ng·2 + kg)·8 + r)·8 + k8`` is
    ``w[t][16c + 8kg + k8][nt·n + 8ng + r]`` (zero past Cin and Cout): the
    wgmma B operand, K-major, 8 × 8 core matrices."""
    cin, cout = w.shape[3], w.shape[4]
    wp = F.pad(w.detach().to(torch.bfloat16), (0, n_tiles * n - cout, 0, cin_pad - cin))
    img = wp.reshape(27, cin_pad // CK, 2, 8, n_tiles, n // 8, 8).permute(4, 0, 1, 5, 2, 6, 3)
    return img.contiguous().reshape(-1)


def launch(plan: WgmmaPlan, xk: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
           what: str) -> torch.Tensor:
    """One launch of the wgmma kernel on CUDA bf16 operands, as ``plan``
    says; raises if the launch is refused."""
    if xk.dtype != torch.bfloat16 or xk.device.type != "cuda":
        raise ValueError(f"{what}: the wgmma kernel takes CUDA bf16, not "
                         f"{xk.dtype} on {xk.device}")
    if xk.data_ptr() % 16:
        raise ValueError(f"{what}: input not 16-byte aligned")
    img = weight_image(w, plan.n, plan.cin_pad, plan.n_tiles)
    bk = bias.detach().float().contiguous()
    f = 4 if plan.fold else 1
    y = torch.empty((plan.b, plan.dout, f * plan.cout, plan.h * plan.wdim // f),
                    dtype=torch.bfloat16, device=xk.device)
    lib = _lib()
    with torch.cuda.device(xk.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.conv3x3_wgmma_bf16(
            xk.data_ptr(), img.data_ptr(), bk.data_ptr(), y.data_ptr(), plan.b,
            plan.din, plan.dout, plan.shift, plan.cin, plan.cout, plan.h, plan.wdim,
            plan.wguard, int(plan.lanes_map), int(plan.fold), plan.n, plan.cin_pad,
            plan.rows, plan.stages, plan.seg_len, plan.segments, plan.n_tiles, stream)
    _build.check(lib, rc, what)
    return y


def device_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _lib() -> ctypes.CDLL:
    lib = _build.load("conv3x3_wgmma")
    if not getattr(lib, "_typed", False):
        lib.conv3x3_wgmma_bf16.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 18
                                           + [ctypes.c_void_p])
        lib.conv3x3_wgmma_bf16.restype = ctypes.c_int
        lib.conv3x3_wgmma_smem.argtypes = [ctypes.c_int] * 4
        lib.conv3x3_wgmma_smem.restype = ctypes.c_int
        lib._typed = True
    return lib
