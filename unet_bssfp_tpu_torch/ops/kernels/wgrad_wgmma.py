"""The launch plan, the GEMM view and the launcher of the bf16 wgmma weight
gradient kernel (``csrc/conv3x3_wgrad_wgmma.cu``), which runs K2 and K5's
weight gradient on the card (:mod:`.conv3d` routes to it), and on the
phase-major w-folded layout K7b and its halo form (:mod:`.pfold`, ``fold``).

Everything about a launch that can be decided without the card is decided
here, in plain Python, so the CPU tests check it: which kernel a shape takes
(:func:`wgrad_plan` returns ``None`` where the wgmma kernel does not take
it), the row chunks, the pixel splits, the ring depth, the shared memory and
the summation chain (:class:`WgradPlan`), and which items and outputs each
block owns (:func:`split_items`, :func:`item_tile`, :func:`chunk_rows`).
:func:`wgrad_gemm_plain` is the kernel's GEMM view in plain PyTorch: the x
row stack and dy's shifted copies as the kernel lays them out, contracted.
The C launcher checks the plan's numbers again and refuses a plan that does
not fit.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from unet_bssfp_tpu_torch.ops.kernels import _build
from unet_bssfp_tpu_torch.ops.kernels.conv_wgmma import TensorMap

ROWS = 2             # h rows per item
TILE_W = 64          # w columns per item (128 B of bf16: one swizzle span)
PX = TILE_W + 16     # raw dy pixels per row: w0 - 8 .. w0 + 71
M = 64               # x rows (kd, ci) per block: one wgmma M
COUT_MAX = 32        # dy's columns (kw, co) are N = 3 · 32 = 96: one co tile
N = 3 * COUT_MAX
MAX_CPK = M // 3     # channels per row chunk: 3 kd x 21 rows fill M
X_BYTES = ROWS * M * 128
DY_BYTES = COUT_MAX * (ROWS + 2) * PX * 2
STAGE_BYTES = X_BYTES + DY_BYTES
SLOTS = 2 * ROWS + 2  # copy rows in the ring: an item's four and the next item's two
COPY_BYTES = SLOTS * N * 128
MAX_STAGES = 4
SLACK = 1024         # the 1024-byte alignment of the swizzled tiles
BAR_BYTES = 16 * MAX_STAGES  # full and empty per stage
SMEM_LIMIT = 232_448  # shared memory one block may take on an H100
SMS = 132             # the H100 SXM's SMs: the default for the pixel splits


def smem_bytes(stages: int) -> int:
    """Dynamic shared memory of one block: alignment slack, the ring (x tile
    and raw dy rows per stage), the ring of dy's shifted copy rows, the
    full and empty barriers."""
    return SLACK + stages * STAGE_BYTES + COPY_BYTES + BAR_BYTES


@dataclasses.dataclass(frozen=True)
class WgradPlan:
    """One launch. ``d`` is dy's slice count, ``halo`` 1 where x carries one
    more slice per side; Cin in ``chunks`` of ``cpk`` channels, one block
    each per split, whose rows (kd, j) are ci = chunk·cpk + j; split ``s``
    owns items [s·per, (s+1)·per); Cout in ``co_tiles`` tiles of 32
    channels, tile t reading dy's channels 32·t .. 32·t + 31 (the TMA box's
    channel start; past Cout TMA's zero fill) and writing dW's; grid
    (chunks, splits, co_tiles). ``fold``: both
    operands are phase-major w-folded, (B, ., 4·C, H·W/4), ``wdim`` is the
    unfolded W, and an item's 128 pixels are summed phase-major
    (:func:`fold_k`); every number is the packed plan's at that shape."""
    b: int
    d: int
    halo: int
    cin: int
    cout: int
    h: int
    wdim: int
    cpk: int
    chunks: int
    stages: int
    splits: int
    per: int
    fold: bool = False
    co_tiles: int = 1

    @property
    def tiles_h(self) -> int:
        return -(-self.h // ROWS)

    @property
    def tiles_w(self) -> int:
        return -(-self.wdim // TILE_W)

    @property
    def items(self) -> int:
        return self.b * self.d * self.tiles_h * self.tiles_w

    @property
    def grid(self) -> Tuple[int, int, int]:
        return self.chunks, self.splits, self.co_tiles

    @property
    def smem(self) -> int:
        return smem_bytes(self.stages)

    @property
    def chain(self) -> int:
        """The longest run of f32 roundings one product passes through: the
        item's accumulator (ROWS·64 pixels), the split's sum of items, the
        sum of splits."""
        return ROWS * TILE_W + self.per + self.splits


def wgrad_plan(b: int, d: int, halo: int, cin: int, cout: int, h: int, wdim: int,
               sms: int = SMS, fold: bool = False) -> Optional[WgradPlan]:
    """The plan of one bf16 launch, or ``None`` where the wgmma kernel does
    not take the shape (static, by shape alone):

    - ``wdim % 8 != 0`` (a TMA row stride must be a multiple of 16 bytes;
      the ``wguard`` width 66 is one, which is why a guarded conv's backward
      strips the guards first and takes the plan at W 64: K2W);
    - 2³¹ items or more (the kernel counts them in 32 bits);
    - with ``fold`` (W = ``wdim``), W/4 not a multiple of 16 (x's folded map
      runs over the flattened lanes h·W/4 + w4, so a tile's 16 w4 must end
      inside their row), or Cout > 32.

    Rows: Cin in the fewest chunks of at most 21 channels (3 kd × 21 rows
    fill one wgmma M of 64), as even as can be. Cout: tiles of 32 (dy's
    (kw, co) columns are one wgmma N of 96; the multi-stage backbone's Cout
    48 takes two). Ring: the deepest up to 4 that fits. Splits: one wave of
    one block per SM (``sms // (chunks · co_tiles)``), at most one per
    item."""
    if min(b, d, cin, cout, h, wdim) < 1 or halo not in (0, 1):
        return None
    if wdim % 8 or (fold and (wdim % (4 * 16) or cout > COUT_MAX)):
        return None
    co_tiles = -(-cout // COUT_MAX)
    chunks = -(-cin // MAX_CPK)
    cpk = -(-cin // chunks)
    stages = max(s for s in range(MAX_STAGES + 1) if smem_bytes(s) <= SMEM_LIMIT)
    if stages < 2:
        return None
    plan = WgradPlan(b, d, halo, cin, cout, h, wdim, cpk, chunks, stages, 1, 1, fold, co_tiles)
    if plan.items >= 2 ** 31 or co_tiles > 65535:
        return None
    splits = max(1, min(plan.items, sms // (chunks * co_tiles), 65535))
    per = -(-plan.items // splits)
    return dataclasses.replace(plan, splits=-(-plan.items // per), per=per)


def split_items(plan: WgradPlan, split: int) -> range:
    """The items split ``split`` sums, in the order it sums them."""
    return range(split * plan.per, min((split + 1) * plan.per, plan.items))


def item_tile(plan: WgradPlan, item: int) -> Tuple[int, int, int, int]:
    """(b, d, h0, w0) of an item, as the kernel decodes it: dy slice d, h
    rows h0 .. h0+1, w columns w0 .. w0+63; the h tile runs fastest, so
    the next item shares two dy rows with this one unless it starts a new
    (b, d, w tile) run."""
    tiles = plan.tiles_h * plan.tiles_w
    bd, t = divmod(item, tiles)
    return bd // plan.d, bd % plan.d, (t % plan.tiles_h) * ROWS, (t // plan.tiles_h) * TILE_W


def tile_channels(plan: WgradPlan, tile: int) -> range:
    """The output channels co tile ``tile`` reads from dy and writes to dW."""
    return range(tile * COUT_MAX, min((tile + 1) * COUT_MAX, plan.cout))


def chunk_rows(plan: WgradPlan, chunk: int) -> List[Tuple[int, int]]:
    """The (kd, ci) rows of dW that the blocks of row chunk ``chunk`` write
    (each for all 9 (kh, kw) taps and every co)."""
    rows = [(m // plan.cpk, chunk * plan.cpk + m % plan.cpk) for m in range(3 * plan.cpk)]
    return [(kd, ci) for kd, ci in rows if ci < plan.cin]


def copy_offset(slot: int, kw: int, co: int, k: int) -> int:
    """Byte offset in the ring of dy's shifted copy rows of the element (kw,
    co, pixel k of the tile) of the dy row in slot ``slot``: 128-byte rows
    (kw, co) per dy row, each row's 16-byte chunks swizzled by the row's
    index mod 8. An item's dy row t lies in slot (slot0 + t) % SLOTS, and
    the next h tile's slot0 is slot0 + 2."""
    n = kw * COUT_MAX + co
    return slot * N * 128 + n * 128 + (((k // 8) ^ (n % 8)) << 4) + (k % 8) * 2


FOLD_X_PLANE = M * 32  # folded x: one phase's 64 rows of 16 pixels, 32-byte swizzled
FOLD_DY_MAIN = 4 * COUT_MAX * ROWS * 16 * 2  # folded raw dy of two rows: main box
FOLD_DY_SIDE = COUT_MAX * ROWS * 8 * 2       # and each 8-w4 side box


def fold_maps(plan: WgradPlan) -> Dict[str, TensorMap]:
    """The folded launch's maps: ``x`` over (H·W/4 lanes, Cin, D + 2·halo,
    4 phases, B), boxes (16 w4, cpk, 3 slices) 32-byte swizzled, one per h
    row and phase (K-step p of an item reads plane p); ``dy`` and
    ``dy_side`` over (W/4, 4 phases, H, Cout, B·D), boxes (16, 4, 2 rows,
    32) and (8, 1, 2, 32)."""
    w4, hw4, dx = plan.wdim // 4, plan.h * plan.wdim // 4, plan.d + 2 * plan.halo
    hw = 4 * hw4
    x = TensorMap((plan.h * w4, plan.cin, dx, 4, plan.b),
                  (2 * hw4, 2 * hw * plan.cin, 2 * hw4 * plan.cin, 2 * hw * plan.cin * dx),
                  (16, plan.cpk, 3, 1, 1), swizzle=32)
    ddims = (w4, 4, plan.h, plan.cout, plan.b * plan.d)
    dstr = (2 * hw4 * plan.cout, 2 * w4, 2 * hw4, 2 * hw * plan.cout)
    return {"x": x, "dy": TensorMap(ddims, dstr, (16, 4, ROWS, COUT_MAX, 1)),
            "dy_side": TensorMap(ddims, dstr, (8, 1, ROWS, COUT_MAX, 1))}


def fold_item_loads(plan: WgradPlan, item: int, chunk: int,
                    follows: bool) -> List[Tuple[str, Tuple[int, ...], int]]:
    """The loads of one folded item, as ``load_item`` issues them: (map,
    start coordinates, byte offset in the stage); an item that ``follows``
    the one before it loads only its second pair of dy rows."""
    b, d, h0, w0 = item_tile(plan, item)
    w4dim, w4, bd = plan.wdim // 4, w0 // 4, b * plan.d + d
    out = [("x", ((h0 + r) * w4dim + w4, chunk * plan.cpk, d - 1 + plan.halo, p, b),
            r * M * 128 + p * FOLD_X_PLANE) for r in range(ROWS) for p in range(4)]
    for half in range(1 if follows else 0, 2):
        at, hh = X_BYTES + half * DY_BYTES // 2, h0 - 1 + 2 * half
        out += [("dy", (w4, 0, hh, 0, bd), at),
                ("dy_side", (w4 - 8, 3, hh, 0, bd), at + FOLD_DY_MAIN),
                ("dy_side", (w4 + 16, 0, hh, 0, bd), at + FOLD_DY_MAIN + FOLD_DY_SIDE)]
    return out


def fold_k(k: int) -> int:
    """The pixel offset from w0 of element k of a folded item's row (x's
    rows and dy's copies alike): k = 16·p + i is pixel w0 + 4·i + p."""
    return 4 * (k % 16) + k // 16


def fold_copy_source(kw: int, k: int) -> Tuple[str, int, int]:
    """Where the folded copy build reads element k of copy ``kw`` of a dy
    row: (box, phase, element of that box's row). The main box holds the
    tile's 16 w4 of every phase (element i: w4 w0/4 + i), the left box
    phase 3 from w4 w0/4 - 8, the right box phase 0 from w4 w0/4 + 16;
    copy kw's element k is dy at pixel w0 + fold_k(k) + 1 - kw."""
    p, i = k // 16, k % 16
    q = p + 1 - kw
    if q == 4:
        return ("right", 0, 0) if i == 15 else ("main", 0, i + 1)
    if q == -1:
        return ("left", 3, 7) if i == 0 else ("main", 3, i - 1)
    return "main", q, i


def wgrad_gemm_plain(xk: torch.Tensor, dy: torch.Tensor, wdim: int, halo: int) -> torch.Tensor:
    """The kernel's GEMM view in plain PyTorch, f32 (f64 for f64 operands):
    for every dy slice, the x row stack (kd, ci) (x slices d-1, d, d+1,
    or d, d+1, d+2 with ``halo``; zero outside) and, per co tile, dy's
    shifted copies (dy row, kw, co_pad) of the tile's 32 channels (zero past
    Cout) with copy[kh][kw](h, w) = dy(h - kh + 1, w - kw + 1), contracted
    over the pixels, rows by (kh, kw, co) columns → the tile's channels of
    dW (3, 3, 3, Cin, Cout)."""
    acc = torch.promote_types(xk.dtype, torch.float32)
    b, dx, cin, hw = xk.shape
    d, cout = dy.shape[1], dy.shape[2]
    h = hw // wdim
    tiles = -(-cout // COUT_MAX)
    x = xk.to(acc) if halo else F.pad(xk.to(acc), (0, 0, 0, 0, 1, 1))
    rows = torch.stack([x[:, kd:kd + d] for kd in range(3)], 2)  # (b, d, kd, ci, hw)
    g = F.pad(dy.to(acc).reshape(b, d, cout, h, wdim),
              (1, 1, 1, 1, 0, tiles * COUT_MAX - cout))
    out = []
    for t in range(tiles):  # the box of tile t: dy's channels 32t .. 32t + 31
        gt = g[:, :, t * COUT_MAX:(t + 1) * COUT_MAX]
        copies = torch.stack([torch.stack([gt[..., 2 - kh:2 - kh + h, 2 - kw:2 - kw + wdim]
                                           for kw in range(3)], 2) for kh in range(3)], 2)
        # (b, d, kh, kw, co_pad, h, w): copy (kh, kw) pairs x pixel p with dy(p - shift)
        out.append(torch.einsum("bdkcp,bdhwop->khwco", rows,
                                copies.reshape(b, d, 3, 3, COUT_MAX, hw)))
    return torch.cat(out, -1)[:, :, :, :cin, :cout]


def launch(plan: WgradPlan, xk: torch.Tensor, dy: torch.Tensor, what: str) -> torch.Tensor:
    """One launch of the wgmma wgrad kernel and its split sum on CUDA bf16
    operands, as ``plan`` says; raises if the launch is refused."""
    for t in (xk, dy):
        if t.dtype != torch.bfloat16 or t.device.type != "cuda":
            raise ValueError(f"{what}: the wgmma wgrad kernel takes CUDA bf16, not "
                             f"{t.dtype} on {t.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: operand not 16-byte aligned")
    ncc = 27 * plan.cin * plan.cout
    part = torch.empty((plan.splits, ncc), dtype=torch.float32, device=xk.device)
    dw = torch.empty((3, 3, 3, plan.cin, plan.cout), dtype=torch.float32, device=xk.device)
    lib = _lib()
    with torch.cuda.device(xk.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.conv3x3_wgrad_wgmma_bf16(
            xk.data_ptr(), dy.data_ptr(), part.data_ptr(), dw.data_ptr(), plan.b, plan.d,
            plan.halo, int(plan.fold), plan.cin, plan.cout, plan.h, plan.wdim, plan.cpk,
            plan.chunks, plan.stages, plan.splits, plan.per, plan.co_tiles, stream)
    _build.check(lib, rc, what)
    return dw


def _lib() -> ctypes.CDLL:
    lib = _build.load("conv3x3_wgrad_wgmma")
    if not getattr(lib, "_typed", False):
        lib.conv3x3_wgrad_wgmma_bf16.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
        lib.conv3x3_wgrad_wgmma_bf16.restype = ctypes.c_int
        lib.conv3x3_wgrad_wgmma_smem.argtypes = [ctypes.c_int]
        lib.conv3x3_wgrad_wgmma_smem.restype = ctypes.c_int
        lib._typed = True
    return lib
