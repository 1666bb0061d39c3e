"""K4: fused InstanceNorm(affine) + LeakyReLU on NDHWC, one CUDA launch.

Replaces ``unet_bssfp_tpu/ops/pallas/fused_norm_act.py::
fused_instance_norm_leaky_relu`` (``_kernel``). The kernel is
``csrc/norm_act.cu`` (its header says what bounds it and how the three
phases of its one cooperative launch run, between two grid barriers);
:func:`norm_plan` is its launch plan: the grid (every CTA the card holds at
once), the tiles of whole rows each CTA owns, the rows it keeps in shared
memory, and the fixed order in which the tiles' partials merge.

:func:`instance_norm_leaky_relu_plain` is the same function in plain
PyTorch: the CPU path, the kernel's reference, and (recomputed under
autograd) the backward, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Iterator, Tuple

import torch

from unet_bssfp_tpu_torch.ops.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)
# Threads a CTA aims at (a row's columns times the rows walked at once), and
# the most columns one channel group may have (one thread each): the
# kernel's launch bound (csrc/norm_act.cu:MAX_THREADS), which leaves each
# thread 128 registers.
THREADS = 512
MAX_COLS = 512
# The H100's opt-in shared memory per block (227 KB): the plan's budget
# where no card is asked (the wrapper passes the card's own).
SMEM_OPTIN = 232448
# A tile of a small sample is cut no finer than this: every CTA of a (sample,
# channel group) merges all k of its tiles' partials, so that L2 traffic
# grows as k² (scripts/torch_port_norm_ablation.py sweeps it at the small
# stages).
MIN_TILE_BYTES = 32768


def instance_norm_leaky_relu_plain(x: torch.Tensor, scale: torch.Tensor,
                                   bias: torch.Tensor,
                                   negative_slope: float = 0.1,
                                   epsilon: float = 1e-5) -> torch.Tensor:
    """Per-(n, c) moments over the spatial dims of NDHWC ``x`` in f32
    (biased variance, centred), affine, LeakyReLU, cast back to x's dtype."""
    axes = tuple(range(1, x.ndim - 1))
    xf = x.float()
    mean = xf.mean(dim=axes, keepdim=True)
    var = (xf - mean).square().mean(dim=axes, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + epsilon)
    y = y * scale.float() + bias.float()
    return torch.where(y >= 0, y, negative_slope * y).to(x.dtype)


class NormPlanC(ctypes.Structure):
    """The plan as ``csrc/norm_act.cu`` reads it."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "bf16", "vec", "n", "c", "cg", "ncg", "cols", "lanes", "lanes_p2", "threads", "k",
        "items", "grid", "smem_rows", "smem_bytes", "scratch_bytes")] + [("s", ctypes.c_longlong)]


@dataclasses.dataclass(frozen=True)
class NormPlan:
    """One launch of K4 on (n, s, c) rows.

    Item ``i`` of ``items`` is the tile (sample, channel group, row chunk) =
    (i // (k·ncg), i // k % ncg, i % k): rows [s·chunk // k, s·(chunk+1) // k)
    of that sample, channels [g·cg, min(c, (g+1)·cg)). CTA b takes items b,
    b + grid, ... and keeps their rows, in that order, in ``smem_rows`` rows
    of shared memory; the rest it reads again. Thread t of a CTA is column
    t % cols (``vec`` channels) of row lane = t // cols, and sums rows lane,
    lane + lanes, ... of a tile in that order; the lanes' sums meet in a
    tree (stride lanes_p2 / 2, then half that, ...), and the tiles'
    partials of a (sample, channel) merge in chunk order 0, 1, ..., k - 1."""
    n: int
    s: int
    c: int
    bf16: bool
    vec: int          # elements per load and store (16 bytes where C and the pointer allow)
    cg: int           # channels per group, a multiple of vec
    ncg: int          # channel groups
    cols: int         # cg // vec: threads across a row
    lanes: int        # rows a CTA walks at once
    threads: int      # cols · lanes
    k: int            # row chunks per (sample, channel group)
    grid: int         # CTAs, all resident at once
    smem_rows: int    # rows of cg elements a CTA keeps in shared memory
    scratch_bytes: int
    smem_bytes: int   # scratch + kept rows: the launch's dynamic shared memory

    @property
    def items(self) -> int:
        return self.n * self.ncg * self.k

    @property
    def lanes_p2(self) -> int:
        return 1 << (self.lanes - 1).bit_length()

    @property
    def workspace(self) -> int:
        """f32 elements of the partials' workspace: the tiles' sums, then
        their second moments about the sample's mean."""
        return 2 * self.n * self.k * self.c

    def item(self, i: int) -> Tuple[int, int, int, int, int]:
        """(sample, first channel, channels, first row, rows) of item i."""
        chunk, g, n = i % self.k, i // self.k % self.ncg, i // (self.k * self.ncg)
        r0, r1 = self.s * chunk // self.k, self.s * (chunk + 1) // self.k
        c0 = g * self.cg
        return n, c0, min(self.cg, self.c - c0), r0, r1 - r0

    def cta_items(self, b: int) -> Iterator[int]:
        return iter(range(b, self.items, self.grid))

    def as_c(self) -> NormPlanC:
        return NormPlanC(int(self.bf16), self.vec, self.n, self.c, self.cg, self.ncg, self.cols,
                         self.lanes, self.lanes_p2, self.threads, self.k, self.items, self.grid,
                         self.smem_rows, self.smem_bytes, self.scratch_bytes, self.s)


def norm_plan(n: int, s: int, c: int, bf16: bool, sms: int,
              blocks_per_sm: Callable[[int, int, int], int],
              smem_optin: int = SMEM_OPTIN, align: int = 16,
              min_tile: int = MIN_TILE_BYTES) -> NormPlan:
    """K4's launch plan for (n, s, c) rows of f32 or bf16 on a card with
    ``sms`` SMs; ``blocks_per_sm(vec, threads, smem_bytes)`` is how many such
    CTAs one SM holds at once (the card's occupancy), ``align`` the largest
    power of two (≤ 16) dividing the byte address of x. Tiles are whole rows
    of one sample; a sample's rows are cut into k chunks so that there are
    about as many tiles as SMs, but none under ``min_tile`` bytes; each CTA
    keeps as many of its rows in shared memory as fit."""
    if min(n, s, c) < 1:
        raise ValueError(f"norm_plan: empty shape {(n, s, c)}")
    el = 2 if bf16 else 4
    vec = 16 // el
    while vec > 1 and (c % vec or align % (vec * el)):
        vec //= 2
    cols = min(c // vec, MAX_COLS)
    cg = cols * vec
    ncg = -(-c // cg)
    lanes = max(1, THREADS // cols)
    threads = cols * lanes
    row_bytes = cg * el
    k = max(1, min(s, sms // (n * ncg), -(-s * row_bytes // min_tile)))
    items = n * ncg * k
    rows_max = -(-s // k)
    # the lanes' sums, or the merged means and variances; the rows after it
    # 16-byte aligned
    scratch = -(-4 * max(threads * vec, 2 * cg) // 16) * 16
    per_cta = -(-items // sms)
    keep = min(per_cta * rows_max, (smem_optin - scratch) // row_bytes)
    if keep < 0:
        raise ValueError(f"norm_plan: {scratch} bytes of scratch exceed the card's "
                         f"{smem_optin} bytes of shared memory")
    smem = scratch + keep * row_bytes
    occupancy = blocks_per_sm(vec, threads, smem)
    if occupancy < 1:
        raise RuntimeError(f"norm_plan: no CTA of {threads} threads and {smem} bytes of "
                           "shared memory fits on an SM")
    grid = min(items, occupancy * sms)
    return NormPlan(n=n, s=s, c=c, bf16=bf16, vec=vec, cg=cg, ncg=ncg, cols=cols, lanes=lanes,
                    threads=threads, k=k, grid=grid, smem_rows=keep, scratch_bytes=scratch,
                    smem_bytes=smem)


_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("norm_act")
        lib.norm_act.argtypes = ([ctypes.POINTER(NormPlanC)] + [ctypes.c_void_p] * 5
                                 + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        lib.norm_act.restype = ctypes.c_int
        lib.norm_act_blocks_per_sm.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
        lib.norm_act_blocks_per_sm.restype = ctypes.c_int
        lib.norm_act_device.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
        lib.norm_act_device.restype = ctypes.c_int
        _LIB = lib
    return _LIB


@functools.lru_cache(maxsize=None)
def _device(index: int) -> Tuple[int, int]:
    """(SMs, opt-in shared memory per block) of CUDA device ``index``, read
    once; raises where it takes no cooperative launch."""
    lib, out = _lib(), [ctypes.c_int() for _ in range(3)]
    with torch.cuda.device(index):
        _build.check(lib, lib.norm_act_device(*[ctypes.byref(o) for o in out]),
                     "fused_instance_norm_leaky_relu")
    sms, optin, coop = (o.value for o in out)
    if not coop:
        raise RuntimeError(f"fused_instance_norm_leaky_relu: device {index} takes no "
                           "cooperative launch")
    return sms, optin


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(index: int, bf16: bool, vec: int, threads: int, smem: int) -> int:
    lib, out = _lib(), ctypes.c_int()
    with torch.cuda.device(index):
        _build.check(lib, lib.norm_act_blocks_per_sm(int(bf16), vec, threads, smem,
                                                     ctypes.byref(out)),
                     "fused_instance_norm_leaky_relu")
    return out.value


@functools.lru_cache(maxsize=None)
def _plan(index: int, n: int, s: int, c: int, bf16: bool, align: int):
    """The plan (and its C struct) for device ``index``, cached per shape."""
    sms, optin = _device(index)
    plan = norm_plan(n, s, c, bf16, sms,
                     lambda vec, threads, smem: _blocks_per_sm(index, bf16, vec, threads, smem),
                     optin, align)
    return plan, plan.as_c()


def _norm_act_fwd(x, scale, bias, negative_slope, epsilon):
    """The kernel (CUDA) or the plain version (CPU); no autograd."""
    if x.device.type == "cpu":
        return instance_norm_leaky_relu_plain(x, scale, bias, negative_slope,
                                              epsilon)
    if x.device.type != "cuda":
        raise ValueError(f"fused_instance_norm_leaky_relu: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_instance_norm_leaky_relu: dtype {x.dtype} not supported")
    if x.ndim != 5 or not x.is_contiguous():
        raise ValueError("fused_instance_norm_leaky_relu: needs a contiguous NDHWC tensor")
    n, c = x.shape[0], x.shape[-1]
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError("fused_instance_norm_leaky_relu: scale/bias must be (C,)")
    if scale.device != x.device or bias.device != x.device:
        raise ValueError("fused_instance_norm_leaky_relu: scale/bias on another device")
    y = torch.empty_like(x)
    if not x.numel():
        return y
    ptr = x.data_ptr()
    plan, cplan = _plan(x.get_device(), n, x.numel() // (n * c), c,
                        x.dtype == torch.bfloat16, min(16, ptr & -ptr))
    part = torch.empty(plan.workspace, dtype=torch.float32, device=x.device)
    g = scale.detach().float().contiguous()
    b = bias.detach().float().contiguous()
    lib = _lib()
    rc = _build.launch(lib.norm_act, x, ctypes.byref(cplan), ptr, g.data_ptr(),
                       b.data_ptr(), y.data_ptr(), part.data_ptr(),
                       float(negative_slope), float(epsilon))
    _build.check(lib, rc, "fused_instance_norm_leaky_relu")
    fused_instance_norm_leaky_relu.launches += 1
    return y


class _FusedNormAct(torch.autograd.Function):
    """``fused_instance_norm_leaky_relu_vjp`` (``fused_norm_act.py:86-117``):
    the kernel forward; the backward recomputes the plain version under
    autograd, as the JAX VJP runs its XLA reference (there is no backward
    kernel to port)."""

    @staticmethod
    def forward(ctx, x, scale, bias, negative_slope, epsilon):
        ctx.save_for_backward(x, scale, bias)
        ctx.args = (negative_slope, epsilon)
        return _norm_act_fwd(x, scale, bias, negative_slope, epsilon)

    @staticmethod
    def backward(ctx, dy):
        inputs = [t.detach().requires_grad_(need) for t, need
                  in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        with torch.enable_grad():
            y = instance_norm_leaky_relu_plain(*inputs, *ctx.args)
            grads = iter(torch.autograd.grad(y, wanted, dy))
        return tuple(next(grads) if t.requires_grad else None
                     for t in inputs) + (None, None)


def fused_instance_norm_leaky_relu(x: torch.Tensor, scale: torch.Tensor,
                                   bias: torch.Tensor,
                                   negative_slope: float = 0.1,
                                   epsilon: float = 1e-5) -> torch.Tensor:
    """Fused IN+LeakyReLU on NDHWC ``x`` → same shape and dtype,
    differentiable. A CPU tensor takes
    :func:`instance_norm_leaky_relu_plain`; a CUDA tensor launches the
    kernel once or raises. The backward is the plain version's."""
    return _FusedNormAct.apply(x, scale, bias, negative_slope, epsilon)


fused_instance_norm_leaky_relu.launches = 0
