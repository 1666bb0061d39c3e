"""K4: fused InstanceNorm(affine) + LeakyReLU on NDHWC, in Triton.

Replaces ``unet_bssfp_tpu/ops/pallas/fused_norm_act.py::
fused_instance_norm_leaky_relu`` (``_kernel``). The TPU kernel loads one
(sample, channel block) volume into VMEM and does everything there; a
Hopper block has no room for a 32³×64 volume, and blocks cannot carry a sum
from one to the next, so the work is split:

1. ``_partial_sum``: each program sums a chunk of rows (spatial positions)
   for a block of channels, in f32.
2. ``_partial_m2``: each program reads all chunk sums of its channels to
   get the mean, then sums ``(x - mean)²`` over its chunk (the centred second
   moment, as ``jnp.var`` and the TPU kernel compute it).
3. ``_apply``: each program derives mean and variance from the partials and
   writes ``leaky_relu((x - mean)·rsqrt(var + eps)·scale + bias)`` in the
   input dtype.

Where a sample has at most ``_SINGLE_MAX_ROWS`` spatial positions (the
8³/4³ stages), ``_single`` runs the three phases in one program per
(sample, channel block) instead: one launch instead of three.

What bounds it on an H100: memory. It does a few operations per element and
reads the input three times and writes it once (4 passes against the 2 a
single fused pass needs). The stage tensors (≤ 33.5 MB in bf16, down_1
in patch mode) fit the 50 MB L2, so the re-reads are mostly served from L2.
Rows are the contiguous channel-minor NDHWC rows, so every load and store
is coalesced along C.

:func:`instance_norm_leaky_relu_plain` is the same function in plain
PyTorch: the CPU path, the kernel's reference, and (recomputed under
autograd) the backward, as in the JAX package.
"""

from __future__ import annotations

import torch

_DTYPES = (torch.float32, torch.bfloat16)
_BLOCK_ROWS = 64
_TARGET_PROGRAMS = 1024
# Up to this many spatial positions per sample, one program per (sample,
# channel block) runs all three phases (one launch instead of three).
_SINGLE_MAX_ROWS = 512


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


_KERNELS = None


def _kernels():
    """Define the Triton kernels on first use (this module is imported on
    machines without Triton)."""
    global _KERNELS
    if _KERNELS is not None:
        return _KERNELS
    import triton
    import triton.language as tl

    @triton.jit
    def _rows(n, start, r0, cols, cmask, S, C, BLOCK_ROWS: tl.constexpr):
        """Offsets and mask of one (BLOCK_ROWS, BLOCK_C) tile of sample n."""
        r = start + r0 + tl.arange(0, BLOCK_ROWS)
        m = (r < S)[:, None] & cmask[None, :]
        off = n.to(tl.int64) * S * C + r.to(tl.int64)[:, None] * C + cols[None, :]
        return off, m

    @triton.jit
    def _chunk_sum(x_ptr, n, start, CHUNK, cols, cmask, S, C,
                   BLOCK_ROWS: tl.constexpr, BLOCK_C: tl.constexpr):
        acc = tl.zeros((BLOCK_ROWS, BLOCK_C), dtype=tl.float32)
        for r0 in range(0, CHUNK, BLOCK_ROWS):
            off, m = _rows(n, start, r0, cols, cmask, S, C, BLOCK_ROWS)
            acc += tl.load(x_ptr + off, mask=m, other=0.0).to(tl.float32)
        return tl.sum(acc, axis=0)

    @triton.jit
    def _chunk_m2(x_ptr, n, start, CHUNK, cols, cmask, S, C, mean,
                  BLOCK_ROWS: tl.constexpr, BLOCK_C: tl.constexpr):
        acc = tl.zeros((BLOCK_ROWS, BLOCK_C), dtype=tl.float32)
        for r0 in range(0, CHUNK, BLOCK_ROWS):
            off, m = _rows(n, start, r0, cols, cmask, S, C, BLOCK_ROWS)
            v = tl.load(x_ptr + off, mask=m, other=0.0).to(tl.float32)
            dv = tl.where(m, v - mean[None, :], 0.0)
            acc += dv * dv
        return tl.sum(acc, axis=0)

    @triton.jit
    def _chunk_apply(x_ptr, y_ptr, n, start, CHUNK, cols, cmask, S, C, mean,
                     mul, shift, slope, BLOCK_ROWS: tl.constexpr):
        for r0 in range(0, CHUNK, BLOCK_ROWS):
            off, m = _rows(n, start, r0, cols, cmask, S, C, BLOCK_ROWS)
            v = tl.load(x_ptr + off, mask=m, other=0.0).to(tl.float32)
            yv = (v - mean[None, :]) * mul[None, :] + shift[None, :]
            yv = tl.where(yv >= 0, yv, slope * yv)
            tl.store(y_ptr + off, yv.to(y_ptr.dtype.element_ty), mask=m)

    @triton.jit
    def _mean_of(part_ptr, n, cols, cmask, S, C, NSPLIT,
                 SPLIT_P2: tl.constexpr):
        """Σ over the NSPLIT chunk partials of sample n, divided by S."""
        sps = tl.arange(0, SPLIT_P2)
        pm = (sps < NSPLIT)[:, None] & cmask[None, :]
        parts = tl.load(part_ptr + (n * NSPLIT + sps)[:, None] * C + cols[None, :],
                        mask=pm, other=0.0)
        return tl.sum(parts, axis=0) / S

    @triton.jit
    def _partial_sum(x_ptr, part_ptr, S, C, CHUNK, NSPLIT,
                     BLOCK_ROWS: tl.constexpr, BLOCK_C: tl.constexpr):
        n, sp = tl.program_id(0), tl.program_id(1)
        cols = tl.program_id(2) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        s1 = _chunk_sum(x_ptr, n, sp * CHUNK, CHUNK, cols, cmask, S, C,
                        BLOCK_ROWS, BLOCK_C)
        tl.store(part_ptr + (n * NSPLIT + sp) * C + cols, s1, mask=cmask)

    @triton.jit
    def _partial_m2(x_ptr, part_ptr, m2_ptr, S, C, CHUNK, NSPLIT,
                    BLOCK_ROWS: tl.constexpr, BLOCK_C: tl.constexpr,
                    SPLIT_P2: tl.constexpr):
        n, sp = tl.program_id(0), tl.program_id(1)
        cols = tl.program_id(2) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        mean = _mean_of(part_ptr, n, cols, cmask, S, C, NSPLIT, SPLIT_P2)
        m2 = _chunk_m2(x_ptr, n, sp * CHUNK, CHUNK, cols, cmask, S, C, mean,
                       BLOCK_ROWS, BLOCK_C)
        tl.store(m2_ptr + (n * NSPLIT + sp) * C + cols, m2, mask=cmask)

    @triton.jit
    def _apply(x_ptr, part_ptr, m2_ptr, scale_ptr, bias_ptr, y_ptr,
               S, C, CHUNK, NSPLIT, slope, eps,
               BLOCK_ROWS: tl.constexpr, BLOCK_C: tl.constexpr,
               SPLIT_P2: tl.constexpr):
        n, sp = tl.program_id(0), tl.program_id(1)
        cols = tl.program_id(2) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        mean = _mean_of(part_ptr, n, cols, cmask, S, C, NSPLIT, SPLIT_P2)
        var = _mean_of(m2_ptr, n, cols, cmask, S, C, NSPLIT, SPLIT_P2)
        mul = tl.rsqrt(var + eps) * tl.load(scale_ptr + cols, mask=cmask, other=1.0)
        shift = tl.load(bias_ptr + cols, mask=cmask, other=0.0)
        _chunk_apply(x_ptr, y_ptr, n, sp * CHUNK, CHUNK, cols, cmask, S, C,
                     mean, mul, shift, slope, BLOCK_ROWS)

    @triton.jit
    def _single(x_ptr, scale_ptr, bias_ptr, y_ptr, S, C, slope, eps,
                BLOCK_ROWS: tl.constexpr, BLOCK_C: tl.constexpr):
        """All three phases in one program per (sample, channel block): the
        small-volume stages, where three launches would cost more than the
        work."""
        n = tl.program_id(0)
        cols = tl.program_id(2) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        mean = _chunk_sum(x_ptr, n, 0, S, cols, cmask, S, C,
                          BLOCK_ROWS, BLOCK_C) / S
        var = _chunk_m2(x_ptr, n, 0, S, cols, cmask, S, C, mean,
                        BLOCK_ROWS, BLOCK_C) / S
        mul = tl.rsqrt(var + eps) * tl.load(scale_ptr + cols, mask=cmask, other=1.0)
        shift = tl.load(bias_ptr + cols, mask=cmask, other=0.0)
        _chunk_apply(x_ptr, y_ptr, n, 0, S, cols, cmask, S, C, mean, mul,
                     shift, slope, BLOCK_ROWS)

    _KERNELS = (triton, _partial_sum, _partial_m2, _apply, _single)
    return _KERNELS


def _split(n: int, s: int, c_blocks: int):
    """(rows per program, number of row chunks): enough programs to fill the
    card, every chunk a whole number of row blocks."""
    def cdiv(a, b):
        return -(-a // b)

    nsplit = min(cdiv(s, _BLOCK_ROWS),
                 max(1, cdiv(_TARGET_PROGRAMS, n * c_blocks)))
    chunk = cdiv(cdiv(s, nsplit), _BLOCK_ROWS) * _BLOCK_ROWS
    return chunk, cdiv(s, chunk)


def _norm_act_fwd(x, scale, bias, negative_slope, epsilon):
    """The Triton kernels (CUDA) or the plain version (CPU); no autograd."""
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
    triton, k_sum, k_m2, k_apply, k_single = _kernels()
    s = x.numel() // (n * c)
    block_c = min(triton.next_power_of_2(c), 128)
    c_blocks = -(-c // block_c)
    y = torch.empty_like(x)
    g = scale.detach().float().contiguous()
    b = bias.detach().float().contiguous()
    if s <= _SINGLE_MAX_ROWS:
        with torch.cuda.device(x.device):
            k_single[(n, 1, c_blocks)](x, g, b, y, s, c, float(negative_slope),
                                       float(epsilon), BLOCK_ROWS=_BLOCK_ROWS,
                                       BLOCK_C=block_c)
        fused_instance_norm_leaky_relu.launches += 1
        return y
    chunk, nsplit = _split(n, s, c_blocks)
    split_p2 = triton.next_power_of_2(nsplit)
    part = torch.empty((n, nsplit, c), dtype=torch.float32, device=x.device)
    m2 = torch.empty_like(part)
    grid = (n, nsplit, c_blocks)
    with torch.cuda.device(x.device):
        k_sum[grid](x, part, s, c, chunk, nsplit,
                    BLOCK_ROWS=_BLOCK_ROWS, BLOCK_C=block_c)
        k_m2[grid](x, part, m2, s, c, chunk, nsplit,
                   BLOCK_ROWS=_BLOCK_ROWS, BLOCK_C=block_c, SPLIT_P2=split_p2)
        k_apply[grid](x, part, m2, g, b, y, s, c, chunk, nsplit,
                      float(negative_slope), float(epsilon),
                      BLOCK_ROWS=_BLOCK_ROWS, BLOCK_C=block_c,
                      SPLIT_P2=split_p2)
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
    Triton kernels or raises. The backward is the plain version's."""
    return _FusedNormAct.apply(x, scale, bias, negative_slope, epsilon)


fused_instance_norm_leaky_relu.launches = 0
