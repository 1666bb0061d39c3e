#!/usr/bin/env python3
"""K10 (``ops/kernels/packed_norm_act.py``) on the card against its plain
chain, at the packed stages' shapes, with its times beside its bound.

  python scripts/torch_port_norm_act_times.py [--cases gan-train serve-eval ...]
      [--iters 10]

Each case makes a packed conv output (bf16, per-channel offsets and
spreads), the norm's affine, the slope and, in train mode, one dropout draw
(rate 0.05, a seeded generator), then:
- holds the kernels' output and, where a gradient is taken, dx, dscale,
  dbias (and PReLU's dslope) against the plain chain in f32 on the card,
  each of the two measured against the plain chain in f64 on the card: the
  kernel's error may not pass twice the plain f32 chain's, or a floor of one
  rounding of the result's dtype at its largest magnitude (bf16 2^-8, f32
  2^-20 of max|ref|: another summation order of the same f32 terms);
- checks that a rerun gives equal bits (forward and backward) and that a
  call is one forward and one backward launch of the wrappers;
- times (CUDA events, 10 calls after 2) the forward and the backward
  kernels, the dropout draw, the plain chain's forward (``plain_fwd_ms``)
  and forward and backward (``plain_ms``), and the same of the library
  yardstick ``F.instance_norm`` + ``F.dropout`` (its own draw) +
  ``F.leaky_relu`` (timed only); the kernels' device ms under the
  profiler; the bound: bytes
  at 3.35 TB/s (forward 2·in + 4 (draw) + 4 (its write) + out + 1 (mask)
  bytes an element in train mode, 2·in + out in eval; backward 2·(in + out
  + 1) + in).

Prints one JSON line a case and ``{"ok": ...}`` last. Needs a card.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

HBM_BYTES_PER_S = 3.35e12
RATE = 0.05
# name: (shape (B, D, C, H·wdim), wdim, wguard, prelu, train, dtype, out dtype)
CASES = {
    "gan-train": ((16, 64, 32, 4096), 64, 0, False, True, "bfloat16", "bfloat16"),
    "serve-eval": ((32, 64, 32, 4096), 64, 0, False, False, "bfloat16", "bfloat16"),
    "ms-prelu-48": ((8, 64, 48, 4096), 64, 0, True, True, "bfloat16", "bfloat16"),
    "ms-prelu-24": ((8, 64, 24, 4096), 64, 0, True, True, "bfloat16", "bfloat16"),
    "whole-eval": ((1, 96, 32, 16384), 128, 0, False, False, "bfloat16", "bfloat16"),
    "gan-train-wguard": ((16, 64, 32, 64 * 66), 66, 2, False, True, "bfloat16", "bfloat16"),
    "f32-train": ((4, 32, 32, 1024), 32, 0, True, True, "float32", "float32"),
    "odd-vec1": ((2, 3, 5, 6 * 7), 7, 1, True, True, "bfloat16", "float32"),
}


def time_ms(torch, fn, iters: int) -> float:
    fn()
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, keys, iters: int = 10):
    """Device ms a call of the kernels whose names hold each of ``keys``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    return {key: sum(getattr(e, "device_time_total", 0) for e in events if key in e.key)
            / 1e3 / iters for key in keys}


def operands(torch, shape, wdim, prelu, train, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    b, d, c, lanes = shape
    off = torch.randn(1, 1, c, 1, device="cuda", generator=g) * 2
    spread = torch.rand(1, 1, c, 1, device="cuda", generator=g) + 0.5
    x = (torch.randn(shape, device="cuda", generator=g) * spread + off).to(dtype)
    scale = 1 + 0.2 * torch.randn(c, device="cuda", generator=g)
    bias = 0.2 * torch.randn(c, device="cuda", generator=g)
    slope = (0.1 + 0.05 * torch.randn(c, device="cuda", generator=g)) if prelu else 0.1
    draw = (torch.empty(shape, device="cuda").bernoulli_(1 - RATE, generator=g)
            if train else None)
    return x, scale, bias, slope, draw


def _err(got, ref):
    return float((got.double() - ref.double()).abs().max())


def run_case(torch, F, K, name, iters=10):
    shape, wdim, wguard, prelu, train, dt, odt = CASES[name]
    dtype, out_dtype = getattr(torch, dt), getattr(torch, odt)
    x, scale, bias, slope, draw = operands(torch, shape, wdim, prelu, train, dtype)
    keep = 1 - RATE  # as the blocks pass it: it scales only with a draw
    dy = torch.randn(shape, device="cuda").to(out_dtype) if train else None

    def call(fn, xs, req):
        leaves = [xs, scale, bias] + ([slope] if prelu else [])
        leaves = [t.detach().requires_grad_(req) for t in leaves]
        sl = leaves[3] if prelu else slope
        y = fn(leaves[0], leaves[1], leaves[2], sl, wdim, wguard, draw, keep, 1e-5, out_dtype)
        if not req:
            return [y.detach()]
        y.backward(dy.to(y.dtype))
        return [y.detach()] + [t.grad for t in leaves]

    K.reset_launches()
    got = call(K.packed_norm_act, x, train)
    torch.cuda.synchronize()
    launches = (K.packed_norm_act.launches, K.packed_norm_act_backward.launches)
    again = call(K.packed_norm_act, x, train)
    repeats = all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    plain = call(K.packed_norm_act_plain, x, train)
    ref = call(lambda *a: K.packed_norm_act_plain(*a[:9], torch.float64), x.double(), train)
    names = ["y", "dx", "dscale", "dbias", "dslope"]
    errs, ok = {}, repeats and launches == (1, int(train))
    for n, a, p, r in zip(names, got, plain, ref):
        floor = (2 ** -8 if a.dtype == torch.bfloat16 else 2 ** -20) * float(r.abs().max())
        ek, ep = _err(a, r), _err(p, r)
        errs[n] = {"kernel": ek, "plain": ep, "floor": floor}
        ok = ok and ek <= max(2 * ep, floor)
    del got, plain, ref

    n = x.numel()
    ib, ob = x.element_size(), torch.empty((), dtype=out_dtype).element_size()
    fwd_bytes = n * (2 * ib + ob + (4 + 4 + 1 if train else 0))
    bwd_bytes = n * (2 * (ib + ob + 1) + ib)
    row = dict(case=name, shape=list(shape), wguard=wguard, prelu=prelu, train=train,
               dtype=dt, out_dtype=odt, launches=launches, bit_identical_rerun=repeats,
               errors=errs,
               bound_fwd_ms=fwd_bytes / HBM_BYTES_PER_S * 1e3,
               bound_bwd_ms=bwd_bytes / HBM_BYTES_PER_S * 1e3 if train else None)
    if iters:
        pna = importlib.import_module("unet_bssfp_tpu_torch.ops.kernels.packed_norm_act")

        spec = pna._spec(x, slope, wdim, wguard, draw, keep, 1e-5, out_dtype)
        vec = slope if prelu else None
        fwd = lambda: pna._cuda_forward(x, scale, bias, vec, draw, spec, train)  # noqa: E731
        row["fwd_ms"] = time_ms(torch, fwd, iters)
        split = device_ms(torch, fwd, ("packed_stats", "packed_apply"))
        row["fwd_device_ms"], row["fwd_device_split"] = sum(split.values()) or None, split
        if train:
            _, mean, rstd, mask = fwd()
            bwd = lambda: pna.packed_norm_act_backward(  # noqa: E731
                dy, x, scale, bias, vec, mean, rstd, mask, spec, True, True)
            row["bwd_ms"] = time_ms(torch, bwd, iters)
            split = device_ms(torch, bwd, ("packed_bwd_sums", "packed_bwd_dx"))
            row["bwd_device_ms"], row["bwd_device_split"] = sum(split.values()) or None, split
            row["draw_ms"] = time_ms(torch, lambda: torch.empty(shape, device="cuda").bernoulli_(
                keep), iters)
        row["plain_fwd_ms"] = time_ms(torch, lambda: call(K.packed_norm_act_plain, x, False),
                                      iters)
        xn = x.transpose(1, 2)  # (B, C, D, L): the instance dims last

        def library(req):
            xi = xn.detach().requires_grad_(req)
            y = F.leaky_relu(F.dropout(F.instance_norm(xi, weight=scale, bias=bias, eps=1e-5),
                                       RATE, training=train), 0.1)
            if req:
                y.backward(dy.transpose(1, 2))

        row["library_fwd_ms"] = time_ms(torch, lambda: library(False), iters)
        if train:  # forward and backward
            row["plain_ms"] = time_ms(torch, lambda: call(K.packed_norm_act_plain, x, True),
                                      iters)
            row["library_ms"] = time_ms(torch, lambda: library(True), iters)
    row["ok"] = bool(ok)
    return row


def main() -> int:
    import torch
    import torch.nn.functional as F

    from unet_bssfp_tpu_torch.ops import kernels as K

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", nargs="+", choices=sorted(CASES), default=list(CASES))
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ok = True
    for name in args.cases:
        row = run_case(torch, F, K, name, args.iters)
        ok = ok and row["ok"]
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"ok": ok, "device": torch.cuda.get_device_name(0)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
