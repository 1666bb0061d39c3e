#!/usr/bin/env python3
"""Probes of the packed conv kernel on the card: the port of
``scripts/pallas_probe.py``.

  python scripts/torch_port_pallas_probe.py [--iters 10] [--device cuda]

1. K9a (``lane_roll``) against ``torch.roll``: the direction check.
2. A tiny conv, (1, 4, 4, 64, 3 → 4) f32: K1 against its plain version.
3. K9b at the conv0 shape (B 8, D 64, 64², 24 → 32, bf16): K1's wgmma
   kernel (``csrc/conv3x3_wgmma.cuh``) in its three modes (``fixed``: the
   products and the epilogue on one tile staged before the d walk;
   ``centre``: the full staging with every (kh, kw) tap unshifted; ``full``:
   K1 itself, bit for bit), each against its plain version, with CUDA-event
   ms per call beside K1's own entry point (``conv3x3_packed``) and the
   ``mma.sync`` loop K9b split before the wgmma kernel
   (``conv3x3_packed_mma``), and the shares of K1's time they imply: the
   products and epilogue ``fixed / full``, the staging (TMA waits,
   transpose, barrier, refill) ``1 - fixed / full``, the shifted descriptor
   addresses ``1 - centre / full``.

On ``--device cpu`` the plain versions run, host-clock timed: a rehearsal,
no measurement of the card. Prints one JSON line per row and the launch
counts of the run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from unet_bssfp_tpu_torch.ops import kernels as K  # noqa: E402
from scripts.torch_port_pfold_probe import time_ms  # noqa: E402

ABLATION = (8, 64, 64, 64, 24, 32)  # B, D, H, W, Cin, Cout
MODES = ("fixed", "centre", "full")


def probe_roll(device):
    x = torch.arange(8 * 128, dtype=torch.float32, device=device).reshape(8, 128)
    got = K.lane_roll(x, 1)
    same = bool(torch.equal(got, torch.roll(x, 1, 1)))
    rev = bool(torch.equal(got, torch.roll(x, -1, 1)))
    print(f"lane_roll(+1) == torch.roll(+1): {same}; == torch.roll(-1): {rev}", flush=True)
    return {"probe": "roll", "same_as_torch_roll_plus_1": same,
            "same_as_torch_roll_minus_1": rev}


def probe_tiny_conv(device):
    b, d, h, w, cin, cout = 1, 4, 4, 64, 3, 4
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(b, d, h, w, cin, device=device, generator=g) * 0.3
    wt = torch.randn(3, 3, 3, cin, cout, device=device, generator=g) * 0.3
    bias = torch.zeros(cout, device=device)
    xk = K.pack_hw(x)
    err = float((K.conv3x3_packed(xk, wt, bias, w)
                 - K.conv3x3_packed_plain(xk, wt, bias, w)).abs().max())
    print(f"tiny conv max|err| = {err:.3e}", flush=True)
    return {"probe": "tiny_conv", "shape": [b, d, h, w, cin, cout], "max_abs_err": err}


def probe_perf_ablation(device, iters: int, shape=ABLATION):
    b, d, h, w, cin, cout = shape
    g = torch.Generator(device=device).manual_seed(1)
    xk = torch.randn(b, d, cin, h * w, device=device, generator=g).bfloat16()
    wt = torch.randn(3, 3, 3, cin, cout, device=device, generator=g) / (27 * cin) ** 0.5
    bias = torch.randn(cout, device=device, generator=g) * 0.1
    k1_out = K.conv3x3_packed(xk, wt, bias, w)
    k1 = time_ms(lambda: K.conv3x3_packed(xk, wt, bias, w), iters, device)
    loop = time_ms(lambda: K.conv3x3_packed_mma(xk, wt, bias, w), iters, device)
    rows, ms = [], {}
    for mode in MODES:
        fn = K.PROBE_MODES[mode]
        ms[mode] = time_ms(lambda: fn(xk, wt, bias, w), iters, device)
        got = fn(xk, wt, bias, w)
        ref = K.conv3x3_probe_plain(xk, wt, bias, w, mode).float()
        err = float((got.float() - ref).abs().max())
        row = {"probe": "ablation", "mode": mode, "shape": list(shape), "ms": ms[mode],
               "k1_ms": k1, "loop_ms": loop, "max_abs_err": err,
               "ref_max_abs": float(ref.abs().max())}
        if mode == "full":
            row["bit_equal_to_k1"] = bool(torch.equal(got, k1_out))
        rows.append(row)
        print(f"ablation {mode:6s}: {ms[mode]:7.3f} ms (K1 {k1:7.3f}, the old loop {loop:7.3f}); "
              f"max|err| vs plain {err:.3e}"
              + (f"; bit-equal to K1 {row['bit_equal_to_k1']}" if mode == "full" else ""),
              flush=True)
    shares = {"products_epilogue": ms["fixed"] / ms["full"],
              "staging": 1 - ms["fixed"] / ms["full"], "shifts": 1 - ms["centre"] / ms["full"]}
    print(f"K1 split: products and epilogue {shares['products_epilogue']:.3f}, staging "
          f"{shares['staging']:.3f}, shifted addresses {shares['shifts']:.3f}", flush=True)
    rows.append({"probe": "ablation_shares", **shares})
    return rows


def run(device="cuda", iters: int = 10, ablation=ABLATION):
    """The three probes on ``device``: (rows, the launch counts of the run).
    The counters are reset first."""
    device = torch.device(device)
    K.reset_launches()
    rows = [probe_roll(device), probe_tiny_conv(device)]
    rows += probe_perf_ablation(device, iters, ablation)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return rows, K.launches()


def expected_launches(iters: int = 10) -> dict:
    """The launches :func:`run` makes on a card: one roll; the tiny conv's
    pack and conv; K1 once for the bit-equality anchor and ``iters`` + 2
    times timed, the old loop ``iters`` + 2 times; each mode ``iters`` + 2
    timed and 1 checked times; no routed launch."""
    n = iters + 2
    out = dict.fromkeys(K.launches(), 0)
    out.update(lane_roll=1, pack_hw=1, conv3x3_packed=2 + n, conv3x3_packed_mma=n)
    for mode in MODES:
        out[K.PROBE_MODES[mode].__name__] = n + 1
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("torch_port_pallas_probe: no CUDA device", file=sys.stderr)
        return 2
    if args.device.startswith("cuda"):
        print(f"device: {torch.cuda.get_device_name(torch.device(args.device))}", flush=True)
    rows, counts = run(args.device, args.iters)
    for row in rows:
        print(json.dumps(row))
    print(json.dumps({"launches": counts}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
