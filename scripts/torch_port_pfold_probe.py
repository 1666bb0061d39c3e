#!/usr/bin/env python3
"""The packed conv (K1) beside the pfold conv (K7a/K7b) at the generator's
stage shapes: the port of ``scripts/pfold_probe.py``.

  python scripts/torch_port_pfold_probe.py [--iters 10] [--device cuda]

For each case (B 8, bf16, (D, H = W, Cin, Cout)): K1's forward against
K7a's, the forward + backward of a sum loss through each (K1, its dgrad and
K2 against K7a, its dgrad and K7b), the max |diff| between K7a's output
and K1's in NDHWC (K7a runs K1's wgmma kernel on the folded layout: 0), and
the max |diff| between K7b's dW and the plain weight gradient for one
random dy beside K2's bound there, 16·sqrt(L)·2^-24·max|ref| with L K7b's
chain, and the max |diff| between K7b's dW and that of the ``mma.sync``
loop K7b ran before (``conv3x3_wgrad_mma`` on the packed operands), within
the sum of the two kernels' bounds (on the CPU the plain version is K7b
itself and the loop's: bounds 0). Beside the JAX
probe's four cases, the halo forms (K5 against K7a's halo form, and their
gradients) at a D_local-32 shard of the upcat case. Then the relayouts at
8 × 64³: ``pack_hw`` at 24 channels and ``fold4_pack`` at 24 and 96. Times
are CUDA-event ms per call after two warm-up calls (on ``--device cpu``,
host-clock ms of the plain versions, a rehearsal and no measurement of the
card). Prints one JSON line per row and the launch counts of the run.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from unet_bssfp_tpu_torch.ops import kernels as K  # noqa: E402
from unet_bssfp_tpu_torch.ops.kernels.pfold import _to_folded  # noqa: E402

B = 8
# (name, D, H = W, Cin, Cout, halo): a halo case's D is the shard's output
# slices; its input carries one more slice per side.
CASES = (("conv0 24->32 @64^3", 64, 64, 24, 32, False),
         ("stage 32->32 @64^3", 64, 64, 32, 32, False),
         ("upcat 96->32 @64^3", 64, 64, 96, 32, False),
         ("vol 24->32 @96x128^2", 96, 128, 24, 32, False),
         ("upcat 96->32 @64^3, D_local 32 halo", 32, 64, 96, 32, True))
RELAYOUTS = (("pack 24ch", 24, False), ("fold4 24ch", 24, True), ("fold4 96ch", 96, True))


def time_ms(fn, iters: int, device) -> float:
    """ms per call over ``iters`` calls after two warm-ups: CUDA events on a
    card, the host clock on the CPU."""
    fn()
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def _fwd_bwd(conv, a, w, bias, dim):
    """Forward + backward of ``sum(conv(a, w, bias))`` into all three."""
    a, w, bias = (t.detach().requires_grad_(True) for t in (a, w, bias))
    conv(a, w, bias, dim).float().sum().backward()
    return a.grad


def run_case(device, name, d, hw, cin, cout, halo, iters):
    g = torch.Generator(device=device).manual_seed(cin * 1000 + d)
    dd = d + 2 * halo
    x = torch.randn(B, dd, hw, hw, cin, device=device, generator=g).bfloat16()
    w = torch.randn(3, 3, 3, cin, cout, device=device, generator=g) * 0.1
    bias = torch.randn(cout, device=device, generator=g) * 0.1
    xk, xf = K.pack_hw(x), K.fold4_pack(x)
    del x
    packed = K.conv3x3_packed_halo if halo else K.conv3x3_packed
    pfold = K.conv3x3_pfold_halo if halo else K.conv3x3_pfold
    w4 = hw // 4
    t_pk = time_ms(lambda: packed(xk, w, bias, hw), iters, device)
    t_pf = time_ms(lambda: pfold(xf, w, bias, w4), iters, device)
    tb_pk = time_ms(lambda: _fwd_bwd(packed, xk, w, bias, hw), iters, device)
    tb_pf = time_ms(lambda: _fwd_bwd(pfold, xf, w, bias, w4), iters, device)
    y_pk = K.unpack_hw(packed(xk, w, bias, hw), hw)
    y_pf = K.unfold4_unpack(pfold(xf, w, bias, w4), w4)
    err = float((y_pk.float() - y_pf.float()).abs().max())
    dyk = torch.randn(B, d, cout, hw * hw, device=device, generator=g).bfloat16()
    dyf = _to_folded(dyk, hw)
    wgrad = K.conv3x3_pfold_wgrad_halo if halo else K.conv3x3_pfold_wgrad
    wplain = K.conv3x3_wgrad_halo_plain if halo else K.conv3x3_wgrad_plain
    dw_ref = wplain(xk, dyk, hw)
    dw_pf = wgrad(xf, dyf, w4)
    err_dw = float((dw_pf - dw_ref).abs().max())
    err_loop = float((dw_pf - K.conv3x3_wgrad_mma(xk, dyk, hw, int(halo))).abs().max())
    atol_dw = atol_loop = 0.0
    if device.type == "cuda":
        ulp = 16 * 2 ** -24 * float(dw_ref.abs().max())
        atol_dw = math.sqrt(K.conv3x3_pfold_wgrad_chain(xf, dyf, w4)) * ulp
        atol_loop = atol_dw + math.sqrt(K.conv3x3_wgrad_mma_chain(xk, dyk, hw)) * ulp
    row = {"case": name, "shape": [B, d, hw, hw, cin, cout], "halo": halo,
           "packed_fwd_ms": t_pk, "pfold_fwd_ms": t_pf, "packed_fb_ms": tb_pk,
           "pfold_fb_ms": tb_pf, "max_abs_diff": err, "wgrad_max_abs_err": err_dw,
           "wgrad_atol": atol_dw, "wgrad_loop_max_abs_diff": err_loop,
           "wgrad_loop_atol": atol_loop}
    print(f"{name}: packed fwd {t_pk:7.3f}  pfold fwd {t_pf:7.3f} ({t_pk / t_pf:4.2f}x)   "
          f"f+b {tb_pk:7.3f} vs {tb_pf:7.3f} ({tb_pk / tb_pf:4.2f}x)   maxdiff {err:.2e}, "
          f"dW {err_dw:.2e} (bound {atol_dw:.2e})",
          flush=True)
    return row


def run_relayout(device, name, c, fold, iters):
    x = torch.randn(B, 64, 64, 64, c, device=device).bfloat16()
    t = time_ms((lambda: K.fold4_pack(x)) if fold else (lambda: K.pack_hw(x)), iters, device)
    print(f"{name}: {t:7.3f} ms", flush=True)
    return {"case": name, "shape": [B, 64, 64, 64, c], "ms": t}


def run(device="cuda", cases=CASES, relayouts=RELAYOUTS, iters: int = 10):
    """Every case and relayout on ``device``: (rows, the launch counts of the
    run). The counters are reset first."""
    device = torch.device(device)
    K.reset_launches()
    rows = []
    for case in cases:
        rows.append(run_case(device, *case, iters))
        if device.type == "cuda":
            torch.cuda.empty_cache()
    for relayout in relayouts:
        rows.append(run_relayout(device, *relayout, iters))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return rows, K.launches()


def expected_launches(cases=CASES, relayouts=RELAYOUTS, iters: int = 10) -> dict:
    """The launches :func:`run` makes on a card: per case two packs (the
    input packed and folded), each forward ``iters`` + 2 timed times and
    once more (K7a against K1), each forward + backward ``iters`` + 2 times
    (forward, dgrad, wgrad), two unpacks, K7b once more against the plain
    version and one launch of the wgrad's ``mma.sync`` loop; per relayout
    ``iters`` + 2 packs. Every launch of the cases is
    one of the wgmma kernels: ``*_mma_routed`` stay 0."""
    n = iters + 2
    out = dict.fromkeys(K.launches(), 0)
    for *_, halo in cases:
        names = (("conv3x3_packed_halo", "conv3x3_packed_halo_dgrad", "conv3x3_wgrad_halo",
                  "conv3x3_pfold_halo", "conv3x3_pfold_halo_dgrad", "conv3x3_pfold_wgrad_halo")
                 if halo else
                 ("conv3x3_packed", "conv3x3_packed_dgrad", "conv3x3_wgrad",
                  "conv3x3_pfold", "conv3x3_pfold_dgrad", "conv3x3_pfold_wgrad"))
        for i, name in enumerate(names):
            out[name] += 2 * n + 1 if i % 3 == 0 else n
        out[names[5]] += 1
        out["conv3x3_wgrad_mma"] += 1
        out["pack_hw"] += 2
        out["unpack_hw"] += 2
    out["pack_hw"] += n * len(relayouts)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("torch_port_pfold_probe: no CUDA device", file=sys.stderr)
        return 2
    if args.device.startswith("cuda"):
        print(f"device: {torch.cuda.get_device_name(torch.device(args.device))}", flush=True)
    rows, counts = run(args.device, iters=args.iters)
    for row in rows:
        print(json.dumps(row))
    print(json.dumps({"launches": counts}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
