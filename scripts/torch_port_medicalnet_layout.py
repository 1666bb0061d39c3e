#!/usr/bin/env python3
"""MedicalNet on the card in the two layouts cuDNN takes for 3-D convs:
NCDHW (``torch.contiguous_format``) and NDHWC (``torch.channels_last_3d``),
at the shapes of the port's two callers, in turns (A B B A).

  python scripts/torch_port_medicalnet_layout.py [--iters 5]

- FID: ``make_medicalnet_fid_fn`` on one (96, 128, 128, 6) prediction and
  its target (2 × 6 slabs), f32, TF32 off, no gradient: what ``run_test``
  takes per test volume.
- Perceptual: ``perceptual_distance`` forward and backward (through
  ``pred``) on 8 × 64³ × 6 patches (48 slabs a side), bf16, no chunk: what
  the default GAN step takes.

Each run builds the net afresh in its layout (``models/medicalnet.py:
MEMORY_FORMAT``). Prints one JSON line: the card's name and power limit, ms
per call (CUDA events, after two warm-ups) and peak MiB of each run, and
each layout's median. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this needs a card", file=sys.stderr)
        return 2
    from unet_bssfp_tpu_torch.models import medicalnet as mn
    from unet_bssfp_tpu_torch.train.steps import make_medicalnet_fid_fn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    g = torch.Generator(device="cuda").manual_seed(0)
    y = torch.rand(1, 96, 128, 128, 6, device="cuda", generator=g)
    y_hat = y + 0.1 * torch.randn(y.shape, device="cuda", generator=g)
    t = torch.rand(8, 64, 64, 64, 6, device="cuda", generator=g)
    p = t + 0.1 * torch.randn(t.shape, device="cuda", generator=g)
    formats = {"ncdhw": torch.contiguous_format, "ndhwc": torch.channels_last_3d}

    def fid_case():
        fid_fn = make_medicalnet_fid_fn(mn.init_medicalnet(0, device="cuda"))
        return lambda: fid_fn(y_hat, y)

    def perceptual_case():
        net = mn.init_medicalnet(0, dtype=torch.bfloat16, device="cuda")

        def run():
            pred = p.detach().requires_grad_(True)
            mn.perceptual_distance(net, pred, t).backward()
        return run

    def timed(fn):
        fn()
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.iters, torch.cuda.max_memory_allocated() / 2 ** 20

    out = {"card": card, "torch": torch.__version__, "iters": args.iters}
    for case, make in (("fid_f32_1x96x128x128x6", fid_case),
                       ("perceptual_bf16_8x64x64x64x6", perceptual_case)):
        runs = []
        for name in ("ncdhw", "ndhwc", "ndhwc", "ncdhw"):
            mn.MEMORY_FORMAT = formats[name]
            ms, peak = timed(make())
            runs.append({"layout": name, "ms": ms, "peak_mib": peak})
            torch.cuda.empty_cache()
        out[case] = {"runs": runs, **{f"{n}_median_ms": statistics.median(
            r["ms"] for r in runs if r["layout"] == n) for n in formats}}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
