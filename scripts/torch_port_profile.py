#!/usr/bin/env python3
"""Where the time of the port's serving path goes, on one CUDA device.

  python scripts/torch_port_profile.py [--whole-volume] [--use-pallas]

Serves one (96, 128, 128, 24) pc-bSSFP volume with the full-width generator
(bf16, packed, seeded random weights) under ``torch.profiler`` and prints
the device time by kernel name, grouped into the port's kernels and the
library's, plus the device's busy share of the profiled window. Writes the
table to ``perf_out/torch_port_profile_<mode>.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--whole-volume", action="store_true")
    parser.add_argument("--use-pallas", action="store_true")
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_port_profile: no CUDA device", file=sys.stderr)
        return 2
    from unet_bssfp_tpu_torch import weights
    from unet_bssfp_tpu_torch.config import Config
    from unet_bssfp_tpu_torch.eval.inference import predict_volume
    from unet_bssfp_tpu_torch.train.state import build_models
    from unet_bssfp_tpu_torch.train.steps import make_predict_fn

    cfg = Config()
    mcfg = dataclasses.replace(cfg.model, use_pallas=args.use_pallas)
    gen = build_models("pc-bssfp", mcfg, "cuda")
    gen.load_state_dict(weights.random_state_dict(gen, 0))
    fn = make_predict_fn(gen)
    g = torch.Generator().manual_seed(0)
    vol = torch.randn(tuple(cfg.data.volume_shape) + (24,), generator=g).cuda()

    def serve():
        predict_volume(fn, vol, patch_size=cfg.data.patch_size,
                       whole_volume=args.whole_volume)

    for _ in range(3):
        serve()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(args.reps):
            serve()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.reps

    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host-side op events repeat their kernels' time
        dev_us = ev.self_device_time_total
        if dev_us > 0:
            rows.append({"name": ev.key, "calls_per_volume": ev.count / args.reps,
                         "ms_per_volume": dev_us / 1e3 / args.reps})
    rows.sort(key=lambda r: -r["ms_per_volume"])
    busy = sum(r["ms_per_volume"] for r in rows)
    mode = "whole" if args.whole_volume else "patch"
    print(f"{torch.cuda.get_device_name(0)}; mode {mode}, use_pallas "
          f"{args.use_pallas}: wall {wall_ms:.3f} ms/volume, device busy "
          f"{busy:.3f} ms/volume ({100 * busy / wall_ms:.1f} %)")
    for r in rows[:25]:
        print(f"{r['ms_per_volume']:9.4f} ms  {r['calls_per_volume']:6.1f}x  {r['name'][:110]}")
    os.makedirs("perf_out", exist_ok=True)
    out = Path("perf_out") / f"torch_port_profile_{mode}{'_pallas' if args.use_pallas else ''}.json"
    out.write_text(json.dumps({"device": torch.cuda.get_device_name(0), "mode": mode,
                               "use_pallas": args.use_pallas, "wall_ms": wall_ms,
                               "busy_ms": busy, "kernels": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
