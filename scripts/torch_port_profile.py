#!/usr/bin/env python3
"""Where the time of the port's serving path or training step goes, on one
CUDA device.

  python scripts/torch_port_profile.py [--whole-volume] [--use-pallas] [--mesh 1,2 [--devices cuda:0,cuda:1]]
  python scripts/torch_port_profile.py --train [--use-pallas]

Serving: one (96, 128, 128, 24) pc-bSSFP volume with the full-width
generator (bf16, packed, seeded random weights). ``--train``: full-width GAN
training steps of the default config (bf16, packed, batch 8 × 64³) from
``create_gan_state``. ``--mesh DATA,SPACE`` serves through a (data, space)
mesh (the halo exchange, K5 and the norms' moments summed over ``space``)
whose positions all lie on ``cuda:0``, or go to ``--devices cuda:0,cuda:1``
in turn. Times ``--reps`` of them on the host's clock after three warm-ups,
then runs ``--reps`` more under ``torch.profiler`` and prints the unprofiled
time and the device time per volume or step, by kernel name
and grouped by layer (the port's kernels, cuDNN, ATen's elementwise,
reduction and copy kernels, the optimizer), plus the device's busy share of
the profiled window and the number of kernels launched. Writes the tables to
``perf_out/torch_port_profile_<mode>.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# (group, substrings of the kernel name), first match wins.
GROUPS = (
    ("K4 norm_act", ("norm_act_kernel",)),
    ("K1/K5 conv3x3_packed (fwd + dgrad, SAME and halo)", ("conv3x3_wgmma_",
                                                            "conv3x3_packed_")),
    ("K2 conv3x3_wgrad", ("conv3x3_wgrad_",)),
    ("K3 transposes", ("transpose_kernel",)),
    ("cuDNN/cuBLAS convs and GEMMs", ("xmma", "cudnn", "nvjet", "gemm", "cutlass",
                                      "conv", "wgrad", "dgrad")),
    ("optimizer (AdamW)", ("multi_tensor", "adam", "foreach")),
    ("ATen reductions", ("reduce_kernel", "Reduce")),
    ("pools and scatters", ("max_pool", "scatter", "argmax")),
    ("ATen dtype/layout copies", ("copy", "Cat", "Memcpy", "Memset", "Fill")),
    ("ATen elementwise", ("elementwise",)),
)


def group_of(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--whole-volume", action="store_true")
    parser.add_argument("--use-pallas", action="store_true")
    parser.add_argument("--train", action="store_true",
                        help="profile training steps instead of serving")
    parser.add_argument("--mesh", default=None, metavar="DATA,SPACE",
                        help="serve through a mesh over --devices")
    parser.add_argument("--devices", default="cuda:0",
                        help="the mesh's devices, taken in turn (default: every "
                             "position on cuda:0; cuda:0,cuda:1 for two cards)")
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args()
    if args.mesh and (args.train or args.use_pallas):
        parser.error("--mesh profiles serving without --use-pallas")

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_port_profile: no CUDA device", file=sys.stderr)
        return 2
    from unet_bssfp_tpu_torch import weights
    from unet_bssfp_tpu_torch.config import Config
    from unet_bssfp_tpu_torch.eval.inference import predict_volume
    from unet_bssfp_tpu_torch.parallel.mesh import make_mesh
    from unet_bssfp_tpu_torch.train.state import build_models, create_gan_state
    from unet_bssfp_tpu_torch.train.steps import make_predict_fn, make_train_step

    cfg = Config()
    mcfg = dataclasses.replace(cfg.model, use_pallas=args.use_pallas)
    g = torch.Generator().manual_seed(0)
    if args.train:
        state = create_gan_state(0, "pc-bssfp", mcfg, cfg.train, "cuda")
        step = make_train_step(state.gen, state.disc, cfg.train)
        n, p = cfg.data.batch_size, cfg.data.patch_size
        x = torch.rand((n, p, p, p, 24), generator=g).cuda()
        y = torch.rand((n, p, p, p, 6), generator=g).cuda()

        def run():
            step(state, x, y)
    else:
        mesh = None
        if args.mesh:
            mesh = make_mesh(args.devices.split(","), ("data", "space"),
                             tuple(int(p) for p in args.mesh.split(",")))
        gen, _ = build_models("pc-bssfp", mcfg, "cuda")
        sd = weights.random_state_dict(gen, 0)
        gen, _ = build_models("pc-bssfp", mcfg, "cuda:0", state_dict=sd, mesh=mesh)
        fn = make_predict_fn(gen, mesh)
        vol = torch.randn(tuple(cfg.data.volume_shape) + (24,), generator=g).cuda()

        def run():
            predict_volume(fn, vol, patch_size=cfg.data.patch_size,
                           whole_volume=args.whole_volume, mesh=mesh)

    def sync():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

    for _ in range(3):
        run()
    sync()
    clean = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        run()
        sync()
        clean.append((time.perf_counter() - t0) * 1e3)
    clean_ms = statistics.median(clean)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(args.reps):
            run()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.reps

    rows = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host-side op events repeat their kernels' time
        dev_us = ev.self_device_time_total
        if dev_us > 0:
            rows.append({"name": ev.key, "group": group_of(ev.key),
                         "calls_per_rep": ev.count / args.reps,
                         "ms_per_rep": dev_us / 1e3 / args.reps})
    rows.sort(key=lambda r: -r["ms_per_rep"])
    busy = sum(r["ms_per_rep"] for r in rows)
    groups = {}
    for r in rows:
        groups[r["group"]] = groups.get(r["group"], 0.0) + r["ms_per_rep"]
    mode = "train" if args.train else ("whole" if args.whole_volume else "patch")
    if args.mesh:
        mode += "_mesh" + args.mesh.replace(",", "x")
        if args.devices != "cuda:0":
            mode += f"_{len(args.devices.split(','))}cards"
    unit = "step" if args.train else "volume"
    launched = sum(r["calls_per_rep"] for r in rows)
    print(f"{torch.cuda.get_device_name(0)}; mode {mode}, use_pallas "
          f"{args.use_pallas}: {clean_ms:.3f} ms/{unit} unprofiled (median of "
          f"{args.reps}); profiled: wall {wall_ms:.3f} ms/{unit}, device busy "
          f"{busy:.3f} ms/{unit} ({100 * busy / wall_ms:.1f} %; summed over the "
          f"cards where the mesh has several), {launched:.0f} kernels launched per {unit}")
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"{ms:9.4f} ms  {group}")
    for r in rows[:25]:
        print(f"{r['ms_per_rep']:9.4f} ms  {r['calls_per_rep']:6.1f}x  {r['name'][:110]}")
    os.makedirs("perf_out", exist_ok=True)
    out = Path("perf_out") / f"torch_port_profile_{mode}{'_pallas' if args.use_pallas else ''}.json"
    out.write_text(json.dumps({"device": torch.cuda.get_device_name(0), "mode": mode,
                               "use_pallas": args.use_pallas, "unit": unit,
                               "unprofiled_ms": clean_ms, "unprofiled_ms_all": clean,
                               "wall_ms": wall_ms, "busy_ms": busy,
                               "kernels_launched": launched, "groups": groups,
                               "kernels": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
