#!/usr/bin/env python3
"""K4 (fused InstanceNorm + LeakyReLU) and K8 (scalar maps) timed on the
card, for a comparison of two checkouts in one call.

  python scripts/torch_port_norm_maps_times.py [--root DIR] [--tag NAME]

Imports ``unet_bssfp_tpu_torch`` from ``--root`` (default: this checkout;
another one, e.g. the parent's ``git archive`` under ``perf_out/``, to time
its kernels), builds its kernels there and prints one JSON line per case:
- K4 at the 8 plain-layer stage shapes of serving under ``use_pallas``
  (patch B 8 and whole-volume B 1; C 64 … 512) in bf16 and f32: time per
  call (CUDA events around 50 back-to-back calls, host work included) and
  device time per call (``torch.profiler``: every kernel the calls launch);
- K8 at (96, 128, 128) brain-like tensors: the same two times, and whether
  the maps stay within ``compare_scalar_maps``' bound of the plain version;
- with ``--k8-classes``, K8's device time on volumes of one kind of voxel
  each: generic tensors (random eigenvalues and rotations), zeros,
  diagonal and isotropic ones, beside the brain-like mix (the classes whose
  divisions and square roots meet zero operands show).
The K8 line carries ``sha256``, a digest of the maps' bytes at (96, 128,
128) from seed 0 (phase 6's input in ``chip_smoke.py``): equal digests of
two checkouts mean bit-identical maps.
Run checkouts in turns (parent, change, change, parent). Needs a card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

NORM_SHAPES = [(n,) + tuple(s >> level for s in base) + (c,)
               for n, base in ((8, (32, 32, 32)), (1, (48, 64, 64)))
               for level, c in enumerate((64, 128, 256, 512))]


def per_call_ms(torch, fn, iters: int = 50) -> float:
    fn()
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int = 20):
    """Device time per call: every CUDA kernel the calls launch, summed."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    names, total = [], 0.0
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0) or 0
        if t > 0 and e.device_type.name == "CUDA":
            names.append(e.key)
            total += t
    return (total / 1e3 / iters if total else None), sorted(set(names))


def maps_digest(maps) -> str:
    """sha256 of the maps' bytes, field after field (kept here, not taken
    from ``ops/scalar_maps_check.py``, so that older checkouts run too)."""
    h = hashlib.sha256()
    for f in maps:
        h.update(f.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--tag", default=None)
    ap.add_argument("--k8-classes", action="store_true")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from unet_bssfp_tpu_torch.ops import kernels as K
    from unet_bssfp_tpu_torch.ops import scalar_maps_check as chk

    assert Path(K.__file__).resolve().is_relative_to(root), K.__file__
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True
                          ).stdout.strip().splitlines()[0]
    tag = args.tag or str(root)
    for dtype in (torch.bfloat16, torch.float32):
        for shape in NORM_SHAPES:
            c = shape[-1]
            g = torch.Generator(device="cuda").manual_seed(c)
            x = torch.randn(shape, device="cuda", generator=g).to(dtype)
            s = 1 + 0.1 * torch.randn(c, device="cuda", generator=g)
            b = 0.1 * torch.randn(c, device="cuda", generator=g)
            fn = lambda: K.fused_instance_norm_leaky_relu(x, s, b, 0.1)  # noqa: E731
            err = float((fn().float() - K.instance_norm_leaky_relu_plain(x, s, b, 0.1).float())
                        .abs().max())
            dev, names = device_ms(torch, fn)
            print(json.dumps({"tag": tag, "card": card, "kernel": "K4", "shape": list(shape),
                              "dtype": str(dtype).split(".")[1], "ms": per_call_ms(torch, fn),
                              "device_ms": dev, "device_kernels": names,
                              "max_abs_err": err}), flush=True)
            del x
    d6 = torch.from_numpy(chk.sample_dt_volume((96, 128, 128), 0)).to("cuda")
    ref = K.scalar_maps_plain(d6)
    fn = lambda: K.scalar_maps(d6)  # noqa: E731
    got = fn()
    res = chk.compare_scalar_maps(got, ref, d6)
    dev, names = device_ms(torch, fn)
    print(json.dumps({"tag": tag, "card": card, "kernel": "K8", "shape": [96, 128, 128, 6],
                      "ms": per_call_ms(torch, fn), "device_ms": dev, "device_kernels": names,
                      "within_bound": res["ok"], "sha256": maps_digest(got),
                      "max_err_over_tol": max(v["max_err_over_tol"] for v in res.values()
                                              if isinstance(v, dict))}), flush=True)
    if args.k8_classes:
        shape = (96, 128, 128)
        nvox = 96 * 128 * 128
        g = torch.Generator().manual_seed(0)
        q, _ = torch.linalg.qr(torch.randn(nvox, 3, 3, generator=g, dtype=torch.float64))
        lam = torch.rand(nvox, 3, generator=g, dtype=torch.float64) * 3e-3 + 1e-4
        mats = q @ torch.diag_embed(lam) @ q.transpose(-1, -2)
        classes = {"brain-like": d6,
                   "generic": mats[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]].float(),
                   "zeros": torch.zeros(nvox, 6), "diagonal": torch.zeros(nvox, 6),
                   "isotropic": torch.zeros(nvox, 6)}
        classes["diagonal"][:, [0, 3, 5]] = lam.float()
        classes["isotropic"][:, [0, 3, 5]] = 1e-3
        for name, vol in classes.items():
            vol = vol.reshape(shape + (6,)).to("cuda")
            dev, _ = device_ms(torch, lambda v=vol: K.scalar_maps(v))
            print(json.dumps({"tag": tag, "card": card, "kernel": "K8", "voxels": name,
                              "device_ms": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
