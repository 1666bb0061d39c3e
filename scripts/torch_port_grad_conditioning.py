#!/usr/bin/env python3
"""How far the full-width generator's plain f32 gradients stray from f64.

  python scripts/torch_port_grad_conditioning.py [--device cuda] [--batch 2]

One generator-phase backward (BCE(D(x, G(x)), 1) + L1·recon_factor, dropout
0, TF32 off) on plain PyTorch/cuDNN (``packed`` and ``use_pallas`` off), once
in f32 and once in f64, from the same seeded weights and the batch of
``chip_smoke.py``'s f32 gradient check. Prints the relative L2 distance of
every generator leaf's f32 gradient from its f64 one, largest first: the
yardstick of that check's 5e-2 per-leaf limit. Writes
``perf_out/torch_port_grad_conditioning.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from unet_bssfp_tpu_torch import weights  # noqa: E402
from unet_bssfp_tpu_torch.config import Config  # noqa: E402
from unet_bssfp_tpu_torch.ops import losses  # noqa: E402
from unet_bssfp_tpu_torch.train.state import build_models  # noqa: E402

SEED, MODALITY, PATCH = 0, "pc-bssfp", 64


def leaf_grads(cfg, device, x, y, dtype):
    mcfg = dataclasses.replace(cfg.model, compute_dtype="float32", dropout=0.0,
                               packed=False, use_pallas=False)
    gen, disc = build_models(MODALITY, mcfg, device)
    gen.load_state_dict(weights.random_state_dict(gen, SEED))
    disc.load_state_dict(weights.random_state_dict(disc, SEED + 1))
    for m in (gen, disc):
        m.to(dtype)
        for sub in m.modules():
            if hasattr(sub, "compute_dtype"):
                sub.compute_dtype = dtype
        m.train()
    disc.requires_grad_(False)
    x, y = x.to(dtype), y.to(dtype)
    y_hat = gen(x)
    logits = disc(x, y_hat)
    loss = (losses.bce_with_logits(logits, torch.ones_like(logits))
            + losses.l1_loss(y_hat, y) * cfg.train.recon_factor)
    loss.backward()
    return {n: p.grad.detach().double() for n, p in gen.named_parameters()}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--batch", type=int, default=2)
    args = parser.parse_args()
    device = torch.device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if device.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    # the batch of chip_smoke.py's f32 gradient check (L1 sign fixed)
    g = torch.Generator(device=device).manual_seed(SEED + 1)
    x = torch.randn((args.batch,) + (PATCH,) * 3 + (24,), device=device, generator=g)
    y = 10.0 + torch.rand((args.batch,) + (PATCH,) * 3 + (6,), device=device, generator=g)
    cfg = Config()
    g32 = leaf_grads(cfg, device, x, y, torch.float32)
    g64 = leaf_grads(cfg, device, x, y, torch.float64)
    rows = sorted(((n, float((g32[n] - r).norm() / r.norm().clamp_min(1e-300)))
                   for n, r in g64.items() if not n.endswith(".conv.bias")),
                  key=lambda t: -t[1])
    for name, rel in rows[:10]:
        print(f"{rel:.3e}  {name}")
    print(f"largest f32-vs-f64 relative L2 over {len(rows)} leaves "
          f"(conv biases under a norm left out): {rows[0][1]:.3e}")
    os.makedirs("perf_out", exist_ok=True)
    with open(os.path.join("perf_out", "torch_port_grad_conditioning.json"), "w") as f:
        json.dump({"device": str(device), "batch": args.batch, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
