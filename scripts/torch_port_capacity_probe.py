#!/usr/bin/env python3
"""The exact-capacity probe, through the port (counterpart of
``scripts/capacity_probe.py``): is the quality record's PSNR plateau a
property of the regime (augmented inputs) or of the model and its training?

The linked fixture's target is a fixed voxel-wise map of the input,
``y = (tanh((x - .5) @ 2W + b) + 1) / 2`` (``data/synthetic.py::
_linked_map``). The probe is that form with ``W`` (24 × 6) and ``b`` (6)
learnt, in float32, by Adam on the L1 loss, trained on
``scripts/torch_port_quality_record.py``'s fixture and augmented patch
stream with the same batch, patch and val convention. Read against the
oracle (``scripts/torch_port_oracle_ceiling.py``): a probe near the
oracle's augmented PSNR says the GAN record's gap is the model's; a probe
near the record says the regime caps it.

It appends one ``kind: capacity_probe`` record to
``CONVERGENCE_TORCH.json`` (``--record`` another file) with the card's name
and power limit and the revision (``$UNET_BSSFP_GIT_REV``, else git). It
runs on ``cuda`` unless
``--device cpu`` is given; without a card it raises.

  python scripts/torch_port_capacity_probe.py                 # 30 epochs on the card
  python scripts/torch_port_capacity_probe.py --smoke --epochs 1 --device cpu --no-record
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_port_quality_record as quality_record  # noqa: E402

IN_CHANNELS, OUT_CHANNELS = 24, 6
PROBE = "exact-form dense 24->6 (+tanh affine), f32, Adam"


def init_params(seed: int, device) -> dict:
    """``w``: 0.3 · N(0, 1) of shape (24, 6) from ``seed``, ``b``: zeros,
    both f32 leaves (the JAX probe draws ``w`` from ``PRNGKey(42)``)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    w = 0.3 * torch.randn(IN_CHANNELS, OUT_CHANNELS, generator=g)
    return {"w": w.to(device).requires_grad_(True),
            "b": torch.zeros(OUT_CHANNELS, device=device, requires_grad=True)}


def apply(params: dict, x):
    """The probe: ``(tanh((x - .5) @ 2w + b) + 1) / 2`` over the channels
    (last dim), in f32."""
    import torch

    z = torch.tanh(torch.matmul(x.float() - 0.5, 2.0 * params["w"]) + params["b"])
    return (z + 1.0) * 0.5


def make_optimizer(params: dict, lr: float):
    """Adam at ``lr`` (optax's defaults: betas 0.9 / 0.999, eps 1e-8)."""
    import torch

    return torch.optim.Adam([params["w"], params["b"]], lr=lr, betas=(0.9, 0.999), eps=1e-8)


def train_step(params: dict, opt, x, y):
    """One Adam step on ``mean |probe(x) - y|``; returns the loss (0-d)."""
    loss = (apply(params, x) - y.float()).abs().mean()
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


def val_sums(params: dict, x, y):
    """``(Σ PSNR, Σ SSIM, Σ L1, n)`` over the batch's items (0-d tensors)."""
    import torch

    from unet_bssfp_tpu_torch.ops.metrics import mae, psnr, ssim3d

    with torch.no_grad():
        y_hat, y = apply(params, x), y.float()
        return (psnr(y_hat, y).sum(), ssim3d(y_hat, y).sum(), mae(y_hat, y).sum(),
                torch.tensor(float(y.shape[0]), device=y.device))


def run(args) -> dict:
    """Train the probe and return its record (appended to ``args.record``
    unless ``args.no_record``)."""
    import torch

    from unet_bssfp_tpu_torch.data.datamodule import DoveDataModule
    from unet_bssfp_tpu_torch.train.loop import epoch_seeds
    from unet_bssfp_tpu_torch.train.state import resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False  # f32 throughout
    qr = argparse.Namespace(smoke=args.smoke, samples_per_vol=args.samples_per_vol,
                            workdir=args.workdir, max_epochs=args.epochs,
                            modality=args.modality)
    bids = quality_record.make_fixture(qr)
    cfg = quality_record.build_config(qr, bids)
    data = DoveDataModule(bids, config=cfg.data)
    data.setup()
    params = init_params(cfg.train.seed, dev)
    opt = make_optimizer(params, args.lr)
    keys = (args.modality, "dwi-tensor")
    t0 = time.monotonic()
    last, best = {}, -1.0
    for epoch in range(args.epochs):
        train_seed, val_seed = epoch_seeds(cfg.train.seed + 1, epoch)
        losses = [train_step(params, opt, b[args.modality], b["dwi-tensor_orig"])
                  for b in data.train_batches(train_seed, keys=keys, device=dev)]
        sums = [val_sums(params, b[args.modality], b["dwi-tensor_orig"])
                for b in data.val_batches(val_seed, keys=keys, device=dev)]
        p, s, l1, n = (float(v) for v in torch.stack([torch.stack(t) for t in sums]).sum(0))
        last = {"val_psnr": round(p / n, 4), "val_ssim": round(s / n, 4),
                "val_l1": round(l1 / n, 5)}
        best = max(best, last["val_psnr"])
        train_l1 = float(torch.stack(losses).mean()) if losses else float("nan")
        print(f"epoch {epoch}: train_L1 {train_l1:.4f} val {last}", flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    entry = {
        "date": datetime.datetime.now().isoformat(timespec="seconds"),
        "git": quality_record.git_rev(),
        "kind": "capacity_probe",
        "device": quality_record.device_label(dev),
        "smoke": bool(args.smoke),
        "linked": True,
        "samples_per_vol": args.samples_per_vol,
        "probe": PROBE,
        "lr": args.lr,
        "probe_epochs": args.epochs,
        "wall_seconds": round(time.monotonic() - t0, 1),
        "val_psnr_last": last.get("val_psnr"),
        "val_psnr_best": round(best, 4),
        "val_ssim_last": last.get("val_ssim"),
        "val_l1_last": last.get("val_l1"),
    }
    print(json.dumps(entry, indent=1))
    if not args.no_record:
        count = quality_record.append_record(args.record, [entry])
        print(f"recorded to {quality_record.repo_path(args.record)} ({count} records)")
    return entry


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--samples-per-vol", type=int, default=32)
    ap.add_argument("--modality", default="pc-bssfp")
    ap.add_argument("--device", default=None, help="default cuda; cpu to run on the CPU")
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(),
                                                      "torch_port_capacity_probe"))
    ap.add_argument("--record", default=quality_record.CONVERGENCE_RECORD)
    ap.add_argument("--no-record", action="store_true")
    return ap


def main(argv=None) -> int:
    run(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
