#!/usr/bin/env python3
"""The oracle PSNR ceiling of the linked synthetic fixture under the
reference's augmented-val convention, through the port (counterpart of
``scripts/oracle_ceiling.py``).

The linked fixture's input -> target relation is exactly deterministic
(``data/synthetic.py::_linked_map``), so in the quality regime the only
irreducible error comes from the augmentation chain: val inputs are
corrupted (the reference augments val too, ``src/data_module.py:130-147``)
while the target stays the pristine ``dwi-tensor_orig``. In the patch and
batch space of the loop's ``val_metric_PSNR`` this measures:

  oracle_aug          PSNR(linked_map(x_aug), y_orig): the exact generating
                      map on the corrupted input (a mapping oracle, not a
                      Bayes bound);
  oracle_clean        PSNR(linked_map(x_clean), y_orig): the fixture's own
                      float-precision ceiling, the test-space ceiling (test
                      metrics run on clean inputs);
  target_aug_vs_orig  PSNR(y_aug, y_orig): how hard the chain corrupts one
                      volume.

The quality record's fixture and data config (12 subjects, (96, 128, 128),
patch 64, batch 8, 32 patches a volume, val split 0.2), over ``--repeats``
augmented val passes of different seeds and one clean pass. Appends a
``kind: "oracle_ceiling"`` entry to ``QUALITY_TORCH.json``. No model, no
training: the data path, one matmul and tanh, the metrics. Runs on
``cuda`` unless ``--device cpu`` is given; without a card and without
``--device cpu`` it raises.

  python scripts/torch_port_oracle_ceiling.py --repeats 4
  python scripts/torch_port_oracle_ceiling.py --smoke --repeats 1 --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import json
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from scripts import torch_port_quality_record as quality_record  # noqa: E402


@contextlib.contextmanager
def highest_matmul_precision():
    """f32 products in f32 on the card (no TF32): JAX's ``Precision.HIGHEST``."""
    import torch

    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)


def make_linked_map_fn(out_channels: int = 6, tag: int = 1):
    """The fixture's generating map as a torch function of ``(..., 24)``
    volumes. Its weights are drawn once from the seeded generator of
    ``_linked_map`` (``987650 + tag``), so the oracle is the function that
    made the targets; the product runs in f32 with TF32 off."""
    import torch

    rng = np.random.default_rng(987650 + tag)
    cin = 24  # pc-bSSFP's channels (the fixture's layout)
    w = rng.standard_normal((cin, out_channels)).astype(np.float32)
    w /= np.sqrt(cin)
    b = 0.1 * rng.standard_normal((out_channels,)).astype(np.float32)
    w2, bt = torch.from_numpy(2.0 * w), torch.from_numpy(b)

    def fn(v: torch.Tensor) -> torch.Tensor:
        with highest_matmul_precision():
            z = torch.tanh(torch.matmul(v - 0.5, w2.to(v.device)) + bt.to(v.device))
        return (z + 1.0) * 0.5

    return fn


def batch_metrics(y_hat, y):
    """Sums of the batch's per-item PSNR, SSIM and L1 in f32, and its size."""
    from unet_bssfp_tpu_torch.ops.metrics import mae, psnr, ssim3d

    y_hat, y = y_hat.float(), y.float()
    n = y.shape[0]
    return (float(psnr(y_hat, y).mean()) * n, float(ssim3d(y_hat, y).mean()) * n,
            float(mae(y_hat, y).mean()) * n, n)


def oracle_pass(data, modality: str, seed: int, augment: bool, oracle, device=None) -> dict:
    """One val pass of ``data`` (stream ``seed``): the oracle's sums, and
    with ``augment`` the augmented target's, against ``dwi-tensor_orig``."""
    acc = {"oracle": [0.0, 0.0, 0.0, 0], "target": [0.0, 0.0, 0.0, 0]}
    for batch in data.val_batches(seed, keys=(modality, "dwi-tensor"), augment=augment,
                                  device=device):
        y = batch["dwi-tensor_orig"]
        for i, v in enumerate(batch_metrics(oracle(batch[modality].float()), y)):
            acc["oracle"][i] += v
        if augment:
            for i, v in enumerate(batch_metrics(batch["dwi-tensor"], y)):
                acc["target"][i] += v
    return acc


def finish(acc) -> dict:
    p, s, l, n = acc
    return {"psnr": round(p / n, 4), "ssim": round(s / n, 4), "l1": round(l / n, 5),
            "n_patches": n}


def measure(data, modality: str, repeats: int, seed0: int = 1000, device=None) -> dict:
    """The oracle over ``repeats`` augmented val passes (seeds ``seed0 +
    r``) and one clean pass (``seed0``); the means per patch."""
    from unet_bssfp_tpu_torch.train.state import resolve_device

    dev = resolve_device(device)
    oracle = make_linked_map_fn(6, tag=1)
    agg = {"oracle": [0.0, 0.0, 0.0, 0], "target": [0.0, 0.0, 0.0, 0]}
    for r in range(repeats):
        one = oracle_pass(data, modality, seed0 + r, True, oracle, dev)
        for k in agg:
            for i in range(4):
                agg[k][i] += one[k][i]
    clean = oracle_pass(data, modality, seed0, False, oracle, dev)
    return {"oracle_aug": finish(agg["oracle"]),
            "target_aug_vs_orig": finish(agg["target"]),
            "oracle_clean": finish(clean["oracle"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--repeats", type=int, default=4)
    ap.add_argument("--modality", default="pc-bssfp")
    ap.add_argument("--out", default=quality_record.QUALITY_RECORD)
    ap.add_argument("--device", default=None, help="default cuda; cpu to run on the CPU")
    args = ap.parse_args(argv)

    from unet_bssfp_tpu_torch.data.datamodule import DoveDataModule
    from unet_bssfp_tpu_torch.train.state import resolve_device

    dev = resolve_device(args.device)  # no card and no --device cpu: raise before the work
    bids = quality_record.make_fixture(args)
    qr_ns = argparse.Namespace(smoke=args.smoke, samples_per_vol=32,
                               workdir=os.path.join(tempfile.gettempdir(),
                                                    "torch_port_oracle_ceiling"),
                               max_epochs=1, modality=args.modality)
    cfg = quality_record.build_config(qr_ns, bids)
    data = DoveDataModule(bids, config=cfg.data)
    data.setup()

    res = measure(data, args.modality, args.repeats, device=dev)
    entry = {
        "date": datetime.datetime.now().isoformat(timespec="seconds"),
        "git": quality_record.git_rev(),
        "kind": "oracle_ceiling",
        "smoke": bool(args.smoke),
        "device": quality_record.device_label(dev),
        "task": (f"linked synthetic fixture ({6 if args.smoke else 12} subjects, "
                 f"{args.modality} -> DT)"),
        "val_convention": "augmented val inputs, pristine target "
                          "(reference parity; src/data_module.py:130-147)",
        "repeats": args.repeats,
        **res,
        "note": "oracle_aug.psnr = exact generating map applied to the corrupted val "
                "input (mapping oracle, not a Bayes bound); oracle_clean = float-precision "
                "ceiling of the fixture mapping itself (the test-space ceiling: test "
                "metrics run on clean inputs).",
    }
    print(json.dumps(entry, indent=1))
    if args.out:
        n = quality_record.append_record(args.out, [entry], indent=1)
        print(f"recorded to {args.out} ({n} records)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
