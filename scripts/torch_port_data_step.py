#!/usr/bin/env python3
"""Where a data-fed training step's time goes: the default GAN step (bf16,
packed, 8 × 64³, pc-bSSFP → DT, the pristine DT the target) fed by
``DoveDataModule.train_batches`` (default ``DataConfig``, volumes cached)
on a synthetic tree of two subjects at (96, 128, 128), with parts of the
stream's work taken away in turns.

  python scripts/torch_port_data_step.py [--repeat 8] [--out perf_out/data_step]

Cases, each run twice: in the order given, then backwards:
- ``resident_batch``: the step on one batch already on the card;
- ``prefetch``: the stream as shipped (batches built ahead by a thread on a
  CUDA stream of its own; the volumes staged through pinned host buffers
  and copied ``non_blocking``, ``datamodule.stage``);
- ``prefetch_pageable``: the same with the volumes copied from pageable
  host memory (the stage before it went through pinned buffers);
- ``prefetch_volumes_on_card``: the same with the volumes kept on the card
  after their first copy (no host-to-card copy: only the thread's Python
  and the side stream's kernels stay);
- ``prefetch_volumes_on_card_no_augment``: the same at ``augment_prob`` 0
  (the side stream runs only the patch cut);
- ``prefetch_off``: each batch built in the loop, on the step's stream.
One JSON line per case and run: per step the host's wait for the batch,
the step's enqueue time (its Python until it returns), its wall time
(batch in hand → synchronised) and its device span (CUDA events on the
consumer's stream around the step: a wait for the batch is not in it);
medians over the steps taken while the stream still builds batches beside
them (the third to the fourth-last). The epochs are the two train samples
repeated ``--repeat`` times. Needs a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
VOLUME = (96, 128, 128)
KEYS = ("pc-bssfp", "dwi-tensor")
CASES = ("resident_batch", "prefetch", "prefetch_pageable", "prefetch_volumes_on_card",
         "prefetch_volumes_on_card_no_augment", "prefetch_off")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeat", type=int, default=8)
    ap.add_argument("--out", default="perf_out/data_step")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from unet_bssfp_tpu_torch.config import Config
    from unet_bssfp_tpu_torch.data import datamodule as dmod
    from unet_bssfp_tpu_torch.data.synthetic import make_synthetic_bids
    from unet_bssfp_tpu_torch.train.state import create_gan_state
    from unet_bssfp_tpu_torch.train.steps import make_train_step

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    out = Path(args.out)
    shutil.rmtree(out, ignore_errors=True)
    tree = out / "tree"
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(lambda s: make_synthetic_bids(str(tree), subjects=(s[0],), sessions=("1",),
                                                    volume_shape=VOLUME, seed=s[1]),
                      (("01", 0), ("02", 1))))
    print(json.dumps({"tree_s": time.perf_counter() - t0}), flush=True)

    cfg = Config()
    dcfg = dataclasses.replace(cfg.data, val_split=0.0, test_split=0.0, cache_volumes=True)
    dm = dmod.DoveDataModule(str(tree), config=dcfg)
    dm.prepare_data()
    dm.train_samples = dm.train_samples * args.repeat
    list(dm.train_batches(0, keys=KEYS, device="cuda"))  # fills the cache
    state = create_gan_state(0, "pc-bssfp", cfg.model, cfg.train, "cuda")
    step = make_train_step(state.gen, state.disc, cfg.train)
    resident = next(iter(dm.train_batches(1, keys=KEYS, device="cuda", prefetch=False)))
    for _ in range(3):
        step(state, resident["pc-bssfp"], resident["dwi-tensor_orig"])
    torch.cuda.synchronize()

    shipped = dmod.stage
    on_card = {}

    def pageable(arrays, device):
        return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}

    def kept(arrays, device):
        for v in arrays.values():
            if id(v) not in on_card:
                on_card[id(v)] = torch.from_numpy(v).to(device)
        return {k: on_card[id(v)] for k, v in arrays.items()}

    n_batches = len(dm.train_samples) * dcfg.samples_per_vol // dcfg.batch_size
    setups = {  # stage, augment_prob, prefetch
        "prefetch": (shipped, dcfg.augment_prob, True),
        "prefetch_pageable": (pageable, dcfg.augment_prob, True),
        "prefetch_volumes_on_card": (kept, dcfg.augment_prob, True),
        "prefetch_volumes_on_card_no_augment": (kept, 0.0, True),
        "prefetch_off": (shipped, dcfg.augment_prob, False),
    }

    def run(case: str, seed: int) -> dict:
        if case == "resident_batch":
            batches = itertools.repeat(resident, n_batches)
        else:
            stage, prob, prefetch = setups[case]
            dmod.stage = stage
            dm.config = dataclasses.replace(dcfg, augment_prob=prob)
            batches = dm.train_batches(seed, keys=KEYS, device="cuda", prefetch=prefetch)
        torch.cuda.synchronize()
        rows = []
        t_start = t_prev = time.perf_counter()
        for batch in batches:
            t0 = time.perf_counter()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            step(state, batch["pc-bssfp"], batch["dwi-tensor_orig"])
            t1 = time.perf_counter()
            e1.record()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            rows.append({"wait": (t0 - t_prev) * 1e3, "enqueue": (t1 - t0) * 1e3,
                         "wall": (t2 - t0) * 1e3, "device": e0.elapsed_time(e1)})
            t_prev = t2
        total = time.perf_counter() - t_start
        dmod.stage, dm.config = shipped, dcfg
        mid = rows[2:-3]
        return {"case": case, "card": card, "steps": len(rows),
                "ms_per_iteration": total * 1e3 / len(rows),
                **{f"{k}_ms_median": statistics.median(r[k] for r in mid)
                   for k in ("wait", "enqueue", "wall", "device")},
                **{f"{k}_ms_all": [round(r[k], 3) for r in rows]
                   for k in ("wait", "enqueue", "wall", "device")}}

    for run_no, order in enumerate((CASES, CASES[::-1])):
        for i, case in enumerate(order):
            print(json.dumps({"run": run_no, **run(case, 100 * run_no + i)}), flush=True)
    shutil.rmtree(out, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
