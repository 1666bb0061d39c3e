#!/usr/bin/env python3
"""Run some phases of a checkout's ``chip_smoke.py`` on the card: the
build, then the training data path (phase 12), the training loop (phase
13) and the evaluation from its best checkpoint (phase 14, which needs
phase 13), on the smoke's 4-subject tree at (96, 128, 128).

  python scripts/torch_port_smoke_phases.py [--root DIR]
      [--phases data loop checkpoint] [--tree perf_out/smoke_tree_phases]

``--root`` is the checkout whose ``chip_smoke.py`` and package run
(default: this one), so a parent and a change compare in one job, in turns
(parent, change, change, parent), each in its own process. The tree is
written once (from the smoke's seeds) and kept for the next run; delete it
after. Prints each phase's check rows as the smoke does and one summary
line: the data-fed step's and loop iteration's medians (phase 12), the
loop's numbers (phase 13), the evaluation's (phase 14). Needs a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--phases", nargs="+", choices=("data", "loop", "checkpoint"),
                    default=["data", "loop", "checkpoint"])
    ap.add_argument("--tree", default="perf_out/smoke_tree_phases")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(root))
    os.chdir(root)
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    sm = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sm)

    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: the phases need a card", file=sys.stderr)
        return 2
    from unet_bssfp_tpu_torch import native
    from unet_bssfp_tpu_torch.config import Config
    from unet_bssfp_tpu_torch.data import augment, nifti
    from unet_bssfp_tpu_torch.data.datamodule import DoveDataModule, sample_generator
    from unet_bssfp_tpu_torch.data.sampler import extract_patches, uniform_patch_starts
    from unet_bssfp_tpu_torch.data.synthetic import make_synthetic_bids
    from unet_bssfp_tpu_torch.ops import kernels as K
    from unet_bssfp_tpu_torch.ops.kernels import _build
    from unet_bssfp_tpu_torch.train.state import create_gan_state
    from unet_bssfp_tpu_torch.train.steps import make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    checks = sm.Checks()
    sm.phase_build(torch, K, _build, native)
    if not (tree / ".complete").exists():
        print(f"tree {tree}: {sm.make_tree(make_synthetic_bids, tree):.1f} s", flush=True)
        (tree / ".complete").write_text("ok\n")
    summary = {"root": str(root), "card": torch.cuda.get_device_name(0)}
    if "data" in args.phases:
        t0 = time.perf_counter()
        _, out = sm.phase_data(torch, K, checks, (
            Config, DoveDataModule, augment, nifti, native,
            (sample_generator, uniform_patch_starts, extract_patches), create_gan_state,
            make_train_step), str(tree))
        summary["data"] = {k: out["train"][k] for k in (
            "ms_per_step_median", "ms_per_loop_iteration_median", "device_busy_share")}
        summary["data"]["phase_s"] = time.perf_counter() - t0
    if "checkpoint" in args.phases and "loop" not in args.phases:
        ap.error("the checkpoint phase evaluates the loop phase's run: add loop")
    if "loop" in args.phases:
        from scripts import torch_port_convergence
        from unet_bssfp_tpu_torch.train import checkpoint
        from unet_bssfp_tpu_torch.train.loop import Trainer, train_model
        from unet_bssfp_tpu_torch.utils import flops

        work = tree.parent / "loop_smoke_phases"
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
        try:
            t0 = time.perf_counter()
            _, _, out, run = sm.phase_loop(torch, K, checks, (
                Config, DoveDataModule, Trainer, train_model, checkpoint, create_gan_state,
                make_train_step, flops, torch_port_convergence), str(tree), work)
            summary["loop"] = {k: v for k, v in out["timing"].items() if not k.endswith("_all")}
            summary["loop"]["remat"] = {k: v for k, v in out["remat"].items()
                                        if k.endswith(("_off", "_on")) and "launches" not in k}
            summary["loop"]["convergence_psnr"] = out["convergence"]["val_psnr_last"]
            summary["loop"]["phase_s"] = time.perf_counter() - t0
            if "checkpoint" in args.phases:
                t0 = time.perf_counter()
                out = sm.phase_eval_checkpoint(torch, K, checks, str(tree), run, work)[-1]
                summary["checkpoint"] = {
                    "s_per_test_volume": out["eval"]["s_per_test_volume"],
                    "fid": {k: out["fid"][k] for k in ("card_ms", "rel_diff")},
                    "perceptual_step": {k: v for k, v in out["perceptual_step"].items()
                                        if k != "perceptual_term"},
                    "phase_s": time.perf_counter() - t0}
                for v in summary["checkpoint"]["perceptual_step"].values():
                    v.pop("launches")
        finally:
            shutil.rmtree(work, ignore_errors=True)
    summary["failures"] = [r.get("phase", r.get("kernel")) for r in checks.failures]
    print(json.dumps(summary), flush=True)
    return 1 if checks.failures else 0


if __name__ == "__main__":
    sys.exit(main())
