#!/usr/bin/env python3
"""Run some phases of a checkout's ``chip_smoke.py`` on the card: the
build, then the training data path (phase 12), the training loop (phase
13), the evaluation from its best checkpoint (phase 14, which needs
phase 13), the quality path (phase 19, which needs phase 13 and writes its
own target cohort first), the multi-stage regime (phase 15) and the sharded training step
(phase 16) and the serving artifact with the public surface (phase 17,
without its plots, which read phase 14's table), on the smoke's 4-subject
tree at (96, 128, 128); and the wguard layout (phase 18), training over
distinct devices (phase 20: meshes over cuda:0 and the host) and training
across processes (phase 21: two processes on cuda:0 under gloo, NCCL where
there are two cards, the cut capacity probe) and the SwinUNETR generator's
GAN step on 4 × 96³ crops (phase 22), which need no tree.

  python scripts/torch_port_smoke_phases.py [--root DIR]
      [--phases data loop checkpoint quality multistage sharded surface wguard
                distinct multiprocess]
      [--tree perf_out/smoke_tree_phases]

``--root`` is the checkout whose ``chip_smoke.py`` and package run
(default: this one), so a parent and a change compare in one job, in turns
(parent, change, change, parent), each in its own process. The tree is
written once (from the smoke's seeds) and kept for the next run; delete it
after. Prints each phase's check rows as the smoke does and one summary
line: the card's name and power limit, the data-fed step's and loop
iteration's medians (phase 12), the loop's numbers (phase 13), the
evaluation's (phase 14), the multi-stage
run's and steps' (phase 15), each mesh's step ms and peak MiB beside the
unsharded step's (phase 16), the export's seconds, the ms per volume of the
artifact and of ``predict_volume`` and the wrappers' ms per step (phase
17), the guarded serving and steps' ms beside the unguarded ones (phase
18), the A/B's entries, the oracle's and the judged summary's seconds
(phase 19), each mixed-mesh step's seconds beside cuda:0 alone's (phase
20), the processes' bf16 ms per step beside one process's (phase 21), the
Swin step's ms, peak MiB and attention kernels (phase 22).
Needs a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--phases", nargs="+",
                    choices=("data", "loop", "checkpoint", "quality", "multistage", "sharded",
                             "surface", "wguard", "distinct", "multiprocess", "swin"),
                    default=["data", "loop", "checkpoint", "quality", "multistage", "sharded",
                             "surface", "wguard", "distinct", "multiprocess", "swin"])
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
    treeless = {"wguard", "distinct", "multiprocess", "swin"}
    if set(args.phases) - treeless and not (tree / ".complete").exists():
        print(f"tree {tree}: {sm.make_tree(make_synthetic_bids, tree):.1f} s", flush=True)
        (tree / ".complete").write_text("ok\n")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    summary = {"root": str(root), "card": card}
    if "data" in args.phases:
        t0 = time.perf_counter()
        _, out = sm.phase_data(torch, K, checks, (
            Config, DoveDataModule, augment, nifti, native,
            (sample_generator, uniform_patch_starts, extract_patches), create_gan_state,
            make_train_step), str(tree))
        summary["data"] = {k: out["train"][k] for k in (
            "ms_per_step_median", "ms_per_loop_iteration_median", "device_busy_share")}
        summary["data"]["phase_s"] = time.perf_counter() - t0
    for phase in ("checkpoint", "quality"):
        if phase in args.phases and "loop" not in args.phases:
            ap.error(f"the {phase} phase evaluates the loop phase's run: add loop")
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
            if "quality" in args.phases:
                t0 = time.perf_counter()
                target = tree.parent / "quality_tree_phases"
                proc = sm.start_quality_tree(target)
                try:
                    out = sm.phase_quality(torch, K, checks, str(tree), str(target), proc,
                                           run["best"], work / "quality")[-1]
                finally:
                    sm.stop_process(proc)
                    shutil.rmtree(target, ignore_errors=True)
                summary["quality"] = {
                    "target_tree": out["target_tree"],
                    "ab_entries": [out[k]["entry"] for k in ("quality_ab_multistage",
                                                             "quality_ab_direct")],
                    "oracle": {k: out["oracle"][k] for k in ("measure", "seconds",
                                                             "map_max_abs_err",
                                                             "clean_max_rel_diff")},
                    "judged_s": out["judged"]["seconds"],
                    "judged_test_metrics": out["judged"]["summary"]["test_metrics"],
                    "phase_s": time.perf_counter() - t0}
        finally:
            shutil.rmtree(work, ignore_errors=True)
    if "multistage" in args.phases:
        import torch.nn.functional as F

        from unet_bssfp_tpu_torch import weights
        from unet_bssfp_tpu_torch.models.multi_input_unet import TrainingState
        from unet_bssfp_tpu_torch.train import multistage

        work = tree.parent / "multistage_smoke_phases"
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
        try:
            t0 = time.perf_counter()
            _, _, out = sm.phase_multistage(
                torch, F, K, checks,
                (Config, DoveDataModule, multistage, weights, TrainingState), str(tree), work)
            stages = ("pretrain", "transfer", "finetune")
            summary["multistage"] = {
                "run_s": out["run"]["seconds"], "epoch_seconds": out["run"]["epoch_seconds"],
                "ms_per_step": {s: {k: out[s][k]["ms_per_step_median"]
                                    for k in ("packed", "cudnn")} for s in stages},
                "peak_mib": {s: {k: out[s][k]["peak_mib"] for k in ("packed", "cudnn")}
                             for s in stages},
                "f32_worst_leaf": out["f32_grad_check"]["worst_leaf"],
                "phase_s": time.perf_counter() - t0}
        finally:
            shutil.rmtree(work, ignore_errors=True)
    if "sharded" in args.phases:
        from unet_bssfp_tpu_torch.models.multi_input_unet import TrainingState
        from unet_bssfp_tpu_torch.parallel.mesh import gather_batch, make_mesh, shard_batch
        from unet_bssfp_tpu_torch.train import checkpoint, multistage
        from unet_bssfp_tpu_torch.train.loop import Trainer
        from unet_bssfp_tpu_torch.train.steps import make_eval_step

        work = tree.parent / "sharded_smoke_phases"
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
        try:
            t0 = time.perf_counter()
            _, out = sm.phase_sharded(
                torch, K, checks,
                (Config, create_gan_state, make_train_step, make_eval_step,
                 (make_mesh, shard_batch, gather_batch), Trainer, DoveDataModule, checkpoint,
                 multistage, TrainingState), str(tree), work)
            summary["sharded"] = {
                "ms_per_step": {k: v["ms_per_step_median"]
                                for k, v in out["steps"]["timing"].items()},
                "peak_mib": {k: v["peak_mib"] for k, v in out["steps"]["timing"].items()},
                "busy_share": {k: v["device_busy_share"]
                               for k, v in out["steps"]["timing"].items()},
                "fit_s": out["fit"]["seconds"],
                "multistage_ms": {k: v["ms_per_step_median"]
                                  for k, v in out["multistage"].items()},
                "phase_s": time.perf_counter() - t0}
        finally:
            shutil.rmtree(work, ignore_errors=True)
    if "surface" in args.phases:
        from unet_bssfp_tpu_torch import model, weights
        from unet_bssfp_tpu_torch.eval import export
        from unet_bssfp_tpu_torch.eval.inference import predict_volume
        from unet_bssfp_tpu_torch.models.multi_input_unet import TrainingState
        from unet_bssfp_tpu_torch.predict import main as predict_main
        from unet_bssfp_tpu_torch.train.state import build_models
        from unet_bssfp_tpu_torch.train.steps import make_predict_fn

        work = tree.parent / "surface_smoke_phases"
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
        try:
            t0 = time.perf_counter()
            _, out = sm.phase_surface(
                torch, K, checks,
                (Config, build_models, make_predict_fn, make_train_step, create_gan_state,
                 weights, predict_volume, nifti, export, predict_main, model, TrainingState),
                str(tree), work, None, None)
            summary["surface"] = {
                "export_s": {d: out[f"export_{d}"]["export_s"] for d in ("bfloat16", "float32")},
                "ms_per_volume": {k: v["median"] for k, v in out["ms_per_volume"].items()},
                "gan_wrapper_ms": out["gan_wrapper"]["ms_per_step_median"],
                "multistage_wrapper_ms": {k: v["ms_per_step_median"]
                                          for k, v in out["multistage_wrapper"].items()},
                "phase_s": time.perf_counter() - t0}
        finally:
            shutil.rmtree(work, ignore_errors=True)
    if "wguard" in args.phases:
        import torch.nn.functional as F

        from unet_bssfp_tpu_torch import weights
        from unet_bssfp_tpu_torch.eval.inference import predict_volume
        from unet_bssfp_tpu_torch.models.multi_input_unet import TrainingState
        from unet_bssfp_tpu_torch.models.packed_layers import guard_cols
        from unet_bssfp_tpu_torch.ops import losses
        from unet_bssfp_tpu_torch.parallel.mesh import gather_batch, make_mesh, shard_batch
        from unet_bssfp_tpu_torch.train import multistage
        from unet_bssfp_tpu_torch.train.state import build_models
        from unet_bssfp_tpu_torch.train.steps import make_predict_fn

        t0 = time.perf_counter()
        _, out = sm.phase_wguard(
            torch, F, K, checks,
            (Config, build_models, make_predict_fn, weights, predict_volume, create_gan_state,
             make_train_step, multistage, TrainingState, (make_mesh, shard_batch, gather_batch),
             losses, guard_cols))
        summary["wguard"] = {
            "serving_ms": {m: {k: v[k] for k in ("ms_per_volume_median",
                                                 "unguarded_ms_per_volume_median")}
                           for m, v in out["serving"].items()},
            **{f"{k}_ms": {g: v[g]["ms_per_step_median"] for g in ("guarded", "unguarded")}
               for k, v in out.items() if k in ("train_step", "finetune_step")},
            "phase_s": time.perf_counter() - t0}
    if "distinct" in args.phases:
        from unet_bssfp_tpu_torch.models.multi_input_unet import TrainingState
        from unet_bssfp_tpu_torch.parallel.mesh import Mesh, make_mesh, replicas
        from unet_bssfp_tpu_torch.train import checkpoint, multistage

        work = tree.parent / "distinct_smoke_phases"
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
        try:
            t0 = time.perf_counter()
            _, out = sm.phase_distinct(
                torch, K, checks,
                (Config, create_gan_state, make_train_step, (Mesh, make_mesh, replicas),
                 checkpoint, multistage, TrainingState), work)
            summary["distinct"] = {
                "step_s": {k: {"mixed": v["s"], "cuda0_alone": v.get("alone_s")}
                           for k, v in out.items()},
                "phase_s": time.perf_counter() - t0}
        finally:
            shutil.rmtree(work, ignore_errors=True)
    if "multiprocess" in args.phases:
        work = (tree.parent / "multiprocess_smoke_phases").resolve()
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
        try:
            t0 = time.perf_counter()
            _, out = sm.phase_multiprocess(
                torch, K, checks, (Config, create_gan_state, make_train_step), card, work)
            summary["multiprocess"] = {
                "bf16_ms_per_step": out["gloo_one_card"]["bf16_ms_per_step"],
                "bf16_one_process_ms": out["gloo_one_card"]["bf16_one_process_ms"],
                "nccl_ran": out["nccl_two_cards"]["ran"],
                "phase_s": time.perf_counter() - t0}
        finally:
            shutil.rmtree(work, ignore_errors=True)
    if "swin" in args.phases:
        t0 = time.perf_counter()
        _, out = sm.phase_swin(torch, K, checks, (Config, create_gan_state, make_train_step))
        summary["swin"] = {k: out[k] for k in ("ms_per_step_median", "peak_mib",
                                               "attention_device_ms", "device_ops",
                                               "encoder_device_ops")}
        summary["swin"]["phase_s"] = time.perf_counter() - t0
    summary["failures"] = [r.get("phase", r.get("kernel")) for r in checks.failures]
    print(json.dumps(summary), flush=True)
    return 1 if checks.failures else 0


if __name__ == "__main__":
    sys.exit(main())
