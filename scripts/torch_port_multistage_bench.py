#!/usr/bin/env python3
"""The multistage-against-direct convergence record, through the port
(counterpart of ``scripts/multistage_bench.py``).

The reference's headline quality numbers come from the pretrain → transfer →
finetune regime (thesis ``03-methods.tex:784-787``). This runs, on the
linked synthetic fixture,

- the three-stage regime (``train/multistage.py::run_multistage``) with a
  fixed epoch budget a stage, and
- a direct supervised run on the target modality with the same total epoch
  budget, the same loss (L1 + (1 − SSIM)) and the same ``MultiInputUNet``,

and appends both to ``CONVERGENCE_TORCH.json`` (``multistage: true`` /
``direct_supervised: true``) with the multistage − direct val PSNR.
``--two-cohort`` is the domain-transfer A/B: PRETRAIN on a large offset-0
cohort, TRANSFER, FINE_TUNE and both arms' judgement on a small cohort whose
generating map is shifted (seed 1, ``link_tag_offset`` 10).

Both arms run on one device, as the port's ``Trainer`` and
``run_multistage`` do (the JAX script builds a mesh over ``gcd(batch,
devices)``). Runs on ``cuda`` unless ``--device cpu`` is given; without a
card and without ``--device cpu`` it raises.

  python scripts/torch_port_multistage_bench.py --two-cohort --pretrain 8 --transfer 4 --finetune 8
  python scripts/torch_port_multistage_bench.py --pretrain 8 --transfer 4 --finetune 8
  python scripts/torch_port_multistage_bench.py --smoke --two-cohort --pretrain 1 \\
      --transfer 1 --finetune 1 --samples-per-vol 2 --no-record --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import sys
import tempfile
import time
from typing import Optional

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from scripts import torch_port_quality_record as quality_record  # noqa: E402

RECORD_PATH = quality_record.CONVERGENCE_RECORD
#: The two entries' keys, as the JAX script writes them (``cohorts`` and
#: ``cohort_note`` with ``--two-cohort``; the delta where both PSNRs exist).
COMMON_KEYS = ("date", "git", "device", "smoke", "linked", "samples_per_vol", "loss", "model")
TWO_COHORT_KEYS = ("cohorts", "cohort_note")
MULTISTAGE_KEYS = ("multistage", "stage_epochs", "wall_seconds", "val_psnr_last",
                   "val_ssim_last", "val_l1_last", "multistage_minus_direct_psnr")
DIRECT_KEYS = ("multistage", "direct_supervised", "epochs", "wall_seconds", "val_psnr_last",
               "val_ssim_last", "val_l1_last")


def _cohort_bids(smoke: bool, subjects: int, vol, seed: int, link_tag_offset: int,
                 env_var: str = "CONVBENCH_DATA") -> str:
    """The cached linked cohort; offset 0 shares the quality record's cache,
    another offset reads ``{env_var}_B``."""
    cache = os.environ.get(env_var if not link_tag_offset else f"{env_var}_B",
                           quality_record.fixture_cache(smoke, subjects, link_tag_offset))
    return quality_record.cached_fixture(cache, subjects, vol, seed=seed,
                                         link_tag_offset=link_tag_offset)


def build(args, pretrain_bids: Optional[str] = None, target_bids: Optional[str] = None,
          workdir: Optional[str] = None):
    """``(cfg, data, pretrain_data)``: the config and the target cohort's
    data module, with ``--two-cohort`` also the pretrain cohort's (else
    None). ``pretrain_bids`` and ``target_bids`` hand in trees of the
    caller's (default: the cached cohorts, 12 subjects at offset 0 and, for
    ``--two-cohort``, 5 at offset 10; 6 and 4 with ``--smoke``);
    ``workdir`` holds the logs and checkpoints (default: a new temporary
    directory)."""
    from unet_bssfp_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
    from unet_bssfp_tpu_torch.data.datamodule import DoveDataModule

    subjects = 6 if args.smoke else 12
    vol = quality_record.SMOKE_VOLUME if args.smoke else quality_record.FULL_VOLUME
    bids = pretrain_bids or _cohort_bids(args.smoke, subjects, vol, seed=0, link_tag_offset=0)
    if args.smoke:
        patch, batch, features, dtype = 16, 4, (4, 8, 8, 16, 16, 4), "float32"
    else:
        patch, batch, features, dtype = 64, 8, (32, 64, 128, 256, 512, 32), "bfloat16"
    workdir = workdir or tempfile.mkdtemp(prefix="msbench_")
    cfg = Config(
        data=DataConfig(data_dir=bids, batch_size=batch, patch_size=patch,
                        samples_per_vol=args.samples_per_vol, volume_shape=vol,
                        val_split=0.2, test_split=0.2, cache_volumes=True),
        model=ModelConfig(features=features, multistage_features=features,
                          compute_dtype=dtype),
        train=TrainConfig(log_dir=os.path.join(workdir, "logs"),
                          checkpoint_dir=os.path.join(workdir, "ckpts"),
                          with_perceptual=False,
                          # every stage runs its whole budget (the A/B is
                          # budget-matched; an early stop in one arm would
                          # unbalance it)
                          early_stop_patience=10_000, seed=42))
    data = DoveDataModule(bids, config=cfg.data)
    if not args.two_cohort:
        return cfg, data, None
    # The offset-0 cohort above is the large PRETRAIN cohort; the TARGET
    # cohort is small (3/1/1 subjects at 5) with a shifted _linked_map (a
    # different input → target relation of the same family) and other
    # fields (seed 1): the structure the thesis's finetune-over-direct claim
    # rests on. Both arms train and are judged on the target cohort; the
    # multistage arm pretrains its DT autoencoder on the large one.
    bids_b = target_bids or _cohort_bids(args.smoke, 4 if args.smoke else 5,
                                         cfg.data.volume_shape, seed=1, link_tag_offset=10)
    cfg_b = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, data_dir=bids_b))
    return cfg_b, DoveDataModule(bids_b, config=cfg_b.data), data


def direct_state(cfg, modality: str, device=None, state_dict=None):
    """The direct arm's net and state: a ``MultiInputUNet`` with
    ``modality``'s head, PRETRAIN-stage semantics (every parameter trainable
    at the base lr), weights drawn from ``train.seed`` unless
    ``state_dict`` is given. Returns ``(state, train_step, eval_step)``."""
    from unet_bssfp_tpu_torch.models.multi_input_unet import TrainingState
    from unet_bssfp_tpu_torch.train.multistage import (
        build_multi_input_unet,
        create_supervised_state,
        make_supervised_eval_step,
        make_supervised_train_step,
    )

    tcfg = cfg.train
    net = build_multi_input_unet(modality, cfg.model, device)
    state = create_supervised_state(tcfg.seed, net, tcfg, TrainingState.PRETRAIN,
                                    state_dict=state_dict)
    return state, make_supervised_train_step(net, tcfg), make_supervised_eval_step(net, tcfg)


def run_direct(args, cfg, data, modality: str, device=None) -> dict:
    """The budget-matched direct arm (the thesis's "direct training"
    comparator): :func:`direct_state` trained from scratch for ``pretrain +
    transfer + finetune`` epochs on ``modality`` → ``dwi-tensor_orig``,
    epochs from ``epoch_seeds(train.seed + 17, epoch)``. Returns the last
    epoch's row."""
    import torch

    from unet_bssfp_tpu_torch.train.logging import MetricLogger
    from unet_bssfp_tpu_torch.train.loop import epoch_seeds
    from unet_bssfp_tpu_torch.train.state import resolve_device

    dev = resolve_device(device)
    tcfg = cfg.train
    state, train_step, eval_step = direct_state(cfg, modality, dev)
    logger = MetricLogger(os.path.join(tcfg.log_dir, f"direct-{modality}"))
    keys = (modality, "dwi-tensor")
    data.setup()
    row = {}
    for epoch in range(args.pretrain + args.transfer + args.finetune):
        train_seed, val_seed = epoch_seeds(tcfg.seed + 17, epoch)
        for batch in data.train_batches(train_seed, keys=keys, device=dev):
            m = train_step(state, batch[modality], batch["dwi-tensor_orig"])
            logger.log_step(dict(sorted(m.items())))
        for batch in data.val_batches(val_seed, keys=keys, device=dev):
            m, _ = eval_step(state, batch[modality], batch["dwi-tensor_orig"])
            logger.log_step(dict(sorted(m.items())))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        row = logger.end_epoch(epoch)
    logger.finish()
    return row


def run_multistage_arm(args, cfg, data, pretrain_data, device=None):
    """The three stages at ``--pretrain/--transfer/--finetune`` epochs.
    Returns ``(states, last row, wall seconds)``."""
    import torch

    from unet_bssfp_tpu_torch.models.multi_input_unet import TrainingState
    from unet_bssfp_tpu_torch.train.multistage import run_multistage
    from unet_bssfp_tpu_torch.train.state import resolve_device

    dev = resolve_device(device)
    t0 = time.perf_counter()
    states, row = run_multistage(
        data, args.modality, config=cfg, device=dev,
        epochs_per_stage={TrainingState.PRETRAIN: args.pretrain,
                          TrainingState.TRANSFER: args.transfer,
                          TrainingState.FINE_TUNE: args.finetune},
        pretrain_data=pretrain_data)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return states, row, time.perf_counter() - t0


def ab_entries(args, device: str, ms_row: dict, ms_wall: float, direct_row: dict,
               direct_wall: float):
    """The multistage and direct entries, as the JAX script writes them."""
    def f(row, key):
        return round(float(row[key]), 4) if row.get(key) is not None else None

    common = {
        "date": datetime.datetime.now().isoformat(timespec="seconds"),
        "git": quality_record.git_rev(),
        "device": device,
        "smoke": args.smoke,
        "linked": True,
        "samples_per_vol": args.samples_per_vol,
        "loss": "L1+(1-SSIM)",
        "model": "MultiInputUNet",
    }
    if args.two_cohort:
        common["cohorts"] = 2
        common["cohort_note"] = (
            "pretrain cohort: large offset-0 linked fixture; target cohort: small seed-1 "
            "link_tag_offset-10 fixture (shifted generating map); both arms judged on the "
            "target cohort's val split")
    ms_entry = {
        **common,
        "multistage": True,
        "stage_epochs": {"pretrain": args.pretrain, "transfer": args.transfer,
                         "finetune": args.finetune},
        "wall_seconds": round(ms_wall, 1),
        "val_psnr_last": f(ms_row, "val_metric_PSNR"),
        "val_ssim_last": f(ms_row, "val_metric_SSIM"),
        "val_l1_last": f(ms_row, "val_metric_L1"),
    }
    direct_entry = {
        **common,
        "multistage": False,
        "direct_supervised": True,
        "epochs": args.pretrain + args.transfer + args.finetune,
        "wall_seconds": round(direct_wall, 1),
        "val_psnr_last": f(direct_row, "val_metric_PSNR"),
        "val_ssim_last": f(direct_row, "val_metric_SSIM"),
        "val_l1_last": f(direct_row, "val_metric_L1"),
    }
    if ms_entry["val_psnr_last"] is not None and direct_entry["val_psnr_last"] is not None:
        ms_entry["multistage_minus_direct_psnr"] = round(
            ms_entry["val_psnr_last"] - direct_entry["val_psnr_last"], 3)
    return ms_entry, direct_entry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pretrain", type=int, default=8)
    ap.add_argument("--transfer", type=int, default=4)
    ap.add_argument("--finetune", type=int, default=8)
    ap.add_argument("--samples-per-vol", type=int, default=32)
    ap.add_argument("--modality", default="pc-bssfp")
    ap.add_argument("--two-cohort", action="store_true",
                    help="domain-transfer A/B: pretrain the DT autoencoder on the large "
                         "offset-0 cohort, transfer/finetune and judge on a small "
                         "shifted-map cohort; the direct arm trains only on the small "
                         "cohort with the same total epoch budget")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--no-record", action="store_true")
    ap.add_argument("--device", default=None, help="default cuda; cpu to run on the CPU")
    args = ap.parse_args(argv)

    from unet_bssfp_tpu_torch.train.state import resolve_device

    quality_record.device_startup_probe(grace_s=0.0, timeout_s=150.0, device=args.device)
    dev = resolve_device(args.device)
    cfg, data, pretrain_data = build(args)
    data.setup()
    if pretrain_data is not None:
        pretrain_data.setup()

    _, ms_row, ms_wall = run_multistage_arm(args, cfg, data, pretrain_data, dev)
    t0 = time.perf_counter()
    direct_row = run_direct(args, cfg, data, args.modality, dev)
    direct_wall = time.perf_counter() - t0
    entries = ab_entries(args, quality_record.device_label(dev), ms_row, ms_wall,
                         direct_row, direct_wall)
    print(json.dumps(list(entries), indent=2))
    print(f"multistage - direct = {entries[0].get('multistage_minus_direct_psnr')} dB "
          "(reference band: +2 to +9 dB on real data)")
    if not args.no_record:
        n = quality_record.append_record(RECORD_PATH, list(entries))
        print(f"recorded to {RECORD_PATH} ({n} records)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
