"""Training CLI (the counterpart of ``src/train.py``): trains the given
modalities in turn on one device, each run logged under ``train.log_dir``
and checkpointed under ``train.checkpoint_dir``.

  python -m unet_bssfp_tpu_torch.train BIDS_DIR [--modalities pc-bssfp ...]
      [--config cfg.json] [--ckpt PATH|auto] [--debug] [--max-epochs N]
      [--whole-volume] [--device cuda]

Runs on CUDA unless ``--device cpu``; asking for CUDA where there is none
raises. ``--ckpt auto`` resumes each modality from the newest whole
checkpoint of its newest run. ``--multistage`` is not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
from typing import Optional, Sequence

from unet_bssfp_tpu_torch.config import MODALITIES, Config
from unet_bssfp_tpu_torch.data.datamodule import DoveDataModule
from unet_bssfp_tpu_torch.train.loop import train_model
from unet_bssfp_tpu_torch.train.state import resolve_device


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Train bSSFP→DT models")
    parser.add_argument("data_dir", help="BIDS dataset root")
    parser.add_argument("--modalities", nargs="*", default=list(MODALITIES),
                        help="modalities to train in turn")
    parser.add_argument("--config", default=None, help="JSON config path")
    parser.add_argument("--ckpt", default=None,
                        help="checkpoint to resume from, or 'auto' (the newest)")
    parser.add_argument("--debug", action="store_true",
                        help="autograd anomaly mode, and a trace of the first steps")
    parser.add_argument("--max-epochs", type=int, default=None)
    parser.add_argument("--multistage", action="store_true",
                        help="the pretrain → transfer → finetune regime (not ported yet)")
    parser.add_argument("--whole-volume", action="store_true",
                        help="train on whole (96, 128, 128) volumes instead of 64³ patches")
    parser.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    args = parser.parse_args(argv)

    if args.multistage:
        raise NotImplementedError(
            "--multistage: the multi-stage regime is not ported yet (ROADMAP.md §1 item 4b)")
    device = resolve_device(args.device)
    config = Config()
    if args.config:
        with open(args.config) as f:
            config = Config.from_json(f.read())
    if args.whole_volume:
        config = dataclasses.replace(
            config, data=dataclasses.replace(config.data, whole_volume=True))
    # W&B key bootstrap (reference src/train.py:81-84)
    if os.environ.get("WANDB_API_KEY") is None and os.path.exists("wandb-api-key.json"):
        with open("wandb-api-key.json") as f:
            os.environ["WANDB_API_KEY"] = json.load(f)["key"]

    print(f"Last run on {datetime.datetime.now()}")
    data = DoveDataModule(args.data_dir, config=config.data)
    data.prepare_data()
    for modality in args.modalities:
        best = train_model(data, modality, ckpt_path=args.ckpt, debug=args.debug,
                           config=config, max_epochs=args.max_epochs, device=device)
        print(f"Best checkpoint for {modality}: {best}")


if __name__ == "__main__":
    main()
