"""Training CLI (the counterpart of ``src/train.py``): trains the given
modalities in turn, each run logged under ``train.log_dir`` and
checkpointed under ``train.checkpoint_dir``.

  python -m unet_bssfp_tpu_torch.train BIDS_DIR [--modalities pc-bssfp ...]
      [--config cfg.json] [--ckpt PATH|auto] [--debug] [--max-epochs N]
      [--multistage] [--whole-volume] [--device cuda:N|cpu]
      [--coordinator-address tcp://HOST:PORT --num-processes N --process-id I]

Without ``--device`` it trains on every visible card, data-parallel, as the
JAX package trains on every device (``parallel.mesh.default_mesh``: the
cards that ``data.batch_size`` divides; on one card, that card).
``--device cuda:N`` or ``cpu`` trains on that one device; asking for CUDA
where there is none raises.

Across processes (``parallel.distributed``, ``jax.distributed``'s
arguments): ``--coordinator-address``, ``--num-processes`` and
``--process-id``, or ``torchrun``'s ``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``
(``scripts/torch_port_run_train.sh`` starts one process per card). Each
process trains on its own card (``cuda:{LOCAL_RANK}``; more processes than
cards raises) or on the ``--device`` it names (``cpu``, or one card that
the processes share), on its stride-slice of the data
(``data.process_split``) with ``batch_size`` per process; process 0 alone
writes the logs and checkpoints. ``--ckpt auto`` resumes each modality from the newest whole
checkpoint of its newest run. ``--multistage`` runs the pretrain →
transfer → finetune regime (``train/multistage.py``) for each modality
instead of the GAN, ``--max-epochs`` applying to every stage, each stage
checkpointed under ``multistage-{modality}-{stage}``.
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
from unet_bssfp_tpu_torch.models.multi_input_unet import TrainingState
from unet_bssfp_tpu_torch.parallel import distributed
from unet_bssfp_tpu_torch.train.loop import train_model
from unet_bssfp_tpu_torch.train.multistage import run_multistage
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
                        help="the pretrain → transfer → finetune regime (MultiInputUNet) "
                             "instead of the GAN")
    parser.add_argument("--whole-volume", action="store_true",
                        help="train on whole (96, 128, 128) volumes instead of 64³ patches")
    parser.add_argument("--device", default=None,
                        help="cuda:N or cpu: train on that one device (default: every "
                             "visible card; in a process group, the process's own card)")
    parser.add_argument("--coordinator-address", default=None,
                        help="the process group's rendezvous: tcp://HOST:PORT, HOST:PORT "
                             "or file:///PATH (default: torchrun's MASTER_ADDR:MASTER_PORT)")
    parser.add_argument("--num-processes", type=int, default=None,
                        help="processes in the group (default: WORLD_SIZE, else 1)")
    parser.add_argument("--process-id", type=int, default=None,
                        help="this process's rank (default: RANK, else 0)")
    args = parser.parse_args(argv)

    env = os.environ
    num = args.num_processes or int(env.get("WORLD_SIZE", 1))
    if num > 1:
        rank = args.process_id if args.process_id is not None else int(env.get("RANK", 0))
        address = args.coordinator_address
        if address is None and "MASTER_ADDR" in env:
            address = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        if address is None:
            parser.error("--num-processes > 1 needs --coordinator-address (or torchrun's "
                         "MASTER_ADDR and MASTER_PORT)")
        distributed.initialize(address, num, rank, device=args.device,
                               local_rank=int(env.get("LOCAL_RANK", rank)))
    try:
        _train(args)
    finally:
        distributed.shutdown()


def _train(args) -> None:
    device = resolve_device(args.device) if args.device is not None else None
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
        if args.multistage:
            epochs = dict.fromkeys(TrainingState, args.max_epochs) if args.max_epochs else None
            _, row = run_multistage(data, modality, config, epochs_per_stage=epochs,
                                    device=device)
            print(f"Multi-stage {modality} final metrics: {row}")
            continue
        best = train_model(data, modality, ckpt_path=args.ckpt, debug=args.debug,
                           config=config, max_epochs=args.max_epochs, device=device)
        print(f"Best checkpoint for {modality}: {best}")


if __name__ == "__main__":
    main()
