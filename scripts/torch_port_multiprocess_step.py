#!/usr/bin/env python3
"""One process of a GAN training run across processes
(``parallel.distributed``): the port's counterpart of
``tests/multihost_worker.py``, run by ``tests/test_torch_port_multiprocess.py``
on the CPU and by ``chip_smoke.py`` on the card.

Each process joins the group, takes its share of the global batch and runs
the steps of each ``--run`` on it with one state per run (the same weights
on every process), then, with ``--finetune``, one FINE_TUNE step of the
multi-stage net. The batch comes from ``--data``:

- ``bids:DIR``: the JAX worker's geometry: a ``DoveDataModule`` over DIR
  (16³ volumes, val and test 0.25, ``process_split``), this process's
  train samples' DT volumes as input and target (``dwi-tensor``), their
  pc-bSSFP volumes as the FINE_TUNE step's input;
- ``random:SEED``: a ``--global-batch`` × ``--patch``³ batch drawn on the
  host from SEED (pc-bSSFP inputs, DT targets), this process's rows
  ``[rank·b, (rank+1)·b)``.

Each process writes ``OUT/rank{R}.json``: its samples, the global batch's
fingerprint (sum and sum of squares), per step the metrics, the kernel
launches and the seconds (the card synchronised around the step), and a
sha256 of every weight and buffer after each run. ``--save`` (process 0)
writes the final state dicts for a comparison with another run.

  python scripts/torch_port_multiprocess_step.py --process-id 0 --num-processes 2 \\
      --coordinator-address file:///tmp/rdv --device cpu --data bids:/tmp/bids \\
      --run float32:2:1e-6:0 --out /tmp/mp

A run is ``DTYPE:STEPS[:LR[:DROPOUT[:ddp]]]`` (float32, bfloat16 or
float64; defaults: ``TrainConfig``'s lr and ``ModelConfig``'s dropout;
``ddp``: the step with ``ddp_parity``).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SMALL = dict(features=(4, 4, 4, 4, 8, 4), disc_features=(4, 8))
MS_SMALL = (4, 8, 8, 16, 16, 4)
SEED = 0


def digest(*modules) -> str:
    """sha256 over every parameter and buffer of ``modules``, in order."""
    import torch

    h = hashlib.sha256()
    for m in modules:
        for name, t in m.state_dict().items():
            h.update(name.encode())
            h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy())
    return h.hexdigest()


def local_batch(args, dev):
    """``(x, y, x_finetune, record)``: this process's share of the batch."""
    import numpy as np
    import torch

    from unet_bssfp_tpu_torch.config import DataConfig
    from unet_bssfp_tpu_torch.data.datamodule import DoveDataModule
    from unet_bssfp_tpu_torch.parallel import distributed

    kind, _, where = args.data.partition(":")
    rank, world = distributed.process_index(), distributed.process_count()
    if kind == "bids":
        dcfg = DataConfig(data_dir=where, volume_shape=(16, 16, 16), test_split=0.25,
                          val_split=0.25, process_split=True)
        data = DoveDataModule(where, config=dcfg)
        data.prepare_data()
        vols = [data.load_subject(s, ("dwi-tensor", "pc-bssfp")) for s in data.train_samples]
        y = torch.from_numpy(np.stack([v["dwi-tensor"] for v in vols]))
        xf = torch.from_numpy(np.stack([v["pc-bssfp"] for v in vols]))
        record = {"local_samples": len(vols),
                  "subjects": {split: [s.subject for s in getattr(data, f"{split}_samples")]
                               for split in ("train", "val", "test")}}
        x = y
    elif kind == "random":
        b = args.global_batch // world
        rng = np.random.default_rng(int(where))
        lead = (args.global_batch,) + (args.patch,) * 3
        x_all = rng.random(lead + (24,), dtype=np.float32)
        y_all = rng.random(lead + (6,), dtype=np.float32)
        x = torch.from_numpy(x_all[rank * b:(rank + 1) * b])
        y = torch.from_numpy(y_all[rank * b:(rank + 1) * b])
        xf, record = x, {"local_samples": b}
    else:
        raise ValueError(f"--data {args.data!r}: expected bids:DIR or random:SEED")
    sums = torch.tensor([float(x.double().sum()), float((x.double() ** 2).sum())],
                        dtype=torch.float64, device=dev)
    distributed.sum_in_place(sums)
    record["batch_sum"], record["batch_sumsq"] = sums.tolist()
    return x.to(dev), y.to(dev), xf.to(dev), record


def local_mesh(args, dev):
    """``--positions`` data positions over this process's device (on the
    CPU over ``cpu`` and ``cpu:0``, two real replicas), or None."""
    import torch

    from unet_bssfp_tpu_torch.parallel.mesh import Mesh

    if args.positions == 1:
        return None
    entries = ((torch.device("cpu"), torch.device("cpu", 0)) if dev.type == "cpu"
               else (dev,))
    return Mesh([[entries[i % len(entries)]] for i in range(args.positions)], ("data",))


def gan_state(args, modality, dtype, dropout, tcfg, dev, mesh):
    """The GAN state on ``dev`` (or ``mesh``), the weights ``--weights``
    holds where given (else drawn from SEED), float64 with every module
    computing in its input's dtype."""
    import torch

    from unet_bssfp_tpu_torch.config import Config
    from unet_bssfp_tpu_torch.models.discriminator import Discriminator
    from unet_bssfp_tpu_torch.models.generator import Generator
    from unet_bssfp_tpu_torch.models.layers import bind_dropout_generators
    from unet_bssfp_tpu_torch.parallel.mesh import broadcast, replicate
    from unet_bssfp_tpu_torch.train.state import GANTrainState, create_gan_state, make_optimizer

    widths = SMALL if args.width == "small" else {}
    mcfg = dataclasses.replace(Config().model, dropout=dropout, **widths,
                               compute_dtype="float32" if dtype == "float64" else dtype)
    state = create_gan_state(SEED, modality, mcfg, tcfg, dev, mesh=mesh)
    if dtype == "float64":
        gen = Generator(modality, features=mcfg.features, dropout=dropout).double()
        disc = Discriminator(modality, features=mcfg.disc_features).double()
        gen.load_state_dict(state.gen.state_dict())
        disc.load_state_dict(state.disc.state_dict())
        if mesh is not None:
            replicate(gen, mesh)
            replicate(disc, mesh)
        gen, disc = gen.to(dev), disc.to(dev)
        rng, *reps = bind_dropout_generators(gen, SEED + 2)
        state = GANTrainState(0, rng, gen, disc, make_optimizer(gen.parameters(), tcfg),
                              make_optimizer(disc.parameters(), tcfg), tuple(reps))
    if args.weights:
        saved = torch.load(args.weights, map_location="cpu", weights_only=True)
        state.gen.load_state_dict(saved["gen"])
        state.disc.load_state_dict(saved["disc"])
        broadcast(state.gen)
        broadcast(state.disc)
    return state


def timed(dev, fn):
    """``(metrics as floats, launches, seconds)`` of ``fn()``, the launch
    counts reset just before it and the card synchronised around it."""
    import torch

    from unet_bssfp_tpu_torch.ops import kernels as K

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    K.reset_launches()
    t0 = time.perf_counter()
    metrics = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    sec = time.perf_counter() - t0
    return {k: float(v) for k, v in metrics.items()}, K.launches(), sec


def run_gan(args, spec, x, y, dev, mesh):
    import torch

    from unet_bssfp_tpu_torch.config import Config
    from unet_bssfp_tpu_torch.train.steps import make_train_step

    parts = spec.split(":")
    dtype, steps = parts[0], int(parts[1])
    base = Config()
    lr = float(parts[2]) if len(parts) > 2 else base.train.lr
    dropout = float(parts[3]) if len(parts) > 3 else base.model.dropout
    tcfg = dataclasses.replace(base.train, lr=lr)
    modality = "dwi-tensor" if args.data.startswith("bids") else "pc-bssfp"
    state = gan_state(args, modality, dtype, dropout, tcfg, dev, mesh)
    ddp = len(parts) > 4 and parts[4] == "ddp"
    step = make_train_step(state.gen, state.disc, tcfg, mesh=mesh, ddp_parity=ddp)
    if dtype == "float64":
        x, y = x.double(), y.double()
    rows = []
    for _ in range(steps):
        m, c, sec = timed(dev, lambda: step(state, x, y))
        rows.append({"metrics": m, "launches": c, "s": sec})
    out = {"spec": spec, "steps": rows, "digest": digest(state.gen, state.disc)}
    return out, state


def run_finetune(args, x, y, dev, mesh):
    """One FINE_TUNE step of the multi-stage net (pc-bssfp → DT)."""
    from unet_bssfp_tpu_torch.config import Config
    from unet_bssfp_tpu_torch.models.multi_input_unet import MultiInputUNet, TrainingState
    from unet_bssfp_tpu_torch.parallel.mesh import replicate
    from unet_bssfp_tpu_torch.train import multistage as ms

    tcfg = Config().train
    if args.finetune == "float64":
        net = MultiInputUNet(modality="pc-bssfp", features=MS_SMALL, dropout=0.0).double()
        if mesh is not None:
            replicate(net, mesh)
        net, x, y = net.to(dev), x.double(), y.double()
    else:
        mcfg = dataclasses.replace(Config().model, compute_dtype=args.finetune, dropout=0.0,
                                   **({"multistage_features": MS_SMALL}
                                      if args.width == "small" else {}))
        net = ms.build_multi_input_unet("pc-bssfp", mcfg, dev, mesh=mesh)
    state = ms.create_supervised_state(SEED, net, tcfg, TrainingState.FINE_TUNE)
    step = ms.make_supervised_train_step(net, tcfg, mesh=mesh)
    m, c, sec = timed(dev, lambda: step(state, x, y))
    return {"metrics": m, "launches": c, "s": sec, "digest": digest(net)}, net


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--coordinator-address", required=True)
    ap.add_argument("--device", default=None, help="default: the process's own card")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--data", required=True, help="bids:DIR or random:SEED")
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--patch", type=int, default=64)
    ap.add_argument("--width", choices=("small", "full"), default="small")
    ap.add_argument("--positions", type=int, default=1)
    ap.add_argument("--run", action="append", default=[],
                    metavar="DTYPE:STEPS[:LR[:DROPOUT[:ddp]]]")
    ap.add_argument("--finetune", default=None, choices=("float32", "bfloat16", "float64"),
                    help="one FINE_TUNE step in this dtype after the runs")
    ap.add_argument("--weights", default=None, help="a .pt of {'gen': ..., 'disc': ...}")
    ap.add_argument("--save", default=None, help="process 0: the final state dicts (.pt)")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    import torch

    from unet_bssfp_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    # f32 as f32 on the card (chip_smoke.py's reference step runs so too)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    backend = distributed.initialize(args.coordinator_address, args.num_processes,
                                     args.process_id, backend=args.backend,
                                     device=args.device, timeout_s=args.timeout)
    try:
        dev = distributed.device()
        rank = distributed.process_index()
        x, y, xf, record = local_batch(args, dev)
        mesh = local_mesh(args, dev)
        record.update(rank=rank, world=distributed.process_count(), backend=backend,
                      device=str(dev), runs=[])
        saved = {}
        for spec in args.run:
            out, state = run_gan(args, spec, x, y, dev, mesh)
            record["runs"].append(out)
            saved.update(gen=state.gen.state_dict(), disc=state.disc.state_dict())
            del state
        if args.finetune:
            record["finetune"], net = run_finetune(args, xf, y, dev, mesh)
            saved["net"] = net.state_dict()
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"rank{rank}.json"), "w") as f:
            json.dump(record, f)
        if args.save and rank == 0:
            torch.save({k: {n: t.cpu() for n, t in sd.items()} for k, sd in saved.items()},
                       args.save)
        distributed.barrier()
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
