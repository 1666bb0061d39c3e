#!/usr/bin/env python3
"""The ``CANONICAL_CPU`` convergence regime (``scripts/convergence_bench.py``)
through the port's ``Trainer``, and its spread over seeds.

  python scripts/torch_port_convergence.py [--device cuda] [--seeds 42 43 44] [--own-init]
  python scripts/torch_port_convergence.py --jax --seeds 42 43 44   # JAX's own
  python scripts/torch_port_convergence.py --write-init             # the init file

The regime is ``convergence_bench.CANONICAL_CPU`` (imported): the linked
synthetic fixture (DT a fixed function of the bSSFP field) of 6 subjects
at (24, 32, 32), seed 0, a 4/1/1 split, 12 patches of 16³ a volume, batch 4,
the smoke-scale nets (features (4, 8, 8, 16, 16, 4), discriminator (8, 8,
16)) in f32, BCE + L1, ``CANONICAL_CPU["epochs"]`` epochs, and its band on
the last epoch's val PSNR. The smoke-scale sizes are ``convergence_bench.run``'s
own (its ``smoke`` branch; ``tests/test_torch_port_convergence.py`` holds
the two configs equal). ``--seeds`` sets ``train.seed``: the dropout
masks, every epoch's data seed and, with ``--own-init``, the initial
weights; the fixture and the split stay. ``--jax`` runs the JAX package's regime itself through
``convergence_bench.run`` with the seed replaced, on one CPU device.

The band (6.487 ± 1.0 dB) was pinned on one initial draw: the JAX
package's weights from ``PRNGKey(42)``. The last epoch's PSNR follows the
initial weights far more than the data and dropout draws (PERF.md §6:
JAX's own seeds 43 and 44 land at 7.684 and 8.29 dB, outside it), and
``jax.random``'s draws cannot be made without JAX. So the port's run starts
from that same draw, the generator's and discriminator's initial weights
of ``PRNGKey(42)`` converted by ``weights.from_flax`` into
``constants/canonical_cpu_init.pt`` (``--write-init``, which needs JAX;
``tests/test_torch_port_convergence.py`` holds the file to JAX's init), and
draws its own data, augmentation and dropout. ``--own-init`` starts from
the port's own draw of ``train.seed`` instead.

Prints one JSON line per run (the last epoch's val PSNR beside the band,
the first and last train L1, wall seconds, the device) and a summary line.
The port's run needs no JAX; ``--jax`` needs it.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import statistics
import sys
import tempfile
import time
from typing import Optional, Sequence

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scripts.convergence_bench import CANONICAL_CPU  # noqa: E402

INIT_FILE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "constants", "canonical_cpu_init.pt")
SMOKE = dict(volume_shape=(24, 32, 32), patch_size=16, batch_size=4, subjects=6,
             features=(4, 8, 8, 16, 16, 4), disc_features=(8, 8, 16),
             compute_dtype="float32")


def band():
    return (CANONICAL_CPU["expected_psnr"] - CANONICAL_CPU["band_db"],
            CANONICAL_CPU["expected_psnr"] + CANONICAL_CPU["band_db"])


def port_config(root: str, seed: int):
    """The port's ``Config`` of the regime, logging under ``root``."""
    from unet_bssfp_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig

    return Config(
        data=DataConfig(data_dir=os.path.join(root, "bids"), batch_size=SMOKE["batch_size"],
                        patch_size=SMOKE["patch_size"],
                        samples_per_vol=CANONICAL_CPU["samples_per_vol"],
                        volume_shape=SMOKE["volume_shape"], val_split=0.2, test_split=0.2,
                        cache_volumes=True),
        model=ModelConfig(features=SMOKE["features"], disc_features=SMOKE["disc_features"],
                          compute_dtype=SMOKE["compute_dtype"]),
        train=TrainConfig(log_dir=os.path.join(root, "logs"),
                          checkpoint_dir=os.path.join(root, "ckpts"),
                          max_epochs=CANONICAL_CPU["epochs"],
                          with_perceptual=CANONICAL_CPU["full_objective"], seed=seed))


def make_fixture(root: str) -> str:
    from unet_bssfp_tpu_torch.data.synthetic import make_synthetic_bids

    return make_synthetic_bids(
        os.path.join(root, "bids"),
        subjects=tuple(f"{i:02d}" for i in range(1, SMOKE["subjects"] + 1)),
        sessions=("1",), volume_shape=SMOKE["volume_shape"], seed=0,
        linked=CANONICAL_CPU["linked"])


def _summary(rows, wall, seed, device) -> dict:
    lo, hi = band()
    first, last = rows[0], rows[-1]
    psnr = float(last["val_metric_PSNR"])
    return {"seed": seed, "device": device, "epochs": len(rows),
            "val_psnr_last": psnr, "band": [lo, hi], "in_band": lo <= psnr <= hi,
            "train_L1_first": float(first["train_gen_loss_recon_L1"]),
            "train_L1_last": float(last["train_gen_loss_recon_L1"]),
            "wall_seconds": wall}


def write_init(path: str = INIT_FILE, seed: int = 42) -> str:
    """The JAX package's initial weights of ``PRNGKey(seed)`` for the
    regime's models (as its ``Trainer.init_state`` draws them), as the
    port's ``state_dict`` s ``{"gen": ..., "disc": ...}``."""
    import jax
    import numpy as np
    import torch

    from unet_bssfp_tpu.config import Config as JaxConfig
    from unet_bssfp_tpu.train.state import create_gan_state as jax_create_gan_state
    from unet_bssfp_tpu_torch import weights

    jcfg = JaxConfig.from_json(port_config("", seed).to_json())
    jax.config.update("jax_default_prng_impl", jcfg.train.rng_impl)
    st = jax_create_gan_state(jax.random.PRNGKey(seed), "pc-bssfp", jcfg.model, jcfg.train,
                              patch_size=jcfg.data.patch_size)
    tree = {k: jax.tree.map(np.asarray, getattr(st, k))
            for k in ("gen_params", "gen_batch_stats", "disc_params", "disc_batch_stats")}
    torch.save({m: weights.from_flax(tree[f"{m}_params"], tree[f"{m}_batch_stats"])
                for m in ("gen", "disc")}, path)
    return path


def run_port(device: str, seed: int = 42, root: Optional[str] = None,
             init: Optional[str] = INIT_FILE) -> dict:
    """One run of the regime through the port's ``Trainer`` on ``device``,
    from the weights in ``init`` (None: the port's own draw of ``seed``)."""
    import torch

    from unet_bssfp_tpu_torch.data.datamodule import DoveDataModule
    from unet_bssfp_tpu_torch.train.loop import Trainer

    root = root or tempfile.mkdtemp(prefix="torch_port_convergence_")
    cfg = port_config(root, seed)
    if not os.path.isdir(cfg.data.data_dir):
        make_fixture(root)
    trainer = Trainer(cfg, "pc-bssfp", device=device)
    state = trainer.init_state()
    if init is not None:
        sd = torch.load(init, map_location="cpu", weights_only=True)
        state.gen.load_state_dict(sd["gen"], strict=True)
        state.disc.load_state_dict(sd["disc"], strict=True)
    t0 = time.perf_counter()
    trainer.fit(DoveDataModule(cfg.data.data_dir, config=cfg.data), state)
    wall = time.perf_counter() - t0
    trainer.logger.finish()
    with open(os.path.join(trainer.logger.log_dir, "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    name = torch.cuda.get_device_name(trainer.device) if trainer.device.type == "cuda" else "cpu"
    return {**_summary(rows, wall, seed, name),
            "init": "own" if init is None else os.path.basename(init)}


def run_jax(seed: int) -> dict:
    """The JAX package's own run (``convergence_bench.run``, CANONICAL_CPU's
    settings) with ``train.seed`` = ``seed``, on one CPU device."""
    os.environ["UNET_BSSFP_PLATFORM"] = "cpu"
    import unet_bssfp_tpu.config as jconfig
    from scripts import convergence_bench

    real = jconfig.TrainConfig
    jconfig.TrainConfig = lambda **kw: real(**{**kw, "seed": seed})
    try:
        t0 = time.perf_counter()
        rec = convergence_bench.run(CANONICAL_CPU["epochs"], CANONICAL_CPU["smoke"],
                                    CANONICAL_CPU["full_objective"], CANONICAL_CPU["linked"],
                                    CANONICAL_CPU["samples_per_vol"])
        wall = time.perf_counter() - t0
    finally:
        jconfig.TrainConfig = real
    lo, hi = band()
    return {"seed": seed, "device": "jax " + rec["device"], "epochs": rec["epochs"],
            "val_psnr_last": rec["val_psnr_last"], "band": [lo, hi],
            "in_band": lo <= rec["val_psnr_last"] <= hi,
            "train_L1_first": rec["train_L1_first"], "train_L1_last": rec["train_L1_last"],
            "wall_seconds": wall}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="the port's device (cuda or cpu)")
    ap.add_argument("--seeds", type=int, nargs="+", default=[42])
    ap.add_argument("--jax", action="store_true", help="run the JAX package's regime")
    ap.add_argument("--own-init", action="store_true",
                    help="start from the port's own draw of the seed, not JAX's PRNGKey(42)")
    ap.add_argument("--write-init", action="store_true",
                    help=f"write {os.path.relpath(INIT_FILE)} from JAX's PRNGKey(42) and stop")
    args = ap.parse_args(argv)
    if args.write_init:
        print(f"wrote {write_init()}")
        return 0
    out = []
    root = None if args.jax else tempfile.mkdtemp(prefix="torch_port_convergence_")
    for seed in args.seeds:
        rec = run_jax(seed) if args.jax else run_port(
            args.device, seed, os.path.join(root, str(seed)),
            None if args.own_init else INIT_FILE)
        out.append(rec)
        print(json.dumps(rec), flush=True)
    psnr = [r["val_psnr_last"] for r in out]
    print(json.dumps({"runs": len(out), "val_psnr": psnr, "min": min(psnr), "max": max(psnr),
                      "mean": statistics.fmean(psnr), "band": list(band()),
                      "all_in_band": all(r["in_band"] for r in out)}))
    return 0 if all(r["in_band"] for r in out) else 1


if __name__ == "__main__":
    sys.exit(main())
