"""Export a trained checkpoint to a self-contained serving artifact (the
counterpart of ``src/export.py``).

Freezes the eval-mode generator (weights in the program, ATen ops only)
into one file that ``python -m unet_bssfp_tpu_torch.predict --exported`` (or
any PyTorch process, through ``eval.export.load_exported``) serves without
the model code or the checkpoint format. The artifact runs on the device
type it was exported on: export on the serving device.

Usage:
  python -m unet_bssfp_tpu_torch.export --checkpoint CKPT --modality pc-bssfp \
      --out model.ubt [--config cfg.json] [--patch] [--batch N] [--device cuda]

``--checkpoint`` is a training step of the port (its directory or its
``state.pt``), whose generator alone is read; its run's ``config.json`` is
the config unless ``--config`` is given. Runs on CUDA unless ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
from typing import Optional, Sequence

from unet_bssfp_tpu_torch.config import MODALITY_CHANNELS, Config
from unet_bssfp_tpu_torch.eval.export import export_generator, save_exported
from unet_bssfp_tpu_torch.train.checkpoint import generator_state_dict, load_config_for_checkpoint


def git_revision() -> str:
    """The short commit of this checkout, or ``unknown``."""
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            capture_output=True, text=True, check=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv: Optional[Sequence[str]] = None) -> str:
    parser = argparse.ArgumentParser(description="checkpoint → serving artifact")
    parser.add_argument("--checkpoint", required=True,
                        help="a training step (directory or state.pt)")
    parser.add_argument("--modality", default="pc-bssfp", choices=tuple(MODALITY_CHANNELS))
    parser.add_argument("--out", required=True, help="artifact path")
    parser.add_argument("--config", default=None, help="JSON config path")
    parser.add_argument("--batch", type=int, default=1, help="serving batch size")
    parser.add_argument("--patch", action="store_true",
                        help="export at patch shape (for grid-stitched serving) instead of "
                             "the whole-volume shape")
    parser.add_argument("--device", default="cuda",
                        help="the device the artifact is traced for and will serve on")
    args = parser.parse_args(argv)

    if args.config:
        with open(args.config) as f:
            config = Config.from_json(f.read())
    else:
        saved = load_config_for_checkpoint(args.checkpoint)
        config = Config.from_json(saved) if saved else Config()

    in_ch = MODALITY_CHANNELS[args.modality]
    if args.patch:
        spatial = (config.data.patch_size,) * 3
    else:
        spatial = tuple(config.data.volume_shape)
    shape = (args.batch, *spatial, in_ch)

    program, meta = export_generator(
        args.modality, config.model, generator_state_dict(args.checkpoint), shape,
        device=args.device,
        extra_meta={"checkpoint": os.path.abspath(args.checkpoint), "git": git_revision()})
    save_exported(program, meta, args.out)
    size_mb = os.path.getsize(args.out) / 1e6
    print(f"wrote {args.out} ({size_mb:.1f} MB): {args.modality} {list(shape)} → "
          f"{meta['out_channels']}ch, device {meta['device']}")
    return args.out


if __name__ == "__main__":
    main()
