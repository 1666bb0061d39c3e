"""Post-process a prediction directory and print its ROI error table
(counterpart of ``src/eval.py``'s ``main``).

  python -m unet_bssfp_tpu_torch.eval PRED_DIR BIDS_DIR [--rescale-args F] \\
      [--out-csv F] [--device cuda] [--num-workers N] \\
      [--checkpoint MODALITY=PATH ... [--config cfg.json]]

With ``--checkpoint`` (repeatable) the predictions are generated first: test
inference of each modality from its checkpoint into ``PRED_DIR/<modality>``
(``gen_predictions``) on the test split of ``BIDS_DIR``, with the config of
``--config`` or else ``Config()``, as the JAX CLI passes its config down
(not the checkpoint's ``config.json``).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from unet_bssfp_tpu_torch.config import Config
from unet_bssfp_tpu_torch.data.datamodule import DoveDataModule
from unet_bssfp_tpu_torch.eval.evaluate import (
    calc_error_table,
    eval_dwi_tensors,
    format_table,
    gen_predictions,
)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m unet_bssfp_tpu_torch.eval",
        description="Post-process predictions and build error tables")
    parser.add_argument("pred_path", help="prediction directory root")
    parser.add_argument("data_path", help="BIDS dataset root (masks/probseg)")
    parser.add_argument("--rescale-args", default=None, help="rescale_args_dwi.txt path")
    parser.add_argument("--out-csv", default="relative_errors.csv")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--num-workers", type=int, default=8)
    parser.add_argument("--checkpoint", action="append", default=[], metavar="MODALITY=PATH",
                        help="generate predictions first: test inference for MODALITY from "
                             "the checkpoint at PATH into <pred_path>/<modality> (repeatable)")
    parser.add_argument("--config", default=None, help="JSON config path")
    args = parser.parse_args(argv)
    if args.checkpoint:
        for spec in args.checkpoint:
            if "=" not in spec:
                parser.error(f"--checkpoint expects MODALITY=PATH, got {spec!r}")
        config = Config()
        if args.config:
            with open(args.config) as f:
                config = Config.from_json(f.read())
        data = DoveDataModule(args.data_path, config=config.data)
        data.prepare_data()
        gen_predictions(data, dict(spec.split("=", 1) for spec in args.checkpoint),
                        args.pred_path, args.rescale_args, config, args.num_workers,
                        args.device)
    else:
        eval_dwi_tensors(args.pred_path, args.rescale_args, args.num_workers, args.device)
    rows = calc_error_table(args.pred_path, args.data_path, args.out_csv,
                            num_workers=args.num_workers, device=args.device)
    print(format_table(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
