"""Post-process a prediction directory and print its ROI error table
(counterpart of ``src/eval.py``'s ``main``).

  python -m unet_bssfp_tpu_torch.eval PRED_DIR BIDS_DIR [--rescale-args F] \\
      [--out-csv F] [--device cuda] [--num-workers N]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from unet_bssfp_tpu_torch.eval.evaluate import (
    calc_error_table,
    eval_dwi_tensors,
    format_table,
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
    parser.add_argument("--checkpoint", action="append", default=[],
                        metavar="MODALITY=PATH", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.checkpoint:
        parser.error("--checkpoint (generate predictions first) is not in the "
                     "PyTorch port yet: it needs test inference and the data "
                     "module; run it with src/eval.py, or pass a directory of "
                     "predictions")
    eval_dwi_tensors(args.pred_path, args.rescale_args, args.num_workers, args.device)
    rows = calc_error_table(args.pred_path, args.data_path, args.out_csv,
                            num_workers=args.num_workers, device=args.device)
    print(format_table(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
