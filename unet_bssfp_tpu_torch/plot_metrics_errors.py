"""The report plots CLI (counterpart of ``src/plot_metrics_errors.py``).

  python -m unet_bssfp_tpu_torch.plot_metrics_errors REL_CSV \
      [--log-dirs DIR ...] [--out-dir plots]

``REL_CSV`` is a ``relative_errors.csv`` (``python -m unet_bssfp_tpu_torch.eval``
writes it); ``--log-dirs`` are searched for ``test_metrics.csv`` files.
Host work only: pandas and matplotlib.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from unet_bssfp_tpu_torch.eval.plots import (  # noqa: F401
    plot_nn_metrics,
    plot_rel_errors,
    plot_stacked_bar_scalars,
    plot_stacked_bar_tensors,
)


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="Build report artifacts")
    parser.add_argument("rel_errors_csv", help="relative_errors.csv path")
    parser.add_argument("--log-dirs", nargs="*", default=[])
    parser.add_argument("--out-dir", default=".")
    args = parser.parse_args(argv)

    if args.log_dirs:
        plot_nn_metrics(args.log_dirs, args.out_dir)
    plot_rel_errors(args.rel_errors_csv, args.out_dir)
    plot_stacked_bar_tensors(args.rel_errors_csv, args.out_dir)
    plot_stacked_bar_scalars(args.rel_errors_csv, args.out_dir)


if __name__ == "__main__":
    main()
