"""The public data surface (counterpart of ``src/data_module.py``).

``DoveDataModule`` keeps the reference's constructor
(``src/data_module.py:10-19``) and its ``prepare_data/setup/print_info``
life-cycle; batches come from ``train_batches/val_batches/test_volumes``
(tensors on ``cuda`` unless the caller passes another device) instead of
torch DataLoaders.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from unet_bssfp_tpu_torch.data.datamodule import DoveDataModule, SampleSpec  # noqa: F401
from unet_bssfp_tpu_torch.data.synthetic import make_synthetic_bids  # noqa: F401


def print_data_samples(data_dir: str, out_png: str = "augmentation.png",
                       device: Union[str, torch.device, None] = None) -> str:
    """Visual smoke-check (reference ``print_data_samples``,
    ``src/data_module.py:205-231``): one augmented training batch of
    ``data_dir`` (the default ``DataConfig``) on ``device`` (default
    ``cuda``), its keys and shapes printed and a 2×2 montage of its middle
    slices saved to ``out_png``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    data = DoveDataModule(data_dir)
    data.prepare_data()
    data.print_info()
    data.setup()
    # one batch: no prefetch thread left running behind it
    batch = next(iter(data.train_batches(0, device=device, prefetch=False)))
    print(list(batch.keys()))
    print(tuple(batch["pc-bssfp"].shape), tuple(batch["dwi-tensor_orig"].shape))
    k = batch["pc-bssfp"].shape[1] // 2
    x = batch["pc-bssfp"][0, k].float().cpu().numpy()
    y = batch["dwi-tensor_orig"][0, k].float().cpu().numpy()
    fig, axes = plt.subplots(2, 2, figsize=(10, 10))
    panels = [("pc-bssfp mag", x[:, :, 0]), ("pc-bssfp phase", x[:, :, 1]),
              ("dwi dxx", y[:, :, 0]), ("dwi dxy", y[:, :, 1])]
    for ax, (title, img) in zip(axes.ravel(), panels):
        ax.imshow(np.asarray(img), cmap="gray")
        ax.set_title(title)
        ax.axis("off")
    fig.savefig(out_png)
    plt.close(fig)
    return out_png


if __name__ == "__main__":
    import sys

    print_data_samples(sys.argv[1] if len(sys.argv) > 1 else ".")
