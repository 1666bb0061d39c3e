"""The serving step (counterpart of ``unet_bssfp_tpu/train/steps.py::
make_predict_fn``); the training steps come with the training slice."""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn


def make_predict_fn(gen: nn.Module) -> Callable[[torch.Tensor], torch.Tensor]:
    """Eval-mode generator forward ``x -> y_hat`` under
    ``torch.inference_mode()``. The weights live in ``gen``, so the JAX
    signature's ``state`` argument has no counterpart."""
    gen.eval()

    def predict(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return gen(x)

    return predict
