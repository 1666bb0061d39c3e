"""Numerics debugging (counterpart of ``unet_bssfp_tpu/utils/debug.py``):
autograd's anomaly mode in place of ``jax_debug_nans``, and a finiteness
check of a function's outputs in place of ``checkify``."""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Tuple

import torch


@contextlib.contextmanager
def enable_nan_checks():
    """Inside the context a backward that produces a NaN raises, naming the
    forward op that made it (the reference's ``detect_anomaly``)."""
    with torch.autograd.set_detect_anomaly(True):
        yield


def _float_leaves(out, path="out") -> List[Tuple[str, torch.Tensor]]:
    if isinstance(out, torch.Tensor):
        return [(path, out)] if out.is_floating_point() else []
    if isinstance(out, dict):
        return [leaf for k, v in out.items() for leaf in _float_leaves(v, f"{path}[{k!r}]")]
    if isinstance(out, (list, tuple)):
        return [leaf for i, v in enumerate(out) for leaf in _float_leaves(v, f"{path}[{i}]")]
    return []


def check_finite_fn(fn: Callable) -> Callable:
    """``fn`` → ``g(*args) -> (error, out)``: ``error`` is None when every
    floating-point tensor in ``out`` is finite, else a
    ``FloatingPointError`` naming the leaves that are not (``raise`` it to
    surface the failure). One host sync per device per call."""

    def checked(*args, **kwargs) -> Tuple[Optional[FloatingPointError], object]:
        out = fn(*args, **kwargs)
        leaves = _float_leaves(out)
        if not leaves:
            return None, out
        by_device = {}
        for name, t in leaves:
            by_device.setdefault(t.device, []).append((name, torch.isfinite(t.detach()).all()))
        bad = [name for flags in by_device.values()
               for (name, _), good in zip(flags, torch.stack([f for _, f in flags]).tolist())
               if not good]
        return (FloatingPointError(f"non-finite values in {', '.join(bad)}") if bad
                else None), out

    return checked
