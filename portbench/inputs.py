"""What the benchmark makes from ``--seed``: sub-seeds, weights, training
batches, serving volumes and the order in which requests take them.

The same seed gives the same inputs. Everything is drawn on the device
with a ``torch.Generator`` of its own, in a few large calls.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Mapping, Sequence, Tuple

import torch

# Flax's lecun_normal: a normal truncated at two standard deviations,
# rescaled so that its variance is 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


def sub_seed(seed: int, *labels) -> int:
    """A 63-bit seed of its own for each ``labels`` under ``seed``."""
    text = "/".join(str(x) for x in (seed,) + labels).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def generator(device, seed: int, *labels) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *labels))


def _fan_in(name: str, shape: Sequence[int]) -> int:
    if name.endswith("upsample.weight"):  # (I, O, k, k, k): a transpose conv
        return shape[0] * math.prod(shape[2:])
    return math.prod(shape[1:])


def weights(shapes: Mapping[str, Tuple[int, ...]], seed: int, label: str, device,
            style: str, prelu_slope: float = 0.25) -> Dict[str, torch.Tensor]:
    """Float32 weights for the leaves ``shapes`` (name → shape), from one
    draw on ``device``.

    ``init``: Flax's initialisation, as training starts: conv kernels
    lecun-normal, biases and norm shifts 0, norm scales 1, running mean 0
    and variance 1, PReLU slopes ``prelu_slope``. ``random``: a model as
    served, every leaf drawn: conv kernels N(0, 1/fan_in), biases and
    shifts N(0, 0.1²), scales 1 + N(0, 0.1²), running means N(0, 0.1²),
    variances 1 + |N(0, 0.1²)|, slopes ``prelu_slope`` + N(0, 0.1²)."""
    names = list(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    g = generator(device, seed, "weights", label)
    if style not in ("init", "random"):
        raise ValueError(f"unknown weight style {style!r}")
    flat = torch.randn(sum(sizes), generator=g, device=device)
    if style == "init":
        # truncated at 2: a value outside is drawn again, four times (one in
        # 4.6 % falls outside a round), and the few left are clamped. (No
        # inverse-CDF draw: erfinv is compiled at run time on CUDA.)
        for _ in range(4):
            flat = torch.where(flat.abs() > 2.0,
                               torch.randn(flat.shape, generator=g, device=device), flat)
        flat.clamp_(-2.0, 2.0)
    out = {}
    for name, z in zip(names, torch.split(flat, sizes)):
        shape, leaf = shapes[name], name.rsplit(".", 1)[-1]
        z = z.view(shape)
        if len(shape) == 5:
            std = _fan_in(name, shape) ** -0.5
            out[name] = z * (std / _TRUNC_STD if style == "init" else std)
        elif style == "init":
            fill = {"weight": 1.0, "running_var": 1.0, "prelu_slope": prelu_slope}.get(leaf, 0.0)
            out[name] = torch.full(shape, fill, device=device)
        elif leaf == "running_var":
            out[name] = 1.0 + 0.1 * z.abs()
        elif leaf == "weight":
            out[name] = 1.0 + 0.1 * z
        elif leaf == "prelu_slope":
            out[name] = prelu_slope + 0.1 * z
        else:
            out[name] = 0.1 * z
    return out


def _rows(g: torch.Generator, n: int, shape: Sequence[int], log_scale: float, device):
    """``n`` rows of standard normal noise, each scaled by its own
    ``exp(U(-log_scale, log_scale))``."""
    z = torch.randn((n,) + tuple(shape), generator=g, device=device)
    s = torch.exp((torch.rand(n, generator=g, device=device) * 2.0 - 1.0) * log_scale)
    return z.mul_(s.view((n,) + (1,) * len(shape)))


def patch_batches(traffic: Mapping, seed: int, in_ch: int, out_ch: int, device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``traffic['pool_batches']`` batches of ``batch`` × ``patch``³ input
    and target patches (NDHWC, float32), every row different and scaled on
    its own: ``(pool, batch, p, p, p, C)``."""
    n, b, p = traffic["pool_batches"], traffic["batch"], traffic["patch"]
    g = generator(device, seed, "batches")
    x = _rows(g, n * b, (p, p, p, in_ch), traffic["row_log_scale"], device)
    y = _rows(g, n * b, (p, p, p, out_ch), traffic["row_log_scale"], device)
    return x.view(n, b, p, p, p, in_ch), y.view(n, b, p, p, p, out_ch)


def volumes(traffic: Mapping, seed: int, in_ch: int, device) -> torch.Tensor:
    """``traffic['pool_volumes']`` float32 volumes ``(V, D, H, W, C)``."""
    g = generator(device, seed, "volumes")
    return _rows(g, traffic["pool_volumes"], tuple(traffic["volume"]) + (in_ch,),
                 traffic["row_log_scale"], device)


def volume_order(traffic: Mapping, seed: int) -> List[int]:
    """The pool in a seeded order: request ``i`` takes its entries ``i·k``
    to ``i·k + k - 1`` (``k`` = ``volumes_per_request``), cycling."""
    return torch.randperm(traffic["pool_volumes"], generator=torch.Generator().manual_seed(
        sub_seed(seed, "order"))).tolist()


def checked_requests(traffic: Mapping, seed: int) -> List[int]:
    """The requests whose answers the run compares: ``check_requests`` of
    the first ``check_from`` ones, drawn from the seed."""
    perm = torch.randperm(traffic["check_from"], generator=torch.Generator().manual_seed(
        sub_seed(seed, "check")))
    return sorted(perm[:traffic["check_requests"]].tolist())
