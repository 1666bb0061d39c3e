"""Weights: Flax variables → the port's ``state_dict`` (generator and
discriminator alike: the module paths are the same in both packages), a JAX
``GANTrainState`` → both modules, the MedicalNet feature extractor's
variables → its ``state_dict``, the port's own ``.pt`` files, Flax's
initialisation, and seeded random weights.

Flax trees are nested dicts of numpy arrays, as
``jax.tree.map(np.asarray, variables)`` gives them, or an ``.npz`` whose keys
are the ``/``-joined Flax paths (``params/unet/conv_0/conv_0/conv/kernel``,
``batch_stats/head24/bn/mean``). Module paths are the same in both packages;
leaf names map as:

  kernel (D, H, W, I, O)  → weight (O, I, D, H, W)
  kernel of ``upsample``  → weight (I, O, D, H, W), spatially flipped
                            (lax.conv_transpose does not flip, torch does)
  scale                   → weight
  bias                    → bias
  mean / var (batch_stats)→ running_mean / running_var
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _convert(path: Tuple[str, ...], leaf: np.ndarray) -> np.ndarray:
    a = np.array(leaf, dtype=np.float32, copy=True)  # never alias a JAX buffer
    if path[-1] != "kernel":
        return a
    if a.ndim != 5:
        raise ValueError(f"{'/'.join(path)}: expected a 5-D conv kernel, got {a.shape}")
    if len(path) > 1 and path[-2] == "upsample":
        return np.ascontiguousarray(np.transpose(a[::-1, ::-1, ::-1], (3, 4, 0, 1, 2)))
    return np.ascontiguousarray(np.transpose(a, (4, 3, 0, 1, 2)))


def from_flax(params: Mapping, batch_stats: Optional[Mapping] = None
              ) -> Dict[str, torch.Tensor]:
    """Flax ``params`` (+ ``batch_stats``) → ``state_dict``. Every Flax leaf
    is consumed exactly once; an unknown leaf name raises."""
    out: Dict[str, torch.Tensor] = {}
    for tree, names in ((params, _PARAM_LEAVES), (batch_stats or {}, _STAT_LEAVES)):
        for path, leaf in _flatten(tree):
            if path[-1] not in names:
                raise KeyError(f"unknown Flax leaf {'/'.join(path)}")
            key = ".".join(path[:-1] + (names[path[-1]],))
            if key in out:
                raise KeyError(f"two Flax leaves map to {key}")
            out[key] = torch.from_numpy(_convert(path, leaf))
    return out


def load_flax_npz(path: str) -> Dict[str, torch.Tensor]:
    """``.npz`` of ``/``-joined Flax paths → ``state_dict``."""
    params: dict = {}
    stats: dict = {}
    with np.load(path) as z:
        for key in z.files:
            parts = key.split("/")
            if parts[0] not in ("params", "batch_stats"):
                raise KeyError(f"{path}: key {key} is neither params/ nor batch_stats/")
            node = params if parts[0] == "params" else stats
            for p in parts[1:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return from_flax(params, stats)


def save(state_dict: Mapping[str, torch.Tensor], path: str) -> None:
    """Write the port's ``.pt`` weight file (a plain tensor dict)."""
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, path)


def load(path: str) -> Dict[str, torch.Tensor]:
    """A port ``.pt`` file, or a Flax ``.npz`` converted on the fly."""
    if path.endswith(".npz"):
        return load_flax_npz(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def state_from_flax(gen: nn.Module, disc: nn.Module, state: Mapping) -> None:
    """Load a JAX ``GANTrainState``'s ``gen_params``/``gen_batch_stats`` and
    ``disc_params``/``disc_batch_stats`` (numpy trees, as
    ``jax.tree.map(np.asarray, ...)`` gives them; a mapping of those four
    names) into ``gen`` and ``disc``, strictly."""
    for module, prefix in ((gen, "gen"), (disc, "disc")):
        sd = from_flax(state[f"{prefix}_params"], state[f"{prefix}_batch_stats"])
        module.load_state_dict(sd, strict=True)


def medicalnet_from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's MedicalNet variables (``{"params", "batch_stats"}``,
    numpy trees) → the port's ``MedicalNetResNet10`` ``state_dict``: the
    inverse of ``unet_bssfp_tpu/models/medicalnet.py:load_torch_state_dict``.
    Leaves map as :func:`from_flax` maps them; the module paths
    ``layer{i}_0`` → ``layer{i}.0`` and ``downsample_conv`` /
    ``downsample_bn`` → ``downsample.0`` / ``downsample.1`` (Med3D's keys)."""
    out = {}
    for key, v in from_flax(variables["params"], variables.get("batch_stats")).items():
        key = re.sub(r"^(layer\d)_0\.", r"\1.0.", key)
        key = key.replace("downsample_conv.", "downsample.0.").replace("downsample_bn.",
                                                                      "downsample.1.")
        out[key] = v
    return out


def _fan_in(key: str, t: torch.Tensor) -> int:
    """A conv kernel's fan-in: torch's (O, I, k, k, k), or (I, O, k, k, k)
    for a transposed conv (``upsample``)."""
    if key.endswith("upsample.weight"):
        return t.shape[0] * t[0, 0].numel()
    return t[0].numel()


def init_state_dict(model: nn.Module, seed: int) -> Dict[str, torch.Tensor]:
    """Flax's initialisation of ``model``: conv kernels ``lecun_normal``
    (normal of variance 1/fan_in, truncated at two standard deviations),
    biases and norm shifts 0, norm scales 1, BatchNorm running mean 0 and
    variance 1; from a CPU ``torch.Generator`` seeded with ``seed``."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for key, t in model.state_dict().items():
        leaf = key.rsplit(".", 1)[-1]
        if t.ndim == 5:
            std = (1.0 / _fan_in(key, t)) ** 0.5 / .87962566103423978
            w = torch.empty(t.shape, dtype=torch.float32)
            out[key] = nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=g)
        elif leaf in ("weight", "running_var"):
            out[key] = torch.ones(t.shape)
        else:
            out[key] = torch.zeros(t.shape)
    return out


def random_state_dict(model: nn.Module, seed: int) -> Dict[str, torch.Tensor]:
    """Seeded random weights for ``model``: conv kernels N(0, 1/fan_in),
    biases and norm shifts N(0, 0.1²), norm scales 1 + N(0, 0.1²), BatchNorm
    running means N(0, 0.1²) and variances 1 + |N(0, 0.1²)|."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for key, t in model.state_dict().items():
        z = torch.randn(t.shape, generator=g, dtype=torch.float32)
        leaf = key.rsplit(".", 1)[-1]
        if t.ndim == 5:
            out[key] = z / _fan_in(key, t) ** 0.5
        elif leaf == "running_var":
            out[key] = 1.0 + 0.1 * z.abs()
        elif leaf == "weight":
            out[key] = 1.0 + 0.1 * z
        else:
            out[key] = 0.1 * z
    return out
