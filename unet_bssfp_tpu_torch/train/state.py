"""Model construction and the GAN train state (counterpart of
``unet_bssfp_tpu/train/state.py``)."""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Tuple, Union

import torch

from unet_bssfp_tpu_torch import weights
from unet_bssfp_tpu_torch.config import MODALITIES, ModelConfig, TrainConfig
from unet_bssfp_tpu_torch.models.discriminator import Discriminator
from unet_bssfp_tpu_torch.models.generator import Generator
from unet_bssfp_tpu_torch.models.layers import bind_dropout_generator
from unet_bssfp_tpu_torch.parallel.mesh import Mesh, as_device, replicate

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """``cuda`` unless the caller asks for another device; asking for CUDA
    where there is none raises (no silent fallback to the CPU)."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was asked for but torch.cuda.is_available() "
                           "is False; pass device='cpu' to run on the CPU")
    return dev


def auto_packed(mcfg: ModelConfig, device: Union[str, torch.device, None],
                mesh: Optional[Mesh] = None) -> bool:
    """An explicit ``mcfg.packed`` wins; otherwise packed iff the device the
    model will run on is CUDA: ``device``, or with a mesh every device of
    the mesh (the packed kernels run on every shard: split over ``data``,
    and over ``space`` with a d-halo exchange; a shape an axis does not
    divide falls back per conv, ``conv3x3_packed_auto``)."""
    if mcfg.packed is not None:
        return mcfg.packed
    devices = mesh.distinct if mesh is not None else (torch.device(device),)
    return all(d.type == "cuda" for d in devices)


def build_models(modality: str, mcfg: ModelConfig,
                 device: Union[str, torch.device, None] = None,
                 state_dict: Optional[dict] = None,
                 mesh: Optional[Mesh] = None
                 ) -> Tuple[Generator, Discriminator]:
    """``(gen, disc)`` for ``modality`` on ``device`` (default ``cuda``),
    with the generator's ``state_dict`` loaded strictly when given. With a
    ``mesh`` the models live on its first device and the generator gets one
    replica on every other distinct device of the mesh (not one per
    position), made after the weights are loaded, so all share them bit
    for bit. ``use_pallas`` on a mesh of more than one position raises: the
    fused norm kernel takes one whole volume and has no sharded route."""
    if modality not in MODALITIES:
        raise ValueError(
            f"unknown modality {modality!r}; expected one of {MODALITIES}")
    if mcfg.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype {mcfg.compute_dtype!r} not in {tuple(_DTYPES)}")
    if mesh is not None:
        if device is not None and as_device(device) != mesh.devices[0][0]:
            raise ValueError(f"device {device} is not the first device of {mesh}")
        if mcfg.use_pallas and mesh.positions > 1:
            raise ValueError(
                f"use_pallas on {mesh}: the fused InstanceNorm+LeakyReLU kernel "
                f"has no sharded route")
        device = mesh.devices[0][0]
    dev = resolve_device(device)
    dtype = _DTYPES[mcfg.compute_dtype]
    gen = Generator(
        modality=modality,
        unet_in_channels=mcfg.unet_in_channels,
        out_channels=mcfg.out_channels,
        features=mcfg.features,
        dropout=mcfg.dropout,
        unet_negative_slope=mcfg.unet_negative_slope,
        head_negative_slope=mcfg.disc_negative_slope,
        compute_dtype=dtype,
        use_fused=mcfg.use_pallas,
        packed=auto_packed(mcfg, dev, mesh),
        remat=mcfg.remat,
    )
    if state_dict is not None:
        gen.load_state_dict(state_dict, strict=True)
    disc = Discriminator(
        modality=modality,
        out_channels=mcfg.out_channels,
        features=mcfg.disc_features,
        negative_slope=mcfg.disc_negative_slope,
        compute_dtype=dtype,
    )
    if mesh is not None:
        replicate(gen, mesh)
    return gen.to(dev), disc.to(dev)


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   cfg: TrainConfig) -> torch.optim.AdamW:
    """AdamW with the reference's hyperparameters (``TrainConfig``'s lr,
    betas and weight decay, eps 1e-8). optax's ``adamw`` and torch's
    decoupled decay are the same update."""
    return torch.optim.AdamW(params, lr=cfg.lr,
                             betas=(cfg.b1, cfg.b2), eps=1e-8,
                             weight_decay=cfg.weight_decay)


@dataclasses.dataclass
class GANTrainState:
    """The GAN's mutable training state: the modules hold the parameters and
    BatchNorm statistics; ``rng`` draws every dropout mask."""

    step: int
    rng: torch.Generator
    gen: Generator
    disc: Discriminator
    gen_opt: torch.optim.AdamW
    disc_opt: torch.optim.AdamW


def create_gan_state(seed: int, modality: str, mcfg: ModelConfig,
                     tcfg: TrainConfig,
                     device: Union[str, torch.device, None] = None
                     ) -> GANTrainState:
    """Both models with Flax's initialisation drawn from ``seed``, their
    AdamW optimizers, and a dropout generator on ``device`` seeded from
    ``seed``; everything repeats for a repeated seed."""
    gen, disc = build_models(modality, mcfg, device)
    dev = next(gen.parameters()).device
    gen.load_state_dict(weights.init_state_dict(gen, seed))
    disc.load_state_dict(weights.init_state_dict(disc, seed + 1))
    rng = torch.Generator(device=dev).manual_seed(seed + 2)
    bind_dropout_generator(gen, rng)
    return GANTrainState(step=0, rng=rng, gen=gen, disc=disc,
                         gen_opt=make_optimizer(gen.parameters(), tcfg),
                         disc_opt=make_optimizer(disc.parameters(), tcfg))
