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

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """``cuda`` unless the caller asks for another device; asking for CUDA
    where there is none raises (no silent fallback to the CPU)."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was asked for but torch.cuda.is_available() "
                           "is False; pass device='cpu' to run on the CPU")
    return dev


def auto_packed(mcfg: ModelConfig, device: torch.device) -> bool:
    """An explicit ``mcfg.packed`` wins; otherwise packed iff CUDA."""
    if mcfg.packed is not None:
        return mcfg.packed
    return torch.device(device).type == "cuda"


def build_models(modality: str, mcfg: ModelConfig,
                 device: Union[str, torch.device, None] = None,
                 state_dict: Optional[dict] = None
                 ) -> Tuple[Generator, Discriminator]:
    """``(gen, disc)`` for ``modality`` on ``device`` (default ``cuda``),
    with the generator's ``state_dict`` loaded strictly when given."""
    if modality not in MODALITIES:
        raise ValueError(
            f"unknown modality {modality!r}; expected one of {MODALITIES}")
    if mcfg.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype {mcfg.compute_dtype!r} not in {tuple(_DTYPES)}")
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
        packed=auto_packed(mcfg, dev),
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
