"""Model construction (counterpart of ``unet_bssfp_tpu/train/state.py``)."""

from __future__ import annotations

from typing import Optional, Union

import torch

from unet_bssfp_tpu_torch.config import MODALITIES, ModelConfig
from unet_bssfp_tpu_torch.models.generator import Generator

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
                 state_dict: Optional[dict] = None) -> Generator:
    """The generator for ``modality`` on ``device`` (default ``cuda``), with
    ``state_dict`` loaded strictly when given. The discriminator comes with
    the training slice."""
    if modality not in MODALITIES:
        raise ValueError(
            f"unknown modality {modality!r}; expected one of {MODALITIES}")
    if mcfg.compute_dtype not in _DTYPES:
        raise ValueError(f"compute_dtype {mcfg.compute_dtype!r} not in {tuple(_DTYPES)}")
    dev = resolve_device(device)
    gen = Generator(
        modality=modality,
        unet_in_channels=mcfg.unet_in_channels,
        out_channels=mcfg.out_channels,
        features=mcfg.features,
        dropout=mcfg.dropout,
        unet_negative_slope=mcfg.unet_negative_slope,
        head_negative_slope=mcfg.disc_negative_slope,
        compute_dtype=_DTYPES[mcfg.compute_dtype],
        use_fused=mcfg.use_pallas,
        packed=auto_packed(mcfg, dev),
    )
    if state_dict is not None:
        gen.load_state_dict(state_dict, strict=True)
    return gen.to(dev)
