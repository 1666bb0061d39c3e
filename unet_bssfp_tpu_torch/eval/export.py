"""A trained generator frozen into one serving artifact (counterpart of
``unet_bssfp_tpu/eval/export.py``).

``export_generator`` traces the eval-mode generator at a fixed input shape
with ``torch.export``; the weights ride in the program, so a consumer needs
no model code, checkpoint or config. As the JAX package builds its artifact
with ``packed=False`` (no Pallas call in the StableHLO), the port builds it
with ``packed=False`` and ``use_pallas=False``: the program holds only ATen
ops (cuDNN convolutions on the card) and no ctypes launch of a hand-written
kernel.

Artifact layout (one file; the port's own, it does not read JAX's ``.ubx``):
    8-byte magic ``UBSSFPT1`` | u32 little-endian header length | JSON header
    (shape/dtype/modality/device/provenance) | ``torch.export.save`` bytes.

A program is traced on one device type and asserts it in its graph: an
artifact exported on the CPU does not run on the card after ``.to("cuda")``
and the reverse, so :func:`load_exported` refuses an artifact whose device
type is not the one asked for (export on the device that serves).
"""

from __future__ import annotations

import dataclasses
import io
import json
import struct
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from unet_bssfp_tpu_torch.config import ModelConfig
from unet_bssfp_tpu_torch.train.state import _DTYPES, build_models, resolve_device

MAGIC = b"UBSSFPT1"
#: The JAX package's artifact magic (``unet_bssfp_tpu/eval/export.py``).
JAX_MAGIC = b"UBSSFPX1"
FORMAT = "unet_bssfp_tpu_torch.export"


class _Serve(nn.Module):
    """The eval-mode generator forward with its output in f32
    (``train/steps.py::make_predict_fn`` semantics)."""

    def __init__(self, gen: nn.Module):
        super().__init__()
        self.gen = gen

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.gen(x).float()


def export_generator(modality: str, mcfg: ModelConfig, state_dict, input_shape: Sequence[int],
                     *, in_dtype: str = "float32",
                     device: Union[str, torch.device, None] = None,
                     extra_meta: Optional[dict] = None
                     ) -> Tuple[torch.export.ExportedProgram, dict]:
    """Freeze the eval-mode generator with ``state_dict`` (its parameters and
    BatchNorm buffers) at ``input_shape`` = (B, D, H, W, C) on ``device``
    (default ``cuda``). Returns the ``torch.export.ExportedProgram`` and the
    metadata header."""
    if in_dtype not in _DTYPES:
        raise ValueError(f"in_dtype {in_dtype!r} not in {tuple(_DTYPES)}")
    dev = resolve_device(device)
    # the plain layers only: the program holds no hand-written kernel
    mcfg = dataclasses.replace(mcfg, packed=False, use_pallas=False, remat=False)
    gen, _ = build_models(modality, mcfg, dev, state_dict=state_dict)
    gen.eval().requires_grad_(False)
    example = torch.zeros(tuple(input_shape), dtype=_DTYPES[in_dtype], device=dev)
    with torch.no_grad():
        program = torch.export.export(_Serve(gen), (example,))
    # not saved with the program: the traced zeros (151 MB at the whole
    # volume) would outweigh its 91 MB of weights
    program.example_inputs = None
    meta = {
        "format": FORMAT,
        "version": 1,
        "modality": modality,
        "input_shape": [int(s) for s in input_shape],
        "in_dtype": in_dtype,
        "out_channels": int(mcfg.out_channels),
        "compute_dtype": str(mcfg.compute_dtype),
        "device": dev.type,
        "torch_version": torch.__version__,
    }
    if extra_meta:
        meta.update(extra_meta)
    return program, meta


def save_exported(program: torch.export.ExportedProgram, meta: dict, path: str) -> None:
    header = json.dumps(meta).encode("utf-8")
    payload = io.BytesIO()
    torch.export.save(program, payload)
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(header)))
        f.write(header)
        f.write(payload.getbuffer())


def read_exported(path: str) -> Tuple[dict, bytes]:
    """``(meta, payload)`` of an artifact; anything else raises
    ``ValueError``: a JAX artifact by name, another magic, a truncated
    header."""
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic == JAX_MAGIC:
            raise ValueError(
                f"{path}: a JAX artifact (unet_bssfp_tpu.export, magic {JAX_MAGIC!r}): its "
                "StableHLO payload does not load into PyTorch; export the checkpoint with "
                "python -m unet_bssfp_tpu_torch.export")
        if magic != MAGIC:
            raise ValueError(f"{path}: not a unet_bssfp_tpu_torch export (magic {magic!r})")
        raw_len = f.read(4)
        if len(raw_len) != 4:
            raise ValueError(f"{path}: truncated export (missing header length)")
        (hlen,) = struct.unpack("<I", raw_len)
        raw_header = f.read(hlen)
        if len(raw_header) != hlen:
            raise ValueError(
                f"{path}: truncated export (header {len(raw_header)}/{hlen} bytes)")
        return json.loads(raw_header.decode("utf-8")), f.read()


def load_exported(path: str, device: Union[str, torch.device, None] = None
                  ) -> Tuple[Callable[[torch.Tensor], torch.Tensor], dict]:
    """Load an artifact for ``device`` (default ``cuda``) → ``(call, meta)``.

    ``call`` takes one tensor of the exported shape and dtype on that device
    and returns the f32 prediction, without gradients; it needs none of this
    package's model code. An artifact exported on another device type is
    refused."""
    meta, payload = read_exported(path)
    dev = resolve_device(device)
    if meta["device"] != dev.type:
        raise ValueError(
            f"{path}: exported on {meta['device']}, asked to serve on {dev.type}: a program "
            f"traced on one device type asserts it in its graph; re-export on the serving "
            f"device (python -m unet_bssfp_tpu_torch.export --device {dev.type})")
    module = torch.export.load(io.BytesIO(payload)).module()

    def call(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return module(x)

    return call, meta
