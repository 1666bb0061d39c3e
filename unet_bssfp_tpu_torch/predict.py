"""Single-volume prediction CLI: one NIfTI in → DT prediction (+ optional
scalar maps) out (the counterpart of ``src/predict.py``).

Usage:
  python -m unet_bssfp_tpu_torch.predict INPUT.nii.gz (--weights W.pt | --checkpoint CKPT) \
      [--modality pc-bssfp] [--out-dir preds] [--config cfg.json] \
      [--patch | --whole-volume] [--device cuda] [--mesh DATA,SPACE] \
      [--scalar-maps [--rescale-args rescale_args_dwi.txt]]

``--weights`` takes the port's ``.pt`` or an ``.npz`` of ``/``-joined Flax
paths (``weights.py``); ``--checkpoint`` a training step (its directory or
its ``state.pt``), whose generator alone is loaded, and whose run's
``config.json`` is the config where ``--config`` is absent. Runs on CUDA
unless ``--device cpu``.

``--mesh 1,2`` splits the work over a (data, space) mesh: the whole volume's
d over ``space``, or each patch batch over ``data`` and each patch's d over
``space``. The positions go to the visible CUDA devices in turn (all to the
CPU with ``--device cpu``); one device may hold several positions, so
``--mesh 1,2`` runs on one card too.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from unet_bssfp_tpu_torch import weights
from unet_bssfp_tpu_torch.config import Config
from unet_bssfp_tpu_torch.data.nifti import load_volume, save_volume
from unet_bssfp_tpu_torch.data.transforms import crop_or_pad
from unet_bssfp_tpu_torch.eval.inference import predict_volume
from unet_bssfp_tpu_torch.ops.scalar_maps import (
    compute_scalar_maps,
    invert_dwi_tensor_norm,
    load_rescale_args,
)
from unet_bssfp_tpu_torch.parallel.mesh import Mesh, make_mesh
from unet_bssfp_tpu_torch.train.checkpoint import generator_state_dict, load_config_for_checkpoint
from unet_bssfp_tpu_torch.train.state import build_models, resolve_device
from unet_bssfp_tpu_torch.train.steps import make_predict_fn


def _crop_offset(cur: int, tgt: int) -> int:
    """Voxel shift of :func:`crop_or_pad` along one axis (crop start
    (cur-tgt)//2; pad -((tgt-cur)//2): the floors differ for odd sizes)."""
    return (cur - tgt) // 2 if cur >= tgt else -((tgt - cur) // 2)


def parse_mesh(text: Optional[str], device: torch.device) -> Optional[Mesh]:
    """``--mesh DATA,SPACE`` → a ('data', 'space') mesh whose positions go to
    ``device`` if it is the CPU or names one card (``cuda:1``), else to the
    visible cards in turn; ``None`` for no ``--mesh``."""
    if text is None:
        return None
    try:
        shape = tuple(int(p) for p in text.split(","))
    except ValueError:
        shape = ()
    if len(shape) != 2 or min(shape) < 1:
        raise ValueError(f"--mesh takes DATA,SPACE (two positive integers), got {text!r}")
    spread = device.type == "cuda" and device.index is None
    return make_mesh(None if spread else [device], ("data", "space"), shape)


def main(argv: Optional[Sequence[str]] = None) -> str:
    parser = argparse.ArgumentParser(description="bSSFP/T1w → DT inference")
    parser.add_argument("input", help="preprocessed input NIfTI")
    source = parser.add_mutually_exclusive_group(required=True)
    source.add_argument("--weights", help="port .pt weights or a Flax-path .npz")
    source.add_argument("--checkpoint",
                        help="a training step (directory or state.pt); its run's config.json "
                             "is the config unless --config is given")
    parser.add_argument("--modality", default="pc-bssfp")
    parser.add_argument("--out-dir", default=".")
    parser.add_argument("--config", default=None, help="JSON config path")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--mesh", default=None, metavar="DATA,SPACE",
                        help="split over a (data, space) mesh, e.g. 1,2 "
                             "(default: no mesh)")
    parser.add_argument("--scalar-maps", action="store_true",
                        help="also write FA/MD/AD/RD/azimuth/inclination/RGB maps")
    parser.add_argument("--rescale-args", default=None,
                        help="rescale_args_dwi.txt to de-normalise before scalar maps")
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--patch", action="store_true",
                      help="force grid-stitched patch inference")
    mode.add_argument("--whole-volume", action="store_true",
                      help="force whole-volume inference")
    args = parser.parse_args(argv)

    saved = None
    if args.config:
        with open(args.config) as f:
            saved = f.read()
    elif args.checkpoint:
        saved = load_config_for_checkpoint(args.checkpoint)
    config = Config.from_json(saved) if saved else Config()
    device = resolve_device(args.device)
    mesh = parse_mesh(args.mesh, device)
    if mesh is not None:
        device = mesh.devices[0][0]
    target_shape = tuple(config.data.volume_shape)

    data, affine = load_volume(args.input)
    vol = crop_or_pad(torch.from_numpy(data), target_shape).to(device)
    # crop_or_pad shifts the voxel grid: carry the shift into the affine so
    # the prediction stays registered to the source.
    offset = [_crop_offset(data.shape[i], target_shape[i]) for i in range(3)]
    affine = np.asarray(affine, np.float64).copy()
    affine[:3, 3] += affine[:3, :3] @ np.asarray(offset, np.float64)

    # Default to the mode the model was trained with, so InstanceNorm
    # moments match training.
    if args.patch:
        whole_volume = False
    elif args.whole_volume:
        whole_volume = True
    else:
        whole_volume = config.data.whole_volume

    state_dict = (weights.load(args.weights) if args.weights
                  else generator_state_dict(args.checkpoint))
    gen, _ = build_models(args.modality, config.model, device, state_dict=state_dict, mesh=mesh)
    predict_fn = make_predict_fn(gen, mesh)
    t0 = time.perf_counter()
    pred = predict_volume(predict_fn, vol, patch_size=config.data.patch_size,
                          out_channels=config.model.out_channels,
                          whole_volume=whole_volume, mesh=mesh)
    pred_np = pred.float().cpu().numpy()
    print(f"inference: {time.perf_counter() - t0:.3f}s "
          f"({'whole-volume' if whole_volume else 'patch-stitched'}, "
          f"{mesh if mesh is not None else device})")

    os.makedirs(args.out_dir, exist_ok=True)
    base = os.path.basename(args.input).split(".nii")[0]
    pred_path = os.path.join(args.out_dir, f"{base}_pred-dt.nii.gz")
    save_volume(pred_path, pred_np, affine)
    print(f"wrote {pred_path}")

    if args.scalar_maps:
        d6 = pred.float()
        if args.rescale_args:
            d6 = invert_dwi_tensor_norm(d6, load_rescale_args(args.rescale_args))
        maps = compute_scalar_maps(d6)  # K8 on the card
        for name, arr in zip(maps._fields, maps):
            save_volume(os.path.join(args.out_dir, f"{base}_{name}.nii.gz"),
                        arr.cpu().numpy(), affine)
        print(f"wrote 7 scalar maps to {args.out_dir}")
    return pred_path


if __name__ == "__main__":
    main()
