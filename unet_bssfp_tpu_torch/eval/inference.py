"""Whole-volume and grid-stitched inference, and the test loop (counterpart
of ``unet_bssfp_tpu/eval/inference.py``).

The test loop replaces the reference's ``test_step``/``predict_step``
(``src/model.py:291-333``): each held-out volume is predicted, its metrics
are taken on the stitched volume (pred against target: the JAX package's
fixed readout of the reference's swapped aggregators, SURVEY.md §7 #3) and
its input, prediction and target are written as NIfTI files.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from unet_bssfp_tpu_torch.data.bids import parse_entities
from unet_bssfp_tpu_torch.data.datamodule import DoveDataModule, SampleSpec
from unet_bssfp_tpu_torch.data.nifti import load_affine, save_volume
from unet_bssfp_tpu_torch.data.sampler import GridAggregator, extract_patches
from unet_bssfp_tpu_torch.ops.metrics import mae, psnr, ssim3d
from unet_bssfp_tpu_torch.parallel.mesh import Mesh


def predict_volume(predict_fn: Callable[[torch.Tensor], torch.Tensor],
                   volume: torch.Tensor, patch_size: int = 64,
                   out_channels: int = 6, batch_size: int = 8,
                   mode: str = "average",
                   whole_volume: bool = False,
                   mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Run the generator over one ``(D, H, W, C)`` volume: once on the whole
    volume, or over the grid of patches in batches of ``batch_size`` (the
    last batch zero-padded to full size) and stitched.

    ``mesh``: the mesh ``predict_fn`` was made for
    (``make_predict_fn(gen, mesh)``), which does the splitting: the whole
    volume's d over ``space`` (one volume has no batch to split, so ``data``
    must be 1); each patch batch over ``data`` and each patch's d over
    ``space``. What the mesh cannot split is refused here, before any
    work."""
    if mesh is not None:
        nd, ns = mesh.size("data"), mesh.size("space")
        d = volume.shape[0] if whole_volume else patch_size
        if whole_volume and nd != 1:
            raise ValueError(f"whole-volume inference on {mesh}: one volume has "
                             f"no batch to split over data={nd}")
        if not whole_volume and batch_size % nd:
            raise ValueError(f"batch_size {batch_size} does not split over "
                             f"data={nd} of {mesh}")
        if ns > 1 and d % (16 * ns):
            raise ValueError(
                f"{'volume' if whole_volume else 'patch'} of D={d} "
                f"(shape {tuple(volume.shape)}) on {mesh}: D must be a multiple "
                f"of 16·n_space={16 * ns}")
    if whole_volume:
        return predict_fn(volume[None])[0]
    agg = GridAggregator(volume.shape[:3], out_channels, patch_size, mode=mode)
    patches = extract_patches(volume, agg.starts, patch_size)
    preds = []
    for i in range(0, patches.shape[0], batch_size):
        chunk = patches[i:i + batch_size]
        n = chunk.shape[0]
        if n < batch_size:
            chunk = torch.cat([chunk, chunk.new_zeros((batch_size - n,) + chunk.shape[1:])])
        preds.append(predict_fn(chunk)[:n])
    return agg.stitch(torch.cat(preds))


def _stitched_metrics(pred: torch.Tensor, target: torch.Tensor,
                      fid_fn=None) -> Dict[str, float]:
    """PSNR, SSIM and L1 of one stitched ``(D, H, W, C)`` volume against its
    target (a batch of one, f32), and ``test_metric_{fid_fn.label}``."""
    p, t = pred[None].float(), target[None].float()
    out = {
        "test_metric_PSNR": float(torch.mean(psnr(p, t))),
        "test_metric_SSIM": float(torch.mean(ssim3d(p, t))),
        "test_metric_L1": float(torch.mean(mae(p, t))),
    }
    if fid_fn is not None:
        out[f"test_metric_{getattr(fid_fn, 'label', 'FID')}"] = float(fid_fn(p, t))
    return out


def save_predictions(out_dir: str, batch_idx: int, modality: str, spec: SampleSpec,
                     x: np.ndarray, y: np.ndarray, y_hat: np.ndarray,
                     affine: Optional[np.ndarray] = None,
                     timestamp: Optional[str] = None) -> Dict[str, str]:
    """Write the input, prediction and target as f32 NIfTI files named as
    the reference names them (``save_predicitions``, ``src/model.py:335-357``):
    ``{kind}-{idx}_mod-{modality}[_{time}]_sub-{sub}_ses-{ses}.nii.gz``, the
    input's subject and session from the modality's source path, the
    prediction's and target's from ``dwi-tensor``'s; ``affine`` on all three.
    Returns ``{kind: path}``."""
    os.makedirs(out_dir, exist_ok=True)
    in_ents = parse_entities(spec.path(modality))
    tgt_ents = parse_entities(spec.path("dwi-tensor"))
    time = f"_{timestamp}" if timestamp else ""
    paths = {}
    for kind, ents, data in (("input", in_ents, x), ("pred", tgt_ents, y_hat),
                             ("target", tgt_ents, y)):
        name = (f"{kind}-{batch_idx}_mod-{modality}{time}"
                f"_sub-{ents.get('subject', 'NA')}_ses-{ents.get('session', 'NA')}.nii.gz")
        paths[kind] = os.path.join(out_dir, name)
        save_volume(paths[kind], np.asarray(data, np.float32), affine)
    return paths


def run_test(predict_fn: Callable[[torch.Tensor], torch.Tensor], data: DoveDataModule,
             modality: str, out_dir: str, patch_size: Optional[int] = None,
             whole_volume: bool = False, save: bool = True, fid_fn=None,
             device=None) -> Dict[str, float]:
    """The test loop (``trainer.test``, reference ``src/model.py:291-313``)
    over ``data``'s held-out volumes on ``device`` (default ``cuda``; the
    target is the un-augmented ``dwi-tensor``): each predicted with
    :func:`predict_volume`, its metrics taken on the stitched volume, and
    with ``save`` its input, prediction and target written to ``out_dir``
    with the target's affine (None where the target's header does not
    read). Returns the mean of each metric over the volumes ({} for none).
    The weights live in ``predict_fn``'s module, so the JAX signature's
    ``state`` argument has no counterpart."""
    patch_size = patch_size or data.config.patch_size
    rows = []
    for idx, (spec, vols) in enumerate(data.test_volumes(keys=(modality, "dwi-tensor"),
                                                         device=device)):
        x, y = vols[modality], vols["dwi-tensor"]
        y_hat = predict_volume(predict_fn, x, patch_size=patch_size, out_channels=y.shape[-1],
                               whole_volume=whole_volume)
        rows.append(_stitched_metrics(y_hat, y, fid_fn))
        if save:
            try:
                affine = load_affine(spec.path("dwi-tensor"))
            except (OSError, ValueError):
                affine = None
            x_np, y_np, y_hat_np = (v.float().cpu().numpy() for v in (x, y, y_hat))
            save_predictions(out_dir, idx, modality, spec, x_np, y_np, y_hat_np, affine=affine)
    if not rows:
        return {}
    return {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
