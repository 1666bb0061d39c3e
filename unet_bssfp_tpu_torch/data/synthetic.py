"""Synthetic BIDS dataset generator (the port's own copy of
``unet_bssfp_tpu/data/synthetic.py``: the same seed gives the same arrays).

Builds an on-disk BIDS tree with the ``desc-`` tags and directory shape the
data layer expects (``.../sub-XX/ses-YY/<datatype>/file``), for end-to-end
runs without real data. Volumes are smooth random fields in [0, 1], like
normalised MRI.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np

from unet_bssfp_tpu_torch.data.nifti import save_volume


def _smooth_field(rng, shape, channels):
    # Trilinear-upsample a coarse random grid → smooth MRI-like structure.
    # Per axis, the interp is a (target, 5) weight matrix applied as
    # scalar × slab multiply-accumulates (neither fancy indexing nor a
    # skinny K=5 GEMM, both far slower for a 24-channel (96,128,128)
    # volume). Identical weights → identical field values.
    base = rng.random((5, 5, 5, channels)).astype(np.float32)
    coarse = base
    for ax, target in enumerate(shape):
        src = coarse.shape[ax]
        idx = np.linspace(0, src - 1, target)
        lo = np.floor(idx).astype(int)
        hi = np.minimum(lo + 1, src - 1)
        frac = (idx - lo).astype(np.float32)
        w = np.zeros((target, src), np.float32)
        w[np.arange(target), lo] += 1.0 - frac
        w[np.arange(target), hi] += frac
        # Scalar × contiguous-slab accumulate per (target, src) weight: a
        # stride-0 broadcast loop is far slower than this tiny Python loop.
        cm = np.ascontiguousarray(np.moveaxis(coarse, ax, 0))
        out = np.zeros((target,) + cm.shape[1:], np.float32)
        for s in range(src):
            c = cm[s]
            col = w[:, s]
            for t in range(target):
                if col[t] != 0.0:
                    out[t] += col[t] * c
        coarse = np.moveaxis(out, 0, ax)
    return np.clip(np.ascontiguousarray(coarse, np.float32), 0.0, 1.0)


def _linked_map(x: np.ndarray, out_channels: int, tag: int) -> np.ndarray:
    """Fixed global deterministic voxel-wise map for the ``linked`` regime.

    ``tanh`` of a seeded random channel mix, rescaled to [0, 1]. The weights
    depend only on ``tag`` (never on the subject), so the input→target
    relation is identical across subjects and sessions — a model that learns
    it on train subjects generalises to val/test subjects.
    """
    rng = np.random.default_rng(987650 + tag)
    cin = x.shape[-1]
    w = rng.standard_normal((cin, out_channels)).astype(np.float32)
    w /= np.sqrt(cin)
    b = 0.1 * rng.standard_normal((out_channels,)).astype(np.float32)
    z = np.tanh((x - 0.5) @ (2.0 * w) + b)
    return ((z + 1.0) * 0.5).astype(np.float32)


def make_synthetic_bids(
    root: str,
    subjects: Sequence[str] = ("01", "02", "03", "04", "05"),
    sessions: Sequence[str] = ("1", "2"),
    volume_shape: Tuple[int, int, int] = (24, 32, 32),
    seed: int = 0,
    derivatives: str = "derivatives/preproc-dove",
    linked: bool = False,
    link_tag_offset: int = 0,
) -> str:
    """Create the fixture tree; returns ``root``.

    Per subject/session: a DT (desc-normtensor_dwi, 6ch), a pc-bSSFP
    (desc-normflatbet_bssfp, 24ch), a one-cycle bSSFP (desc-nfbnopc_bssfp,
    24ch); per subject (first session): a T1w (desc-normrepeat_T1w, 6ch), a
    brain mask (desc-2mmiso_mask) and a CSF/GM/WM probseg (desc-probseg_T1w).

    ``linked=False`` (default): every volume is an independent smooth random
    field — there is NO learnable input→target mapping, so trained quality
    saturates at the smoothness-prior floor (~15 dB val PSNR); fine for
    pipeline/regression tests, wrong for demonstrating model capacity.

    ``linked=True``: the DT, one-cycle bSSFP and T1w are fixed global
    deterministic voxel-wise functions of the subject's pc-bSSFP field
    (``_linked_map``), so ``<modality> → DT`` is exactly learnable and a
    capable model can approach the reference's 30–43 dB PSNR regime
    (BASELINE.md finetune table). Use single-session subjects with this
    regime: the data layer cross-products DT and bSSFP files across sessions
    (reference ``src/data_module.py:108-117``), and a ses-1 DT paired with a
    ses-2 bSSFP would break the link.

    ``link_tag_offset`` shifts the ``_linked_map`` seed tags, producing a
    COHORT with a different (but same-family) generating map — the
    two-cohort domain-transfer fixture: pretrain on a large offset-0 cohort,
    finetune on a small offset-k cohort whose input→target relation is
    related but not identical, mirroring the thesis's pretrain→finetune
    domain shift (the thesis's ``03-methods.tex:784-787``).
    """
    rng = np.random.default_rng(seed)
    deriv_root = os.path.join(root, derivatives)
    for sub in subjects:
        for i, ses in enumerate(sessions):
            base = os.path.join(deriv_root, f"sub-{sub}", f"ses-{ses}")
            for dtype_dir in ("dwi", "anat"):
                os.makedirs(os.path.join(base, dtype_dir), exist_ok=True)
            pre = f"sub-{sub}_ses-{ses}"
            if linked:
                pc = _smooth_field(rng, volume_shape, 24)
                dt = _linked_map(pc, 6, tag=1 + link_tag_offset)
                nopc = _linked_map(pc, 24, tag=2 + link_tag_offset)
            else:
                # draw order is load-bearing: it pins the byte content of
                # the (cached, round-tracked) unlinked fixtures
                dt = _smooth_field(rng, volume_shape, 6)
                pc = _smooth_field(rng, volume_shape, 24)
                nopc = _smooth_field(rng, volume_shape, 24)
            save_volume(
                os.path.join(base, "dwi", f"{pre}_desc-normtensor_dwi.nii.gz"),
                dt,
            )
            save_volume(
                os.path.join(base, "dwi", f"{pre}_desc-normflatbet_bssfp.nii.gz"),
                pc,
            )
            save_volume(
                os.path.join(base, "dwi", f"{pre}_desc-nfbnopc_bssfp.nii.gz"),
                nopc,
            )
            if i == 0:
                save_volume(
                    os.path.join(base, "anat", f"{pre}_desc-normrepeat_T1w.nii.gz"),
                    (_linked_map(pc, 6, tag=3 + link_tag_offset) if linked
                     else _smooth_field(rng, volume_shape, 6)),
                )
                mask = (rng.random(volume_shape) > 0.2).astype(np.float32)
                save_volume(
                    os.path.join(base, "anat", f"{pre}_desc-2mmiso_mask.nii.gz"),
                    mask[..., None],
                )
                probs = rng.random(volume_shape + (3,)).astype(np.float32)
                probs = probs / probs.sum(-1, keepdims=True)
                save_volume(
                    os.path.join(base, "anat", f"{pre}_desc-probseg_T1w.nii.gz"),
                    probs,
                )
    return root
