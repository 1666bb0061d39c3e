"""Checkpoint-driven evaluation, prediction post-processing and the ROI
error table (counterpart of ``unet_bssfp_tpu/eval/evaluate.py``).

``eval_model`` runs a checkpoint's generator over the test cohort
(``run_test``) and writes ``test_metrics.csv``; ``gen_predictions`` does so
for each modality and runs the chain below on each prediction directory.
The chain a user runs over a directory of predictions: de-normalise each
predicted and target DT (``*_denorm``), derive its 7 scalar maps (K8 on the
card), write relative and angular error maps (``diff-``) with their
denominator-floored twins (``dfloor-``), and reduce them to probseg-weighted
means per (modality, prediction, subject, session, ROI). The per-voxel math
runs on ``device`` (``cuda`` unless the caller asks for another); NIfTI I/O
fans out over ``num_workers`` host threads. The table is built and written
with the standard library: the same header, rows and order as the JAX
package's pandas pivot.
"""

from __future__ import annotations

import csv
import math
import os
import re
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from unet_bssfp_tpu_torch.config import Config
from unet_bssfp_tpu_torch.data.bids import BIDSIndex
from unet_bssfp_tpu_torch.data.nifti import load_volume, save_volume
from unet_bssfp_tpu_torch.data.queue import parallel_map
from unet_bssfp_tpu_torch.data.transforms import crop_or_pad
from unet_bssfp_tpu_torch.eval.inference import run_test
from unet_bssfp_tpu_torch.models.medicalnet import load_medicalnet, medicalnet_is_pretrained
from unet_bssfp_tpu_torch.ops.error_maps import (
    angular_error_map,
    masked_probseg,
    relative_error_map,
    relative_error_map_floored,
    roi_weighted_mean_errors,
)
from unet_bssfp_tpu_torch.ops.scalar_maps import (
    ScalarMaps,
    compute_scalar_maps,
    invert_dwi_tensor_norm,
    load_rescale_args,
)
from unet_bssfp_tpu_torch.train.checkpoint import (
    generator_state_dict,
    load_config_for_checkpoint,
)
from unet_bssfp_tpu_torch.train.state import build_models, resolve_device
from unet_bssfp_tpu_torch.train.steps import make_medicalnet_fid_fn, make_predict_fn

TENSOR_COLS = ("dxx", "dxy", "dxz", "dyy", "dyz", "dzz")
ROI_NAMES = ("CSF", "GM", "WM")
BASE_COLS = TENSOR_COLS + ("md", "fa", "ad", "rd", "azimuth", "inclination")

_NAME_RE = re.compile(
    r"(?P<kind>input|pred|target|diff|dfloor)-(?P<idx>\d+)_mod-(?P<mod>.+?)"
    # optional save_predictions timestamp: must not fold into `mod`
    r"(?:_(?P<time>\d{8}-\d{6}))?"
    r"_sub-(?P<sub>[^_]+)_ses-(?P<ses>[^_.]+)"
    r"(?P<deriv>(?:_[a-z]+)?)\.nii(?:\.gz)?$"
)


def run_concurrently(func, arglist, n_concurrent: int = 8) -> list:
    """``[func(a) for a in arglist]`` over ``n_concurrent`` host threads, in
    order (reference ``run_concurrently``, ``src/eval.py:23-36``, a process
    pool there): the per-voxel math runs on the device, the host work is
    I/O."""
    return parallel_map(func, arglist, num_workers=n_concurrent)


def parse_pred_name(path: str) -> Optional[Dict[str, str]]:
    m = _NAME_RE.search(os.path.basename(path))
    if not m:
        return None
    d = m.groupdict()
    d["deriv"] = d["deriv"].lstrip("_")
    return d


def _list_files(directory: str) -> List[str]:
    """Every NIfTI file under ``directory``, recursively (prediction roots
    hold one subdirectory per modality)."""
    out = []
    for root, _, files in os.walk(directory):
        for fn in files:
            if fn.endswith(".nii.gz") or fn.endswith(".nii"):
                out.append(os.path.join(root, fn))
    return sorted(out)


def _tensor_files(directory: str, deriv: str) -> List[str]:
    """pred/target files whose derivative suffix is ``deriv``."""
    out = []
    for path in _list_files(directory):
        ents = parse_pred_name(path)
        if ents and ents["kind"] in ("pred", "target") and ents["deriv"] == deriv:
            out.append(path)
    return out


def _load(path: str, device: torch.device):
    data, affine = load_volume(path)
    return torch.from_numpy(data).to(device), affine


def _save(path: str, data: torch.Tensor, affine) -> None:
    save_volume(path, data.float().cpu().numpy(), affine)


def _renamed(path: str, new_base: str) -> str:
    """``path`` with its basename replaced; the directories are kept as they
    are (a directory may share a derivative's substring)."""
    return os.path.join(os.path.dirname(path), new_base)


def _with_deriv(path: str, deriv: str) -> str:
    """``x.nii.gz`` → ``x_<deriv>.nii.gz`` (or ``.nii``)."""
    base = os.path.basename(path)
    ext = ".nii.gz" if base.endswith(".nii.gz") else ".nii"
    return _renamed(path, base[: -len(ext)] + f"_{deriv}{ext}")


# ---------------------------------------------------------------------------
# de-normalisation
# ---------------------------------------------------------------------------

def invert_dwi_tensor_norm_files(directory: str, params: str, num_workers: int = 8,
                                 device=None) -> List[str]:
    """Write ``*_denorm`` next to each pred/target tensor file."""
    dev = resolve_device(device)
    minmax = load_rescale_args(params)

    def work(path):
        data, affine = _load(path, dev)
        out_path = _with_deriv(path, "denorm")
        _save(out_path, invert_dwi_tensor_norm(data, minmax), affine)
        return out_path

    return parallel_map(work, _tensor_files(directory, ""), num_workers)


def _alias_norm_as_denorm(pred_dir: str) -> None:
    """Without rescale constants, the maps are taken of the normalised
    tensors: copy each pred/target as its ``*_denorm``."""
    for path in _tensor_files(pred_dir, ""):
        data, affine = load_volume(path)
        save_volume(_with_deriv(path, "denorm"), data, affine)


# ---------------------------------------------------------------------------
# scalar maps
# ---------------------------------------------------------------------------

def calc_scalar_maps(directory: str, num_workers: int = 8,
                     source_deriv: str = "denorm", device=None) -> List[str]:
    """For every ``*_<source_deriv>`` pred/target file write its 7 scalar
    maps (fa/md/ad/rd/azimuth/inclination/rgb): one K8 launch per volume on
    the card."""
    dev = resolve_device(device)

    def work(path):
        data, affine = _load(path, dev)
        maps = compute_scalar_maps(data)
        base = os.path.basename(path)
        out_paths = []
        for name in ScalarMaps._fields:
            if source_deriv:
                out_base = base.replace(f"_{source_deriv}", f"_{name}")
            else:
                out_base = base.replace(".nii", f"_{name}.nii", 1)
            out_path = _renamed(path, out_base)
            _save(out_path, getattr(maps, name), affine)
            out_paths.append(out_path)
        return out_paths

    todo = _tensor_files(directory, source_deriv)
    return [p for sub in parallel_map(work, todo, num_workers) for p in sub]


# ---------------------------------------------------------------------------
# difference maps
# ---------------------------------------------------------------------------

def calc_diff_maps(directory: str, num_workers: int = 8, device=None) -> List[str]:
    """``diff-`` maps: relative error for tensors and diffusivities, angular
    error for azimuth/inclination; each relative map also gets its
    denominator-floored twin ``dfloor-``."""
    dev = resolve_device(device)
    by_key: Dict[Tuple, Dict[str, str]] = {}
    for path in _list_files(directory):
        ents = parse_pred_name(path)
        if not ents or ents["kind"] not in ("pred", "target") or ents["deriv"] == "rgb":
            continue
        key = (ents["idx"], ents["mod"], ents["sub"], ents["ses"], ents["deriv"])
        by_key.setdefault(key, {})[ents["kind"]] = path

    pairs = []
    for key, kinds in sorted(by_key.items()):
        if "pred" in kinds and "target" in kinds:
            pairs.append((kinds["pred"], kinds["target"], key[4]))
        else:
            print(f"Could not find both files for {key}: {list(kinds)}")

    def work(args):
        pred_path, target_path, deriv = args
        p, affine = _load(pred_path, dev)
        t, _ = _load(target_path, dev)
        pbase = os.path.basename(pred_path)
        out_path = _renamed(pred_path, pbase.replace("pred-", "diff-", 1))
        if deriv in ("azimuth", "inclination"):
            _save(out_path, angular_error_map(p, t), affine)
            return out_path
        _save(out_path, relative_error_map(p, t), affine)
        _save(_renamed(pred_path, pbase.replace("pred-", "dfloor-", 1)),
              relative_error_map_floored(p, t), affine)
        return out_path

    return parallel_map(work, pairs, num_workers)


# ---------------------------------------------------------------------------
# ROI error table
# ---------------------------------------------------------------------------

def _load_masks(data_path: str, subjects: Iterable[str], derivatives: str,
                device: torch.device):
    index = BIDSIndex(data_path)
    deriv_dir = os.path.join(data_path, derivatives)
    if os.path.isdir(deriv_dir):
        index.add_derivatives(deriv_dir)
    scope = os.path.basename(derivatives.rstrip("/"))
    masks, probsegs = {}, {}
    for sub in subjects:
        mask_files = index.get(scope=scope, subject=sub, desc="2mmiso", suffix="mask")
        seg_files = index.get(scope=scope, subject=sub, desc="probseg", suffix="T1w")
        if not mask_files or not seg_files:
            continue
        mask = _load(mask_files[0], device)[0][..., 0]
        masks[sub] = mask
        probsegs[sub] = masked_probseg(mask, _load(seg_files[0], device)[0])
    return masks, probsegs


def calc_error_table(pred_path: str, data_path: str, out_csv: Optional[str] = None,
                     derivatives: str = "derivatives/preproc-dove",
                     num_workers: int = 8, device=None) -> List[Dict[str, object]]:
    """Probseg-weighted mean |error| per (modality, pred_id, sub, ses, roi)
    × (tensor elements + scalars, and their ``_floored`` twins from the
    ``dfloor-`` maps). Returns the table's rows (dicts keyed by
    :func:`table_columns`, in the table's order) and writes ``out_csv`` when
    given and the table is not empty.

    As the JAX package's ``pivot_table``: rows sorted by (modality, pred_id,
    sub, ses, roi) as strings, duplicate keys (files that differ only in
    their timestamp) averaged, a missing entry NaN; masks and probsegs
    crop-or-padded to the prediction's grid."""
    dev = resolve_device(device)
    diff_files = []
    for root, _, files in os.walk(pred_path):
        for fn in sorted(files):
            ents = parse_pred_name(fn)
            if ents and ents["kind"] in ("diff", "dfloor") and \
                    ents["deriv"] not in ("denorm", "rgb"):
                diff_files.append(os.path.join(root, fn))
    subjects = sorted({parse_pred_name(f)["sub"] for f in diff_files})
    masks, probsegs = _load_masks(data_path, subjects, derivatives, dev)

    def work(path):
        ents = parse_pred_name(path)
        sub = ents["sub"]
        if sub not in masks:
            return []
        data, _ = _load(path, dev)
        spatial = tuple(data.shape[:3])
        mask, probseg = masks[sub], probsegs[sub]
        if tuple(mask.shape[:3]) != spatial:
            mask = crop_or_pad(mask[..., None], spatial)[..., 0]
            probseg = crop_or_pad(probseg, spatial)
        errors = roi_weighted_mean_errors(data, mask, probseg).cpu().tolist()
        cols = [ents["deriv"]] if ents["deriv"] else list(TENSOR_COLS)
        if ents["kind"] == "dfloor":
            cols = [f"{c}_floored" for c in cols]
        return [((ents["mod"], ents["idx"], sub, ents["ses"], roi), col, errors[r][c])
                for r, roi in enumerate(ROI_NAMES) for c, col in enumerate(cols)]

    cells: Dict[Tuple, Dict[str, List[float]]] = {}
    for found in parallel_map(work, diff_files, num_workers):
        for key, col, value in found:
            cells.setdefault(key, {}).setdefault(col, []).append(value)
    present = {col for by_col in cells.values() for col in by_col}
    value_cols = [c for c in BASE_COLS + tuple(f"{b}_floored" for b in BASE_COLS)
                  if c in present]
    rows = []
    for (mod, idx, sub, ses, roi), by_col in sorted(cells.items()):
        row = {"modality": mod, "pred_id": idx, "roi": roi, "sub": sub, "ses": ses}
        for col in value_cols:
            vals = by_col.get(col)
            # the mean of f32 values, kept in f32 as the pandas table is
            row[col] = float(np.float32(sum(vals) / len(vals))) if vals else math.nan
        rows.append(row)
    if rows and out_csv:
        write_table(rows, out_csv)
    return rows


def table_columns(rows: List[Dict[str, object]]) -> List[str]:
    """The table's header: the index (modality, pred_id, roi), then sub, ses
    and the value columns in the table's order."""
    return list(rows[0]) if rows else []


def _cell(v) -> str:
    if isinstance(v, float):  # pandas writes f32 values' shortest repr, NaN as ""
        return "" if math.isnan(v) else str(np.float32(v))
    return str(v)


def write_table(rows: List[Dict[str, object]], path: str) -> None:
    """The table as CSV, as the JAX package's pandas table writes it."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(table_columns(rows))
        for row in rows:
            writer.writerow([_cell(v) for v in row.values()])


def format_table(rows: List[Dict[str, object]]) -> str:
    """The table as aligned text, for the CLI."""
    if not rows:
        return "Empty table: no diff maps with masks found"

    def shown(v) -> str:
        if isinstance(v, float):
            return "NaN" if math.isnan(v) else f"{v:.6g}"
        return str(v)

    cols = table_columns(rows)
    text = [cols] + [[shown(v) for v in row.values()] for row in rows]
    widths = [max(len(r[i]) for r in text) for i in range(len(cols))]
    return "\n".join("  ".join(s.rjust(w) for s, w in zip(r, widths)) for r in text)


# ---------------------------------------------------------------------------
# the chain
# ---------------------------------------------------------------------------

def eval_dwi_tensors(pred_dir: str, dwi_rescale_args_path: Optional[str] = None,
                     num_workers: int = 8, device=None) -> None:
    """The per-directory chain: de-normalise (or, without rescale
    constants, alias the normalised tensors as ``*_denorm``), scalar maps,
    difference maps."""
    if dwi_rescale_args_path and os.path.exists(dwi_rescale_args_path):
        invert_dwi_tensor_norm_files(pred_dir, dwi_rescale_args_path, num_workers,
                                     device)
    else:
        _alias_norm_as_denorm(pred_dir)
    calc_scalar_maps(pred_dir, num_workers, "denorm", device)
    calc_diff_maps(pred_dir, num_workers, device)


# ---------------------------------------------------------------------------
# checkpoint-driven evaluation
# ---------------------------------------------------------------------------

def eval_model(data, checkpoint_path: str, modality: str, pred_dir: str,
               config: Optional[Config] = None, with_fid: bool = True,
               device=None) -> Dict[str, float]:
    """Test inference from a checkpoint (reference ``eval_model``,
    ``src/eval.py:195-213``): the generator of ``modality`` built from
    ``config`` (None: the ``config.json`` beside the checkpoint, else
    ``Config()``) on ``device`` (default ``cuda``), loaded with the step's
    generator weights and buffers alone (``generator_state_dict``, so a
    checkpoint from any device evaluates on any device); ``run_test`` over
    ``data``'s test volumes into ``pred_dir``, whole-volume where the model
    was trained so; ``test_metrics.csv`` (``modality`` and the metric
    means) written there. Returns the metrics.

    ``with_fid``: the reference's MedicalNet FID of each stitched volume
    (``src/model.py:235-257, 308-309``), ``test_metric_FID`` with the
    pretrained Med3D weights of ``train.medicalnet_weights``, else
    ``test_metric_FID_random_features``."""
    dev = resolve_device(device)
    if config is None:
        saved = load_config_for_checkpoint(checkpoint_path)
        config = Config.from_json(saved) if saved else Config()
    gen, _ = build_models(modality, config.model, dev,
                          state_dict=generator_state_dict(checkpoint_path))
    fid_fn = None
    if with_fid:
        path = config.train.medicalnet_weights
        fid_fn = make_medicalnet_fid_fn(load_medicalnet(path, device=dev),
                                        pretrained=medicalnet_is_pretrained(path))
    data.setup()
    metrics = run_test(make_predict_fn(gen), data, modality, pred_dir,
                       patch_size=config.data.patch_size,
                       whole_volume=config.data.whole_volume, fid_fn=fid_fn, device=dev)
    os.makedirs(pred_dir, exist_ok=True)
    with open(os.path.join(pred_dir, "test_metrics.csv"), "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["modality", *metrics])
        writer.writeheader()
        writer.writerow({"modality": modality, **metrics})
    return metrics


def gen_predictions(data, checkpoints: Dict[str, str], pred_base: str,
                    dwi_rescale_args_path: Optional[str] = None,
                    config: Optional[Config] = None, num_workers: int = 8,
                    device=None) -> None:
    """For each ``{modality: checkpoint}``: ``eval_model`` into
    ``pred_base/<modality>``, then the chain (``eval_dwi_tensors``) on it
    (reference ``gen_predictions``, ``src/eval.py:326-351``, with the paths
    as arguments)."""
    for modality, ckpt in checkpoints.items():
        pred_dir = os.path.join(pred_base, modality)
        eval_model(data, ckpt, modality, pred_dir, config, device=device)
        eval_dwi_tensors(pred_dir, dwi_rescale_args_path, num_workers, device)
