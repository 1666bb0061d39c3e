"""How two implementations of the DT scalar maps are held to each other (K8
against its plain version, either against the JAX package): realistic
tensors to check them on (:func:`sample_dt_volume`), the per-voxel bound
they obey (:func:`scalar_maps_tolerance`, :func:`compare_scalar_maps`), and
how that bound carries through the eval chain's files
(:func:`chain_bounds`, :func:`compare_chain_files`) into the ROI error
table (:func:`table_cell_bounds`, :func:`compare_error_tables`). The tests
and ``chip_smoke.py`` use these; the eval path does not.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from unet_bssfp_tpu_torch.ops.eig3 import eigh3x3_from_lower6
from unet_bssfp_tpu_torch.ops.error_maps import angular_error_map
from unet_bssfp_tpu_torch.ops.kernels.scalar_maps import RAD2DEG, scalar_maps_plain
from unet_bssfp_tpu_torch.ops.scalar_maps import ScalarMaps


def sample_dt_volume(shape: Sequence[int], seed: int) -> np.ndarray:
    """Diffusion tensors as a brain volume holds them, ``shape + (6,)`` f32
    from ``seed``: eigenvalues 1e-4 … 3.5e-3 mm²/s under random rotations,
    with 30 % exact-zero background, 5 % exactly isotropic diagonal voxels
    (CSF), 5 % rotated isotropic ones and 5 % planar ones (λ1 = λ2)."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    lam = np.sort(rng.uniform(1e-4, 3.5e-3, (n, 3)), axis=-1)
    kind = rng.random(n)
    planar = (kind >= 0.85) & (kind < 0.9)
    lam[planar, 2] = lam[planar, 1]                                 # planar
    iso = (kind >= 0.75) & (kind < 0.85)
    lam[iso] = lam[iso, :1]                                         # isotropic
    q, r = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    q = q * np.sign(np.diagonal(r, axis1=-2, axis2=-1))[:, None, :]
    q[(kind >= 0.75) & (kind < 0.8)] = np.eye(3)                    # exactly diagonal
    dt = np.einsum("nij,nj,nkj->nik", q, lam, q)
    d6 = dt[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]].astype(np.float32)
    d6[kind < 0.3] = 0.0                                            # background
    return d6.reshape(tuple(shape) + (6,))


# Tolerance between two f32 implementations of the maps (the kernel and its
# plain version, or either and the JAX package). Each result is the exact
# one of a matrix within ROUNDINGS roundings (u = 2^-24) of the input, whose
# entries are at most s = max|d6| per voxel: 15 rotations of at most four
# roundings on an entry, and the scaling. Two such results lie within
#   e = 2·ROUNDINGS·u·s
# in every eigenvalue (Weyl), so md, ad and rd within e, FA within 5·e/‖λ‖
# (|∂FA/∂λ| ≤ 2·sqrt(1.5)·sqrt(3)/‖λ‖ < 5/‖λ‖), and the principal
# eigenvectors within θ = e/(λ2 − λ1) radians (Davis–Kahan). An angle θ
# moves the azimuth by at most θ/(r_xy − θ) (r_xy: the vector's length in
# the x-y plane) and the inclination by at most θ, plus acos's rounding
# step near ±1 (cos moved by 4u moves acos by min(4u/sin, sqrt(8u))); RGB =
# FA·|v2| moves by the FA bound plus FA·θ. Each output adds a few roundings
# of its own (4u of its size; atan2f/acosf are within 2 ulp).
# Angles and RGB are compared only where they are well defined: the gap
# λ2 − λ1 ≥ 1e-2·max|λ| (planar and isotropic voxels have none), r_xy > 2θ
# (the azimuth of a vector along z has none) and the two largest |·| of v2
# more than 2θ apart (else either side may pick the other sign). Zero
# voxels (s = 0) must agree exactly.
ROUNDINGS = 64
U = 2.0 ** -24
GAP_FRAC = 1e-2


def scalar_maps_tolerance(d6: torch.Tensor, angle_atol: float = 0.0,
                          input_err=0.0):
    """Per-voxel bounds on |a − b| for two f32 implementations of the maps of
    ``d6``: ``{field: tensor}`` (rgb ``S + (3,)``), 0 at zero voxels and inf
    where an angle or RGB is left out; and the ``S`` mask of voxels whose
    angles and RGB are compared. ``angle_atol`` (degrees) is added to the
    angle bounds for a side whose atan2 is approximated; ``input_err``
    (scalar or ``S``) bounds how far the two sides' inputs differ per entry
    (‖δA‖₂ ≤ 3·that is added to e)."""
    d6 = d6.to(torch.float64)
    w, v = eigh3x3_from_lower6(d6)
    v2 = v[..., :, 2]
    s = d6.abs().amax(-1)
    zero = s == 0
    e = 2 * ROUNDINGS * U * s + 3 * input_err
    gap = w[..., 2] - w[..., 1]
    theta = e / gap.clamp_min(1e-300)
    rxy = torch.sqrt(v2[..., 0] ** 2 + v2[..., 1] ** 2)
    top2 = v2.abs().sort(-1).values
    gate = ((gap >= GAP_FRAC * w.abs().amax(-1)) & (rxy > 2 * theta)
            & (top2[..., 2] - top2[..., 1] > 2 * theta)) | zero
    fa_tol = 5 * e / torch.linalg.vector_norm(w, dim=-1).clamp_min(1e-300) + 4 * U
    fa = scalar_maps_plain(d6)[0]
    sin_incl = torch.sqrt(1 - v2[..., 2].clamp(-1, 1) ** 2)
    acos_step = torch.clamp_max(4 * U / sin_incl.clamp_min(1e-300), math.sqrt(8 * U))
    tol = {
        "fa": fa_tol,
        "md": e + 4 * U * w.mean(-1).abs(),
        "ad": e + 4 * U * w[..., 2].abs(),
        "rd": e + 4 * U * (w[..., 0] + w[..., 1]).abs() / 2,
        "azimuth": RAD2DEG * (theta / (rxy - theta).clamp_min(1e-300)
                              + 4 * U * math.pi) + angle_atol,
        "inclination": RAD2DEG * (theta + acos_step + 4 * U * math.pi) + angle_atol,
        "rgb": (fa_tol + fa * theta + 4 * U)[..., None].expand(gate.shape + (3,)),
    }
    for k in ("azimuth", "inclination", "rgb"):
        keep = gate[..., None] if k == "rgb" else gate
        tol[k] = torch.where(keep, tol[k], math.inf)
    return {k: torch.where(zero[..., None] if k == "rgb" else zero, 0.0, t)
            for k, t in tol.items()}, gate


def compare_scalar_maps(got, ref, d6: torch.Tensor, angle_atol: float = 0.0,
                        input_err=0.0) -> Dict[str, object]:
    """Hold ``got`` to ``ref`` (both 7-field maps of ``d6``) at
    :func:`scalar_maps_tolerance`, angles as :func:`angular_error_map`.
    Returns per field the max |error| where compared, the max
    error/tolerance ratio and ``ok``; the voxels left out of the angle/RGB
    comparison (``gated_out``) of ``voxels``; and ``ok`` over all."""
    tol, gate = scalar_maps_tolerance(d6, angle_atol, input_err)
    out, ok = {}, True
    for k, g, r in zip(ScalarMaps._fields, got, ref):
        g, r = g.double(), r.double()
        err = angular_error_map(g, r) if k in ("azimuth", "inclination") else (g - r).abs()
        err = torch.where(torch.isnan(err), math.inf, err)
        finite = torch.isfinite(tol[k])
        err_in = torch.where(finite, err, 0.0)
        ratio = torch.where(err_in == 0, 0.0, err_in / tol[k])
        field_ok = bool((err <= tol[k]).all())
        ok = ok and field_ok
        out[k] = {"max_abs_err": float(err_in.max()) if err.numel() else 0.0,
                  "max_err_over_tol": float(ratio.max()) if err.numel() else 0.0,
                  "ok": field_ok}
    out["gated_out"] = int((~gate).sum())
    out["voxels"] = int(gate.numel())
    out["ok"] = ok
    return out


def _relative_bound(p, t, dp, dt, den=None, dden=None):
    """Bound on |Δ(|p − t|/den)| for p, t known within dp, dt (den = |t| by
    default): first order in dp/den, dden/den, plus the output's rounding;
    inf where the denominator is within 2·dden of 0 (ill-conditioned)."""
    den = np.abs(t) if den is None else den
    dden = dt if dden is None else dden
    r = np.abs(p - t) / np.where(den == 0, 1, den)
    b = (dp + dt) / den + r * dden / np.maximum(den - dden, 1e-300) + 4 * U * r
    b = np.where(den > 2 * dden, b, np.inf)
    return np.where((dp == 0) & (dt == 0) & (dden == 0), 4 * U * r, b)


def chain_bounds(files: Dict[str, np.ndarray], minmax) -> Dict[str, np.ndarray]:
    """Per-file bound on |a − b| between two runs of the eval chain
    (``eval.evaluate.eval_dwi_tensors``) on the same predictions that differ
    in their scalar-maps implementation (e.g. K8 on the card against its
    plain version on the CPU) and may round x·a + b as one FMA, from one
    run's files (name → array; ``minmax``: the rescale arguments). Inputs
    copied: 0; de-normalised: 2u·(|x|·a + |b|); maps:
    :func:`scalar_maps_tolerance` with that input bound; the relative-error
    maps (``diff-``, and ``dfloor-`` with its floor 0.1·mean|t| over t ≠ 0,
    whose N-term sum rounds by N·u and moves with the mean of dt): first
    order in their inputs' bounds, inf where a denominator is within twice
    its own bound of 0; the angles' diff maps: the sum of their bounds plus
    4u·180°."""
    from unet_bssfp_tpu_torch.eval.evaluate import parse_pred_name

    mm = np.asarray(minmax, np.float32)
    a, b = np.abs(mm[:, 1] - mm[:, 0]), mm[:, 0]
    bounds = {}
    for fn, x in files.items():
        ents = parse_pred_name(fn)
        if ents["kind"] in ("pred", "target") and ents["deriv"] == "":
            bounds[fn] = np.zeros_like(x)
        elif ents["kind"] in ("pred", "target") and ents["deriv"] == "denorm":
            bounds[fn] = 2 * U * (np.abs(files[fn.replace("_denorm", "")]) * a + np.abs(b))
    for fn, x in files.items():
        ents = parse_pred_name(fn)
        if ents["kind"] in ("pred", "target") and ents["deriv"] == "denorm":
            tol, _ = scalar_maps_tolerance(torch.from_numpy(x),
                                           input_err=torch.from_numpy(bounds[fn].max(-1)))
            for k, v in tol.items():
                mfn = fn.replace("_denorm", f"_{k}")
                bounds[mfn] = v.numpy().reshape(files[mfn].shape)
    for fn, x in files.items():
        ents = parse_pred_name(fn)
        if ents["kind"] not in ("diff", "dfloor"):
            continue
        pfn = fn.replace(f"{ents['kind']}-", "pred-", 1)
        tfn = pfn.replace("pred-", "target-", 1)
        p, t = files[pfn].astype(np.float64), files[tfn].astype(np.float64)
        dp, dt = bounds[pfn], bounds[tfn]
        if ents["deriv"] in ("azimuth", "inclination"):
            bounds[fn] = dp + dt + 4 * U * 180
        elif ents["kind"] == "diff":
            bounds[fn] = _relative_bound(p, t, dp, dt)
        else:
            at = np.abs(t)
            axes = (0, 1, 2)
            nz = at > 0
            count = np.maximum(nz.sum(axes, keepdims=True), 1)
            scale = (at * nz).sum(axes, keepdims=True) / count
            dscale = (dt * nz).sum(axes, keepdims=True) / count + at[..., :1].size * U * scale
            den = np.maximum(at, 0.1 * scale)
            dden = np.where(at >= 0.1 * scale, dt, 0.1 * dscale) + np.zeros_like(at)
            bounds[fn] = _relative_bound(p, t, dp, dt, den, dden)
    return bounds


def compare_chain_files(got: Dict[str, np.ndarray], ref: Dict[str, np.ndarray],
                        bounds: Dict[str, np.ndarray]) -> Dict[str, object]:
    """Hold every file of one chain run to the other's at ``bounds``
    (:func:`chain_bounds`): the same names, shapes and inf/NaN pattern, and
    |Δ| within the bound wherever it is finite (angles as
    :func:`angular_error_map`). Returns the files past their bound
    (``failures``), per file the voxels left out (an infinite bound), and
    ``ok``."""
    from unet_bssfp_tpu_torch.eval.evaluate import parse_pred_name

    failures, left_out = [], {}
    if sorted(got) != sorted(ref):
        return {"ok": False, "failures": [("names", sorted(got), sorted(ref))], "left_out": {}}
    for fn, x in got.items():
        y, bnd = ref[fn], bounds[fn]
        if x.shape != y.shape:
            failures.append((fn, "shape", x.shape, y.shape))
            continue
        if not (np.array_equal(np.isnan(x), np.isnan(y))
                and np.array_equal(np.isinf(x), np.isinf(y))):
            failures.append((fn, "inf/nan pattern"))
            continue
        fin = np.isfinite(x) & np.isfinite(bnd)
        if parse_pred_name(fn)["deriv"] in ("azimuth", "inclination"):
            err = angular_error_map(torch.from_numpy(x).double(),
                                    torch.from_numpy(y).double()).numpy()
        else:
            err = np.abs(x.astype(np.float64) - y)
        over = err[fin] - bnd[fin]
        if over.size and over.max() > 0:
            failures.append((fn, "past bound", float(over.max())))
        left_out[fn] = int((~np.isfinite(bnd) & np.isfinite(x)).sum())
    return {"ok": not failures, "failures": failures, "left_out": left_out}


def table_cell_bounds(rows: List[Dict[str, object]], got: Dict[str, np.ndarray],
                      ref: Dict[str, np.ndarray], bounds: Dict[str, np.ndarray],
                      masks, probsegs) -> List[Dict[str, float]]:
    """Per row and value column of an error table (``calc_error_table``'s
    rows of one run), how far the other run's cell may lie from it given the
    diff maps' bounds (:func:`chain_bounds`): each cell is Σ p·|diff| / Σ p
    over the subject's masked probseg (``masks``, ``probsegs``: the chain's
    own, by subject), so it moves by the probseg-weighted mean of its diff
    map's bound; voxels left out of that bound count with their measured
    difference between ``got`` and ``ref``."""
    from unet_bssfp_tpu_torch.eval.evaluate import ROI_NAMES, TENSOR_COLS

    out = []
    for row in rows:
        mask = np.asarray(masks[row["sub"]]) > 0
        w = np.asarray(probsegs[row["sub"]])[..., ROI_NAMES.index(row["roi"])]
        cells = {}
        for col, v in row.items():
            if isinstance(v, str):
                continue
            base = col[: -len("_floored")] if col.endswith("_floored") else col
            kind = "dfloor" if col.endswith("_floored") else "diff"
            deriv = "" if base in TENSOR_COLS else f"_{base}"
            fn = (f"{kind}-{row['pred_id']}_mod-{row['modality']}_sub-{row['sub']}"
                  f"_ses-{row['ses']}{deriv}.nii.gz")
            x, y, bnd = got[fn], ref[fn], bounds[fn]
            if deriv:
                x, y, bnd = x[..., 0], y[..., 0], bnd.reshape(x.shape)[..., 0]
            else:
                ch = TENSOR_COLS.index(base)
                x, y, bnd = x[..., ch], y[..., ch], bnd[..., ch]
            keep = mask & np.isfinite(x)
            measured = np.abs(np.abs(x.astype(np.float64)) - np.abs(y))
            b = np.where(np.isfinite(bnd), bnd, measured)
            cells[col] = float((w * np.where(keep, b, 0)).sum() / max(w.sum(), 1e-300))
        out.append(cells)
    return out


def compare_error_tables(got: List[Dict[str, object]],
                         want: List[Dict[str, object]],
                         cell_bounds: Optional[List[Dict[str, float]]] = None) -> List[tuple]:
    """The cells of two ROI error tables (``eval.evaluate.calc_error_table``
    rows) that differ past their bound; empty where they agree. Two chains
    that compute the same maps bit for bit except the angles' last bits
    (atan2f/acosf against the CPU's, ≤ 3 ulp of ≤ 180° on each side) give
    cells within 4u·|cell|, plus 16u·180° for the angles, since each cell is
    an f64 sum rounded once to f32. Where the maps differ by more (K8
    contracts a·b + c into FMAs, its plain version does not),
    ``cell_bounds`` (:func:`table_cell_bounds`) adds each cell's share of
    the diff maps' bound."""
    if len(got) != len(want):
        return [("rows", len(got), len(want))]
    bad = []
    for i, (g, w) in enumerate(zip(got, want)):
        if list(g) != list(w):
            return [("columns", list(g), list(w))]
        for k, v in w.items():
            if isinstance(v, str):
                if g[k] != v:
                    bad.append((k, g[k], v))
                continue
            tol = 4 * U * abs(v) + (16 * U * 180 if k in ("azimuth", "inclination") else 0)
            if cell_bounds is not None:
                tol += cell_bounds[i][k]
            if not abs(g[k] - v) <= tol:
                bad.append((g["sub"], g["roi"], k, g[k], v, tol))
    return bad
