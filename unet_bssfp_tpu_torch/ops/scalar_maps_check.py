"""How two implementations of the DT scalar maps are held to each other (K8
against its plain version, either against the JAX package): realistic
tensors to check them on (:func:`sample_dt_volume`), the per-voxel bound
they obey (:func:`scalar_maps_tolerance`, :func:`compare_scalar_maps`), and
the bound that carries into the ROI error table
(:func:`compare_error_tables`). The tests and ``chip_smoke.py`` use these;
the eval path does not.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

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


def compare_error_tables(got: List[Dict[str, object]],
                         want: List[Dict[str, object]]) -> List[tuple]:
    """The cells of two ROI error tables (``eval.evaluate.calc_error_table``
    rows) that differ past their bound; empty where they agree. Two chains
    that differ only in their scalar-maps implementation (K8 on the card,
    the plain version on the CPU) compute the same maps bit for bit except
    the angles' last bits (atan2f/acosf against the CPU's, ≤ 3 ulp of
    ≤ 180° on each side), and each cell is an f64 sum rounded once to f32:
    so |Δ| ≤ 4u·|cell|, plus 16u·180° for the angles."""
    if len(got) != len(want):
        return [("rows", len(got), len(want))]
    bad = []
    for g, w in zip(got, want):
        if list(g) != list(w):
            return [("columns", list(g), list(w))]
        for k, v in w.items():
            if isinstance(v, str):
                if g[k] != v:
                    bad.append((k, g[k], v))
                continue
            tol = 4 * U * abs(v) + (16 * U * 180 if k in ("azimuth", "inclination") else 0)
            if not abs(g[k] - v) <= tol:
                bad.append((g["sub"], g["roi"], k, g[k], v, tol))
    return bad
