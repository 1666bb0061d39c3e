"""Batched symmetric 3×3 eigendecomposition by cyclic Jacobi (counterpart of
``unet_bssfp_tpu/ops/eig3.py``).

Plain PyTorch, one elementwise op per step, in the JAX package's order: the
CPU path of :func:`ops.scalar_maps.compute_scalar_maps` and the reference
that K8 (``csrc/scalar_maps.cu``) repeats op for op. Fixed 5 sweeps over the
pairs (0,1), (0,2), (1,2), no data-dependent control flow. Every step is
IEEE-rounded, as K8's are: ATen's f32 ``sqrt`` on the CPU is not correctly
rounded for every input, so :func:`sqrt_rn` takes it in f64, and a division by a constant divides by a tensor (ATen's
CUDA division by a Python scalar multiplies by its reciprocal).

Conventions as ``np.linalg.eigh``: eigenvalues ascending, eigenvectors as
columns (``v[..., :, k]`` pairs with ``w[..., k]``); each column's first
largest-|·| component is made non-negative.
"""

from __future__ import annotations

from typing import Tuple

import torch

N_SWEEPS = 5


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded square root: f32 through f64 (exact for an f32
    input: the f64 root rounds once more to the nearest f32)."""
    if x.dtype == torch.float32:
        return torch.sqrt(x.to(torch.float64)).to(torch.float32)
    return torch.sqrt(x)


def _jacobi_rotation(app, aqq, apq):
    """Rotation (c, s, t) zeroing the (p, q) entry (``eig3.py:32-43``).
    ``sign(0) = 0``; ``theta == 0`` gives t = 1, but ``apq == 0`` (identity)
    wins over it."""
    safe_apq = torch.where(apq == 0.0, 1.0, apq)
    theta = (aqq - app) / (2.0 * safe_apq)
    t = torch.sign(theta) / (torch.abs(theta) + sqrt_rn(theta * theta + 1.0))
    t = torch.where(theta == 0.0, 1.0, t)
    t = torch.where(apq == 0.0, 0.0, t)
    c = 1.0 / sqrt_rn(t * t + 1.0)
    return c, t * c, t


def _rotate_vecs(v, p, q, c, s):
    """``V <- V @ G(p, q, c, s)`` on the row-major 9-tuple ``v``."""
    v = list(v)
    for r in range(3):
        vp, vq = v[3 * r + p], v[3 * r + q]
        v[3 * r + p] = c * vp - s * vq
        v[3 * r + q] = s * vp + c * vq
    return tuple(v)


def _sweep(a, v):
    a00, a01, a02, a11, a12, a22 = a
    zero = torch.zeros_like(a00)
    c, s, t = _jacobi_rotation(a00, a11, a01)                       # (0, 1)
    a00, a11, a02, a12, a01 = (a00 - t * a01, a11 + t * a01, c * a02 - s * a12,
                               s * a02 + c * a12, zero)
    v = _rotate_vecs(v, 0, 1, c, s)
    c, s, t = _jacobi_rotation(a00, a22, a02)                       # (0, 2)
    a00, a22, a01, a12, a02 = (a00 - t * a02, a22 + t * a02, c * a01 - s * a12,
                               s * a01 + c * a12, zero)
    v = _rotate_vecs(v, 0, 2, c, s)
    c, s, t = _jacobi_rotation(a11, a22, a12)                       # (1, 2)
    a11, a22, a01, a02, a12 = (a11 - t * a12, a22 + t * a12, c * a01 - s * a02,
                               s * a01 + c * a02, zero)
    v = _rotate_vecs(v, 1, 2, c, s)
    return (a00, a01, a02, a11, a12, a22), v


def eigh3x3_sym(a00: torch.Tensor, a01: torch.Tensor, a02: torch.Tensor,
                a11: torch.Tensor, a12: torch.Tensor, a22: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigendecomposition of symmetric 3×3 matrices given as 6 component
    tensors of one shape ``S`` → ``(w: S + (3,), v: S + (3, 3))``, computed in
    ``promote_types(dtype, float32)``."""
    dtype = torch.promote_types(a00.dtype, torch.float32)
    a = tuple(x.to(dtype) for x in (a00, a01, a02, a11, a12, a22))
    # Scale-normalise (``eig3.py:117-130``): multiply by 1/scale, scale 0 → 1.
    scale = torch.abs(a[5])
    for x in reversed(a[:5]):
        scale = torch.maximum(torch.abs(x), scale)
    inv_scale = torch.where(scale == 0.0, 1.0, 1.0 / scale)
    a = tuple(x * inv_scale for x in a)

    one, zero = torch.ones_like(a[0]), torch.zeros_like(a[0])
    v = (one, zero, zero, zero, one, zero, zero, zero, one)  # row-major I
    for _ in range(N_SWEEPS):
        a, v = _sweep(a, v)

    w = [a[0] * scale, a[3] * scale, a[5] * scale]
    cols = [(v[0], v[3], v[6]), (v[1], v[4], v[7]), (v[2], v[5], v[8])]

    def cswap(i, j):  # strict >: ties do not swap
        swap = w[i] > w[j]
        w[i], w[j] = torch.where(swap, w[j], w[i]), torch.where(swap, w[i], w[j])
        ci, cj = cols[i], cols[j]
        cols[i] = tuple(torch.where(swap, b, x) for x, b in zip(ci, cj))
        cols[j] = tuple(torch.where(swap, x, b) for x, b in zip(ci, cj))

    cswap(0, 1)
    cswap(1, 2)
    cswap(0, 1)

    signed = []
    for col in cols:  # the first component with the largest |·| leads
        ax, ay, az = (torch.abs(x) for x in col)
        amax = torch.maximum(torch.maximum(ax, ay), az)
        lead = torch.where(ax == amax, col[0], torch.where(ay == amax, col[1], col[2]))
        sgn = torch.where(lead < 0, -1.0, 1.0)  # only lead < 0 flips: -0.0 does not
        signed.append(tuple(x * sgn for x in col))

    w_out = torch.stack(w, dim=-1)
    v_out = torch.stack([torch.stack([signed[k][r] for k in range(3)], dim=-1)
                         for r in range(3)], dim=-2)
    return w_out, v_out


def eigh3x3_from_lower6(d6: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """From the channels-last 6-channel DT layout ``(..., 6)`` ordered
    (dxx, dxy, dxz, dyy, dyz, dzz)."""
    return eigh3x3_sym(*(d6[..., i] for i in range(6)))
