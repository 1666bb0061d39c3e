"""K8: the fused per-voxel eigendecomposition + DT scalar maps.

Replaces ``unet_bssfp_tpu/ops/pallas/scalar_maps_kernel.py::
scalar_maps_planar``. The kernel is ``csrc/scalar_maps.cu`` (its header says
what bounds it and how it is laid out); :func:`scalar_maps_plain` is the same
function in plain PyTorch (``unet_bssfp_tpu/ops/scalar_maps.py:33-72``), the
CPU path and the kernel's reference, which the kernel repeats step for step
(with FMA contraction and a correctly rounded reciprocal square root, so
within the bound of ``ops/scalar_maps_check.py``, not bit for bit).
:func:`scalar_maps_plan` is the launch plan: one voxel a thread.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Tuple

import torch

from unet_bssfp_tpu_torch.ops.eig3 import eigh3x3_from_lower6, sqrt_rn
from unet_bssfp_tpu_torch.ops.kernels import _build

RAD2DEG = 180.0 / math.pi
_COUNT_LOCK = threading.Lock()
THREADS = 128  # csrc/scalar_maps.cu: THREADS, threads per block


def scalar_maps_plan(nvox: int) -> int:
    """The blocks of a launch on ``nvox`` voxels, one voxel a thread:
    every voxel once, as :func:`plan_voxels` lists them."""
    if nvox < 1:
        raise ValueError(f"scalar_maps: {nvox} voxels")
    return -(-nvox // THREADS)


def plan_voxels(blocks: int) -> torch.Tensor:
    """The voxel the kernel gives (block, thread), as a (blocks, THREADS)
    index: block·THREADS + thread, a coalesced run across the warp.
    Indices ≥ V are computed on voxel V - 1 and not stored."""
    return torch.arange(blocks)[:, None] * THREADS + torch.arange(THREADS)


def scalar_maps_plain(d6: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """All DT scalar maps of a channels-last ``(..., 6)`` tensor volume
    ordered (dxx, dxy, dxz, dyy, dyz, dzz), as (fa, md, ad, rd, azimuth,
    inclination, rgb):
      AD = λ2, RD = (λ0 + λ1)/2, MD = (λ0 + λ1 + λ2)/3,
      FA = sqrt(1.5)·‖λ − MD‖/‖λ‖ (0 where ‖λ‖ = 0),
      azimuth = atan2(v2_y, v2_x), inclination = acos(clip(v2_z/‖v2‖)) in
      degrees, RGB = FA·|v2| for the principal eigenvector v2."""
    w, v = eigh3x3_from_lower6(d6)
    lam0, lam1, lam2 = w[..., 0], w[..., 1], w[..., 2]
    ad = lam2
    rd = (lam0 + lam1) / 2.0
    # IEEE division (see ops/eig3.py): by a tensor, not a Python scalar
    md = (lam0 + lam1 + lam2) / lam0.new_tensor(3.0)
    var = sqrt_rn((lam0 - md) ** 2 + (lam1 - md) ** 2 + (lam2 - md) ** 2)
    norm = sqrt_rn(lam0 * lam0 + lam1 * lam1 + lam2 * lam2)
    fa = math.sqrt(1.5) * var / torch.where(norm == 0, 1.0, norm)

    vx, vy, vz = v[..., 0, 2], v[..., 1, 2], v[..., 2, 2]
    azimuth = RAD2DEG * torch.atan2(vy, vx)
    r = sqrt_rn(vx * vx + vy * vy + vz * vz)
    inclination = RAD2DEG * torch.acos(
        torch.clamp(vz / torch.where(r == 0, 1.0, r), -1.0, 1.0))
    rgb = fa[..., None] * torch.abs(v[..., :, 2])
    return fa, md, ad, rd, azimuth, inclination, rgb


def scalar_maps(d6: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``S + (6,)`` → (fa, md, ad, rd, azimuth, inclination) each ``S`` and
    rgb ``S + (3,)``, f32. A CPU tensor takes the plain version; a CUDA
    tensor (any float type, cast to f32 as the TPU kernel casts) launches
    the kernel on the calling thread's current stream, or raises."""
    if d6.device.type == "cpu":
        return scalar_maps_plain(d6)
    if d6.device.type != "cuda":
        raise ValueError(f"scalar_maps: unsupported device {d6.device}")
    if d6.shape[-1] != 6 or not d6.is_floating_point():
        raise ValueError(f"scalar_maps: expected a float (..., 6) tensor, got "
                         f"{d6.dtype} {tuple(d6.shape)}")
    shape = tuple(d6.shape[:-1])
    x = d6.to(torch.float32).contiguous()
    if x.data_ptr() % 8:  # the kernel reads each voxel as three float2
        x = x.clone()
    nvox = x.numel() // 6
    planes = torch.empty((6, nvox), dtype=torch.float32, device=x.device)
    rgb = torch.empty((nvox, 3), dtype=torch.float32, device=x.device)
    if nvox:
        lib = _lib()
        rc = _build.launch(lib.scalar_maps, x, x.data_ptr(), planes.data_ptr(),
                           rgb.data_ptr(), nvox, scalar_maps_plan(nvox))
        _build.check(lib, rc, "scalar_maps")
        with _COUNT_LOCK:  # the eval chain launches from several threads
            scalar_maps.launches += 1
    return planes.view((6,) + shape).unbind(0) + (rgb.view(shape + (3,)),)


scalar_maps.launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("scalar_maps")
    if not getattr(lib, "_typed", False):
        lib.scalar_maps.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
        lib.scalar_maps.restype = ctypes.c_int
        lib._typed = True
    return lib
