"""ctypes binding of the port's native NIfTI codec (``nifti_native.cpp``;
the port's own copy of ``unet_bssfp_tpu/native``).

The library is built at first use (``g++ -O3 -shared -fPIC
-ffp-contract=off … -lz``) into ``unet_bssfp_tpu_torch/_build/``, named by a
hash of the source and the flags, never next to the source. ctypes foreign
calls release the GIL, so the threads of ``data.queue.parallel_map``
decompress concurrently: the native replacement for the reference's
8-process TorchIO loader fan-out (``src/data_module.py:152-166``). Where no
compiler or zlib is found, :func:`is_available` is False and
``data.nifti`` keeps to its pure-Python codec.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "nifti_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ("-O3", "-shared", "-fPIC", "-ffp-contract=off")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _target() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libnifti_native-{digest[:16]}.so"


def _build(out: Path) -> bool:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run([cxx, *FLAGS, str(_SRC), "-o", str(tmp), "-lz"], check=True,
                       capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)  # atomic: another process may build the same name
    return True


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None where it cannot be."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        out = _target()
        if not out.exists() and not _build(out):
            return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError:
            return None
        lib.nifti_read_f32.restype = ctypes.c_int64
        lib.nifti_read_f32.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double)]
        lib.nifti_read_header.restype = ctypes.c_int
        lib.nifti_read_header.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int)]
        lib.nifti_write_f32.restype = ctypes.c_int
        lib.nifti_write_f32.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double)]
        _lib = lib
        return _lib


def is_available() -> bool:
    return _load() is not None


def _affine_from_srow(srow: np.ndarray) -> np.ndarray:
    affine = np.eye(4)
    if np.any(srow):
        affine[:3, :] = srow.reshape(3, 4)
    return affine


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native NIfTI codec unavailable (no C++ compiler or zlib)")
    return lib


def read_header(path: str) -> Tuple[Tuple[int, ...], np.ndarray]:
    """(shape, (4, 4) affine) of a little-endian NIfTI-1 file; raises
    OSError where the header cannot be read."""
    lib = _require()
    dims = (ctypes.c_int64 * 8)()
    srow = (ctypes.c_double * 12)()
    datatype = ctypes.c_int()
    rc = lib.nifti_read_header(os.fsencode(path), dims, srow, ctypes.byref(datatype))
    if rc != 0:
        raise OSError(f"nifti_read_header({path!r}) failed: {rc}")
    ndim = int(dims[0])
    shape = tuple(int(dims[i]) for i in range(1, ndim + 1)) if 1 <= ndim <= 7 else ()
    if not shape or min(shape) < 1:
        raise OSError(f"{path!r}: NIfTI dims {list(dims)} hold no volume")
    return shape, _affine_from_srow(np.asarray(srow))


def read_volume(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read a NIfTI file natively → (float32 array in the file's shape,
    (4, 4) affine); raises OSError on what the codec does not read (a
    big-endian file, an unknown datatype, a short file)."""
    lib = _require()
    shape, _ = read_header(path)
    count = int(np.prod(shape))
    out = np.empty(count, np.float32)
    dims = (ctypes.c_int64 * 8)()
    srow = (ctypes.c_double * 12)()
    n = lib.nifti_read_f32(os.fsencode(path),
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                           count, dims, srow)
    if n < 0:
        raise OSError(f"nifti_read_f32({path!r}) failed: {n}")
    if n != count:
        raise OSError(f"nifti_read_f32({path!r}): {n} voxels for {count}")
    return out.reshape(shape, order="F"), _affine_from_srow(np.asarray(srow))


def write_volume(path: str, data: np.ndarray, affine: np.ndarray) -> None:
    """Write ``data`` as float32 NIfTI-1 (gzip level 1 for ``.gz``)."""
    lib = _require()
    data = np.asfortranarray(data, np.float32)
    if not 1 <= data.ndim <= 7:
        raise ValueError(f"NIfTI takes 1 to 7 dims, got {data.shape}")
    dims = (ctypes.c_int64 * 8)()
    dims[0] = data.ndim
    for i, s in enumerate(data.shape, 1):
        dims[i] = s
    aff = np.ascontiguousarray(np.asarray(affine, np.float64)[:3, :]).ravel()
    flat = data.ravel(order="F")
    rc = lib.nifti_write_f32(os.fsencode(path),
                             flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), dims,
                             aff.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc != 0:
        raise OSError(f"nifti_write_f32({path!r}) failed: {rc}")
