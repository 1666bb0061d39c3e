"""NIfTI-1 codec, channels-last (the port's counterpart of
``unet_bssfp_tpu/data/nifti.py``): 348-byte header + raw data, plain or
gzip; float volumes with dim/affine round-trip.

Two codecs, tried in the JAX package's order: the native C++ codec
(``unet_bssfp_tpu_torch.native``: one ctypes call that releases the GIL,
built at first use) and this module's pure-Python codec, which takes
whatever the native one does not (big-endian files, a ``dtype`` other than
float32 on load, arrays other than float32 on save, no compiler). Both give
the same arrays, bit for bit, and write the same header; :func:`codec`
names the one in use.

NIfTI stores spatial-first with a trailing channel dim, which is the port's
``(D, H, W, C)`` volume layout.
"""

from __future__ import annotations

import gzip
import struct
from typing import Optional, Tuple

import numpy as np

from unet_bssfp_tpu_torch import native

_DTYPE_CODES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}
_CODES_DTYPE = {np.dtype(v): k for k, v in _DTYPE_CODES.items()}

_HDR_SIZE = 348


def _read_bytes(path: str) -> bytes:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


def _parse_header(buf: bytes):
    endian = "<"
    if struct.unpack_from("<i", buf, 0)[0] != _HDR_SIZE:
        endian = ">"
        if struct.unpack_from(">i", buf, 0)[0] != _HDR_SIZE:
            raise ValueError("not a NIfTI-1 file")
    dim = struct.unpack_from(endian + "8h", buf, 40)
    datatype = struct.unpack_from(endian + "h", buf, 70)[0]
    vox_offset = struct.unpack_from(endian + "f", buf, 108)[0]
    scl_slope = struct.unpack_from(endian + "f", buf, 112)[0]
    scl_inter = struct.unpack_from(endian + "f", buf, 116)[0]
    srow = np.array(struct.unpack_from(endian + "12f", buf, 280),
                    np.float64).reshape(3, 4)
    shape = tuple(dim[1:1 + max(dim[0], 1)])
    return endian, shape, datatype, int(vox_offset), scl_slope, scl_inter, srow


def _affine(srow: np.ndarray) -> np.ndarray:
    affine = np.eye(4)
    if np.any(srow):
        affine[:3, :] = srow
    return affine


def codec() -> str:
    """``"native"`` where the C++ codec is built and loaded, else
    ``"python"``."""
    return "native" if native.is_available() else "python"


def load_volume(path: str, dtype=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    """NIfTI file → (data ``(D, H, W, C)``, affine ``(4, 4)``); a 3-D volume
    gains a singleton channel dim. The native codec reads a float32 load;
    what it refuses falls to the pure-Python codec."""
    if np.dtype(dtype) == np.float32 and native.is_available():
        try:
            data, affine = native.read_volume(path)
        except OSError:
            pass  # e.g. a big-endian file: the Python codec reads it
        else:
            return (data[..., None] if data.ndim == 3 else data), affine
    return _python_load(path, dtype)


def _python_load(path: str, dtype=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    buf = _read_bytes(path)
    endian, shape, datatype, vox_offset, slope, inter, srow = _parse_header(buf)
    if datatype not in _DTYPE_CODES:
        raise ValueError(f"{path}: NIfTI datatype {datatype} not supported")
    np_dtype = np.dtype(_DTYPE_CODES[datatype]).newbyteorder(endian)
    count = int(np.prod(shape)) if shape else 0
    data = np.frombuffer(buf, dtype=np_dtype, count=count,
                         offset=vox_offset).reshape(shape, order="F")
    data = data.astype(dtype)
    # NIfTI-1 scaling: applied unless slope is 0/NaN; a nonzero intercept
    # matters even at slope 1.
    if not np.isnan(slope) and slope != 0.0 and (slope != 1.0 or inter != 0.0):
        data = data * slope + inter
    if data.ndim == 3:
        data = data[..., None]
    return data, _affine(srow)


def load_affine(path: str) -> np.ndarray:
    """The ``(4, 4)`` affine of a NIfTI header (no voxel decode natively)."""
    if native.is_available():
        try:
            return native.read_header(path)[1]
        except OSError:
            pass
    return _affine(_parse_header(_read_bytes(path))[6])


def save_volume(path: str, data: np.ndarray,
                affine: Optional[np.ndarray] = None) -> None:
    """Save a ``(D, H, W, C)`` (or 3-D) array; affine defaults to identity.
    A float32 array goes through the native codec; another type keeps its
    type through the pure-Python codec."""
    affine = np.eye(4) if affine is None else np.asarray(affine, np.float64)
    data = np.asarray(data)
    if data.ndim == 4 and data.shape[-1] == 1:
        data = data[..., 0]
    if data.dtype == np.float32 and native.is_available():
        native.write_volume(path, data, affine)
        return
    _python_save(path, data, affine)


def _python_save(path: str, data: np.ndarray, affine: np.ndarray) -> None:
    data = np.ascontiguousarray(data)
    if data.dtype not in _CODES_DTYPE:
        data = data.astype(np.float32)
    dim = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)

    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, _CODES_DTYPE[data.dtype])
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)  # bitpix
    struct.pack_into("<8f", hdr, 76, *([1.0] * 8))  # qfac, spacings
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
    # qform_code (252) stays 0; sform_code (254) = NIFTI_XFORM_SCANNER
    struct.pack_into("<h", hdr, 254, 1)
    struct.pack_into("<12f", hdr, 280, *affine[:3, :].astype(np.float32).ravel())
    struct.pack_into("<4s", hdr, 344, b"n+1\x00")

    payload = bytes(hdr) + b"\x00" * 4 + data.tobytes(order="F")
    if path.endswith(".gz"):
        with gzip.open(path, "wb", compresslevel=1) as f:
            f.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)
