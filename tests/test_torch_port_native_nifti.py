"""The port's native NIfTI codec (``unet_bssfp_tpu_torch.native``, built
from its own ``nifti_native.cpp`` into ``unet_bssfp_tpu_torch/_build/``)
against the port's pure-Python codec and the JAX package's pure-Python
reader (``unet_bssfp_tpu.data.nifti._builtin_load``, not its C++ library):
the same arrays and affines bit for bit, on .nii and .nii.gz, float32,
float64, int16 and uint32 data, with and without scl_slope/scl_inter, 3-D
and 4-D; the same header written; what the native codec refuses read by the
Python one."""

import gzip
import struct
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

from unet_bssfp_tpu.data import nifti as jnifti
from unet_bssfp_tpu_torch import native
from unet_bssfp_tpu_torch.data import nifti

AFFINE = np.array([[1.5, 0, 0, -10], [0, 2.0, 0.1, 5], [0, 0, 2.5, 7], [0, 0, 0, 1]])


@pytest.fixture
def lib():
    if not native.is_available():
        pytest.skip("no C++ compiler or zlib: the native codec cannot be built")
    return native


def _write(path, data, slope=1.0, inter=0.0, endian="<"):
    """A NIfTI-1 file of ``data``'s own type, with the scaling fields set."""
    hdr = bytearray(348)
    dim = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into(endian + "i", hdr, 0, 348)
    struct.pack_into(endian + "8h", hdr, 40, *dim)
    struct.pack_into(endian + "h", hdr, 70, nifti._CODES_DTYPE[data.dtype])
    struct.pack_into(endian + "h", hdr, 72, data.dtype.itemsize * 8)
    struct.pack_into(endian + "f", hdr, 108, 352.0)
    struct.pack_into(endian + "ff", hdr, 112, slope, inter)
    struct.pack_into(endian + "h", hdr, 254, 1)
    struct.pack_into(endian + "12f", hdr, 280, *AFFINE[:3].astype(np.float32).ravel())
    struct.pack_into("4s", hdr, 344, b"n+1\x00")
    payload = bytes(hdr) + b"\x00" * 4 + data.astype(data.dtype.newbyteorder(endian)).tobytes(
        order="F")
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(payload)
    return str(path)


def _data(dtype, ndim, seed=0):
    rng = np.random.default_rng(seed)
    shape = (6, 7, 5) if ndim == 3 else (6, 7, 5, 3)
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return rng.integers(max(info.min, -30000), min(info.max, 30000), shape).astype(dtype)
    return (rng.standard_normal(shape) * 100).astype(dtype)


@pytest.mark.parametrize("ext", [".nii", ".nii.gz"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int16, np.uint32])
@pytest.mark.parametrize("scaling", [(1.0, 0.0), (0.37, -12.5), (1.0, 3.0), (0.0, 5.0),
                                     (float("nan"), 1.0)])
@pytest.mark.parametrize("ndim", [3, 4])
def test_native_reads_what_the_python_readers_read(lib, tmp_path, ext, dtype, scaling, ndim):
    data = _data(dtype, ndim)
    path = _write(tmp_path / f"v{ext}", data, *scaling)
    got, aff = lib.read_volume(path)
    py, py_aff = nifti._python_load(path)
    jx, jx_aff = jnifti._builtin_load(path)
    assert got.dtype == py.dtype == np.float32
    assert got.shape == data.shape and py.shape == data.shape + (1,) * (4 - ndim)
    np.testing.assert_array_equal(got.reshape(py.shape), py)
    np.testing.assert_array_equal(got, jx)
    np.testing.assert_array_equal(aff, py_aff)
    np.testing.assert_array_equal(aff, jx_aff)
    # the module's entry point takes the native codec, and gives the same
    back, back_aff = nifti.load_volume(path)
    np.testing.assert_array_equal(back, py)
    np.testing.assert_array_equal(back_aff, py_aff)
    np.testing.assert_array_equal(nifti.load_affine(path), py_aff)


@pytest.mark.parametrize("ext", [".nii", ".nii.gz"])
@pytest.mark.parametrize("shape", [(6, 7, 5), (6, 7, 5, 3), (4, 5, 6, 24)])
def test_native_writes_what_the_python_writer_writes(lib, tmp_path, ext, shape):
    data = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    a, b = tmp_path / f"native{ext}", tmp_path / f"python{ext}"
    lib.write_volume(str(a), data, AFFINE)
    nifti._python_save(str(b), data, AFFINE)
    opener = gzip.open if ext == ".nii.gz" else open
    with opener(a, "rb") as fa, opener(b, "rb") as fb:
        raw_a, raw_b = fa.read(), fb.read()
    assert raw_a == raw_b  # header and voxels, byte for byte
    assert struct.unpack_from("<hh", raw_a, 252) == (0, 1)  # qform_code, sform_code
    for path in (a, b):
        for reader in (lib.read_volume, nifti._python_load, jnifti._builtin_load):
            got, aff = reader(str(path))
            np.testing.assert_array_equal(got.reshape(shape), data)
            np.testing.assert_allclose(aff, AFFINE, atol=1e-6)


def test_codec_names_the_native_one_and_builds_outside_the_source(lib):
    assert nifti.codec() == "native"
    built = lib._target()
    assert built.exists() and built.parent == lib.BUILD_DIR
    assert built.parent.name == "_build" and built.parent.parent.name == "unet_bssfp_tpu_torch"
    assert not list(Path(lib.__file__).parent.glob("*.so"))


def test_save_volume_routes_by_type(lib, tmp_path):
    """float32 goes through the native writer; other types keep their type
    through the Python one; a trailing singleton channel is dropped."""
    for dtype, code in ((np.float32, 16), (np.float64, 64), (np.int16, 4)):
        data = _data(dtype, 4)[..., :1]
        path = tmp_path / f"v_{np.dtype(dtype).name}.nii"
        nifti.save_volume(str(path), data, AFFINE)
        raw = path.read_bytes()
        assert struct.unpack_from("<h", raw, 70)[0] == code
        assert struct.unpack_from("<h", raw, 40)[0] == 3
        back, _ = nifti.load_volume(str(path))
        np.testing.assert_array_equal(back, data.astype(np.float32))


def test_big_endian_and_other_dtypes_fall_back_to_python(lib, tmp_path):
    data = _data(np.float32, 4)
    path = _write(tmp_path / "be.nii", data, 0.5, 1.0, endian=">")
    with pytest.raises(OSError):
        lib.read_volume(path)
    got, aff = nifti.load_volume(path)
    np.testing.assert_array_equal(got, data * np.float32(0.5) + np.float32(1.0))
    np.testing.assert_array_equal(nifti.load_affine(path), aff)
    # a float64 load is the Python codec's
    got64, _ = nifti.load_volume(path, dtype=np.float64)
    assert got64.dtype == np.float64
    with pytest.raises(FileNotFoundError):
        nifti.load_volume(str(tmp_path / "missing.nii.gz"))


def test_threaded_native_loads_equal_sequential_ones(lib, tmp_path):
    """The loader reads in threads (the codec releases the GIL): eight
    concurrent reads give the sequential arrays."""
    paths = []
    for i in range(8):
        data = np.random.default_rng(i).random((16, 16, 16, 6)).astype(np.float32)
        paths.append(str(tmp_path / f"v{i}.nii.gz"))
        nifti.save_volume(paths[-1], data)
    seq = [nifti.load_volume(p)[0] for p in paths]
    with ThreadPoolExecutor(8) as ex:
        par = list(ex.map(lambda p: nifti.load_volume(p)[0], paths))
    for a, b in zip(seq, par):
        np.testing.assert_array_equal(a, b)
