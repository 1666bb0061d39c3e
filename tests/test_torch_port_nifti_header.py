"""The port's NIfTI writer sets the affine's code where NIfTI-1 puts it:
``qform_code`` (bytes 252-253) 0 and ``sform_code`` (bytes 254-255) 1, with
the affine in the srow fields (bytes 280-327), as the JAX package's native
codec (``unet_bssfp_tpu/native/nifti_native.cpp``) writes them."""

import gzip
import struct

import numpy as np
import pytest

from unet_bssfp_tpu_torch.data import nifti


def _header(path):
    with (gzip.open(path, "rb") if str(path).endswith(".gz") else open(path, "rb")) as f:
        return f.read(348)


@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
def test_saved_header_has_sform_code_1_and_qform_code_0(tmp_path, suffix):
    rng = np.random.default_rng(0)
    data = rng.standard_normal((4, 5, 6, 2)).astype(np.float32)
    affine = np.array([[1.5, 0, 0, -10], [0, 2.0, 0.1, 5], [0, 0, 2.5, 7], [0, 0, 0, 1]])
    path = tmp_path / f"v{suffix}"
    nifti.save_volume(str(path), data, affine)
    hdr = _header(path)
    assert struct.unpack_from("<i", hdr, 0)[0] == 348
    qform_code, sform_code = struct.unpack_from("<hh", hdr, 252)
    assert (qform_code, sform_code) == (0, 1)
    srow = np.array(struct.unpack_from("<12f", hdr, 280), np.float32).reshape(3, 4)
    np.testing.assert_array_equal(srow, affine[:3].astype(np.float32))
    np.testing.assert_allclose(nifti.load_affine(str(path)), affine, atol=1e-6)
    back, aff = nifti.load_volume(str(path))
    np.testing.assert_array_equal(back, data)

    from unet_bssfp_tpu import native
    if native.is_available():
        ref = tmp_path / f"native{suffix}"
        native.write_volume(str(ref), data, affine)
        assert _header(ref)[252:256] == hdr[252:256]
