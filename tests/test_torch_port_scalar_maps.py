"""The port's eigendecomposition and scalar maps (``ops/eig3.py`` and
``ops/kernels/scalar_maps.py::scalar_maps_plain``: K8's plain version, the
CPU path of ``ops/scalar_maps.py::compute_scalar_maps``) against the JAX
package's, on the CPU.

Tolerances. Both sides run the same cyclic Jacobi in f32 but round at other
places (XLA fuses and may contract a·b + c). Each result is the exact one of
a matrix within 64 roundings (u = 2^-24) of entries ≤ s = max|A|, so two
results differ by at most e = 2·64·u·s in each eigenvalue (Weyl) and by
θ = e/gap radians in an eigenvector whose eigenvalue is ``gap`` from the
others (Davis–Kahan); ``compare_scalar_maps`` carries these bounds into every
map (derivation beside it in ``ops/scalar_maps_check.py``).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_bssfp_tpu.ops.eig3 import eigh3x3_sym as jax_eigh3x3_sym
from unet_bssfp_tpu.ops.pallas.scalar_maps_kernel import compute_scalar_maps_fused
from unet_bssfp_tpu.ops.scalar_maps import compute_scalar_maps as jax_compute_scalar_maps
from unet_bssfp_tpu.ops.scalar_maps import invert_dwi_tensor_norm as jax_invert
from unet_bssfp_tpu.ops.scalar_maps import load_rescale_args as jax_load_rescale_args
from unet_bssfp_tpu_torch.ops.eig3 import eigh3x3_from_lower6, eigh3x3_sym
from unet_bssfp_tpu_torch.ops.kernels import scalar_maps
from unet_bssfp_tpu_torch.ops.scalar_maps import (
    ScalarMaps,
    compute_scalar_maps,
    invert_dwi_tensor_norm,
    load_rescale_args,
)
from unet_bssfp_tpu_torch.ops.scalar_maps_check import (
    ROUNDINGS,
    compare_scalar_maps,
    sample_dt_volume,
)

torch.set_num_threads(1)
U = 2.0 ** -24
REPO_CONSTANTS = Path(__file__).resolve().parents[1] / "constants"


def _lower6(mats: np.ndarray) -> np.ndarray:
    return mats[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]].astype(np.float32)


def _rotated(rng, lam: np.ndarray) -> np.ndarray:
    q, _ = np.linalg.qr(rng.standard_normal((len(lam), 3, 3)))
    return _lower6(np.einsum("nij,nj,nkj->nik", q, lam, q))


def _eig_cases():
    rng = np.random.default_rng(11)
    n = 256
    a = rng.uniform(0.1, 2.0, n)
    b = a + rng.uniform(0.5, 1.0, n)
    return {
        "random": rng.standard_normal((n, 6)).astype(np.float32),
        "diagonal": np.stack([rng.standard_normal(n), np.zeros(n), np.zeros(n),
                              rng.standard_normal(n), np.zeros(n),
                              rng.standard_normal(n)], -1).astype(np.float32),
        "repeated_low": _rotated(rng, np.stack([a, a, b], -1)),
        "repeated_high": _rotated(rng, np.stack([a, b, b], -1)),
        "isotropic": _rotated(rng, np.stack([a, a, a], -1)),
        "zero": np.zeros((n, 6), np.float32),
        "scale_1e-3": 1e-3 * rng.standard_normal((n, 6)).astype(np.float32),
        "scale_1e3": 1e3 * rng.standard_normal((n, 6)).astype(np.float32),
    }


EIG_CASES = _eig_cases()


@pytest.mark.parametrize("case", sorted(EIG_CASES))
def test_eigh3x3_sym_matches_jax(case):
    d6 = EIG_CASES[case]
    jw, jv = jax_eigh3x3_sym(*(jnp.asarray(d6[:, i]) for i in range(6)))
    jw, jv = np.asarray(jw, np.float64), np.asarray(jv, np.float64)
    w, v = eigh3x3_sym(*(torch.from_numpy(d6[:, i]) for i in range(6)))
    w, v = w.double().numpy(), v.double().numpy()
    s = np.abs(d6).max(-1).astype(np.float64)
    e = 2 * ROUNDINGS * U * s
    # eigenvalues: Weyl
    assert np.all(np.abs(w - jw) <= e[:, None]), np.abs(w - jw).max()
    # each eigenvector whose eigenvalue stands apart: Davis–Kahan, compared
    # as the sine of the angle between the two (sign-free; |v × v'|, which
    # has no cancellation) and, where the lead component is unambiguous,
    # entry by entry with the sign; 8u covers the f32 vectors' own norms
    for k in range(3):
        others = [j for j in range(3) if j != k]
        gap = np.min(np.abs(jw[:, others] - jw[:, k:k + 1]), axis=-1)
        theta = e / np.maximum(gap, 1e-300)
        sep = gap >= 1e-2 * np.abs(jw).max(-1)
        sin = np.linalg.norm(np.cross(v[:, :, k], jv[:, :, k]), axis=-1)
        assert np.all(sin[sep] <= theta[sep] + 8 * U), case
        top2 = np.sort(np.abs(jv[:, :, k]), -1)
        lead_ok = sep & (top2[:, 2] - top2[:, 1] > 2 * theta)
        diff = np.abs(v[:, :, k] - jv[:, :, k]).max(-1)
        assert np.all(diff[lead_ok] <= theta[lead_ok] + 8 * U), case
    # the port's own result is an orthonormal eigenbasis of A: within the
    # same 64 roundings
    a = np.zeros((len(d6), 3, 3))
    for idx, (i, j) in enumerate(((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))):
        a[:, i, j] = a[:, j, i] = d6[:, idx]
    recon = np.einsum("nik,nk,njk->nij", v, w, v)
    assert np.all(np.abs(recon - a).max((-2, -1)) <= 3 * e + 1e-300)
    ortho = np.einsum("nki,nkj->nij", v, v) - np.eye(3)
    assert np.abs(ortho).max() <= 2 * ROUNDINGS * U
    assert np.all(np.diff(w, axis=-1) >= 0)  # ascending


def test_eigh3x3_exact_cases():
    """Zero → λ = 0 and V = I; a diagonal matrix → its sorted diagonal and a
    permutation, bit for bit, on both sides (no rotation is applied)."""
    d6 = np.array([[0, 0, 0, 0, 0, 0], [3, 0, 0, 1, 0, 2], [2, 0, 0, 2, 0, 2]],
                  np.float32)
    w, v = eigh3x3_from_lower6(torch.from_numpy(d6))
    np.testing.assert_array_equal(w.numpy(), [[0, 0, 0], [1, 2, 3], [2, 2, 2]])
    np.testing.assert_array_equal(v[0].numpy(), np.eye(3))
    np.testing.assert_array_equal(v[1].numpy(), np.eye(3)[:, [1, 2, 0]])
    np.testing.assert_array_equal(v[2].numpy(), np.eye(3))  # ties never swap
    jw, jv = jax_eigh3x3_sym(*(jnp.asarray(d6[:, i]) for i in range(6)))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def _jax_maps(fn, d6: np.ndarray, **kw):
    return tuple(torch.from_numpy(np.array(x)) for x in fn(jnp.asarray(d6), **kw))


# (inputs, the largest share of voxels whose angles/RGB may be left out)
MAP_INPUTS = {
    # the JAX kernel test's input: every voxel anisotropic
    "normal_8x12x16": (lambda: (np.random.default_rng(42).standard_normal(
        (8, 12, 16, 6)) * 1e-3).astype(np.float32), 0.02),
    # brain-like: 10 % isotropic, 5 % planar by construction
    "brain_16x16x16": (lambda: sample_dt_volume((16, 16, 16), 1), 0.2),
    "brain_odd_5x7x3": (lambda: sample_dt_volume((5, 7, 3), 2), 0.3),
}


@pytest.mark.parametrize("name", sorted(MAP_INPUTS))
def test_compute_scalar_maps_matches_jax(name):
    make, max_gated = MAP_INPUTS[name]
    d6 = make()
    got = compute_scalar_maps(torch.from_numpy(d6))
    assert isinstance(got, ScalarMaps)
    assert got.fa.shape == d6.shape[:-1] and got.rgb.shape == d6.shape[:-1] + (3,)
    assert all(f.dtype == torch.float32 for f in got)
    # the K8 wrapper's CPU path is the plain version
    assert all(torch.equal(a, b) for a, b in zip(got, scalar_maps(torch.from_numpy(d6))))
    res = compare_scalar_maps(got, _jax_maps(jax_compute_scalar_maps, d6),
                              torch.from_numpy(d6))
    assert res["ok"], res
    assert res["gated_out"] <= max_gated * res["voxels"], res


@pytest.mark.parametrize("name", sorted(MAP_INPUTS))
def test_compute_scalar_maps_matches_jax_kernel_interpret(name):
    """Against K8 itself (``scalar_maps_planar`` in interpret mode): its
    polynomial atan2 adds up to ~6e-4° (``scalar_maps_kernel.py:42-45``),
    so the angles get the JAX kernel test's 2e-3° on top of the bound."""
    make, max_gated = MAP_INPUTS[name]
    d6 = make()
    ref = _jax_maps(compute_scalar_maps_fused, d6, interpret=True)
    res = compare_scalar_maps(compute_scalar_maps(torch.from_numpy(d6)), ref,
                              torch.from_numpy(d6), angle_atol=2e-3)
    assert res["ok"], res
    assert res["gated_out"] <= max_gated * res["voxels"], res


def test_zero_voxels_give_exact_zeros():
    d6 = sample_dt_volume((6, 8, 10), 3)
    zero = np.all(d6 == 0, -1)
    assert 0.2 < zero.mean() < 0.4
    got = compute_scalar_maps(torch.from_numpy(d6))
    ref = _jax_maps(jax_compute_scalar_maps, d6)
    for name, g, r in zip(ScalarMaps._fields, got, ref):
        assert torch.all(g[torch.from_numpy(zero)] == 0), name
        assert torch.all(r[torch.from_numpy(zero)] == 0), name


def test_load_rescale_args_both_layouts(tmp_path):
    for fn in ("rescale_args_dwi.txt", "rescale_args_bssfp.txt", "rescale_args_t1w.txt"):
        path = str(REPO_CONSTANTS / fn)
        got = load_rescale_args(path)
        np.testing.assert_array_equal(got, jax_load_rescale_args(path))
        assert got.ndim == 2 and got.shape[1] == 2
    assert load_rescale_args(str(REPO_CONSTANTS / "rescale_args_dwi.txt")).shape == (6, 2)
    odd = tmp_path / "odd.txt"
    odd.write_text("1\n2\n3\n")
    with pytest.raises(ValueError, match="odd number"):
        load_rescale_args(str(odd))


@pytest.mark.parametrize("layout", ["per_channel", "broadcast"])
def test_invert_dwi_tensor_norm_matches_jax(layout):
    rng = np.random.default_rng(5)
    x = rng.random((4, 5, 6, 6)).astype(np.float32)
    minmax = load_rescale_args(str(REPO_CONSTANTS / "rescale_args_dwi.txt"))
    if layout == "broadcast":
        minmax = minmax[:1]
    got = invert_dwi_tensor_norm(torch.from_numpy(x), minmax).numpy()
    ref = np.asarray(jax_invert(jnp.asarray(x), minmax))
    mm = np.asarray(minmax, np.float32)
    a, b = np.abs(mm[:, 1] - mm[:, 0]), mm[:, 0]
    # x·a + b: XLA may fuse it into one FMA (one rounding fewer), so the two
    # differ by at most the product's and the sum's roundings
    tol = 2 * U * (np.abs(x) * a + np.abs(b))
    assert np.all(np.abs(got - ref) <= tol)
    np.testing.assert_allclose(got, x * a + b, rtol=0, atol=float(tol.max()))
