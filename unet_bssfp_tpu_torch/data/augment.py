"""The training augmentation chain on the card (counterpart of
``unet_bssfp_tpu/data/augment.py``).

The reference's TorchIO chain (``src/data_module.py:130-139``): RandomMotion,
RandomGhosting, RandomSpike(0.01-0.1), RandomBiasField, RandomBlur(0.01-0.1),
RandomNoise(0.01-0.1), RandomGamma, each with p = 0.1, and ``keep={'dwi-tensor':
'dwi-tensor_orig'}`` (:func:`augment_subject`). Volumes are channels-last
``(D, H, W, C)``; the k-space transforms use ``torch.fft``, the rotation a
trilinear gather, the rest elementwise ops, on the volume's device. The JAX
package has no Pallas kernel here, so neither has the port.

Every transform is split into a *draw* and an *apply*:

- ``draw_<name>(generator, ...)`` takes a CPU ``torch.Generator`` and returns
  the transform's parameters as host numbers (noise: its std and the seed of
  its field; gamma: g; blur: three stds; bias field: the 20 coefficients of
  order 3; spike: positions and r; ghosting: axis, n and intensity; motion:
  angles and shifts of each of its transforms);
- ``apply_<name>(vol, ...)`` is a deterministic function of the volume and
  those parameters, on the volume's device.

So the gates and parameters cost the card no synchronisation, only the taken
transforms run there (the JAX package gates with ``lax.cond`` for the same
reason), and the tests hold each apply to the JAX transform on the
parameters JAX's own key splits draw. Per-voxel noise comes from a generator
on the volume's device, seeded from the host generator.

Fidelity points kept from the JAX package: ``_fft3`` casts to complex64 and
``_ifft3`` takes the real part; the spike adds peak·r at one (d, h, w) on
every channel; ghosting spares plane 0; motion's k-space segments run along
axis 0 with ``seg_len = d // (T + 1)``, its translation ramp uses
``fftfreq`` in f32; :func:`rotate_trilinear` clamps at the edges and maps
sources through ``coords @ R``; blur is 5 taps with edge padding and
σ ≥ 1e-3; gamma is sign·|x|^g.

Host-side constants (the rotation matrix, blur taps, linspaces, fftfreqs)
are computed on the CPU and moved to the volume's device, so an apply on the
card and on the CPU do the same elementwise arithmetic; they differ only
where the libraries do (exp, pow, cos, sin, the FFT).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

_F32 = torch.float32


def _uniform(generator: torch.Generator, lo: float, hi: float, shape=()) -> torch.Tensor:
    """U[lo, hi) in f32 on the CPU."""
    u = torch.rand(shape, generator=generator, dtype=_F32)
    return lo + (hi - lo) * u


def _seed(generator: torch.Generator) -> int:
    return int(torch.randint(0, 2 ** 62, (), generator=generator))


# --------------------------------------------------------------------------
# intensity transforms
# --------------------------------------------------------------------------

def draw_noise(generator: torch.Generator, std_range=(0.01, 0.1)) -> Dict:
    """std ~ U(std_range) and the seed of the noise field."""
    return {"std": float(_uniform(generator, *std_range)), "seed": _seed(generator)}


def noise_field(seed: int, vol: torch.Tensor) -> torch.Tensor:
    """Standard normal noise of ``vol``'s shape, from a generator on
    ``vol``'s device seeded with ``seed``."""
    gen = torch.Generator(device=vol.device).manual_seed(seed)
    return torch.randn(vol.shape, generator=gen, device=vol.device, dtype=vol.dtype)


def apply_noise(vol: torch.Tensor, std: float, field: torch.Tensor,
                mean: float = 0.0) -> torch.Tensor:
    """Additive gaussian noise (tio ``RandomNoise``): vol + mean + std·field."""
    return vol + mean + std * field


def random_noise(generator: torch.Generator, vol: torch.Tensor, std_range=(0.01, 0.1),
                 mean: float = 0.0) -> torch.Tensor:
    p = draw_noise(generator, std_range)
    return apply_noise(vol, p["std"], noise_field(p["seed"], vol), mean)


def draw_gamma(generator: torch.Generator, log_gamma=(-0.3, 0.3)) -> Dict:
    """g = exp(U(log_gamma)) (tio ``RandomGamma`` defaults)."""
    return {"g": float(torch.exp(_uniform(generator, *log_gamma)))}


def apply_gamma(vol: torch.Tensor, g: float) -> torch.Tensor:
    """sign(x)·|x|^g: values in [0, 1] stay there, order is kept."""
    return torch.sign(vol) * torch.pow(torch.abs(vol), g)


def random_gamma(generator: torch.Generator, vol: torch.Tensor,
                 log_gamma=(-0.3, 0.3)) -> torch.Tensor:
    return apply_gamma(vol, **draw_gamma(generator, log_gamma))


def draw_blur(generator: torch.Generator, std_range=(0.01, 0.1)) -> Dict:
    """Per-axis std ~ U(std_range) voxels (tio ``RandomBlur``)."""
    return {"stds": _uniform(generator, *std_range, (3,)).tolist()}


def _blur_taps(std: float) -> List[float]:
    """The normalised 5-tap gaussian of ``std`` (σ ≥ 1e-3), in f32."""
    taps = torch.arange(-2.0, 3.0, dtype=_F32)
    sigma = torch.clamp(torch.tensor(std, dtype=_F32), min=1e-3)
    k = torch.exp(-(taps ** 2) / (2.0 * sigma ** 2))
    return (k / torch.sum(k)).tolist()


def apply_blur(vol: torch.Tensor, stds: Sequence[float]) -> torch.Tensor:
    """Separable 5-tap gaussian blur along each spatial axis with edge
    padding (one voxel either side repeated twice)."""
    out = vol
    for ax in range(3):
        k = _blur_taps(stds[ax])
        n = out.shape[ax]
        first, last = out.narrow(ax, 0, 1), out.narrow(ax, n - 1, 1)
        padded = torch.cat([first, first, out, last, last], dim=ax)
        res = padded.narrow(ax, 0, n) * k[0]
        for i in range(1, 5):
            res = res + padded.narrow(ax, i, n) * k[i]
        out = res
    return out


def random_blur(generator: torch.Generator, vol: torch.Tensor,
                std_range=(0.01, 0.1)) -> torch.Tensor:
    return apply_blur(vol, **draw_blur(generator, std_range))


def _n_coeff(order: int) -> int:
    return sum(1 for i in range(order + 1) for j in range(order + 1 - i)
               for _ in range(order + 1 - i - j))


def draw_bias_field(generator: torch.Generator, coefficients: float = 0.5,
                    order: int = 3) -> Dict:
    """The polynomial's coefficients ~ U(-c, c) (tio ``RandomBiasField``)."""
    coeffs = _uniform(generator, -coefficients, coefficients, (_n_coeff(order),))
    return {"coeffs": coeffs.tolist(), "order": order}


def apply_bias_field(vol: torch.Tensor, coeffs: Sequence[float],
                     order: int = 3) -> torch.Tensor:
    """vol · exp(Σ c·z^i·y^j·x^k), i + j + k ≤ order, over normalised
    coordinates in [-1, 1] (Van Leemput 1999)."""
    d, h, w = vol.shape[:3]
    if len(coeffs) != _n_coeff(order):
        raise ValueError(f"bias field of order {order} takes {_n_coeff(order)} "
                         f"coefficients, got {len(coeffs)}")
    powers = [[(torch.linspace(-1.0, 1.0, n, dtype=_F32) ** e).to(vol.device)
               for e in range(order + 1)] for n in (d, h, w)]
    zs = [p.view(d, 1, 1) for p in powers[0]]
    ys = [p.view(1, h, 1) for p in powers[1]]
    xs = [p.view(1, 1, w) for p in powers[2]]
    field = torch.zeros((d, h, w), dtype=_F32, device=vol.device)
    idx = 0
    for i in range(order + 1):
        for j in range(order + 1 - i):
            for k in range(order + 1 - i - j):
                field = field + coeffs[idx] * zs[i] * ys[j] * xs[k]
                idx += 1
    return vol * torch.exp(field)[..., None]


def random_bias_field(generator: torch.Generator, vol: torch.Tensor,
                      coefficients: float = 0.5, order: int = 3) -> torch.Tensor:
    return apply_bias_field(vol, **draw_bias_field(generator, coefficients, order))


# --------------------------------------------------------------------------
# k-space transforms
# --------------------------------------------------------------------------

def _fft3(vol: torch.Tensor) -> torch.Tensor:
    return torch.fft.fftn(vol.to(torch.complex64), dim=(0, 1, 2))


def _ifft3(spec: torch.Tensor) -> torch.Tensor:
    return torch.fft.ifftn(spec, dim=(0, 1, 2)).real


def draw_spike(generator: torch.Generator, spatial_shape: Sequence[int],
               intensity=(0.01, 0.1), num_spikes: int = 1) -> Dict:
    """Spike positions (uniform over k-space) and r ~ U(intensity) (tio
    ``RandomSpike``)."""
    dims = torch.tensor(list(spatial_shape[:3]), dtype=_F32)
    pos = torch.floor(torch.rand((num_spikes, 3), generator=generator, dtype=_F32) * dims)
    r = float(_uniform(generator, *intensity))
    return {"positions": pos.to(torch.int64).tolist(), "r": r}


def apply_spike(vol: torch.Tensor, positions: Sequence[Sequence[int]], r: float) -> torch.Tensor:
    """Add r·max|spectrum| at each k-space position, on every channel."""
    spec = _fft3(vol)
    peak = torch.amax(torch.abs(spec))
    for z, y, x in positions:
        spec[z, y, x] = spec[z, y, x] + peak * r
    return _ifft3(spec)


def random_spike(generator: torch.Generator, vol: torch.Tensor, intensity=(0.01, 0.1),
                 num_spikes: int = 1) -> torch.Tensor:
    return apply_spike(vol, **draw_spike(generator, vol.shape, intensity, num_spikes))


def draw_ghosting(generator: torch.Generator, num_ghosts=(4, 10), intensity=(0.5, 1.0)) -> Dict:
    """A phase-encode axis, every n-th plane and the attenuation (tio
    ``RandomGhosting`` defaults)."""
    axis = int(torch.randint(0, 3, (), generator=generator))
    n = int(torch.randint(num_ghosts[0], num_ghosts[1] + 1, (), generator=generator))
    return {"axis": axis, "n": n, "intensity": float(_uniform(generator, *intensity))}


def apply_ghosting(vol: torch.Tensor, axis: int, n: int, intensity: float) -> torch.Tensor:
    """Scale every n-th k-space plane along ``axis`` by 1 − intensity,
    sparing plane 0 (the k-space centre)."""
    spec = _fft3(vol)
    length = spec.shape[axis]
    ids = torch.arange(length)
    ghost = (ids % n == 0) & (ids != 0)
    scale = torch.where(ghost, torch.tensor(1.0, dtype=_F32) - intensity,
                        torch.tensor(1.0, dtype=_F32))
    shape = [1, 1, 1, 1]
    shape[axis] = length
    return _ifft3(spec * scale.view(shape).to(spec.device))


def random_ghosting(generator: torch.Generator, vol: torch.Tensor, num_ghosts=(4, 10),
                    intensity=(0.5, 1.0)) -> torch.Tensor:
    return apply_ghosting(vol, **draw_ghosting(generator, num_ghosts, intensity))


def _euler_matrix(angles) -> torch.Tensor:
    """f32 rotation matrix from Euler angles (radians) about the volume axes,
    Rz·Ry·Rx (SimpleITK's Euler3D, as TorchIO uses it), on the CPU."""
    a = torch.as_tensor(angles, dtype=_F32).cpu()
    cz, sz = torch.cos(a[0]), torch.sin(a[0])
    cy, sy = torch.cos(a[1]), torch.sin(a[1])
    cx, sx = torch.cos(a[2]), torch.sin(a[2])
    one, zero = torch.tensor(1.0), torch.tensor(0.0)
    rz = torch.stack([torch.stack([one, zero, zero]), torch.stack([zero, cz, -sz]),
                      torch.stack([zero, sz, cz])])
    ry = torch.stack([torch.stack([cy, zero, sy]), torch.stack([zero, one, zero]),
                      torch.stack([-sy, zero, cy])])
    rx = torch.stack([torch.stack([cx, -sx, zero]), torch.stack([sx, cx, zero]),
                      torch.stack([zero, zero, one])])
    return rz @ ry @ rx


def rotate_trilinear(vol: torch.Tensor, angles) -> torch.Tensor:
    """Rigid rotation of a ``(D, H, W, C)`` volume about its centre:
    source = (target − c) @ R + c (R orthonormal, so Rᵀ maps back),
    trilinear weights, sources clamped to the edge voxels. The product is
    written out per coordinate, so the card and the CPU compute the same
    sources."""
    d, h, w = vol.shape[:3]
    r = _euler_matrix(angles).tolist()
    dev = vol.device
    centre = [(n - 1.0) / 2.0 for n in (d, h, w)]
    zz = (torch.arange(d, dtype=_F32) - centre[0]).to(dev).view(d, 1, 1)
    yy = (torch.arange(h, dtype=_F32) - centre[1]).to(dev).view(1, h, 1)
    xx = (torch.arange(w, dtype=_F32) - centre[2]).to(dev).view(1, 1, w)
    los, fracs = [], []
    for k in range(3):
        src = zz * r[0][k] + yy * r[1][k] + xx * r[2][k] + centre[k]
        lo = torch.floor(src)
        los.append(lo.to(torch.int64))
        fracs.append(src - lo)
    flat = vol.reshape(d * h * w, vol.shape[3])
    out = torch.zeros_like(vol)
    for dz in (0, 1):
        zi = torch.clamp(los[0] + dz, 0, d - 1)
        wz = fracs[0] if dz else 1.0 - fracs[0]
        for dy in (0, 1):
            yi = torch.clamp(los[1] + dy, 0, h - 1)
            wy = fracs[1] if dy else 1.0 - fracs[1]
            for dx in (0, 1):
                xi = torch.clamp(los[2] + dx, 0, w - 1)
                wx = fracs[2] if dx else 1.0 - fracs[2]
                idx = (zi * h + yi) * w + xi
                out = out + (wz * wy * wx)[..., None] * flat[idx]
    return out


def draw_motion(generator: torch.Generator, degrees: float = 10.0,
                translation: float = 10.0, num_transforms: int = 2) -> Dict:
    """Per transform: Euler angles ~ U(±degrees) in radians and a shift ~
    U(±translation) voxels (tio ``RandomMotion``)."""
    lim = degrees * math.pi / 180.0
    angles, shifts = [], []
    for _ in range(num_transforms):
        angles.append(_uniform(generator, -lim, lim, (3,)).tolist())
        shifts.append(_uniform(generator, -translation, translation, (3,)).tolist())
    return {"angles": angles, "shifts": shifts}


def apply_motion(vol: torch.Tensor, angles: Sequence[Sequence[float]],
                 shifts: Sequence[Sequence[float]]) -> torch.Tensor:
    """Compose the k-spaces of the volume and its rigidly moved copies: the
    k-space planes along axis 0 split into T + 1 segments of ``d // (T +
    1)`` (the last runs to the end); segment t + 1 onwards takes copy t,
    rotated by trilinear resampling and shifted exactly by a phase ramp."""
    d, h, w = vol.shape[:3]
    dev = vol.device
    fz = torch.fft.fftfreq(d, dtype=_F32).to(dev).view(d, 1, 1, 1)
    fy = torch.fft.fftfreq(h, dtype=_F32).to(dev).view(1, h, 1, 1)
    fx = torch.fft.fftfreq(w, dtype=_F32).to(dev).view(1, 1, w, 1)
    spec = _fft3(vol)
    seg_len = d // (len(angles) + 1)
    for t, (ang, shift) in enumerate(zip(angles, shifts)):
        start = (t + 1) * seg_len
        spec_t = _fft3(rotate_trilinear(vol, ang))[start:]
        phase = -2.0 * math.pi * (fz[start:] * shift[0] + fy * shift[1] + fx * shift[2])
        spec[start:] = spec_t * torch.complex(torch.cos(phase), torch.sin(phase))
    return _ifft3(spec)


def random_motion(generator: torch.Generator, vol: torch.Tensor, degrees: float = 10.0,
                  translation: float = 10.0, num_transforms: int = 2) -> torch.Tensor:
    return apply_motion(vol, **draw_motion(generator, degrees, translation, num_transforms))


# --------------------------------------------------------------------------
# the chain and subject-level augmentation
# --------------------------------------------------------------------------

def _apply_noise_seeded(vol: torch.Tensor, std: float, seed: int) -> torch.Tensor:
    return apply_noise(vol, std, noise_field(seed, vol))


# (name, draw(generator, spatial_shape) → params, apply(vol, **params)), in
# the reference's order
CHAIN: Tuple[Tuple[str, Callable, Callable], ...] = (
    ("motion", lambda g, s: draw_motion(g), apply_motion),
    ("ghosting", lambda g, s: draw_ghosting(g), apply_ghosting),
    ("spike", lambda g, s: draw_spike(g, s), apply_spike),
    ("bias_field", lambda g, s: draw_bias_field(g), apply_bias_field),
    ("blur", lambda g, s: draw_blur(g), apply_blur),
    ("noise", lambda g, s: draw_noise(g), _apply_noise_seeded),
    ("gamma", lambda g, s: draw_gamma(g), apply_gamma),
)
_APPLY = {name: apply for name, _, apply in CHAIN}


def draw_chain(generator: torch.Generator, spatial_shape: Sequence[int],
               prob: float = 0.1) -> List[Tuple[str, Dict]]:
    """Gate each transform of the chain with probability ``prob`` and draw
    the parameters of the taken ones, all from the host ``generator``."""
    taken = []
    for name, draw, _ in CHAIN:
        if float(torch.rand((), generator=generator)) < prob:
            taken.append((name, draw(generator, spatial_shape)))
    return taken


def apply_chain(vol: torch.Tensor, draws: Sequence[Tuple[str, Dict]]) -> torch.Tensor:
    """Run the drawn transforms in order on ``vol``'s device."""
    for name, params in draws:
        vol = _APPLY[name](vol, **params)
    return vol


def augment_volume(generator: torch.Generator, vol: torch.Tensor,
                   prob: float = 0.1) -> torch.Tensor:
    """The 7-transform chain, each gated with probability ``prob``
    (reference: each p = 0.1, ``src/data_module.py:130-139``); only the
    taken transforms run."""
    return apply_chain(vol, draw_chain(generator, vol.shape[:3], prob))


def augment_subject(generator: torch.Generator, subject: Dict[str, torch.Tensor],
                    prob: float = 0.1,
                    keep: Optional[Dict[str, str]] = None) -> Dict[str, torch.Tensor]:
    """Subject-level augmentation: one draw of gates and parameters for the
    subject, applied to every image (TorchIO subject semantics; the noise
    field is made anew from one seed for each image's shape), and ``keep``
    keeps pristine copies under new keys — by default the un-augmented DT
    target as ``dwi-tensor_orig`` (``src/data_module.py:139``). The images
    must share one spatial shape."""
    keep = keep or {"dwi-tensor": "dwi-tensor_orig"}
    shapes = {tuple(v.shape[:3]) for v in subject.values()}
    if len(shapes) > 1:
        raise ValueError(f"augment_subject: images of different spatial shapes {shapes}")
    draws = draw_chain(generator, next(iter(shapes)) if shapes else (1, 1, 1), prob)
    out = {dst: subject[src] for src, dst in keep.items() if src in subject}
    for name, vol in subject.items():
        out[name] = apply_chain(vol, draws)
    return out
