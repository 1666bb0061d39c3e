"""MedicalNet ResNet-10, the 3D feature extractor behind the reference's
perceptual loss and FID (counterpart of ``unet_bssfp_tpu/models/medicalnet.py``).

The reference takes its features from MONAI's
``medicalnet_resnet10_23datasets`` (reference ``src/model.py:127-129,
235-257``): a 7³ stride-2 stem → BatchNorm/ReLU → 3³ stride-2 max-pool →
four BasicBlocks of 64, 128 (stride 2), 256 (dilation 2) and 512 (dilation
4) channels with 1³ 'B'-type shortcuts where the width changes. The
submodules carry Med3D's torch names (``conv1``, ``bn1``,
``layer{1..4}.0.{conv1,bn1,conv2,bn2,downsample.{0,1}}``), so a converted
``.npz`` (``tools/convert_medicalnet.py``) loads by key. The net is frozen:
its parameters take no gradient and it only ever runs in eval mode.

The API speaks NDHWC, as the generator does; inside, the convs run on
NCDHW tensors (:data:`MEMORY_FORMAT`). The JAX package's TPU
lowerings of the stem, the dilated convs and the stem pool (space-to-depth,
phase split, ``pool_pair``) are exact reformulations of these same convs
and are not ported.

Without pretrained weights the net is seeded (random-feature mode): a valid
metric family, but not comparable to the reference's numbers, so the FID is
tagged ``FID_random_features``. The port's seeded draw is its own and does
not reproduce the JAX package's ``PRNGKey`` draw.
"""

from __future__ import annotations

import logging
import os
import zipfile
from typing import Any, Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from unet_bssfp_tpu_torch import weights
from unet_bssfp_tpu_torch.ops.metrics import znorm

_log = logging.getLogger(__name__)

#: The layout the convs run in: NCDHW, which cuDNN ran 6 % faster than
#: channels-last (NDHWC) at the FID's f32 shape and as fast at the perceptual
#: term's bf16 shape on the H100 (``scripts/torch_port_medicalnet_layout.py``,
#: PERF.md).
MEMORY_FORMAT = torch.contiguous_format

#: Pinned identity of the checkpoint the reference trains with (MONAI's
#: ``PerceptualLoss(network_type='medicalnet_resnet10_23datasets')``,
#: reference ``src/model.py:127-129``). There is no network here, so the
#: identity is pinned by source and the structural fingerprint below;
#: ``tools/convert_medicalnet.py`` records the SHA256 of the torch file it
#: converted (``__source_sha256__``).
MEDICALNET_SOURCE = {
    "monai_network_type": "medicalnet_resnet10_23datasets",
    "torch_hub_repo": "warvito/MedicalNet-models",
    "torch_hub_model": "medicalnet_resnet10_23datasets",
    "original_release": (
        "Tencent/MedicalNet resnet_10_23dataset.pth (Chen et al. 2019, "
        "https://github.com/Tencent/MedicalNet)"
    ),
}

#: Required tensor inventory (torch key → shape) of the pinned checkpoint.
#: Extra keys (the segmentation head ``conv_seg.*``) are permitted and ignored.
MEDICALNET_FINGERPRINT: Dict[str, tuple] = {
    "conv1.weight": (64, 1, 7, 7, 7),
    "layer1.0.conv1.weight": (64, 64, 3, 3, 3),
    "layer1.0.conv2.weight": (64, 64, 3, 3, 3),
    "layer2.0.conv1.weight": (128, 64, 3, 3, 3),
    "layer2.0.conv2.weight": (128, 128, 3, 3, 3),
    "layer2.0.downsample.0.weight": (128, 64, 1, 1, 1),
    "layer3.0.conv1.weight": (256, 128, 3, 3, 3),
    "layer3.0.conv2.weight": (256, 256, 3, 3, 3),
    "layer3.0.downsample.0.weight": (256, 128, 1, 1, 1),
    "layer4.0.conv1.weight": (512, 256, 3, 3, 3),
    "layer4.0.conv2.weight": (512, 512, 3, 3, 3),
    "layer4.0.downsample.0.weight": (512, 256, 1, 1, 1),
}

_PROVENANCE = ("__source_sha256__", "__source_file__")


def check_medicalnet_fingerprint(state_dict: Dict[str, Any]) -> None:
    """Validate a (possibly ``module.``-prefixed) state dict against the
    pinned ResNet-10 inventory; raises ``ValueError`` on a mismatch."""
    sd = {k.replace("module.", ""): v for k, v in state_dict.items()}
    problems = []
    for key, shape in MEDICALNET_FINGERPRINT.items():
        if key not in sd:
            problems.append(f"missing {key}")
        elif tuple(np.shape(sd[key])) != shape:
            problems.append(f"{key}: shape {tuple(np.shape(sd[key]))} != {shape}")
    if problems:
        raise ValueError(
            "checkpoint does not match the pinned "
            f"{MEDICALNET_SOURCE['monai_network_type']} fingerprint: " + "; ".join(problems))


def resolve_medicalnet_path(weights_path: Optional[str] = None) -> Optional[str]:
    """The converted Med3D ``.npz``: ``weights_path`` if given (even if it is
    missing, so the random-feature warning names what was asked for), else
    ``$UNET_BSSFP_MEDICALNET``, else ``<repo>/weights/medicalnet_resnet10.npz``
    where it exists, else None."""
    if weights_path:
        return weights_path
    env = os.environ.get("UNET_BSSFP_MEDICALNET")
    if env:
        return env
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    default = os.path.join(repo, "weights", "medicalnet_resnet10.npz")
    return default if os.path.exists(default) else None


#: ``(abspath, mtime) -> bool``: the check reads the whole ~57 MB archive.
_pretrained_cache: Dict[tuple, bool] = {}


def medicalnet_is_pretrained(weights_path: Optional[str] = None) -> bool:
    """True when a converted Med3D checkpoint resolves
    (:func:`resolve_medicalnet_path`) AND its inventory passes
    :func:`check_medicalnet_fingerprint`: perceptual and FID values are then
    comparable to the reference's. A file that exists but fails the check
    gives False, with a warning."""
    path = resolve_medicalnet_path(weights_path)
    if not (path and os.path.exists(path)):
        return False
    try:
        key = (os.path.abspath(path), os.stat(path).st_mtime)
    except OSError:
        return False
    if key in _pretrained_cache:
        return _pretrained_cache[key]
    try:
        with np.load(path) as archive:
            check_medicalnet_fingerprint({k: archive[k] for k in archive.files
                                          if k not in _PROVENANCE})
        ok = True
    except (OSError, EOFError, ValueError, KeyError, zipfile.BadZipFile) as exc:
        # unreadable, truncated, not an npz, or the wrong inventory
        _log.warning("Med3D checkpoint at %s failed the pinned fingerprint check (%s); "
                     "treating it as NOT pretrained.", path, exc)
        ok = False
    _pretrained_cache[key] = ok
    return ok


def _bn(c: int) -> nn.BatchNorm3d:
    # Flax's momentum 0.9 is torch's 0.1; the net only runs in eval mode
    return nn.BatchNorm3d(c, eps=1e-5, momentum=0.1)


class BasicBlock3D(nn.Module):
    """Two 3³ convs (BN, ReLU between), a 1³ shortcut where the width or the
    stride changes, ReLU(y + residual)."""

    def __init__(self, cin: int, cout: int, stride: int = 1, dilation: int = 1):
        super().__init__()
        self.conv1 = nn.Conv3d(cin, cout, 3, stride=stride, padding=dilation,
                               dilation=dilation, bias=False)
        self.bn1 = _bn(cout)
        self.conv2 = nn.Conv3d(cout, cout, 3, padding=dilation, dilation=dilation, bias=False)
        self.bn2 = _bn(cout)
        self.downsample = None
        if cin != cout or stride != 1:
            self.downsample = nn.Sequential(
                nn.Conv3d(cin, cout, 1, stride=stride, bias=False), _bn(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return torch.relu(y + residual)


class MedicalNetResNet10(nn.Module):
    """Single-channel ``(N, D, H, W, 1)`` volume → ``(N, d, h, w, 512)``
    features (each extent halved three times, by the stem, the pool and
    layer2), computed in the dtype of the net's parameters."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv3d(1, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = _bn(64)
        self.maxpool = nn.MaxPool3d(3, stride=2, padding=1)  # pads with -inf, as Flax
        self.layer1 = nn.Sequential(BasicBlock3D(64, 64))
        self.layer2 = nn.Sequential(BasicBlock3D(64, 128, stride=2))
        self.layer3 = nn.Sequential(BasicBlock3D(128, 256, dilation=2))
        self.layer4 = nn.Sequential(BasicBlock3D(256, 512, dilation=4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.ndim != 5 or x.shape[-1] != 1:
            raise ValueError(f"MedicalNet takes single-channel (N, D, H, W, 1) volumes, "
                             f"got {tuple(x.shape)}")
        x = x.to(self.conv1.weight.dtype).movedim(-1, 1).contiguous(memory_format=MEMORY_FORMAT)
        y = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        y = self.layer4(self.layer3(self.layer2(self.layer1(y))))
        return y.movedim(1, -1)


def _frozen(net: MedicalNetResNet10, dtype, device) -> MedicalNetResNet10:
    net.requires_grad_(False)
    return net.to(device=device, dtype=dtype, memory_format=MEMORY_FORMAT).eval()


def init_medicalnet(seed: int = 0, dtype: Optional[torch.dtype] = None,
                    device: Union[str, torch.device, None] = None) -> MedicalNetResNet10:
    """The random-feature net: Flax's initialisation (``lecun_normal``
    truncated at 2σ, BatchNorm scale 1, shift 0, mean 0, variance 1) drawn
    from a CPU generator seeded with ``seed`` (``weights.init_state_dict``),
    frozen, in eval mode, on ``device`` (default the CPU) in ``dtype``
    (default f32). The draw is the port's own, not JAX's ``PRNGKey(seed)``."""
    net = MedicalNetResNet10()
    net.load_state_dict(weights.init_state_dict(net, seed))
    return _frozen(net, dtype or torch.float32, device or "cpu")


def medicalnet_state_dict(state_dict: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A Med3D torch state dict (numpy- or tensor-valued, ``module.``-prefixed
    or not) → the net's ``state_dict`` in f32: every parameter and BatchNorm
    statistic the net has (a missing one raises ``KeyError``); extra keys
    such as ``conv_seg.*`` are ignored, as the JAX package ignores them."""
    sd = {k.replace("module.", ""): v for k, v in state_dict.items()}
    out = {}
    for key in MedicalNetResNet10().state_dict():
        if key.endswith("num_batches_tracked"):
            continue  # not in Med3D files; eval mode never reads it
        out[key] = torch.as_tensor(np.asarray(sd[key], np.float32))
    return out


def load_medicalnet(weights_path: Optional[str] = None, seed: int = 0,
                    dtype: Optional[torch.dtype] = None,
                    device: Union[str, torch.device, None] = None) -> MedicalNetResNet10:
    """The frozen net from a converted Med3D ``.npz`` where one resolves and
    passes the fingerprint, else :func:`init_medicalnet` (random features).
    Logs loudly which mode is active."""
    weights_path = resolve_medicalnet_path(weights_path)
    if medicalnet_is_pretrained(weights_path):
        with np.load(weights_path) as archive:
            sd = {k: archive[k] for k in archive.files}
        sha = sd.pop("__source_sha256__", None)
        src = sd.pop("__source_file__", None)
        check_medicalnet_fingerprint(sd)
        _log.info(
            "MedicalNet perceptual/FID: PRETRAINED Med3D weights from %s (source file %s, "
            "sha256 %s) — reference-comparable mode", weights_path,
            np.asarray(src).item() if src is not None else "unknown",
            np.asarray(sha).item() if sha is not None else "unrecorded")
        net = MedicalNetResNet10()
        net.load_state_dict(medicalnet_state_dict(sd))  # BatchNorm fills num_batches_tracked
        return _frozen(net, dtype or torch.float32, device or "cpu")
    _log.warning(
        "MedicalNet perceptual/FID: RANDOM-FEATURE mode (no pretrained Med3D weights at %r). "
        "Values are internally consistent but NOT comparable to the reference's published "
        "loss/FID numbers; convert the pinned %s checkpoint with tools/convert_medicalnet.py "
        "to enable parity mode.", weights_path, MEDICALNET_SOURCE["monai_network_type"])
    return init_medicalnet(seed=seed, dtype=dtype, device=device)


def medicalnet_features(net: MedicalNetResNet10, volume: torch.Tensor) -> torch.Tensor:
    """Features of each channel of ``(N, D, H, W, C)``, run separately (one
    batch of C·N slabs in (c, n) order) and concatenated channel-major on
    the last axis → ``(N, d, h, w, C·512)``, as the reference's FID path
    (``src/model.py:241-253``). Z-normalising is the caller's job."""
    n, c = volume.shape[0], volume.shape[-1]
    f = net(volume.movedim(-1, 0).reshape(c * n, *volume.shape[1:4], 1))
    return torch.cat(f.split(n), dim=-1)


def _unit(f: torch.Tensor) -> torch.Tensor:
    return f / (torch.sqrt(torch.sum(f * f, dim=-1, keepdim=True)) + 1e-10)


def perceptual_distance(net: MedicalNetResNet10, pred: torch.Tensor, target: torch.Tensor,
                        chunk: Optional[int] = None) -> torch.Tensor:
    """MONAI's ``MedicalNetPerceptualSimilarity`` (is_fake_3d=False), the
    reference's ``PerceptualLoss`` (``src/model.py:127-129``): whole-tensor
    z-norm of each side → each channel's features (channels moved to the
    batch in (c, n) order) → unit-normalised over the features → squared
    difference summed over the features, mean over the rest; the
    normalisation and the reduction in f32 whatever the net's dtype.

    The target is data: its features run under ``torch.no_grad()``, so the
    gradient flows through ``pred`` only. ``chunk`` runs the slabs in groups
    of ``chunk`` (bounding the peak activation memory) where it divides
    their count and is smaller."""

    def features(z: torch.Tensor) -> torch.Tensor:
        n_, d, h, w, c_ = z.shape
        slabs = z.movedim(-1, 0).reshape(c_ * n_, d, h, w, 1)
        if chunk and slabs.shape[0] > chunk and slabs.shape[0] % chunk == 0:
            return torch.cat([net(g) for g in slabs.split(chunk)])
        return net(slabs)

    fp = features(znorm(pred))
    with torch.no_grad():
        ft = features(znorm(target))
    return torch.mean(torch.sum((_unit(fp.float()) - _unit(ft.float())) ** 2, dim=-1))
