"""The generator (1³ head + BasicUNet-3D), the PatchGAN discriminator and
the MultiInputUNet as plain float32 functions of a weight dict.

Written from the architecture's description (``SomeUserName1/UNet-bSSFP``
``src/model.py``, MONAI's ``BasicUNet``, the thesis's ``03-methods.tex``),
not from the program: NCDHW tensors, ``F.conv3d``, ``F.instance_norm``-free
moments written out, and dropout masks drawn as the configuration's seeded
generator draws them (:class:`Masks`).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]
EPS = 1e-5


class _Fp8(torch.autograd.Function):
    """Round trip through float8 e4m3 with one scale per tensor (its
    largest magnitude maps to 448, the format's largest finite value), in
    the forward and, for the gradient that reaches the tensor, in the
    backward."""

    @staticmethod
    def forward(ctx, t):
        return _fp8_round(t)

    @staticmethod
    def backward(ctx, g):
        return _fp8_round(g)


def _fp8_round(t: torch.Tensor) -> torch.Tensor:
    scale = 448.0 / t.detach().abs().amax().clamp_min(1e-30)
    return (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` as fp8 e4m3 holds it (per-tensor scale), gradients likewise."""
    return _Fp8.apply(t)


class Masks:
    """Dropout masks drawn as the program draws them: for a block whose
    activations the program holds as NDHWC, ``bernoulli_(keep)`` of a
    float32 ``(B, D, H, W, C)`` tensor; for a block of the packed
    full-resolution stages, of ``(B, D, C, H·W)``. Each call draws the next
    mask from ``generator`` and returns it as a boolean NCDHW tensor."""

    def __init__(self, generator: torch.Generator, rate: float):
        self.generator = generator
        self.keep = 1.0 - rate

    def draw(self, shape_ncdhw, packed: bool) -> torch.Tensor:
        b, c, d, h, w = shape_ncdhw
        dev = self.generator.device
        if packed:
            m = torch.empty((b, d, c, h * w), device=dev).bernoulli_(
                self.keep, generator=self.generator).bool()
            return m.view(b, d, c, h, w).permute(0, 2, 1, 3, 4)
        m = torch.empty((b, d, h, w, c), device=dev).bernoulli_(
            self.keep, generator=self.generator).bool()
        return m.permute(0, 4, 1, 2, 3)


def q(t, quant: Quant):
    """``t`` as the computation's precision holds it: float32 (``quant``
    None), or rounded by ``quant``."""
    return t if quant is None else quant(t)


def conv(x, w, b, stride=1, padding=0, quant: Quant = None):
    return q(F.conv3d(q(x, quant), q(w, quant), b, stride, padding), quant)


def conv_transpose(x, w, b, quant: Quant = None):
    return q(F.conv_transpose3d(q(x, quant), q(w, quant), b, stride=2), quant)


def instance_norm(x, scale, bias):
    var, mean = torch.var_mean(x, dim=(2, 3, 4), correction=0, keepdim=True)
    return (x - mean) * torch.rsqrt(var + EPS) * scale.view(1, -1, 1, 1, 1) \
        + bias.view(1, -1, 1, 1, 1)


def batch_norm(x, p: Params, name: str, train: bool):
    """Train mode: the batch's moments (biased variance); eval mode: the
    running statistics."""
    if train:
        var, mean = torch.var_mean(x, dim=(0, 2, 3, 4), correction=0, keepdim=True)
    else:
        mean = p[f"{name}.running_mean"].view(1, -1, 1, 1, 1)
        var = p[f"{name}.running_var"].view(1, -1, 1, 1, 1)
    return (x - mean) * torch.rsqrt(var + EPS) * p[f"{name}.weight"].view(1, -1, 1, 1, 1) \
        + p[f"{name}.bias"].view(1, -1, 1, 1, 1)


def prelu(x, slope):
    return torch.where(x >= 0, x, slope.view(1, -1, 1, 1, 1) * x)


def unique_prefix(p: Params, suffix: str) -> str:
    """The one key prefix ``X`` with ``X + suffix`` in ``p`` (the modality
    group's head names, ``head24`` or ``d1_head24``)."""
    found = [k[:-len(suffix)] for k in p if k.endswith(suffix) and "." not in k[:-len(suffix)]]
    if len(found) != 1:
        raise KeyError(f"expected one top-level key ending in {suffix!r}, found {found}")
    return found[0]


def basic_unet(p: Params, x, features: Sequence[int], dropout: float, slope: float,
               use_prelu: bool, masks: Optional[Masks], packed: bool,
               quant: Quant = None, pre: str = "unet."):
    """BasicUNet-3D (MONAI): TwoConv, four Down, four UpCat (transpose conv,
    replicate pad to the skip, concat skip first), final 1³ conv. Each conv
    block: 3³ conv → InstanceNorm(affine) → dropout → LeakyReLU(slope) or
    PReLU. ``packed``: the blocks at full resolution draw their masks in the
    packed layout."""

    def block(name, h, full_res):
        h = conv(h, p[f"{name}.conv.weight"], p[f"{name}.conv.bias"], 1, 1, quant)
        h = q(instance_norm(h, p[f"{name}.norm.weight"], p[f"{name}.norm.bias"]), quant)
        if masks is not None and dropout > 0:
            m = masks.draw(h.shape, packed and full_res)
            h = torch.where(m, h / masks.keep, torch.zeros((), dtype=h.dtype, device=h.device))
        if use_prelu:
            return q(prelu(h, p[f"{name}.prelu_slope"]), quant)
        return q(F.leaky_relu(h, slope), quant)

    def two(name, h, full_res=False):
        return block(f"{name}.conv_1", block(f"{name}.conv_0", h, full_res), full_res)

    def upcat(name, h, skip, full_res=False):
        up = conv_transpose(h, p[f"{name}.upsample.weight"], p[f"{name}.upsample.bias"], quant)
        pads = []
        for ax in (4, 3, 2):
            diff = skip.shape[ax] - up.shape[ax]
            pads += [diff // 2, diff - diff // 2]
        if any(pads):
            up = F.pad(up, pads, mode="replicate")
        return two(f"{name}.convs", torch.cat([skip, up], dim=1), full_res)

    x0 = two(f"{pre}conv_0", x, True)
    x1 = two(f"{pre}down_1.convs", F.max_pool3d(x0, 2, 2))
    x2 = two(f"{pre}down_2.convs", F.max_pool3d(x1, 2, 2))
    x3 = two(f"{pre}down_3.convs", F.max_pool3d(x2, 2, 2))
    x4 = two(f"{pre}down_4.convs", F.max_pool3d(x3, 2, 2))
    u = upcat(f"{pre}upcat_4", x4, x3)
    u = upcat(f"{pre}upcat_3", u, x2)
    u = upcat(f"{pre}upcat_2", u, x1)
    u = upcat(f"{pre}upcat_1", u, x0, True)
    return conv(u, p[f"{pre}final_conv.weight"], p[f"{pre}final_conv.bias"], quant=quant)


def to_ncdhw(x):
    return x.permute(0, 4, 1, 2, 3)


def to_ndhwc(x):
    return x.permute(0, 2, 3, 4, 1)


def generator(p: Params, x, cfg: dict, train: bool, masks: Optional[Masks] = None,
              packed: bool = False, quant: Quant = None):
    """The GAN's generator on NDHWC ``x``: the modality's 1³ ConvBlock head
    (conv, BatchNorm, LeakyReLU(disc slope)), then the BasicUNet."""
    head = unique_prefix(p, ".bn.running_mean")
    h = conv(to_ncdhw(x), p[f"{head}.conv.weight"], p[f"{head}.conv.bias"], quant=quant)
    h = q(F.leaky_relu(q(batch_norm(h, p, f"{head}.bn", train), quant),
                       cfg["disc_negative_slope"]), quant)
    out = basic_unet(p, h, cfg["features"], cfg["dropout"], cfg["unet_negative_slope"],
                     False, masks if train else None, packed, quant)
    return to_ndhwc(out)


def discriminator(p: Params, x, y, cfg: dict, quant: Quant = None):
    """PatchGAN on concat(x, y): a k4 s2 p1 conv block without BatchNorm,
    then k4 s2 p1 blocks with BatchNorm (train mode), LeakyReLU after each,
    and a 1³ conv to one logit per patch; NDHWC logits."""
    s = cfg["disc_negative_slope"]
    first = [k for k in p if k.startswith("d1_") and k.endswith(".conv.weight")]
    if len(first) != 1:
        raise KeyError(f"expected one first block d1_<head>, found {first}")
    first = first[0][:-len(".conv.weight")]
    h = torch.cat([to_ncdhw(x), to_ncdhw(y)], dim=1)
    h = q(F.leaky_relu(conv(h, p[f"{first}.conv.weight"], p[f"{first}.conv.bias"], 2, 1,
                            quant), s), quant)
    for i in range(2, len(cfg["disc_features"]) + 1):
        h = conv(h, p[f"d{i}.conv.weight"], p[f"d{i}.conv.bias"], 2, 1, quant)
        h = q(F.leaky_relu(q(batch_norm(h, p, f"d{i}.bn", True), quant), s), quant)
    return to_ndhwc(conv(h, p["final.weight"], p["final.bias"], quant=quant))


def multi_input_unet(p: Params, x, cfg: dict, train: bool, masks: Optional[Masks] = None,
                     packed: bool = False, quant: Quant = None):
    """The thesis's MultiInputUNet on NDHWC ``x``: the residual input head
    (three 3³ conv → InstanceNorm → ReLU, the first block's output added
    before the last ReLU), then the BasicUNet with PReLU slopes."""
    head = [k[:-len(".conv_in.weight")] for k in p if k.endswith(".conv_in.weight")][0]

    def cn(name, h):
        h = conv(h, p[f"{head}.conv_{name}.weight"], p[f"{head}.conv_{name}.bias"], 1, 1, quant)
        return q(instance_norm(h, p[f"{head}.norm_{name}.weight"], p[f"{head}.norm_{name}.bias"]),
                 quant)

    h = q(F.relu(cn("in", to_ncdhw(x))), quant)
    skip = h
    h = q(F.relu(cn("mid", h)), quant)
    h = q(F.relu(cn("out", h) + skip), quant)
    out = basic_unet(p, h, cfg["features"], cfg["dropout"], 0.25, True,
                     masks if train else None, packed, quant)
    return to_ndhwc(out)


def _conv_leaves(out: dict, name: str, cin: int, cout: int, k: int) -> None:
    out[f"{name}.weight"] = (cout, cin, k, k, k)
    out[f"{name}.bias"] = (cout,)


def _norm_leaves(out: dict, name: str, c: int, running: bool = False) -> None:
    out[f"{name}.weight"] = (c,)
    out[f"{name}.bias"] = (c,)
    if running:
        out[f"{name}.running_mean"] = (c,)
        out[f"{name}.running_var"] = (c,)


def unet_shapes(out: dict, cin: int, cout: int, f: Sequence[int], use_prelu: bool,
                pre: str = "unet.") -> None:
    """The BasicUNet's leaves and their shapes, in the order of its blocks."""

    def two(name, a, b):
        for i, c in enumerate((a, b)):
            _conv_leaves(out, f"{name}.conv_{i}.conv", c, b, 3)
            _norm_leaves(out, f"{name}.conv_{i}.norm", b)
            if use_prelu:
                out[f"{name}.conv_{i}.prelu_slope"] = (b,)

    two(f"{pre}conv_0", cin, f[0])
    for i in range(1, 5):
        two(f"{pre}down_{i}.convs", f[i - 1], f[i])
    for lvl, (up_in, up_out, skip, c) in zip((4, 3, 2, 1), (
            (f[4], f[4] // 2, f[3], f[3]), (f[3], f[3] // 2, f[2], f[2]),
            (f[2], f[2] // 2, f[1], f[1]), (f[1], f[1], f[0], f[5]))):
        out[f"{pre}upcat_{lvl}.upsample.weight"] = (up_in, up_out, 2, 2, 2)
        out[f"{pre}upcat_{lvl}.upsample.bias"] = (up_out,)
        two(f"{pre}upcat_{lvl}.convs", skip + up_out, c)
    _conv_leaves(out, f"{pre}final_conv", f[5], cout, 1)


def gan_shapes(cfg: dict):
    """The generator's and the discriminator's leaves (parameters and
    BatchNorm statistics) → shapes, named as the configuration's model
    names them: the modality group's head ``head24``/``head6`` and first
    discriminator block ``d1_<head>``."""
    head = f"head{cfg['in_channels']}"
    gen: dict = {}
    _conv_leaves(gen, f"{head}.conv", cfg["in_channels"], cfg["unet_in_channels"], 1)
    _norm_leaves(gen, f"{head}.bn", cfg["unet_in_channels"], running=True)
    unet_shapes(gen, cfg["unet_in_channels"], cfg["out_channels"], cfg["features"], False)
    disc: dict = {}
    chans = [cfg["in_channels"] + cfg["out_channels"]] + list(cfg["disc_features"])
    for i in range(1, len(chans)):
        name = f"d1_{head}" if i == 1 else f"d{i}"
        _conv_leaves(disc, f"{name}.conv", chans[i - 1], chans[i], 4)
        if i > 1:
            _norm_leaves(disc, f"{name}.bn", chans[i], running=True)
    _conv_leaves(disc, "final", chans[-1], 1, 1)
    return gen, disc


def multi_input_shapes(cfg: dict) -> dict:
    """The MultiInputUNet's leaves → shapes: ``head_head<C>`` then the
    PReLU U-Net."""
    head, c = f"head_head{cfg['in_channels']}", cfg["head_features"]
    out: dict = {}
    for name, cin in (("in", cfg["in_channels"]), ("mid", c), ("out", c)):
        _conv_leaves(out, f"{head}.conv_{name}", cin, c, 3)
        _norm_leaves(out, f"{head}.norm_{name}", c)
    unet_shapes(out, c, cfg["out_channels"], cfg["features"], True)
    return out
