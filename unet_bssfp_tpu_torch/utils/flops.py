"""Analytic FLOP counts of the GAN step (counterpart of
``unet_bssfp_tpu/utils/flops.py``, same conventions, same numbers).

Step FLOPs are counted from the static conv shapes (BasicUNet generator,
PatchGAN discriminator, MedicalNet ResNet10 behind the perceptual term)
and divided by a measured step time for TFLOP/s and the share of the
card's peak.

Conventions (stated so the number is reproducible):
- a conv of output spatial volume V, kernel K³, Cin→Cout counts
  ``2·V·Cout·K³·Cin`` FLOPs (multiply+add);
- a backward pass costs 2× forward (dx + dw) when both gradients are
  needed, 1× when only one of them is;
- norms, activations, pools, optimizer updates and the loss itself are
  ignored (sub-1% at these shapes).
"""

from __future__ import annotations

from typing import Sequence, Tuple

# Dense bf16 tensor-core peak FLOP/s by card, keyed on a prefix of
# ``torch.cuda.get_device_name()``: NVIDIA's H100 data sheet, SXM5 part
# (989 TFLOP/s without sparsity, at its 700 W limit).
GPU_BF16_PEAK = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


def peak_flops(device_name: str) -> float | None:
    """bf16 peak for a device name, longest-prefix match; None if unknown."""
    best = None
    for prefix, peak in GPU_BF16_PEAK.items():
        if device_name.startswith(prefix):
            if best is None or len(prefix) > best[0]:
                best = (len(prefix), peak)
    return best[1] if best else None


def _conv(vol: int, k: int, cin: int, cout: int) -> float:
    return 2.0 * vol * cout * (k ** 3) * cin


def generator_fwd_flops(
    patch: int = 64,
    in_ch: int = 24,
    out_ch: int = 6,
    unet_in: int = 24,
    features: Sequence[int] = (32, 64, 128, 256, 512, 32),
) -> float:
    """One generator forward on a ``patch³`` input (per sample).

    Head 1³ conv + BasicUNet3D: 5 TwoConv encoder stages, 4 transpose-conv
    up stages with skip-concat TwoConvs, final 1³ conv (the channel plumbing
    documented in ``models/unet.py``).
    """
    f = list(features)
    vols = [(patch // (2 ** i)) ** 3 for i in range(5)]  # 64³..4³
    total = _conv(vols[0], 1, in_ch, unet_in)            # modality head
    # encoder
    total += _conv(vols[0], 3, unet_in, f[0]) + _conv(vols[0], 3, f[0], f[0])
    for i in range(1, 5):
        total += _conv(vols[i], 3, f[i - 1], f[i])
        total += _conv(vols[i], 3, f[i], f[i])
    # decoder: upcat_4..upcat_2 halve the up channels, upcat_1 keeps f[1]
    up_specs: Tuple[Tuple[int, int, int, int, int], ...] = (
        # (out_vol, up_cin, up_cout, skip_ch, conv_out)
        (vols[3], f[4], f[4] // 2, f[3], f[3]),
        (vols[2], f[3], f[3] // 2, f[2], f[2]),
        (vols[1], f[2], f[2] // 2, f[1], f[1]),
        (vols[0], f[1], f[1], f[0], f[5]),
    )
    for out_vol, up_cin, up_cout, skip, conv_out in up_specs:
        # k2s2 transpose conv: each output voxel touched by exactly one tap
        total += 2.0 * out_vol * up_cin * up_cout
        total += _conv(out_vol, 3, up_cout + skip, conv_out)
        total += _conv(out_vol, 3, conv_out, conv_out)
    total += _conv(vols[0], 1, f[5], out_ch)
    return total


def discriminator_fwd_flops(
    patch: int = 64,
    in_ch: int = 24,
    out_ch: int = 6,
    features: Sequence[int] = (32, 64, 128, 256, 512),
) -> float:
    """One PatchGAN forward (per sample): five k4s2 convs + 1³ head."""
    chans = [in_ch + out_ch] + list(features)
    total = 0.0
    vol = patch ** 3
    for i in range(len(features)):
        vol //= 8
        total += _conv(vol, 4, chans[i], chans[i + 1])
    total += _conv(vol, 1, chans[-1], 1)
    return total


def medicalnet_fwd_flops(vol_side: int = 64) -> float:
    """One MedicalNet-ResNet10 forward on a single-channel ``vol_side³``
    volume (stem 7³ s2 → pool s2 → blocks 64/128(s2)/256(dil)/512(dil))."""
    s = vol_side // 2          # after stem
    p = s // 2                 # after maxpool
    total = 2.0 * (s ** 3) * 64 * (7 ** 3) * 1
    # layer1: 64→64 ×2 at p³
    total += 2 * _conv(p ** 3, 3, 64, 64)
    q = p // 2                 # layer2 stride 2
    total += _conv(q ** 3, 3, 64, 128) + _conv(q ** 3, 3, 128, 128)
    total += _conv(q ** 3, 1, 64, 128)
    # layer3/4 dilated, stride 1 at q³
    total += _conv(q ** 3, 3, 128, 256) + _conv(q ** 3, 3, 256, 256)
    total += _conv(q ** 3, 1, 128, 256)
    total += _conv(q ** 3, 3, 256, 512) + _conv(q ** 3, 3, 512, 512)
    total += _conv(q ** 3, 1, 256, 512)
    return total


def gan_step_flops(
    batch: int = 8,
    patch: int = 64,
    in_ch: int = 24,
    out_ch: int = 6,
    with_perceptual: bool = False,
    reuse_fake: bool = False,
) -> float:
    """FLOPs of one full GAN train step (reference semantics,
    ``src/model.py:259-281``; see ``train/steps.py``).

    Generator: fwd + bwd(2×) in the gen phase, plus one detached fwd in the
    disc phase unless ``reuse_fake``. Discriminator: fwd + dx-only bwd (1×)
    in the gen phase; two fwd + dw-only bwd (1× each) in the disc phase.
    Perceptual: MedicalNet fwd on 2·C single-channel slabs per sample plus
    dx-only bwd on the prediction's C slabs.
    """
    g = generator_fwd_flops(patch, in_ch, out_ch)
    d = discriminator_fwd_flops(patch, in_ch, out_ch)
    per_sample = g * (3.0 if reuse_fake else 4.0) + d * (2.0 + 4.0)
    if with_perceptual:
        m = medicalnet_fwd_flops(patch)
        per_sample += m * out_ch * 3.0   # fwd 2C slabs + bwd C slabs
    return per_sample * batch
