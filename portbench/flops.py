"""Model FLOPs of the benchmark's steps and chunks, from conv shapes.

A frozen copy of the program's ``utils/flops.py`` conventions, extended to
the MultiInputUNet's stages and to the serving chunk:

- a conv of output volume V, kernel K³, Cin → Cout counts ``2·V·Cout·K³·Cin``;
  a k2 s2 transpose conv ``2·V_out·Cin·Cout`` (one tap per output voxel);
- a backward pass costs 2× the forward where both gradients are taken
  (dx and dw), 1× where one of them is;
- norms, activations, pools, the losses and the optimizer are not counted.

Every count comes from :func:`generator_convs`, :func:`discriminator_convs`
and :func:`multi_input_convs`, lists of ``(kernel, flops)`` per sample, so
the whole step's count and the count of its 3³ and 4³ convs alone (the
conv roofline's numerator) read the same shapes.

:func:`norm_act_bytes` counts the least bytes that K10 (the packed stages'
norm → dropout → activation chain, ``csrc/packed_norm_act.cu``) moves in a
step or chunk: its roofline's numerator.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

Convs = List[Tuple[int, float]]  # (kernel side, FLOPs per sample); 0 = transpose


def _conv(vol: int, k: int, cin: int, cout: int) -> Tuple[int, float]:
    return k, 2.0 * vol * cout * (k ** 3) * cin


def unet_convs(patch: int, unet_in: int, out_ch: int, features: Sequence[int]) -> Convs:
    """BasicUNet-3D: TwoConv, four Down, UpCat 4..2 halving the up channels,
    UpCat 1 keeping f1, final 1³ conv."""
    f = list(features)
    vols = [(patch // (2 ** i)) ** 3 for i in range(5)]
    out = [_conv(vols[0], 3, unet_in, f[0]), _conv(vols[0], 3, f[0], f[0])]
    for i in range(1, 5):
        out += [_conv(vols[i], 3, f[i - 1], f[i]), _conv(vols[i], 3, f[i], f[i])]
    for vol, up_cin, up_cout, skip, cout in (
            (vols[3], f[4], f[4] // 2, f[3], f[3]),
            (vols[2], f[3], f[3] // 2, f[2], f[2]),
            (vols[1], f[2], f[2] // 2, f[1], f[1]),
            (vols[0], f[1], f[1], f[0], f[5])):
        out.append((0, 2.0 * vol * up_cin * up_cout))
        out += [_conv(vol, 3, up_cout + skip, cout), _conv(vol, 3, cout, cout)]
    out.append(_conv(vols[0], 1, f[5], out_ch))
    return out


def generator_convs(patch: int, in_ch: int, out_ch: int, unet_in: int,
                    features: Sequence[int]) -> Convs:
    """The GAN's generator: 1³ head, then the BasicUNet."""
    return [_conv(patch ** 3, 1, in_ch, unet_in)] + unet_convs(patch, unet_in, out_ch, features)


def discriminator_convs(patch: int, in_ch: int, out_ch: int,
                        features: Sequence[int]) -> Convs:
    """PatchGAN: k4 s2 convs from in+out channels, then a 1³ conv to 1."""
    chans = [in_ch + out_ch] + list(features)
    out, vol = [], patch ** 3
    for i in range(len(features)):
        vol //= 8
        out.append(_conv(vol, 4, chans[i], chans[i + 1]))
    out.append(_conv(vol, 1, chans[-1], 1))
    return out


def head_convs(patch: int, in_ch: int, head: int) -> Convs:
    """The MultiInputUNet's residual head: three 3³ convs to ``head``."""
    v = patch ** 3
    return [_conv(v, 3, in_ch, head), _conv(v, 3, head, head), _conv(v, 3, head, head)]


def total(convs: Convs, only_kernels: Sequence[int] = ()) -> float:
    """Sum of ``convs``, or of those whose kernel side is in ``only_kernels``."""
    return sum(f for k, f in convs if not only_kernels or k in only_kernels)


def gan_step(batch: int, patch: int, in_ch: int, out_ch: int, unet_in: int,
             features: Sequence[int], disc_features: Sequence[int],
             only_kernels: Sequence[int] = ()) -> float:
    """One GAN step without the perceptual term, the fake drawn again in
    the discriminator phase (``reuse_fake`` off, as the reference's step):
    G forward + backward (3×) and its second forward (1×); D forward +
    dx-only backward in the generator phase (2×), two forwards and their
    dw-only backwards in its own (4×)."""
    g = total(generator_convs(patch, in_ch, out_ch, unet_in, features), only_kernels)
    d = total(discriminator_convs(patch, in_ch, out_ch, disc_features), only_kernels)
    return batch * (4.0 * g + 6.0 * d)


def supervised_step(stage: str, batch: int, patch: int, in_ch: int, out_ch: int,
                    head: int, features: Sequence[int], only_kernels: Sequence[int] = ()
                    ) -> float:
    """One step of the MultiInputUNet: forward and backward (3×) of head and
    U-Net where every leaf trains; in ``transfer`` the U-Net is frozen and
    takes its dx-only backward (2×), the head 3×."""
    h = total(head_convs(patch, in_ch, head), only_kernels)
    u = total(unet_convs(patch, head, out_ch, features), only_kernels)
    return batch * (3.0 * h + (2.0 if stage == "transfer" else 3.0) * u)


def serve_chunk(patches: int, patch: int, in_ch: int, out_ch: int, unet_in: int,
                features: Sequence[int], only_kernels: Sequence[int] = ()) -> float:
    """One generator forward over a chunk's ``patches``."""
    return patches * total(generator_convs(patch, in_ch, out_ch, unet_in, features),
                           only_kernels)


def norm_act_pass_bytes(kind: str, elem: int, dropout: bool) -> int:
    """The least bytes an element that one K10 call moves, each input read
    once and each output written once, ``elem`` bytes an element of x, y, dy
    and dx (the compute dtype's):

    - ``grad``, a train forward whose gradient is taken: x, the f32 dropout
      draw, y, the 1-byte mask kept for the backward;
    - ``no_grad``, a train forward without one: x, the draw, y;
    - ``backward``: x, dy and the mask; dx;
    - ``eval``: x, y.

    The draw and the mask only with dropout on. The draw's write
    (``bernoulli_``) is ATen's, not K10's; the moments and partial sums of an
    instance (a few floats a chunk of 8192 elements) are left out. K10 reads
    x twice in each direction (``csrc/packed_norm_act.cu``: 11, 10, 12 and 6
    bytes an element in bf16); a kernel that reads it once would still be
    held to this bound."""
    draw, mask = (4, 1) if dropout else (0, 0)
    return {"grad": 2 * elem + draw + mask, "no_grad": 2 * elem + draw,
            "backward": 3 * elem + mask, "eval": 2 * elem}[kind]


def packed_stage_channels(features: Sequence[int]) -> List[int]:
    """Output channels of the convs of a U-Net's packed full-resolution
    stages, each followed by one K10 call: conv_0's two (the first
    features) and upcat_1's two (the last)."""
    return [features[0], features[0], features[-1], features[-1]]


def norm_act_bytes(passes: Sequence[str], rows: int, patch: int, features: Sequence[int],
                   elem: int, dropout: bool) -> float:
    """K10's least bytes an item: each of ``passes`` (kinds of
    :func:`norm_act_pass_bytes`) takes the packed stages' four blocks over
    ``rows`` patches of ``patch``³ voxels."""
    elements = rows * patch ** 3 * sum(packed_stage_channels(features))
    return float(sum(elements * norm_act_pass_bytes(p, elem, dropout) for p in passes))
