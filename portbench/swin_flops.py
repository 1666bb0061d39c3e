"""Model FLOPs and kernel work of a GAN step with the SwinUNETR generator
(MONAI v1: ``portbench/reference/swin_unetr.py``), by the conventions of
``portbench/flops.py``:

- a conv of output volume V, kernel K³, Cin → Cout counts ``2·V·Cout·K³·Cin``;
  a k2 s2 transpose conv ``2·V_out·Cin·Cout``; a linear layer ``2·T·I·O``
  over its T tokens (the attention's qkv and proj over the windows' padded
  tokens, the MLP and patch merging over the stage's own);
- window attention ``4·n²·d`` a window and head forward (q·kᵀ and p·v),
  ``8·n²·d`` backward (dq, dk, dv and dp);
- a backward pass costs 2× the forward, norms, activations, softmax, the
  losses and the optimizer are not counted.

:func:`step_flops` gives the step's model FLOPs and those of its convs and
GEMMs alone (the conv groups' work: every conv and linear layer, attention
left out). :func:`window_attn_work` and :func:`norm_act_work` give the least
operations and bytes a step of the attention kernels and of K10, the
numerators of their rooflines.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from portbench import flops as pf


def _conv(vol: int, k: int, cin: int, cout: int) -> float:
    return 2.0 * vol * cout * k ** 3 * cin


def stages(patch: int, s: dict) -> List[dict]:
    """Each Swin stage at a ``patch``³ input: its side, channels, heads, the
    (clamped) window, the side padded to whole windows, and whether its odd
    blocks shift (MONAI v1's ``get_window_size``)."""
    out, side = [], patch // s["patch_size"]
    for i, (depth, heads) in enumerate(zip(s["depths"], s["num_heads"])):
        w = min(side, s["window_size"])
        out.append(dict(side=side, dim=s["feature_size"] * 2 ** i, heads=heads, depth=depth,
                        window=w, padded=-(-side // w) * w, shifts=side > s["window_size"]))
        side //= 2
    return out


def attention_blocks(patch: int, s: dict) -> List[Tuple[int, int, int, int, bool]]:
    """(windows, heads, n, d, shifted) of every block a crop."""
    out = []
    for st in stages(patch, s):
        nw = (st["padded"] // st["window"]) ** 3
        for j in range(st["depth"]):
            out.append((nw, st["heads"], st["window"] ** 3, st["dim"] // st["heads"],
                        st["shifts"] and j % 2 == 1))
    return out


def generator_gemms(patch: int, cfg: dict) -> float:
    """FLOPs of one crop's generator forward in its convs and linear layers:
    the 1³ head, the patch embedding, the Swin linear layers, the UNETR
    blocks and the output conv."""
    s, fs = cfg["swin"], cfg["swin"]["feature_size"]
    cin, c = cfg["in_channels"], cfg["unet_in_channels"]
    v = patch ** 3
    total = _conv(v, 1, cin, c) + _conv(v // s["patch_size"] ** 3, s["patch_size"], c, fs)
    for st in stages(patch, s):
        dim, hidden = st["dim"], int(st["dim"] * s["mlp_ratio"])
        tokens, padded = st["side"] ** 3, st["padded"] ** 3
        block = 2.0 * padded * dim * 4 * dim + 2.0 * tokens * dim * hidden * 2
        total += st["depth"] * block + 2.0 * (tokens // 8) * 8 * dim * 2 * dim

    def res(vol, a, b):
        return _conv(vol, 3, a, b) + _conv(vol, 3, b, b) + (_conv(vol, 1, a, b) if a != b else 0)

    sides = [patch // 2 ** i for i in range(6)]  # 96, 48, 24, 12, 6, 3
    total += res(sides[0] ** 3, c, fs)
    total += res(sides[1] ** 3, fs, fs) + res(sides[2] ** 3, 2 * fs, 2 * fs) \
        + res(sides[3] ** 3, 4 * fs, 4 * fs) + res(sides[5] ** 3, 16 * fs, 16 * fs)
    for lvl, cup in ((4, 16 * fs), (3, 8 * fs), (2, 4 * fs), (1, 2 * fs), (0, fs)):
        o = cup // 2 if lvl else fs
        vol = sides[lvl] ** 3
        total += 2.0 * vol * cup * o + res(vol, 2 * o, o)
    return total + _conv(v, 1, fs, cfg["out_channels"])


def attention_flops(patch: int, s: dict) -> float:
    """One crop's window attention forward: 4·n²·d a window and head."""
    return sum(nw * h * 4.0 * n * n * d for nw, h, n, d, _ in attention_blocks(patch, s))


def step_flops(cfg: dict, traffic: dict) -> Tuple[float, float]:
    """A GAN step's model FLOPs, and those of its convs and GEMMs alone: G's
    forward with its gradient and its backward (3×) and its second forward
    in D's phase (1×); D's as ``flops.gan_step`` counts it (6×)."""
    b, p = traffic["batch"], traffic["patch"]
    gemm = generator_gemms(p, cfg)
    attn = attention_flops(p, cfg["swin"])
    d = pf.total(pf.discriminator_convs(p, cfg["in_channels"], cfg["out_channels"],
                                        cfg["disc_features"]))
    return b * (4.0 * (gemm + attn) + 6.0 * d), b * (4.0 * gemm + 6.0 * d)


def window_attn_work(cfg: dict, traffic: dict, keys: Sequence[str]) -> Dict[str, float]:
    """The attention kernels' least work a step (``keys``: their names'
    parts): forward with a gradient and without (D's phase), and the
    backward. FLOPs 4·n²·d a window and head forward, 8·n²·d backward.
    Bytes, at the compute dtype: q, k, v and o once each forward, and the
    bias (the relative-position bias with the shift mask, as passed: windows
    × heads × n² where shifted, heads × n² where not) once; backward q, k,
    v, o and dO read, dq, dk, dv written, the bias read and its gradient
    written once at the bias's size."""
    elem = 2 if cfg["compute_dtype"] == "bfloat16" else 4
    b = traffic["batch"]
    flops = nbytes = 0.0
    for nw, h, n, d, shifted in attention_blocks(traffic["patch"], cfg["swin"]):
        t = b * nw * h * n * d * elem
        bias = (nw if shifted else 1) * h * n * n * elem
        flops += b * nw * h * n * n * d * (4.0 + 4.0 + 8.0)
        nbytes += 2 * (4 * t + bias) + (8 * t + 2 * bias)
    return {"keys": list(keys), "flops": flops, "bytes": nbytes}


def norm_act_work(cfg: dict, traffic: dict) -> Dict[str, float]:
    """K10's least bytes a step: six calls a generator pass (encoder1's and
    decoder1's conv1, conv2 and residual norms) on (B, D, C, H·W) at the
    full resolution and ``feature_size`` channels, without dropout: the
    forward with a gradient, the backward, and the forward without one in
    D's phase (``flops.norm_act_pass_bytes``)."""
    elem = 2 if cfg["compute_dtype"] == "bfloat16" else 4
    elements = traffic["batch"] * traffic["patch"] ** 3 * cfg["swin"]["feature_size"] * 6
    per = sum(pf.norm_act_pass_bytes(k, elem, False) for k in ("grad", "backward", "no_grad"))
    return {"keys": ["norm_act_kernel_packed"], "flops": 0.0, "bytes": float(elements * per)}

