"""SwinUNETR (MONAI v1) behind the GAN's 1³ head as plain float32 functions
of a weight dict, and the GAN's steps with it as the generator.

Written from MONAI's ``monai/networks/nets/swin_unetr.py`` (v1; Hatamizadeh
et al., arXiv:2201.01266) and its blocks (``UnetrBasicBlock``,
``UnetrUpBlock``, ``UnetResBlock``, ``UnetOutBlock``), not from the program:
the Swin encoder channels-last as MONAI runs it (``torch.roll``,
``window_partition``/``window_reverse``, the shift mask of
``compute_mask``), attention written out as ``softmax(q·kᵀ·scale + bias +
mask)·v``, the conv blocks NCDHW with ``F.conv3d`` and their norms' moments
written out. Imports nothing of the program and no JAX. ``quant`` rounds
both operands and the result of every conv, linear layer and attention
product and every activation kept (the benchmark's fp8 control).

The names of the leaves are the program's (``swin_gan_shapes``): the head
``head<C>``, then ``swin_unetr.`` with MONAI's module names, but for the
transpose convs (``upsample``, as the repo's U-Nets name theirs), the conv
leaves (``conv1.weight``: no ``.conv`` level) and the affine-free norms
(no leaves).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import losses
from portbench.reference.models import (
    Params,
    Quant,
    batch_norm,
    conv,
    discriminator,
    q,
    to_ncdhw,
    to_ndhwc,
    unique_prefix,
)
from portbench.reference.train import AdamW, Record

EPS = 1e-5


# --- the Swin encoder, channels-last ---

def get_window_size(x_size, window_size, shift_size):
    """MONAI's: an axis no larger than the window takes its own size as the
    window and no shift."""
    use_window, use_shift = list(window_size), list(shift_size)
    for i in range(len(x_size)):
        if x_size[i] <= window_size[i]:
            use_window[i] = x_size[i]
            use_shift[i] = 0
    return tuple(use_window), tuple(use_shift)


def window_partition(x, ws):
    """(b, d, h, w, c) → (b·nW, ws0·ws1·ws2, c), MONAI's order."""
    b, d, h, w, c = x.shape
    x = x.view(b, d // ws[0], ws[0], h // ws[1], ws[1], w // ws[2], ws[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).contiguous().view(-1, ws[0] * ws[1] * ws[2], c)


def window_reverse(windows, ws, dims):
    b, d, h, w = dims
    x = windows.view(b, d // ws[0], h // ws[1], w // ws[2], ws[0], ws[1], ws[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).contiguous().view(b, d, h, w, -1)


def compute_mask(dims, ws, sh, device):
    """MONAI's ``compute_mask``: shift regions labelled on the padded grid,
    −100 between tokens of one window in different regions."""
    d, h, w = dims
    img_mask = torch.zeros((1, d, h, w, 1), device=device)
    cnt = 0
    for ds in (slice(-ws[0]), slice(-ws[0], -sh[0]), slice(-sh[0], None)):
        for hs in (slice(-ws[1]), slice(-ws[1], -sh[1]), slice(-sh[1], None)):
            for wsl in (slice(-ws[2]), slice(-ws[2], -sh[2]), slice(-sh[2], None)):
                img_mask[:, ds, hs, wsl, :] = cnt
                cnt += 1
    mask_windows = window_partition(img_mask, ws).squeeze(-1)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, -100.0).masked_fill(attn_mask == 0, 0.0)


def relative_position_index(window: int, device) -> torch.Tensor:
    """MONAI's index for a window³ window (built once for the configured
    window, sliced ``[:n, :n]`` where a stage clamps it)."""
    coords = torch.stack(torch.meshgrid(*[torch.arange(window)] * 3, indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 2] += window - 1
    rel[:, :, 0] *= (2 * window - 1) * (2 * window - 1)
    rel[:, :, 1] *= 2 * window - 1
    return rel.sum(-1).to(device)


def layer_norm(x, weight=None, bias=None):
    """Over the last dim, biased variance, eps 1e-5; affine where given."""
    var, mean = torch.var_mean(x, dim=-1, correction=0, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + EPS)
    return y if weight is None else y * weight + bias


def linear(x, w, b, quant: Quant = None):
    y = q(x, quant) @ q(w, quant).t()
    return q(y if b is None else y + b, quant)


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def window_attention(p: Params, pre: str, x, mask, heads: int, window: int, quant: Quant):
    """MONAI's ``WindowAttention.forward`` on (b·nW, n, c) windows."""
    b, n, c = x.shape
    qkv = linear(x, p[f"{pre}.qkv.weight"], p[f"{pre}.qkv.bias"], quant)
    qkv = qkv.reshape(b, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    qh, kh, vh = qkv[0], qkv[1], qkv[2]
    qh = qh * (c // heads) ** -0.5
    attn = q(q(qh, quant) @ q(kh, quant).transpose(-2, -1), quant)
    index = relative_position_index(window, x.device)[:n, :n].reshape(-1)
    rpb = p[f"{pre}.relative_position_bias_table"][index].reshape(n, n, -1).permute(2, 0, 1)
    attn = attn + rpb.unsqueeze(0)
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.view(b // nw, nw, heads, n, n) + mask.unsqueeze(1).unsqueeze(0)
        attn = attn.view(-1, heads, n, n)
    attn = q(torch.softmax(attn, dim=-1), quant)
    out = q(attn @ q(vh, quant), quant).transpose(1, 2).reshape(b, n, c)
    return linear(out, p[f"{pre}.proj.weight"], p[f"{pre}.proj.bias"], quant)


def swin_block(p: Params, pre: str, x, mask, heads: int, window: int, shift: int,
               quant: Quant):
    """MONAI's ``SwinTransformerBlock.forward`` (drop rates 0)."""
    shortcut = x
    b, d, h, w, c = x.shape
    y = q(layer_norm(x, p[f"{pre}.norm1.weight"], p[f"{pre}.norm1.bias"]), quant)
    ws, sh = get_window_size((d, h, w), (window,) * 3, (shift,) * 3)
    pad_d1 = (ws[0] - d % ws[0]) % ws[0]
    pad_b = (ws[1] - h % ws[1]) % ws[1]
    pad_r = (ws[2] - w % ws[2]) % ws[2]
    y = F.pad(y, (0, 0, 0, pad_r, 0, pad_b, 0, pad_d1))
    _, dp, hp, wp, _ = y.shape
    if any(i > 0 for i in sh):
        y = torch.roll(y, shifts=(-sh[0], -sh[1], -sh[2]), dims=(1, 2, 3))
        attn_mask = mask
    else:
        attn_mask = None
    windows = window_partition(y, ws)
    out = window_attention(p, f"{pre}.attn", windows, attn_mask, heads, window, quant)
    y = window_reverse(out.view(-1, *(ws + (c,))), ws, (b, dp, hp, wp))
    if any(i > 0 for i in sh):
        y = torch.roll(y, shifts=sh, dims=(1, 2, 3))
    y = y[:, :d, :h, :w, :]
    x = shortcut + y
    z = q(layer_norm(x, p[f"{pre}.norm2.weight"], p[f"{pre}.norm2.bias"]), quant)
    z = q(gelu(linear(z, p[f"{pre}.mlp.linear1.weight"], p[f"{pre}.mlp.linear1.bias"], quant)),
          quant)
    return x + linear(z, p[f"{pre}.mlp.linear2.weight"], p[f"{pre}.mlp.linear2.bias"], quant)


def patch_merging(p: Params, pre: str, x, quant: Quant):
    """MONAI's ``PatchMerging`` (v0.9): x5 repeats x2 and x6 repeats x3."""
    b, d, h, w, c = x.shape
    if h % 2 or w % 2 or d % 2:
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
    x0 = x[:, 0::2, 0::2, 0::2, :]
    x1 = x[:, 1::2, 0::2, 0::2, :]
    x2 = x[:, 0::2, 1::2, 0::2, :]
    x3 = x[:, 0::2, 0::2, 1::2, :]
    x4 = x[:, 1::2, 0::2, 1::2, :]
    x5 = x[:, 0::2, 1::2, 0::2, :]
    x6 = x[:, 0::2, 0::2, 1::2, :]
    x7 = x[:, 1::2, 1::2, 1::2, :]
    x = torch.cat([x0, x1, x2, x3, x4, x5, x6, x7], -1)
    x = q(layer_norm(x, p[f"{pre}.norm.weight"], p[f"{pre}.norm.bias"]), quant)
    return linear(x, p[f"{pre}.reduction.weight"], None, quant)


def basic_layer(p: Params, pre: str, x, depth: int, heads: int, window: int, quant: Quant):
    """MONAI's ``BasicLayer`` on channels-last x: the mask on the padded
    grid, the blocks (odd ones shifted), patch merging."""
    b, d, h, w, c = x.shape
    shift = window // 2
    ws, sh = get_window_size((d, h, w), (window,) * 3, (shift,) * 3)
    dp, hp, wp = (int(math.ceil(s / k)) * k for s, k in zip((d, h, w), ws))
    mask = compute_mask((dp, hp, wp), ws, sh, x.device)
    for i in range(depth):
        x = swin_block(p, f"{pre}.blocks.{i}", x, mask, heads, window,
                       0 if i % 2 == 0 else shift, quant)
    return patch_merging(p, f"{pre}.downsample", x, quant)


def swin_encoder(p: Params, pre: str, x, cfg: dict, quant: Quant) -> List[torch.Tensor]:
    """MONAI's ``SwinTransformer.forward(x, normalize=True)`` on NCDHW x:
    the five hidden states, channels-last, each through the affine-free
    LayerNorm of ``proj_out``."""
    s = cfg["swin"]
    x0 = to_ndhwc(conv(x, p[f"{pre}.patch_embed.weight"], p[f"{pre}.patch_embed.bias"],
                       s["patch_size"], 0, quant))
    outs, h = [x0], x0
    for i, (depth, heads) in enumerate(zip(s["depths"], s["num_heads"])):
        h = basic_layer(p, f"{pre}.layers{i + 1}", h, depth, heads, s["window_size"], quant)
        outs.append(h)
    return [q(layer_norm(t), quant) for t in outs]


# --- the UNETR blocks, NCDHW ---

def instance_norm(x):
    """Affine-free InstanceNorm3d: biased moments over (d, h, w)."""
    var, mean = torch.var_mean(x, dim=(2, 3, 4), correction=0, keepdim=True)
    return (x - mean) * torch.rsqrt(var + EPS)


def res_block(p: Params, pre: str, x, quant: Quant):
    """MONAI's ``UnetResBlock``: convs without bias, affine-free norms,
    LeakyReLU 0.01; the residual through conv3/norm3 where it exists."""
    out = conv(x, p[f"{pre}.conv1.weight"], None, 1, 1, quant)
    out = q(F.leaky_relu(q(instance_norm(out), quant), 0.01), quant)
    out = conv(out, p[f"{pre}.conv2.weight"], None, 1, 1, quant)
    out = q(instance_norm(out), quant)
    residual = x
    if f"{pre}.conv3.weight" in p:
        residual = q(instance_norm(conv(x, p[f"{pre}.conv3.weight"], None, 1, 0, quant)), quant)
    return q(F.leaky_relu(out + residual, 0.01), quant)


def up_block(p: Params, pre: str, x, skip, quant: Quant):
    """MONAI's ``UnetrUpBlock``: transpose conv (no bias), concat (up,
    skip), residual block."""
    up = q(F.conv_transpose3d(q(x, quant), q(p[f"{pre}.upsample.weight"], quant), None,
                              stride=2), quant)
    return res_block(p, f"{pre}.conv_block", torch.cat((up, skip), dim=1), quant)


def swin_unetr(p: Params, x, cfg: dict, quant: Quant = None, pre: str = "swin_unetr."):
    """MONAI's ``SwinUNETR.forward`` on NCDHW x (normalize on)."""
    hs = [to_ncdhw(t) for t in swin_encoder(p, f"{pre}swin", x, cfg, quant)]
    enc0 = res_block(p, f"{pre}encoder1", x, quant)
    enc1 = res_block(p, f"{pre}encoder2", hs[0], quant)
    enc2 = res_block(p, f"{pre}encoder3", hs[1], quant)
    enc3 = res_block(p, f"{pre}encoder4", hs[2], quant)
    dec4 = res_block(p, f"{pre}encoder10", hs[4], quant)
    dec3 = up_block(p, f"{pre}decoder5", dec4, hs[3], quant)
    dec2 = up_block(p, f"{pre}decoder4", dec3, enc3, quant)
    dec1 = up_block(p, f"{pre}decoder3", dec2, enc2, quant)
    dec0 = up_block(p, f"{pre}decoder2", dec1, enc1, quant)
    out = up_block(p, f"{pre}decoder1", dec0, enc0, quant)
    return conv(out, p[f"{pre}out.weight"], p[f"{pre}out.bias"], quant=quant)


def generator(p: Params, x, cfg: dict, train: bool, quant: Quant = None):
    """The GAN's generator with the SwinUNETR backbone on NDHWC ``x``: the
    modality's 1³ ConvBlock head (conv, BatchNorm, LeakyReLU(disc slope)),
    then the SwinUNETR."""
    head = unique_prefix(p, ".bn.running_mean")
    h = conv(to_ncdhw(x), p[f"{head}.conv.weight"], p[f"{head}.conv.bias"], quant=quant)
    h = q(F.leaky_relu(q(batch_norm(h, p, f"{head}.bn", train), quant),
                       cfg["disc_negative_slope"]), quant)
    return to_ndhwc(swin_unetr(p, h, cfg, quant))


# --- the leaves ---

def _res_leaves(out: dict, pre: str, cin: int, cout: int) -> None:
    out[f"{pre}.conv1.weight"] = (cout, cin, 3, 3, 3)
    out[f"{pre}.conv2.weight"] = (cout, cout, 3, 3, 3)
    if cin != cout:
        out[f"{pre}.conv3.weight"] = (cout, cin, 1, 1, 1)


def swin_unetr_shapes(out: dict, cin: int, cout: int, s: dict, pre: str = "swin_unetr."
                      ) -> None:
    """The SwinUNETR's leaves → shapes, in the program's order."""
    fs, window, patch = s["feature_size"], s["window_size"], s["patch_size"]
    out[f"{pre}swin.patch_embed.weight"] = (fs, cin, patch, patch, patch)
    out[f"{pre}swin.patch_embed.bias"] = (fs,)
    for i, (depth, heads) in enumerate(zip(s["depths"], s["num_heads"])):
        dim, stage = fs * 2 ** i, f"{pre}swin.layers{i + 1}"
        hidden = int(dim * s["mlp_ratio"])
        for j in range(depth):
            blk = f"{stage}.blocks.{j}"
            for name, shape in (("norm1.weight", (dim,)), ("norm1.bias", (dim,)),
                                ("attn.relative_position_bias_table",
                                 ((2 * window - 1) ** 3, heads)),
                                ("attn.qkv.weight", (3 * dim, dim)), ("attn.qkv.bias", (3 * dim,)),
                                ("attn.proj.weight", (dim, dim)), ("attn.proj.bias", (dim,)),
                                ("norm2.weight", (dim,)), ("norm2.bias", (dim,)),
                                ("mlp.linear1.weight", (hidden, dim)),
                                ("mlp.linear1.bias", (hidden,)),
                                ("mlp.linear2.weight", (dim, hidden)),
                                ("mlp.linear2.bias", (dim,))):
                out[f"{blk}.{name}"] = shape
        out[f"{stage}.downsample.norm.weight"] = (8 * dim,)
        out[f"{stage}.downsample.norm.bias"] = (8 * dim,)
        out[f"{stage}.downsample.reduction.weight"] = (2 * dim, 8 * dim)
    _res_leaves(out, f"{pre}encoder1", cin, fs)
    for name, c in (("encoder2", fs), ("encoder3", 2 * fs), ("encoder4", 4 * fs),
                    ("encoder10", 16 * fs)):
        _res_leaves(out, f"{pre}{name}", c, c)
    for name, c in (("decoder5", 16 * fs), ("decoder4", 8 * fs), ("decoder3", 4 * fs),
                    ("decoder2", 2 * fs), ("decoder1", fs)):
        o = c // 2 if name != "decoder1" else fs
        out[f"{pre}{name}.upsample.weight"] = (c, o, 2, 2, 2)
        _res_leaves(out, f"{pre}{name}.conv_block", 2 * o, o)
    out[f"{pre}out.weight"] = (cout, fs, 1, 1, 1)
    out[f"{pre}out.bias"] = (cout,)


def swin_gan_shapes(cfg: dict) -> Tuple[Dict[str, tuple], Dict[str, tuple]]:
    """The generator's (1³ head + SwinUNETR) and the PatchGAN's leaves
    (parameters and BatchNorm statistics) → shapes, named as the program's
    ``state_dict`` names them."""
    head = f"head{cfg['in_channels']}"
    c = cfg["unet_in_channels"]
    gen = {f"{head}.conv.weight": (c, cfg["in_channels"], 1, 1, 1), f"{head}.conv.bias": (c,)}
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        gen[f"{head}.bn.{leaf}"] = (c,)
    swin_unetr_shapes(gen, c, cfg["out_channels"], cfg["swin"])
    disc: dict = {}
    chans = [cfg["in_channels"] + cfg["out_channels"]] + list(cfg["disc_features"])
    for i in range(1, len(chans)):
        name = f"d1_{head}" if i == 1 else f"d{i}"
        disc[f"{name}.conv.weight"] = (chans[i], chans[i - 1], 4, 4, 4)
        disc[f"{name}.conv.bias"] = (chans[i],)
        if i > 1:
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                disc[f"{name}.bn.{leaf}"] = (chans[i],)
    disc["final.weight"] = (1, chans[-1], 1, 1, 1)
    disc["final.bias"] = (1,)
    return gen, disc


# --- the GAN's steps ---

def gan_steps(gen_p: Params, disc_p: Params, gen_train: Sequence[str],
              disc_train: Sequence[str], batches, cfg: dict, tcfg: dict,
              quant: Quant = None) -> Record:
    """``len(batches)`` GAN steps (``reference.train.gan_steps``'s order and
    losses: G's loss and AdamW step, the fake drawn again by the updated
    generator without a gradient, D's loss and AdamW step) with the
    SwinUNETR generator; no dropout anywhere (its rates are 0)."""
    gp = {k: v.detach().float().clone() for k, v in gen_p.items()}
    dp = {k: v.detach().float().clone() for k, v in disc_p.items()}
    for d, names in ((gp, gen_train), (dp, disc_train)):
        d.update({k: d[k].detach().clone().requires_grad_(True) for k in names})
    opts = [AdamW({k: gp[k] for k in gen_train}, tcfg["lr"], tcfg["b1"], tcfg["b2"],
                  tcfg["weight_decay"]),
            AdamW({k: dp[k] for k in disc_train}, tcfg["lr"], tcfg["b1"], tcfg["b2"],
                  tcfg["weight_decay"])]
    start = {**{f"gen.{k}": gp[k].detach().clone() for k in gen_train},
             **{f"disc.{k}": dp[k].detach().clone() for k in disc_train}}
    out = Record([], {}, {})
    for i, (x, y) in enumerate(batches):
        x, y = x.float(), y.float()
        y_hat = generator(gp, x, cfg, True, quant)
        for v in dp.values():
            v.requires_grad_(False)
        g_loss = (losses.bce_with_logits(discriminator(dp, x, y_hat, cfg, quant), 1.0)
                  + tcfg["recon_factor"] * losses.l1(y_hat, y))
        g_loss.backward()
        grads = {f"gen.{k}": gp[k].grad.norm().item() for k in gen_train}
        del y_hat
        opts[0].step()
        for k in disc_train:
            dp[k].requires_grad_(True)
        with torch.no_grad():
            y_fake = generator(gp, x, cfg, True, quant)
        logits_hat = discriminator(dp, x, y_fake, cfg, quant)
        logits_real = discriminator(dp, x, y, cfg, quant)
        d_loss = (losses.bce_with_logits(logits_real, 1.0)
                  + losses.bce_with_logits(logits_hat, 0.0)) / 2.0
        d_loss.backward()
        grads.update({f"disc.{k}": dp[k].grad.norm().item() for k in disc_train})
        opts[1].step()
        if i == 0:
            out.grad1 = grads
        out.losses.append([g_loss.item(), d_loss.item()])
    now = {**{f"gen.{k}": gp[k] for k in gen_train}, **{f"disc.{k}": dp[k] for k in disc_train}}
    out.delta = {k: (now[k].detach() - start[k]).norm().item() for k in start}
    return out

