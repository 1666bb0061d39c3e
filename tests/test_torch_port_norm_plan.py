"""K4's launch plan (``ops/kernels/norm_act.py:norm_plan``) without a card:
every (sample, row, channel) in exactly one tile, the tiles within the
card's shared memory and resident at once, and a float32 model of the
kernel's sums in the plan's order (``csrc/norm_act.cu``) against the JAX
package's Pallas kernel in interpret mode. The kernel itself is held to its
plain version on the card in ``test_torch_port_gpu.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_bssfp_tpu.ops.pallas.fused_norm_act import (
    fused_instance_norm_leaky_relu as jax_fused_in_lrelu,
)
from unet_bssfp_tpu_torch.ops.kernels import norm_act

torch.set_num_threads(1)

SMS = 132


def h100_blocks_per_sm(vec, threads, smem):
    """An H100's occupancy for a CTA of ``threads`` threads (≤ 64 registers
    each under the kernel's launch bounds) and ``smem`` bytes of dynamic
    shared memory: 2048 threads, 228 KB (1 KB of it reserved per CTA)."""
    return min(2048 // threads, 233472 // (smem + 1024), 32)


# The plain-layer stages of serving under use_pallas, (B, S, C): patch mode
# (B 8, 32³ … 4³) and whole volume (B 1, 48×64² … 6×8²).
SERVING = [(n, (d >> lv) * (h >> lv) * (w >> lv), c)
           for n, (d, h, w) in ((8, (32, 32, 32)), (1, (48, 64, 64)))
           for lv, c in enumerate((64, 128, 256, 512))]
ODD = [(1, 1, 3), (8, 1, 24), (3, 7, 3), (2, 7, 24), (1, 513, 24), (5, 513, 3),
       (7, 27, 40), (1, 5, 4100), (1, 3, 8200)]


def _plan(n, s, c, bf16, sms=SMS, align=16, optin=norm_act.SMEM_OPTIN,
          occupancy=h100_blocks_per_sm, min_tile=norm_act.MIN_TILE_BYTES):
    return norm_act.norm_plan(n, s, c, bf16, sms, occupancy, optin, align, min_tile)


def _check_plan(p):
    el = 2 if p.bf16 else 4
    seen = np.zeros((p.n, p.s, p.c), np.int32)
    slots = set()
    for b in range(p.grid):
        kept = 0
        for i in p.cta_items(b):
            n, c0, width, r0, rows = p.item(i)
            assert rows >= 1 and 1 <= width <= p.cg and c0 % p.vec == 0 and width % p.vec == 0
            seen[n, r0:r0 + rows, c0:c0 + width] += 1
            chunk = i % p.k
            slot = (n * p.k + chunk, c0)
            assert slot not in slots  # the partials' fixed slot: written once
            slots.add(slot)
            kept += rows
        # the rows a CTA keeps in shared memory, beside the scratch
        assert min(kept, p.smem_rows) * p.cg * el + p.scratch_bytes <= p.smem_bytes
    assert (seen == 1).all()
    # every item is some CTA's, and all CTAs are resident at once
    assert sum(len(list(p.cta_items(b))) for b in range(p.grid)) == p.items
    assert p.grid <= SMS * h100_blocks_per_sm(p.vec, p.threads, p.smem_bytes)
    assert p.smem_bytes <= norm_act.SMEM_OPTIN
    assert p.threads == p.cols * p.lanes <= 512 and p.cg == p.cols * p.vec
    assert p.scratch_bytes % 16 == 0 and p.scratch_bytes >= 4 * max(p.threads * p.vec, 2 * p.cg)
    assert p.c % p.vec == 0 and 16 % (p.vec * el) == 0
    assert p.workspace == 2 * p.n * p.k * p.c


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("n,s,c", SERVING + ODD)
def test_norm_plan_covers_every_element_once(n, s, c, bf16):
    p = _plan(n, s, c, bf16)
    _check_plan(p)
    # the same plan every time: the merge order depends on the shape alone
    assert _plan(n, s, c, bf16) == p


def test_norm_plan_serving_shapes_use_16_byte_vectors_and_fill_the_card():
    """16-byte vectors at every stage; as many tiles as SMs where the tiles
    stay at or over MIN_TILE_BYTES (every CTA merges all k partials of its
    channels, so a small stage takes fewer, larger tiles)."""
    for n, s, c in SERVING:
        for bf16 in (True, False):
            p = _plan(n, s, c, bf16)
            el = 2 if bf16 else 4
            assert p.vec * el == 16 and p.ncg == 1
            assert p.items <= p.grid <= SMS
            # the card is filled unless the tiles would fall under the floor
            tiles = -(-s * c * el // norm_act.MIN_TILE_BYTES)
            assert p.grid > SMS // 2 or p.k == tiles
            assert (s // p.k) * c * el >= norm_act.MIN_TILE_BYTES or p.k == 1
    # the heaviest bf16 stage: 8 samples × 16 chunks of 2048 rows of 128 B;
    # 1688 rows of each stay in shared memory, the rest is read again
    p = _plan(8, 32 ** 3, 64, True)
    assert (p.k, p.grid, p.threads, p.smem_rows) == (16, 128, 512, 1688)


def test_norm_plan_narrows_vectors_to_the_alignment_and_raises_on_empty():
    assert _plan(2, 7, 24, True, align=2).vec == 1
    assert _plan(2, 7, 24, True, align=4).vec == 2
    assert _plan(2, 7, 24, False, align=8).vec == 2
    assert _plan(2, 7, 3, False).vec == 1
    with pytest.raises(ValueError):
        _plan(0, 7, 3, False)
    with pytest.raises(RuntimeError):
        norm_act.norm_plan(1, 7, 3, False, SMS, lambda *a: 0)


def _lane_tree(acc, lanes, lanes_p2):
    st = lanes_p2 // 2
    while st:
        hi = min(st, max(lanes - st, 0))
        acc[:hi] = acc[:hi] + acc[st:st + hi]
        st //= 2
    return acc[0]


def _fma(a, b, c):
    """fma(a, b, c) in float32: the product exact in float64, rounded once
    with the sum (double rounding aside)."""
    return (a.double() * b.double() + c.double()).float()


def _merged(p, parts, nn, c0, w):
    """The kernel's merge of chunk partials parts[nn, :, c0:c0 + w]: summed
    in chunk order, over s."""
    total = torch.zeros(w)
    for kk in range(p.k):
        total = total + parts[nn, kk, c0:c0 + w]
    return total / torch.tensor(float(p.s))


def kernel_model(x, scale, bias, slope, eps, p):
    """csrc/norm_act.cu's arithmetic in float32, in the plan's order: each
    thread sums its rows of a tile in order, the lanes meet in the tree,
    the tiles' partials merge in chunk order; then the same for (x − mean)²
    as one FMA a row against the merged mean; then
    y = fma(x − mean, rsqrt(var + eps)·scale, bias) before the LeakyReLU and
    the cast."""
    n, s, c = p.n, p.s, p.c
    xf = x.float().reshape(n, s, c)
    mean, var = torch.zeros(n, c), torch.zeros(n, c)
    for phase, out in ((0, mean), (1, var)):
        parts = torch.zeros(n, p.k, c)
        for i in range(p.items):
            nn, c0, w, r0, rows = p.item(i)
            tile = xf[nn, r0:r0 + rows, c0:c0 + w]
            acc = torch.zeros(p.lanes, w)
            for start in range(0, rows, p.lanes):
                blk = tile[start:start + p.lanes]
                k = blk.shape[0]
                if phase == 0:
                    acc[:k] = acc[:k] + blk
                else:
                    d = blk - mean[nn, c0:c0 + w]
                    acc[:k] = _fma(d, d, acc[:k])
            parts[nn, i % p.k, c0:c0 + w] = _lane_tree(acc, p.lanes, p.lanes_p2)
        for i in range(p.items):
            nn, c0, w, _, _ = p.item(i)
            out[nn, c0:c0 + w] = _merged(p, parts, nn, c0, w)
    mul = torch.rsqrt(var + eps) * scale.float()
    y = _fma(xf - mean[:, None], mul[:, None], bias.float().expand_as(xf))
    y = torch.where(y >= 0, y, slope * y)
    return y.reshape(x.shape).to(x.dtype)


def _np(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


# test_torch_port_kernels.py::test_fused_norm_act_matches_jax's shapes and
# tolerances, on the H100's plans, on a 5-SM card's with no tile floor
# (several chunks a sample) and on a one-CTA card's (every tile in one CTA,
# in turn)
@pytest.mark.parametrize("shape,slope", [((2, 8, 8, 8, 128), 0.1),
                                         ((1, 4, 4, 4, 24), 0.2),
                                         ((2, 4, 4, 4, 64), 0.1)])
@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("card", ["h100", "5 SMs", "one CTA"])
def test_kernel_model_matches_jax(shape, slope, dtype, atol, card):
    rng = np.random.default_rng(11)
    c = shape[-1]
    x, scale, bias = _np(rng, shape), _np(rng, (c,)), _np(rng, (c,))
    ref = jax_fused_in_lrelu(jnp.asarray(x).astype(dtype), jnp.asarray(scale),
                             jnp.asarray(bias), slope, interpret=True)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    n, s = shape[0], int(np.prod(shape[1:-1]))
    bf16 = dtype == "bfloat16"
    p = {"h100": lambda: _plan(n, s, c, bf16),
         "5 SMs": lambda: _plan(n, s, c, bf16, sms=5, min_tile=1),
         "one CTA": lambda: _plan(n, s, c, bf16, sms=1, occupancy=lambda *a: 1)}[card]()
    assert p.k > 1 if card == "5 SMs" else True
    assert p.grid == 1 and p.items == n if card == "one CTA" else True
    got = kernel_model(xt, torch.from_numpy(scale), torch.from_numpy(bias), slope, 1e-5, p)
    assert got.dtype == xt.dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=atol)


@pytest.mark.parametrize("n,s,c", [(1, 1, 3), (3, 7, 3), (1, 513, 24), (2, 5, 4100)])
def test_kernel_model_matches_plain_at_odd_shapes(n, s, c):
    """S 1 (the variance is 0: y is the bias), C 3 and 24, S 513 on a
    3-SM plan (chunks of 171 rows), two channel groups."""
    g = torch.Generator().manual_seed(s + c)
    x = torch.randn(n, s, 1, 1, c, generator=g)
    scale, bias = torch.randn(c, generator=g), torch.randn(c, generator=g)
    p = _plan(n, s, c, False, sms=3, min_tile=1)
    torch.testing.assert_close(kernel_model(x, scale, bias, 0.1, 1e-5, p),
                               norm_act.instance_norm_leaky_relu_plain(x, scale, bias),
                               rtol=1e-5, atol=1e-4)
