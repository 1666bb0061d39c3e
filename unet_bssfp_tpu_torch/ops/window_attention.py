"""Window attention of the Swin encoder (``models/swin_unetr.py``):
``softmax(q·kᵀ·d^-½ + bias)·v`` over every window and head of a block in
one call of ``F.scaled_dot_product_attention``.

The bias is one additive tensor a call, in ``q``'s dtype: the block's
relative-position bias, gathered from its table, plus the stage's shift mask
where the block is shifted. It broadcasts over the batch dim, and where it
requires a gradient SDPA returns one (the bias table takes its gradient
through it). On the card SDPA picks its fused kernel (the memory-efficient
one takes an additive bias and its gradient); on the CPU its own.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """``q``, ``k``, ``v``: (G, H, N, d), where G·H enumerates (image,
    window, head); ``bias``: (1, H, N, N) in ``q``'s dtype, the same for
    every g. Returns (G, H, N, d). A call on a CUDA tensor counts one
    launch in ``window_attention.launches`` (its backward is autograd's)."""
    if q.device.type == "cuda":
        window_attention.launches += 1
    return F.scaled_dot_product_attention(q, k, v, attn_mask=bias)


window_attention.launches = 0
