#!/usr/bin/env python3
"""Times of the packed conv kernels (K1, K1's dgrad, K2) at the training
step's shapes, for comparing two checkouts on one card.

  python scripts/torch_port_conv_times.py [--root CHECKOUT] [--iters 20]

Imports ``unet_bssfp_tpu_torch`` from ``--root`` (default: this checkout),
builds its kernels there, and prints one JSON line: CUDA-event ms per call
of ``conv3x3_packed``, ``conv3x3_packed_dgrad`` and ``conv3x3_wgrad`` in bf16
at B 8 × 64³ for the convs 24 → 32, 32 → 32 and 96 → 32, each the median of
three rounds of ``--iters`` calls; where the checkout has the halo kernels
(K5), also theirs at a shard of that batch (B 8 × D_local 32 × 64²); where
it has the pfold kernels (K7a, K7b), also those on the same volumes folded
(and their halo forms at the shard);
where it has the ``mma.sync`` loop's check-only entry point
(``conv3x3_packed_mma``, beside the wgmma kernel that K1 and K5 take), also
that loop's forward and dgrad at the same shapes; where it has the weight
gradient's ``mma.sync`` loop as a check-only entry point
(``conv3x3_wgrad_mma``, beside the wgmma kernel that K2 and K5's wgrad
take), also that loop's SAME and halo forms; where its
``conv3x3_packed`` takes ``wguard``, also the guarded forms (K1W and its
dgrad) at row width 66 (2 zero guard columns, as ``guard_cols`` gives them)
for the same three convs, with ``convolution_backward``'s dx on the
unguarded tensors beside the dgrad, and K1W and K1 at 96 → 32 on the whole
volume (1 × 96 × 128², row width 130). To
compare a parent commit with a change, unpack the parent (``git archive``)
into a directory and run: parent, change, change, parent, all inside one
job on one card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import statistics
import sys
from pathlib import Path


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args()
    sys.path.insert(0, args.root)

    import torch

    if not torch.cuda.is_available():
        print("torch_port_conv_times: no CUDA device", file=sys.stderr)
        return 2
    from unet_bssfp_tpu_torch.ops import kernels as K

    def ms(fn):
        rounds = []
        for _ in range(3):
            fn()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(args.iters):
                fn()
            end.record()
            torch.cuda.synchronize()
            rounds.append(start.elapsed_time(end) / args.iters)
        return statistics.median(rounds)

    b, d, w = 8, 64, 64
    out = {"root": args.root, "device": torch.cuda.get_device_name(0)}
    g = torch.Generator(device="cuda").manual_seed(0)
    for cin in (24, 32, 96):
        xk = torch.randn(b, d, cin, w * w, device="cuda", generator=g).bfloat16()
        dy = torch.randn(b, d, 32, w * w, device="cuda", generator=g).bfloat16()
        wt = torch.randn(3, 3, 3, cin, 32, device="cuda", generator=g) / (27 * cin) ** 0.5
        bias = torch.zeros(32, device="cuda")
        out[f"{cin}->32"] = {
            "conv3x3_packed": ms(lambda: K.conv3x3_packed(xk, wt, bias, w)),
            "conv3x3_packed_dgrad": ms(lambda: K.conv3x3_packed_dgrad(dy, wt, w)),
            "conv3x3_wgrad": ms(lambda: K.conv3x3_wgrad(xk, dy, w))}
        if hasattr(K, "conv3x3_wgrad_halo"):
            xp, dyh = xk[:, :d // 2 + 2].contiguous(), dy[:, :d // 2].contiguous()
            out[f"{cin}->32"].update({
                "conv3x3_packed_halo": ms(lambda: K.conv3x3_packed_halo(xp, wt, bias, w)),
                "conv3x3_packed_halo_dgrad": ms(
                    lambda: K.conv3x3_packed_halo_dgrad(dyh, wt, w)),
                "conv3x3_wgrad_halo": ms(lambda: K.conv3x3_wgrad_halo(xp, dyh, w))})
        if hasattr(K, "conv3x3_packed_mma"):
            from unet_bssfp_tpu_torch.ops.kernels.conv3d import _flip_t
            wf, zero = _flip_t(wt, torch.bfloat16), torch.zeros(cin, device="cuda")
            out[f"{cin}->32"].update({
                "conv3x3_packed_mma": ms(lambda: K.conv3x3_packed_mma(xk, wt, bias, w)),
                "conv3x3_packed_mma_dgrad": ms(
                    lambda: K.conv3x3_packed_mma(dy, wf, zero, w))})
        if hasattr(K, "conv3x3_wgrad_mma"):
            out[f"{cin}->32"].update({
                "conv3x3_wgrad_mma": ms(lambda: K.conv3x3_wgrad_mma(xk, dy, w)),
                "conv3x3_wgrad_mma_halo": ms(lambda: K.conv3x3_wgrad_mma(xp, dyh, w, 1))})
        if hasattr(K, "conv3x3_pfold"):
            xf, dyf = (K.fold4_pack(K.unpack_hw(t, w)) for t in (xk, dy))
            xpf, dyhf = xf[:, :d // 2 + 2].contiguous(), dyf[:, :d // 2].contiguous()
            out[f"{cin}->32"].update({
                "conv3x3_pfold": ms(lambda: K.conv3x3_pfold(xf, wt, bias, w // 4)),
                "conv3x3_pfold_dgrad": ms(lambda: K.conv3x3_pfold_dgrad(dyf, wt, w // 4)),
                "conv3x3_pfold_wgrad": ms(lambda: K.conv3x3_pfold_wgrad(xf, dyf, w // 4)),
                "conv3x3_pfold_halo": ms(lambda: K.conv3x3_pfold_halo(xpf, wt, bias, w // 4)),
                "conv3x3_pfold_halo_dgrad": ms(
                    lambda: K.conv3x3_pfold_halo_dgrad(dyhf, wt, w // 4)),
                "conv3x3_pfold_wgrad_halo": ms(
                    lambda: K.conv3x3_pfold_wgrad_halo(xpf, dyhf, w // 4))})
    if "wguard" in inspect.signature(K.conv3x3_packed).parameters:
        out["guarded"] = guarded_times(torch, K, ms, g)
    print(json.dumps(out))
    return 0


def guarded_times(torch, K, ms, g):
    """K1W and its dgrad (2 guard columns a row, zero in the inputs) at the
    training step's convs, cuDNN's dx beside the dgrad; K1W and K1 at the
    whole volume's 96 → 32."""
    out = {}
    gc = 2
    for b, d, h, w, cin in ((8, 64, 64, 64, 24), (8, 64, 64, 64, 32), (8, 64, 64, 64, 96),
                            (1, 96, 128, 128, 96)):
        wd = w + gc
        xk = K.guard_mask(torch.randn(b, d, cin, h * wd, device="cuda", generator=g).bfloat16(),
                          wd, gc).contiguous()
        dy = K.guard_mask(torch.randn(b, d, 32, h * wd, device="cuda", generator=g).bfloat16(),
                          wd, gc).contiguous()
        wt = torch.randn(3, 3, 3, cin, 32, device="cuda", generator=g) / (27 * cin) ** 0.5
        bias = torch.zeros(32, device="cuda")
        row = {"conv3x3_packed_wguard": ms(lambda: K.conv3x3_packed(xk, wt, bias, wd, gc))}
        if b == 1:
            xu = K.strip_guards(xk, wd, gc)
            row["conv3x3_packed"] = ms(lambda: K.conv3x3_packed(xu, wt, bias, w))
            out[f"whole {cin}->32"] = row
            continue
        dyn = K.strip_guards(dy, wd, gc).reshape(b, d, 32, h, w).permute(0, 2, 1, 3, 4).contiguous()
        xn = torch.empty(b, cin, d, h, w, device="cuda", dtype=torch.bfloat16)
        wn = wt.bfloat16().permute(4, 3, 0, 1, 2).contiguous()
        row.update({
            "conv3x3_packed_dgrad_wguard": ms(lambda: K.conv3x3_packed_dgrad(dy, wt, wd, gc)),
            "convolution_backward_dx": ms(lambda: torch.ops.aten.convolution_backward(
                dyn, xn, wn, None, [1, 1, 1], [1, 1, 1], [1, 1, 1], False, [0, 0, 0], 1,
                [True, False, False]))})
        out[f"{cin}->32"] = row
    return out


if __name__ == "__main__":
    sys.exit(main())
