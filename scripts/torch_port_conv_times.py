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
take), also that loop's SAME and halo forms. To
compare a parent commit with a change, unpack the parent (``git archive``)
into a directory and run: parent, change, change, parent, all inside one
job on one card.
"""

from __future__ import annotations

import argparse
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
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
