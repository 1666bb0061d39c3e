#!/usr/bin/env python3
"""Where the wgmma weight-gradient kernel's time goes: the kernel with parts of
its work switched off, at the training step's and the mesh backward's heaviest
shapes.

  python scripts/torch_port_wgrad_ablation.py [--iters 10]

Builds ``csrc/conv3x3_wgrad_wgmma.cu`` as it stands and as variants, each a
copy of the source with one or more statements removed (under
``unet_bssfp_tpu_torch/_build/ablation/``), and times each launch of the
kernel and its split sum (CUDA events, median of three rounds of ``--iters``
calls) on bf16 operands at B 8 × 64³ (96 → 32 and 32 → 32) and at a
D_local-32 halo shard (96 → 32):

- ``base``: the kernel (its result is the reference of ``equal``);
- ``base_3_stages``: the same with a ring of 3 stages instead of the plan's;
- ``no_build``: without building the next item's dy copy rows during the
  products (a run's first item still builds all four);
- ``no_mma``: without the wgmma products;
- ``neither``: without both: what the loads, barriers and sums take;
- ``neither_no_dy`` / ``neither_no_x``: ``neither`` without the dy loads of a
  following item / without the x loads.

Only ``base`` computes dW. Prints one JSON line per (shape, variant).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from unet_bssfp_tpu_torch.ops.kernels import _build  # noqa: E402
from unet_bssfp_tpu_torch.ops.kernels import wgrad_wgmma as G  # noqa: E402

SRC = (_build.CSRC / "conv3x3_wgrad_wgmma.cu").read_text()
BUILD = "build_copies(base + s1 * STAGE_BYTES + X_BYTES, copies, next, 2);"
MMA = """        wgmma_tile<N>(acc, desc_sw128(x_s + r * X_ROW_BYTES + k * 32),
                      desc_sw128(b_s[r] + k * 32));"""
DY = "  tma_load_5d(dst + X_BYTES + DY_HALF, dymap, bar, w0 - 8, h0 + 1, 0, t.d, t.b);"
X = """    tma_load_5d(dst + r * X_ROW_BYTES, xmap, bar, w0, blockIdx.x * p.cpk, t.d - 1 + p.halo,
                h0 + r, t.b);"""
TX = "ROWS * 3 * p.cpk * 128 + (follows ? DY_HALF : DY_BYTES)"
SHAPES = ((8, 64, 0, 96), (8, 64, 0, 32), (8, 32, 1, 96))  # (B, D, halo, Cin), 64², Cout 32


def variants() -> dict:
    for text in (BUILD, MMA, DY, X, TX):
        if text not in SRC:
            raise RuntimeError(f"the kernel source no longer holds {text!r}")
    neither = SRC.replace(BUILD, "").replace(MMA, ";")
    return {"base": SRC, "no_build": SRC.replace(BUILD, ""), "no_mma": SRC.replace(MMA, ";"),
            "neither": neither,
            "neither_no_dy": neither.replace(DY, "").replace(
                TX, "ROWS * 3 * p.cpk * 128 + (follows ? 0 : DY_HALF)"),
            "neither_no_x": neither.replace(X, ";").replace(TX, "(follows ? DY_HALF : DY_BYTES)")}


def build(name: str, src: str) -> ctypes.CDLL:
    out = _build.BUILD_DIR / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{name}.cu", out / f"{name}.so"
    cu.write_text(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
                    str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.conv3x3_wgrad_wgmma_bf16.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_longlong, ctypes.c_void_p])
    lib.conv3x3_wgrad_wgmma_bf16.restype = ctypes.c_int
    return lib


def ms(fn, iters: int) -> float:
    rounds = []
    for _ in range(3):
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        rounds.append(start.elapsed_time(end) / iters)
    return statistics.median(rounds)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_port_wgrad_ablation: no CUDA device", file=sys.stderr)
        return 2
    libs = {name: build(name, src) for name, src in variants().items()}
    card = torch.cuda.get_device_name(0)
    for b, d, halo, cin in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(cin + d)
        xk = torch.randn(b, d + 2 * halo, cin, 4096, device="cuda", generator=g).bfloat16()
        dy = torch.randn(b, d, 32, 4096, device="cuda", generator=g).bfloat16()
        plan = G.wgrad_plan(b, d, halo, cin, 32, 64, 64)
        part = torch.empty(plan.splits, 27 * cin * 32, device="cuda")
        out = torch.empty(27 * cin * 32, device="cuda")
        ref = None
        runs = [(name, lib, plan.stages) for name, lib in libs.items()]
        runs.insert(1, ("base_3_stages", libs["base"], 3))
        for name, lib, stages in runs:
            def call(lib=lib, stages=stages):
                rc = lib.conv3x3_wgrad_wgmma_bf16(
                    xk.data_ptr(), dy.data_ptr(), part.data_ptr(), out.data_ptr(), plan.b,
                    plan.d, plan.halo, plan.cin, plan.cout, plan.h, plan.wdim, plan.cpk,
                    plan.chunks, stages, plan.splits, plan.per,
                    torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"{name}: launch returned {rc}")
            call()
            torch.cuda.synchronize()
            if ref is None:
                ref = out.clone()
            print(json.dumps({"device": card, "shape": [b, d, cin, 64 * 64], "halo": halo,
                              "cout": 32, "variant": name, "ms": ms(call, args.iters),
                              "equal_to_base": bool(torch.equal(out, ref))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
