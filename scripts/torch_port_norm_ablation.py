#!/usr/bin/env python3
"""Where K4's time goes (``csrc/norm_act.cu``): the kernel with parts of its
work cut off, the tile floor of its plan swept, and the card's own fill and
copy of the same bytes beside them.

  python scripts/torch_port_norm_ablation.py [--iters 30]

Builds ``csrc/norm_act.cu`` as it stands and as variants, each a copy of the
source with a ``return`` or a store removed (under
``unet_bssfp_tpu_torch/_build/ablation/``), and times each launch on the
card (``torch.profiler``, after three warm-up launches) at the 8 plain-layer
stage shapes of serving under ``use_pallas`` in bf16, and at the two heaviest
in f32:

- ``base``: the kernel; ``max_abs_err`` is its distance from the plain
  version;
- ``phase_1``: returns before the first grid barrier: the loads, the kept
  rows and the tiles' sums;
- ``phase_2``: returns before the second: with the merge of the sums and
  the centred second moments;
- ``barrier``: returns right after the second barrier;
- ``no_store``: phase 3 without its stores of y (the merges, the reads of
  the kept and the re-read rows and the arithmetic stay);
- ``unroll_8``: the kernel with batches of 8 rows in flight instead of 4;
- ``kept_first``: phase 3 writing the kept rows before the rows it reads
  again (the kernel takes those first, while L2 still holds them);
- ``min_tile=B``: ``base`` on the plan with a tile floor of B bytes (the
  plan's is ``norm_act.MIN_TILE_BYTES``), at the four small stages;
- ``fill`` / ``copy``: ``y.fill_`` and ``y.copy_(x)`` on the stage's tensor:
  what the card writes, and reads and writes, in this run.

Prints one JSON line per (shape, dtype, variant), with the card's name and
power limit. Needs a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from unet_bssfp_tpu_torch.ops.kernels import _build  # noqa: E402
from unet_bssfp_tpu_torch.ops.kernels import norm_act as NA  # noqa: E402

SRC = (_build.CSRC / "norm_act.cu").read_text()
BARRIER = "  grid.sync();\n"
STORE = "out[rr * cvec] = apply<VEC>(v[u], mean, mul, add, p.slope);"
UNROLL = "constexpr int UNROLL = 4;"
AGAIN_FIRST = "      // the rows read again first: the last ones phase 2 read, likely still in L2\n"
KEPT_LOOP = "      for (int r = lane; r < keep; r += step) {"
TILE_END = "    }\n    slot += m.rows;\n  }\n}"
SHAPES = [(n,) + tuple(s >> level for s in base) + (c,)
          for n, base in ((8, (32, 32, 32)), (1, (48, 64, 64)))
          for level, c in enumerate((64, 128, 256, 512))]


def variants() -> dict:
    if (SRC.count(BARRIER) != 2 or SRC.count(STORE) != 2 or SRC.count(UNROLL) != 1
            or SRC.count(AGAIN_FIRST) != 1):
        raise RuntimeError("the kernel source no longer holds two barriers, two stores of y, "
                           "its batch size and phase 3's loop order")
    first = SRC.index(BARRIER)
    second = SRC.index(BARRIER, first + 1)

    def cut(at):
        return SRC[:at] + "  return;\n" + SRC[at:]

    again = SRC.index(AGAIN_FIRST)
    kept = SRC.index(KEPT_LOOP, again)
    end = SRC.index(TILE_END, kept)
    kept_first = (SRC[:again] + SRC[kept:end] + SRC[again + len(AGAIN_FIRST):kept]
                  + SRC[end:])
    return {"base": SRC, "phase_1": cut(first), "phase_2": cut(second),
            "kept_first": kept_first,
            "barrier": cut(second + len(BARRIER)),
            "unroll_8": SRC.replace(UNROLL, "constexpr int UNROLL = 8;"),
            # keep the arithmetic: store only a value no input gives
            "no_store": SRC.replace(STORE, "{ const P o = apply<VEC>(v[u], mean, mul, add, p.slope);"
                                    " if (to_f(o.v[0]) == 1.2345e-38f) out[rr * cvec] = o; }")}


def build(sources: dict) -> dict:
    """One nvcc per variant, all at once; the loaded libraries by name."""
    out_dir = _build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src = out_dir / f"norm_act_{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o",
             str(out_dir / f"norm_act_{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"norm_act_{name}.so"))
        lib.norm_act.argtypes = ([ctypes.POINTER(NA.NormPlanC)] + [ctypes.c_void_p] * 5
                                 + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        libs[name] = lib
    return libs


def device_ms(fn, iters: int) -> float:
    """Device time per call of every kernel ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.device_time_total for e in prof.key_averages()
                if e.device_type.name == "CUDA")
    return total / 1e3 / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True
                          ).stdout.strip().splitlines()[0]
    libs = build(variants())
    sms, optin = NA._device(0)
    stream = torch.cuda.current_stream().cuda_stream
    cases = [(shape, torch.bfloat16) for shape in SHAPES] + [
        (shape, torch.float32) for shape in SHAPES[:1] + SHAPES[4:5]]
    for shape, dtype in cases:
        n, c = shape[0], shape[-1]
        s = shape[1] * shape[2] * shape[3]
        bf16 = dtype == torch.bfloat16
        g = torch.Generator(device="cuda").manual_seed(c)
        x = torch.randn(shape, device="cuda", generator=g).to(dtype)
        scale = 1 + 0.1 * torch.randn(c, device="cuda", generator=g)
        bias = 0.1 * torch.randn(c, device="cuda", generator=g)
        y = torch.empty_like(x)
        occupancy = lambda vec, threads, smem: NA._blocks_per_sm(0, bf16, vec, threads, smem)  # noqa: E731
        plan = NA.norm_plan(n, s, c, bf16, sms, occupancy, optin)
        runs = [(name, plan) for name in libs]
        if plan.grid < sms // 2:
            runs += [(f"min_tile={b}", NA.norm_plan(n, s, c, bf16, sms, occupancy, optin, 16, b))
                     for b in (8192, 16384, 65536) if b != NA.MIN_TILE_BYTES]
        for name, p in runs:
            lib = libs.get(name, libs["base"])
            part = torch.empty(p.workspace, device="cuda")
            cp = p.as_c()

            def fn():
                rc = lib.norm_act(ctypes.byref(cp), x.data_ptr(), scale.data_ptr(),
                                  bias.data_ptr(), y.data_ptr(), part.data_ptr(), 0.1, 1e-5,
                                  stream)
                if rc:
                    raise RuntimeError(f"{name}: CUDA error {rc}")

            row = {"card": card, "shape": list(shape), "dtype": str(dtype).split(".")[1],
                   "variant": name, "k": p.k, "grid": p.grid, "smem_rows": p.smem_rows,
                   "device_ms": device_ms(fn, args.iters)}
            if name == "base" or name.startswith("min_tile"):
                fn()
                row["max_abs_err"] = float((y.float() - NA.instance_norm_leaky_relu_plain(
                    x, scale, bias, 0.1).float()).abs().max())
            print(json.dumps(row), flush=True)
        for name, fn in (("fill", lambda: y.fill_(1.0)), ("copy", lambda: y.copy_(x))):
            print(json.dumps({"card": card, "shape": list(shape),
                              "dtype": str(dtype).split(".")[1], "variant": name,
                              "device_ms": device_ms(fn, args.iters)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
