#!/usr/bin/env python3
"""The host cost of K9a's launch path (``ops/kernels/probe.py:lane_roll``)
on the card, part by part, beside ``torch.roll``.

  python scripts/torch_port_launch_cost.py [--root DIR] [--calls 10000]

Each part is timed with ``time.perf_counter`` over ``--calls`` calls after
a warm-up and reported in µs per call: the wrapper's steps as the wrapper
before the launch helper took them (``_lib()``, ``torch.empty_like``, the
``with torch.cuda.device`` switch, ``torch.cuda.current_stream()``, the
``ctypes`` launch, ``_build.check``); the two ways to the current stream's
raw handle (``torch.cuda.current_stream(i).cuda_stream`` and PyTorch's
private ``torch._C._cuda_getCurrentRawStream(i)``) and ``_build.launch``,
which the wrapper takes now; and whole calls: the wrapper, ``torch.roll``,
and 200 back-to-back calls of each between CUDA events (the smoke's
per-call time: the medians of 7 alternating runs, and the quartiles of
their ratios). ``--root`` imports the package from another checkout (the
parent's, for a comparison in one call); parts that checkout lacks are
left out. Prints one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time


def per_call_us(fn, calls: int) -> float:
    for _ in range(100):
        fn()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) * 1e6 / calls


def events_us(torch, fn, calls: int = 200) -> float:
    fn()
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / calls


def _enter_exit(ctx):
    """A ``with`` block around nothing: enter and leave."""
    ctx.__enter__()
    ctx.__exit__(None, None, None)


def measure(calls: int) -> dict:
    import torch

    from unet_bssfp_tpu_torch.ops import kernels as K
    from unet_bssfp_tpu_torch.ops.kernels import _build, probe

    x = torch.randn(8, 128, device="cuda")
    dev, index = x.device, x.get_device()
    lib = probe._lib()
    fn = lib.lane_roll_f32
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    parts = {
        "x.device": lambda: x.device,
        "checks (dim, dtype, contiguous)": lambda: (x.dim() != 2 or x.dtype != torch.float32
                                                    or not x.is_contiguous()),
        "_lib()": probe._lib,
        "torch.empty_like": lambda: torch.empty_like(x),
        "with torch.cuda.device(x.device)": lambda: _enter_exit(torch.cuda.device(dev)),
        "torch.cuda.current_stream().cuda_stream": lambda: torch.cuda.current_stream().cuda_stream,
        "torch.cuda.current_stream(i).cuda_stream":
            lambda: torch.cuda.current_stream(index).cuda_stream,
        "torch.cuda.current_device()": torch.cuda.current_device,
        "data_ptr x2": lambda: (x.data_ptr(), y.data_ptr()),
        "ctypes launch": lambda: fn(x.data_ptr(), y.data_ptr(), 8, 128, 1, stream),
        "_build.check": lambda: _build.check(lib, 0, "lane_roll"),
        "lane_roll (whole wrapper)": lambda: K.lane_roll(x, 1),
        "torch.roll": lambda: torch.roll(x, 1, 1),
    }
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        parts["torch._C._cuda_getCurrentRawStream(i)"] = lambda: raw(index)
    if hasattr(_build, "launch"):
        parts["_build.launch (handle + ctypes launch)"] = lambda: _build.launch(
            fn, x, x.data_ptr(), y.data_ptr(), 8, 128, 1)
    out = {"per_call_us": {}, "events_us_200_calls": {}}
    for name, part in parts.items():
        out["per_call_us"][name] = per_call_us(part, calls)
        torch.cuda.synchronize()
    if raw is not None:
        side = torch.cuda.Stream()
        with torch.cuda.stream(side):
            out["raw_handle_is_public_handle_on_a_side_stream"] = (
                raw(index) == torch.cuda.current_stream(index).cuda_stream == side.cuda_stream)
    runs = [(events_us(torch, lambda: K.lane_roll(x, 1)),
             events_us(torch, lambda: torch.roll(x, 1, 1))) for _ in range(7)]
    for i, name in enumerate(("lane_roll", "torch.roll")):
        out["events_us_200_calls"][name] = statistics.median(r[i] for r in runs)
    out["events_us_200_calls"]["runs"] = runs
    out["events_us_200_calls"]["ratio_quartiles"] = statistics.quantiles(
        [a / b for a, b in runs], n=4)
    out["lane_roll_correct"] = bool(torch.equal(K.lane_roll(x, 1), torch.roll(x, 1, 1)))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parser.add_argument("--calls", type=int, default=10_000)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("torch_port_launch_cost: no CUDA device", file=sys.stderr)
        return 2
    result = {"root": args.root, "device": torch.cuda.get_device_name(0),
              "calls": args.calls, **measure(args.calls)}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
