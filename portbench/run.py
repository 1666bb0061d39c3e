"""Run one cell of the benchmark once and print its result line.

    python -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the program (``unet_bssfp_tpu_torch``),
on a machine with the CUDA devices the cell asks for. Set-up is timed from
this module's first line to the first timed step; the window then runs the
cell's closed loop for ``--seconds`` (host clock, a synchronise after each
step or request). ``--trace 1`` follows the window with a short profiled
one and reports the per-layer metrics instead of the end-to-end ones. Last,
the program's state is freed and what the timed path produced is compared
with the plain reference (``portbench/reference``).

The last line on standard output is the result, one JSON object; the
numbers compared, each beside its limit, are the last lines on standard
error and the result's last key, ``checks``. The exit code is not 0, and no
result is printed, without enough CUDA devices, without the program in the
checkout, or where ``jax``, ``jaxlib``, ``flax`` or ``unet_bssfp_tpu`` was
loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, Optional, Tuple  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "unet_bssfp_tpu")
PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def cache_env(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program builds its CUDA libraries into its own ``_build``)."""
    base = root / "portbench" / ".cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv"), ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        os.makedirs(base / sub, exist_ok=True)
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that the harness must not load,
    compared whole (``unet_bssfp_tpu_torch`` is not ``unet_bssfp_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def peak(device_name: str, key: str) -> Optional[float]:
    """``peaks.json``'s ``key`` (``bf16_flops_per_s``, ``hbm_bytes_per_s``,
    ...) for the device, or None for a device it does not list."""
    entry = PEAKS["devices"].get(device_name)
    return entry[key] if entry else None


def _num(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else str(x)


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, traced: bool, device,
             t0: float, root: Optional[Path] = None, fault: Optional[str] = None,
             cfg: Optional[dict] = None, traffic: Optional[dict] = None) -> Dict:
    """Set up, measure and check ``cell`` once; returns the result's fields.
    ``cfg``/``traffic`` stand in for the cell's files, ``fault`` breaks the
    timed path (the tests' use; the command line sets neither)."""
    import torch

    from portbench import check, spec
    from portbench.drivers import common

    cfg = cfg or spec.config(bench, cell["config"], root)
    traffic = traffic or spec.traffic(cell["traffic"])
    drv = spec.driver(traffic["kind"])
    cuda = torch.device(device).type == "cuda"
    a = time.perf_counter()
    c = drv.setup(cfg, traffic, seed, device, fault)
    setup_s = time.perf_counter() - t0
    setup_driver_s = time.perf_counter() - a
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    items, item_s = 0, []
    start = time.perf_counter()
    while True:
        a = time.perf_counter()
        c.item(items)
        if c.sync_each:
            common.sync(device)
        e = time.perf_counter()
        item_s.append(e - a)
        items += 1
        if e - start >= seconds:
            break
    common.sync(device)
    elapsed = time.perf_counter() - start
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else None
    print(f"window: {items} items in {elapsed:.3f} s; item s min/median/max "
          f"{min(item_s):.5f}/{statistics.median(item_s):.5f}/{max(item_s):.5f}; "
          f"set-up {setup_s:.2f} s: before the cell driver {setup_s - setup_driver_s:.2f} s, "
          f"the cell driver's {json.dumps(c.phases.seconds)}", file=sys.stderr)

    host_s, summary, span_table, launches = [], None, None, None
    if traced:
        for k in range(traffic["trace_items"]):
            a = time.perf_counter()
            c.item(items + k)
            host_s.append(time.perf_counter() - a)
            common.sync(device)
        summary, span_table, launches = _traced(c, items + len(host_s),
                                                traffic["trace_items"], device, cuda)
    model_flops, conv_flops = drv.flops(cfg, traffic)
    work = drv.kernel_work(cfg, traffic) if hasattr(drv, "kernel_work") else {}
    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    ctx = {"kind": c.kind, "units_per_item": c.units_per_item, "items": items,
           "elapsed_s": elapsed, "item_s": item_s, "host_s": host_s, "setup_s": setup_s,
           "peak_bytes": window_peak, "trace": summary, "spans": span_table,
           "launches": launches, "cfg": cfg, "traffic": traffic, "model_flops": model_flops,
           "conv_flops": conv_flops, "work": work,
           "peak_flops": peak(name, "bf16_flops_per_s"),
           "peak_bandwidth": peak(name, "hbm_bytes_per_s")}

    readings = c.check()
    ok, checks = check.judge(readings, spec.limits(cell["name"]))
    metrics = {}
    for m in spec.metrics_of(bench, cell["name"], "per_layer" if traced else "end_to_end"):
        value = spec.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": name, "count": cell["chips"],
           "memory_peak_bytes": max(setup_peak, window_peak or 0)}
    out = {"correct": ok, "attempted": items, "failed": 0, "metrics": metrics, "device": dev}
    if summary is not None:
        dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    out["checks"] = {k: {"value": _num(v["value"]), "limit": v["limit"]}
                     for k, v in checks.items()}
    return out


def _traced(c, first: int, n: int, device, cuda: bool) -> Tuple[Optional[dict],
                                                                 Optional[dict], dict]:
    """``n`` more steps or requests under ``torch.profiler`` (one before
    them warms the profiler up, outside the traced window): the window
    reduced by :func:`portbench.trace.summarise`, the program's spans by
    :func:`portbench.spans.attribute`, and the launches an item of each of
    the program's own kernel wrappers (``ops/kernels.launches()``; those
    launched also go to standard error)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench import spans, trace
    from portbench.drivers import common
    from unet_bssfp_tpu_torch.ops import kernels

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        c.item(first)
        common.sync(device)
        kernels.reset_launches()
        with record_function(trace.WINDOW):
            for k in range(n):
                c.item(first + 1 + k, annotate=True)
                with record_function("portbench.sync"):
                    common.sync(device)
    counts = {k: v / n for k, v in kernels.launches().items()}
    print("launches per item (the program's own kernels): "
          f"{json.dumps({k: v for k, v in counts.items() if v})}", file=sys.stderr)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = trace.load(path)
    finally:
        os.remove(path)
    return trace.summarise(events, n), spans.attribute(events, n), counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd().resolve()
    cache_env(root)

    import torch

    from portbench import spec

    bench = spec.load_benchmark(root)
    cell = spec.cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {cell['name']} needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 3
    try:
        import unet_bssfp_tpu_torch
    except ImportError as exc:
        print(f"portbench: the program is not in this checkout: {exc}", file=sys.stderr)
        return 3
    if root not in Path(unet_bssfp_tpu_torch.__file__).resolve().parents:
        print(f"portbench: unet_bssfp_tpu_torch loads from {unet_bssfp_tpu_torch.__file__}, "
              f"outside the checkout {root}", file=sys.stderr)
        return 3

    result = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T0,
                      root)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules that must not load were loaded: {bad}", file=sys.stderr)
        return 4
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
