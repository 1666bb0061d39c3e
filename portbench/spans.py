"""The program's own spans in a profiler trace, per phase of a step or
request.

The program names its phases with ``record_function`` ranges
(``bssfp.*``: ``unet_bssfp_tpu_torch/utils/profiling.py`` lists them),
``user_annotation`` events on the same clock as the device's kernels,
copies and CUDA runtime calls. :func:`attribute` credits each device
operation of the traced window to the innermost program span, on any host
thread, that holds the start of the runtime or driver call that launched
it (the two share a ``correlation`` id): the backward's kernels are
launched from autograd's thread while the main thread is in
``bssfp.*.backward``, so the match is by time, not by thread. A traced run
of ``portbench.run`` hands the table to the metric readers
(``ctx["spans"]``).

    python -m portbench.spans --workload <name> --seed <n> --seconds <s>

runs the cell as ``python -m portbench.run ... --trace 1`` does, then
prints the per-span table and the window's idle gaps (named by
:func:`portbench.trace.summarise`) to standard error and one JSON line to
standard output: the table, the phases' sums (``phases``), the share of
device time they hold (``coverage``) and the run's own result line
(``result``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from portbench import trace

PREFIX = "bssfp."
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}
# Host calls that wait for the device.
BLOCKING = ("cudaDeviceSynchronize", "cudaStreamSynchronize", "cudaEventSynchronize",
            "cudaMemcpy", "cudaFree")
# The phases a training step's spans end in, and serving's spans.
TRAIN_PHASES = ("forward", "loss", "backward", "optimizer")
SERVE_SPANS = ("bssfp.extract", "bssfp.predict", "bssfp.stitch")

Span = Tuple[float, float, str]


def _x(events: List[dict], cats) -> List[dict]:
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cats]


def _window(events: List[dict]) -> Optional[Tuple[float, float]]:
    for e in _x(events, {"user_annotation"}):
        if e.get("name") == trace.WINDOW:
            return float(e["ts"]), float(e["ts"]) + float(e["dur"])
    return None


def _spans(events: List[dict]) -> List[Span]:
    """The program's spans."""
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), str(e["name"]))
            for e in _x(events, {"user_annotation"}) if str(e.get("name", "")).startswith(PREFIX)]


def _device(events: List[dict], w0: float, w1: float) -> List[Tuple[float, float, dict]]:
    """The device operations that overlap the window, clipped to it."""
    out = []
    for e in _x(events, trace.DEVICE_CATS):
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        if b > w0 and a < w1:
            out.append((max(a, w0), min(b, w1), e))
    return out


def _innermost(spans: List[Span], a: float, b: float) -> Optional[str]:
    """The name of the shortest span that holds ``[a, b]``."""
    best = None
    for s0, s1, name in spans:
        if s0 <= a and b <= s1 and (best is None or s1 - s0 < best[0]):
            best = (s1 - s0, name)
    return best[1] if best else None


def attribute(events: List[dict], items: int) -> Optional[Dict]:
    """Per program span name and per item: ``device_s`` and ``ops`` (the
    device operations it launched, clipped to the window), ``blocking``
    (calls of :data:`BLOCKING` whose host interval lies in it) and
    ``host_s`` (its own host time, taken under the profiler); beside them
    ``device_s`` of the whole window and ``uncredited_s``, both per item.
    None where the trace holds no window."""
    window = _window(events)
    if window is None:
        return None
    w0, w1 = window
    spans = [s for s in _spans(events) if s[1] > w0 and s[0] < w1]
    table: Dict[str, Dict[str, float]] = {}

    def row(name: str) -> Dict[str, float]:
        return table.setdefault(name, {"device_s": 0.0, "ops": 0, "blocking": 0,
                                       "host_s": 0.0})

    for a, b, name in spans:
        row(name)["host_s"] += (min(b, w1) - max(a, w0)) / 1e6
    launches = {}
    for e in _x(events, LAUNCH_CATS):
        corr = e.get("args", {}).get("correlation")
        if corr is not None:
            launches[corr] = float(e["ts"])
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if e.get("name") in BLOCKING and w0 <= a and b <= w1:
            name = _innermost(spans, a, b)
            if name is not None:
                row(name)["blocking"] += 1
    total = uncredited = 0.0
    for a, b, e in _device(events, w0, w1):
        us = b - a
        total += us
        launched = launches.get(e.get("args", {}).get("correlation"))
        name = None if launched is None else _innermost(spans, launched, launched)
        if name is None:
            uncredited += us
            continue
        r = row(name)
        r["device_s"] += us / 1e6
        r["ops"] += 1
    per_item = {name: {k: v / items for k, v in r.items()} for name, r in sorted(table.items())}
    return {"items": items, "spans": per_item, "device_s": total / 1e6 / items,
            "uncredited_s": uncredited / 1e6 / items}


def phase_ms(table: Dict, suffix: str) -> float:
    """Device ms an item credited to the spans named ``bssfp.*.<suffix>``
    (``forward``: the generator's and the discriminator's together)."""
    return 1e3 * sum(r["device_s"] for name, r in table["spans"].items()
                     if name.endswith("." + suffix))


def span_ms(table: Dict, name: str) -> float:
    """Device ms an item credited to the span ``name``."""
    return 1e3 * table["spans"].get(name, {}).get("device_s", 0.0)


def syncs(table: Dict) -> float:
    """Blocking calls an item inside the program's spans."""
    return sum(r["blocking"] for r in table["spans"].values())


def coverage(table: Dict, names: List[str]) -> Optional[float]:
    """The share of the window's device time an item that ``names`` hold."""
    if table["device_s"] <= 0:
        return None
    return sum(table["spans"].get(n, {}).get("device_s", 0.0) for n in names) / table["device_s"]


def phase_names(table: Dict, kind: str) -> List[str]:
    """The spans that make up an item's phases: in ``train`` those named
    ``bssfp.*.<phase>`` for the phases of :data:`TRAIN_PHASES`, in
    ``serve`` :data:`SERVE_SPANS`."""
    if kind == "train":
        return [n for n in table["spans"] if n.rsplit(".", 1)[-1] in TRAIN_PHASES]
    return list(SERVE_SPANS)


def report(table: Dict, kind: str) -> Dict:
    """The phases' sums an item: training's four phases and blocking calls,
    or serving's three spans; the share of device time they hold."""
    if kind == "train":
        out = {f"{p}_ms": phase_ms(table, p) for p in TRAIN_PHASES}
    else:
        out = {f"{n[len(PREFIX):]}_ms": span_ms(table, n) for n in SERVE_SPANS}
    out.update(syncs=syncs(table), coverage=coverage(table, phase_names(table, kind)),
               uncredited_ms=1e3 * table["uncredited_s"], device_ms=1e3 * table["device_s"])
    return out


def _print_table(table: Dict, gaps: List[Tuple[str, float]]) -> None:
    print(f"program spans an item ({table['items']} items; host ms taken under the profiler):",
          file=sys.stderr)
    print(f"  {'span':<24}{'device ms':>12}{'device ops':>12}{'blocking':>10}{'host ms':>10}",
          file=sys.stderr)
    for name, r in table["spans"].items():
        print(f"  {name:<24}{1e3 * r['device_s']:>12.3f}{r['ops']:>12.1f}"
              f"{r['blocking']:>10.1f}{1e3 * r['host_s']:>10.3f}", file=sys.stderr)
    print(f"  uncredited device ms {1e3 * table['uncredited_s']:.3f} of "
          f"{1e3 * table['device_s']:.3f}", file=sys.stderr)
    print("idle gaps (ms): " + ", ".join(f"{k} {1e3 * v:.3f}" for k, v in gaps),
          file=sys.stderr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()

    from portbench import run, spec
    root = Path.cwd().resolve()
    run.cache_env(root)
    import torch

    bench = spec.load_benchmark(root)
    cell = spec.cell(bench, args.workload)
    if not torch.cuda.is_available():
        print("portbench.spans: no CUDA device", file=sys.stderr)
        return 3
    traffic = spec.traffic(cell["traffic"])
    kept = []
    load = trace.load

    def keep(path):
        kept.append(load(path))
        return kept[-1]

    trace.load = keep  # the traced window's events, as the run reads them
    try:
        result = run.run_cell(bench, cell, args.seed, args.seconds, True, "cuda:0", t0, root)
    finally:
        trace.load = load
    table = attribute(kept[-1], traffic["trace_items"]) if kept else None
    if table is None:
        print("portbench.spans: the trace holds no window", file=sys.stderr)
        return 1
    gaps = [tuple(g) for g in result.get("breakdown", {}).get("idle_gaps", [])]
    _print_table(table, gaps)
    kind = "serve" if traffic["kind"] == "serve_cohort" else "train"
    print(json.dumps({"workload": args.workload, "seed": args.seed, "table": table,
                      "phases": report(table, kind), "idle_gaps": gaps, "result": result}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
