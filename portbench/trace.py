"""The reduction of a profiler trace to what the per-layer readers read.

Input: the events of a ``torch.profiler`` Chrome trace (``traceEvents``).
Device work is every complete event of category ``kernel``, ``gpu_memcpy``
or ``gpu_memset``; host spans are the benchmark's own ``record_function``
ranges (``user_annotation`` events named ``portbench.*``) and the
program's (``bssfp.*``). The traced window is the span named
``portbench.window``; everything is clipped to it.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
WINDOW = "portbench.window"
SPAN_PREFIXES = ("portbench.", "bssfp.")
GROUPS = json.loads((Path(__file__).with_name("groups.json")).read_text())


def group_of(name: str) -> str:
    """The kernel's group: the first of ``groups.json`` with a key in the name."""
    for group, keys in GROUPS["groups"]:
        if any(k in name for k in keys):
            return group
    return "other"


def _union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def summarise(events: List[dict], items: int) -> Optional[Dict]:
    """Busy and window seconds, device ops, seconds by group and by the
    full name of each kernel, copy or fill (``name_s``), the device ops
    that took most time and the longest idle gaps (labelled by the
    innermost span of the benchmark's or the program's on the host at the
    gap's start), for a window of ``items`` steps or chunks. None where the
    trace holds no window or no device event in it."""
    spans = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith(SPAN_PREFIXES)]
    windows = [e for e in spans if e["name"] == WINDOW]
    if not windows:
        return None
    w0 = float(windows[0]["ts"])
    w1 = w0 + float(windows[0]["dur"])
    dev = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        if b <= w0 or a >= w1:
            continue
        dev.append((max(a, w0), min(b, w1), str(e.get("name", ""))))
    if not dev:
        return None
    merged = _union((a, b) for a, b, _ in dev)
    busy_us = sum(b - a for a, b in merged)
    by_group: Dict[str, float] = {}
    by_name: Dict[str, float] = {}
    by_label: Dict[str, float] = {}
    for a, b, name in dev:
        g = group_of(name)
        by_group[g] = by_group.get(g, 0.0) + (b - a) / 1e6
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
        key = f"{g}: {name}"[:96]
        by_label[key] = by_label.get(key, 0.0) + (b - a) / 1e6
    gaps = []
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    inner = [e for e in spans if e["name"] != WINDOW]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            gaps.append((_label(inner, a), (b - a) / 1e6))
    gaps.sort(key=lambda g: -g[1])
    top = sorted(by_label.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy_us / 1e6, "items": items,
            "ops": len(dev), "group_s": by_group, "name_s": by_name,
            "device_ops": [[k, v] for k, v in top], "idle_gaps": [[k, v] for k, v in gaps[:10]]}


def _label(spans: List[dict], t: float) -> str:
    """The name of the shortest span that holds host time ``t``: a
    benchmark span's without ``portbench.``, a program span's whole;
    ``host`` where none does."""
    best = None
    for e in spans:
        a = float(e["ts"])
        b = a + float(e["dur"])
        if a <= t <= b and (best is None or b - a < best[0]):
            best = (b - a, e["name"])
    if best is None:
        return "host"
    return best[1].removeprefix("portbench.")


def load(path: str) -> List[dict]:
    """The events of an exported Chrome trace."""
    with open(path) as f:
        return json.load(f)["traceEvents"]
