"""What the metric readers (``metrics/<name>.py``) share. A reader gets
the run's context, a dict:

- ``kind``: ``train`` or ``serve``; ``units_per_item``: patches a step or
  volumes a request;
- the window (host clock, tracing off): ``items``, ``elapsed_s``,
  ``item_s`` (each item's time: to its synchronise where the cell driver
  synchronises each, else its call), ``setup_s``, ``peak_bytes``
  (``max_memory_allocated`` over the window; None off CUDA);
- ``host_s``: in a traced run, each of a few items' calls until they
  returned, each synchronised before the next (empty otherwise);
- ``trace``: :func:`portbench.trace.summarise` of the traced window, or
  None where the run was not traced or the trace held no device work;
- ``model_flops``, ``conv_flops``: per item (``portbench/flops.py``);
  ``peak_flops``: the device's bf16 peak (``peaks.json``), or None.

A reader returns its number, or None where it finds nothing to read: the
metric is then left out of the line.
"""

from __future__ import annotations

import statistics
from typing import Callable, Optional

from portbench import trace

Reader = Callable[[dict], Optional[float]]


def rate(kind: str) -> Reader:
    """Units completed over the window's whole time."""
    def read(ctx):
        if ctx["kind"] != kind:
            return None
        return ctx["items"] * ctx["units_per_item"] / ctx["elapsed_s"]
    return read


def item_ms_quantile(kind: str, q: int) -> Reader:
    """The ``q``-th percentile of the items' times, over every item."""
    def read(ctx):
        if ctx["kind"] != kind or len(ctx["item_s"]) < 2:
            return None
        return 1e3 * statistics.quantiles(ctx["item_s"], n=100, method="inclusive")[q - 1]
    return read


def peak_gib(ctx) -> Optional[float]:
    return None if ctx["peak_bytes"] is None else ctx["peak_bytes"] / 2 ** 30


def setup_s(ctx) -> Optional[float]:
    return ctx["setup_s"]


def host_ms(kind: str) -> Reader:
    """Mean host milliseconds from an item's call to its return."""
    def read(ctx):
        if ctx["kind"] != kind or not ctx["host_s"]:
            return None
        return 1e3 * statistics.fmean(ctx["host_s"])
    return read


def _traced(kind: str, fn) -> Reader:
    def read(ctx):
        t = ctx["trace"]
        return fn(ctx, t) if ctx["kind"] == kind and t is not None else None
    return read


def device_ops(kind: str) -> Reader:
    """Device kernels, copies and fills per item in the traced window."""
    return _traced(kind, lambda ctx, t: t["ops"] / t["items"])


def eager_ms(kind: str) -> Reader:
    """Device ms per item in the eager groups (ATen elementwise, reductions,
    copies) of ``groups.json``."""
    return _traced(kind, lambda ctx, t: 1e3 * sum(
        t["group_s"].get(g, 0.0) for g in trace.GROUPS["eager"]) / t["items"])


def conv_roofline(kind: str) -> Reader:
    """The least time of the item's 3³ and 4³ convs at the bf16 peak over
    the device time of every conv group, in %."""
    def fn(ctx, t):
        conv_s = sum(t["group_s"].get(g, 0.0) for g in trace.GROUPS["conv"]) / t["items"]
        if not ctx["peak_flops"] or conv_s <= 0:
            return None
        return 100.0 * ctx["conv_flops"] / ctx["peak_flops"] / conv_s
    return _traced(kind, fn)


def mfu(kind: str) -> Reader:
    """Model FLOPs completed over the window's time at the bf16 peak, in %."""
    def read(ctx):
        if ctx["kind"] != kind or not ctx["peak_flops"]:
            return None
        return 100.0 * ctx["items"] * ctx["model_flops"] / ctx["elapsed_s"] / ctx["peak_flops"]
    return read


def idle_share(kind: str) -> Reader:
    """The share of the window's wall time that no device operation
    covers, in %: one minus the traced busy seconds an item over the
    untraced window's seconds an item. (The traced window's own idle share,
    ``device.window_s`` against ``busy_s``, also counts the profiler's host
    overhead, which stretches host-bound stretches of a step.)"""
    return _traced(kind, lambda ctx, t: 100.0 * (
        1.0 - (t["busy_s"] / t["items"]) / (ctx["elapsed_s"] / ctx["items"])))
