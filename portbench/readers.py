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
- ``trace``: :func:`portbench.trace.summarise` of the traced window
  (``name_s``: device seconds by each kernel's full name; ``group_s``: by
  ``groups.json``'s groups), or None where the run was not traced or the
  trace held no device work;
- ``spans``: :func:`portbench.spans.attribute` of the traced window, the
  program's ``bssfp.*`` spans an item; None untraced;
- ``launches``: launches an item of each of the program's kernel wrappers
  in the traced window (``ops/kernels.launches()``, by wrapper name);
  None untraced;
- ``cfg``, ``traffic``: the cell's configuration and traffic mix;
- ``model_flops``, ``conv_flops``: per item (``portbench/flops.py``);
- ``work``: the cell driver's ``kernel_work(cfg, traffic)``, ``{}`` where
  it has none: a name to ``{"keys": [...], "flops": f, "bytes": b}``, the
  least operations and bytes an item of the kernels whose names hold one
  of ``keys``;
- ``peak_flops``: the device's bf16 peak, ``peak_bandwidth``: its memory's
  bytes a second (``peaks.json``), or None.

A reader returns its number, or None where it finds nothing to read: the
metric is then left out of the line.
"""

from __future__ import annotations

import statistics
from typing import Callable, Optional, Sequence, Union

from portbench import spans, trace

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


def kernel_ms(kind: str, keys: Sequence[str]) -> Reader:
    """Device ms an item of the kernels whose full names hold one of
    ``keys``; None where the traced window has none."""
    def fn(ctx, t):
        s = _kernel_s(t, keys)
        return 1e3 * s / t["items"] if s > 0 else None
    return _traced(kind, fn)


def kernel_roofline(kind: str, work: Union[str, Callable[[dict, dict], Optional[dict]]]
                    ) -> Reader:
    """A kernel's share of its roofline, in %: its least time on the device,
    max(flops / ``peak_flops``, bytes / ``peak_bandwidth``), over the device
    time of the kernels it names. ``work`` is a name in ``ctx["work"]`` (the
    cell driver's ``kernel_work``), or a function of the cell's
    configuration and traffic that returns such an entry (a metric file of
    its own, for a cell whose driver declares none). None where the cell
    declares no such work, the window holds none of its kernels, or a peak
    that it needs is unknown."""
    def fn(ctx, t):
        w = ctx["work"].get(work) if isinstance(work, str) else work(ctx["cfg"], ctx["traffic"])
        if not w:
            return None
        s = _kernel_s(t, w["keys"]) / t["items"]
        need = [(n, rate) for n, rate in ((w["flops"], ctx["peak_flops"]),
                                          (w["bytes"], ctx["peak_bandwidth"])) if n > 0]
        if s <= 0 or not need or not all(rate for _, rate in need):
            return None
        return 100.0 * max(n / rate for n, rate in need) / s
    return _traced(kind, fn)


def _kernel_s(t: dict, keys: Sequence[str]) -> float:
    return sum(v for name, v in t["name_s"].items() if any(k in name for k in keys))


def _spanned(kind: str, fn) -> Reader:
    def read(ctx):
        table = ctx["spans"]
        return fn(table) if ctx["kind"] == kind and table and table["spans"] else None
    return read


def phase_ms(kind: str, suffix: str) -> Reader:
    """Device ms an item that the program's ``bssfp.*.<suffix>`` spans
    launched (:func:`portbench.spans.phase_ms`)."""
    return _spanned(kind, lambda table: spans.phase_ms(table, suffix) if any(
        n.endswith("." + suffix) for n in table["spans"]) else None)


def span_ms(kind: str, name: str) -> Reader:
    """Device ms an item that the program's span ``name`` launched."""
    return _spanned(kind, lambda table: spans.span_ms(table, name)
                    if name in table["spans"] else None)


def syncs(kind: str) -> Reader:
    """Calls an item that wait for the device inside the program's spans."""
    return _spanned(kind, spans.syncs)


def coverage(kind: str) -> Reader:
    """The share of the traced window's device time that the item's phases
    (:func:`portbench.spans.phase_names`) launched, in %."""
    def fn(table):
        share = spans.coverage(table, spans.phase_names(table, kind))
        return None if share is None else 100.0 * share
    return _spanned(kind, fn)


def launches(kind: str, *counters: str) -> Reader:
    """Launches an item of the program's kernel wrappers ``counters``
    together, from its own counters in the traced window."""
    def read(ctx):
        got = ctx["launches"]
        if ctx["kind"] != kind or got is None or any(c not in got for c in counters):
            return None
        return sum(got[c] for c in counters)
    return read
