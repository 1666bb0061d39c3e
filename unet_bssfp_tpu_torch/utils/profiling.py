"""Tracing and step timing (counterpart of
``unet_bssfp_tpu/utils/profiling.py``): ``torch.profiler`` traces in
Chrome's format (open in Perfetto) and a step timer that waits for the
step's device work."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List

import torch


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the enclosed window into ``log_dir/trace-<time>.json``:
    ``with trace('logs/trace'): run_steps()``. Yields the profiler."""
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=_activities())
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace-{time.strftime('%Y%m%d-%H%M%S')}.json"))


def _devices(out) -> set:
    if isinstance(out, torch.Tensor):
        return {out.device}
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return set().union(*map(_devices, out)) if out else set()
    return set()


class StepTimer:
    """Wall-clock step timing with warm-up steps discarded. Each step ends
    in ``torch.cuda.synchronize`` of the CUDA devices its result lies on, so
    the time is the device's, not the enqueue's."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: List[float] = []
        self._count = 0

    def time_step(self, fn, *args, **kwargs):
        start = time.perf_counter()
        out = fn(*args, **kwargs)
        for dev in _devices(out):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        elapsed = time.perf_counter() - start
        self._count += 1
        if self._count > self.warmup:
            self.times.append(elapsed)
        return out

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        ts = sorted(self.times)
        return {"mean_s": sum(ts) / len(ts), "median_s": ts[len(ts) // 2],
                "min_s": ts[0], "max_s": ts[-1], "steps": len(ts)}
