"""Tracing (counterpart of ``unet_bssfp_tpu/utils/profiling.py``):
``torch.profiler`` traces in Chrome's format (open in Perfetto), and the
program's own spans in them.

:func:`span` names a phase of the program's work. Under a running
profiler it is ``torch.profiler.record_function``: a ``user_annotation``
event on the same clock as the device's kernels, copies and runtime
calls, so a kernel is credited to the phase whose host interval holds its
launch, and an idle gap of the device to the phase the host was in.
Without a profiler it costs one flag check. The spans, and where they sit:

- ``bssfp.step``: a whole train step (``train/steps.py::make_train_step``,
  ``train/multistage.py::make_supervised_train_step``);
- ``bssfp.gen.forward`` / ``.loss`` / ``.backward`` / ``.optimizer``: the
  GAN step's generator phase: ``gen(x)`` and ``disc(x, ŷ)``; the batch
  losses; ``zero_grad`` and the backward; the update (the replicas'
  gradient reduce, AdamW, the broadcast);
- ``bssfp.disc.forward`` / ``.loss`` / ``.backward`` / ``.optimizer``: its
  discriminator phase: the recomputed (or reused, detached) fake and both
  ``disc`` calls; then as the generator's;
- ``bssfp.net.forward`` / ``.loss`` / ``.backward`` / ``.optimizer``: the
  supervised step (PRETRAIN, TRANSFER, FINE_TUNE): ``net(x)``; L1 + SSIM
  [+ perceptual]; then as the GAN's;
- ``bssfp.extract``: ``data/sampler.py::extract_patches``, a patch stack;
- ``bssfp.predict``: ``train/steps.py::make_predict_fn``, the eval-mode
  forward;
- ``bssfp.stitch``: ``data/sampler.py::GridAggregator.stitch``, one volume;
- ``bssfp.data_wait``: ``train/loop.py::Trainer.fit``, the wait for the
  next train batch.

No span sits inside a block, a layer or a kernel wrapper: a step launches
some thousands of kernels, and each would pay the check.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.autograd import profiler as _autograd_profiler

_NO_SPAN = contextlib.nullcontext()


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


def span(name: str):
    """``with span('bssfp.gen.forward'): ...``: a ``record_function`` range
    while a profiler runs, else one shared null context (``record_function``
    itself costs some µs a call with no profiler running)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(name)
