"""Host-side fan-out (the port's own copy of ``parallel_map`` from
``unet_bssfp_tpu/data/queue.py``): NIfTI reads and writes run in background
threads, so device work does not wait on I/O."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable


def parallel_map(fn: Callable, items, num_workers: int = 8):
    """Thread-pool map for IO-bound work (NIfTI loads), results in the order
    of ``items``. Mirrors the reference's loader parallelism knob
    (num_workers=8, ``src/data_module.py:15``)."""
    if num_workers <= 1:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(max_workers=num_workers) as ex:
        return list(ex.map(fn, items))
