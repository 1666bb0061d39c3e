"""Host-side prefetch and fan-out (the port's own copy of
``unet_bssfp_tpu/data/queue.py``): NIfTI reads and writes run in background
threads, and a batch stream runs ahead of its consumer in one thread, so
device work does not wait on I/O."""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Callable, Iterable, Iterator, Optional


class PrefetchIterator:
    """Wrap an iterator; a daemon thread stays ``size`` items ahead. An
    exception the wrapped iterator raises reaches the consumer, at the item
    where it was raised."""

    _DONE = object()

    def __init__(self, it: Iterable, size: int = 2):
        self._queue: "queue.Queue" = queue.Queue(maxsize=size)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, args=(iter(it),),
                                        daemon=True)
        self._thread.start()

    def _worker(self, it: Iterator) -> None:
        try:
            for item in it:
                self._queue.put(item)
        except BaseException as e:  # handed to the consumer, re-raised there
            self._err = e
        finally:
            self._queue.put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._DONE:
            # the sentinel stays for a consumer that asks again
            self._queue.put(self._DONE)
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def parallel_map(fn: Callable, items, num_workers: int = 8, ordered: bool = True):
    """Thread-pool map for IO-bound work (NIfTI loads). Mirrors the
    reference's loader parallelism knob (num_workers=8,
    ``src/data_module.py:15``). With ``ordered`` the results are in the
    order of ``items``; without it, in the order the calls finish (with one
    worker, the order of ``items``). An exception of ``fn`` is raised to
    the caller."""
    if num_workers <= 1:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(max_workers=num_workers) as ex:
        if ordered:
            return list(ex.map(fn, items))
        return [f.result() for f in as_completed([ex.submit(fn, x) for x in items])]
