"""Bounded worker pool for per-chunk output writes.

Port of dvs_mcemvs_tpu/utils/writers.py.  The full_seq scheduler's save
step -- extraction, device-to-host copies, PNG encoding, point lists -- runs
on a few worker threads with a bounded number in flight, so device work of
later chunks overlaps the host serialization of earlier ones.

Workers' exceptions are re-raised on the submitting thread at the next
submit()/drain(), so a failed write still fails the run.  No failure is
dropped (the JAX pool drops all but one): drain() waits for every pending
save, logs each failure and re-raises the first; on a failing run the pool
cancels the saves not started and logs the failures of those that ran.
"""

from __future__ import annotations

import collections
import logging
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Deque

log = logging.getLogger(__name__)


class SaveWorkerPool:
    """Submit-ordered bounded thread pool (default 2 workers, 4 in flight).

    Chunk saves are independent files, so workers may complete out of
    order; `submit` applies backpressure by waiting on the OLDEST pending
    future once `max_inflight` is reached.
    """

    def __init__(self, workers: int = 2, max_inflight: int = 4):
        self._ex = ThreadPoolExecutor(max_workers=workers,
                                      thread_name_prefix="chunk-save")
        self._pending: Deque[Future] = collections.deque()
        self._max_inflight = max(1, max_inflight)

    def submit(self, fn: Callable, *args, **kwargs) -> None:
        while len(self._pending) >= self._max_inflight:
            self._pending.popleft().result()  # re-raises worker exceptions
        self._pending.append(self._ex.submit(fn, *args, **kwargs))

    def _collect(self) -> list:
        """Wait for every pending save; log each failure and return them."""
        errors = []
        while self._pending:
            f = self._pending.popleft()
            if f.cancelled() or f.exception() is None:
                continue
            errors.append(f.exception())
            log.error("a chunk save failed: %r", f.exception(), exc_info=f.exception())
        return errors

    def drain(self) -> None:
        """Block until every submitted save has finished; re-raise the first
        failure after logging all of them."""
        errors = self._collect()
        if errors:
            raise errors[0]

    def shutdown(self) -> None:
        try:
            self.drain()
        finally:
            self._ex.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.shutdown()
            return False
        # The run is failing: cancel the saves not started and report the
        # failures among those that ran.
        self._ex.shutdown(wait=True, cancel_futures=True)
        self._collect()
        return False
