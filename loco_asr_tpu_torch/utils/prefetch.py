"""Background prefetch for host-side input pipelines, the port's own copy
of ``loco_asr_tpu.utils.prefetch``.

The device should not wait on audio decode (a wav.scp pipe, the resampler)
or tokenization: wrap any batch iterator so that up to ``depth`` batches
are prepared ahead on a worker thread while the GPU runs the current
step.  ``train_asr`` reads its training batches through
``prefetch(..., depth=4)``, as the JAX trainer does.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


class PrefetchIterator(Iterator[T]):
    """Iterate ``source`` on a daemon thread, buffering up to ``depth``
    items, in order.  An exception in the producer re-raises in the
    consumer after the items produced before it."""

    def __init__(self, source: Iterable[T], depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._err = None

        def run():
            try:
                for item in source:
                    self._q.put(item)
            except BaseException as e:  # noqa: BLE001 -- re-raised in the consumer
                self._err = e
            finally:
                self._q.put(_SENTINEL)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self) -> "PrefetchIterator[T]":
        return self

    def __next__(self) -> T:
        item = self._q.get()
        if item is _SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def prefetch(source: Iterable[T], depth: int = 2) -> PrefetchIterator[T]:
    return PrefetchIterator(source, depth)
