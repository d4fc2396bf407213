"""In-process pubsub bus (counterpart of minio_tpu/admin/pubsub.py,
reference pkg/pubsub/pubsub.go).

Zero cost when nobody subscribes: publishers check `has_subscribers`
before building records (the reference's trace wrapper does exactly this,
cmd/handler-utils.go:362-364).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator


class PubSub:
    def __init__(self, max_queue: int = 1000):
        self._subs: list[queue.Queue] = []
        self._mu = threading.Lock()
        self._max_queue = max_queue
        # Records dropped on slow consumers — silent loss would make a
        # gappy trace look complete; exported as
        # minio_tpu_trace_dropped_total for the process trace bus.
        self.dropped = 0

    @property
    def has_subscribers(self) -> bool:
        return bool(self._subs)

    def publish(self, item) -> None:
        with self._mu:
            subs = list(self._subs)
        for q in subs:
            try:
                q.put_nowait(item)
            except queue.Full:  # slow consumer: drop, never block
                with self._mu:
                    self.dropped += 1

    def subscribe(self) -> "Subscription":
        q: queue.Queue = queue.Queue(maxsize=self._max_queue)
        with self._mu:
            self._subs.append(q)
        return Subscription(self, q)

    def _unsubscribe(self, q: queue.Queue) -> None:
        with self._mu:
            try:
                self._subs.remove(q)
            except ValueError:
                pass


class Subscription:
    def __init__(self, bus: PubSub, q: queue.Queue):
        self._bus = bus
        self._q = q
        self._closed = False

    def get(self, timeout: float | None = None):
        """Next item, or None on timeout."""
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def stream(self, poll: float = 1.0) -> Iterator:
        while not self._closed:
            item = self.get(timeout=poll)
            if item is not None:
                yield item

    def close(self) -> None:
        self._closed = True
        self._bus._unsubscribe(self._q)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
