"""Dynamic timeouts: self-tuning deadlines for drive calls (counterpart of
minio_tpu/utils/dyntimeout.py; reference dynamicTimeout,
cmd/dynamic-timeouts.go:35).

A fixed timeout is too tight on a busy drive (spurious failures) or too
loose on a healthy one (slow failure detection). Each DynamicTimeout logs
its recent outcomes and adapts once per window of LOG_SIZE: when a quarter
of the window timed out the deadline grows by 25%; when every call
succeeded it halves its distance to 1.5x the slowest observed call, never
below the configured floor. The same log of outcomes gives the JAX
package's sequence of deadlines.
"""

from __future__ import annotations

import threading

LOG_SIZE = 100           # observations per adjustment window
MAX_TIMEOUT = 300.0      # absolute ceiling (seconds)
FAIL_FRACTION = 0.25     # share of timeouts in a window that inflates
SHRINK_MARGIN = 1.5      # headroom kept over the slowest observed call


class DynamicTimeout:
    """Thread-safe adaptive timeout.

        dt = DynamicTimeout(timeout=5.0, minimum=1.0)
        deadline = dt.timeout()
        ... run the call ...
        dt.log_success(duration)   # or dt.log_failure() on a timeout
    """

    def __init__(self, timeout: float, minimum: float):
        if minimum <= 0 or timeout < minimum:
            raise ValueError(f"bad timeout bounds {timeout}/{minimum}")
        self._timeout = timeout
        self.minimum = minimum
        self._mu = threading.Lock()
        self._durations: list[float] = []
        self._failures = 0

    def timeout(self) -> float:
        return self._timeout

    def log_success(self, duration: float) -> None:
        with self._mu:
            self._durations.append(duration)
            self._maybe_adjust()

    def log_failure(self) -> None:
        """The call hit the deadline."""
        with self._mu:
            self._failures += 1
            self._maybe_adjust()

    def _maybe_adjust(self) -> None:
        n = len(self._durations) + self._failures
        if n < LOG_SIZE:
            return
        if self._failures >= n * FAIL_FRACTION:
            self._timeout = min(self._timeout * 1.25, MAX_TIMEOUT)
        elif self._durations:
            envelope = max(self._durations) * SHRINK_MARGIN
            if envelope < self._timeout:
                self._timeout = max(self.minimum, (self._timeout + envelope) / 2)
        self._durations.clear()
        self._failures = 0


def parse_duration(raw: str, default: float = 0.0) -> float:
    """A Go-style duration ("250ms", "1.5s", "2m", "1h", bare seconds) in
    seconds; `default` on empty or invalid input."""
    s = (raw or "").strip().lower()
    if not s:
        return default
    try:
        for suffix, mult in (("ms", 1e-3), ("s", 1.0), ("m", 60.0), ("h", 3600.0)):
            if s.endswith(suffix):
                return float(s[:-len(suffix)]) * mult
        return float(s)
    except ValueError:
        return default
