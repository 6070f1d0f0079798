"""Injectable clock (ref: pkg/utils/injectabletime/time.go — the reference
swaps a package-level Now var; we pass a Clock object so tests control time
without globals)."""

from __future__ import annotations

import threading
import time as _time


class Clock:
    def now(self) -> float:
        return _time.time()

    def monotonic(self) -> float:
        """Monotonic timestamps for durations/deadlines (rate limiters,
        tombstone TTLs) — never compare these against now()."""
        return _time.monotonic()

    def sleep(self, seconds: float) -> None:
        _time.sleep(seconds)


# Shared default for injectable-clock call sites (a Clock is stateless, so
# one instance serves every "no clock supplied" default). This module is the
# only one allowed to touch the raw time functions — tools/vet's
# clock-discipline checker holds every other production module to it.
SYSTEM_CLOCK = Clock()


class FakeClock(Clock):
    """Deterministic clock for TTL/expiry tests. One advancing timeline
    backs both now() and monotonic(), so wall-TTL and deadline logic move
    together under advance()."""

    def __init__(self, start: float = 1_000_000.0):
        self._now = start
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self._now

    def monotonic(self) -> float:
        with self._lock:
            return self._now

    def sleep(self, seconds: float) -> None:
        self.advance(seconds)

    def advance(self, seconds: float) -> None:
        with self._lock:
            self._now += seconds

    def set(self, timestamp: float) -> None:
        with self._lock:
            self._now = timestamp
