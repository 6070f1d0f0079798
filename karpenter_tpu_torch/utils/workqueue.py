"""Rate-limited work queues.

Ref: pkg/utils/parallel/workqueue.go (token-bucket async task runner used to
throttle CreateFleet) and termination/eviction.go (set-deduped queue with
exponential per-item backoff 100ms -> 10s).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Dict, Hashable, Optional

from karpenter_tpu_torch.utils.clock import Clock, SYSTEM_CLOCK


class RateLimiter:
    """Token bucket: qps refill, burst capacity (ref: client-go flowcontrol
    as used at aws/cloudprovider.go:41-46)."""

    def __init__(self, qps: float, burst: int, clock: Optional[Clock] = None):
        self.qps = qps
        self.burst = burst
        self.clock = clock or SYSTEM_CLOCK
        self._tokens = float(burst)  # vet: guarded-by(self._lock)
        self._last = self.clock.now()  # vet: guarded-by(self._lock)
        self._lock = threading.Lock()

    def try_acquire(self) -> bool:
        with self._lock:
            now = self.clock.now()
            self._tokens = min(self.burst, self._tokens + (now - self._last) * self.qps)
            self._last = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    def wait_time(self) -> float:
        with self._lock:
            if self._tokens >= 1.0:
                return 0.0
            return (1.0 - self._tokens) / self.qps


class BackoffQueue:
    """Set-deduped retry queue with per-item exponential backoff
    (ref: termination/eviction.go:33-54). Synchronous drain model: callers
    pump `process(fn)`; items whose fn returns False are requeued with
    backoff. Tests drive it with a FakeClock."""

    def __init__(
        self,
        base_delay: float = 0.1,
        max_delay: float = 10.0,
        clock: Optional[Clock] = None,
        max_items: Optional[int] = None,
    ):
        self.base_delay = base_delay
        self.max_delay = max_delay
        self.clock = clock or SYSTEM_CLOCK
        # Requeue-set bound: past this many distinct in-flight items, add()
        # refuses new ones (requeues of items already held always land —
        # dropping an accepted item's retry would strand it). None =
        # unbounded, for queues whose feeder is itself bounded.
        self.max_items = max_items
        self._queue: deque = deque()  # vet: guarded-by(self._lock)
        self._in_queue: set = set()  # vet: guarded-by(self._lock)
        self._failures: Dict[Hashable, int] = {}  # vet: guarded-by(self._lock)
        self._not_before: Dict[Hashable, float] = {}  # vet: guarded-by(self._lock)
        self._lock = threading.Lock()

    def add(self, item: Hashable) -> bool:
        with self._lock:
            if item in self._in_queue:
                return False
            if self.max_items is not None and len(self._in_queue) >= self.max_items:
                return False
            self._in_queue.add(item)
            self._queue.append(item)
            return True

    def __len__(self):
        return len(self._queue)  # vet: unguarded(GIL-atomic len; monitoring read)

    def __contains__(self, item):
        return item in self._in_queue  # vet: unguarded(GIL-atomic membership; monitoring read)

    def process(self, fn: Callable[[Hashable], bool]) -> int:
        """Run fn over every currently-due item once. Returns #successes.
        Failures requeue with exponential backoff."""
        with self._lock:
            batch = list(self._queue)
            self._queue.clear()
            # Snapshot the due times with the batch: reading them item-by-
            # item outside the lock raced a concurrent process() call's
            # backoff writes (found by the vet lock-discipline checker).
            not_before = dict(self._not_before)
        done = 0
        now = self.clock.now()
        for item in batch:
            if not_before.get(item, 0.0) > now:
                with self._lock:
                    self._queue.append(item)
                continue
            ok = fn(item)
            with self._lock:
                if ok:
                    self._in_queue.discard(item)
                    self._failures.pop(item, None)
                    self._not_before.pop(item, None)
                    done += 1
                else:
                    failures = self._failures.get(item, 0) + 1
                    self._failures[item] = failures
                    delay = min(self.base_delay * (2 ** (failures - 1)), self.max_delay)
                    self._not_before[item] = now + delay
                    self._queue.append(item)
        return done
