"""Clock-injected TTL cache.

Ref: the reference leans on github.com/patrickmn/go-cache throughout the AWS
provider (aws/instancetypes.go:55-56, launchtemplate.go:61, subnets.go:25).
Ours takes a Clock so TTL expiry is deterministic under test (FakeClock)
instead of depending on wall time.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Hashable, Optional, Tuple

from karpenter_tpu_torch.utils.clock import Clock, SYSTEM_CLOCK

_MISSING = object()


class TtlCache:
    # Expired entries are only reaped when their key is looked up, so a
    # churn-heavy keyspace (e.g. pod UIDs) would otherwise grow without
    # bound; every SWEEP_INTERVAL-th set() purges all expired entries
    # (go-cache runs a janitor goroutine for the same reason).
    SWEEP_INTERVAL = 256

    def __init__(self, ttl: float, clock: Optional[Clock] = None):
        self.ttl = ttl
        self.clock = clock or SYSTEM_CLOCK
        self._entries: Dict[Hashable, Tuple[float, Any]] = {}  # vet: guarded-by(self._lock)
        self._lock = threading.Lock()
        self._sets_since_sweep = 0  # vet: guarded-by(self._lock)

    def get(self, key: Hashable, default: Any = None) -> Any:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                return default
            expires_at, value = entry
            if self.clock.now() >= expires_at:
                del self._entries[key]
                return default
            return value

    def __contains__(self, key: Hashable) -> bool:
        return self.get(key, _MISSING) is not _MISSING

    def set(self, key: Hashable, value: Any = None) -> None:
        """Store (or refresh the TTL of) key. The reference notes the same
        refresh-on-set semantics for ICE blackouts (instancetypes.go:181)."""
        with self._lock:
            now = self.clock.now()
            self._entries[key] = (now + self.ttl, value)
            self._sets_since_sweep += 1
            if self._sets_since_sweep >= self.SWEEP_INTERVAL:
                self._sets_since_sweep = 0
                for stale in [k for k, (exp, _) in self._entries.items() if exp <= now]:
                    del self._entries[stale]

    def delete(self, key: Hashable) -> None:
        with self._lock:
            self._entries.pop(key, None)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def keys(self):
        now = self.clock.now()
        with self._lock:
            return [k for k, (exp, _) in self._entries.items() if exp > now]
