"""Write fencing by lease generation.

A deposed leader must not mutate shared state: its in-flight sweeps race the
successor's and can double-launch capacity or overwrite fresher bindings. The
fence is armed with the lease generation (the Lease's monotonic ``transitions``
counter) when leadership is acquired and revoked the instant the elector
observes leadership lost. Every mutating verb — store writes and cloud
launch/terminate — calls :meth:`WriteFence.check` first; once revoked the verb
raises :class:`FencedWriteError` instead of reaching either backend.

The fence also powers cooperative sweep abort: reconcile threads bind their
cluster's fence via :func:`bind_thread`, and a gate installed into
``utils.crashpoints`` re-checks it at every instrumented crashpoint site, so a
long sweep that straddles a leadership loss dies at the next site instead of
draining to completion.
"""
from __future__ import annotations

import threading
from typing import Optional

from karpenter_tpu_torch.utils import crashpoints
from karpenter_tpu_torch.utils.metrics import REGISTRY

LEADER_FENCE_REJECTED_TOTAL = REGISTRY.counter(
    "leader_fence_rejected_total",
    "Mutating verbs refused because the write fence was revoked (stale leader)",
    ["verb"],
)

_UNARMED = "unarmed"
_ACTIVE = "active"
_REVOKED = "revoked"


class FencedWriteError(Exception):
    """A mutating verb was refused because this process is no longer leader.

    Deliberately an ``Exception`` (not ``BaseException``): a fenced sweep must
    travel the same recovery paths as any other reconcile error so the loop
    records the failure and parks the key instead of killing the thread.
    """

    def __init__(self, verb: str, generation: Optional[int]):
        super().__init__(
            f"write fence revoked: refusing {verb} (lease generation {generation})"
        )
        self.verb = verb
        self.generation = generation


class WriteFence:
    """Tri-state fence: unarmed (pass-through) / active / revoked.

    Arm/revoke are keyed by holder identity so a rival elector sharing the
    store in-process (tests drive several electors over one Cluster) cannot
    revoke a fence it never armed.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._state = _UNARMED  # vet: guarded-by(self._lock)
        self._holder: Optional[str] = None  # vet: guarded-by(self._lock)
        self._generation: Optional[int] = None  # vet: guarded-by(self._lock)

    @property
    def generation(self) -> Optional[int]:
        with self._lock:
            return self._generation if self._state == _ACTIVE else None

    def arm(self, holder: str, generation: int) -> None:
        """Grant write access for ``holder`` at ``generation``. Idempotent;
        re-arming (renewal, or a fresh acquire after revocation) overwrites."""
        with self._lock:
            self._state = _ACTIVE
            self._holder = holder
            self._generation = int(generation)

    def revoke(self, holder: str) -> None:
        """Flip to revoked iff ``holder`` is the one the fence was armed for."""
        with self._lock:
            if self._state == _ACTIVE and self._holder == holder:
                self._state = _REVOKED

    def disarm(self, holder: str) -> None:
        """Voluntary release: return to pass-through (clean shutdown path)."""
        with self._lock:
            if self._holder == holder:
                self._state = _UNARMED
                self._holder = None
                self._generation = None

    def check(self, verb: str) -> None:
        """Refuse ``verb`` with :class:`FencedWriteError` once revoked."""
        with self._lock:
            if self._state != _REVOKED:
                return
            generation = self._generation
        LEADER_FENCE_REJECTED_TOTAL.inc(verb)
        from karpenter_tpu_torch.utils.obs import RECORDER

        RECORDER.record("fence-reject", verb=verb, generation=generation)
        raise FencedWriteError(verb, generation)

    def revoked(self) -> bool:
        with self._lock:
            return self._state == _REVOKED


_thread_state = threading.local()


def bind_thread(fence: Optional[WriteFence]) -> None:
    """Associate ``fence`` with the calling thread for cooperative abort."""
    _thread_state.fence = fence


def current_thread_fence() -> Optional[WriteFence]:
    return getattr(_thread_state, "fence", None)


def _abort_gate(site: str) -> None:
    """Crashpoint gate: abort a deposed leader's sweep at the next site."""
    fence = current_thread_fence()
    if fence is not None and fence.revoked():
        fence.check(f"sweep:{site}")


crashpoints.set_abort_gate(_abort_gate)
