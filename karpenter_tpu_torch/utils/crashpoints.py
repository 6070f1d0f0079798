"""Named crash-injection sites for crash-consistency testing.

The launch→register→bind pipeline buys capacity at one boundary and records
it at another; a controller that dies between the two must converge after a
restart without leaking instances or double-binding pods. That property is
only trustworthy if it is *executed*, so the pipeline threads named
`crashpoint(...)` sites through its commit points and the crash battletest
(tests/test_crash_consistency.py, `make crash-smoke`) arms each one in turn,
"kills" the controller there, restarts it, and asserts convergence.

Design notes:

- `SimulatedCrash` subclasses BaseException, NOT Exception. The pipeline is
  full of deliberate `except Exception` recovery (launch errors become
  per-node error lists, reconcile loops log-and-requeue); a *crash* must
  punch through all of it exactly like `os._exit` would, and be caught only
  by the test harness playing the role of the supervisor.
- Sites are zero-cost when disarmed: one dict read, no lock on the hot path
  (the armed map is only mutated from tests).
- `action="exit"` hard-kills the process (for subprocess-based harnesses);
  the default `action="raise"` stays in-process so a test can catch the
  crash and "restart" by building fresh controllers over the surviving
  store — the same state a real restart would observe.
- `at=N` fires on the Nth passage through the site (1-based), so e.g.
  `mid-bind` can let the first pod bind and kill the controller before the
  second.

Site inventory (see docs/design/crash-consistency.md):

- ``provision.before-launch``    batch drained, nothing bought yet
- ``cloud.after-create-fleet``   capacity bought, no callback/node yet
- ``provision.before-register``  node object about to be created
- ``provision.mid-bind``         fires per pod bind (arm with at=N)
- ``provision.after-bind``       node registered + pods bound, stats pending
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Dict, List

# The canonical site names, asserted by the lint in the crash battletest so
# the matrix can't silently drift from the instrumented code. SITES is the
# provisioning pipeline's matrix (tests/test_crash_consistency.py drives a
# provision pass into each); INTERRUPTION_SITES is the interruption
# pipeline's (tests/test_interruption.py drives a reclaim into each). The
# inventory lint asserts over the union.
SITES = (
    "provision.before-launch",
    "cloud.after-create-fleet",
    "provision.before-register",
    "provision.mid-bind",
    "provision.after-bind",
)

# Interruption pipeline commit points (docs/design/interruption.md):
# - ``interruption.after-annotate``  intent on the Node, event not yet acked
# - ``interruption.mid-drain``       fires per displaced pod (arm with at=N)
# - ``interruption.before-delete``   drain done, node deletion not yet issued
INTERRUPTION_SITES = (
    "interruption.after-annotate",
    "interruption.mid-drain",
    "interruption.before-delete",
)

# Consolidation pipeline commit points (docs/design/consolidation.md):
# - ``consolidation.after-nominate``  action annotation stamped on the
#   victim, nothing displaced yet
# - ``consolidation.mid-drain``       fires per displaced pod (arm with at=N)
# - ``consolidation.before-delete``   drain done, node deletion not yet issued
CONSOLIDATION_SITES = (
    "consolidation.after-nominate",
    "consolidation.mid-drain",
    "consolidation.before-delete",
)

# Market-fold commit point (docs/design/market.md):
# - ``market.mid-tick``  fires between folded market ticks (arm with at=N)
#   — a kill mid-fold leaves the PriceBook partially folded; the restart
#   re-polls the replayable feed from seq 0 and must reconstruct the
#   IDENTICAL book state and generation (the fold is a pure idempotent
#   function of the tick sequence; tests/test_market_feed.py asserts it on
#   both store backends).
MARKET_SITES = ("market.mid-tick",)

# Incremental-encode commit point (docs/design/incremental-encode.md):
# - ``encode.mid-apply``  fires inside DeviceClusterState's two-phase pod
#   sync, after the old contribution was removed and before the new one is
#   added — a kill here leaves the host bookkeeping torn, which the state
#   must detect (torn marker) and heal by rebuilding from the snapshot
#   path; the battletest asserts the rebuilt tensors are bit-identical to a
#   fresh snapshot encode.
ENCODE_SITES = ("encode.mid-apply",)

# Leader-election commit points (docs/operations.md, HA runbook):
# - ``leader.after-acquire``  the lease CAS committed and the fence armed,
#   but the Manager has not activated yet — a kill here leaves a held lease
#   that the standby can only take over after the TTL expires.
# - ``leader.before-renew``   fires at the top of each renewal attempt — a
#   kill here models the classic "died holding the lease mid-term" case.
LEADER_SITES = (
    "leader.after-acquire",
    "leader.before-renew",
)

# Unhealthy-node escalation commit points (docs/design/node-lifecycle.md):
# - ``health.after-cordon``   staleness confirmed and the victim cordoned,
#   nothing displaced yet — a restart must re-detect the same node (the
#   hysteresis counters are in-memory) and resume the ladder idempotently.
# - ``health.mid-displace``   fires per displaced pod (arm with at=N) — a
#   kill here leaves some pods rebound-pending and some still on the dying
#   node; the restart must finish the drain without double-displacing.
HEALTH_SITES = (
    "health.after-cordon",
    "health.mid-displace",
)

# Drift rolling-replacement commit points (docs/design/drift.md):
# - ``drift.after-mark``     drift kind annotation stamped on the victim,
#   nothing displaced yet — a restart resumes the replacement from the
#   durable annotation without re-detecting.
# - ``drift.mid-replace``    fires per displaced pod (arm with at=N) — a
#   kill here leaves some pods rebound-pending and some still on the
#   drifted node; the restart must finish without double-displacing.
# - ``drift.before-delete``  drain done, node deletion not yet issued.
DRIFT_SITES = (
    "drift.after-mark",
    "drift.mid-replace",
    "drift.before-delete",
)


class SimulatedCrash(BaseException):
    """The controller process 'died' at a named site. BaseException so no
    recovery path in the pipeline can swallow it (see module docstring)."""

    def __init__(self, site: str):
        super().__init__(f"simulated crash at {site}")
        self.site = site


@dataclass
class _Arm:
    action: str = "raise"  # "raise" | "exit"
    at: int = 1  # fire on the Nth passage (1-based)
    hits: int = 0  # passages so far while armed


_lock = threading.Lock()
_armed: Dict[str, _Arm] = {}
_passages: Dict[str, int] = {}  # every passage ever, armed or not
# Fired just before a crash executes (black-box hooks: the flight recorder
# registers a dump here so even an action="exit" kill — which skips atexit —
# leaves a forensic record). Append-only from module init; never under _lock.
_crash_callbacks: List = []
# Optional gate consulted on EVERY passage (armed or not). utils.fence
# installs one that aborts a deposed leader's sweep at the next site — the
# crashpoint inventory doubles as the set of cooperative-abort sites, so a
# long sweep straddling a leadership loss dies at its next commit point
# instead of draining to completion against the successor. Written once at
# module init (fence import); read lock-free like the armed map.
_abort_gate = None


def set_abort_gate(gate) -> None:
    """Install ``gate(site)`` to run at every crashpoint passage. The gate
    may raise to abort the sweep (utils.fence raises FencedWriteError)."""
    global _abort_gate
    _abort_gate = gate


def on_crash(callback) -> None:
    """Register callback(site) to run right before an armed crash fires."""
    _crash_callbacks.append(callback)


def crashpoint(name: str) -> None:
    """A named injection site. No-op unless a test armed `name`."""
    gate = _abort_gate
    if gate is not None:
        gate(name)
    # Lock-free fast path: dict reads are GIL-atomic and the armed map is
    # only written from tests, so production passes cost one lookup.
    if not _armed:
        if _passages:
            _count_passage(name)
        return
    _count_passage(name)
    with _lock:
        arm = _armed.get(name)
        if arm is None:
            return
        arm.hits += 1
        if arm.hits < arm.at:
            return
        del _armed[name]  # one-shot: the process only dies once
    for callback in _crash_callbacks:
        try:
            callback(name)
        except Exception:  # noqa: BLE001 — a black-box hook must not mask the crash
            pass
    if arm.action == "exit":
        os._exit(86)
    raise SimulatedCrash(name)


def _count_passage(name: str) -> None:
    with _lock:
        _passages[name] = _passages.get(name, 0) + 1


def arm(name: str, action: str = "raise", at: int = 1) -> None:
    """Arm `name` to fire on its `at`-th passage. One-shot."""
    if action not in ("raise", "exit"):
        raise ValueError(f"unknown crash action {action!r}")
    with _lock:
        _armed[name] = _Arm(action=action, at=at)
        _passages.setdefault(name, 0)


def disarm_all() -> None:
    with _lock:
        _armed.clear()
        _passages.clear()


def passages(name: str) -> int:
    """How many times `name` was crossed since passage counting started
    (counting starts at the first arm() and stops at disarm_all())."""
    with _lock:
        return _passages.get(name, 0)


def armed() -> List[str]:
    with _lock:
        return sorted(_armed)


def any_armed() -> bool:
    """Lock-free (same GIL-atomicity argument as the crashpoint fast path):
    lets instrumented code pick a deterministic serial path while a crash
    test is armed — e.g. bind fan-out, where a kill mid-fan-out would leave
    whichever sibling binds the pool happened to finish, not a reproducible
    minimal state."""
    return bool(_armed)
