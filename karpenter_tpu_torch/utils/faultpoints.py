"""Named fault-injection sites for chaos-testing the control plane.

The crashpoint facility (utils/crashpoints.py) proves the pipelines survive
*total* failure — the process dies at a commit point. This module is its
partner for *partial* failure: the apiserver stays up but misbehaves — slow
responses, dropped connections, 429 throttles, 5xx storms, spurious 409
conflicts, and watch streams that tear, duplicate, reorder, or silently
drop events. ChaosTransport (kubeapi/chaos.py) consults these sites on
every request/stream event, and the fake apiserver's HTTP watch handler
consults ``watch.stall`` to model a server that stops sending bytes.

Design notes (mirroring crashpoints):

- Zero-cost when disarmed: one dict read on the hot path, no lock (the
  armed map is only mutated from tests/harnesses).
- Faults are *Exceptions or status codes*, never BaseException: unlike a
  crash, a fault is exactly what the retry envelope and reconnect loops are
  built to absorb, so it must travel the recovery paths.
- Deterministic storms: rates are rolled on a module RNG reseeded via
  ``seed(n)`` so a chaos run replays bit-identically.
- ``rate=1.0`` + ``count=1`` gives the deterministic single-shot arming the
  unit tests use; the smoke arms fractional rates across every site.

Site inventory (asserted against the instrumented literals by
tests/test_chaos.py, the crashpoint-inventory-lint analogue — a new kube
call site must either reuse these sites or extend BOTH this tuple and the
instrumentation):

- ``api.request.get|post|put|patch|delete``  one per HTTP verb, crossed by
  every ChaosTransport.request (LIST is a collection GET)
- ``watch.open``    crossing a watch stream open (tear | gone faults)
- ``watch.event``   crossed per delivered watch event (latency | tear |
                    duplicate | reorder | drop-410)
- ``watch.stall``   consulted by the fake apiserver's HTTP watch handler:
                    hold events without closing the socket — the fault the
                    HttpTransport read-deadline exists to bound
- ``market.feed``   crossed by the market controller's feed poll
                    (controllers/market.py): ``stale`` holds back the
                    newest ticks (they redeliver), ``reorder`` scrambles
                    the batch (the seq-sorted fold absorbs it), and
                    ``blackout`` skips the poll — staleness climbs
- ``lease.cas``     crossed by the apiserver backend's lease CAS
                    (kubeapi/cluster.py acquire_lease): ``conflict`` loses
                    the CAS outright (a rival's update raced ours), while
                    ``commit-lost`` commits the server write but reports
                    the attempt lost — the classic split-brain seed, where
                    the holder must re-observe itself on the next campaign
- ``kubelet.register``   crossed by the fake-kubelet fleet
                    (tests/fake_kubelet.py) at node registration: ``drop``
                    = never-join (the Liveness guard's prey), ``delay`` =
                    slow-join (registration lands late but inside grace),
                    ``zombie`` = a DELETED node's kubelet re-registering
                    under its old name (the adoption-defense prey)
- ``kubelet.heartbeat``  crossed per heartbeat: ``drop`` = the kubelet goes
                    permanently dark mid-life (gone-dark detection prey),
                    ``flap`` = one beat reports NotReady then recovers
                    (the hysteresis must absorb it)
- ``kubelet.pod-ready``  crossed per pod-ready transition: ``delay`` holds
                    the transition back
- ``kubelet.eviction``   crossed per eviction the kubelet should complete:
                    ``black-hole`` = the pod sticks terminating forever
                    (the stuck-drain breaker's prey)
- ``solver.dispatch``    crossed per device solve batch (models/solver.py
                    CostSolver): ``oom`` raises RESOURCE_EXHAUSTED at the
                    dispatch/fetch choke point — the bisect-and-retry
                    ladder's prey (arm with count=N to force N split
                    depths before the batch fits)
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

SITES = (
    "api.request.get",
    "api.request.post",
    "api.request.put",
    "api.request.patch",
    "api.request.delete",
    "watch.open",
    "watch.event",
    "watch.stall",
    "market.feed",
    "lease.cas",
    "kubelet.register",
    "kubelet.heartbeat",
    "kubelet.pod-ready",
    "kubelet.eviction",
    "solver.dispatch",
)

REQUEST_SITES = tuple(s for s in SITES if s.startswith("api.request."))

# Which fault kinds make sense where — arm() rejects anything else so a
# typo'd kind fails the arming test, not silently never-fires.
KINDS_BY_SITE = {
    **{
        site: ("latency", "timeout", "reset", "throttle", "server-error", "conflict")
        for site in REQUEST_SITES
    },
    "watch.open": ("tear", "gone"),
    "watch.event": ("latency", "tear", "duplicate", "reorder", "drop-410"),
    "watch.stall": ("stall",),
    "market.feed": ("stale", "reorder", "blackout"),
    "lease.cas": ("conflict", "commit-lost"),
    "kubelet.register": ("drop", "delay", "zombie"),
    "kubelet.heartbeat": ("drop", "flap"),
    "kubelet.pod-ready": ("delay",),
    "kubelet.eviction": ("black-hole",),
    "solver.dispatch": ("oom",),
}


@dataclass
class Fault:
    """One armed fault: kind + rate + kind-specific parameters."""

    site: str
    kind: str
    rate: float = 1.0  # probability per passage
    count: Optional[int] = None  # max fires; None = unlimited
    delay_s: float = 0.0  # latency / stall duration
    retry_after_s: float = 1.0  # throttle: Status details.retryAfterSeconds
    status: int = 503  # server-error status code
    fires: int = 0  # times this fault actually fired


_lock = threading.Lock()
_armed: Dict[str, List[Fault]] = {}
_fired: Dict[str, int] = {}
_rng = random.Random(0)


def seed(value: int) -> None:
    """Reseed the roll RNG — a storm armed after seed(n) replays exactly."""
    with _lock:
        _rng.seed(value)


def arm(
    site: str,
    kind: str,
    rate: float = 1.0,
    count: Optional[int] = None,
    delay_s: float = 0.0,
    retry_after_s: float = 1.0,
    status: int = 503,
) -> Fault:
    """Arm `kind` at `site`; multiple faults may stack on one site (each is
    rolled independently, first winner fires). Returns the Fault so tests
    can read back .fires."""
    allowed = KINDS_BY_SITE.get(site)
    if allowed is None:
        raise ValueError(f"unknown fault site {site!r} (see faultpoints.SITES)")
    if kind not in allowed:
        raise ValueError(f"fault kind {kind!r} invalid at {site!r}; one of {allowed}")
    if not 0.0 < rate <= 1.0:
        raise ValueError(f"rate must be in (0, 1], got {rate}")
    fault = Fault(
        site=site, kind=kind, rate=rate, count=count,
        delay_s=delay_s, retry_after_s=retry_after_s, status=status,
    )
    with _lock:
        _armed.setdefault(site, []).append(fault)
    return fault


def draw(site: str) -> Optional[Fault]:
    """The injection call: returns the fault to apply at this passage of
    `site`, or None. No-op (one dict read, no lock) unless armed."""
    if not _armed:
        return None
    winner = None
    with _lock:
        faults = _armed.get(site)
        if not faults:
            return None
        for fault in faults:
            if fault.count is not None and fault.fires >= fault.count:
                continue
            if fault.rate < 1.0 and _rng.random() >= fault.rate:
                continue
            fault.fires += 1
            _fired[site] = _fired.get(site, 0) + 1
            winner = fault
            break
    # The reference also records every injected fault in its flight
    # recorder; the port has no flight recorder yet.
    return winner


def fires(site: str) -> bool:
    """Boolean convenience for sites whose fault carries no parameters
    (the fake apiserver's ``watch.stall`` handler)."""
    return draw(site) is not None


def fired(site: str) -> int:
    """How many faults have fired at `site` since the last disarm_all()."""
    with _lock:
        return _fired.get(site, 0)


def total_fired() -> int:
    with _lock:
        return sum(_fired.values())


def disarm_all() -> None:
    with _lock:
        _armed.clear()
        _fired.clear()


def any_armed() -> bool:
    return bool(_armed)
