"""Pod-latency SLO pipeline: phase-attributed lifecycle tracking, a rolling
SLO evaluator, and a flight recorder.

The reference ships only aggregate Prometheus duration histograms
(SURVEY.md §5): when a p99 regresses there is no way to tell WHICH hop of
the provisioning pipeline ate the budget, and when a storm smoke fails the
only forensic record is the log tail. This module closes both gaps:

- ``PodLifecycleTracker`` stamps monotonic phase transitions per pod —
  unschedulable-seen → batched → constraint-compiled → solve-dispatched →
  solve-fetched → launched → node-ready → bound — into bounded per-phase
  histograms (``pod_phase_seconds{phase}``) plus an end-to-end
  ``pod_pending_seconds`` histogram. It is fed from the store's verb-level
  watch-delta feed (O(churn) per sweep, the same feed the incremental
  encoder rides) plus explicit stamps at the pipeline's own commit points,
  and survives controller restarts by re-anchoring on the pod's
  creationTimestamp: a tracker that first sees a pod mid-flight anchors its
  pending clock at creation, not at process boot, so restart-spanning
  latency is charged honestly.

  Phase semantics: each stamp attributes the time since the pod's PREVIOUS
  stamp to the stamped phase, whatever order events arrive in (binds land
  before node readiness on the launch path; the canonical order above is
  the attribution order, not a delivery contract). A stamp for a phase
  already recorded this pending cycle is ignored (monotonic); a
  ``reschedule`` verb starts a fresh cycle.

- ``SloEvaluator`` keeps rolling windows of end-to-end pending times,
  time-to-first-launch, and per-phase durations; publishes
  ``slo_p99_pending_seconds`` / ``slo_p99_ttfl_seconds`` gauges; and, when
  a configured target (``--slo-pending-p99`` / ``--slo-ttfl``) is
  exceeded, counts ``slo_breaches_total{slo}``, records a breach event
  naming the worst offending pods and their slowest phase, and triggers a
  flight-recorder dump.

- ``FlightRecorder`` is a lock-annotated bounded ring of structured
  decision/fault events: launch decisions (chosen type + price +
  relaxation level), kube-API retries, faultpoint hits, chip quarantines,
  drains, consolidation actions, SLO breaches. It dumps as JSON on SLO
  breach, on crash (crashpoint hook + atexit), and on demand via the
  runtime's ``/debug/flightrecorder`` endpoint. Events carry a strictly
  increasing ``seq``; ``dropped`` counts ring evictions, so a dump with
  ``dropped == 0`` is gap-free by construction — the storm smokes assert
  exactly that.

Set ``KARPENTER_FLIGHT_DIR`` to make breach/crash/exit dumps land on disk;
without it, dumps are only served over HTTP. See
docs/design/observability.md for the phase model and SLO semantics.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

from karpenter_tpu_torch.utils import crashpoints
from karpenter_tpu_torch.utils import logging as klog
from karpenter_tpu_torch.utils.clock import Clock, SYSTEM_CLOCK
from karpenter_tpu_torch.utils.metrics import DURATION_BUCKETS, REGISTRY

log = klog.named("obs")

# The canonical phase (attribution) order. Every phase gets a
# pod_phase_seconds{phase} series; the chaos smoke asserts all of them
# publish under storm load.
PHASES = (
    "unschedulable-seen",
    "batched",
    "constraint-compiled",
    "solve-dispatched",
    "solve-fetched",
    "launched",
    "node-ready",
    "bound",
)

# The default 5ms-60s DURATION_BUCKETS saturate exactly where a pending-time
# breach lives (storm targets run 60-240s; a wedged pod pends for minutes) —
# the exposed histograms must resolve the SLO regime or dashboard quantiles
# cap at 60s while the in-process evaluator sees the truth.
PENDING_BUCKETS = DURATION_BUCKETS + (
    90.0, 120.0, 180.0, 240.0, 300.0, 450.0, 600.0,
)

POD_PHASE_SECONDS = REGISTRY.histogram(
    "pod_phase_seconds",
    "Time attributed to each pod lifecycle phase (see "
    "docs/design/observability.md for the phase model)",
    ["phase"],
    buckets=PENDING_BUCKETS,
)
POD_PENDING_SECONDS = REGISTRY.histogram(
    "pod_pending_seconds",
    "End-to-end pod pending time: creation/unschedulable-seen to bound",
    buckets=PENDING_BUCKETS,
)
SLO_P99_PENDING = REGISTRY.gauge(
    "slo_p99_pending_seconds",
    "Rolling-window p99 of pod_pending_seconds (the sustained-churn SLO "
    "signal; target via --slo-pending-p99)",
)
SLO_P99_TTFL = REGISTRY.gauge(
    "slo_p99_ttfl_seconds",
    "Rolling-window p99 of time-to-first-launch (unschedulable-seen to "
    "node launch; target via --slo-ttfl)",
)
SLO_BREACHES_TOTAL = REGISTRY.counter(
    "slo_breaches_total",
    "SLO breach episodes by objective (each one triggers a flight-recorder "
    "dump)",
    ["slo"],
)
FLIGHT_EVENTS_TOTAL = REGISTRY.counter(
    "flight_recorder_events_total",
    "Flight-recorder events recorded, by kind",
    ["kind"],
)
TRACKED_PODS = REGISTRY.gauge(
    "lifecycle_tracked_pods",
    "Pods currently tracked by the lifecycle tracker (bounded; evictions "
    "count as forgotten)",
)


def _quantile(values: Sequence[float], q: float) -> float:
    """Nearest-rank quantile over an unsorted sample list (0.0 if empty)."""
    if not values:
        return 0.0
    ordered = sorted(values)
    rank = max(1, int(math.ceil(q * len(ordered))))
    return ordered[min(rank, len(ordered)) - 1]


class FlightRecorder:
    """Bounded ring of structured decision/fault events (see module
    docstring). record() is cheap (one deque append under a short lock) so
    call sites can stay on hot paths; serialization happens only at dump
    time, on a consistent snapshot."""

    MAXLEN = 8192

    def __init__(self, clock: Optional[Clock] = None, maxlen: int = MAXLEN):
        self.clock = clock or SYSTEM_CLOCK
        self._events: deque = deque(maxlen=maxlen)  # vet: guarded-by(self._lock)
        self._seq = 0  # vet: guarded-by(self._lock)
        self._lock = threading.Lock()

    def configure(self, clock: Optional[Clock] = None) -> None:
        if clock is not None:
            self.clock = clock

    def record(self, kind: str, **fields) -> None:
        event = {
            "kind": kind,
            "t_wall": self.clock.now(),
            "t_mono": time.perf_counter(),
            **fields,
        }
        with self._lock:
            self._seq += 1
            event["seq"] = self._seq
            self._events.append(event)
        FLIGHT_EVENTS_TOTAL.inc(kind)

    def snapshot(self) -> dict:
        """Consistent view: events copied under the lock, with enough
        metadata (seq / dropped) for a reader to prove the record gap-free."""
        with self._lock:
            events = list(self._events)
            seq = self._seq
        return {
            "pid": os.getpid(),
            "seq": seq,
            "events": events,
            # Ring evictions since process start: a dump with dropped == 0
            # contains EVERY event ever recorded — the storm smokes' no-
            # unexplained-gaps oracle.
            "dropped": seq - len(events),
            "first_seq": events[0]["seq"] if events else 0,
            "last_seq": events[-1]["seq"] if events else 0,
        }

    def dump_json(self) -> str:
        return json.dumps(self.snapshot(), default=str)

    def dump(self, tag: str = "manual") -> Optional[str]:
        """Write a dump file into KARPENTER_FLIGHT_DIR (None when unset —
        the HTTP endpoint is then the only reader)."""
        directory = os.environ.get("KARPENTER_FLIGHT_DIR")
        if not directory:
            return None
        path = os.path.join(
            directory, f"flightrecorder-{tag}-{os.getpid()}.json"
        )
        try:
            with open(path, "w") as f:
                f.write(self.dump_json())
        except OSError:
            log.exception("flight-recorder dump to %s failed", path)
            return None
        return path

    def count(self, kind: Optional[str] = None) -> int:
        with self._lock:
            if kind is None:
                return len(self._events)
            return sum(1 for e in self._events if e["kind"] == kind)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._seq = 0


RECORDER = FlightRecorder()


class SloEvaluator:
    """Rolling-window SLO evaluation over the tracker's samples. Quantiles
    recompute at most once per EVAL_INTERVAL_S (the windows absorb storm
    rates without per-sample sorts); breaches are episode-gated so a
    sustained violation produces one dump per cooldown, not one per pod."""

    WINDOW_SECONDS = 300.0
    MAX_SAMPLES = 8192
    EVAL_INTERVAL_S = 1.0
    BREACH_COOLDOWN_S = 30.0
    OFFENDERS = 5

    def __init__(self, clock: Optional[Clock] = None, recorder: Optional[FlightRecorder] = None):
        self.clock = clock or SYSTEM_CLOCK
        self.recorder = recorder or RECORDER
        # Targets: 0 disables the objective (Options defaults — production
        # wiring passes --slo-pending-p99 / --slo-ttfl through Manager).
        self.pending_p99_target = 0.0
        self.ttfl_target = 0.0
        self._lock = threading.Lock()
        # (t, seconds, uid, slowest_phase) samples
        self._pending: deque = deque(maxlen=self.MAX_SAMPLES)  # vet: guarded-by(self._lock)
        self._ttfl: deque = deque(maxlen=self.MAX_SAMPLES)  # vet: guarded-by(self._lock)
        self._phases: Dict[str, deque] = {  # vet: guarded-by(self._lock)
            phase: deque(maxlen=2048) for phase in PHASES
        }
        self._last_eval = -float("inf")  # vet: guarded-by(self._lock)
        self._last_breach: Dict[str, float] = {}  # vet: guarded-by(self._lock)
        self.breaches: Dict[str, int] = {}  # vet: guarded-by(self._lock)

    def configure(
        self,
        clock: Optional[Clock] = None,
        pending_p99_target: Optional[float] = None,
        ttfl_target: Optional[float] = None,
    ) -> None:
        if clock is not None:
            self.clock = clock
        if pending_p99_target is not None:
            self.pending_p99_target = pending_p99_target
        if ttfl_target is not None:
            self.ttfl_target = ttfl_target

    # -- sample feeds (called by the tracker) --------------------------------

    def add_pending(self, seconds: float, uid: str, slowest_phase: str) -> None:
        now = self.clock.now()
        with self._lock:
            self._pending.append((now, seconds, uid, slowest_phase))
        self.evaluate()

    def add_ttfl(self, seconds: float, uid: str) -> None:
        now = self.clock.now()
        with self._lock:
            self._ttfl.append((now, seconds, uid, ""))
        self.evaluate()

    def add_phase(self, phase: str, seconds: float) -> None:
        now = self.clock.now()
        with self._lock:
            window = self._phases.get(phase)
            if window is not None:
                window.append((now, seconds))

    def add_phase_many(self, phase: str, durations: Sequence[float]) -> None:
        now = self.clock.now()
        with self._lock:
            window = self._phases.get(phase)
            if window is not None:
                window.extend((now, s) for s in durations)

    # -- evaluation ----------------------------------------------------------

    def _window_values(self, samples: deque, now: float) -> List[float]:
        """Values inside the rolling window (caller holds the lock).
        Expired leading samples are evicted in place."""
        horizon = now - self.WINDOW_SECONDS
        while samples and samples[0][0] < horizon:
            samples.popleft()
        return [s[1] for s in samples]

    def evaluate(self, force: bool = False) -> dict:
        """Recompute quantiles (clock-gated unless forced), publish gauges,
        and fire breach handling; returns the /debug/slo snapshot."""
        now = self.clock.now()
        with self._lock:
            if not force and now - self._last_eval < self.EVAL_INTERVAL_S:
                return {}
            self._last_eval = now
            pending = self._window_values(self._pending, now)
            ttfl = self._window_values(self._ttfl, now)
            phases = {
                phase: self._window_values(window, now)
                for phase, window in self._phases.items()
            }
            breaches = dict(self.breaches)
        pending_p99 = _quantile(pending, 0.99)
        ttfl_p99 = _quantile(ttfl, 0.99)
        SLO_P99_PENDING.set(pending_p99)
        SLO_P99_TTFL.set(ttfl_p99)
        snapshot = {
            "targets": {
                "pending-p99": self.pending_p99_target,
                "ttfl": self.ttfl_target,
            },
            "pending": {
                "count": len(pending),
                "p50": _quantile(pending, 0.50),
                "p99": pending_p99,
            },
            "ttfl": {
                "count": len(ttfl),
                "p50": _quantile(ttfl, 0.50),
                "p99": ttfl_p99,
            },
            "phases": {
                phase: {
                    "count": len(values),
                    "p50": _quantile(values, 0.50),
                    "p99": _quantile(values, 0.99),
                }
                for phase, values in phases.items()
            },
            "breaches": breaches,
        }
        pending_breach = (
            self.pending_p99_target > 0 and pending_p99 > self.pending_p99_target
        )
        ttfl_breach = self.ttfl_target > 0 and ttfl_p99 > self.ttfl_target
        if pending_breach or ttfl_breach:
            # Offenders cost a full window sort — pay for it only when a
            # breach actually fires, never on the steady-state eval path.
            with self._lock:
                offenders = self._offenders_locked(now)
            if pending_breach:
                self._breach(
                    "pending-p99", pending_p99, self.pending_p99_target, offenders
                )
            if ttfl_breach:
                self._breach("ttfl", ttfl_p99, self.ttfl_target, offenders)
            # The call that DETECTS a breach must also report it — the
            # counts snapshotted above predate the check.
            with self._lock:
                snapshot["breaches"] = dict(self.breaches)
        return snapshot

    def _offenders_locked(self, now: float) -> List[dict]:
        """Worst pending samples in the window — the pods a breach dump
        names, each with its slowest phase (caller holds the lock)."""
        horizon = now - self.WINDOW_SECONDS
        worst = sorted(
            (s for s in self._pending if s[0] >= horizon),
            key=lambda s: -s[1],
        )[: self.OFFENDERS]
        return [
            {"pod_uid": uid, "pending_seconds": seconds, "slowest_phase": phase}
            for (_, seconds, uid, phase) in worst
        ]

    def _breach(self, slo: str, observed: float, target: float, offenders) -> None:
        now = self.clock.now()
        with self._lock:
            if now - self._last_breach.get(slo, -float("inf")) < self.BREACH_COOLDOWN_S:
                return
            self._last_breach[slo] = now
            self.breaches[slo] = self.breaches.get(slo, 0) + 1
        SLO_BREACHES_TOTAL.inc(slo)
        log.warning(
            "SLO breach: %s p99 %.3fs > target %.3fs (%d offender(s) named "
            "in the flight-recorder dump)", slo, observed, target, len(offenders),
        )
        self.recorder.record(
            "slo-breach", slo=slo, observed_p99=observed, target=target,
            offenders=offenders,
        )
        self.recorder.dump(tag=f"slo-{slo}")


class _Entry:
    __slots__ = ("anchor", "last", "stamps")

    def __init__(self, anchor: float):
        self.anchor = anchor
        self.last = anchor
        self.stamps: Dict[str, float] = {}


class PodLifecycleTracker:
    """Per-pod phase stamping (see module docstring). One process-wide
    instance (OBS) mirrors metrics.REGISTRY / tracing.TRACER; Manager
    configures its clock + SLO targets and attaches it to the cluster
    store's watch-delta feed."""

    MAX_TRACKED = 131072
    TERMINAL = frozenset(("bound", "node-ready"))

    def __init__(self, clock: Optional[Clock] = None):
        self.clock = clock or SYSTEM_CLOCK
        self.evaluator = SloEvaluator(clock=self.clock)
        self._pods: Dict[str, _Entry] = {}  # vet: guarded-by(self._lock)
        self._lock = threading.Lock()
        self._source = None  # the attached cluster store (latest attach wins)

    def configure(
        self,
        clock: Optional[Clock] = None,
        slo_pending_p99: Optional[float] = None,
        slo_ttfl: Optional[float] = None,
    ) -> None:
        if clock is not None:
            self.clock = clock
        self.evaluator.configure(
            clock=clock,
            pending_p99_target=slo_pending_p99,
            ttfl_target=slo_ttfl,
        )

    def attach(self, cluster) -> None:
        """Subscribe to `cluster`'s verb-level watch feed. The newest attach
        wins: stores have no unsubscribe, so the callback closes over its
        cluster and goes inert when a newer one is attached (chaos harnesses
        rebuild the 'controller process' — and its store — mid-storm)."""
        self._source = cluster

        def _on_delta(verb: str, kind: str, obj, _cluster=cluster) -> None:
            if self._source is _cluster:
                self.on_delta(verb, kind, obj)

        cluster.watch_deltas(_on_delta)

    # -- the watch-delta feed ------------------------------------------------

    def on_delta(self, verb: str, kind: str, obj) -> None:
        if kind != "pod":
            return
        if verb == "delete":
            self.forget(obj.uid)
        elif verb == "reschedule":
            self.reanchor(obj.uid)
        elif verb == "bind":
            self._on_bound(obj, reanchor=True)
        elif obj.node_name:
            # apply/update of an already-bound pod (watch re-list, restart
            # catch-up): counts as bound only for a pod tracked as pending.
            self._on_bound(obj, reanchor=False)
        elif obj.is_provisionable():
            self.first_seen(obj)

    def _on_bound(self, pod, reanchor: bool) -> None:
        uid = pod.uid
        with self._lock:
            entry = self._pods.get(uid)
        if entry is None:
            created = getattr(pod, "created_at", None)
            if not reanchor or created is None:
                # A re-list apply of an already-bound pod we never saw
                # pending: it bound before this tracker watched (or while
                # the controller was down) — creation→now would charge its
                # whole AGE as pending, so nothing honest can be recorded.
                return
            # Restart re-anchor: the pod's actual BIND event arrived for a
            # pod this tracker never saw pending (it was pending across the
            # restart, relisted mid-race); charge from creationTimestamp.
            self.first_seen(pod)
        # A pod binding onto an already-Ready node never gets a Readiness
        # stamp; record the node-ready edge here so the phase publishes.
        source = self._source
        if source is not None and pod.node_name:
            try:
                node = source.try_get_node(pod.node_name)
            except Exception:  # noqa: BLE001 — store teardown race, stamp anyway
                node = None
            if node is not None and getattr(node, "ready", False):
                self.stamp(uid, "node-ready")
        self.stamp(uid, "bound")

    # -- stamping ------------------------------------------------------------

    def first_seen(self, pod) -> None:
        """Begin (or refresh) tracking: anchor at creationTimestamp when the
        store stamped one (restart re-anchoring), else at now."""
        now = self.clock.now()
        uid = pod.uid
        with self._lock:
            if uid in self._pods:
                return
            anchor = getattr(pod, "created_at", None)
            if anchor is None or anchor > now:
                anchor = now
            self._ensure_room_locked()
            entry = self._pods[uid] = _Entry(anchor)
            entry.stamps["unschedulable-seen"] = now
            entry.last = now
            tracked = len(self._pods)
        TRACKED_PODS.set(float(tracked))
        delta = max(0.0, now - entry.anchor)
        POD_PHASE_SECONDS.observe(delta, "unschedulable-seen")
        self.evaluator.add_phase("unschedulable-seen", delta)

    def _ensure_room_locked(self) -> None:
        # Bounded memory: evict the longest-tracked entry (dict preserves
        # insertion order). A 131k backlog overflow loses the OLDEST pods'
        # samples, never the live churn.
        while len(self._pods) >= self.MAX_TRACKED:
            self._pods.pop(next(iter(self._pods)))

    def stamp(self, uid: str, phase: str) -> None:
        """Attribute now - (pod's previous stamp) to `phase`. Unknown pods
        and repeat stamps are ignored (monotonic per pending cycle)."""
        now = self.clock.now()
        with self._lock:
            entry = self._pods.get(uid)
            if entry is None or phase in entry.stamps:
                return
            entry.stamps[phase] = now
            delta = max(0.0, now - entry.last)
            entry.last = now
            anchor = entry.anchor
            retire = self.TERMINAL <= entry.stamps.keys()
            slowest = self._slowest_phase_locked(entry) if phase == "bound" else ""
            if retire:
                self._pods.pop(uid, None)
            tracked = len(self._pods)
        TRACKED_PODS.set(float(tracked))
        POD_PHASE_SECONDS.observe(delta, phase)
        self.evaluator.add_phase(phase, delta)
        if phase == "launched":
            self.evaluator.add_ttfl(max(0.0, now - anchor), uid)
        elif phase == "bound":
            pending = max(0.0, now - anchor)
            POD_PENDING_SECONDS.observe(pending)
            self.evaluator.add_pending(pending, uid, slowest)

    def stamp_many(self, uids: Sequence[str], phase: str) -> None:
        """One lock round + batched histogram observes for a whole schedule
        (the provisioning pass stamps thousands of pods per phase edge;
        per-pod locking here would convoy the storm path the same way
        per-key metrics locking convoyed the reconcile pools)."""
        if not uids:
            return
        now = self.clock.now()
        deltas: List[float] = []
        finals: List[tuple] = []  # (uid, anchor, slowest) for bound/launched
        with self._lock:
            for uid in uids:
                entry = self._pods.get(uid)
                if entry is None or phase in entry.stamps:
                    continue
                entry.stamps[phase] = now
                deltas.append(max(0.0, now - entry.last))
                entry.last = now
                if phase in ("launched", "bound"):
                    slowest = (
                        self._slowest_phase_locked(entry)
                        if phase == "bound"
                        else ""
                    )
                    finals.append((uid, entry.anchor, slowest))
                if self.TERMINAL <= entry.stamps.keys():
                    self._pods.pop(uid, None)
            tracked = len(self._pods)
        TRACKED_PODS.set(float(tracked))
        if deltas:
            POD_PHASE_SECONDS.observe_many(deltas, phase)
            self.evaluator.add_phase_many(phase, deltas)
        for uid, anchor, slowest in finals:
            if phase == "launched":
                self.evaluator.add_ttfl(max(0.0, now - anchor), uid)
            else:
                pending = max(0.0, now - anchor)
                POD_PENDING_SECONDS.observe(pending)
                self.evaluator.add_pending(pending, uid, slowest)

    @staticmethod
    def _slowest_phase_locked(entry: _Entry) -> str:
        """The phase that ate the most of this pod's pending time — what a
        breach dump attributes (caller holds the tracker lock)."""
        ordered = sorted(entry.stamps.items(), key=lambda kv: kv[1])
        slowest, worst = "", -1.0
        previous = entry.anchor
        for phase, at in ordered:
            duration = at - previous
            if duration > worst:
                slowest, worst = phase, duration
            previous = at
        return slowest

    def reanchor(self, uid: str) -> None:
        """A displaced pod re-enters pending: fresh cycle, anchor = now."""
        now = self.clock.now()
        with self._lock:
            self._ensure_room_locked()
            entry = self._pods[uid] = _Entry(now)
            entry.stamps["unschedulable-seen"] = now
            tracked = len(self._pods)
        TRACKED_PODS.set(float(tracked))
        POD_PHASE_SECONDS.observe(0.0, "unschedulable-seen")

    def forget(self, uid: str) -> None:
        with self._lock:
            self._pods.pop(uid, None)
            tracked = len(self._pods)
        TRACKED_PODS.set(float(tracked))

    def pending_anchors(self, uids: Sequence[str]) -> Dict[str, float]:
        """Pending-cycle anchor (epoch seconds) per tracked uid — one lock
        round for a whole backlog. Untracked uids are omitted; callers treat
        a missing anchor as "newest" (the provisioning worker's aging refill
        sorts by this, so an untracked pod can never starve a tracked one)."""
        with self._lock:
            pods = self._pods
            return {uid: pods[uid].anchor for uid in uids if uid in pods}

    def tracked(self) -> int:
        with self._lock:
            return len(self._pods)

    def reset(self) -> None:
        """Test hook: drop all per-pod state (histograms are global and
        stay, like every other REGISTRY metric)."""
        with self._lock:
            self._pods.clear()
        TRACKED_PODS.set(0.0)

    def slo_snapshot(self) -> dict:
        return self.evaluator.evaluate(force=True)


OBS = PodLifecycleTracker()
# The tracker's evaluator shares the process recorder so breach events and
# launch decisions interleave in one timeline.
OBS.evaluator.recorder = RECORDER


# -- stack dumps (/debug/stacks) ---------------------------------------------


def stacks_snapshot(sample_s: float = 0.2) -> dict:
    """Every thread's current stack plus a short sampled hot-path profile
    (StackProf-backed — the same sampler the benchmarks use)."""
    import sys
    import traceback

    names = {t.ident: t.name for t in threading.enumerate()}
    threads = {}
    for ident, frame in sys._current_frames().items():
        name = names.get(ident, str(ident))
        threads[f"{name}-{ident}"] = traceback.format_stack(frame)
    hot: List[dict] = []
    samples = 0
    if sample_s > 0:
        from karpenter_tpu_torch.utils.stackprof import StackProf

        profiler = StackProf(interval_s=0.004).start()
        SYSTEM_CLOCK.sleep(sample_s)
        profiler.stop()
        samples = profiler.samples
        hot = [
            {"thread": thread, "frame": sig, "count": count}
            for (thread, sig), count in profiler.frames2.most_common(20)
        ]
    return {
        "pid": os.getpid(),
        "thread_count": len(threads),
        "threads": threads,
        "profile_samples": samples,
        "hot": hot,
    }


# -- crash / exit dumps --------------------------------------------------------


def _on_crash(site: str) -> None:
    RECORDER.record("crash", site=site)
    RECORDER.dump(tag=f"crash-{site.replace('.', '-')}")


crashpoints.on_crash(_on_crash)

if os.environ.get("KARPENTER_FLIGHT_DIR"):
    import atexit

    atexit.register(RECORDER.dump, "exit")
