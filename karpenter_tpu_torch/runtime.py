"""Runtime: the controller-manager process shell.

The port of karpenter_tpu/runtime.py (ref: cmd/controller/main.go +
pkg/controllers/manager.go): wires cluster watches to reconcile loops, runs
the per-Provisioner batch windows, serves /metrics and /healthz//readyz, and
holds a leader lock. Everything is thread-based (the reference's goroutines)
over either cluster store: the in-memory `Cluster`, or `kubeapi.
ApiServerCluster`, whose watch pumps keep its cache in step with a live
apiserver (cmd/controller.build_cluster picks one from --cluster-store).
Tests keep driving controllers synchronously without any of this.

The device is explicit: `Manager(cluster, cloud, options, device=None)` runs
its solver, encoder and consolidation solve on the CUDA card and raises
without one; `device="cpu"` runs the kernels' plain versions. Readiness
gates on the boot warmup (models/warmup.py: the kernels' builds and first
launches, then the host/device break-even calibration). A DEGRADED backend
verdict at boot makes `start` raise, and a warmup that fails on the card
stops the Manager (warmup_error): the port never pins the CPU or routes
solves to the host behind the card's back. On the card the host solve path
is opt-in (models/solver.host_route_open: KARPENTER_HOST_SOLVE=1 or auto).
`--solver remote` sends the solves to the solver sidecar at
`--solver-endpoint` (solver_service/: RemoteSolver); the Manager then needs
the card only for its own device users, the incremental encoder and the
consolidation solve.
"""

from __future__ import annotations

import heapq
import http.server
import json
import os
import random
import threading
from typing import Callable, Optional

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.controllers.cluster import Cluster
from karpenter_tpu_torch.controllers.consolidation import ConsolidationController
from karpenter_tpu_torch.controllers.counter import CounterController
from karpenter_tpu_torch.controllers.health import HealthController
from karpenter_tpu_torch.controllers.metrics import MetricsController, POLL_SECONDS
from karpenter_tpu_torch.controllers.node import NodeController
from karpenter_tpu_torch.controllers.instancegc import InstanceGcController
from karpenter_tpu_torch.controllers.interruption import InterruptionController
from karpenter_tpu_torch.controllers.market import MarketController
from karpenter_tpu_torch.controllers.podgc import PodGcController
from karpenter_tpu_torch.controllers.provisioning import (
    BATCH_IDLE_SECONDS,
    ProvisioningController,
)
from karpenter_tpu_torch.controllers.selection import SelectionController
from karpenter_tpu_torch.controllers.termination import TerminationController
from karpenter_tpu_torch.device import DeviceLike
from karpenter_tpu_torch.models.solver import (
    CostSolver,
    GreedySolver,
    NativeSolver,
    TPUSolver,
)
from karpenter_tpu_torch.utils import logging as klog
from karpenter_tpu_torch.utils.backoff import jittered_s
from karpenter_tpu_torch.utils.crashpoints import crashpoint
from karpenter_tpu_torch.utils.fence import WriteFence, bind_thread
from karpenter_tpu_torch.utils.metrics import REGISTRY
from karpenter_tpu_torch.utils.obs import OBS, RECORDER, stacks_snapshot
from karpenter_tpu_torch.utils.options import Options

# Reconcile-loop health metrics, mirroring what the reference's controllers
# dashboard graphs (grafana-dashboards/karpenter-controllers.json reads
# workqueue_depth, controller_runtime_reconcile_total, and the reconcile
# duration histogram that controller-runtime exports for every controller).
WORKQUEUE_DEPTH = REGISTRY.gauge(
    "workqueue_depth", "Items queued per reconcile loop", ["name"]
)
RECONCILE_TOTAL = REGISTRY.counter(
    "reconcile_total",
    "Reconciles per loop by outcome (success|requeue|error)",
    ["controller", "result"],
)
RECONCILE_DURATION = REGISTRY.histogram(
    "reconcile_time_seconds", "Reconcile latency per loop", ["controller"]
)
# Degradation oracle for the chaos storms (docs/design/chaos.md): a sweep
# that fails keeps its loop thread alive and re-enters after backoff — this
# series is how operators see the degradation (by exception class), and how
# `make chaos-smoke` proves the loops absorbed it.
SWEEP_FAILURES_TOTAL = REGISTRY.counter(
    "sweep_failures_total",
    "Failed reconcile sweeps by loop and exception class",
    ["controller", "reason"],
)
# Leader-election health (docs/operations.md HA runbook): transitions count
# observed generation bumps (a handoff — alert on a flapping rate), and the
# takeover histogram is the campaign wait from first refused CAS to the win
# (the availability gap a standby actually closes). The fence-rejection
# counter lives with the fence itself (utils/fence.py).
LEADER_TRANSITIONS_TOTAL = REGISTRY.counter(
    "leader_transitions_total", "Observed lease-generation bumps (handoffs)"
)
LEADER_TAKEOVER_SECONDS = REGISTRY.histogram(
    "leader_takeover_seconds",
    "Campaign wait from first refused lease CAS to acquisition",
)


class ReconcileLoop:
    """A keyed reconcile queue with delayed requeue — the controller-runtime
    workqueue analogue. reconcile(key) returns None (done) or a delay in
    seconds to requeue."""

    def __init__(
        self,
        name: str,
        reconcile: Callable,
        concurrency: int = 1,
        chunk: int = 1,
        fence: Optional[WriteFence] = None,
    ):
        self.name = name
        self.reconcile = reconcile
        self.concurrency = concurrency
        # The cluster's write fence, bound to each worker thread so the
        # crashpoint abort gate (utils/fence.py) can kill a deposed leader's
        # in-flight sweep at its next commit point.
        self.fence = fence
        # Keys popped per wake-up. The default 1 preserves strict one-at-a-
        # time dispatch (right for loops whose reconciles block on RPCs);
        # CPU-bound high-volume loops (selection) set it higher so a pod
        # storm costs one queue/metric lock round per CHUNK keys instead of
        # per key — at 128 workers the per-key locking convoyed the whole
        # pipeline (bench_pod_storm, sampled).
        self.chunk = max(1, chunk)
        self.log = klog.named(name)
        # Wake coalescing for chunked pools (guarded by _cv): _waiting
        # counts workers inside cv.wait(). A notify is needed ONLY when
        # every worker is waiting — any non-waiting worker re-checks the
        # heap under the cv before it can sleep, so it picks up new keys
        # without a wake (the counter window is race-free: enqueue holds
        # the cv, and a worker not counted as waiting is by definition on
        # its way to that re-check). Waking a thread per enqueue at high
        # concurrency is pure context-switch churn (sampled as the top
        # residual cost of the 128-thread pod storm). chunk=1 loops keep
        # per-key notifies: their reconciles block on RPCs, where per-key
        # parallelism is the point.
        # Per-key consecutive-failure streaks for the error backoff. A key
        # CAN be reconciled by two workers at once (a watch-event enqueue
        # during an in-flight reconcile re-queues it, and a second worker
        # may pop it before the first finishes), so the read-modify-write
        # must hold the cv lock or increments race.
        self._err_streak: dict = {}  # vet: guarded-by(self._cv)
        self._waiting = 0  # vet: guarded-by(self._cv)
        self._pops = 0  # vet: guarded-by(self._cv) — chunk pops ever (start()'s grabbed-work escape)
        self._heap: list = []  # vet: guarded-by(self._cv) — (due_time, seq, key)
        self._queued: set = set()  # vet: guarded-by(self._cv)
        self._due: dict = {}  # vet: guarded-by(self._cv) — key -> earliest pending due time
        self._cv = threading.Condition()
        self._seq = 0
        self._stop = False
        self._threads: list = []

    def enqueue(self, key, delay: float = 0.0) -> None:
        import time as _time

        if delay == 0.0:
            # Lock-free duplicate suppression (dict reads are GIL-atomic): a
            # key already queued and due NOW covers this enqueue entirely.
            # Safe against the pop race — cache writes happen BEFORE the
            # watch notify that lands here, so a worker that pops the key
            # concurrently still reconciles state at least as new as the
            # event's. Bind fan-out storms re-enqueue the same few node keys
            # tens of thousands of times; this keeps them off the lock.
            due = self._due.get(key)  # vet: unguarded(GIL-atomic dict read; rationale above)
            if due is not None and due <= _time.monotonic():
                return
        with self._cv:
            if self._enqueue_locked(key, delay, _time.monotonic()):
                WORKQUEUE_DEPTH.set(len(self._queued), self.name)
                self._notify_locked(1)

    def enqueue_many(self, pairs) -> None:
        """Enqueue a batch of (key, delay) under ONE lock round — the
        chunked reconcile loop requeues every key of a chunk at once, and
        per-key locking here was the top contention point of a 128-thread
        pod storm (sampled)."""
        import time as _time

        if not pairs:
            return
        with self._cv:
            now = _time.monotonic()
            added = 0
            for key, delay in pairs:
                added += 1 if self._enqueue_locked(key, delay, now) else 0
            if added:
                WORKQUEUE_DEPTH.set(len(self._queued), self.name)
                self._notify_locked(added)

    def _notify_locked(self, added: int) -> None:
        """Wake waiters for `added` new entries (caller holds _cv). Chunked
        pools notify only when the whole pool is asleep: any awake worker
        re-checks the heap before sleeping and drains every due key up to
        its chunk, so it collects these entries without a wake."""
        if self.chunk == 1:
            self._cv.notify(min(added, self.concurrency))
        elif self._waiting >= len(self._threads):
            # Empty _threads (pre-start enqueue) compares 0 >= 0: notify is
            # a harmless no-op and the seeding path stays unsurprising.
            self._cv.notify()

    def _enqueue_locked(self, key, delay: float, now: float) -> bool:
        """Insert under the held cv. An entry already due at-or-before this
        one covers it; an EARLIER enqueue (e.g. a watch event while the key
        sits in a long backoff) pulls the work forward, like workqueue.Add
        during rate-limited backoff — the old entry is lazily dropped when
        it pops."""
        due = now + delay
        if key in self._queued and due >= self._due.get(key, float("inf")):
            return False
        self._queued.add(key)
        self._due[key] = due
        self._seq += 1
        heapq.heappush(self._heap, (due, self._seq, key))
        return True

    def start(self) -> None:
        import time as _time

        for i in range(self.concurrency):
            thread = threading.Thread(
                target=self._run, name=f"{self.name}-{i}", daemon=True
            )
            thread.start()
            self._threads.append(thread)
        # Wait for the pool to park (every worker in cv.wait) before
        # declaring the loop started: a high-concurrency pool's boot
        # stampede — N fresh threads racing through the cv for the first
        # time — otherwise lands on top of the first real traffic. Bounded
        # wait; a pool that grabbed real work immediately is also "ready"
        # (_pops counts chunk pops, so consumed-and-emptied work still
        # satisfies the escape instead of spinning out the full deadline).
        deadline = _time.monotonic() + 1.0
        while _time.monotonic() < deadline:
            with self._cv:
                if self._waiting >= self.concurrency or self._pops:
                    break
            _time.sleep(0.001)

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()

    def _run(self) -> None:
        import time as _time

        if self.fence is not None:
            bind_thread(self.fence)
        while True:
            with self._cv:
                while not self._stop and (
                    not self._heap or self._heap[0][0] > _time.monotonic()
                ):
                    timeout = (
                        self._heap[0][0] - _time.monotonic() if self._heap else None
                    )
                    self._waiting += 1
                    try:
                        self._cv.wait(timeout=timeout)
                    finally:
                        self._waiting -= 1
                if self._stop:
                    return
                keys = self._pop_due_locked()
            if keys:
                self._reconcile_chunk(keys)

    def _pop_due_locked(self) -> list:
        """Pop every due key up to the chunk budget in one lock round
        (caller holds _cv); stale heap entries (superseded by an earlier
        enqueue) are dropped without consuming budget."""
        import time as _time

        keys = []
        now = _time.monotonic()
        while self._heap and self._heap[0][0] <= now and len(keys) < self.chunk:
            popped_due, _, key = heapq.heappop(self._heap)
            if key not in self._queued or self._due.get(key) != popped_due:
                continue  # superseded by an earlier enqueue: stale entry
            self._queued.discard(key)
            self._due.pop(key, None)
            keys.append(key)
        if keys:
            self._pops += 1
        WORKQUEUE_DEPTH.set(len(self._queued), self.name)
        return keys

    # Error-requeue backoff: a key whose reconcile keeps failing (an API
    # outage, a poisoned object) re-enters at 2^n seconds up to the cap —
    # the loop thread stays alive and the key keeps probing, but a
    # persistent fault can't hot-loop the controller against a degraded
    # apiserver. Any success resets the streak; a watch event pulls the
    # key forward early (enqueue with delay 0 supersedes a backoff entry).
    ERROR_BACKOFF_BASE_S = 1.0
    ERROR_BACKOFF_CAP_S = 30.0

    def _error_backoff_s(self, key) -> float:
        from karpenter_tpu_torch.utils.backoff import capped_backoff_s

        with self._cv:
            streak = self._err_streak.get(key, 0) + 1
            self._err_streak[key] = streak
        return capped_backoff_s(
            self.ERROR_BACKOFF_BASE_S, self.ERROR_BACKOFF_CAP_S, streak
        )

    def forget(self, key) -> None:
        """Drop a terminally deleted key's backoff streak. The streak is
        only ever popped on a SUCCESSFUL reconcile — a key that erred its
        way out of existence (deleted mid-outage) would otherwise hold its
        entry forever, one leak per churned pod/node over a long soak. The
        pending queue entry (if any) self-heals: the key pops, reconciles
        to a not-found no-op, and leaves no state behind."""
        with self._cv:
            self._err_streak.pop(key, None)

    def err_streak_size(self) -> int:
        """Soak-oracle accessor: backoff entries currently held."""
        with self._cv:
            return len(self._err_streak)

    def _reconcile_chunk(self, keys: list) -> None:
        """Reconcile a popped chunk; metrics are recorded once per chunk
        (per-key durations, batched) so high-concurrency pools don't convoy
        on the registry locks."""
        import time as _time

        durations = []
        outcomes = {"success": 0, "requeue": 0, "error": 0}
        requeues = []
        for key in keys:
            began = _time.perf_counter()
            try:
                result = self.reconcile(key)
                outcomes["requeue" if result is not None else "success"] += 1
                with self._cv:
                    self._err_streak.pop(key, None)
            except Exception as error:  # noqa: BLE001 — must not kill the loop
                self.log.exception("reconcile %r failed", key)
                result = self._error_backoff_s(key)
                outcomes["error"] += 1
                SWEEP_FAILURES_TOTAL.inc(self.name, type(error).__name__)
            durations.append(_time.perf_counter() - began)
            if result is not None:
                requeues.append((key, float(result)))
        RECONCILE_DURATION.observe_many(durations, self.name)
        for outcome, count in outcomes.items():
            if count:
                RECONCILE_TOTAL.inc(self.name, outcome, amount=count)
        self.enqueue_many(requeues)


class LeaderElector:
    """Lease-based leader election over the cluster store
    (ref: cmd/controller/main.go:80-81 — controller-runtime leader election
    on a coordination.k8s.io Lease). One candidate holds a named lease and
    renews it at RENEW_SECONDS; rivals CAS-acquire and win only after the
    holder's LEASE_SECONDS expire without renewal. Losing a held lease (e.g.
    a renewal pause longer than the TTL) fires on_lost — production wiring
    stops the manager, matching the reference's exit-on-lost-lease.

    Scope note: mutual exclusion spans exactly the processes sharing this
    Cluster store. Over the in-memory store that is one process (the chart
    pins replicas=1); an apiserver-backed store extends it cluster-wide."""

    LEASE_NAME = "karpenter-tpu-leader"
    LEASE_SECONDS = 15.0
    RENEW_SECONDS = 5.0

    def __init__(self, cluster, identity: str, on_lost=None, rng=None):
        self.cluster = cluster
        self.identity = identity
        self.on_lost = on_lost
        self.is_leader = threading.Event()
        # The lease generation (its transitions counter) captured at
        # acquire — the fencing token. None until the first win.
        self.generation: Optional[int] = None
        # Renew/campaign waits are jittered (utils/backoff.jittered_s) so
        # replicas sharing the 5s cadence don't CAS the lease in lockstep;
        # tests inject a seeded rng.
        self._rng = rng if rng is not None else random.Random()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_renew: Optional[float] = None
        # Stamped at the first refused CAS of a campaign; a win after a
        # non-None stamp is a TAKEOVER (someone held the lease when we
        # started wanting it) and observes leader_takeover_seconds.
        self._campaign_began: Optional[float] = None

    def try_acquire(self) -> bool:
        won = self.cluster.acquire_lease(
            self.LEASE_NAME, self.identity, self.LEASE_SECONDS
        )
        now = self.cluster.clock.now()
        if not won:
            if self._campaign_began is None:
                self._campaign_began = now
            return False
        generation = int(won)
        self._last_renew = now
        fresh = not self.is_leader.is_set()
        if generation != (self.generation or 0):
            LEADER_TRANSITIONS_TOTAL.inc()
        self.generation = generation
        # Arm BEFORE is_leader flips: the moment a waiter sees leadership
        # it may start mutating, and those writes must already carry the
        # new generation.
        self.cluster.fence.arm(self.identity, generation)
        if fresh:
            if self._campaign_began is not None:
                waited = max(0.0, now - self._campaign_began)
                LEADER_TAKEOVER_SECONDS.observe(waited)
                RECORDER.record(
                    "leader",
                    action="takeover",
                    holder=self.identity,
                    generation=generation,
                    waited_s=round(waited, 3),
                )
            else:
                RECORDER.record(
                    "leader",
                    action="acquire",
                    holder=self.identity,
                    generation=generation,
                )
            self._campaign_began = None
            self.is_leader.set()
            crashpoint("leader.after-acquire")
        return True

    def acquire(self, blocking: bool = True, poll_s: float = 1.0) -> bool:
        """Campaign until leadership (blocking) or one attempt; then keep
        renewing in the background."""
        while not self.try_acquire():
            if not blocking:
                return False
            if self._stop.wait(timeout=jittered_s(poll_s, rng=self._rng)):
                return False
        self._thread = threading.Thread(
            target=self._renew_loop, name="leader-renew", daemon=True
        )
        self._thread.start()
        return True

    def _renew_once(self) -> bool:
        """One renewal attempt; on failure (someone took our expired lease)
        drops leadership and fires on_lost.

        Fencing: if more than LEASE_SECONDS elapsed since our last successful
        renewal (a pause longer than the TTL — GC, suspend, store outage),
        the lease may have expired and a rival may have acquired it; re-CASing
        could steal it back mid-term, so leadership is declared lost WITHOUT
        attempting the CAS. The reference's leaderelection library likewise
        treats a missed renew deadline as lost leadership."""
        crashpoint("leader.before-renew")
        now = self.cluster.clock.now()
        if self._last_renew is None or now - self._last_renew > self.LEASE_SECONDS:
            self._lose()
            return False
        won = self.cluster.acquire_lease(
            self.LEASE_NAME, self.identity, self.LEASE_SECONDS
        )
        if won:
            self._last_renew = self.cluster.clock.now()
            return True
        self._lose()
        return False

    def _lose(self) -> None:
        """Leadership is gone: revoke the write fence FIRST — before on_lost
        and before is_leader clears — so no in-flight sweep can slip a write
        out between the loss and the manager stopping."""
        self.cluster.fence.revoke(self.identity)
        self.is_leader.clear()
        RECORDER.record(
            "leader",
            action="lose",
            holder=self.identity,
            generation=self.generation,
        )
        if self.on_lost is not None:
            self.on_lost()

    def _renew_loop(self) -> None:
        while not self._stop.wait(
            timeout=jittered_s(self.RENEW_SECONDS, rng=self._rng)
        ):
            if not self._renew_once():
                return

    def release(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        if self.is_leader.is_set():
            self.cluster.release_lease(self.LEASE_NAME, self.identity)
            self.cluster.fence.disarm(self.identity)
            self.is_leader.clear()


class LeaderLock:
    """Single-host leader election stand-in: an exclusive file lock.
    Kept for single-process deployments without a shared store; in-cluster
    runs use LeaderElector over the Lease analogue."""

    def __init__(self, path: Optional[str] = None):
        # In the process's temporary directory (TMPDIR), not a fixed path.
        if path is None:
            import tempfile

            path = os.path.join(tempfile.gettempdir(), "karpenter-tpu-torch-leader.lock")
        self.path = path
        self._file = None

    def acquire(self, blocking: bool = True) -> bool:
        import fcntl

        self._file = open(self.path, "w")
        try:
            fcntl.flock(
                self._file,
                fcntl.LOCK_EX | (0 if blocking else fcntl.LOCK_NB),
            )
            return True
        except OSError:
            self._file.close()
            self._file = None
            return False

    def release(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


def make_solver(name: str, endpoint: str = "", device: DeviceLike = None):
    """The solver a Manager runs, by its --solver name. `device` places the
    device-backed solvers (ffd, cost): None is the card. "remote" solves on
    the sidecar at `endpoint` and never touches the card itself."""
    if name == "remote":
        # The solver-sidecar plugin boundary: solve RPCs to `endpoint`, host
        # greedy fallback + 30s blackout when it's unreachable.
        from karpenter_tpu_torch.solver_service.client import RemoteSolver

        return RemoteSolver(endpoint)
    if name == "greedy":
        return GreedySolver()
    if name == "native":
        # Front-load the build here, at startup, rather than inside the first
        # reconcile; degrade loudly if no toolchain.
        from karpenter_tpu_torch.ops import native

        if not native.available():
            klog.named("runtime").warning(
                "solver=native requested but the native library is "
                "unavailable (no C++ toolchain?); falling back to greedy"
            )
            return GreedySolver()
        return NativeSolver()
    if name == "ffd":
        return TPUSolver(mode="ffd", device=device)
    if name == "cost":
        return CostSolver(device=device)
    raise ValueError(f"unknown solver {name!r}")


class Manager:
    """Ref: pkg/controllers/manager.go RegisterControllers + cmd wiring."""

    def __init__(
        self, cluster: Cluster, cloud, options: Options, device: DeviceLike = None
    ):
        self.cluster = cluster
        self.cloud = cloud
        self.options = options
        # Places the solver, the incremental encoder and the consolidation
        # solve: None is the card, "cpu" the kernels' plain versions.
        self.device = device
        self.log = klog.named("manager")
        self.solver = make_solver(options.solver, options.solver_endpoint, device)
        # The incremental encoder: subscribes to the store's verb-level
        # watch feed and keeps device-resident cluster tensors synced
        # O(churn); provisioning, consolidation, and interruption all solve
        # against it (docs/design/incremental-encode.md).
        from karpenter_tpu_torch.models.cluster_state import DeviceClusterState

        self.cluster_state = DeviceClusterState(
            cluster,
            compaction_threshold=options.encode_compaction_threshold,
            device=device,
        )
        # The pod-latency SLO pipeline (utils/obs.py): the lifecycle tracker
        # rides the same verb-level watch feed as the incremental encoder —
        # O(churn) per sweep — and the evaluator takes its targets from the
        # --slo-pending-p99 / --slo-ttfl flags. Sharing the store's clock
        # keeps phase deltas honest under fake-clock harnesses.
        OBS.configure(
            clock=cluster.clock,
            slo_pending_p99=options.slo_pending_p99,
            slo_ttfl=options.slo_ttfl,
        )
        RECORDER.configure(clock=cluster.clock)
        OBS.attach(cluster)
        self.provisioning = ProvisioningController(
            cluster, cloud, self.solver, cluster_state=self.cluster_state,
            queue_max_pods=options.provision_queue_max_pods,
        )
        self.selection = SelectionController(cluster, self.provisioning)
        self.termination = TerminationController(cluster, cloud)
        # ONE voluntary-disruption ledger spans every voluntary actor —
        # consolidation, drift/expiration, and emptiness deletes all draw on
        # the same --disruption-budget, with per-reason caps nested inside.
        from karpenter_tpu_torch.controllers.eligibility import DisruptionLedger
        from karpenter_tpu_torch.controllers import eligibility as _eligibility

        self.disruption_ledger = DisruptionLedger(
            cluster,
            budget=options.disruption_budget,
            reason_caps={
                _eligibility.REASON_CONSOLIDATION: (
                    options.consolidation_max_disruption
                ),
                _eligibility.REASON_DRIFT: options.drift_max_disruption,
            },
        )
        self.node = NodeController(
            cluster,
            liveness_timeout=options.node_liveness_timeout,
            ledger=self.disruption_ledger,
        )
        self.counter = CounterController(cluster)
        self.metrics = MetricsController(cluster)
        self.podgc = PodGcController(cluster)
        self.instancegc = InstanceGcController(cluster, cloud)
        # Live market (market/): ONE PriceBook per controller process,
        # built BEFORE the controllers that feed or read it.
        from karpenter_tpu_torch.market.pricebook import PriceBook, set_active_book

        self.price_book = PriceBook(
            clock=cluster.clock,
            reprice_threshold=options.reprice_threshold,
        )
        self.interruption = InterruptionController(
            cluster,
            cloud,
            self.provisioning,
            self.termination,
            escalate_fraction=options.interruption_escalate_fraction,
            cluster_state=self.cluster_state,
            price_book=self.price_book,
        )
        self.health = HealthController(
            cluster,
            cloud,
            self.provisioning,
            self.termination,
            unreachable_timeout=options.node_unreachable_timeout,
            drain_stuck_timeout=options.drain_stuck_timeout,
            cluster_state=self.cluster_state,
        )
        self.consolidation = ConsolidationController(
            cluster,
            cloud,
            self.provisioning,
            self.termination,
            max_disruption=options.consolidation_max_disruption,
            cooldown_seconds=options.consolidation_cooldown,
            cluster_state=self.cluster_state,
            ledger=self.disruption_ledger,
            device=device,
        )
        # Drift sweep: spec-hash + provider-side + expiration detection with
        # budgeted rolling replacement (docs/design/drift.md). Constructed
        # after consolidation so the two share the ledger and the same
        # provisioning/termination plumbing.
        from karpenter_tpu_torch.controllers.drift import DriftController

        self.drift = DriftController(
            cluster,
            cloud,
            self.provisioning,
            self.termination,
            ledger=self.disruption_ledger,
            enabled=options.drift_enabled,
        )
        # The book (built above, before the controllers that feed it) folds
        # the provider's tick stream; set_active_book makes it the book the
        # solver-layer penalty/cache hooks read, attach_market makes the
        # provider's ADVERTISED spot prices track it, and the market sweep
        # requeues the cost controllers on debounced reprices. A restarted
        # Manager builds a fresh book and re-folds the provider's replayable
        # history from seq 0 — reconstructing the exact pre-crash state AND
        # generation (docs/design/market.md).
        set_active_book(self.price_book)
        cloud.attach_market(self.price_book)
        self.market = MarketController(
            cluster,
            cloud,
            self.price_book,
            debounce_seconds=options.reprice_debounce,
            # 0 = auto: the provider knows its own safe cadence (1s for the
            # in-memory fake, 15s on EC2 where a sweep is a paginated
            # DescribeSpotPriceHistory).
            sweep_seconds=options.market_poll_interval
            or getattr(cloud, "MARKET_POLL_DEFAULT_S", 1.0),
        )
        self.market.requeue = self._reprice_requeue
        self.reprice_requeues = 0
        self.ready = threading.Event()
        # Set once the solver's compile debt is paid (immediately for host
        # solvers). Gates /readyz AND the batch loop: a batch window that
        # closes during warmup holds its pods until the ladder is warm,
        # so the first live solve runs at steady state — the reference boots
        # with zero compile debt (cmd/controller/main.go:61-99), and with
        # this, so does the default in-process deployment.
        self.warm = threading.Event()
        self._warming_can_serve = bool(
            getattr(self.solver, "host_fallback_available", lambda: False)()
        )
        # Pulsed by workers when a batch window FILLS (ProvisionerWorker
        # .batch_full); the batch loop waits on it so full windows
        # provision immediately.
        self._batch_full = threading.Event()
        self.provisioning.batch_full = self._batch_full
        self._stop = threading.Event()
        # Warm-standby mode (start_standby): the informer cache and the
        # DeviceClusterState sync run (both ride the store's watch feed,
        # wired at construction), the solver warmup ladder runs, but no
        # reconcile loop starts and /readyz answers 503 "standby" until
        # start() activates on takeover.
        self.standby = threading.Event()
        self._warmup_kicked = False
        # Seconds the boot warmup took (models/warmup.warmup_ladder), once
        # it has run; the error that stopped the Manager, when it failed on
        # the card.
        self.warmup_s: Optional[float] = None
        self.warmup_error: Optional[BaseException] = None

        # Reconcile loops. The reference runs selection at
        # MaxConcurrentReconciles=10,000 (selection/controller.go:166) where
        # each reconcile parks on network I/O; here selection reconciles the
        # informer cache (CPU-bound under the GIL) and the loop is keyed +
        # collapse-deduped, with the batch overflow held by the worker —
        # so the envelope is picked from pod-storm data (bench.py
        # bench_pod_storm: 10k-pod drain ~1.8s at 8 threads and within
        # ~20% of that at 128 — extra threads buy nothing under the GIL,
        # they only pay wake/cache tax; see Options.selection_concurrency).
        self.loops = {
            "selection": ReconcileLoop(
                "selection",
                lambda key: self.selection.reconcile(*key),
                concurrency=options.selection_concurrency,
                # Selection reconciles the informer cache — pure CPU, ~100µs
                # each — so chunked dispatch amortizes queue/metric locking
                # across a storm without delaying anything slow.
                chunk=64,
            ),
            "provisioning": ReconcileLoop(
                "provisioning", self.provisioning.reconcile, concurrency=2
            ),
            "termination": ReconcileLoop(
                "termination", self.termination.reconcile, concurrency=4
            ),
            "node": ReconcileLoop("node", self.node.reconcile, concurrency=4),
            "counter": ReconcileLoop(
                "counter", lambda key: self.counter.reconcile(key), concurrency=1
            ),
            "metrics": ReconcileLoop(
                "metrics", self.metrics.reconcile, concurrency=1
            ),
            # Orphaned-pod reaper (kube-controller-manager podgc analogue):
            # a periodic self-requeuing sweep, like the metrics poll.
            "podgc": ReconcileLoop(
                "podgc", self.podgc.reconcile, concurrency=1
            ),
            # Leaked-capacity reaper: periodic self-requeuing sweep
            # reconciling provider instances (by ownership tag) against
            # Nodes — the money-side analogue of podgc.
            "instancegc": ReconcileLoop(
                "instancegc", self.instancegc.reconcile, concurrency=1
            ),
            # Interruption sweep: poll provider reclaim notices, drain
            # ahead of the deadline, replace before the pods land.
            "interruption": ReconcileLoop(
                "interruption", self.interruption.reconcile, concurrency=1
            ),
            # Node-health sweep: heartbeat staleness + NotReady detection
            # with flap hysteresis, escalating through the drain ladder.
            "health": ReconcileLoop(
                "health", self.health.reconcile, concurrency=1
            ),
            # Consolidation sweep: re-solve the live cluster for cost and
            # shed/replace capacity the workload no longer justifies.
            "consolidation": ReconcileLoop(
                "consolidation", self.consolidation.reconcile, concurrency=1
            ),
            # Drift sweep: compare live nodes against the current spec hash
            # and the provider's launch-template generation; roll drifted
            # capacity through the budgeted replacement path.
            "drift": ReconcileLoop(
                "drift", self.drift.reconcile, concurrency=1
            ),
            # Market sweep: poll the provider's price/ICE feed, fold ticks
            # into the PriceBook, requeue cost decisions on debounced
            # reprices — the dynamic analogue of the 5-minute drift requeue.
            "market": ReconcileLoop(
                "market", self.market.reconcile, concurrency=1
            ),
        }
        # Every loop worker binds the cluster's write fence so a deposed
        # leader's in-flight sweep aborts at its next crashpoint site
        # (cooperative abort; utils/fence.py).
        for loop in self.loops.values():
            loop.fence = cluster.fence

    # --- watch fan-out (ref: controller Register() watch wiring) ------------

    def _on_event(self, kind: str, obj) -> None:
        if kind == "pod":
            # Only provisionable pods route through selection: its reconcile
            # is a no-op for anything else, and a 10k-pod storm's bind wave
            # would otherwise re-enqueue every just-bound pod for a pointless
            # (GIL-bound) pass. The reference pays the same event with a
            # network-parked reconcile; here the event thread can filter on
            # the object it already holds.
            if obj.is_provisionable():
                self.loops["selection"].enqueue((obj.namespace, obj.name))
            if obj.node_name:
                # pod-to-node events re-list the node (ref: node/controller.go:118-150)
                self.loops["node"].enqueue(obj.node_name)
        elif kind == "node":
            self.loops["node"].enqueue(obj.name)
            self.loops["termination"].enqueue(obj.name)
            provisioner = obj.labels.get(wellknown.PROVISIONER_NAME_LABEL)
            if provisioner:
                self.loops["counter"].enqueue(provisioner)
        elif kind == "provisioner":
            self.loops["provisioning"].enqueue(obj.name)
            self.loops["counter"].enqueue(obj.name)
            self.loops["metrics"].enqueue(obj.name)

    def _on_delta(self, verb: str, kind: str, obj) -> None:
        """Terminal deletes prune the per-key error-backoff streaks
        (ReconcileLoop.forget): a pod/node that erred its way out of
        existence would otherwise leak one streak entry per churned object
        for the life of the process — invisible in 10-second smokes, a
        steady drip over a soak. Rides the store's verb-level feed; the
        plain watch (no verb) cannot see deletes as deletes."""
        if verb != "delete":
            return
        if kind == "pod":
            self.loops["selection"].forget((obj.namespace, obj.name))
        elif kind == "node":
            self.loops["node"].forget(obj.name)
            self.loops["termination"].forget(obj.name)
        elif kind == "provisioner":
            for name in ("provisioning", "counter", "metrics"):
                self.loops[name].forget(obj.name)

    # --- batch loop ---------------------------------------------------------

    def _batch_loop(self) -> None:
        # The batch loop launches capacity, so its thread binds the fence
        # too: a provision pass caught mid-flight by a leadership loss
        # aborts at its next crashpoint site (utils/fence.py).
        bind_thread(self.cluster.fence)
        while not self._stop.is_set():
            # Wake on the next poll tick OR the instant a window fills —
            # a storm's full batches provision without paying up to a poll
            # interval of latency each (idle-closed windows still close on
            # the tick, since their edge is a clock passing, not an event).
            self._batch_full.wait(timeout=BATCH_IDLE_SECONDS / 5)
            self._batch_full.clear()
            if self._stop.is_set():
                return
            if not self.warm.is_set() and not self._warming_can_serve:
                # No host fallback: batches accumulate until the ladder is
                # warm, so no live batch ever pays the build stall. With a
                # fallback, provisioning continues — solves route host-side
                # via the warming preference (models/solver.py).
                continue
            for worker in list(self.provisioning.workers.values()):
                if worker.batch_ready():
                    try:
                        worker.provision()
                    except Exception as error:  # noqa: BLE001
                        self.log.exception("provisioning pass failed")
                        # The batch loop's own degradation signal: a failed
                        # provision pass (API storm mid-bind, launch fault)
                        # leaves the batch queued and the loop alive.
                        SWEEP_FAILURES_TOTAL.inc("batch", type(error).__name__)

    def _requeue_loop(self) -> None:
        """5-minute provisioner refresh to pick up instance-type drift
        (ref: provisioning/controller.go:80)."""
        while not self._stop.wait(timeout=ProvisioningController.REQUEUE_SECONDS):
            for provisioner in self.cluster.list_provisioners():
                self.loops["provisioning"].enqueue(provisioner.name)

    def _reprice_requeue(self) -> None:
        """The market sweep's requeue hook: a debounced reprice pulls every
        provisioner refresh AND a consolidation sweep forward NOW (enqueue
        at delay 0 supersedes the poll interval) — the dynamic analogue of
        _requeue_loop's 5-minute drift timer. Counted on reprice_requeues."""
        self.reprice_requeues += 1
        for provisioner in self.cluster.list_provisioners():
            self.loops["provisioning"].enqueue(provisioner.name)
        self.loops["consolidation"].enqueue("sweep")
        # A reprice can flip a spot pool's sustained-ICE drift verdict, so
        # the drift sweep is pulled forward with the other cost decisions.
        self.loops["drift"].enqueue("sweep")

    # --- lifecycle ----------------------------------------------------------

    def start_standby(self) -> None:
        """Warm standby: everything read-only a takeover would otherwise pay
        for. The informer cache and DeviceClusterState sync already ride the
        store's watch feed (wired at construction), so this only kicks the
        solver warmup ladder — the kernels' builds and first launches —
        leaving /readyz at 503
        "standby" and every reconcile loop parked until start()."""
        self.standby.set()
        self._kick_warmup()

    def start(self) -> None:
        if self.warmup_error is not None:
            # A standby whose warmup failed on the card: never activate.
            raise RuntimeError("the solver warmup failed on the card") from self.warmup_error
        self.standby.clear()
        self.cluster.watch(self._on_event)
        self.cluster.watch_deltas(self._on_delta)
        for loop in self.loops.values():
            loop.start()
        # Standalone eviction pump (ref: termination/eviction.go:45-57): the
        # queue drains even when no termination reconcile is in flight.
        self.termination.evictions.start()
        threading.Thread(
            target=self._batch_loop, name="provision-batcher", daemon=True
        ).start()
        threading.Thread(
            target=self._requeue_loop, name="backoff-requeue", daemon=True
        ).start()
        # Seed existing state.
        for provisioner in self.cluster.list_provisioners():
            self.loops["provisioning"].enqueue(provisioner.name)
            self.loops["metrics"].enqueue(provisioner.name)
        for pod in self.cluster.list_pods():
            self.loops["selection"].enqueue((pod.namespace, pod.name))
        for node in self.cluster.list_nodes():
            self.loops["node"].enqueue(node.name)
        self.loops["podgc"].enqueue("sweep")
        self.loops["instancegc"].enqueue("sweep")
        self.loops["interruption"].enqueue("sweep")
        self.loops["health"].enqueue("sweep")
        self.loops["consolidation"].enqueue("sweep")
        self.loops["drift"].enqueue("sweep")
        self.loops["market"].enqueue("sweep")
        self._kick_warmup()
        if self.warm.is_set() and not self._stop.is_set():
            # Activating from a standby whose warmup already finished: the
            # warmup thread set `warm` while `standby` held readiness back.
            self.ready.set()

    def _kick_warmup(self) -> None:
        """Start the solver warmup exactly once per Manager — standby kicks
        it early, activation reuses the result (bounded time-to-first-launch:
        a takeover never builds or first-launches a kernel on a live batch).
        A card that fails its boot probe stops the Manager and raises."""
        if self._warmup_kicked:
            return
        self._warmup_kicked = True
        if getattr(self.solver, "needs_device_warmup", False):
            from karpenter_tpu_torch.utils import backend_health

            # One verdict before any in-process device touch: a wedged card
            # at boot is refused with its reason — not a warmup thread
            # hanging in C behind a 503 forever, and never a quiet move to
            # the host (backend_probe_result=0 in /metrics).
            boot = backend_health.ensure_backend(getattr(self.solver, "device", self.device))
            if boot.state == backend_health.DEGRADED:
                self.stop()
                raise RuntimeError(
                    f"the card failed its liveness probe at boot: {boot.reason}"
                )
            else:
                threading.Thread(
                    target=self._warmup, name="solver-warmup", daemon=True
                ).start()
        else:
            self.warm.set()
            self._assert_ready()

    def _assert_ready(self) -> None:
        """warm -> ready, unless stopped (a deposed leader's loops are all
        down — /readyz must not flip back to 200) or still a standby (ready
        means 'routable for work'; a standby is warm but not active)."""
        if not self._stop.is_set() and not self.standby.is_set():
            self.ready.set()

    def _warmup(self) -> None:
        """The boot warmup (models/warmup.py): reconcile loops serve
        immediately; /readyz waits for the ladder, and batches either wait
        too or take the warming host preference. On the card a failed
        warmup (a kernel that does not build or launch, a calibration that
        fails) stops the Manager with its error in warmup_error: /healthz
        answers 503 and /readyz never 200, and no solve moves to the CPU.
        On the CPU it is logged and the Manager serves anyway."""
        from karpenter_tpu_torch.device import resolve_device
        from karpenter_tpu_torch.models.warmup import warmup_ladder

        device = resolve_device(getattr(self.solver, "device", self.device))
        try:
            self.warmup_s = warmup_ladder(device=device)
        except Exception as exc:  # noqa: BLE001 — the verdict is the device's
            if device.type == "cuda":
                self.log.exception("solver warmup failed on the card; stopping")
                self.warmup_error = exc
                self.stop()
                return
            self.log.exception("solver warmup failed; serving anyway")
        self.warm.set()
        self._assert_ready()

    def reload_options(self, changed: dict) -> None:
        """Apply a re-parsed reloadable Options subset (options.RELOADABLE)
        live — the SIGHUP / POST /debug/loglevel path. `changed` maps field
        name to new value (options.apply_reload's return)."""
        if not changed:
            return
        if "log_level" in changed:
            klog.set_level(changed["log_level"])
        if "slo_pending_p99" in changed or "slo_ttfl" in changed:
            OBS.configure(
                clock=self.cluster.clock,
                slo_pending_p99=self.options.slo_pending_p99,
                slo_ttfl=self.options.slo_ttfl,
            )
        self.log.info("reloaded options: %s", sorted(changed))

    def stop(self) -> None:
        self._stop.set()
        self._batch_full.set()  # unblock the batch loop promptly
        for loop in self.loops.values():
            loop.stop()
        self.termination.evictions.stop()
        self.ready.clear()

    def healthy(self) -> bool:
        """False once stopped — flips /healthz to 503 (a deposed leader must
        fail its liveness probe, not idle at 200)."""
        return not self._stop.is_set()


class _HTTPHandler(http.server.BaseHTTPRequestHandler):
    manager: Optional[Manager] = None

    def do_GET(self):  # noqa: N802 — http.server API
        if self.path == "/metrics":
            body = REGISTRY.render().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
        elif self.path == "/debug/flightrecorder":
            # The black box, on demand: a consistent snapshot of the
            # decision/fault ring with seq/dropped metadata so the reader
            # can prove it gap-free (docs/design/observability.md).
            body = RECORDER.dump_json().encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
        elif self.path == "/debug/slo":
            body = json.dumps(OBS.slo_snapshot(), default=str).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
        elif self.path == "/debug/stacks":
            # Instantaneous stacks + a short StackProf sample: "what is the
            # process wedged on / burning on" without attaching a debugger.
            body = json.dumps(stacks_snapshot(), default=str).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
        elif self.path == "/healthz":
            # Unhealthy once the manager stops (e.g. deposed leader) so the
            # liveness probe restarts the pod instead of letting a stopped
            # replica idle at 200.
            healthy = self.manager is None or self.manager.healthy()
            body = b"ok" if healthy else b"stopped"
            self.send_response(200 if healthy else 503)
            self.send_header("Content-Type", "text/plain")
        elif self.path == "/readyz":
            ready = self.manager is not None and self.manager.ready.is_set()
            if ready:
                body, status = b"ok", 200
            elif self.manager is not None and self.manager.standby.is_set():
                # A campaigning standby is healthy-but-not-routable: the
                # distinct body lets probes (and operators) tell a warm
                # standby from a replica that is genuinely not up yet.
                body, status = b"standby", 503
            else:
                body, status = b"not ready", 503
            self.send_response(status)
            self.send_header("Content-Type", "text/plain")
        elif self.path == "/debug/loglevel":
            body = json.dumps({"level": klog.get_level()}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
        else:
            body = b"not found"
            self.send_response(404)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):  # noqa: N802 — http.server API
        """POST /debug/loglevel with `debug` or `{"level": "debug"}` flips
        the root logger live — the remote half of the SIGHUP reload path
        (cmd/controller.py); both route through Manager.reload_options."""
        if self.path != "/debug/loglevel":
            body = b"not found"
            self.send_response(404)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        length = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(length).decode("utf-8", "replace").strip()
        level = raw
        if raw.startswith("{"):
            try:
                level = str(json.loads(raw).get("level", ""))
            except ValueError:
                level = ""
        level = level.strip().strip('"').lower()
        if level not in ("debug", "info", "warning", "error"):
            body = json.dumps({"error": f"unknown level {level!r}"}).encode()
            self.send_response(400)
        else:
            if self.manager is not None:
                self.manager.options.log_level = level
                self.manager.reload_options({"log_level": level})
            else:
                klog.set_level(level)
            body = json.dumps({"level": level}).encode()
            self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    do_PUT = do_POST  # noqa: N815 — same semantics either verb

    def log_message(self, *args):  # silence per-request logging
        pass


def serve_http(
    manager: Manager, port: int, address: str = ""
) -> http.server.ThreadingHTTPServer:
    # Default bind is all interfaces: the scrape/probe traffic this serves
    # arrives over the pod IP in a real deployment.
    handler = type("Handler", (_HTTPHandler,), {"manager": manager})
    server = http.server.ThreadingHTTPServer((address, port), handler)
    threading.Thread(
        target=server.serve_forever, name="http-serve", daemon=True
    ).start()
    return server
