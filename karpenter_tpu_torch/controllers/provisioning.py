"""Provisioning: the per-Provisioner batching worker and its controller.

Ref: pkg/controllers/provisioning/{controller,provisioner}.go. The controller
reconciles Provisioner objects — refreshing requirements from live instance
types, hash-comparing the spec, and hot-swapping the running worker. The
worker batches incoming pods (1s idle / 10s max window, 2000-pod cap),
schedules, solves, enforces limits, launches capacity, and binds pods.
"""

from __future__ import annotations

import copy
import hashlib
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from karpenter_tpu_torch import drift as driftlib
from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.pods import PodSpec
from karpenter_tpu_torch.api.provisioner import PodIncompatibleError, Provisioner
from karpenter_tpu_torch.api.requirements import Requirement, Requirements
from karpenter_tpu_torch.api.validation import default_provisioner, validate_provisioner
from karpenter_tpu_torch.cloudprovider import CloudProvider, NodeSpec
from karpenter_tpu_torch.api.taints import Taint
from karpenter_tpu_torch.controllers.cluster import Cluster, NotFoundError
from karpenter_tpu_torch.controllers.scheduling import Scheduler
from karpenter_tpu_torch.models.solver import GreedySolver, Solver
from karpenter_tpu_torch.ops.ffd import PackResult
from karpenter_tpu_torch.utils import logging as klog
from karpenter_tpu_torch.utils import tracing
from karpenter_tpu_torch.utils.crashpoints import any_armed, crashpoint
from karpenter_tpu_torch.utils.metrics import REGISTRY
from karpenter_tpu_torch.utils.obs import OBS, RECORDER
from karpenter_tpu_torch.utils.tracing import TRACER

# Batching envelope (ref: provisioner.go:42-47).
MAX_PODS_PER_BATCH = 2000
BATCH_IDLE_SECONDS = 1.0
BATCH_MAX_SECONDS = 10.0

# Admission cap per worker (batch window + overflow backlog together;
# --provision-queue-max-pods). Past it, `add` REFUSES and the pod rides
# selection's backoff requeue instead — bounded memory here, and the
# aging/retry pressure moves to the layer that already owns it. The default
# holds 25 full batch windows: a storm that deep is minutes of solve work
# away from the window anyway, so queueing more buys nothing but RSS.
DEFAULT_QUEUE_MAX_PODS = 50_000

# Pod binds fan out in parallel (ref: provisioner.go:239-247 ParallelizeUntil
# runs one goroutine per pod): each bind is an apiserver RPC in production,
# so without fan-out the bind stage dominates a large pass. The pool is
# shared across workers; goroutine-per-pod doesn't pay off for OS threads.
BIND_FANOUT = 32
_bind_pool: Optional[ThreadPoolExecutor] = None
_bind_pool_lock = threading.Lock()


def _bind_executor() -> ThreadPoolExecutor:
    global _bind_pool
    with _bind_pool_lock:
        if _bind_pool is None:
            _bind_pool = ThreadPoolExecutor(
                max_workers=BIND_FANOUT, thread_name_prefix="bind"
            )
        return _bind_pool

# Duration histograms around the three hot stages, matching the reference's
# only performance instrumentation (ref: scheduling/scheduler.go:34-47,
# binpacking/packer.go:41-55, provisioner.go:252-265 via metrics.Measure).
SCHEDULING_DURATION = REGISTRY.histogram(
    "allocation_scheduling_duration_seconds",
    "Duration of the constraint-grouping stage per batch",
)
SOLVE_DURATION = REGISTRY.histogram(
    "allocation_binpacking_duration_seconds",
    "Duration of solver packing per schedule batch (all of a pass's "
    "schedules solve together, sharing one device round trip)",
)
BIND_DURATION = REGISTRY.histogram(
    "allocation_bind_duration_seconds",
    "Duration of node creation + pod binding per packing",
)

# Overload visibility (docs/design/overload.md): current held pods per
# worker (batch window + overflow), refusals by reason, and the
# pending-cycle age of each pod at the moment its batch window closes for
# solving — the distribution a starving pod would push right.
PROVISION_QUEUE_DEPTH = REGISTRY.gauge(
    "provision_queue_depth",
    "Pods held by the provisioner worker (open batch window + overflow "
    "backlog)",
    ["provisioner"],
)
PROVISION_BACKPRESSURE_TOTAL = REGISTRY.counter(
    "provision_backpressure_total",
    "Pods refused at provisioning admission, by reason",
    ["reason"],
)
BATCH_WINDOW_AGE = REGISTRY.histogram(
    "batch_window_age_seconds",
    "Pending-cycle age of each pod when its batch window closes for "
    "solving (aging-ordered refill keeps the tail bounded under overload)",
    buckets=(0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0, 600.0),
)


def _batch_uids(schedules) -> List[str]:
    """Every pod uid across a pass's schedules — the lifecycle tracker's
    stamp_many unit (one lock round per phase edge for the whole batch)."""
    return [p.uid for s in schedules for p in s.pods]


def global_requirements(instance_types) -> Requirements:
    """Union of what the fleet actually offers, as In-requirements
    (ref: provisioning/controller.go:138-159 refreshes zones/types/arch/os/
    capacity-type from live instance types every reconcile)."""
    zones, names, archs, oses, capacity_types = set(), set(), set(), set(), set()
    for it in instance_types:
        zones |= set(it.zones())
        names.add(it.name)
        archs.add(it.architecture)
        oses |= set(it.operating_systems)
        capacity_types |= set(it.capacity_types())
    return Requirements(
        [
            Requirement.in_(wellknown.ZONE_LABEL, sorted(zones)),
            Requirement.in_(wellknown.INSTANCE_TYPE_LABEL, sorted(names)),
            Requirement.in_(wellknown.ARCH_LABEL, sorted(archs)),
            Requirement.in_(wellknown.OS_LABEL, sorted(oses)),
            Requirement.in_(wellknown.CAPACITY_TYPE_LABEL, sorted(capacity_types)),
        ]
    )


def spec_hash(provisioner: Provisioner) -> int:
    """Stable hash of the solver-relevant spec
    (ref: controller.go:111-125 uses hashstructure)."""
    spec = provisioner.spec
    constraints = spec.constraints
    return hash(
        (
            tuple(sorted(constraints.labels.items())),
            tuple(constraints.taints),
            constraints.requirements.canonical_key(),
            repr(sorted((constraints.provider or {}).items())),
            spec.ttl_seconds_after_empty,
            spec.ttl_seconds_until_expired,
            tuple(sorted(spec.limits.resources.items())) if spec.limits else None,
        )
    )


@dataclass
class ProvisionStats:
    scheduled_pods: int = 0
    launched_nodes: int = 0
    unschedulable_pods: int = 0
    launch_errors: List[Exception] = field(default_factory=list)


class ProvisionerWorker:
    """One batching loop per Provisioner (ref: provisioner.go:49-100 runs a
    goroutine; here `add` enqueues and `provision` drains — the runtime's
    thread loop calls provision on the batch window, tests call it directly)."""

    def __init__(
        self,
        provisioner: Provisioner,
        cluster: Cluster,
        cloud: CloudProvider,
        solver: Optional[Solver] = None,
        cluster_state=None,
        level_recorder=None,
        queue_max_pods: Optional[int] = None,
    ):
        self.provisioner = provisioner
        self.cluster = cluster
        self.cloud = cloud
        self.solver = solver or GreedySolver()
        # Admission cap (batch + overflow); see DEFAULT_QUEUE_MAX_PODS.
        self.queue_max_pods = queue_max_pods or DEFAULT_QUEUE_MAX_PODS
        # Reports each constrained solve's kernel-chosen relaxation level
        # back to selection's bookkeeping cache (selection.Preferences).
        self.level_recorder = level_recorder
        # Incremental encoder (models/cluster_state.DeviceClusterState):
        # when its delta-maintained tensors cover a schedule's batch, the
        # spec->tensor encode is skipped and the solve runs against the
        # device-resident state — O(churn) per sweep instead of O(cluster).
        self.cluster_state = cluster_state
        self.scheduler = Scheduler(cluster)
        self._pending: List[PodSpec] = []  # vet: guarded-by(self._lock)
        # Pods beyond the batch cap wait HERE, not in the selection queue: a
        # 50k-pod storm would otherwise need every overflowed pod
        # re-reconciled (1 Hz re-verify) to refill each 2000-pod batch —
        # measured at ~15s of GIL-bound queue mechanics per batch. The
        # reference survives that shape with 10k network-parked reconciles
        # (selection/controller.go:166); this runtime holds the backlog in
        # the worker and refills the window directly at each drain.
        self._overflow: List[PodSpec] = []  # vet: guarded-by(self._lock)
        self._pending_uids: set = set()  # vet: guarded-by(self._lock)
        self._lock = threading.Lock()
        self._first_add: Optional[float] = None  # vet: guarded-by(self._lock)
        self._last_add: Optional[float] = None  # vet: guarded-by(self._lock)
        # Saturation edge state: the flight recorder gets ONE event per
        # engage/release transition, never one per refused pod (a 50k-pod
        # refusal storm would evict every launch record from the ring).
        self._saturated = False  # vet: guarded-by(self._lock)
        self._node_seq = 0

    # --- batching (ref: provisioner.go:137-163) -----------------------------

    # Set by the runtime's batch loop: workers pulse it the moment a window
    # FILLS, so a full batch provisions immediately instead of waiting out
    # the loop's poll interval (idle-closed windows still ride the poll —
    # their closing edge is a clock passing, not an event).
    batch_full: Optional[threading.Event] = None

    def add(self, pod: PodSpec) -> bool:
        """Admit a pod into the open batch window, or the overflow backlog
        once the window is full — up to the admission cap. Returns True iff
        the worker HOLDS the pod (a duplicate re-add of a held pod counts);
        False means refused at the cap, and the caller (selection) keeps the
        pod on its backoff requeue ladder, where it already ages."""
        filled = False
        refused = engaged = False
        with self._lock:
            accepted = False
            depth = len(self._pending) + len(self._overflow)
            if pod.uid not in self._pending_uids:
                if depth >= self.queue_max_pods:
                    refused = True
                    engaged = not self._saturated
                    self._saturated = True
                else:
                    accepted = True
                    depth += 1
                    if len(self._pending) >= MAX_PODS_PER_BATCH:
                        self._overflow.append(pod)
                    else:
                        self._pending.append(pod)
                        filled = len(self._pending) >= MAX_PODS_PER_BATCH
                    self._pending_uids.add(pod.uid)
                    # Window clock moves only on GENUINE adds: duplicate
                    # re-verify adds would otherwise keep refreshing _last_add
                    # and hold a partial batch open to the 10s max instead of
                    # closing on the 1s idle.
                    now = self.cluster.clock.now()
                    if self._first_add is None:
                        self._first_add = now
                    self._last_add = now
        if refused:
            PROVISION_BACKPRESSURE_TOTAL.inc("queue-full")
            if engaged:
                RECORDER.record(
                    "backpressure",
                    provisioner=self.provisioner.name,
                    phase="engage",
                    depth=self.queue_max_pods,
                )
            return False
        if accepted:
            OBS.stamp(pod.uid, "batched")
            PROVISION_QUEUE_DEPTH.set(float(depth), self.provisioner.name)
        if filled and self.batch_full is not None:
            self.batch_full.set()
        return True

    def queue_depth(self) -> int:
        """Pods currently held (open window + overflow backlog)."""
        with self._lock:
            return len(self._pending) + len(self._overflow)

    def take_backlog(self) -> List[PodSpec]:
        """Drain EVERYTHING (batch + overflow) for hand-off to a replacement
        worker on spec-hash hot-swap."""
        with self._lock:
            backlog = self._pending + self._overflow
            self._pending = []
            self._overflow = []
            self._pending_uids = set()
            self._first_add = self._last_add = None
            self._saturated = False
        PROVISION_QUEUE_DEPTH.set(0.0, self.provisioner.name)
        return backlog

    def batch_ready(self) -> bool:
        """Window closed: 1s since last add or 10s since first, or full."""
        with self._lock:
            if not self._pending:
                return False
            if len(self._pending) >= MAX_PODS_PER_BATCH:
                return True
            now = self.cluster.clock.now()
            return (
                now - self._last_add >= BATCH_IDLE_SECONDS
                or now - self._first_add >= BATCH_MAX_SECONDS
            )

    def _drain(self) -> List[PodSpec]:
        now = self.cluster.clock.now()
        released = False
        with self._lock:
            batch = self._pending
            # Refill the next window straight from the overflow backlog —
            # its pods already waited a full window, so the next batch
            # starts its clock now rather than waiting for re-verifies.
            # Under pressure the refill is AGING-ORDERED: oldest pending
            # cycle first (lifecycle-tracker anchors — re-adds after a
            # refused/rescheduled round arrive out of arrival order, and a
            # plain FIFO would let them starve behind fresher waves). The
            # OBS lock is a leaf: nothing in the tracker calls back here.
            overflow = self._overflow
            if overflow:
                anchors = OBS.pending_anchors([p.uid for p in overflow])
                order = sorted(
                    range(len(overflow)),
                    key=lambda i: (anchors.get(overflow[i].uid, now), i),
                )
                overflow = [overflow[i] for i in order]
            self._pending = overflow[:MAX_PODS_PER_BATCH]
            self._overflow = overflow[MAX_PODS_PER_BATCH:]
            self._pending_uids = {p.uid for p in self._pending} | {
                p.uid for p in self._overflow
            }
            depth = len(self._pending) + len(self._overflow)
            if self._saturated and depth < self.queue_max_pods:
                self._saturated = False
                released = True
            if self._pending:
                self._first_add = self._last_add = now
            else:
                self._first_add = self._last_add = None
        PROVISION_QUEUE_DEPTH.set(float(depth), self.provisioner.name)
        if released:
            RECORDER.record(
                "backpressure",
                provisioner=self.provisioner.name,
                phase="release",
                depth=depth,
            )
        if batch:
            anchors = OBS.pending_anchors([p.uid for p in batch])
            BATCH_WINDOW_AGE.observe_many(
                [max(0.0, now - anchors.get(p.uid, now)) for p in batch]
            )
        return batch

    # --- the provisioning pass (ref: provisioner.go:102-135) ----------------

    def _live_batch(self, batch: List[PodSpec]) -> List[PodSpec]:
        """Re-fetch to drop pods bound/terminated since batching, but keep
        scheduling the BATCH copy ("Do not mutate the pod in case the
        scheduler relaxed constraints", ref: provisioner.go:169-185)."""
        pods = []
        for pod in batch:
            live = self.cluster.try_get_pod(pod.namespace, pod.name)
            if live is None or not live.is_provisionable():
                continue
            pods.append(pod)
        return pods

    def provision(self) -> ProvisionStats:
        # One trace id per provisioning batch: every span this pass records
        # — host stages, the sidecar RPC (ridden as gRPC metadata), the SPMD
        # broadcast leg — carries it, so a merged Chrome trace stitches the
        # whole batch across processes (docs/design/observability.md).
        with TRACER.trace(tracing.new_trace_id()):
            return self._provision()

    def _provision(self) -> ProvisionStats:
        stats = ProvisionStats()
        pods = self._live_batch(self._drain())
        if not pods:
            return stats

        daemons = [
            template
            for template in self.cluster.list_daemonset_templates()
            if self._daemon_schedules_here(template)
        ]
        with SCHEDULING_DURATION.measure(), TRACER.span(
            "provision.schedule", provisioner=self.provisioner.name, pods=len(pods)
        ):
            schedules = self.scheduler.solve(self.provisioner, pods)
        OBS.stamp_many(_batch_uids(schedules), "constraint-compiled")
        # Constrained schedules (relaxation ladder, topology spread, pod
        # (anti-)affinity) route through the compiler's [L, G, T] dispatch;
        # everything else stays on the plain solver boundary. All plain
        # schedules solve as ONE batch: device-backed solvers share a
        # single device->host round trip across them, and the sidecar's
        # streaming RPC does the same across the wire (the reference loops
        # Pack per schedule — provisioner.go:102-135). On the pipelined path
        # the batch additionally OVERLAPS with bind: schedule N's nodes
        # launch and bind while schedules N+1.. are still solving on the
        # device (solve_many_pipelined).
        plain = [s for s in schedules if not s.needs_compiler]
        constrained = [s for s in schedules if s.needs_compiler]
        problems = [self._encode_problem(schedule, daemons) for schedule in plain]
        for schedule, result in self._all_results(
            plain, problems, constrained, daemons
        ):
            if stats.launch_errors and not schedule.needs_compiler:
                # An earlier schedule's launch failed (e.g. ICE): its pools
                # are now in the unavailable-offerings blackout, but this
                # schedule was solved against the pre-failure batch snapshot.
                # Re-solve it against fresh instance types so the within-pass
                # capacity feedback of the sequential loop is preserved
                # (ref: aws/instancetypes.go:174-183 blackout semantics).
                # Constrained schedules skip the re-solve: their dispatch
                # already ran after every plain launch of the pass, and a
                # late ICE heals through the next sweep's fresh compile.
                fresh_types = self.cloud.get_instance_types(schedule.constraints)
                with SOLVE_DURATION.measure(), TRACER.span(
                    "provision.resolve", pods=len(schedule.pods)
                ):
                    result = self.solver.solve(
                        schedule.pods, fresh_types, schedule.constraints, daemons
                    )
            stats.unschedulable_pods += len(result.unschedulable)
            with BIND_DURATION.measure(), TRACER.span(
                "provision.bind", nodes=result.node_count
            ):
                self._launch(schedule.constraints, result, stats)
        if stats.launched_nodes:
            live = self.cluster.try_get_provisioner(self.provisioner.name)
            if live is not None:
                live.status.last_scale_time = self.cluster.clock.now()
                self.cluster.update_provisioner_status(live)
        return stats

    def _encode_problem(self, schedule, daemons):
        """One schedule as a solver problem. Fast path: when the incremental
        encoder's pending tensors cover exactly this schedule's pods, hand
        the solver the PRE-ENCODED (groups, fleet) pair — group_pods /
        build_fleet are skipped and the kernel consumes the device-resident
        arrays (Solver._encode_problems passes the pair through). Any
        mismatch (multi-schedule pass, mid-pass churn, torn state) falls
        back to the snapshot encode, which stays authoritative."""
        instance_types = self.cloud.get_instance_types(schedule.constraints)
        if self.cluster_state is not None:
            encoded = self.cluster_state.encode_schedule(
                schedule.pods, instance_types, schedule.constraints, daemons
            )
            if encoded is not None:
                return encoded
        return (schedule.pods, instance_types, schedule.constraints, daemons)

    @staticmethod
    def _problem_pods(problem) -> int:
        # A pre-encoded problem is a (PodGroups, InstanceFleet) pair.
        return problem[0].num_pods if len(problem) == 2 else len(problem[0])

    def _all_results(self, plain, problems, constrained, daemons):
        """(schedule, result) pairs for the whole pass: the plain batch via
        the pipelined solver boundary, then each constrained schedule via
        the compiler's [L, G, T] dispatch (constraints/solve) — one kernel
        call per schedule solving every relaxation level, replacing the
        legacy relax-retry loop AND the Topology.inject pre-pass."""
        yield from self._solve_results(plain, problems)
        if not constrained:
            return
        from karpenter_tpu_torch.constraints.solve import solve_constrained

        epoch = None
        if self.cluster_state is not None:
            try:
                # (epoch, generation): generation moves on every delta
                # flush, so the envelope cache invalidates on ordinary
                # pod/node churn, not just full re-uploads; None while
                # deltas are pending (compile reads the live store).
                # stamp_epoch folds in the market generation — a reprice
                # (live price drift past --reprice-threshold, ICE churn)
                # invalidates the compiled envelopes the same way cluster
                # churn does, so constrained solves never pack against a
                # stale price surface (docs/design/market.md).
                from karpenter_tpu_torch.market.pricebook import stamp_epoch

                epoch = stamp_epoch(self.cluster_state.compile_tag())
            except Exception:  # noqa: BLE001 — cache tag only, never fatal
                epoch = None
        for schedule in constrained:
            instance_types = self.cloud.get_instance_types(schedule.constraints)
            schedule_uids = [p.uid for p in schedule.pods]
            OBS.stamp_many(schedule_uids, "solve-dispatched")
            with SOLVE_DURATION.measure(), TRACER.span(
                "provision.solve.constrained",
                pods=len(schedule.pods),
                levels=schedule.ladder.num_levels if schedule.ladder else 1,
            ):
                result, decision = solve_constrained(
                    self.solver, schedule, instance_types, daemons,
                    cluster=self.cluster, epoch=epoch,
                )
            OBS.stamp_many(schedule_uids, "solve-fetched")
            RECORDER.record(
                "relaxation",
                provisioner=self.provisioner.name,
                pods=len(schedule.pods),
                level=max(decision.pod_levels.values(), default=0),
                description=decision.description,
                trace=TRACER.current_trace() or "",
            )
            if self.level_recorder is not None:
                for uid, level in decision.pod_levels.items():
                    self.level_recorder(uid, level, decision.description)
            yield schedule, result

    def _solve_results(self, schedules, problems):
        """Yield (schedule, result) pairs for the pass.

        Default: the double-buffered solve->bind pipeline — the solver
        dispatches every schedule's kernel (and queues its device->host
        copy) up front, then results stream back in order, so each
        schedule's bind/launch runs while the NEXT schedules are still
        solving. When any crash test is armed the pass drops to the serial
        solve-everything-then-bind flow: a mid-bind kill must leave the
        deterministic minimal surviving state, which the battletest matrix
        asserts, and interleaving binds with in-flight solves would leave
        whatever the pipeline happened to finish (same rule as the serial
        bind path in _register_and_bind)."""
        batch_uids = _batch_uids(schedules)
        if any_armed():
            OBS.stamp_many(batch_uids, "solve-dispatched")
            with SOLVE_DURATION.measure(), TRACER.span(
                "provision.solve",
                schedules=len(problems),
                pods=sum(self._problem_pods(p) for p in problems),
            ):
                results = self.solver.solve_many(problems)
            OBS.stamp_many(batch_uids, "solve-fetched")
            yield from zip(schedules, results)
            return
        # Encode + dispatch is measured as its own sample: for device
        # solvers this covers the spec->tensor encode and the async kernel
        # dispatches of the WHOLE batch (plus any host-gated schedules'
        # synchronous solves); per-schedule pulls below then record each
        # schedule's residual solve wait — time the solver still needed
        # AFTER the previous schedule's bind, i.e. the unoverlapped
        # remainder the pipeline leaves on the critical path. Host solvers
        # solve lazily per pull (base solve_encoded_pipelined), so their
        # solve time lands in the per-schedule samples.
        with SOLVE_DURATION.measure(), TRACER.span(
            "provision.solve.dispatch",
            schedules=len(problems),
            pods=sum(self._problem_pods(p) for p in problems),
        ):
            iterator = self.solver.solve_many_pipelined(problems)
        OBS.stamp_many(batch_uids, "solve-dispatched")
        for index, schedule in enumerate(schedules):
            with SOLVE_DURATION.measure(), TRACER.span(
                "provision.solve",
                schedules=len(problems),
                schedule=index,
                pods=len(schedule.pods),
            ):
                result = next(iterator)
            OBS.stamp_many([p.uid for p in schedule.pods], "solve-fetched")
            yield schedule, result

    def _daemon_schedules_here(self, template: PodSpec) -> bool:
        try:
            self.provisioner.spec.constraints.validate_pod(template)
            return True
        except Exception:
            return False

    @staticmethod
    def _launch_identity(
        provisioner_name: str, packing, lease_generation=None
    ) -> str:
        """Stable identity of one logical launch, derived from the batch
        CONTENT: (provisioner, node count, the sorted uids of every pod the
        packing serves, and WHAT is being bought — the instance-type options
        and any pinned pool rows). A controller that crashes after the fleet
        call and re-solves the same still-unbound pods reproduces the same
        packing and therefore the same identity — the cloud provider turns
        that into a deterministic idempotency token (EC2 ClientToken) and
        adopts the instances the first attempt bought instead of buying
        twice. Pods that DID get bound before the crash drop out of the
        re-batch, changing the identity, so partially-applied launches never
        alias fresh ones. Including the purchase content guards the other
        aliasing direction: a re-solve that picks DIFFERENT pools (blackout
        caches are empty after a restart, catalogs drift) mints a fresh
        token and buys fresh capacity rather than replaying a token against
        mismatched parameters (EC2 would reject the call with
        IdempotentParameterMismatch); the first attempt's orphan is the
        leaked-capacity GC's job.

        Each uid carries its reschedule epoch (bumped when the interruption
        drain displaces the pod back to pending): a replacement launch for
        displaced pods must NOT alias the purchase that backed their dying
        node — with a bare uid it would, and the provider's idempotent
        replay would adopt the reclaimed instance and rebind the pods onto
        the very node being drained.

        `lease_generation` (the write fence's leaseTransitions value, None
        when leader election is off) folds leadership into the token: a
        stale leader re-solving the same pods under its OLD generation can
        neither alias nor adopt the successor's purchase — its orphan is
        the leaked-capacity GC's job, like any other cross-identity
        orphan."""
        from karpenter_tpu_torch.controllers.cluster import reschedule_epoch

        pod_uids = sorted(
            f"{pod.uid or f'{pod.namespace}/{pod.name}'}@{reschedule_epoch(pod)}"
            for pod in packing.pods
        )
        type_names = sorted(t.name for t in packing.instance_type_options)
        pools = [
            f"{pool.instance_type.name}/{pool.zone}/{pool.priority}"
            for pool in (packing.pool_options or [])
        ]
        payload = "|".join(
            [provisioner_name, str(packing.node_quantity)]
            + pod_uids
            + ["types"]
            + type_names
            + ["pools"]
            + pools
            + (
                ["lease-gen", str(lease_generation)]
                if lease_generation is not None
                else []
            )
        )
        return hashlib.sha256(payload.encode()).hexdigest()[:32]

    def _launch(self, constraints, result: PackResult, stats: ProvisionStats):
        crashpoint("provision.before-launch")
        for packing in result.packings:
            # Re-GET the provisioner before every launch: abort if it was
            # deleted mid-pass, and enforce limits against fresh status
            # (ref: provisioner.go:187-195).
            live = self.cluster.try_get_provisioner(self.provisioner.name)
            if live is None or live.deletion_timestamp is not None:
                stats.unschedulable_pods += len(packing.pods)
                continue
            if live.spec.limits is not None:
                reason = live.spec.limits.exceeded_by(live.status.resources)
                if reason is not None:
                    stats.unschedulable_pods += len(packing.pods)
                    continue
            node_pods = iter(packing.pods_per_node)

            def bind_callback(
                node: NodeSpec, _pods_iter=node_pods, _packing=packing
            ):
                pods = next(_pods_iter, [])
                self._register_and_bind(
                    node, pods, extra_labels=_packing.node_labels
                )
                stats.launched_nodes += 1
                stats.scheduled_pods += len(pods)

            # Fence the purchase itself: the cloud provider is outside the
            # store, so the deposed-leader check runs here, at the caller —
            # and the launch identity carries the generation so even a check
            # that races the revocation can't alias the successor's token.
            self.cluster.fence.check("cloud.create")
            launch_id = self._launch_identity(
                self.provisioner.name, packing, self.cluster.fence.generation
            )
            # The flight-recorder's launch decision: WHAT is being bought
            # (first-choice type + price), for whom, under which idempotency
            # token — the record a breach/crash dump correlates against.
            # market_generation names the price state the purchase was made
            # under: a breach dump's launches line up against its reprice
            # events by generation (None = no live market attached).
            from karpenter_tpu_torch.market.pricebook import active_generation

            first_pool = (packing.pool_options or [None])[0]
            RECORDER.record(
                "launch",
                provisioner=self.provisioner.name,
                nodes=packing.node_quantity,
                pods=len(packing.pods),
                instance_type=(
                    packing.instance_type_options[0].name
                    if packing.instance_type_options
                    else ""
                ),
                price=getattr(first_pool, "price", None),
                zone=getattr(first_pool, "zone", None),
                launch_id=launch_id,
                market_generation=active_generation(),
                trace=TRACER.current_trace() or "",
            )
            errors = self.cloud.create(
                constraints,
                packing.instance_type_options,
                packing.node_quantity,
                bind_callback,
                pool_options=packing.pool_options,
                launch_id=launch_id,
            )
            for error in errors:
                RECORDER.record(
                    "launch-error",
                    provisioner=self.provisioner.name,
                    launch_id=launch_id,
                    error=repr(error),
                )
            stats.launch_errors.extend(errors)

    @staticmethod
    def _pod_vanished(error: BaseException) -> bool:
        """Both backends' is-not-found: the in-memory store raises
        NotFoundError; the apiserver write-through raises ApiError 404."""
        if isinstance(error, NotFoundError):
            return True
        return getattr(error, "status", None) == 404

    def _drift_hash(self) -> str:
        """Drift identity for freshly-registered nodes: hash the STORED spec,
        never this worker's fleet-merged EFFECTIVE copy — effective
        requirements shift with the live catalog (ICE blackouts, new zones),
        and stamping them would make every market wobble look like
        provisioner drift."""
        stored = self.cluster.try_get_provisioner(self.provisioner.name)
        return driftlib.spec_hash(stored if stored is not None else self.provisioner)

    def _register_and_bind(
        self, node: NodeSpec, pods: Sequence[PodSpec], extra_labels=None
    ):
        """Create the node object (not-ready taint + termination finalizer +
        constraint labels) then bind its pods (ref: provisioner.go:209-250).
        `extra_labels` carries the packing's topology-domain labels: a
        custom-key spread domain is stamped at registration, so fresh nodes
        are born into the domain the constrained solve assigned them."""
        node.labels.setdefault(wellknown.PROVISIONER_NAME_LABEL, self.provisioner.name)
        for key, value in (extra_labels or {}).items():
            node.labels.setdefault(key, value)
        for key, value in self.provisioner.spec.constraints.labels.items():
            node.labels.setdefault(key, value)
        node.annotations.setdefault(
            wellknown.PROVISIONER_HASH_ANNOTATION, self._drift_hash()
        )
        node.taints = list(self.provisioner.spec.constraints.taints) + [
            Taint(key=wellknown.NOT_READY_TAINT_KEY, effect="NoSchedule")
        ]
        if wellknown.TERMINATION_FINALIZER not in node.finalizers:
            node.finalizers.append(wellknown.TERMINATION_FINALIZER)
        OBS.stamp_many([p.uid for p in pods], "launched")
        crashpoint("provision.before-register")
        try:
            self.cluster.create_node(node)
        except Exception as error:  # noqa: BLE001 — coded errors only
            if getattr(error, "status", None) != 409:
                raise
            # AlreadyExists: a restarted controller re-registering a node a
            # pre-crash pass already created (the cloud provider adopted the
            # instance and replayed the same NodeSpec). The object is the
            # durable record — proceed to bind against it.
            klog.named("provisioning").info(
                "node %s already registered; adopting", node.name
            )
        # Bind every pod concurrently; a failed bind is logged, not fatal
        # (ref: provisioner.go:239-247 counts successes and moves on — the
        # unbound pod stays unschedulable and retries through selection).
        def bind(pod: PodSpec) -> None:
            crashpoint("provision.mid-bind")
            try:
                self.cluster.bind_pod(pod, node)
            except Exception as error:  # noqa: BLE001
                if self._pod_vanished(error):
                    # The pod was deleted between batch collection and this
                    # bind RPC — expected under churn, nothing to retry
                    # (controller-runtime's IgnoreNotFound contract).
                    klog.named("provisioning").debug(
                        "pod %s/%s vanished before bind to %s",
                        pod.namespace, pod.name, node.name,
                    )
                    return
                klog.named("provisioning").exception(
                    "failed to bind %s/%s to %s", pod.namespace, pod.name, node.name
                )

        # Serial path for singleton binds AND whenever a crash test is armed:
        # a mid-bind kill must leave the deterministic minimal surviving
        # state (pods before the crash index bound, none after), not
        # whatever sibling binds the executor happened to finish first.
        if len(pods) <= 1 or any_armed():
            for pod in pods:
                bind(pod)
            crashpoint("provision.after-bind")
            return
        futures = []
        for index, pod in enumerate(pods):
            try:
                futures.append(_bind_executor().submit(bind, pod))
            except RuntimeError:
                # Interpreter teardown: atexit shut the shared pool down
                # while a daemon batch thread was mid-provision. Only the
                # NOT-YET-SUBMITTED pods need the inline fallback — the
                # already-submitted ones ran (or will run) on the pool, and
                # re-binding them would double-bind.
                for late in pods[index:]:
                    bind(late)
                break
        for future in futures:
            future.result()
        crashpoint("provision.after-bind")


class ProvisioningController:
    """Reconciles Provisioner objects and manages workers
    (ref: provisioning/controller.go:64-125). Requeues every 5 minutes in the
    runtime to pick up instance-type drift."""

    REQUEUE_SECONDS = 300.0

    def __init__(
        self,
        cluster: Cluster,
        cloud: CloudProvider,
        solver: Optional[Solver] = None,
        cluster_state=None,
        queue_max_pods: Optional[int] = None,
    ):
        self.cluster = cluster
        self.cloud = cloud
        self.solver = solver
        self.cluster_state = cluster_state
        self.queue_max_pods = queue_max_pods
        self.workers: Dict[str, ProvisionerWorker] = {}
        self._hashes: Dict[str, int] = {}
        # Runtime wiring (runtime.Manager): propagated to every worker so a
        # filling batch window wakes the batch loop immediately.
        self.batch_full: Optional[threading.Event] = None
        # Set by SelectionController: receives (uid, level, description) for
        # every constrained solve. Late-bound — workers route through
        # _record_level so construction order doesn't matter.
        self.level_recorder = None

    def _record_level(self, uid: str, level: int, description: str = "") -> None:
        if self.level_recorder is not None:
            self.level_recorder(uid, level, description)

    def reconcile(self, name: str) -> None:
        provisioner = self.cluster.try_get_provisioner(name)
        if provisioner is None or provisioner.deletion_timestamp is not None:
            if self.workers.pop(name, None) is not None:
                # The worker's depth series would otherwise freeze at its
                # last value forever on the deleted provisioner's label.
                PROVISION_QUEUE_DEPTH.set(0.0, name)
            self._hashes.pop(name, None)
            return
        self.apply(provisioner)

    def apply(self, provisioner: Provisioner) -> None:
        default_provisioner(provisioner)
        validate_provisioner(provisioner)
        # Constrain a WORKING COPY to what the fleet offers
        # (ref: controller.go:91-108). The stored spec stays pristine: each
        # reconcile re-derives the intersection from it, so offerings that
        # come back after an ICE blackout (or newly added types/zones) widen
        # the envelope again instead of being ratcheted away.
        instance_types = self.cloud.get_instance_types()
        requirements = (
            provisioner.spec.constraints.requirements.merge(
                global_requirements(instance_types)
            )
            .merge(Requirements.from_labels(provisioner.spec.constraints.labels))
            .consolidate()
        )
        effective = copy.deepcopy(provisioner)
        effective.spec.constraints.requirements = requirements
        new_hash = spec_hash(effective)
        if self._hashes.get(provisioner.name) != new_hash:
            self._hashes[provisioner.name] = new_hash
            replacement = ProvisionerWorker(
                effective, self.cluster, self.cloud, self.solver,
                cluster_state=self.cluster_state,
                level_recorder=self._record_level,
                queue_max_pods=self.queue_max_pods,
            )
            replacement.batch_full = self.batch_full
            # Hand the old worker's accepted backlog (batch + overflow) to
            # the replacement: mid-storm spec-hash flips (ICE blackouts
            # changing effective offerings) must not dump tens of thousands
            # of parked pods back onto the slow selection re-verify path.
            # Re-validate against the CHANGED constraints at hand-off — the
            # hash flipped precisely because they changed; pods now
            # incompatible stay out and heal through the selection
            # re-verify, which relaxes and can re-route them.
            old = self.workers.get(provisioner.name)
            if old is not None:
                for pod in old.take_backlog():
                    try:
                        effective.spec.constraints.validate_pod(pod)
                    except PodIncompatibleError:
                        continue
                    replacement.add(pod)
            self.workers[provisioner.name] = replacement
        else:
            self.workers[provisioner.name].provisioner = effective
        # A provisioner with a running worker is ready to scale — the Active
        # status condition (ref: provisioner_status.go:40-50 knative
        # conditions; the v0.5.x reference defines but barely drives it).
        if provisioner.status.conditions.get("Active") is not True:
            provisioner.status.conditions["Active"] = True
            self.cluster.update_provisioner_status(provisioner)

    def worker(self, name: str) -> Optional[ProvisionerWorker]:
        return self.workers.get(name)
