"""Termination: finalizer-driven graceful node deletion.

Ref: pkg/controllers/termination/{controller,terminate,eviction}.go — a node
with a deletionTimestamp and the karpenter termination finalizer is cordoned,
drained (respecting do-not-evict, PDBs, and critical-pod ordering), then
deleted at the cloud provider before the finalizer is removed.
"""

from __future__ import annotations

import threading
from typing import Dict, FrozenSet, List, Optional, Tuple

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.pods import PodSpec
from karpenter_tpu_torch.cloudprovider import CloudProvider, NodeSpec
from karpenter_tpu_torch.controllers.cluster import Cluster
from karpenter_tpu_torch.controllers.errors import PDBViolationError
from karpenter_tpu_torch.utils import logging as klog
from karpenter_tpu_torch.utils.fence import bind_thread
from karpenter_tpu_torch.utils.metrics import REGISTRY
from karpenter_tpu_torch.utils.workqueue import BackoffQueue

CRITICAL_PRIORITY_CLASSES = ("system-cluster-critical", "system-node-critical")

# Eviction outcomes by result: "evicted" is progress, "pdb-blocked" retries
# with backoff, "gone" means the pod vanished before the queue reached it.
EVICTIONS_TOTAL = REGISTRY.counter(
    "evictions_total", "Evictions processed by the eviction queue", ["result"]
)
# Cordon-to-cloud-delete wall time per drained node. Buckets stretch past the
# reconcile-duration ramp: a drain legitimately lasts minutes when PDBs
# meter it.
NODE_DRAIN_DURATION = REGISTRY.histogram(
    "node_drain_duration_seconds",
    "Node drain duration (first drain attempt to cloud delete)",
    buckets=(1.0, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0, 600.0, 1800.0, 3600.0),
)
# A drain that spins without progress was previously invisible (the
# reconcile requeued forever in silence); this fires once per stall episode.
DRAIN_STALLED_TOTAL = REGISTRY.counter(
    "drain_stalled_total",
    "Drains that made no progress for STALL_RECONCILES consecutive "
    "reconciles, by blocking reason",
    ["reason"],
)


class EvictionQueue:
    """Async rate-limited eviction worker (ref: termination/eviction.go:45-109):
    set-deduped, exponential backoff 100ms -> 10s, PDB violations retry.

    The queue drains from its OWN pump thread (start()/stop()), independent of
    any termination reconcile — the reference runs a standalone worker
    goroutine (eviction.go:45-57), so queued evictions survive a node whose
    reconcile stops requeueing. Tests without a runtime call drain_once()."""

    PUMP_INTERVAL_SECONDS = 0.1

    def __init__(self, cluster: Cluster):
        self.cluster = cluster
        self.queue = BackoffQueue(base_delay=0.1, max_delay=10.0, clock=cluster.clock)
        self.log = klog.named("eviction")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def add(self, pods: List[PodSpec]) -> None:
        for pod in pods:
            self.queue.add((pod.namespace, pod.name))

    def drain_once(self) -> int:
        """Pump the queue once (the pump thread loops this; tests call it
        directly)."""

        def evict(key) -> bool:
            namespace, name = key
            pod = self.cluster.try_get_pod(namespace, name)
            if pod is None:
                EVICTIONS_TOTAL.inc("gone")
                return True
            try:
                self.cluster.evict_pod(namespace, name)
                EVICTIONS_TOTAL.inc("evicted")
                return True
            except PDBViolationError:
                EVICTIONS_TOTAL.inc("pdb-blocked")
                return False  # 429-equivalent: retry with backoff

        return self.queue.process(evict)

    def start(self) -> None:
        """Start the standalone pump thread (idempotent). Each pump owns its
        stop Event: a pump that outlived its stop()'s join timeout keeps its
        already-set Event and still exits, instead of being revived by the
        next start()."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._pump, args=(self._stop,), name="eviction-queue", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def _pump(self, stop: threading.Event) -> None:
        # The pump evicts through the store's fenced verbs: bind the fence
        # so a deposed leader's pump aborts at the crashpoint gate between
        # drains, not only at the next evict_pod's fence check.
        bind_thread(self.cluster.fence)
        while not stop.wait(timeout=self.PUMP_INTERVAL_SECONDS):
            try:
                self.drain_once()
            except Exception:  # noqa: BLE001 — the pump must survive store errors
                self.log.exception("eviction drain failed")


class Terminator:
    """Ref: termination/terminate.go."""

    def __init__(self, cluster: Cluster, cloud: CloudProvider, evictions: EvictionQueue):
        self.cluster = cluster
        self.cloud = cloud
        self.evictions = evictions
        # node name -> clock time of the FIRST drain attempt; closed (and
        # observed into NODE_DRAIN_DURATION) at terminate.
        self._drain_started: Dict[str, float] = {}

    def cordon(self, node: NodeSpec) -> None:
        """ref: terminate.go:42-55."""
        if not node.unschedulable:
            node.unschedulable = True
            self.cluster.update_node(node)

    def drain(self, node: NodeSpec) -> bool:
        """Returns True when fully drained (ref: terminate.go:58-82)."""
        first_attempt = node.name not in self._drain_started
        self._drain_started.setdefault(node.name, self.cluster.clock.now())
        pods = self.cluster.list_pods(node_name=node.name)
        if first_attempt:
            # Flight-record the drain DECISION once, at first attempt — the
            # black box names which node started displacing pods and when.
            from karpenter_tpu_torch.utils.obs import RECORDER

            RECORDER.record("drain", node=node.name, pods=len(pods))
        # Refuse to drain while any pod carries do-not-evict
        # (ref: terminate.go:67-72).
        for pod in pods:
            if wellknown.DO_NOT_EVICT_ANNOTATION in pod.annotations:
                return False
        evictable = self._evictable(pods)
        if not evictable:
            return True
        # Evict non-critical pods before critical ones
        # (ref: terminate.go:127-147).
        non_critical = [
            p for p in evictable
            if p.priority_class_name not in CRITICAL_PRIORITY_CLASSES
        ]
        self.evictions.add(non_critical if non_critical else evictable)
        return False

    def _evictable(self, pods: List[PodSpec]) -> List[PodSpec]:
        """Skip terminating ("stuck") and node-owned/daemon pods that tolerate
        the unschedulable state (ref: terminate.go:111-125)."""
        return [pod for pod in pods if pod.survives_node_drain()]

    def terminate(self, node: NodeSpec) -> None:
        """Cloud delete then strip the finalizer (ref: terminate.go:84-100)."""
        # The provider call is outside the store, so the deposed-leader
        # fence check runs here at the caller (utils/fence.py).
        self.cluster.fence.check("cloud.delete")
        self.cloud.delete(node)
        self.cluster.remove_finalizer(node, wellknown.TERMINATION_FINALIZER)
        started = self._drain_started.pop(node.name, None)
        if started is not None:
            NODE_DRAIN_DURATION.observe(self.cluster.clock.now() - started)

    def forget(self, name: str) -> None:
        """Drop drain bookkeeping for a node that vanished without passing
        through terminate (external delete raced us)."""
        self._drain_started.pop(name, None)


class TerminationController:
    """Ref: termination/controller.go:60-97. Requeues (returning a delay)
    while draining."""

    REQUEUE_SECONDS = 1.0
    # Reconciles without drain progress before the stall is surfaced (at the
    # 1s requeue that is ~30s of a node visibly going nowhere).
    STALL_RECONCILES = 30

    def __init__(self, cluster: Cluster, cloud: CloudProvider):
        self.cluster = cluster
        self.evictions = EvictionQueue(cluster)
        self.terminator = Terminator(cluster, cloud, self.evictions)
        self.log = klog.named("termination")
        # node name -> (pod-state snapshot, consecutive no-change count).
        # Progress = the snapshot changes (a pod vanished or started
        # terminating); a long-flat snapshot is a stalled drain.
        self._stalls: Dict[str, Tuple[FrozenSet, int]] = {}

    def reconcile(self, name: str) -> Optional[float]:
        node = self.cluster.try_get_node(name)
        if node is None:
            self._stalls.pop(name, None)
            self.terminator.forget(name)
            return None
        if node.deletion_timestamp is None:
            return None
        if wellknown.TERMINATION_FINALIZER not in node.finalizers:
            return None
        self.terminator.cordon(node)
        if not self.terminator.drain(node):
            # Evictions drain from the EvictionQueue's own pump thread
            # (ref: eviction.go:45-57) — the reconcile only requeues to
            # observe progress.
            self._observe_stall(node)
            return self.REQUEUE_SECONDS
        self.terminator.terminate(node)
        self._stalls.pop(name, None)
        return None

    def _observe_stall(self, node: NodeSpec) -> None:
        """Count consecutive no-progress reconciles; at STALL_RECONCILES,
        increment drain_stalled_total{reason} and log the blocking pods ONCE
        per stall episode (progress resets the episode)."""
        pods = self.cluster.list_pods(node_name=node.name)
        snapshot = frozenset(
            (p.namespace, p.name, p.is_terminating()) for p in pods
        )
        previous, count = self._stalls.get(node.name, (None, 0))
        if snapshot != previous:
            self._stalls[node.name] = (snapshot, 0)
            return
        count += 1
        self._stalls[node.name] = (snapshot, count)
        if count != self.STALL_RECONCILES:
            return
        blockers = [
            p for p in pods if wellknown.DO_NOT_EVICT_ANNOTATION in p.annotations
        ]
        reason = "do-not-evict" if blockers else "pdb"
        DRAIN_STALLED_TOTAL.inc(reason)
        stuck = blockers or [p for p in pods if not p.is_terminating()]
        self.log.warning(
            "drain of %s stalled for %d reconciles (%s); blocking pods: %s",
            node.name,
            count,
            reason,
            ", ".join(sorted(f"{p.namespace}/{p.name}" for p in stuck)) or "none",
        )
