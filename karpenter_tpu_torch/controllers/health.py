"""Unhealthy-node detection and the escalation ladder.

The Liveness guard (controllers/node.py) only covers nodes that NEVER
joined — a kubelet that reported once and then went dark left an immortal
NotReady node that kept receiving pods. This controller closes that gap:

1. **Detection with hysteresis.** A managed, joined node is unhealthy when
   its heartbeat is stale (``status_reported_at`` older than
   ``--node-unreachable-timeout``) or its kubelet reports NotReady. One bad
   observation proves nothing — watch delivery jitters and kubelets flap —
   so escalation waits for ``STALE_OBSERVATIONS`` consecutive unhealthy
   sweeps. A single fresh heartbeat resets the counter.

2. **The escalation ladder** (the same drain machinery interruption and
   consolidation already ride): re-taint ``karpenter.sh/not-ready`` →
   cordon → PDB-gated displacement via ``reschedule_pod`` (the
   reschedule-epoch bump makes every replacement a DIFFERENT logical launch,
   so a restart-idempotent provider can never adopt the dying node's
   purchase) → displaced pods fed straight to ``ProvisionerWorker.add`` so
   replacement capacity launches while the drain runs → finalizer-path
   delete (termination drains the daemon tail and calls the cloud delete).

3. **Stuck-drain breaker.** A polite drain blocked past
   ``--drain-stuck-timeout`` (do-not-evict pods, PDB refusals, an eviction
   black-hole) escalates loudly — overrides are taken and counted on
   ``drain_stalled_total{reason="unreachable"}`` — because leaving pods on
   an unreachable node is strictly worse than any budget.

4. **Zombie defense.** A deleted node's kubelet re-registering under the
   same name must not be adopted: a re-registration carrying the DEAD
   incarnation's provider id is rejected (the launch-identity analogue — a
   legitimate replacement always rides a fresh launch, hence a fresh
   provider id), and a node whose instance no provider listing accounts for
   (two consecutive sightings, the instancegc pattern) is reaped the same
   way. Both count ``node_zombie_rejections_total``.

Crash consistency: ``health.after-cordon`` / ``health.mid-displace`` are
named crashpoints; the battletest (tests/test_health.py, `make
lifecycle-smoke`) kills the controller at each and asserts a restart
converges with every pod rebound exactly once.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.pods import PodSpec
from karpenter_tpu_torch.api.taints import Taint
from karpenter_tpu_torch.cloudprovider import CloudProvider, NodeSpec
from karpenter_tpu_torch.controllers.cluster import Cluster
from karpenter_tpu_torch.controllers.errors import PDBViolationError
from karpenter_tpu_torch.controllers.provisioning import ProvisioningController
from karpenter_tpu_torch.controllers.termination import (
    DRAIN_STALLED_TOTAL,
    TerminationController,
)
from karpenter_tpu_torch.utils import logging as klog
from karpenter_tpu_torch.utils.crashpoints import crashpoint
from karpenter_tpu_torch.utils.metrics import REGISTRY

SWEEP_SECONDS = 2.0
# Heartbeat age past which a joined node counts as unreachable
# (--node-unreachable-timeout; kube's node-monitor-grace-period analogue).
DEFAULT_UNREACHABLE_TIMEOUT = 60.0
# Polite-drain budget once a node is confirmed unhealthy; past it the drain
# overrides do-not-evict and PDBs rather than leaving pods on a dead node
# (--drain-stuck-timeout).
DEFAULT_DRAIN_STUCK_TIMEOUT = 120.0
# Consecutive unhealthy sweeps before the ladder engages — the flap
# hysteresis. One fresh heartbeat resets the count.
STALE_OBSERVATIONS = 3

NODE_UNHEALTHY_TOTAL = REGISTRY.counter(
    "node_unhealthy_total",
    "Nodes confirmed unhealthy (hysteresis passed) and escalated, by reason",
    ["reason"],
)
NODE_HEARTBEAT_STALE_SECONDS = REGISTRY.gauge(
    "node_heartbeat_stale_seconds",
    "Worst heartbeat staleness across joined, managed, live nodes",
)
NODE_ZOMBIE_REJECTIONS_TOTAL = REGISTRY.counter(
    "node_zombie_rejections_total",
    "Re-registrations of deleted nodes (or instance-less ghosts) rejected",
)


class HealthController:
    """Periodic sweep (Manager drives it like interruption): detect stale or
    NotReady nodes, escalate through cordon→displace→replace→delete."""

    def __init__(
        self,
        cluster: Cluster,
        cloud: CloudProvider,
        provisioning: ProvisioningController,
        termination: TerminationController,
        unreachable_timeout: float = DEFAULT_UNREACHABLE_TIMEOUT,
        drain_stuck_timeout: float = DEFAULT_DRAIN_STUCK_TIMEOUT,
        stale_observations: int = STALE_OBSERVATIONS,
        cluster_state=None,
    ):
        self.cluster = cluster
        self.cloud = cloud
        self.provisioning = provisioning
        self.termination = termination
        self.unreachable_timeout = unreachable_timeout
        self.drain_stuck_timeout = drain_stuck_timeout
        self.stale_observations = stale_observations
        # Incremental encoder (optional): per-node pod listing without an
        # O(pods) filter per node per sweep, same as interruption.
        self.cluster_state = cluster_state
        self.log = klog.named("health")
        # node name -> consecutive unhealthy sweeps. In-memory: a restart
        # re-counts from zero, which only DELAYS escalation by K sweeps —
        # never acts on less evidence than the configured hysteresis.
        self._strikes: Dict[str, int] = {}
        # node name -> clock time escalation engaged (hysteresis passed);
        # the drain-stuck anchor. Doubles as the "already counted" marker
        # so node_unhealthy_total counts episodes, not sweeps.
        self._unhealthy_since: Dict[str, float] = {}
        # Nodes whose stall already fired drain_stalled_total this episode.
        self._stalled: set = set()
        # name -> provider_id of nodes THIS controller deleted: the zombie
        # check's fast path. In-memory and bounded; the instance-less ghost
        # sweep below is the restart-durable layer.
        self._buried: Dict[str, str] = {}
        # provider_id -> first sighting for the instance-less ghost check
        # (two consecutive sightings, the instancegc pattern).
        self._ghost_suspects: Dict[str, float] = {}

    # --- sweep --------------------------------------------------------------

    def reconcile(self, _key=None) -> float:
        now = self.cluster.clock.now()
        managed = [
            node
            for node in self.cluster.list_nodes()
            if wellknown.PROVISIONER_NAME_LABEL in node.labels
            and node.deletion_timestamp is None
        ]
        self._reject_zombies(managed, now)
        unhealthy = self._classify(managed, now)
        # Prune bookkeeping for nodes that left the unhealthy set entirely —
        # including ones deleted between sweeps, which the loop never visits.
        names = {node.name for node, _ in unhealthy}
        for name in list(self._strikes):
            if name not in names:
                self._forget(name)
        for node, reason in unhealthy:
            strikes = self._strikes.get(node.name, 0) + 1
            self._strikes[node.name] = strikes
            if strikes < self.stale_observations:
                continue  # hysteresis: flaps don't reach the ladder
            if node.name not in self._unhealthy_since:
                self._unhealthy_since[node.name] = now
                NODE_UNHEALTHY_TOTAL.inc(reason)
                self.log.warning(
                    "node %s unhealthy (%s) after %d consecutive "
                    "observations; escalating",
                    node.name, reason, strikes,
                )
            self._escalate(node, now)
        return SWEEP_SECONDS

    def _classify(self, managed: List[NodeSpec], now: float) -> List[tuple]:
        """Split the managed fleet into healthy (strikes forgotten) and
        (node, reason) suspects, publishing the worst-staleness gauge."""
        unhealthy: List[tuple] = []
        worst_staleness = 0.0
        for node in managed:
            if node.status_reported_at is None:
                continue  # never joined: the Liveness guard's case
            if wellknown.INTERRUPTION_KIND_ANNOTATION in node.annotations:
                continue  # the interruption drain already owns this node
            staleness = now - node.status_reported_at
            worst_staleness = max(worst_staleness, staleness)
            stale = staleness >= self.unreachable_timeout
            if not stale and node.ready:
                self._forget(node.name)
                continue
            reason = "stale-heartbeat" if stale else "not-ready"
            unhealthy.append((node, reason))
        NODE_HEARTBEAT_STALE_SECONDS.set(worst_staleness)
        return unhealthy

    def _forget(self, name: str) -> None:
        self._strikes.pop(name, None)
        self._unhealthy_since.pop(name, None)
        self._stalled.discard(name)

    # --- zombie defense -----------------------------------------------------

    def _reject_zombies(self, managed: List[NodeSpec], now: float) -> None:
        """Reject re-registrations of dead nodes. Fast path: a node carrying
        a provider id this controller already buried is its old kubelet
        phoning home, not a replacement (replacements ride fresh launches =
        fresh provider ids). Durable path: a node whose instance the
        provider listing cannot account for on two consecutive sightings is
        a ghost — survives controller restarts because it reads only
        cloud + store state. Skipped when the provider enumerates nothing
        at all (a backend without list_instances must not nuke the fleet)."""
        instances = {
            instance.provider_id for instance in self.cloud.list_instances()
        }
        suspects: Dict[str, float] = {}
        for node in managed:
            if not node.provider_id:
                continue  # manually-registered test nodes: not ours to judge
            buried = self._buried.get(node.name)
            if buried is not None and node.provider_id == buried:
                self._reject(node, "re-registration of deleted node")
                continue
            if not instances or node.provider_id in instances:
                continue
            first_seen = self._ghost_suspects.get(node.provider_id)
            if first_seen is None:
                suspects[node.provider_id] = now  # wait one sweep
                continue
            suspects[node.provider_id] = first_seen
            self._reject(node, "no backing instance")
        self._ghost_suspects = suspects

    def _reject(self, node: NodeSpec, why: str) -> None:
        NODE_ZOMBIE_REJECTIONS_TOTAL.inc()
        self.log.warning(
            "rejecting zombie node %s (%s): %s",
            node.name, node.provider_id, why,
        )
        self.termination.terminator.cordon(node)
        self.cluster.delete_node(node.name)

    # --- escalation ladder ----------------------------------------------------

    def _escalate(self, node: NodeSpec, now: float) -> None:
        # Re-taint first: the solver must stop packing onto the sick node
        # even while the (possibly slow) drain runs. Idempotent — Readiness
        # re-adds it too once node.ready goes false, but a gone-dark kubelet
        # never flips the flag itself.
        if not any(t.key == wellknown.NOT_READY_TAINT_KEY for t in node.taints):
            node.taints.append(
                Taint(key=wellknown.NOT_READY_TAINT_KEY, effect="NoSchedule")
            )
            self.cluster.update_node(node)
        self.termination.terminator.cordon(node)
        crashpoint("health.after-cordon")
        anchor = self._unhealthy_since.get(node.name, now)
        escalated = now - anchor >= self.drain_stuck_timeout
        if escalated and node.name not in self._stalled:
            # The stuck-drain breaker: same loud shape as interruption's
            # deadline override, counted on the shared drain-stall counter.
            self._stalled.add(node.name)
            DRAIN_STALLED_TOTAL.inc("unreachable")
            self.log.warning(
                "drain of unhealthy node %s stuck for %.0fs; escalating "
                "over PDBs and do-not-evict",
                node.name, now - anchor,
            )
        displaced = [
            self._displace(node, pod, escalated)
            for pod in self._replaceable(node)
        ]
        if not all(displaced):
            return  # protected/PDB-blocked pods wait for the next sweep
        # Drained of everything replaceable: the finalizer path takes over
        # (termination drains the daemon tail, deletes at the cloud, strips
        # the finalizer) — instancegc invariants hold unchanged. Bury the
        # provider id so the dead kubelet re-registering is rejected.
        if node.provider_id:
            if len(self._buried) >= 4096:
                self._buried.clear()  # bounded; the ghost sweep still covers
            self._buried[node.name] = node.provider_id
        self._forget(node.name)
        self.cluster.delete_node(node.name)
        self.log.info("unhealthy node %s drained; deleting", node.name)

    def _replaceable(self, node: NodeSpec) -> List[PodSpec]:
        """Pods worth replacement capacity — the same drain-eligibility
        predicate the terminator uses, so the handoff can't disagree."""
        if self.cluster_state is not None:
            pods = self.cluster_state.pods_on_node(node.name)
        else:
            pods = self.cluster.list_pods(node_name=node.name)
        return [pod for pod in pods if pod.survives_node_drain()]

    def _displace(self, node: NodeSpec, pod: PodSpec, escalated: bool) -> bool:
        """Unbind one pod back to pending and feed it to the provisioner.
        Polite before the stuck-drain deadline; past it, overrides are taken
        (and counted) rather than leaving the pod on an unreachable node."""
        protected = wellknown.DO_NOT_EVICT_ANNOTATION in pod.annotations
        if protected and not escalated:
            return False
        try:
            live = self.cluster.reschedule_pod(pod.namespace, pod.name)
        except PDBViolationError:
            if not escalated:
                return False
            live = self.cluster.reschedule_pod(
                pod.namespace, pod.name, override_pdb=True
            )
            self.log.warning(
                "stuck-drain escalation: displacing %s/%s from %s OVER its PDB",
                pod.namespace, pod.name, node.name,
            )
        if live is None:
            return True  # vanished under us: nothing left to replace
        if protected:
            self.log.warning(
                "stuck-drain escalation: displacing %s/%s from %s despite "
                "do-not-evict", pod.namespace, pod.name, node.name,
            )
        crashpoint("health.mid-displace")
        self._feed(node, live)
        return True

    def _feed(self, node: NodeSpec, pod: PodSpec) -> None:
        """Proactive replacement: hand the displaced pod straight to the
        owning provisioner's batch window so replacement capacity launches
        while the rest of the drain runs. Without a worker the reschedule's
        watch event still routes the pod through selection."""
        name = node.labels.get(wellknown.PROVISIONER_NAME_LABEL, "")
        worker = self.provisioning.worker(name)
        if worker is not None:
            worker.add(pod)
