"""Interruption-aware capacity reclamation.

The provider buys spot deliberately (cloudprovider/market.py prices the
discount) but a reclaim notice used to go unanswered: the node died under its
pods, selection re-discovered them as unschedulable, and users ate the full
re-provision latency. The reference grew an interruption controller consuming
the EC2 spot-interruption-warning / rebalance-recommendation /
instance-state-change streams precisely because reacting inside the 2-minute
window is the difference between "uses spot" and "survives spot". This is
that subsystem:

1. **Ingest (record-then-ack).** `CloudProvider.poll_interruptions()` is
   at-least-once: each event is stamped onto the victim Node as annotations
   (`karpenter.sh/interruption-{kind,deadline}`) — the durable intent a
   restarted controller resumes from — and only then acked. The interrupted
   (type, zone, capacity-type) pool is fed to the provider's offering
   blackout so replacement capacity re-solves AWAY from the pool being
   reclaimed.

2. **Deadline-driven drain.** The node is cordoned immediately. Replaceable
   pods are *displaced* — unbound back to pending and fed straight to the
   owning provisioner worker (`ProvisionerWorker.add`), so replacement
   capacity is launching while the drain runs and each pod rebinds exactly
   once. This store has no workload controller to re-create an evicted pod,
   so displacement plays the evict→recreate→reschedule round trip in one
   step; the disruption is PDB-gated like an eviction. Until the escalation
   point the drain is polite: `do-not-evict` pods wait, PDB refusals retry.
   Past `escalate_fraction` of the reclaim window, losing the pod uncleanly
   is strictly worse than any budget, so the drain overrides both — loudly
   (`interruption_drain_override_total{reason}` + warning logs).

3. **Finalizer-path deletion.** Once no replaceable pods remain, the node is
   deleted through the normal finalizer path (termination controller drains
   the daemon-pod tail and calls the cloud delete), so instancegc /
   crash-consistency invariants hold unchanged.

Crash consistency: `interruption.after-annotate` / `interruption.mid-drain`
/ `interruption.before-delete` are named crashpoints; the battletest
(tests/test_interruption.py, `make interruption-smoke`) kills the controller
at each and asserts a restart converges with every pod bound exactly once.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.pods import PodSpec
from karpenter_tpu_torch.cloudprovider import (
    HARD_INTERRUPTION_KINDS,
    CloudProvider,
    InterruptionEvent,
    NodeSpec,
)
from karpenter_tpu_torch.controllers.cluster import Cluster
from karpenter_tpu_torch.controllers.errors import PDBViolationError
from karpenter_tpu_torch.controllers.provisioning import ProvisioningController
from karpenter_tpu_torch.controllers.termination import TerminationController
from karpenter_tpu_torch.utils import logging as klog
from karpenter_tpu_torch.utils.crashpoints import crashpoint
from karpenter_tpu_torch.utils.metrics import REGISTRY

SWEEP_SECONDS = 2.0
# Fraction of the reclaim window spent draining politely before the drain
# overrides do-not-evict and PDB budgets rather than losing pods uncleanly.
DEFAULT_ESCALATE_FRACTION = 0.5

INTERRUPTION_EVENTS_TOTAL = REGISTRY.counter(
    "interruption_events_total",
    "Provider interruption notices received, by kind",
    ["kind"],
)
INTERRUPTION_UNMATCHED_TOTAL = REGISTRY.counter(
    "interruption_events_unmatched_total",
    "Interruption notices that matched no cluster Node (already gone)",
)
INTERRUPTION_OVERRIDE_TOTAL = REGISTRY.counter(
    "interruption_drain_override_total",
    "Deadline-escalated displacements that overrode a protection",
    ["reason"],
)
INTERRUPTION_DISPLACED_TOTAL = REGISTRY.counter(
    "interruption_displaced_pods_total",
    "Pods displaced off interrupted nodes into the provisioner",
)
INTERRUPTION_ACTIVE_NODES = REGISTRY.gauge(
    "interruption_active_nodes",
    "Nodes currently draining under an interruption notice",
)
# Margin left on the reclaim clock when the node entered the finalizer path:
# shrinking lead means drains are racing the deadline — raise capacity or
# lower the escalation fraction.
INTERRUPTION_DRAIN_LEAD = REGISTRY.histogram(
    "interruption_drain_lead_seconds",
    "Seconds of reclaim deadline remaining when the drained node was deleted",
    buckets=(1.0, 5.0, 10.0, 30.0, 60.0, 90.0, 120.0, 300.0),
)


class InterruptionController:
    """Periodic sweep (Manager drives it like instancegc): map provider
    interruption events to nodes, drain ahead of the deadline, replace
    before the pods land."""

    def __init__(
        self,
        cluster: Cluster,
        cloud: CloudProvider,
        provisioning: ProvisioningController,
        termination: TerminationController,
        escalate_fraction: float = DEFAULT_ESCALATE_FRACTION,
        cluster_state=None,
        price_book=None,
    ):
        self.cluster = cluster
        self.cloud = cloud
        self.provisioning = provisioning
        self.termination = termination
        self.escalate_fraction = escalate_fraction
        # The Manager's own PriceBook (market/pricebook.py): interruptions
        # raise the reclaimed pool's forecast hazard. Injected — never read
        # from the process-global active_book(), which with two Managers
        # alive (restart harnesses, parity suites) would attribute THIS
        # manager's interruptions to the OTHER's market state. None = no
        # live market attached (unit harnesses), hazard not tracked.
        self.price_book = price_book
        # Event ids whose hazard was already noted (at-least-once dedup for
        # note_interruption; see _ingest). In-memory: a restart may re-note
        # a redelivered event once, which the half-life decay absorbs.
        self._noted: set = set()
        # Incremental encoder: the drain's replaceable-pod listing reads its
        # O(delta)-maintained per-node index instead of filtering the whole
        # store per node per sweep; displacement itself re-reads the store
        # (reschedule_pod), and the replacement re-solve the displaced pods
        # feed (ProvisionerWorker.add) solves against the same state.
        self.cluster_state = cluster_state
        self.log = klog.named("interruption")
        # node name -> first sweep that saw its interruption; the escalation
        # anchor. In-memory only: after a restart the window re-anchors at
        # the restart (the remaining time to the ANNOTATED deadline shrinks,
        # so escalation can only come sooner, never later than the deadline).
        self._observed: Dict[str, float] = {}

    # --- sweep --------------------------------------------------------------

    def reconcile(self, _key=None) -> float:
        for event in self.cloud.poll_interruptions():
            self._ingest(event)
        draining = []
        for node in self.cluster.list_nodes():
            if wellknown.INTERRUPTION_KIND_ANNOTATION not in node.annotations:
                continue
            if node.deletion_timestamp is not None:
                continue  # the finalizer path owns it now (termination)
            draining.append(node)
        # Prune anchors for nodes that left the drain set — including ones
        # deleted AND fully removed between sweeps (external delete,
        # Liveness/Expiration), which the loop above never visits.
        names = {node.name for node in draining}
        self._observed = {
            name: at for name, at in self._observed.items() if name in names
        }
        for node in draining:
            self._drain(node)
        INTERRUPTION_ACTIVE_NODES.set(float(len(draining)))
        return SWEEP_SECONDS

    # --- ingest (record-then-ack) -------------------------------------------

    def _ingest(self, event: InterruptionEvent) -> None:
        INTERRUPTION_EVENTS_TOTAL.inc(event.kind)
        node = self._match_node(event)
        if node is None:
            # Instance already gone (or never registered — instancegc's
            # problem, not ours): ack so the queue doesn't clog.
            INTERRUPTION_UNMATCHED_TOTAL.inc()
            self.log.info(
                "interruption %s for unmatched instance %s; acked",
                event.kind, event.instance_id,
            )
            self.cloud.ack_interruption(event)
            return
        self._record(node, event)
        # The pool is being reclaimed: black it out so the replacement
        # re-solve excludes it. In-memory, so it sits BEFORE the ack — a
        # crash here re-delivers the event and re-arms the blackout.
        self.cloud.blackout_offering(
            node.instance_type, node.zone, node.capacity_type
        )
        # And raise the pool's interruption hazard: the forecast penalty
        # (market/forecast.py) steers FUTURE packing away from this pool
        # even after the blackout TTL lapses, decaying on a half-life.
        # Deduped per event id: the feed is at-least-once (an ack that
        # fails after retries redelivers), and note_interruption is a
        # counted increment — without the dedup one physical interruption
        # would double its hazard contribution on every redelivery. The
        # blackout above is naturally idempotent; this is not.
        if self.price_book is not None and event.event_id not in self._noted:
            if len(self._noted) >= 4096:
                # Bounded: clear BEFORE adding so the current id survives
                # the flush (old ids never redeliver; the one being
                # processed right now absolutely can — its ack is next).
                self._noted.clear()
            self._noted.add(event.event_id)
            self.price_book.note_interruption((node.instance_type, node.zone))
        crashpoint("interruption.after-annotate")
        self.cloud.ack_interruption(event)

    def _match_node(self, event: InterruptionEvent) -> Optional[NodeSpec]:
        """Join on provider_id when the event carries one, else on the
        instance id suffix of the node's provider id (EC2 events name only
        the instance)."""
        for node in self.cluster.list_nodes():
            if event.provider_id and node.provider_id == event.provider_id:
                return node
            if event.instance_id and node.provider_id.endswith(
                "/" + event.instance_id
            ):
                return node
        return None

    def _record(self, node: NodeSpec, event: InterruptionEvent) -> None:
        """Stamp the interruption onto the Node (idempotent; a harder kind
        or an earlier deadline upgrades a previous stamp)."""
        current = node.annotations.get(wellknown.INTERRUPTION_KIND_ANNOTATION)
        changed = False
        if current is None or (
            event.is_hard() and current not in HARD_INTERRUPTION_KINDS
        ):
            node.annotations[wellknown.INTERRUPTION_KIND_ANNOTATION] = event.kind
            changed = True
        if event.deadline is not None:
            known = self._deadline(node)
            if known is None or event.deadline < known:
                node.annotations[
                    wellknown.INTERRUPTION_DEADLINE_ANNOTATION
                ] = repr(event.deadline)
                changed = True
        if changed:
            self.cluster.update_node(node)
            self.log.warning(
                "node %s (%s %s/%s) interrupted: %s, deadline %s",
                node.name, node.instance_type, node.zone, node.capacity_type,
                event.kind, event.deadline if event.deadline else "none",
            )

    @staticmethod
    def _deadline(node: NodeSpec) -> Optional[float]:
        raw = node.annotations.get(wellknown.INTERRUPTION_DEADLINE_ANNOTATION)
        try:
            return float(raw) if raw else None
        except ValueError:
            return None

    # --- drain ---------------------------------------------------------------

    def _drain(self, node: NodeSpec) -> None:
        self.termination.terminator.cordon(node)
        now = self.cluster.clock.now()
        deadline = self._deadline(node)
        anchor = self._observed.setdefault(node.name, now)
        # Only HARD kinds may escalate — a soft event carrying a deadline
        # (whatever stamped it) still never buys the right to override
        # protections; the capacity is merely at elevated risk.
        hard = (
            node.annotations.get(wellknown.INTERRUPTION_KIND_ANNOTATION)
            in HARD_INTERRUPTION_KINDS
        )
        escalated = (
            hard
            and deadline is not None
            and now >= anchor + (
                self.escalate_fraction * max(0.0, deadline - anchor)
            )
        )
        displaced = [
            self._displace(node, pod, escalated)
            for pod in self._replaceable(node)
        ]
        if not all(displaced):
            return  # protected/PDB-blocked pods wait for the next sweep
        # Drained of everything replaceable: hand the node to the finalizer
        # path (termination drains the daemon tail, deletes at the cloud,
        # strips the finalizer) so instancegc invariants hold unchanged.
        crashpoint("interruption.before-delete")
        self._observed.pop(node.name, None)
        if deadline is not None:
            INTERRUPTION_DRAIN_LEAD.observe(max(0.0, deadline - now))
        self.cluster.delete_node(node.name)
        self.log.info("interrupted node %s drained; deleting", node.name)

    def _replaceable(self, node: NodeSpec) -> List[PodSpec]:
        """Pods worth replacement capacity — the same drain-eligibility
        predicate the terminator's eviction set uses, so the 'nothing
        replaceable left' handoff and the finalizer drain cannot disagree."""
        if self.cluster_state is not None:
            pods = self.cluster_state.pods_on_node(node.name)
        else:
            pods = self.cluster.list_pods(node_name=node.name)
        return [pod for pod in pods if pod.survives_node_drain()]

    def _displace(self, node: NodeSpec, pod: PodSpec, escalated: bool) -> bool:
        """Unbind one pod back to pending and feed it to the provisioner.
        Polite before escalation (do-not-evict waits, PDB refusals retry);
        past it, overrides are taken — and counted — rather than letting the
        reclaim kill the pod uncleanly."""
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
            INTERRUPTION_OVERRIDE_TOTAL.inc("pdb")
            self.log.warning(
                "deadline escalation: displacing %s/%s from %s OVER its PDB",
                pod.namespace, pod.name, node.name,
            )
        if live is None:
            return True  # vanished under us: nothing left to replace
        if protected:
            INTERRUPTION_OVERRIDE_TOTAL.inc("do-not-evict")
            self.log.warning(
                "deadline escalation: displacing %s/%s from %s despite "
                "do-not-evict", pod.namespace, pod.name, node.name,
            )
        INTERRUPTION_DISPLACED_TOTAL.inc()
        crashpoint("interruption.mid-drain")
        self._feed(node, live)
        return True

    def _feed(self, node: NodeSpec, pod: PodSpec) -> None:
        """Proactive replacement: hand the displaced pod straight to the
        owning provisioner's batch window (skipping a selection round trip)
        so replacement capacity is launching while the rest of the drain
        runs. Without a worker (foreign node, provisioner deleted) the
        reschedule's watch event still routes the pod through selection."""
        name = node.labels.get(wellknown.PROVISIONER_NAME_LABEL, "")
        worker = self.provisioning.worker(name)
        if worker is not None:
            worker.add(pod)
