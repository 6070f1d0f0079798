"""Node lifecycle: readiness, liveness, expiration, emptiness, finalizer.

Ref: pkg/controllers/node/*.go — an umbrella reconciler runs five
sub-reconcilers over every karpenter-managed node and requeues at the soonest
of their requested times (ref: utils/result/result.go Min combinator).
"""

from __future__ import annotations

from typing import List, Optional

from karpenter_tpu_torch import drift as driftlib
from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.taints import Taint
from karpenter_tpu_torch.cloudprovider import NodeSpec
from karpenter_tpu_torch.controllers import eligibility
from karpenter_tpu_torch.controllers.cluster import Cluster

LIVENESS_TIMEOUT_SECONDS = 15 * 60  # ref: node/liveness.go:31
# How soon a budget-starved expiration/emptiness retries its claim.
BUDGET_REQUEUE_SECONDS = 10.0


def _min_requeue(*results: Optional[float]) -> Optional[float]:
    values = [r for r in results if r is not None]
    return min(values) if values else None


class Readiness:
    """Strip the not-ready taint once the kubelet reports Ready, and — the
    other direction the reference never implemented — re-add it when a node
    that HAD joined goes NotReady, so the solver stops packing onto a sick
    node (ref: node/readiness.go:27-41; the one-way-taint gap)."""

    def reconcile(self, cluster: Cluster, provisioner, node: NodeSpec) -> Optional[float]:
        if not node.ready:
            # Only nodes that once reported get the taint re-added: a
            # never-joined node still carries its registration taint, and
            # re-tainting it here would double-write every liveness wait.
            if node.status_reported_at is not None and not any(
                t.key == wellknown.NOT_READY_TAINT_KEY for t in node.taints
            ):
                node.taints.append(
                    Taint(key=wellknown.NOT_READY_TAINT_KEY, effect="NoSchedule")
                )
                cluster.update_node(node)
            return None
        before = len(node.taints)
        node.taints = [
            t for t in node.taints if t.key != wellknown.NOT_READY_TAINT_KEY
        ]
        if len(node.taints) != before:
            cluster.update_node(node)
            # The node-ready lifecycle edge: pods already bound here waited
            # on the kubelet — attribute that wait to their node-ready phase.
            from karpenter_tpu_torch.utils.obs import OBS

            OBS.stamp_many(
                [p.uid for p in cluster.list_pods(node_name=node.name)],
                "node-ready",
            )
        return None

    # taint list uses Taint dataclass; imported for type parity
    _ = Taint


class Liveness:
    """Delete nodes whose kubelet never reported within the timeout — the
    runaway-scale guard (ref: node/liveness.go:31-52, designs/limits.md).

    Deliberately scoped to the NEVER-joined case: a node that reported once
    and then went dark is the health controller's job
    (controllers/health.py), which drains and replaces instead of deleting
    out from under still-running pods."""

    def __init__(self, timeout: float = LIVENESS_TIMEOUT_SECONDS):
        self.timeout = timeout

    def reconcile(self, cluster: Cluster, provisioner, node: NodeSpec) -> Optional[float]:
        if node.status_reported_at is not None:
            return None
        age = cluster.clock.now() - node.created_at
        if age >= self.timeout:
            cluster.delete_node(node.name)
            return None
        return self.timeout - age


class HashStamp:
    """Back-fill the provisioner-hash annotation on nodes that predate drift
    detection (legacy/adopted capacity). A missing hash is NEVER drift: the
    node is stamped with the CURRENT stored-spec hash and participates in
    spec-hash drift from the next spec change onward — adopting a fleet must
    not instantly nominate all of it for replacement."""

    def reconcile(self, cluster: Cluster, provisioner, node: NodeSpec) -> Optional[float]:
        if wellknown.PROVISIONER_HASH_ANNOTATION not in node.annotations:
            node.annotations[wellknown.PROVISIONER_HASH_ANNOTATION] = (
                driftlib.spec_hash(provisioner)
            )
            cluster.update_node(node)
        return None


class Expiration:
    """Expire nodes older than ttlSecondsUntilExpired — the node-upgrade /
    chaos mechanism (ref: node/expiration.go:37-52), rewired through the
    drift machinery: an expired node is just drift of kind "expired". The
    claim is the durable drift-action annotation, budgeted through the
    shared DisruptionLedger, so N simultaneously-expired nodes roll
    budget-at-a-time instead of the whole fleet deleting at once. Deletion
    still happens right here (the finalizer drain takes over), so expiration
    works even where the drift controller isn't running; when it IS running,
    its sweep sees the same annotation and never double-claims."""

    def __init__(self, ledger: Optional[eligibility.DisruptionLedger] = None):
        self.ledger = ledger

    def reconcile(self, cluster: Cluster, provisioner, node: NodeSpec) -> Optional[float]:
        ttl = provisioner.spec.ttl_seconds_until_expired
        if ttl is None:
            return None
        age = cluster.clock.now() - node.created_at
        if age < ttl:
            return ttl - age
        if wellknown.DRIFT_ACTION_ANNOTATION in node.annotations:
            return None  # already claimed (by us earlier, or the drift sweep)
        if wellknown.INTERRUPTION_KIND_ANNOTATION in node.annotations:
            return None  # the reclamation drain owns it; it's dying anyway
        if eligibility.claim_reason(node) is not None:
            return BUDGET_REQUEUE_SECONDS  # another voluntary actor owns it
        ledger = self.ledger or eligibility.DisruptionLedger(cluster)
        if ledger.headroom(eligibility.REASON_DRIFT) <= 0:
            return BUDGET_REQUEUE_SECONDS  # budget spent: roll on a later pass
        node.annotations[wellknown.DRIFT_ACTION_ANNOTATION] = (
            driftlib.DRIFT_KIND_EXPIRED
        )
        cluster.update_node(node)
        # Lazy import: controllers.drift pulls in provisioning/termination,
        # which this leaf module must not import at module load.
        from karpenter_tpu_torch.controllers.drift import DRIFT_REPLACEMENTS_TOTAL
        from karpenter_tpu_torch.utils.obs import RECORDER

        RECORDER.record(
            "drift",
            node=node.name,
            drift_kind=driftlib.DRIFT_KIND_EXPIRED,
            reason=f"node age {age:.0f}s >= ttlSecondsUntilExpired {ttl}s",
        )
        DRIFT_REPLACEMENTS_TOTAL.inc(driftlib.DRIFT_KIND_EXPIRED, "executed")
        cluster.delete_node(node.name)
        return None


class Emptiness:
    """Stamp/clear the emptiness timestamp; delete past ttlSecondsAfterEmpty
    (ref: node/emptiness.go:38-99). The delete consults the shared
    DisruptionLedger: a stamped-and-waiting empty node costs nothing, but
    actually deleting one is a voluntary disruption like any other."""

    def __init__(self, ledger: Optional[eligibility.DisruptionLedger] = None):
        self.ledger = ledger

    def reconcile(self, cluster: Cluster, provisioner, node: NodeSpec) -> Optional[float]:
        ttl = provisioner.spec.ttl_seconds_after_empty
        if ttl is None:
            return None
        # Shared voluntary-disruption gate (controllers/eligibility.py): the
        # same predicate consolidation nominates through, so an interrupted
        # or already-deleting node can't be claimed by both paths at once.
        if not eligibility.voluntary_disruption_allowed(node):
            return None
        if not eligibility.is_empty(cluster, node):
            if wellknown.EMPTINESS_TIMESTAMP_ANNOTATION in node.annotations:
                # The dedicated removal verb: a plain update_node merge-patch
                # cannot delete the key on the apiserver backend.
                cluster.remove_node_annotation(
                    node, wellknown.EMPTINESS_TIMESTAMP_ANNOTATION
                )
            return None
        stamp = node.annotations.get(wellknown.EMPTINESS_TIMESTAMP_ANNOTATION)
        now = cluster.clock.now()
        if stamp is None:
            node.annotations[wellknown.EMPTINESS_TIMESTAMP_ANNOTATION] = str(now)
            cluster.update_node(node)
            return ttl
        elapsed = now - float(stamp)
        if elapsed >= ttl:
            ledger = self.ledger or eligibility.DisruptionLedger(cluster)
            if ledger.headroom(eligibility.REASON_EMPTINESS) <= 0:
                return BUDGET_REQUEUE_SECONDS  # budget spent: retry shortly
            cluster.delete_node(node.name)
            return None
        return ttl - elapsed


class Finalizer:
    """Re-add the termination finalizer to nodes that lost or never had it
    (ref: node/finalizer.go:28-40)."""

    def reconcile(self, cluster: Cluster, provisioner, node: NodeSpec) -> Optional[float]:
        if node.deletion_timestamp is not None:
            return None
        if wellknown.TERMINATION_FINALIZER not in node.finalizers:
            node.finalizers.append(wellknown.TERMINATION_FINALIZER)
            cluster.update_node(node)
        return None


class NodeController:
    """Umbrella reconciler (ref: node/controller.go:61-115): only
    karpenter-labeled nodes, skip deleting ones, run sub-reconcilers, requeue
    at the soonest requested time."""

    def __init__(
        self,
        cluster: Cluster,
        liveness_timeout: float = LIVENESS_TIMEOUT_SECONDS,
        ledger: Optional[eligibility.DisruptionLedger] = None,
    ):
        self.cluster = cluster
        self.reconcilers = [
            Readiness(),
            Liveness(timeout=liveness_timeout),
            HashStamp(),
            Expiration(ledger=ledger),
            Emptiness(ledger=ledger),
            Finalizer(),
        ]

    def reconcile(self, name: str) -> Optional[float]:
        node = self.cluster.try_get_node(name)
        if node is None or node.deletion_timestamp is not None:
            return None
        provisioner_name = node.labels.get(wellknown.PROVISIONER_NAME_LABEL)
        if provisioner_name is None:
            return None  # not ours
        provisioner = self.cluster.try_get_provisioner(provisioner_name)
        if provisioner is None:
            return None
        results = []
        for reconciler in self.reconcilers:
            results.append(reconciler.reconcile(self.cluster, provisioner, node))
            # RE-READ between sub-reconcilers, don't just probe existence:
            # on the apiserver backend a watch event (kubelet heartbeat, a
            # rival controller's patch) can REPLACE the cached object
            # mid-sequence, and the next sub-reconciler writing through the
            # stale reference would undo that update. The refreshed object
            # also catches a sub-reconciler's own delete (deletion held by
            # the finalizer), which ends the pass.
            node = self.cluster.try_get_node(name)
            if node is None or node.deletion_timestamp is not None:
                return None  # a sub-reconciler (or a rival) deleted the node
        return _min_requeue(*results)
