"""Shared node-disruption eligibility predicates and the disruption ledger.

Emptiness TTL deletion (controllers/node.py), consolidation
(controllers/consolidation.py), drift replacement (controllers/drift.py) and
expiration (rewired through drift as kind "expired") are all VOLUNTARY
disruption paths — they choose to remove capacity that could keep running.
Before this module each carried its own copy of "may I touch this node", and
the copies could disagree: a node stamped with the emptiness timestamp could
concurrently be nominated for a consolidation replace, double-disrupting it.
The predicates live here exactly once; every voluntary actor imports them,
so they cannot drift.

The `DisruptionLedger` generalizes the per-controller budgets into ONE
fleet-wide voluntary-disruption budget (`--disruption-budget`): every
voluntary actor asks the ledger for headroom before claiming a victim, and
every in-flight claim — whichever controller stamped it — counts against the
shared total until the victim is gone. Per-reason caps (consolidation's
`--consolidation-max-disruption`, drift's `--drift-max-disruption`) nest
inside the global budget; the effective headroom for a reason is
min(global remaining, reason cap remaining). The ledger holds no state of
its own: claims are read from the durable node annotations on every call,
so a restarted controller sees exactly the same budget a continuous one
would, and two actors sharing one cluster can never overspend by more than
their sweep interleaving (each claim is re-counted before the next grant).
"""

from __future__ import annotations

from typing import Dict, Optional

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.pods import PodSpec
from karpenter_tpu_torch.cloudprovider import NodeSpec
from karpenter_tpu_torch.controllers.cluster import Cluster
from karpenter_tpu_torch.utils.metrics import REGISTRY

# Fleet-wide cap on concurrently in-flight voluntary disruptions
# (`--disruption-budget`). 0 disables ALL voluntary disruption.
DEFAULT_DISRUPTION_BUDGET = 10

REASON_CONSOLIDATION = "consolidation"
REASON_DRIFT = "drift"
REASON_EMPTINESS = "emptiness"

DISRUPTION_BUDGET_IN_USE = REGISTRY.gauge(
    "disruption_budget_in_use",
    "Voluntary disruptions currently in flight across every reason "
    "(consolidation + drift/expiration + emptiness), as last counted by a "
    "ledger headroom check",
)


def is_workload_pod(pod: PodSpec) -> bool:
    """Counts against emptiness / consolidation headroom: a live pod not
    bound to the node by ownership (daemon/static pods die with the node)
    and not already on its way out (ref: emptiness.go isEmpty:84)."""
    return not (
        pod.is_terminal()
        or pod.is_terminating()
        or pod.is_owned_by_daemonset()
        or pod.is_owned_by_node()
    )


def is_empty(cluster: Cluster, node: NodeSpec) -> bool:
    """Empty = no workload pods (only daemons/static/terminating remain)."""
    for pod in cluster.list_pods(node_name=node.name):
        if is_workload_pod(pod):
            return False
    return True


def voluntary_disruption_allowed(node: NodeSpec) -> bool:
    """A node may be voluntarily disrupted only when no other lifecycle owns
    it: it has joined (ready), is not already deleting (the finalizer path
    owns it), and carries no interruption notice (the reclamation drain owns
    it — voluntary cost actions must never fight the deadline-driven one)."""
    return (
        node.ready
        and node.deletion_timestamp is None
        and wellknown.INTERRUPTION_KIND_ANNOTATION not in node.annotations
    )


def emptiness_owns(provisioner, node: NodeSpec) -> bool:
    """True when the emptiness TTL path has claimed this node (the TTL is
    configured and the timestamp is stamped): its deletion is already
    scheduled, so consolidation must not concurrently nominate it."""
    return (
        provisioner is not None
        and provisioner.spec.ttl_seconds_after_empty is not None
        and wellknown.EMPTINESS_TIMESTAMP_ANNOTATION in node.annotations
    )


def claim_reason(node: NodeSpec) -> Optional[str]:
    """Which voluntary-disruption reason currently owns this node, or None.

    Consolidation and drift claims are the durable action annotations —
    present from the moment of nomination until the finalizer removes the
    node, so a victim counts against the budget through its whole drain.
    An emptiness claim counts only once DELETION has begun: the timestamp
    annotation alone is a scheduled intent (an idle cluster can carry dozens
    of empty nodes waiting out their TTL, and those must not starve
    consolidation/drift of the shared budget — they are not disrupting
    anything yet)."""
    if wellknown.CONSOLIDATION_ACTION_ANNOTATION in node.annotations:
        return REASON_CONSOLIDATION
    if wellknown.DRIFT_ACTION_ANNOTATION in node.annotations:
        return REASON_DRIFT
    if (
        wellknown.EMPTINESS_TIMESTAMP_ANNOTATION in node.annotations
        and node.deletion_timestamp is not None
    ):
        return REASON_EMPTINESS
    return None


class DisruptionLedger:
    """The shared voluntary-disruption budget (module docstring).

    Stateless over the store: `in_flight()` re-derives the claim counts from
    the durable node annotations on every call, so the ledger needs no
    persistence, no cross-controller locking, and survives restarts for
    free. `reason_caps` maps reason -> per-reason concurrent cap (a missing
    reason is bounded only by the global budget; a cap of 0 disables that
    reason entirely)."""

    def __init__(
        self,
        cluster: Cluster,
        budget: int = DEFAULT_DISRUPTION_BUDGET,
        reason_caps: Optional[Dict[str, int]] = None,
    ):
        self.cluster = cluster
        self.budget = budget
        self.reason_caps = dict(reason_caps or {})

    def in_flight(self) -> Dict[str, int]:
        """Live claim count per reason, freshly derived from the store."""
        counts = {
            REASON_CONSOLIDATION: 0,
            REASON_DRIFT: 0,
            REASON_EMPTINESS: 0,
        }
        for node in self.cluster.list_nodes():
            reason = claim_reason(node)
            if reason is not None:
                counts[reason] += 1
        return counts

    def headroom(self, reason: str) -> int:
        """How many NEW victims `reason` may claim right now:
        min(global budget remaining, reason cap remaining), floored at 0."""
        counts = self.in_flight()
        total = sum(counts.values())
        DISRUPTION_BUDGET_IN_USE.set(float(total))
        room = self.budget - total
        cap = self.reason_caps.get(reason)
        if cap is not None:
            room = min(room, cap - counts.get(reason, 0))
        return max(0, room)
