"""Pod model — the slice of a kube Pod the provisioning path consumes.

Ref: the reference operates on v1.Pod via helpers in pkg/utils/pod and
v1alpha5.Requirements.PodRequirements (requirements.go:58-76). We model only
the fields those paths read: requests, nodeSelector, node affinity, tolerations,
topology-spread constraints, ownership, and scheduling status.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from types import MappingProxyType
from typing import Dict, List, Optional, Tuple

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.requirements import Requirement, Requirements
from karpenter_tpu_torch.api.resources import ResourceList, parse_resource_list
from karpenter_tpu_torch.api.taints import Toleration

_uid_counter = itertools.count(1)

# Lazily-bound ops.encode.resource_vector (function-level import would pay
# import-machinery overhead per pod construction — ~9ms across a 50k storm;
# a module-level import would be circular, encode imports this module).
_resource_vector = None


def _dense_request_cache(parsed: Dict[str, float]):
    """(vector, vector bytes) — THE dense-vector cache format. Built here at
    construction and read by ops.encode.group_pods; one definition so the
    two sides cannot drift."""
    global _resource_vector
    if _resource_vector is None:
        from karpenter_tpu_torch.ops.encode import resource_vector

        _resource_vector = resource_vector
    vec = _resource_vector(parsed)
    return vec, vec.tobytes()

PHASE_PENDING = "Pending"
PHASE_RUNNING = "Running"
PHASE_SUCCEEDED = "Succeeded"
PHASE_FAILED = "Failed"

DO_NOT_SCHEDULE = "DoNotSchedule"
SCHEDULE_ANYWAY = "ScheduleAnyway"


@dataclass
class TopologySpreadConstraint:
    max_skew: int
    topology_key: str
    when_unsatisfiable: str = DO_NOT_SCHEDULE
    # Simplified selector: pods match iff their labels contain all these pairs.
    match_labels: Dict[str, str] = field(default_factory=dict)

    def matches(self, labels: Dict[str, str]) -> bool:
        return all(labels.get(k) == v for k, v in self.match_labels.items())

    def group_key(self) -> Tuple:
        """Constraints with equal key are spread together
        (ref: scheduling/topology.go:57-75 hashes the constraint)."""
        return (
            self.max_skew,
            self.topology_key,
            self.when_unsatisfiable,
            tuple(sorted(self.match_labels.items())),
        )


@dataclass
class PreferredTerm:
    weight: int
    requirements: List[Requirement]


@dataclass
class PodSpec:
    name: str
    namespace: str = "default"
    uid: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)

    # Effective resource requests (already folded across containers).
    requests: ResourceList = field(default_factory=dict)

    node_selector: Dict[str, str] = field(default_factory=dict)
    # Required node affinity: OR over terms, AND within a term.
    required_terms: List[List[Requirement]] = field(default_factory=list)
    # matchFields terms are modeled only so selection can reject them
    # (ref: selection/controller.go validate:108-159 — the provisioning path
    # doesn't support field selectors).
    match_fields_terms: List[dict] = field(default_factory=list)
    preferred_terms: List[PreferredTerm] = field(default_factory=list)
    tolerations: List[Toleration] = field(default_factory=list)
    topology_spread: List[TopologySpreadConstraint] = field(default_factory=list)
    # Inter-pod (anti-)affinity is unsupported by the provisioning path
    # (ref: selection/controller.go:117-123 rejects it); modeled only so
    # selection can reject such pods.
    pod_affinity_terms: List[dict] = field(default_factory=list)
    pod_anti_affinity_terms: List[dict] = field(default_factory=list)

    # Ownership / lifecycle.
    owner_kind: Optional[str] = None  # "DaemonSet", "Node", "ReplicaSet", ...
    priority_class_name: str = ""
    phase: str = PHASE_PENDING
    node_name: Optional[str] = None
    unschedulable: bool = False  # PodScheduled=False reason=Unschedulable
    deletion_timestamp: Optional[float] = None
    # metadata.creationTimestamp (epoch seconds): stamped by the cluster
    # store on first apply when absent, preserved across updates. The pod
    # lifecycle tracker (utils/obs.py) re-anchors its pending clock here
    # after a controller restart, so restart-spanning latency is charged.
    created_at: Optional[float] = None

    def __post_init__(self):
        if not self.uid:
            self.uid = f"pod-uid-{next(_uid_counter)}"
        # Always copy: never alias (and mutate) a caller-supplied dict.
        parsed = parse_resource_list(self.requests)
        # Every pod consumes one pod slot.
        parsed.setdefault(wellknown.RESOURCE_PODS, 1.0)
        # Read-only: the dense-vector cache below depends on requests never
        # changing after parsing, so that invariant is ENFORCED, not assumed
        # (mutating a proxy raises TypeError). Build changed requests into a
        # new PodSpec instead.
        self.requests = MappingProxyType(parsed)
        # Dense [R] request vector, computed HERE — construction is where
        # requests were just parsed, so the (memoized) dict->vector walk
        # happens once per pod at admission time, spread across the watch
        # stream, instead of 50k times inside the solve path's encode
        # (measured: ~35ms of a 50k-pod cold encode was exactly this walk).
        # ops.encode.group_pods reads the cache; requests immutability above
        # keeps it sound.
        self.dense_vector = _dense_request_cache(parsed)

    # --- predicates (ref: pkg/utils/pod/scheduling.go) ----------------------

    def is_scheduled(self) -> bool:
        return self.node_name is not None

    def is_terminal(self) -> bool:
        return self.phase in (PHASE_SUCCEEDED, PHASE_FAILED)

    def is_terminating(self) -> bool:
        return self.deletion_timestamp is not None

    def is_owned_by_daemonset(self) -> bool:
        return self.owner_kind == "DaemonSet"

    def is_owned_by_node(self) -> bool:
        return self.owner_kind == "Node"

    def failed_to_schedule(self) -> bool:
        return self.unschedulable

    def survives_node_drain(self) -> bool:
        """Worth disrupting when its node drains: not already dying, not
        bound to the node by ownership (daemon/static pods die with the
        node, they don't migrate). THE drain-eligibility predicate — the
        terminator's eviction set and the interruption drain's displacement
        set both read it, so they cannot disagree about which pods remain."""
        return not (
            self.is_terminating()
            or self.is_terminal()
            or self.is_owned_by_node()
            or self.is_owned_by_daemonset()
        )

    def is_provisionable(self) -> bool:
        """Candidate for provisioning: unschedulable, unbound, not daemon/static
        (ref: selection/controller.go isProvisionable:104)."""
        return (
            self.failed_to_schedule()
            and not self.is_scheduled()
            and not self.is_owned_by_daemonset()
            and not self.is_owned_by_node()
            and not self.is_terminal()
            and not self.is_terminating()
        )

    # --- scheduling requirements (ref: requirements.go PodRequirements:58-76)

    def scheduling_requirements(self) -> Requirements:
        """nodeSelector + the heaviest preferred term + the first required term.

        The reference deliberately collapses affinity OR-terms to the first
        term and preferences to the single heaviest — relaxation on retry is
        handled separately (selection/preferences.go).
        """
        requirements: List[Requirement] = [
            Requirement.in_(key, [value])
            for key, value in sorted(self.node_selector.items())
        ]
        if self.preferred_terms:
            heaviest = max(self.preferred_terms, key=lambda term: term.weight)
            requirements.extend(heaviest.requirements)
        if self.required_terms:
            requirements.extend(self.required_terms[0])
        return Requirements(requirements)

    def total_requests(self) -> ResourceList:
        return dict(self.requests)
