"""Consolidation: cost-driven deprovisioning by cluster re-solve.

Everything before this controller only solves for PENDING pods — nodes are
bought, then removed only when empty, expired, or dead, so cost drifts
upward as workloads churn (BENCH_r05 steady-state cost_ratio 0.64, per-seed
lows of 0.51). This subsystem closes the loop from observed cluster state
back through the batched solver to a deprovisioning decision, the way
modern Karpenter's consolidation does — except the counterfactuals for ALL
candidate nodes are scored in one batched dispatch (ops/consolidate.py)
instead of being simulated one at a time:

1. **Nominate.** Underutilized-by-requested-resources nodes that nothing
   else owns: cordon-free, ready, not deleting, no interruption notice, not
   claimed by the emptiness TTL (the shared predicates in
   controllers/eligibility.py), current offering marked `consolidatable`,
   and every replaceable pod PDB-drainable right now
   (`PodSpec.survives_node_drain()` + the cluster's PDB gate).

2. **Batch-evaluate.** One `ops.consolidate.solve_candidates` dispatch per
   sweep scores, for every candidate simultaneously, "delete the node and
   repack its pods onto remaining headroom" and "replace the node with a
   strictly cheaper instance type", with per-candidate masking carrying the
   envelope differences. Savings are $/hr at the current offering prices.

3. **Execute** the best cost-positive action(s) — at most
   `--consolidation-max-disruption` (default 1) per sweep — through the
   PR 3 drain path: stamp the action annotation (durable intent), cordon,
   PDB-gated `reschedule_pod` displacement (bumping the reschedule epoch so
   any replacement launch never aliases the dying node's purchase), then
   finalizer-path delete. Delete-action pods are rebound straight onto
   their planned receivers (this store has no kube-scheduler to do it);
   replace-action pods are fed to `ProvisionerWorker.add`, so replacement
   capacity is launching BEFORE the victim finishes draining. Consolidation
   is strictly voluntary: it never overrides PDBs or do-not-evict — a
   protection appearing mid-drain cancels the action.

Consolidation yields to reclamation: any interruption notice or a foreign
node deletion suppresses sweeps for `--consolidation-cooldown` seconds past
the last observed activity, so the voluntary path never fights the
deadline-driven one.

Crash consistency: `consolidation.{after-nominate,mid-drain,before-delete}`
are named crashpoints; the battletest (tests/test_consolidation.py,
`make consolidation-smoke`) kills the controller at each and asserts a
restart converges — pods bound exactly once, victim gone, zero leaks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.pods import PodSpec
from karpenter_tpu_torch.api.provisioner import PodIncompatibleError
from karpenter_tpu_torch.api.taints import taints_tolerate_pod
from karpenter_tpu_torch.cloudprovider import CloudProvider, NodeSpec, Offering
from karpenter_tpu_torch.controllers import eligibility
from karpenter_tpu_torch.controllers.cluster import Cluster
from karpenter_tpu_torch.controllers.errors import PDBViolationError
from karpenter_tpu_torch.controllers.provisioning import ProvisioningController
from karpenter_tpu_torch.controllers.termination import TerminationController
from karpenter_tpu_torch.ops import consolidate
from karpenter_tpu_torch.ops.encode import (
    InstanceFleet,
    PodGroups,
    build_fleet,
    group_pods,
    resource_vector,
)
from karpenter_tpu_torch.utils import logging as klog
from karpenter_tpu_torch.utils.crashpoints import crashpoint
from karpenter_tpu_torch.utils.metrics import REGISTRY

SWEEP_SECONDS = 10.0
# Voluntary disruption waits this long after any interruption/termination
# activity so consolidation never fights the reclamation path.
DEFAULT_COOLDOWN_SECONDS = 60.0
DEFAULT_MAX_DISRUPTION = 1
# A node is nominated when its requested-resources utilization (max over
# tracked dims) sits below this fraction — fuller nodes have nothing worth
# shedding: delete can't repack them and a strictly cheaper type can't hold
# their demand.
UNDERUTILIZED_FRACTION = 0.85
# Candidate cap per sweep: the batched solve is cheap but the nomination
# walk is O(nodes x pods); the lowest-utilization slice carries the wins.
MAX_CANDIDATES = 64

ACTION_DELETE = "delete"
ACTION_REPLACE = "replace"

CONSOLIDATION_ACTIONS_TOTAL = REGISTRY.counter(
    "consolidation_actions_total",
    "Consolidation actions by kind and outcome "
    "(executed|blocked|cancelled)",
    ["action", "result"],
)
CONSOLIDATION_SAVINGS_TOTAL = REGISTRY.counter(
    "consolidation_savings_dollars_total",
    "Projected $/hr shed by executed consolidation actions (accumulates "
    "the per-action savings estimate)",
)
CONSOLIDATION_CANDIDATES = REGISTRY.gauge(
    "consolidation_candidate_count",
    "Nodes nominated for counterfactual evaluation in the last sweep",
)


@dataclass
class Candidate:
    node: NodeSpec
    provisioner_name: str
    pods: List[PodSpec]  # replaceable (survives_node_drain) pods
    groups: PodGroups
    price: float  # current offering $/hr
    utilization: float
    constrained: bool  # pods carry node-level scheduling requirements


@dataclass
class Action:
    node_name: str
    kind: str  # ACTION_DELETE | ACTION_REPLACE
    savings: float
    # Delete only: pod uid -> planned receiver node name. Best-effort — a
    # receiver that changed since the solve falls back to the provisioner.
    assignment: Optional[Dict[str, str]] = None


class ConsolidationController:
    """Periodic sweep (Manager drives it like instancegc/interruption):
    nominate, batch-evaluate, execute at most the disruption budget."""

    def __init__(
        self,
        cluster: Cluster,
        cloud: CloudProvider,
        provisioning: ProvisioningController,
        termination: TerminationController,
        max_disruption: int = DEFAULT_MAX_DISRUPTION,
        cooldown_seconds: float = DEFAULT_COOLDOWN_SECONDS,
        cluster_state=None,
        ledger: Optional[eligibility.DisruptionLedger] = None,
        device=None,
    ):
        self.cluster = cluster
        self.cloud = cloud
        self.provisioning = provisioning
        self.termination = termination
        self.max_disruption = max_disruption
        self.cooldown_seconds = cooldown_seconds
        # The shared voluntary-disruption budget. The Manager passes one
        # ledger spanning every voluntary actor; directly-constructed
        # controllers (tests) get a private ledger whose consolidation cap
        # is max_disruption — the pre-ledger budget semantics.
        self.ledger = ledger or eligibility.DisruptionLedger(
            cluster,
            reason_caps={eligibility.REASON_CONSOLIDATION: max_disruption},
        )
        # Incremental encoder (models/cluster_state.DeviceClusterState):
        # nomination and receiver scoring read its O(delta)-maintained
        # per-node pod index and used vectors instead of re-listing every
        # pod per node per sweep (O(nodes x pods) on the snapshot path).
        # EXECUTION (drain / rebind) stays on the authoritative store.
        self.cluster_state = cluster_state
        # The device the counterfactual solve (K7) runs on: None is the
        # card, "cpu" the kernel's plain version.
        self.device = device
        self.log = klog.named("consolidation")
        # In-memory accounting only: the ACTION ANNOTATION on the victim is
        # the durable intent a restart resumes from. Savings estimates are
        # best-effort across a restart (delete recomputes from the current
        # offering price; a resumed replace records 0).
        self._savings: Dict[str, float] = {}
        self._last_reclamation: Optional[float] = None

    # --- sweep --------------------------------------------------------------

    def reconcile(self, _key=None) -> float:
        if self.max_disruption <= 0:
            return SWEEP_SECONDS  # consolidation disabled
        # Resume in-flight drains first (a restarted controller finds the
        # durable action annotation; the per-pod plan is recomputable but
        # not stored — resumed displacements route through the provisioner).
        for node in self._claimed_nodes():
            if node.deletion_timestamp is None:
                self._drain(node, assignment=None)
        if self._reclamation_cooldown():
            return SWEEP_SECONDS
        budget = self.ledger.headroom(eligibility.REASON_CONSOLIDATION)
        if budget <= 0:
            return SWEEP_SECONDS
        candidates = self._nominate()
        CONSOLIDATION_CANDIDATES.set(float(len(candidates)))
        if not candidates:
            return SWEEP_SECONDS
        for action in self._evaluate(candidates)[:budget]:
            self._begin(action)
        return SWEEP_SECONDS

    def _claimed_nodes(self) -> List[NodeSpec]:
        """Nodes carrying the consolidation action annotation — in-flight
        victims, whether still draining or already on the finalizer path.
        All of them count against the disruption budget until gone."""
        return [
            node
            for node in self.cluster.list_nodes()
            if wellknown.CONSOLIDATION_ACTION_ANNOTATION in node.annotations
        ]

    def _reclamation_cooldown(self) -> bool:
        """True while interruption/termination activity is live or cooled
        down less than `cooldown_seconds` ago. Our own victims (deleting
        WITH the consolidation annotation) don't arm the cooldown — they are
        paced by the in-flight budget instead."""
        now = self.cluster.clock.now()
        for node in self.cluster.list_nodes():
            foreign_delete = (
                node.deletion_timestamp is not None
                and wellknown.CONSOLIDATION_ACTION_ANNOTATION
                not in node.annotations
            )
            if (
                foreign_delete
                or wellknown.INTERRUPTION_KIND_ANNOTATION in node.annotations
            ):
                self._last_reclamation = now
                return True
        return (
            self._last_reclamation is not None
            and now - self._last_reclamation < self.cooldown_seconds
        )

    # --- nomination ----------------------------------------------------------

    def _nominate(self) -> List[Candidate]:
        catalog = {it.name: it for it in self.cloud.get_instance_types()}
        candidates: List[Candidate] = []
        for node in self.cluster.list_nodes():
            candidate = self._nominate_one(node, catalog)
            if candidate is not None:
                candidates.append(candidate)
        candidates.sort(key=lambda c: (c.utilization, c.node.name))
        return candidates[:MAX_CANDIDATES]

    def _pods_on(self, name: str) -> List[PodSpec]:
        """One node's pods: the incremental index (O(pods on the node))
        when the state is wired, the full-store filter otherwise."""
        if self.cluster_state is not None:
            return self.cluster_state.pods_on_node(name)
        return self.cluster.list_pods(node_name=name)

    def _used_on(self, name: str) -> Optional[np.ndarray]:
        """One node's summed non-terminal request vector from the
        incremental state, or None to compute from a pod walk."""
        if self.cluster_state is not None:
            return self.cluster_state.node_used(name)
        return None

    def _nominate_one(self, node: NodeSpec, catalog) -> Optional[Candidate]:
        provisioner_name = self._owned_and_free(node)
        if provisioner_name is None:
            return None
        offering = self._offering(node, catalog)
        if offering is None or not offering.consolidatable or offering.price <= 0:
            return None
        pods = self._pods_on(node.name)
        replaceable = self._drainable_pods(pods)
        if replaceable is None:
            return None
        utilization = self._utilization(node, pods, catalog)
        if utilization >= UNDERUTILIZED_FRACTION:
            return None
        constrained = any(
            p.node_selector
            or p.required_terms
            or p.topology_spread
            # Pod (anti-)affinity is admitted by selection now (the
            # constraint compiler lowers it); the counterfactual re-solve
            # here does not, so such pods mark the candidate constrained.
            or p.pod_affinity_terms
            or p.pod_anti_affinity_terms
            for p in replaceable
        )
        return Candidate(
            node=node,
            provisioner_name=provisioner_name,
            pods=replaceable,
            groups=group_pods(replaceable),
            price=offering.price,
            utilization=utilization,
            constrained=constrained,
        )

    def _owned_and_free(self, node: NodeSpec) -> Optional[str]:
        """The owning provisioner's name iff the node is ours and no other
        lifecycle has a claim on it (shared voluntary-disruption gate +
        the emptiness-TTL claim from controllers/eligibility.py)."""
        provisioner_name = node.labels.get(wellknown.PROVISIONER_NAME_LABEL)
        if provisioner_name is None:
            return None  # not ours
        provisioner = self.cluster.try_get_provisioner(provisioner_name)
        if provisioner is None:
            return None
        if node.unschedulable:
            return None  # cordoned (by an operator or an in-flight drain)
        if eligibility.claim_reason(node) is not None:
            return None  # in flight already (ours, drift's, or emptiness's)
        if not eligibility.voluntary_disruption_allowed(node):
            return None
        if eligibility.emptiness_owns(provisioner, node):
            return None  # the emptiness TTL path has claimed it
        return provisioner_name

    def _drainable_pods(self, pods: List[PodSpec]) -> Optional[List[PodSpec]]:
        """The replaceable subset of one node's (already listed) pods iff
        every one of them may be displaced right now (no protections, PDB
        budgets all allow it); None marks the node un-nominatable this
        sweep."""
        replaceable = [p for p in pods if p.survives_node_drain()]
        if not replaceable:
            return None  # empty — emptiness's job, not a cost action
        if any(
            wellknown.DO_NOT_EVICT_ANNOTATION in p.annotations
            for p in replaceable
        ):
            return None  # voluntary disruption never overrides protections
        if any(not self.cluster._pdb_allows(p) for p in replaceable):
            return None  # not PDB-drainable right now
        return replaceable

    @staticmethod
    def _offering(node: NodeSpec, catalog) -> Optional[Offering]:
        instance_type = catalog.get(node.instance_type)
        if instance_type is None:
            return None  # unknown or fully blacked-out type: leave it alone
        for offering in instance_type.offerings:
            if (
                offering.zone == node.zone
                and offering.capacity_type == node.capacity_type
            ):
                return offering
        return None

    @staticmethod
    def _pod_vector(pod: PodSpec) -> np.ndarray:
        cached = getattr(pod, "dense_vector", None)
        if cached is not None:
            return cached[0]
        return resource_vector(pod.requests)

    def _usable_capacity(self, node: NodeSpec, catalog) -> np.ndarray:
        """Allocatable vector: raw capacity minus the catalog's overhead for
        this type (zero overhead when the type is unknown)."""
        usable = np.array(resource_vector(node.capacity), dtype=np.float64)
        instance_type = catalog.get(node.instance_type)
        if instance_type is not None:
            usable -= resource_vector(instance_type.overhead)
        return np.maximum(usable, 0.0)

    def _used(self, pods: List[PodSpec]) -> np.ndarray:
        used = np.zeros_like(resource_vector({}), dtype=np.float64)
        for pod in pods:
            if pod.is_terminal():
                continue
            used = used + self._pod_vector(pod)
        return used

    def _utilization(self, node: NodeSpec, pods, catalog) -> float:
        usable = self._usable_capacity(node, catalog)
        used = self._used(pods)
        tracked = usable > 0
        if not tracked.any():
            return 1.0
        return float((used[tracked] / usable[tracked]).max())

    # --- batched counterfactual evaluation -----------------------------------

    def _receivers(self, catalog) -> Tuple[List[NodeSpec], np.ndarray]:
        """Live nodes eligible to absorb displaced pods, with their free
        usable headroom — tightest first (best-fit-decreasing bin order)."""
        receivers: List[Tuple[NodeSpec, np.ndarray]] = []
        for node in self.cluster.list_nodes():
            if not self._can_receive(node):
                continue
            used = self._used_on(node.name)
            if used is None:
                used = self._used(self._pods_on(node.name))
            headroom = self._usable_capacity(node, catalog) - used
            receivers.append((node, np.maximum(headroom, 0.0)))
        cpu = 0  # RESOURCE_DIMS[0] is cpu; deterministic tie-break on name
        receivers.sort(key=lambda item: (item[1][cpu], item[0].name))
        if not receivers:
            return [], np.zeros((0, resource_vector({}).shape[0]), np.float64)
        return (
            [node for node, _ in receivers],
            np.stack([headroom for _, headroom in receivers]),
        )

    @staticmethod
    def _pods_tolerate(node: NodeSpec, pods: List[PodSpec]) -> bool:
        """Every pod tolerates the receiver's NoSchedule/NoExecute taints —
        e.g. another provisioner's tainted capacity never absorbs intolerant
        pods, no matter how much headroom it has."""
        return all(
            taints_tolerate_pod(node.taints, pod.tolerations) for pod in pods
        )

    @staticmethod
    def _can_receive(node: NodeSpec) -> bool:
        return (
            node.ready
            and not node.unschedulable
            and node.deletion_timestamp is None
            and wellknown.INTERRUPTION_KIND_ANNOTATION not in node.annotations
            and wellknown.CONSOLIDATION_ACTION_ANNOTATION not in node.annotations
            and wellknown.DRIFT_ACTION_ANNOTATION not in node.annotations
            and wellknown.EMPTINESS_TIMESTAMP_ANNOTATION not in node.annotations
        )

    def _replacement_fleet(self, worker, group: List[Candidate]):
        """The replacement envelope for one provisioner's candidates: live
        instance types under the worker's EFFECTIVE constraints, usable
        capacity net of overhead and daemon overhead, cheapest allowed
        offering price per type."""
        if worker is None:
            return None
        constraints = worker.provisioner.spec.constraints
        daemons = []
        for template in self.cluster.list_daemonset_templates():
            try:
                constraints.validate_pod(template)
            except PodIncompatibleError:
                continue
            daemons.append(template)
        pods_need = np.zeros_like(resource_vector({}), dtype=np.float32)
        for candidate in group:
            if candidate.groups.num_groups:
                pods_need = np.maximum(
                    pods_need, candidate.groups.vectors.max(axis=0)
                )
        return build_fleet(
            self.cloud.get_instance_types(constraints),
            constraints,
            pods=[],
            daemons=daemons,
            pods_need=pods_need,
        )

    @staticmethod
    def _type_valid(
        group: List[Candidate], fleet: Optional[InstanceFleet]
    ) -> np.ndarray:
        """Per-candidate replacement-type mask: accelerator anti-waste — a
        type carrying accelerators the candidate's pods don't request is not
        a valid replacement (the fleet-level filter used the UNION demand so
        the axis can serve heterogeneous candidates)."""
        from karpenter_tpu_torch.ops.encode import _ACCEL_INDEXES

        if fleet is None or fleet.num_types == 0:
            return np.zeros((len(group), 0), dtype=bool)
        demand = np.stack(
            [
                candidate.groups.vectors.T @ candidate.groups.counts
                if candidate.groups.num_groups
                else np.zeros(fleet.total.shape[1], np.float32)
                for candidate in group
            ]
        )  # [C, R]
        valid = np.ones((len(group), fleet.num_types), dtype=bool)
        for index in _ACCEL_INDEXES:
            valid &= ~(
                (fleet.total[None, :, index] > 0) & (demand[:, None, index] <= 0)
            )
        return valid

    def _evaluate(self, candidates: List[Candidate]) -> List[Action]:
        """One batched counterfactual solve per provisioner group (ONE for
        the common single-provisioner cluster); returns every cost-positive
        action, best savings first."""
        catalog = {it.name: it for it in self.cloud.get_instance_types()}
        receivers, headroom = self._receivers(catalog)
        by_provisioner: Dict[str, List[Candidate]] = {}
        for candidate in candidates:
            by_provisioner.setdefault(candidate.provisioner_name, []).append(
                candidate
            )
        actions: List[Action] = []
        for provisioner_name, group in sorted(by_provisioner.items()):
            worker = self.provisioning.worker(provisioner_name)
            fleet = self._replacement_fleet(worker, group)
            verdicts = self._solve_group(group, receivers, headroom, fleet)
            actions.extend(
                self._actions_from(group, receivers, fleet, verdicts)
            )
        actions.sort(key=lambda a: (-a.savings, a.node_name))
        return actions

    def _solve_group(
        self,
        group: List[Candidate],
        receivers: List[NodeSpec],
        headroom: np.ndarray,
        fleet: Optional[InstanceFleet],
    ) -> consolidate.ConsolidationVerdicts:
        num_dims = int(resource_vector({}).shape[0])
        num_groups = max(
            (candidate.groups.num_groups for candidate in group), default=0
        )
        num_groups = max(num_groups, 1)
        vectors = np.zeros((len(group), num_groups, num_dims), np.float32)
        counts = np.zeros((len(group), num_groups), np.int32)
        bin_mask = np.zeros((len(group), len(receivers)), bool)
        prices = np.zeros(len(group), np.float64)
        for i, candidate in enumerate(group):
            g = candidate.groups.num_groups
            if g:
                vectors[i, :g] = candidate.groups.vectors
                counts[i, :g] = candidate.groups.counts
            prices[i] = candidate.price
            if not candidate.constrained:
                # Per-candidate masking: every eligible receiver except the
                # victim itself, and only receivers whose taints the
                # candidate's pods tolerate. Constrained candidates (pods
                # with node-level scheduling requirements) keep an empty bin
                # row — their delete leg can't be verified resource-only, so
                # only the replace leg (re-solved by the provisioner, which
                # honors constraints) is scored.
                bin_mask[i] = [
                    receiver.name != candidate.node.name
                    and self._pods_tolerate(receiver, candidate.pods)
                    for receiver in receivers
                ]
        if fleet is not None and fleet.num_types:
            type_capacity, type_prices = fleet.capacity, fleet.prices
        else:
            type_capacity = np.zeros((0, num_dims), np.float32)
            type_prices = np.zeros((0,), np.float32)
        problem = consolidate.ConsolidationProblem(
            pod_vectors=vectors,
            pod_counts=counts,
            headroom=headroom.astype(np.float32),
            bin_mask=bin_mask,
            node_prices=prices,
            type_capacity=type_capacity,
            type_prices=type_prices,
            type_valid=self._type_valid(group, fleet),
        )
        return consolidate.solve_candidates(problem, device=self.device)

    def _actions_from(
        self, group, receivers, fleet, verdicts
    ) -> List[Action]:
        actions = []
        for i, candidate in enumerate(group):
            kind = verdicts.action[i]
            if kind == consolidate.ACTION_DELETE:
                assignment = {
                    pod.uid: receivers[j].name
                    for pod, j in consolidate.delete_assignment(
                        verdicts, i, candidate.groups.members
                    )
                }
                actions.append(
                    Action(
                        node_name=candidate.node.name,
                        kind=ACTION_DELETE,
                        savings=float(verdicts.savings[i]),
                        assignment=assignment,
                    )
                )
            elif kind == consolidate.ACTION_REPLACE:
                replacement = fleet.instance_types[int(verdicts.replace_type[i])]
                self.log.info(
                    "replace plan for %s: %s ($%.4f/hr) -> %s ($%.4f/hr)",
                    candidate.node.name, candidate.node.instance_type,
                    candidate.price, replacement.name,
                    float(verdicts.replace_price[i]),
                )
                actions.append(
                    Action(
                        node_name=candidate.node.name,
                        kind=ACTION_REPLACE,
                        savings=float(verdicts.savings[i]),
                    )
                )
        return actions

    # --- execution -----------------------------------------------------------

    def _begin(self, action: Action) -> None:
        node = self.cluster.try_get_node(action.node_name)
        if (
            node is None
            or not eligibility.voluntary_disruption_allowed(node)
            or eligibility.claim_reason(node) is not None
        ):
            return  # the cluster moved under the solve: drop the action
        # Durable intent FIRST: a controller that dies past this point
        # resumes the drain from the annotation.
        node.annotations[wellknown.CONSOLIDATION_ACTION_ANNOTATION] = action.kind
        self.cluster.update_node(node)
        self._savings[node.name] = action.savings
        # Flight-record the decision at its commit point (the annotation is
        # durable intent; this is the forensic record of WHY).
        from karpenter_tpu_torch.utils.obs import RECORDER

        RECORDER.record(
            "consolidate",
            node=node.name,
            action=action.kind,
            instance_type=node.instance_type,
            savings=action.savings,
        )
        self.log.info(
            "consolidating %s (%s %s/%s): %s, projected savings $%.4f/hr",
            node.name, node.instance_type, node.zone, node.capacity_type,
            action.kind, action.savings,
        )
        crashpoint("consolidation.after-nominate")
        displaced = self._drain(node, action.assignment)
        # None = the drain CANCELLED the action (already counted by _cancel);
        # 0 = the whole first sweep was refused (a PDB re-check lost a race):
        # surface that once; the in-flight drain retries politely.
        if displaced == 0 and self.cluster.try_get_node(node.name) is not None:
            CONSOLIDATION_ACTIONS_TOTAL.inc(action.kind, "blocked")

    def _drain(
        self, node: NodeSpec, assignment: Optional[Dict[str, str]]
    ) -> Optional[int]:
        """One polite drain pass; returns how many pods were displaced, or
        None when the action was CANCELLED (so the caller doesn't also count
        it blocked). Completes with the finalizer-path delete once nothing
        replaceable remains."""
        pods = [
            p
            for p in self.cluster.list_pods(node_name=node.name)
            if p.survives_node_drain()
        ]
        if any(
            wellknown.DO_NOT_EVICT_ANNOTATION in p.annotations for p in pods
        ):
            # A protection appeared after nomination: consolidation is
            # voluntary, so the action is cancelled, not escalated.
            self._cancel(node)
            return None
        self.termination.terminator.cordon(node)
        displaced = self._displace_all(node, pods, assignment)
        remaining = [
            p
            for p in self.cluster.list_pods(node_name=node.name)
            if p.survives_node_drain()
        ]
        if not remaining:
            self._complete(node)
        return displaced

    def _displace_all(
        self, node: NodeSpec, pods: List[PodSpec], assignment
    ) -> int:
        displaced = 0
        for pod in pods:
            try:
                live = self.cluster.reschedule_pod(pod.namespace, pod.name)
            except PDBViolationError:
                continue  # budget spent: the drain rolls, one sweep at a time
            if live is None:
                continue  # vanished under us
            displaced += 1
            crashpoint("consolidation.mid-drain")
            target = (assignment or {}).get(pod.uid)
            if target is None or not self._rebind(live, target):
                self._feed(node, live)
        return displaced

    def _complete(self, node: NodeSpec) -> None:
        """Drained of everything replaceable: record the action, hand the
        node to the finalizer path (termination drains the daemon tail,
        deletes at the cloud) so instancegc invariants hold unchanged."""
        crashpoint("consolidation.before-delete")
        kind = node.annotations.get(
            wellknown.CONSOLIDATION_ACTION_ANNOTATION, ACTION_DELETE
        )
        savings = self._savings.pop(node.name, None)
        if savings is None and kind == ACTION_DELETE:
            # Resumed after a restart: a delete's savings IS the node price.
            catalog = {it.name: it for it in self.cloud.get_instance_types()}
            offering = self._offering(node, catalog)
            savings = offering.price if offering is not None else 0.0
        CONSOLIDATION_ACTIONS_TOTAL.inc(kind, "executed")
        CONSOLIDATION_SAVINGS_TOTAL.inc(amount=max(savings or 0.0, 0.0))
        self.cluster.delete_node(node.name)
        self.log.info("consolidated node %s drained; deleting (%s)", node.name, kind)

    def _cancel(self, node: NodeSpec) -> None:
        kind = node.annotations.get(
            wellknown.CONSOLIDATION_ACTION_ANNOTATION, ACTION_DELETE
        )
        # The dedicated removal verb: a plain update_node merge-patch cannot
        # delete the key on the apiserver backend, and a resurrected claim
        # would consume the disruption budget forever.
        self.cluster.remove_node_annotation(
            node, wellknown.CONSOLIDATION_ACTION_ANNOTATION
        )
        self._savings.pop(node.name, None)
        if (
            node.deletion_timestamp is None
            and wellknown.INTERRUPTION_KIND_ANNOTATION not in node.annotations
        ):
            node.unschedulable = False  # undo our cordon
        self.cluster.update_node(node)
        CONSOLIDATION_ACTIONS_TOTAL.inc(kind, "cancelled")
        self.log.warning(
            "consolidation of %s cancelled: a do-not-evict pod appeared "
            "mid-drain (voluntary disruption never overrides protections)",
            node.name,
        )

    def _rebind(self, pod: PodSpec, target_name: str) -> bool:
        """Bind a displaced pod onto its planned receiver if it still fits
        (fresh headroom, scheduling requirements against the live labels) —
        the kube-scheduler step this store doesn't otherwise have. False
        routes the pod through the provisioner instead."""
        target = self.cluster.try_get_node(target_name)
        if target is None or not self._can_receive(target):
            return False
        catalog = {it.name: it for it in self.cloud.get_instance_types()}
        headroom = self._usable_capacity(target, catalog) - self._used(
            self.cluster.list_pods(node_name=target.name)
        )
        if (self._pod_vector(pod) > headroom + 1e-6).any():
            return False
        if not pod.scheduling_requirements().satisfied_by_labels(target.labels):
            return False
        if not taints_tolerate_pod(target.taints, pod.tolerations):
            return False  # e.g. another provisioner's tainted capacity
        try:
            self.cluster.bind_pod(pod, target)
        except Exception:  # noqa: BLE001 — pod vanished mid-bind: nothing to place
            return False
        return True

    def _feed(self, node: NodeSpec, pod: PodSpec) -> None:
        """Replacement capacity ahead of the drain: hand the displaced pod
        straight to the owning provisioner's batch window (the interruption
        drain's pattern) so a replace-action launch is in flight while the
        rest of the victim drains."""
        name = node.labels.get(wellknown.PROVISIONER_NAME_LABEL, "")
        worker = self.provisioning.worker(name)
        if worker is not None:
            worker.add(pod)
