"""Scheduler: split a pod batch into groups of isomorphic constraints.

Ref: pkg/controllers/provisioning/scheduling/{scheduler,topology,
topologygroup}.go. The output Schedules feed the solver one at a time — all
pods in a Schedule are satisfiable by the same tightened constraint set, which
is what lets the solver treat them as one dense tensor problem.

Two topology regimes:

* **Compiled (default).** Topology-spread, pod (anti-)affinity, and the
  preference-relaxation ladder are NOT resolved here: the schedule carries
  its relaxation ladder (constraints/ladder.py) and the constraint compiler
  lowers everything into the [L, G, T] kernel dispatch at solve time
  (constraints/compiler.py). Spread pods that the greedy pre-pass used to
  split into one-schedule-per-zone stay in ONE schedule, so one dispatch
  co-optimizes spread against cost instead of serializing per domain.

* **Greedy (KARPENTER_GREEDY_TOPOLOGY=1 / Scheduler(greedy_topology=True)).**
  The legacy host-side pre-pass, kept as the parity oracle: topology-spread
  decisions are injected as node selectors ahead of the solve
  (Topology.inject, ref topology.go:40-140), now generalized to arbitrary
  topology keys and max_skew > 1 so the oracle covers everything the
  compiled path does (minus anti-affinity, which the pre-pass cannot
  express).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.pods import PodSpec, TopologySpreadConstraint
from karpenter_tpu_torch.api.provisioner import Constraints, PodIncompatibleError, Provisioner
from karpenter_tpu_torch.constraints.ladder import LadderState, RelaxationLadder, build_ladder
from karpenter_tpu_torch.constraints.terms import node_domain, term_fingerprint
from karpenter_tpu_torch.controllers.cluster import Cluster

# Legacy constant (the greedy pre-pass once rejected everything else); the
# compiled path and the generalized greedy fallback both take arbitrary
# node-label keys now, so this only names the keys with special lowering
# (hostname: fabricated domains / per-node caps).
SUPPORTED_TOPOLOGY_KEYS = (wellknown.HOSTNAME_LABEL, wellknown.ZONE_LABEL)

_domain_counter = itertools.count(1)


@dataclass
class Schedule:
    """Pods satisfiable by one tightened constraint set
    (ref: scheduler.go:54-58). On the compiled path a schedule additionally
    carries its relaxation ladder: `needs_compiler` schedules route through
    constraints/solve.solve_constrained (one [L, G, T] dispatch) instead of
    the plain solver boundary."""

    constraints: Constraints
    pods: List[PodSpec] = field(default_factory=list)
    ladder: Optional[RelaxationLadder] = None
    valid_levels: Optional[List[bool]] = None
    needs_compiler: bool = False
    # The constraint representative: the scheduler-local shadow whose
    # selector/spread/affinity state the compiler should read (on the
    # greedy-topology path the shadow carries injected selectors and has
    # its spread constraints cleared — inject already resolved them).
    # None = read pods[0].
    rep: Optional[PodSpec] = None


class TopologyGroup:
    """Greedy spread counter (ref: topologygroup.go:24-68)."""

    def __init__(self, constraint: TopologySpreadConstraint):
        self.constraint = constraint
        self.counts: Dict[str, int] = {}

    def register(self, *domains: str) -> None:
        for domain in domains:
            self.counts.setdefault(domain, 0)

    def increment(self, domain: str) -> None:
        if domain in self.counts:
            self.counts[domain] += 1

    def next_domain(self, allowed: Optional[Sequence[str]] = None) -> Optional[str]:
        """argmin-count domain within the pod's reachable set (mutating:
        increments the winner).

        Skew is measured against the floor of the REACHABLE domains — a
        pod whose selector excludes a domain cannot be asked to balance
        against it — and in that frame the argmin sequence never stretches
        skew beyond 1, so any max_skew >= 1 is honored without an explicit
        guard (a pod pinned to one over-full domain still lands there,
        exactly as the compiled water-fill fills a one-domain allowed set:
        constraints/compiler.water_fill_takes shares this frame, which is
        what keeps the two paths in placement parity). max_skew > 1 on the
        hostname key is realized upstream by bucket fabrication
        (_compute_hostname: ceil(n/max_skew) domains)."""
        candidates = [
            d for d in self.counts if allowed is None or d in allowed
        ]
        if not candidates:
            return None
        winner = min(candidates, key=lambda d: (self.counts[d], d))
        self.counts[winner] += 1
        return winner

    def assign_many(self, n: int) -> List[str]:
        """n sequential next_domain() picks, computed in closed form.

        The greedy loop is O(n x domains) Python — a real cost when a 50k-pod
        deployment carries one spread constraint. Observation: assigning a
        pod to domain d for the (j+1)-th time happens at "level" counts[d]+j,
        and greedy always takes the globally smallest (level, name); so the
        whole sequence is the first n slots of {(counts[d]+j, d)} in
        (level, name) order — water-filling + one lexsort, bit-identical to
        the sequential walk (the tensor-style reformulation of
        topologygroup.go:54-68's mutating argmin)."""
        if n <= 0 or not self.counts:
            return []
        names = sorted(self.counts)
        counts = np.array([self.counts[d] for d in names], dtype=np.int64)
        # Smallest water level L with sum(max(0, L - c_d)) >= n.
        lo, hi = int(counts.min()) + 1, int(counts.max()) + n
        while lo < hi:
            mid = (lo + hi) // 2
            if int(np.maximum(0, mid - counts).sum()) >= n:
                hi = mid
            else:
                lo = mid + 1
        level = lo
        full = np.maximum(0, (level - 1) - counts)  # slots strictly below L-1
        remaining = n - int(full.sum())
        takes = full.copy()
        # The last `remaining` picks happen at level L-1, in name order among
        # domains that have a slot there.
        for i in range(len(names)):
            if remaining == 0:
                break
            if counts[i] + full[i] == level - 1:  # next untaken slot is L-1
                takes[i] += 1
                remaining -= 1
        # Per-pod sequence: lexsort the taken slots by (level, name rank).
        domain_idx = np.repeat(np.arange(len(names)), takes)
        levels = np.concatenate(
            [np.arange(counts[i], counts[i] + takes[i]) for i in range(len(names))]
        )
        order = np.lexsort((domain_idx, levels))
        sequence = [names[i] for i in domain_idx[order]]
        for i, name in enumerate(names):
            self.counts[name] += int(takes[i])
        return sequence


class Topology:
    """Injects topology-spread decisions as node selectors
    (ref: topology.go:40-140) — the greedy fallback behind
    KARPENTER_GREEDY_TOPOLOGY, kept as the compiled path's parity oracle.
    Handles arbitrary topology keys: hostname fabricates fresh domains;
    every other key spreads over label values discovered from live nodes,
    the requirement envelope, and provisioner labels (matching the
    compiler's discover_domains)."""

    def __init__(self, cluster: Cluster):
        self.cluster = cluster

    def inject(self, constraints: Constraints, pods: Sequence[PodSpec]) -> None:
        for group_key, group_pods in self._topology_groups(pods).items():
            constraint = group_pods[0][0]
            group = TopologyGroup(constraint)
            members = [pod for _, pod in group_pods]
            if constraint.topology_key == wellknown.HOSTNAME_LABEL:
                self._compute_hostname(group, members)
            else:
                self._compute_labeled(group, constraints, members)
            allowed_per_pod = [
                self._allowed_domains_for_pod(pod, group) for pod in members
            ]
            if group.counts and all(a is None for a in allowed_per_pod):
                # Homogeneous fast path: no pod restricts its domains, so the
                # whole group's greedy sequence computes in closed form.
                for pod, domain in zip(members, group.assign_many(len(members))):
                    pod.node_selector[constraint.topology_key] = domain
                continue
            for pod, allowed in zip(members, allowed_per_pod):
                domain = group.next_domain(allowed)
                if domain is not None:
                    pod.node_selector[constraint.topology_key] = domain

    def _topology_groups(self, pods: Sequence[PodSpec]):
        """Group (constraint, pod) pairs by equivalent spread constraint
        (ref: topology.go:57-75). Arbitrary keys pass through: a key with no
        discoverable domains simply registers nothing and injects nothing."""
        groups: Dict[Tuple, List[Tuple[TopologySpreadConstraint, PodSpec]]] = {}
        for pod in pods:
            for constraint in pod.topology_spread:
                groups.setdefault(constraint.group_key(), []).append(
                    (constraint, pod)
                )
        return groups

    def _compute_hostname(self, group: TopologyGroup, pods: List[PodSpec]) -> None:
        """Fabricate ceil(pods/maxSkew) fresh hostname domains
        (ref: topology.go:95-105 — hostname domains don't exist until nodes
        launch, so the scheduler invents distinct buckets)."""
        num_domains = -(-len(pods) // max(group.constraint.max_skew, 1))
        for _ in range(num_domains):
            group.register(f"host-domain-{next(_domain_counter)}")

    def _compute_labeled(
        self, group: TopologyGroup, constraints: Constraints, pods: List[PodSpec]
    ) -> None:
        """Register allowed domains for an arbitrary label key and count
        existing matching pods per domain from live cluster state — the
        arbitrary-key generalization of the reference's zonal pass
        (ref: topology.go:112-140; zone stays a special case only in where
        a node's value is read from)."""
        key = group.constraint.topology_key
        allowed = constraints.effective_requirements().allowed(key)
        domains = set()
        for node in self.cluster.list_nodes():
            value = self._node_domain(node, key)
            if value and allowed.contains(value):
                domains.add(value)
        # Domains can also come from the constraint envelope (or provisioner
        # labels) even before any node exists there.
        finite = allowed.finite_values()
        if finite:
            domains |= set(finite)
        label_value = constraints.labels.get(key)
        if label_value and allowed.contains(label_value):
            domains.add(label_value)
        group.register(*sorted(domains))
        for pod in self.cluster.list_pods(
            predicate=lambda p: p.node_name is not None
            and group.constraint.matches(p.labels)
        ):
            node = self.cluster.try_get_node(pod.node_name)
            if node is None:
                continue
            value = self._node_domain(node, key)
            if value:
                group.increment(value)

    # THE zone-vs-label fallback rule, shared with the compiler's domain
    # discovery (constraints/terms.node_domain) so the greedy oracle and
    # the compiled path can never diverge on a node's domain.
    _node_domain = staticmethod(node_domain)

    def _allowed_domains_for_pod(self, pod: PodSpec, group: TopologyGroup):
        """A pod with its own zone/hostname selector restricts its domains."""
        key = group.constraint.topology_key
        selected = pod.node_selector.get(key)
        if selected is not None:
            return [selected]
        allowed = pod.scheduling_requirements().allowed(key)
        if allowed.is_any():
            return None
        return [d for d in group.counts if allowed.contains(d)]


class Scheduler:
    """Ref: scheduling/scheduler.go:67-126."""

    def __init__(self, cluster: Cluster, greedy_topology: Optional[bool] = None):
        self.cluster = cluster
        self.topology = Topology(cluster)
        if greedy_topology is None:
            from karpenter_tpu_torch.constraints import greedy_topology_enabled

            greedy_topology = greedy_topology_enabled()
        self.greedy_topology = greedy_topology

    def solve(
        self, provisioner: Provisioner, pods: Sequence[PodSpec]
    ) -> List[Schedule]:
        constraints = provisioner.spec.constraints
        # Topology decisions (when the greedy oracle is active) are injected
        # into per-pass SHADOW copies, never the live pod: a fabricated
        # zone/hostname selector must not survive a failed launch, or
        # retries stay pinned to a blacked-out domain (the reference works
        # on scheduler-local pod copies too).
        work = [(pod, self._scheduling_copy(pod)) for pod in pods]
        if self.greedy_topology:
            # The parity oracle: spread resolves host-side ahead of the
            # solve, exactly like the reference's topology.go pre-pass. The
            # shadows then drop their spread constraints — inject already
            # turned them into selectors — while the relaxation ladder and
            # (rejected-at-selection) affinity still compile as usual.
            self.topology.inject(constraints, [shadow for _, shadow in work])
            for _, shadow in work:
                shadow.topology_spread = []
        return self._solve_compiled(constraints, work)

    # --- compiled path (default): constraints lower at solve time ----------

    @staticmethod
    def _compiled_signature(pod: PodSpec) -> Tuple:
        """Constraint-relevant identity of a pod: pods sharing it share one
        evaluation AND one schedule's ladder/spread/affinity config (the
        compiler reads a representative pod)."""
        return (
            tuple(
                (t.key, t.operator, t.value, t.effect) for t in pod.tolerations
            ),
            tuple(sorted(pod.node_selector.items())),
            tuple(
                (
                    term.weight,
                    tuple((r.key, r.operator, r.values) for r in term.requirements),
                )
                for term in pod.preferred_terms
            ),
            tuple(
                tuple((r.key, r.operator, r.values) for r in term)
                for term in pod.required_terms
            ),
            tuple(c.group_key() for c in pod.topology_spread),
            term_fingerprint(pod.pod_affinity_terms),
            term_fingerprint(pod.pod_anti_affinity_terms),
            # Labels join the signature ONLY when spread/affinity is in
            # play: the compiler reads the representative pod's labels
            # (hostname anti-affinity self-match, spread selector
            # membership), so label-divergent pods must not share a rep —
            # while plain pods keep merging regardless of labels.
            tuple(sorted(pod.labels.items()))
            if (
                pod.topology_spread
                or pod.pod_affinity_terms
                or pod.pod_anti_affinity_terms
            )
            else (),
        )

    @staticmethod
    def _level_shadow(pod: PodSpec, state: LadderState) -> PodSpec:
        import copy as _copy

        shadow = _copy.copy(pod)
        shadow.node_selector = dict(pod.node_selector)
        shadow.preferred_terms = list(state.preferred)
        shadow.required_terms = [list(term) for term in state.required]
        return shadow

    def _evaluate_compiled(self, constraints: Constraints, shadow: PodSpec):
        """One signature's evaluation over its shadow: (tightened, merge
        key, ladder, valid_levels, needs_compiler) or None when no
        relaxation level is compatible (the pod is skipped, as the legacy
        path skipped level-0-incompatible pods)."""
        ladder = build_ladder(shadow)
        needs = (
            ladder.num_levels > 1
            or bool(shadow.topology_spread)
            or bool(shadow.pod_affinity_terms)
            or bool(shadow.pod_anti_affinity_terms)
        )
        if not needs:
            # Plain pod: the legacy one-shot evaluation, bit-identical.
            try:
                constraints.validate_pod(shadow)
            except PodIncompatibleError:
                return None
            tightened = constraints.tighten(shadow)
            return (
                tightened,
                tightened.requirements.canonical_key(),
                None,
                None,
                False,
            )
        valid_levels = []
        for state in ladder.states:
            try:
                constraints.validate_pod(self._level_shadow(shadow, state))
                valid_levels.append(True)
            except PodIncompatibleError:
                valid_levels.append(False)
        if not any(valid_levels):
            return None
        # The schedule envelope is the WIDEST one — provisioner constraints
        # plus the pod's own selector, with no ladder terms: every level's
        # candidate types must survive the fleet filter, and each level's
        # mask narrows within it (constraints/compiler.py).
        base = self._scheduling_copy(shadow)
        base.preferred_terms = []
        base.required_terms = []
        tightened = constraints.tighten(base)
        return (
            tightened,
            tightened.requirements.canonical_key(),
            ladder,
            valid_levels,
            True,
        )

    def _solve_compiled(
        self, constraints: Constraints, work: Sequence[Tuple[PodSpec, PodSpec]]
    ) -> List[Schedule]:
        evaluated: Dict[Tuple, object] = {}
        _INCOMPATIBLE = object()
        schedules: Dict[Tuple, Schedule] = {}
        ordered: List[Schedule] = []
        for pod, shadow in work:
            signature = self._compiled_signature(shadow)
            entry = evaluated.get(signature)
            if entry is None:
                entry = (
                    self._evaluate_compiled(constraints, shadow) or _INCOMPATIBLE
                )
                evaluated[signature] = entry
            if entry is _INCOMPATIBLE:
                continue
            tightened, canonical, ladder, valid_levels, needs = entry
            accelerators = frozenset(
                name
                for name in wellknown.ACCELERATOR_RESOURCES
                if pod.requests.get(name, 0) > 0
            )
            # Compiled schedules merge by full signature (the compiler reads
            # a representative shadow, so members must be homogeneous);
            # plain schedules keep the legacy canonical-requirements merge.
            key = (signature, accelerators) if needs else (canonical, accelerators)
            schedule = schedules.get(key)
            if schedule is None:
                schedule = Schedule(
                    constraints=tightened,
                    ladder=ladder,
                    valid_levels=valid_levels,
                    needs_compiler=needs,
                    rep=shadow,
                )
                schedules[key] = schedule
                ordered.append(schedule)
            schedule.pods.append(pod)
        return ordered

    @staticmethod
    def _scheduling_copy(pod: PodSpec) -> PodSpec:
        import copy as _copy

        shadow = _copy.copy(pod)
        shadow.node_selector = dict(pod.node_selector)
        return shadow
