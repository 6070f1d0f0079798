"""The constraint compiler: scheduling constraints as device tensors.

Lowers one schedule's pod affinity/anti-affinity, topology-spread constraints
(arbitrary node-label keys, not just hostname/zone), and the full
preference-relaxation ladder (constraints/ladder.py) into the per-level
tensors the [L, G, T] pack dispatch consumes
(ops/pack_kernel.pack_kernel_levels):

  * `allow[l, g, t]`    — feasibility over (level, sub-group, type);
  * `penalty[l, g, t]`  — additive ScheduleAnyway spread pressure;
  * `level_counts[l,g]` — per-level pods per sub-group (domain-expanded
                          spread groups carry per-level water-filled takes);
  * `conflict[g, h]`    — may-not-share-a-node pairs (hostname
                          anti-affinity; sub-groups pinned to different
                          domains of one topology key);
  * `node_cap[g]`       — per-node caps (hostname spread: cap = max_skew;
                          hostname self-anti-affinity: cap = 1).

The lowering rules, by constraint family:

topology spread (DoNotSchedule)
    Hostname keys need no domain axis — fresh nodes ARE the domains — so a
    hostname constraint lowers to ``node_cap = max_skew`` (the greedy pass
    fabricated ceil(n/maxSkew) buckets of maxSkew pods each; a per-node cap
    is the same partition without the pre-solve selector injection). Any
    other key spreads over *domains* discovered from live node labels, the
    requirement envelope, and provisioner labels: each base pod-group
    expands into one sub-group per domain, and each level's pod counts are
    the closed-form water-fill of the batch over that level's allowed
    domains seeded with existing matching pods — exactly the greedy
    sequence's totals (TopologyGroup.assign_many), computed once at compile
    time. Sub-groups of different domains conflict (a node has one value
    per topology key), which keeps every node single-domain so decode can
    pin its launch pools (zone keys) or stamp its labels (custom keys).

topology spread (ScheduleAnyway)
    A soft constraint: no expansion, no mask — an additive penalty on types
    whose offered domains are already crowded, folded into the cost-mode
    round score.

pod anti-affinity
    Hostname terms become conflict-matrix entries (and a self-match becomes
    ``node_cap = 1``): provisioning only ever binds onto freshly launched
    nodes, so in-batch exclusion is the whole problem. Zone/custom-key
    terms exclude the domains where matching pods already run.

pod affinity
    Zone/custom-key terms restrict a level's domains to those hosting
    matching pods; when none exist yet but the batch itself contains
    matching pods, the batch seeds the domain (unrestricted) — the
    reference rejects these pods outright, so this is strictly new
    workload coverage. Hostname affinity stays rejected at selection.

relaxation ladder
    Level l's requirement view (ladder.states[l]) filters the fleet per
    level: instance-type/arch/os/capacity-type envelopes become rows of
    ``allow``; zone envelopes intersect into per-(level, sub-group) allowed
    zone sets that both mask types and pin launch pools at decode.
    Custom-label compatibility is level-validated host-side
    (Scheduler._compiled_signature) and arrives as ``valid_levels``.

The compiled *envelope* (everything independent of the concrete pod batch:
per-level type masks, zone sets, spread domains and their seed counts) is
cached under a lock keyed by (ladder, spread/affinity config, fleet
fingerprint, cluster tag) so repeated sweeps over an unchanged cluster
recompile nothing — the tag is the PR 7 incremental encoder's
(epoch, generation) pair (DeviceClusterState.compile_tag), which moves on
every delta flush: O(churn) invalidation, and no tag at all (no caching)
while deltas are still pending, since the envelope reads the live store.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.pods import (
    DO_NOT_SCHEDULE,
    PodSpec,
    TopologySpreadConstraint,
)
from karpenter_tpu_torch.constraints.ladder import RelaxationLadder
from karpenter_tpu_torch.ops.encode import InstanceFleet, PodGroups
from karpenter_tpu_torch.ops.pack_kernel import NODE_CAP_NONE

# ScheduleAnyway spread pressure per pod per excess matching pod in the
# type's least-crowded offered domain, in $/hr units (the cost-mode score is
# $/weighted-work; the penalty must be small against real node prices so it
# breaks ties instead of overriding economics).
SOFT_SPREAD_PENALTY = 0.005


from karpenter_tpu_torch.constraints.terms import (  # noqa: E402 — shared helpers
    node_domain as _node_domain,
    selector_matches as _selector_matches,
    term_fingerprint,
    term_match_labels,
    term_topology_key,
)


@dataclass(frozen=True)
class SpreadDomains:
    """One domain-keyed topology constraint's discovered universe."""

    constraint: TopologySpreadConstraint
    domains: Tuple[str, ...]  # sorted
    seed_counts: Tuple[int, ...]  # existing matching pods per domain


@dataclass
class CompiledConstraints:
    """One schedule's constraints, lowered for the [L, G, T] dispatch."""

    ladder: RelaxationLadder
    valid_levels: List[bool]
    spread_key: Optional[str]  # the domain-expanded topology key, if any
    num_levels: int
    # Kernel tensors (host numpy; solve pads + uploads).
    vectors: np.ndarray  # [G', R] float32
    level_counts: np.ndarray  # [L, G'] int32
    allow: np.ndarray  # [L, G', T] bool
    penalty: np.ndarray  # [L, G', T] float32
    conflict: np.ndarray  # [G', G'] bool
    node_cap: np.ndarray  # [G'] int32
    # Decode metadata.
    sub_base: List[int]  # G' -> base group index
    sub_domain: List[Optional[str]]  # spread domain of each sub-group
    zone_sets: List[List[Optional[FrozenSet[str]]]]  # [L][G'] pool pinning
    members: List[List[List[PodSpec]]]  # [L][G'] pod lists per level
    epoch: Optional[int] = None

    @property
    def num_subgroups(self) -> int:
        return int(self.vectors.shape[0])


@dataclass(frozen=True)
class _Envelope:
    """The batch-independent compile product (cacheable): per-level type
    masks and zone sets plus the discovered spread domains."""

    type_mask: Tuple[Tuple[bool, ...], ...]  # [L][T]
    zone_sets: Tuple[Optional[FrozenSet[str]], ...]  # [L]
    spread: Optional[SpreadDomains]
    soft_spreads: Tuple[SpreadDomains, ...]
    # (Anti-)affinity lowers per topology key — a rack-keyed term must never
    # subtract rack values from a zone set. Zone-scoped terms restrict the
    # launch zones; spread-key-scoped terms restrict the expanded domains
    # (identical to the zone pair when the spread key IS the zone label).
    anti_excluded_zones: FrozenSet[str]
    affinity_zones: Optional[FrozenSet[str]]  # None = unrestricted
    spread_anti_excluded: FrozenSet[str]
    spread_affinity: Optional[FrozenSet[str]]  # None = unrestricted
    # Per-level allowed values of the expanded (non-zone) spread key — the
    # custom-key analogue of zone_sets. None = unrestricted at that level.
    spread_key_sets: Tuple[Optional[FrozenSet[str]], ...] = ()


class CompilerCache:
    """LRU of compiled envelopes, cluster-tag-tagged.

    Keyed by (schedule fingerprint, fleet fingerprint, cluster tag) where
    the tag is DeviceClusterState.compile_tag() — the (epoch, generation)
    pair that moves on every flushed watch delta, so pod/node churn
    naturally invalidates every entry: O(churn) bookkeeping, no scanning.
    Thread-safe: provisioning workers share one instance across sweeps."""

    MAX_ENTRIES = 128

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Tuple, _Envelope]" = OrderedDict()  # vet: guarded-by(self._lock)
        self.hits = 0  # vet: guarded-by(self._lock)
        self.misses = 0  # vet: guarded-by(self._lock)

    def get(self, key: Tuple) -> Optional[_Envelope]:
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
            return entry

    def put(self, key: Tuple, envelope: _Envelope) -> None:
        with self._lock:
            while len(self._entries) >= self.MAX_ENTRIES:
                self._entries.popitem(last=False)
            self._entries[key] = envelope

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


_shared_cache = CompilerCache()


def shared_cache() -> CompilerCache:
    return _shared_cache


def _fleet_fingerprint(fleet: InstanceFleet) -> Tuple:
    return (
        tuple(it.name for it in fleet.instance_types),
        fleet.capacity.tobytes(),
        tuple(fleet.allowed_zones),
        fleet.capacity_type,
    )


def _spread_fingerprint(rep: PodSpec) -> Tuple:
    return (
        tuple(c.group_key() for c in rep.topology_spread),
        term_fingerprint(rep.pod_affinity_terms),
        term_fingerprint(rep.pod_anti_affinity_terms),
    )


# --- domain discovery --------------------------------------------------------


def _domain_universe(key: str, allowed, constraints, fleet, cluster) -> set:
    """Candidate domain values for one topology key within the envelope."""
    domains = set()
    if key == wellknown.ZONE_LABEL:
        domains |= {z for z in (fleet.allowed_zones or []) if allowed.contains(z)}
        for it in fleet.instance_types:
            domains |= {z for z in it.zones() if allowed.contains(z)}
    if cluster is not None:
        for node in cluster.list_nodes():
            value = _node_domain(node, key)
            if value and allowed.contains(value):
                domains.add(value)
    finite = allowed.finite_values()
    if finite:
        domains |= set(finite)
    label_value = constraints.labels.get(key)
    if label_value and allowed.contains(label_value):
        domains.add(label_value)
    return domains


def _matching_pod_domains(cluster, key: str, matches) -> List[str]:
    """Domain value of every bound pod accepted by `matches` (one value per
    matching pod — callers count or set-ify as needed)."""
    values: List[str] = []
    if cluster is None:
        return values
    for pod in cluster.list_pods(
        predicate=lambda p: p.node_name is not None and matches(p.labels)
    ):
        node = cluster.try_get_node(pod.node_name)
        if node is None:
            continue
        value = _node_domain(node, key)
        if value:
            values.append(value)
    return values


def discover_domains(
    constraint: TopologySpreadConstraint,
    constraints,
    fleet: InstanceFleet,
    cluster,
    level_reqs=(),
) -> SpreadDomains:
    """The domain universe of one spread constraint: live node label values
    within the envelope, the envelope's own finite values, fleet zones (for
    the zone key), provisioner labels, and any finite values the ladder's
    level requirements name for the key (pod required/preferred terms) —
    the arbitrary-key generalization of Topology._compute_zonal. Empty =
    the constraint is ignored, matching the greedy pass's unknown-key
    behavior."""
    key = constraint.topology_key
    allowed = constraints.effective_requirements().allowed(key)
    universe = _domain_universe(key, allowed, constraints, fleet, cluster)
    for requirements in level_reqs:
        if requirements is None:
            continue
        finite = requirements.allowed(key).finite_values()
        if finite:
            universe |= {v for v in finite if allowed.contains(v)}
    ordered = tuple(sorted(universe))
    counts = [0] * len(ordered)
    index = {d: i for i, d in enumerate(ordered)}
    for value in _matching_pod_domains(cluster, key, constraint.matches):
        slot = index.get(value)
        if slot is not None:
            counts[slot] += 1
    return SpreadDomains(
        constraint=constraint, domains=ordered, seed_counts=tuple(counts)
    )


def water_fill_takes(seed_counts: Sequence[int], n: int) -> List[int]:
    """Per-domain takes of n sequential greedy argmin-count picks — the
    domain-total view of TopologyGroup.assign_many (same water level, same
    name-order tiebreak), shared so the compiled counts and the greedy
    fallback cannot drift."""
    if n <= 0 or not seed_counts:
        return [0] * len(seed_counts)
    counts = np.asarray(seed_counts, dtype=np.int64)
    lo, hi = int(counts.min()) + 1, int(counts.max()) + n
    while lo < hi:
        mid = (lo + hi) // 2
        if int(np.maximum(0, mid - counts).sum()) >= n:
            hi = mid
        else:
            lo = mid + 1
    level = lo
    full = np.maximum(0, (level - 1) - counts)
    remaining = n - int(full.sum())
    takes = full.copy()
    for i in range(len(counts)):
        if remaining == 0:
            break
        if counts[i] + full[i] == level - 1:
            takes[i] += 1
            remaining -= 1
    return [int(t) for t in takes]


# --- the compile -------------------------------------------------------------


def _level_type_mask(
    requirements, fleet: InstanceFleet, zone_set: Optional[FrozenSet[str]]
) -> List[bool]:
    """[T] — which fleet types satisfy one level's requirement view."""
    allowed_type = requirements.allowed(wellknown.INSTANCE_TYPE_LABEL)
    allowed_arch = requirements.allowed(wellknown.ARCH_LABEL)
    allowed_os = requirements.allowed(wellknown.OS_LABEL)
    allowed_cap = requirements.allowed(wellknown.CAPACITY_TYPE_LABEL)
    mask = []
    for it in fleet.instance_types:
        ok = (
            allowed_type.contains(it.name)
            and allowed_arch.contains(it.architecture)
            and any(allowed_os.contains(os) for os in it.operating_systems)
            and any(allowed_cap.contains(c) for c in it.capacity_types())
        )
        if ok and zone_set is not None:
            ok = any(z in zone_set for z in it.zones())
        mask.append(bool(ok))
    return mask


def _ladder_envelopes(schedule, rep: PodSpec, fleet: InstanceFleet):
    """Per-level (type mask, zone set, requirement view) from the ladder.
    Invalid levels carry None requirements and an all-False mask."""
    fleet_zones = set(fleet.allowed_zones or [])
    for it in fleet.instance_types:
        fleet_zones |= set(it.zones())
    zone_sets: List[Optional[FrozenSet[str]]] = []
    type_masks: List[Tuple[bool, ...]] = []
    level_reqs: List = []
    for level, state in enumerate(schedule.ladder.states):
        if not schedule.valid_levels[level]:
            zone_sets.append(frozenset())
            type_masks.append(tuple([False] * fleet.num_types))
            level_reqs.append(None)
            continue
        requirements = state.requirements(rep)
        level_reqs.append(requirements)
        allowed_zone = requirements.allowed(wellknown.ZONE_LABEL)
        if allowed_zone.is_any():
            zone_set: Optional[FrozenSet[str]] = None
        else:
            zone_set = frozenset(
                z for z in fleet_zones if allowed_zone.contains(z)
            )
        type_masks.append(tuple(_level_type_mask(requirements, fleet, zone_set)))
        zone_sets.append(zone_set)
    return type_masks, zone_sets, level_reqs


def _key_sets_per_level(key: str, level_reqs) -> Tuple[Optional[FrozenSet[str]], ...]:
    """[L] allowed values of one label key per ladder level (None = any;
    invalid levels get the empty set)."""
    sets: List[Optional[FrozenSet[str]]] = []
    for requirements in level_reqs:
        if requirements is None:
            sets.append(frozenset())
            continue
        allowed = requirements.allowed(key)
        finite = allowed.finite_values()
        sets.append(None if finite is None else frozenset(finite))
    return tuple(sets)


def _spread_discovery(rep: PodSpec, constraints, fleet, cluster, level_reqs=()):
    """(hard spread to expand, soft spreads): hostname keys lower to node
    caps (handled by _hostname_caps); the first hard domain-keyed
    constraint expands; ScheduleAnyway and later hard ones become soft
    penalties. The ladder's per-level requirement views contribute their
    finite values to the domain universe — pod-level required terms live in
    the ladder, not the schedule envelope."""
    spread: Optional[SpreadDomains] = None
    soft: List[SpreadDomains] = []
    for constraint in rep.topology_spread:
        if constraint.topology_key == wellknown.HOSTNAME_LABEL:
            continue
        discovered = discover_domains(
            constraint, constraints, fleet, cluster, level_reqs=level_reqs
        )
        if not discovered.domains:
            continue  # unknown key with no domains: ignored (greedy parity)
        if constraint.when_unsatisfiable == DO_NOT_SCHEDULE and spread is None:
            spread = discovered
        else:
            if constraint.when_unsatisfiable == DO_NOT_SCHEDULE:
                # Only ONE hard domain-keyed constraint gets the expansion
                # axis; further ones degrade to best-effort penalties (and
                # contribute nothing for non-zone keys). Loud, not silent:
                # a violated hard constraint must be traceable to this
                # demotion. (ROADMAP: constraint-compiler follow-ons.)
                from karpenter_tpu_torch.utils import logging as klog

                klog.named("constraints").warning(
                    "second hard spread constraint on %r demoted to "
                    "best-effort (one domain-expanded key per schedule)",
                    constraint.topology_key,
                )
            soft.append(discovered)
    return spread, soft


def _anti_affinity_exclusions(rep: PodSpec, cluster, key: str) -> FrozenSet[str]:
    """Domains of ONE topology key excluded by anti-affinity: wherever
    matching pods run. Key-scoped — a rack-keyed exclusion must never
    subtract rack values from a ZONE domain set (the value namespaces are
    unrelated, so cross-key mixing silently drops or nukes constraints)."""
    excluded: set = set()
    for term in rep.pod_anti_affinity_terms:
        if term_topology_key(term) != key:
            continue
        labels = term_match_labels(term)
        excluded.update(
            _matching_pod_domains(
                cluster, key, lambda pl, _l=labels: _selector_matches(_l, pl)
            )
        )
    return frozenset(excluded)


def _affinity_inclusions(
    rep: PodSpec, cluster, key: str
) -> Optional[FrozenSet[str]]:
    """Domains of ONE topology key required by affinity (∩ across that
    key's terms); None = unrestricted — including the batch-seeding case
    where no targets exist yet. Key-scoped for the same reason as
    _anti_affinity_exclusions."""
    affinity_domains: Optional[FrozenSet[str]] = None
    for term in rep.pod_affinity_terms:
        if term_topology_key(term) != key:
            continue
        labels = term_match_labels(term)
        found = frozenset(
            _matching_pod_domains(
                cluster, key, lambda pl, _l=labels: _selector_matches(_l, pl)
            )
        )
        if found:
            affinity_domains = (
                found if affinity_domains is None else affinity_domains & found
            )
        # else: batch-seeded — no restriction from this term.
    return affinity_domains


def _compile_envelope(
    schedule, rep: PodSpec, fleet: InstanceFleet, cluster
) -> _Envelope:
    type_masks, zone_sets, level_reqs = _ladder_envelopes(schedule, rep, fleet)
    spread, soft = _spread_discovery(
        rep, schedule.constraints, fleet, cluster, level_reqs=level_reqs
    )
    anti_zones = _anti_affinity_exclusions(rep, cluster, wellknown.ZONE_LABEL)
    affinity_zones = _affinity_inclusions(rep, cluster, wellknown.ZONE_LABEL)
    key_sets: Tuple[Optional[FrozenSet[str]], ...] = ()
    spread_anti, spread_affinity = anti_zones, affinity_zones
    if spread is not None and spread.constraint.topology_key != wellknown.ZONE_LABEL:
        key = spread.constraint.topology_key
        key_sets = _key_sets_per_level(key, level_reqs)
        spread_anti = _anti_affinity_exclusions(rep, cluster, key)
        spread_affinity = _affinity_inclusions(rep, cluster, key)
    return _Envelope(
        type_mask=tuple(type_masks),
        zone_sets=tuple(zone_sets),
        spread=spread,
        soft_spreads=tuple(soft),
        anti_excluded_zones=anti_zones,
        affinity_zones=affinity_zones,
        spread_anti_excluded=spread_anti,
        spread_affinity=spread_affinity,
        spread_key_sets=key_sets,
    )


def _hostname_caps(rep: PodSpec) -> int:
    """Per-node cap from hostname spread + hostname self-anti-affinity."""
    cap = NODE_CAP_NONE
    for constraint in rep.topology_spread:
        if (
            constraint.topology_key == wellknown.HOSTNAME_LABEL
            and constraint.when_unsatisfiable == DO_NOT_SCHEDULE
        ):
            cap = min(cap, max(int(constraint.max_skew), 1))
    for term in rep.pod_anti_affinity_terms:
        if term_topology_key(term) == wellknown.HOSTNAME_LABEL:
            if _selector_matches(term_match_labels(term), rep.labels):
                cap = 1
    return cap


def _soft_penalties(envelope: _Envelope, type_zones, num_types: int) -> np.ndarray:
    """[T] ScheduleAnyway spread pressure: per type, the crowding of its
    least-crowded offered zone relative to the global minimum."""
    soft_pen = np.zeros((num_types,), np.float32)
    for discovered in envelope.soft_spreads:
        if discovered.constraint.topology_key != wellknown.ZONE_LABEL:
            continue
        counts = dict(zip(discovered.domains, discovered.seed_counts))
        floor = min(counts.values()) if counts else 0
        for t, zones in enumerate(type_zones):
            offered = [counts[z] for z in zones if z in counts]
            if offered:
                soft_pen[t] += SOFT_SPREAD_PENALTY * (min(offered) - floor)
    return soft_pen


def _build_conflicts(
    rep: PodSpec, num_sub: int, sub_domain, spread: Optional[SpreadDomains]
) -> np.ndarray:
    """[G', G'] may-not-share-a-node pairs: sub-groups pinned to different
    domains of the expanded key (one label value per node), plus
    SELF-MATCHED hostname anti-affinity forbidding co-residence across
    groups (all schedule pods share labels when anti-affinity is in the
    signature, so the rep's self-match speaks for every member). A
    hostname term targeting OTHER labels is vacuous in-batch — its targets
    merge into different schedules, which launch different fresh nodes —
    and must not fragment this schedule's pack one-group-per-node."""
    conflict = np.zeros((num_sub, num_sub), bool)
    if spread is not None:
        for a in range(num_sub):
            for b in range(num_sub):
                if sub_domain[a] != sub_domain[b]:
                    conflict[a, b] = True
    if any(
        term_topology_key(t) == wellknown.HOSTNAME_LABEL
        and _selector_matches(term_match_labels(t), rep.labels)
        for t in rep.pod_anti_affinity_terms
    ):
        conflict |= ~np.eye(num_sub, dtype=bool)
    return conflict


@dataclass
class _LevelFiller:
    """Fills one level's slices of the compiled tensors (counts/allow/
    penalty) and produces that level's member splits + zone pins — the
    per-level lowering loop of compile_constraints, split by spread regime."""

    envelope: _Envelope
    groups: PodGroups
    spread: Optional[SpreadDomains]
    spread_is_zonal: bool
    type_zones: List[FrozenSet[str]]
    soft_pen: np.ndarray
    sub_base: List[int]
    sub_domain: List[Optional[str]]
    level_counts: np.ndarray
    allow: np.ndarray
    penalty: np.ndarray

    def fill(self, level: int):
        if self.spread is not None:
            return self._fill_spread(level)
        return self._fill_plain(level)

    def _zone_type_mask(self, zone: FrozenSet[str]) -> np.ndarray:
        return np.array([bool(tz & zone) for tz in self.type_zones], bool)

    def _zone_restriction(self, level: int) -> Optional[FrozenSet[str]]:
        """One level's zone-scoped restriction: ladder zone envelope ∩
        affinity inclusions − anti-affinity exclusions. None = any.
        Shared by the plain path and custom-key spread rounds — a rack
        spread's domain axis is not zones, so zone-keyed terms must still
        restrict its types and pin its pools."""
        zone = self.envelope.zone_sets[level]
        if self.envelope.affinity_zones is not None:
            zone = (
                self.envelope.affinity_zones
                if zone is None
                else zone & self.envelope.affinity_zones
            )
        if self.envelope.anti_excluded_zones:
            base = zone if zone is not None else frozenset(
                z for tz in self.type_zones for z in tz
            )
            zone = frozenset(base - self.envelope.anti_excluded_zones)
        return zone

    def _allowed_domains(self, level: int, level_zone) -> List[str]:
        """Domains this level admits: the ladder's envelope for the spread
        key (zone set for zone-keyed spreads, the level's finite key values
        for custom keys), minus anti-affinity exclusions, intersected with
        affinity inclusions."""
        key_sets = self.envelope.spread_key_sets
        key_set = key_sets[level] if key_sets else None
        allowed = []
        for d in self.spread.domains:
            if d in self.envelope.spread_anti_excluded:
                continue
            if self.spread_is_zonal:
                if level_zone is not None and d not in level_zone:
                    continue
            elif key_set is not None and d not in key_set:
                continue
            inclusions = self.envelope.spread_affinity
            if inclusions is not None and d not in inclusions:
                continue
            allowed.append(d)
        return allowed

    def _fill_spread(self, level: int):
        num_sub = len(self.sub_base)
        level_zone = self.envelope.zone_sets[level]
        type_mask = np.array(self.envelope.type_mask[level], bool)
        level_members: List[List[PodSpec]] = [[] for _ in range(num_sub)]
        level_zone_sets: List[Optional[FrozenSet[str]]] = [None] * num_sub
        allowed_domains = self._allowed_domains(level, level_zone)
        domain_index = {d: i for i, d in enumerate(self.spread.domains)}
        # Per base group, water-fill the group's pods over the allowed
        # domains — seeded with existing pods, carrying counts across groups
        # in FFD order so the whole schedule's totals match the greedy
        # sequence.
        running = {
            d: self.spread.seed_counts[domain_index[d]] for d in allowed_domains
        }
        for g in range(self.groups.num_groups):
            pod_list = self.groups.members[g]
            takes = water_fill_takes(
                [running[d] for d in allowed_domains], len(pod_list)
            )
            cursor = 0
            for di, d in enumerate(allowed_domains):
                sub = g * len(self.spread.domains) + domain_index[d]
                take = takes[di]
                self.level_counts[level, sub] = take
                level_members[sub] = pod_list[cursor : cursor + take]
                cursor += take
                running[d] += take
                if self.spread_is_zonal:
                    zone = frozenset([d])
                    if level_zone is not None:
                        zone = zone & level_zone
                    level_zone_sets[sub] = zone
        zone_restrict = None if self.spread_is_zonal else self._zone_restriction(level)
        for sub in range(num_sub):
            d = self.sub_domain[sub]
            if d not in allowed_domains:
                continue
            self.allow[level, sub] = type_mask
            if self.spread_is_zonal:
                zone = level_zone_sets[sub] or frozenset([d])
                self.allow[level, sub] &= self._zone_type_mask(zone)
            elif zone_restrict is not None:
                # Custom-key spread: the domain axis is not zones, so the
                # level's zone-scoped terms restrict types AND pin pools.
                self.allow[level, sub] &= self._zone_type_mask(zone_restrict)
                level_zone_sets[sub] = zone_restrict
            self.penalty[level, sub] = self.soft_pen
        return level_zone_sets, level_members

    def _fill_plain(self, level: int):
        num_sub = len(self.sub_base)
        type_mask = np.array(self.envelope.type_mask[level], bool)
        level_members: List[List[PodSpec]] = [[] for _ in range(num_sub)]
        zone = self._zone_restriction(level)
        for sub in range(num_sub):
            self.level_counts[level, sub] = int(
                self.groups.counts[self.sub_base[sub]]
            )
            level_members[sub] = self.groups.members[self.sub_base[sub]]
            self.allow[level, sub] = type_mask
            if zone is not None:
                self.allow[level, sub] &= self._zone_type_mask(zone)
            self.penalty[level, sub] = self.soft_pen
        return [zone] * num_sub, level_members


def compile_constraints(
    schedule,
    groups: PodGroups,
    fleet: InstanceFleet,
    cluster=None,
    cache: Optional[CompilerCache] = None,
    epoch: Optional[int] = None,
) -> CompiledConstraints:
    """Lower one schedule's constraints against a concrete fleet.

    `schedule` must carry `ladder`, `valid_levels`, and `constraints`
    (controllers/scheduling.Schedule on the compiled path). `epoch` is the
    incremental encoder's cluster tag (compile_tag's (epoch, generation)
    pair) when available; with both `cache` and `epoch` the
    batch-independent envelope is reused across sweeps."""
    rep = schedule.rep if getattr(schedule, "rep", None) is not None else schedule.pods[0]
    ladder: RelaxationLadder = schedule.ladder
    num_levels = ladder.num_levels
    num_types = fleet.num_types

    envelope: Optional[_Envelope] = None
    key: Optional[Tuple] = None
    if cache is not None and epoch is not None:
        key = (
            ladder.fingerprint(),
            tuple(schedule.valid_levels),
            _spread_fingerprint(rep),
            _fleet_fingerprint(fleet),
            # The envelope reads the schedule constraints too (domain
            # discovery consults provisioner labels + requirements): two
            # provisioners sharing a fleet — or one whose spec changed
            # without any pod/node churn — must not share entries.
            tuple(sorted(schedule.constraints.labels.items())),
            schedule.constraints.requirements.canonical_key(),
            epoch,
        )
        envelope = cache.get(key)
    if envelope is None:
        envelope = _compile_envelope(schedule, rep, fleet, cluster)
        if cache is not None and key is not None:
            cache.put(key, envelope)

    spread = envelope.spread
    node_cap_value = _hostname_caps(rep)

    # Sub-group expansion over the spread domains (if any).
    sub_base: List[int] = []
    sub_domain: List[Optional[str]] = []
    if spread is not None:
        for g in range(groups.num_groups):
            for domain in spread.domains:
                sub_base.append(g)
                sub_domain.append(domain)
    else:
        sub_base = list(range(groups.num_groups))
        sub_domain = [None] * groups.num_groups
    num_sub = len(sub_base)

    vectors = (
        groups.vectors[sub_base]
        if num_sub
        else np.zeros((0, groups.vectors.shape[1]), np.float32)
    )
    level_counts = np.zeros((num_levels, num_sub), np.int32)
    allow = np.zeros((num_levels, num_sub, num_types), bool)
    penalty = np.zeros((num_levels, num_sub, num_types), np.float32)
    zone_sets: List[List[Optional[FrozenSet[str]]]] = []
    members: List[List[List[PodSpec]]] = []

    spread_is_zonal = (
        spread is not None
        and spread.constraint.topology_key == wellknown.ZONE_LABEL
    )
    type_zones = [frozenset(it.zones()) for it in fleet.instance_types]
    soft_pen = _soft_penalties(envelope, type_zones, num_types)

    filler = _LevelFiller(
        envelope=envelope,
        groups=groups,
        spread=spread,
        spread_is_zonal=spread_is_zonal,
        type_zones=type_zones,
        soft_pen=soft_pen,
        sub_base=sub_base,
        sub_domain=sub_domain,
        level_counts=level_counts,
        allow=allow,
        penalty=penalty,
    )
    for level in range(num_levels):
        level_zone_sets, level_members = filler.fill(level)
        zone_sets.append(level_zone_sets)
        members.append(level_members)

    conflict = _build_conflicts(rep, num_sub, sub_domain, spread)
    node_cap = np.full((num_sub,), node_cap_value, np.int32)
    return CompiledConstraints(
        ladder=ladder,
        valid_levels=list(schedule.valid_levels),
        spread_key=spread.constraint.topology_key if spread else None,
        num_levels=num_levels,
        vectors=vectors.astype(np.float32),
        level_counts=level_counts,
        allow=allow,
        penalty=penalty,
        conflict=conflict,
        node_cap=node_cap,
        sub_base=sub_base,
        sub_domain=sub_domain,
        zone_sets=zone_sets,
        members=members,
        epoch=epoch,
    )
