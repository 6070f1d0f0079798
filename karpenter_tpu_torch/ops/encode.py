"""Densify pod / instance-type specs into the arrays every kernel consumes.

The tensor layout (karpenter_tpu.api.wellknown.RESOURCE_DIMS) uses millicores
and MiB so float32 stays exact across realistic magnitudes (float32 integers
are exact to 2^24: 16M millicores / 16 TiB in MiB).

Pods with identical request vectors are collapsed into *groups*: real batches
contain a handful of distinct shapes (deployments replicate pods), so the
solver works on [G] groups instead of [P] pods — the same trick that makes the
greedy baseline O(nodes×types×G) instead of the reference's
O(nodes×types×P) inner loop (ref: binpacking/packable.go:113-132).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.pods import PodSpec
from karpenter_tpu_torch.api.provisioner import Constraints
from karpenter_tpu_torch.cloudprovider import InstanceType


# Content-keyed memo for resource_vector: pod batches repeat a handful of
# request shapes thousands of times (a 50k-pod batch has ~16 distinct
# shapes), so the dict→vector conversion runs once per distinct content
# instead of once per pod. Entries are read-only so sharing is safe; the
# bound guards a long-running controller against unbounded distinct shapes.
_VEC_MEMO: Dict[Tuple, np.ndarray] = {}
_VEC_MEMO_MAX = 65536


def resource_vector(resources: Mapping[str, float]) -> np.ndarray:
    """ResourceList -> dense [R] float32 vector in kernel units.

    Returns a cached READ-ONLY array shared across calls with equal content —
    copy before mutating."""
    key = tuple(sorted(resources.items()))
    vec = _VEC_MEMO.get(key)
    if vec is not None:
        return vec
    vec = np.zeros(wellknown.NUM_RESOURCE_DIMS, dtype=np.float32)
    for name, value in resources.items():
        index = wellknown.RESOURCE_DIM_INDEX.get(name)
        if index is None:
            continue  # ephemeral-storage etc. — not packed dimensions
        if name == wellknown.RESOURCE_CPU:
            value = value * wellknown.CPU_SCALE
        elif name == wellknown.RESOURCE_MEMORY:
            value = value * wellknown.MEMORY_SCALE
        vec[index] = value
    vec.flags.writeable = False
    if len(_VEC_MEMO) >= _VEC_MEMO_MAX:
        _VEC_MEMO.clear()
    _VEC_MEMO[key] = vec
    return vec


@dataclass
class PodGroups:
    """Pods collapsed by identical request vector, sorted FFD-style
    (desc cpu, then desc memory — ref: binpacking/packer.go:96-104,
    with the remaining dims as deterministic tiebreak)."""

    vectors: np.ndarray  # [G, R] float32
    counts: np.ndarray  # [G] int32
    members: List[List[PodSpec]]  # pods per group, original objects

    @property
    def num_groups(self) -> int:
        return int(self.vectors.shape[0])

    @property
    def num_pods(self) -> int:
        return int(self.counts.sum())


_CPU_INDEX = wellknown.RESOURCE_DIM_INDEX[wellknown.RESOURCE_CPU]
_MEM_INDEX = wellknown.RESOURCE_DIM_INDEX[wellknown.RESOURCE_MEMORY]


def group_sort_key(vector: np.ndarray):
    """THE FFD group ordering (desc cpu, then desc memory, then the full
    vector for determinism) — shared by group_pods and the incremental
    encoder's sorted view (models/cluster_state.py) so the two paths produce
    bit-identical group tensors."""
    return (
        -vector[_CPU_INDEX],
        -vector[_MEM_INDEX],
        tuple(-x for x in vector.tolist()),
    )


def group_pods(pods: Sequence[PodSpec]) -> PodGroups:
    # One dict holding (vector, members) per distinct request shape: this
    # loop runs once per pod of a 50k batch, so it carries exactly one dict
    # probe and one append per pod.
    groups: Dict[bytes, Tuple[np.ndarray, List[PodSpec]]] = {}
    lookup = groups.get
    for pod in pods:
        # The cache is populated at PodSpec construction
        # (api/pods._dense_request_cache — one definition of the format);
        # the fallback covers only detached copies built without __post_init__.
        cached = pod.dense_vector
        if cached is None:  # pragma: no cover — defensive
            from karpenter_tpu_torch.api.pods import _dense_request_cache

            pod.dense_vector = cached = _dense_request_cache(pod.requests)
        entry = lookup(cached[1])
        if entry is None:
            groups[cached[1]] = (cached[0], [pod])
        else:
            entry[1].append(pod)
    # Desc by cpu, then memory, then the full vector for determinism
    # (group_sort_key — shared with the incremental encoder).
    entries = sorted(
        groups.values(), key=lambda entry: group_sort_key(entry[0])
    )
    return PodGroups(
        vectors=np.stack([vec for vec, _ in entries])
        if entries
        else np.zeros((0, wellknown.NUM_RESOURCE_DIMS), np.float32),
        counts=np.array([len(members) for _, members in entries], dtype=np.int32),
        members=[members for _, members in entries],
    )


@dataclass
class InstanceFleet:
    """Candidate instance types densified for the kernels, already filtered to
    the constraint envelope and sorted ascending (ref: packable.go:76-91)."""

    instance_types: List[InstanceType]
    capacity: np.ndarray  # [T, R] usable capacity (total - overhead - daemons)
    total: np.ndarray  # [T, R] raw capacity (node allocatable before daemons)
    prices: np.ndarray  # [T] cheapest feasible offering $/hr
    # Launch envelope implied by the schedule's constraints: the zones pools
    # may come from (empty = unconstrained) and the capacity type a launch
    # would use (ref: instance.go getCapacityType:281-292).
    allowed_zones: List[str] = field(default_factory=list)
    capacity_type: str = wellknown.CAPACITY_TYPE_ON_DEMAND

    @property
    def num_types(self) -> int:
        return len(self.instance_types)


_ACCEL_INDEXES = [
    wellknown.RESOURCE_DIM_INDEX[r]
    for r in wellknown.ACCELERATOR_RESOURCES
    if r in wellknown.RESOURCE_DIM_INDEX
]
_POD_ENI_INDEX = wellknown.RESOURCE_DIM_INDEX[wellknown.RESOURCE_AWS_POD_ENI]


def _passes_constraint_filters(
    instance_type: InstanceType, constraints: Constraints
) -> bool:
    """Zone/type/arch/OS/capacity-type envelope filters
    (ref: packable.go:177-218)."""
    requirements = constraints.effective_requirements()
    checks = [
        (wellknown.INSTANCE_TYPE_LABEL, {instance_type.name}),
        (wellknown.ARCH_LABEL, {instance_type.architecture}),
        (wellknown.OS_LABEL, set(instance_type.operating_systems)),
        (wellknown.ZONE_LABEL, set(instance_type.zones())),
        (wellknown.CAPACITY_TYPE_LABEL, set(instance_type.capacity_types())),
    ]
    for key, offered in checks:
        allowed = requirements.allowed(key)
        if not any(allowed.contains(value) for value in offered):
            return False
    return True


def _passes_accelerator_filters(
    capacity_vec: np.ndarray, pods_need: np.ndarray
) -> bool:
    """Accelerators must match demand in both directions: required -> present,
    absent demand -> absent hardware (anti-waste; ref: packable.go:220-248).
    Pod-ENI is one-directional: only required -> present (ref: :250-262)."""
    for index in _ACCEL_INDEXES:
        if pods_need[index] > 0 and capacity_vec[index] == 0:
            return False
        if pods_need[index] == 0 and capacity_vec[index] > 0:
            return False
    if pods_need[_POD_ENI_INDEX] > 0 and capacity_vec[_POD_ENI_INDEX] == 0:
        return False
    return True


def _slow_kept(
    instance_types: Sequence[InstanceType],
    constraints: Constraints,
    pods_need: np.ndarray,
    daemon_groups: PodGroups,
    allowed_zones,
    allowed_capacity,
) -> List[Tuple[InstanceType, np.ndarray, np.ndarray, float]]:
    """Per-type walk for constrained envelopes / daemon overhead — the
    general path (_fast_kept handles the unconstrained hot shape)."""
    kept: List[Tuple[InstanceType, np.ndarray, np.ndarray, float]] = []
    for instance_type in instance_types:
        if not _passes_constraint_filters(instance_type, constraints):
            continue
        total = resource_vector(instance_type.capacity)
        if not _passes_accelerator_filters(total, pods_need):
            continue
        usable = total - resource_vector(instance_type.overhead)
        if (usable < 0).any():
            continue  # overhead exceeds capacity (ref: packable.go:64-68)
        usable = _greedy_fill(usable, daemon_groups)
        if usable is None:
            continue  # daemons don't fit (ref: packable.go:69-73)
        price = instance_type.min_price(
            zones=[z for z in instance_type.zones() if allowed_zones.contains(z)],
            capacity_types=[
                c for c in instance_type.capacity_types() if allowed_capacity.contains(c)
            ],
        )
        kept.append((instance_type, usable, total, price))
    return kept


def _greedy_fill(remaining: np.ndarray, groups: PodGroups) -> Optional[np.ndarray]:
    """Pack daemons-style: every pod of every group must fit, else None."""
    remaining = remaining.copy()
    for g in range(groups.num_groups):
        need = groups.vectors[g] * groups.counts[g]
        remaining -= need
        if (remaining < 0).any():
            return None
    return remaining


_ENVELOPE_KEYS = (
    wellknown.INSTANCE_TYPE_LABEL,
    wellknown.ARCH_LABEL,
    wellknown.OS_LABEL,
    wellknown.ZONE_LABEL,
    wellknown.CAPACITY_TYPE_LABEL,
)


def _fast_kept(
    instance_types: Sequence[InstanceType], pods_need: np.ndarray
) -> List[Tuple[InstanceType, np.ndarray, np.ndarray, float]]:
    """Vectorized filter for the hot shape — unconstrained envelope, no
    daemons: the accelerator anti-waste and overhead checks collapse to
    [T, R] array masks, and every type's price is its unrestricted
    cheapest offering. Bit-identical kept set to the per-type walk."""
    if not instance_types:
        return []
    total = np.stack([resource_vector(it.capacity) for it in instance_types])
    usable = total - np.stack(
        [resource_vector(it.overhead) for it in instance_types]
    )
    mask = (usable >= 0).all(axis=1)
    # Offering-less types are unlaunchable (no zone/capacity-type to match);
    # the per-type walk drops them because any() over an empty offered set
    # is False even under an unconstrained envelope.
    mask &= np.array([bool(it.offerings) for it in instance_types])
    for index in _ACCEL_INDEXES:
        if pods_need[index] > 0:
            mask &= total[:, index] > 0
        else:
            mask &= total[:, index] == 0
    if pods_need[_POD_ENI_INDEX] > 0:
        mask &= total[:, _POD_ENI_INDEX] > 0
    return [
        (instance_types[i], usable[i], total[i], instance_types[i].min_price())
        for i in np.nonzero(mask)[0]
    ]


def build_fleet(
    instance_types: Sequence[InstanceType],
    constraints: Constraints,
    pods: Sequence[PodSpec],
    daemons: Sequence[PodSpec] = (),
    pods_need: Optional[np.ndarray] = None,
) -> InstanceFleet:
    """Filter + densify instance types for one schedule's constraints
    (ref: PackablesFor packable.go:45-93): constraint envelope filters,
    accelerator anti-waste, kubelet overhead reservation, daemonset overhead
    packing, then ascending sort by (accelerators, cpu, memory).

    pods_need is the [R] elementwise max of the pods' request vectors; pass
    it when the caller already grouped the pods (Solver.solve does) so the
    50k-pod batch isn't re-walked here."""
    if pods_need is None:
        pods_need = (
            np.max([resource_vector(p.requests) for p in pods], axis=0)
            if pods
            else np.zeros(wellknown.NUM_RESOURCE_DIMS, np.float32)
        )
    daemon_groups = group_pods(list(daemons))

    requirements = constraints.effective_requirements()
    allowed_zones = requirements.allowed(wellknown.ZONE_LABEL)
    allowed_capacity = requirements.allowed(wellknown.CAPACITY_TYPE_LABEL)

    unconstrained = daemon_groups.num_groups == 0 and all(
        requirements.allowed(key).is_any() for key in _ENVELOPE_KEYS
    )
    if unconstrained:
        kept = _fast_kept(instance_types, pods_need)
    else:
        kept = _slow_kept(
            instance_types, constraints, pods_need, daemon_groups,
            allowed_zones, allowed_capacity,
        )

    cpu = wellknown.RESOURCE_DIM_INDEX[wellknown.RESOURCE_CPU]
    mem = wellknown.RESOURCE_DIM_INDEX[wellknown.RESOURCE_MEMORY]
    kept.sort(
        key=lambda item: (
            tuple(item[2][i] for i in _ACCEL_INDEXES),
            item[2][cpu],
            item[2][mem],
        )
    )
    # Launch envelope: the offered zones that survive the constraint set
    # (offered zones are finite, so NotIn/complement requirements filter
    # correctly — finite_values() alone would drop them), and spot iff
    # allowed and offered by any kept type (ref: instance.go:281-292).
    zone_values = sorted(
        {
            zone
            for item in kept
            for zone in item[0].zones()
            if allowed_zones.contains(zone)
        }
    )
    capacity_type = wellknown.CAPACITY_TYPE_ON_DEMAND
    if allowed_capacity.contains(wellknown.CAPACITY_TYPE_SPOT):
        for item in kept:
            if wellknown.CAPACITY_TYPE_SPOT in item[0].capacity_types():
                capacity_type = wellknown.CAPACITY_TYPE_SPOT
                break
    if not kept:
        empty = np.zeros((0, wellknown.NUM_RESOURCE_DIMS), np.float32)
        return InstanceFleet(
            [], empty, empty.copy(), np.zeros((0,), np.float32),
            allowed_zones=zone_values,
            capacity_type=capacity_type,
        )
    # The reference applies its spot-market forecast penalty here; with no
    # active PriceBook that hook returns the prices untouched, and the port
    # has no market layer yet, so the column is the offerings' own minimum.
    prices = np.array([item[3] for item in kept], dtype=np.float32)
    return InstanceFleet(
        instance_types=[item[0] for item in kept],
        capacity=np.stack([item[1] for item in kept]),
        total=np.stack([item[2] for item in kept]),
        prices=prices,
        allowed_zones=zone_values,
        capacity_type=capacity_type,
    )

