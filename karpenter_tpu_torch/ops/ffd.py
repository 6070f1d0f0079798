"""Greedy First-Fit-Decreasing packer — the host-side baseline and fallback.

Behaviorally faithful to the reference kernel
(ref: pkg/controllers/provisioning/binpacking/packer.go:82-189 and
packable.go:113-175) but reformulated over *pod groups* (identical request
vectors) instead of individual pods, which is exact for FFD because identical
pods are adjacent in the sorted order. This is both the correctness oracle the
TPU kernels are cross-checked against and the in-process fallback when no
accelerator is available.

Reference semantics preserved:
  - pods sorted desc by cpu then memory; packables sorted asc.
  - per node: greedy fill; if the largest remaining pod doesn't fit, the
    packable packs nothing; early exit once remaining capacity drops to/below
    the smallest remaining pod on any nonzero dimension (packable.go:120,147-157
    — including its quirk of exiting even when the smallest pod would fit
    exactly).
  - per round: the largest packable sets the max-pods upper bound; the first
    (smallest) packable achieving that bound wins, and it plus the next
    MAX_INSTANCE_TYPES-1 larger packables become the node's instance options
    (packer.go:163-189).
  - a largest pod that fits nowhere is set aside as unschedulable
    (packer.go:120-124).
  - packings with identical instance-type options merge into one entry with
    node_quantity += 1 (packer.go:126-135 hashes with Pods ignored).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from karpenter_tpu_torch.api.pods import PodSpec
from karpenter_tpu_torch.api.provisioner import Constraints
from karpenter_tpu_torch.cloudprovider import InstanceType
from karpenter_tpu_torch.ops.encode import InstanceFleet, PodGroups, build_fleet, group_pods

# Number of instance-type options offered to the cloud provider per node
# (ref: packer.go:38-39 — EC2 Fleet request-size bound).
MAX_INSTANCE_TYPES = 20


@dataclass
class PoolOption:
    """One (type, zone) launch-override row with an explicit priority.

    The reference's override rows carry a priority only per *type* (its index
    in the ascending-size window, instance.go:173-207) and are therefore
    price-blind within a type across zones. A cost-aware plan ranks individual
    pools by price instead — same row budget, strictly more control."""

    instance_type: InstanceType
    zone: str
    price: float
    priority: int


class LazyNodePods:
    """Per-node pod lists materialized on first access.

    Distributing 50k PodSpec refs into per-node lists costs tens of ms of
    pure Python; the solve boundary only needs the *plan* (fills, counts,
    options). Segments record (replication, [(group, start, n)]) windows over
    groups.members — integer bookkeeping at decode time — and the concrete
    lists are built lazily when the bind path (or a test) iterates them.
    Within a replicated segment node k takes members[g][start+k*n : start+(k+1)*n],
    matching the eager decode's sequential cursor order exactly."""

    def __init__(self, members):
        self._members = members
        self._segments: List[Tuple[int, List[Tuple[int, int, int]]]] = []
        self._cache: Optional[List[List[PodSpec]]] = None

    def add_segment(self, repl: int, slices: List[Tuple[int, int, int]]) -> None:
        self._segments.append((repl, slices))
        self._cache = None

    def _materialize(self) -> List[List[PodSpec]]:
        if self._cache is None:
            nodes: List[List[PodSpec]] = []
            for repl, slices in self._segments:
                for k in range(repl):
                    node: List[PodSpec] = []
                    for g, start, n in slices:
                        node.extend(
                            self._members[g][start + k * n : start + (k + 1) * n]
                        )
                    nodes.append(node)
            self._cache = nodes
        return self._cache

    def __len__(self) -> int:
        return sum(repl for repl, _ in self._segments)

    def __iter__(self):
        return iter(self._materialize())

    def __getitem__(self, index):
        return self._materialize()[index]

    def __eq__(self, other):
        try:
            return list(self) == list(other)
        except TypeError:
            return NotImplemented


@dataclass
class Packing:
    """One node shape: pods per node, viable instance types, node count.

    pods_per_node is a plain list on the eager path (pack_groups) and a
    LazyNodePods on solver-decoded packings — consumers iterate/len/index,
    they don't mutate."""

    pods_per_node: "Sequence[List[PodSpec]]"
    instance_type_options: List[InstanceType]
    node_quantity: int = 1
    # Cost-aware plans additionally pin pool-level override rows (cheapest
    # first). None = reference semantics (derive rows from
    # instance_type_options x offered zones, priority per type).
    pool_options: Optional[List[PoolOption]] = None
    # Constrained plans may stamp extra labels on every node of this packing
    # (custom-key topology domains realize as labels at registration —
    # constraints/solve.decode_constrained); None = no extra labels.
    node_labels: Optional[dict] = None

    @property
    def pods(self) -> List[PodSpec]:
        return [pod for node in self.pods_per_node for pod in node]


@dataclass
class PackResult:
    packings: List[Packing]
    unschedulable: List[PodSpec] = field(default_factory=list)

    @property
    def node_count(self) -> int:
        return sum(p.node_quantity for p in self.packings)

    def projected_cost(self) -> float:
        """$/hr if each node launches as its cheapest offered option."""
        total = 0.0
        for p in self.packings:
            if p.pool_options:
                price = min(pool.price for pool in p.pool_options)
            else:
                price = min(
                    (it.min_price() for it in p.instance_type_options),
                    default=float("inf"),
                )
            total += p.node_quantity * price
        return total


def fill_node(
    capacity: np.ndarray,
    total: np.ndarray,
    vectors: np.ndarray,
    counts: np.ndarray,
    quirk: bool = True,
) -> np.ndarray:
    """Greedily fill one node. Returns packed count per group.

    `capacity` is the usable ledger (total - overhead - daemons); `total` is
    the raw instance capacity used by the early-exit check, matching
    packable.go fits() comparing against p.total. quirk=False disables the
    reference's fits() early exit (pure greedy — used by the cost paths,
    which don't need bit-parity and pack strictly better).
    """
    num_groups = vectors.shape[0]
    packed = np.zeros(num_groups, dtype=np.int64)
    active = np.nonzero(counts > 0)[0]
    if active.size == 0:
        return packed
    smallest = vectors[active[-1]]
    remaining = capacity.astype(np.float64).copy()
    packed_any = False
    for g in active:
        need = vectors[g].astype(np.float64)
        positive = need > 0
        if positive.any():
            n_fit = int(np.floor((remaining[positive] / need[positive]).min() + 1e-9))
        else:
            n_fit = int(counts[g])
        n = min(int(counts[g]), max(n_fit, 0))
        if n > 0:
            packed[g] = n
            remaining -= need * n
            packed_any = True
        if n < counts[g]:
            # This group's next pod failed to reserve.
            if not packed_any:
                return np.zeros(num_groups, dtype=np.int64)  # largest pod set aside
            # Early exit when essentially full w.r.t. the smallest pod:
            # reserved + smallest >= total on any tracked dim (fits(), :147-157).
            if quirk and np.any((total > 0) & (remaining <= smallest + 1e-9)):
                break
    return packed


def _pack_with_largest(
    fleet: InstanceFleet, vectors: np.ndarray, counts: np.ndarray
) -> Tuple[Optional[np.ndarray], List[InstanceType]]:
    """One round: pick the node that packs the max pods achievable by the
    largest packable, preferring the smallest instance type that achieves it
    (ref: packer.go:163-189). Returns (packed counts, instance options)."""
    last = fleet.num_types - 1
    upper = fill_node(fleet.capacity[last], fleet.total[last], vectors, counts)
    max_packed = int(upper.sum())
    if max_packed == 0:
        return None, []
    for t in range(fleet.num_types):
        packed = (
            upper
            if t == last
            else fill_node(fleet.capacity[t], fleet.total[t], vectors, counts)
        )
        if int(packed.sum()) == max_packed:
            options = fleet.instance_types[t : t + MAX_INSTANCE_TYPES]
            return packed, options
    raise AssertionError("largest packable must achieve its own bound")


def pack_groups(fleet: InstanceFleet, groups: PodGroups) -> PackResult:
    """Drive rounds of _pack_with_largest until all pods are placed or set
    aside (ref: packer.go Pack:105-137)."""
    counts = groups.counts.astype(np.int64).copy()
    # Cursor into each group's member list for assigning concrete pods.
    cursors = [0] * groups.num_groups
    by_options: dict = {}
    packings: List[Packing] = []
    unschedulable: List[PodSpec] = []

    if fleet.num_types == 0:
        for g in range(groups.num_groups):
            unschedulable.extend(groups.members[g])
        return PackResult(packings=[], unschedulable=unschedulable)

    while counts.sum() > 0:
        packed, options = _pack_with_largest(fleet, groups.vectors, counts)
        if packed is None:
            # Largest remaining pod fits nowhere: set it aside.
            g = int(np.nonzero(counts > 0)[0][0])
            unschedulable.append(groups.members[g][cursors[g]])
            cursors[g] += 1
            counts[g] -= 1
            continue
        node_pods: List[PodSpec] = []
        for g in np.nonzero(packed > 0)[0]:
            n = int(packed[g])
            node_pods.extend(groups.members[g][cursors[g] : cursors[g] + n])
            cursors[g] += n
            counts[g] -= n
        key = tuple(it.name for it in options)
        existing = by_options.get(key)
        if existing is not None:
            existing.node_quantity += 1
            existing.pods_per_node.append(node_pods)
        else:
            packing = Packing(pods_per_node=[node_pods], instance_type_options=list(options))
            by_options[key] = packing
            packings.append(packing)
    return PackResult(packings=packings, unschedulable=unschedulable)


def pack_rounds_dense(
    vectors: np.ndarray,
    counts: np.ndarray,
    capacity: np.ndarray,
    total: np.ndarray,
    quirk: bool = True,
) -> Tuple[List[Tuple[int, np.ndarray, int]], np.ndarray]:
    """pack_groups' round loop on bare arrays — (rounds, unschedulable counts)
    in the decode format the TPU kernel and native packer emit. This is the
    object-free last-resort path for the solver sidecar, which holds tensors
    off the wire and no PodSpec/InstanceType objects."""
    counts = counts.astype(np.int64).copy()
    num_groups, num_types = int(vectors.shape[0]), int(capacity.shape[0])
    rounds: List[Tuple[int, np.ndarray, int]] = []
    unschedulable = np.zeros(num_groups, dtype=np.int64)
    if num_types == 0:
        unschedulable += counts
        return rounds, unschedulable
    last = num_types - 1
    while counts.sum() > 0:
        upper = fill_node(capacity[last], total[last], vectors, counts, quirk=quirk)
        max_packed = int(upper.sum())
        if max_packed == 0:
            g = int(np.nonzero(counts > 0)[0][0])
            unschedulable[g] += 1
            counts[g] -= 1
            continue
        for t in range(num_types):
            packed = (
                upper
                if t == last
                else fill_node(capacity[t], total[t], vectors, counts, quirk=quirk)
            )
            if int(packed.sum()) == max_packed:
                rounds.append((t, packed.astype(np.int64), 1))
                counts -= packed
                break
    return rounds, unschedulable


def pack(
    pods: Sequence[PodSpec],
    instance_types: Sequence[InstanceType],
    constraints: Constraints,
    daemons: Sequence[PodSpec] = (),
) -> PackResult:
    """The full greedy path: filter/densify the fleet, group + sort pods, pack."""
    groups = group_pods(list(pods))
    fleet = build_fleet(instance_types, constraints, pods, daemons)
    return pack_groups(fleet, groups)
