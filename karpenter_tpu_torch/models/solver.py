"""Solver models — the pluggable "solver boundary", in PyTorch.

The port of karpenter_tpu/models/solver.py, trimmed to the provisioning
solve's main path. The provisioning controller calls a Solver; CostSolver
runs the fused device solve (dominance pricing, the pack round loop in two
modes, the LP relaxation, plan compaction), scores its candidates against
host candidates on the host and keeps the cheapest feasible packing;
GreedySolver and NativeSolver are the host-side FFD solvers.

The device is explicit: CostSolver(device=None) runs on the CUDA card and
raises without one (karpenter_tpu_torch/device.py); device="cpu" runs the
kernels' plain PyTorch versions.

Pod tensors may arrive already on the device (the incremental encode's
sorted gather, models/cluster_state.py); the fleet arrays ride the
device_resident cache; the pipelined solve hands results back one schedule
at a time; and the batched paths survive device-memory exhaustion by
pre-splitting and bisecting the batch.

Left out of this slice, against the reference: the sharded and mesh path,
break-even calibration, tracing spans, TPUSolver and the market hooks in the
pool-price matrix.
"""

from __future__ import annotations

import abc
import functools
import os
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from karpenter_tpu_torch.api.pods import PodSpec
from karpenter_tpu_torch.api.provisioner import Constraints
from karpenter_tpu_torch.cloudprovider import InstanceType
from karpenter_tpu_torch.device import resolve_device
from karpenter_tpu_torch.ops import ffd
from karpenter_tpu_torch.ops import mix_pack
from karpenter_tpu_torch.ops.cuda_kernels import dominance_prices
from karpenter_tpu_torch.ops.encode import InstanceFleet, PodGroups, build_fleet, group_pods
from karpenter_tpu_torch.ops.pack_kernel import (
    PackRounds,
    bucket_size,
    compact_plan,
    decompact_plan,
    max_rounds,
    pack_kernel_pair,
    device_resident,
    pad_to,
)
from karpenter_tpu_torch.ops.score_kernel import (
    feasibility_mask,
    lp_relax,
    round_assignment,
)
from karpenter_tpu_torch.utils import logging as klog
from karpenter_tpu_torch.utils.metrics import REGISTRY

# The plain LP's einsums (the CPU path, and what K3 is held against on the
# card) must stay in full fp32: TF32 would keep about three decimal digits.
# PyTorch's default is already False; the solver states it rather than rely
# on it.
torch.backends.cuda.matmul.allow_tf32 = False

# Which side of the adaptive dispatch a cost solve was ROUTED to — the
# first thing to check when solve latency looks wrong for the problem
# size. Counted at routing time: a device dispatch whose candidates all
# fail (rare — the caller then falls back to host greedy) still counts as
# "device", since the routing decision is what the metric explains.
SOLVE_DISPATCH_TOTAL = REGISTRY.counter(
    "solver_dispatch_total",
    "Cost solves by routed dispatch path (host|device)",
    ["path"],
)
# Device-memory survival (CostSolver._solve_batch_survive): batch splits
# forced by HBM pressure. "estimate" = the pre-dispatch estimator chunked
# an oversized batch before it could OOM; "oom" = a live RESOURCE_EXHAUSTED
# bisected the batch and re-dispatched the halves; "floor" = a single
# schedule still OOMed, so the solve answered from the host path. A
# climbing "oom" rate with zero "estimate" means the estimator's
# budget read is wrong for this device.
SOLVER_BATCH_SPLIT_TOTAL = REGISTRY.counter(
    "solver_batch_split_total",
    "Solve-batch splits under device memory pressure (estimate|oom|floor)",
    ["reason"],
)



class Solver(abc.ABC):
    """The solver boundary. Pods must already share one schedule's
    constraints (the scheduler groups them; ref: scheduling/scheduler.go:67).
    `solve` densifies specs then delegates to `solve_encoded`, the
    tensor-level entry point the benchmark and sidecar call directly."""

    # Device-backed solvers carry build and launch debt the first time each
    # (groups, types) bucket is hit; the constrained solve routes them to the
    # [L, G, T] kernel, host solvers to its numpy mirror.
    needs_device_warmup = False

    def solve(
        self,
        pods: Sequence[PodSpec],
        instance_types: Sequence[InstanceType],
        constraints: Constraints,
        daemons: Sequence[PodSpec] = (),
    ) -> ffd.PackResult:
        groups = group_pods(list(pods))
        fleet = build_fleet(
            instance_types, constraints, pods, daemons,
            pods_need=_groups_need(groups),
        )
        return self.solve_encoded(groups, fleet)

    @staticmethod
    def _encode_problems(
        problems: Sequence[
            Tuple[Sequence[PodSpec], Sequence[InstanceType], Constraints, Sequence[PodSpec]]
        ],
    ) -> List[Tuple[PodGroups, InstanceFleet]]:
        """THE spec->tensor encoding of a problem batch, shared by the
        barrier (solve_many) and pipelined (solve_many_pipelined) paths so
        they can never drift.

        Encoded-state fast path: a problem may arrive ALREADY encoded as a
        (PodGroups, InstanceFleet) pair — the incremental encoder
        (models/cluster_state.DeviceClusterState) hands these over when its
        delta-maintained tensors cover the batch, and group_pods/build_fleet
        are skipped entirely (per-sweep encode cost O(churn), not
        O(cluster)). The pair passes through untouched so the two sources
        stay interchangeable downstream."""
        encoded = []
        for item in problems:
            if len(item) == 2 and isinstance(item[0], PodGroups):
                encoded.append((item[0], item[1]))
                continue
            pods, instance_types, constraints, daemons = item
            groups = group_pods(list(pods))
            encoded.append(
                (
                    groups,
                    build_fleet(
                        instance_types, constraints, pods, daemons,
                        pods_need=_groups_need(groups),
                    ),
                )
            )
        return encoded

    def solve_many(
        self,
        problems: Sequence[
            Tuple[Sequence[PodSpec], Sequence[InstanceType], Constraints, Sequence[PodSpec]]
        ],
    ) -> List[ffd.PackResult]:
        """Solve a batch of independent schedule problems. Device-backed
        solvers override solve_encoded_many to share one device->host round
        trip across the whole batch (a pod batch regularly splits into many
        schedules — ref: provisioner.go solves them in a loop, paying the
        kernel per schedule)."""
        return self.solve_encoded_many(self._encode_problems(problems))

    def solve_encoded_many(
        self, items: Sequence[Tuple[PodGroups, InstanceFleet]]
    ) -> List[ffd.PackResult]:
        return [self.solve_encoded(groups, fleet) for groups, fleet in items]

    def solve_many_pipelined(
        self,
        problems: Sequence[
            Tuple[Sequence[PodSpec], Sequence[InstanceType], Constraints, Sequence[PodSpec]]
        ],
    ) -> Iterator[ffd.PackResult]:
        """solve_many as a generator: results come back one schedule at a
        time, in order, so the caller can bind schedule N while later
        schedules are still solving. Device-backed solvers override
        solve_encoded_pipelined to genuinely overlap the remaining kernels
        and device->host copies with the caller's bind work; the base
        implementation solves the whole batch up front and just yields."""
        return self.solve_encoded_pipelined(self._encode_problems(problems))

    def solve_encoded_pipelined(
        self, items: Sequence[Tuple[PodGroups, InstanceFleet]]
    ) -> Iterator[ffd.PackResult]:
        """Base implementation: solve each schedule ON DEMAND at its pull.
        Host solvers have no device work to overlap, but lazy per-pull
        solving keeps the caller's per-schedule timing honest (each
        SOLVE_DURATION sample in provisioning measures a real solve, not a
        pre-solved batch) and matches the pipelined contract: work for
        schedule N+1 happens after schedule N was handed over. Batching
        solvers (CostSolver, RemoteSolver) override this with genuinely
        overlapped implementations."""
        return (self.solve_encoded(groups, fleet) for groups, fleet in items)

    @abc.abstractmethod
    def solve_encoded(self, groups: PodGroups, fleet: InstanceFleet) -> ffd.PackResult:
        ...


def _groups_need(groups: PodGroups) -> Optional[np.ndarray]:
    """[R] max request vector from already-grouped pods (saves build_fleet a
    second 50k-pod walk)."""
    if groups.num_groups == 0:
        return None
    return groups.vectors.max(axis=0)


class GreedySolver(Solver):
    """Host-side grouped FFD in pure Python — reference-faithful oracle."""

    def solve_encoded(self, groups: PodGroups, fleet: InstanceFleet) -> ffd.PackResult:
        return ffd.pack_groups(fleet, groups)


class NativeSolver(Solver):
    """Compiled host FFD (csrc/host/ffd.cc via ctypes): same rounds as
    GreedySolver, at compiled-code speed. Degrades to the pure-Python path
    when the library can't be built."""

    def __init__(self, quirk: bool = True):
        self.quirk = quirk

    def solve_encoded(self, groups: PodGroups, fleet: InstanceFleet) -> ffd.PackResult:
        from karpenter_tpu_torch.ops import native

        if fleet.num_types == 0 or groups.num_groups == 0:
            return ffd.pack_groups(fleet, groups)
        result = native.ffd_pack_rounds(
            groups.vectors,
            groups.counts.astype(np.int64),
            fleet.capacity,
            fleet.total,
            quirk=self.quirk,
        )
        if result is None:
            return ffd.pack_groups(fleet, groups)
        round_list, unschedulable_counts = result
        return _decode_rounds(round_list, unschedulable_counts, groups, fleet)


def _rounds_ints(rounds: PackRounds) -> List[torch.Tensor]:
    return [
        rounds.round_type.reshape(-1),
        rounds.round_fill.reshape(-1),
        rounds.round_repl.reshape(-1),
        rounds.num_rounds.reshape(1),
        rounds.unschedulable.reshape(-1),
        rounds.overflow.to(torch.int32).reshape(1),
    ]


def _cost_fused_body(vectors, counts, capacity, total, valid, prices, *, lp_steps: int):
    """All three CostSolver candidates as one stream of device work: greedy
    FFD rounds, cost-greedy rounds, and the LP relaxation, with no host sync
    before the fetch. Returns four tensors with different fetch policies
    (see FusedHandle): the compacted int32 payload and the LP objective are
    fetched eagerly; the dense round state is a spill fetched only when the
    compaction overflows its entry budget; the [G, T] LP assignment stays on
    the device until the scoring pass decides to realize the LP plan.

    Price model: a node packed for type t launches as the cheapest pool of
    ANY type whose capacity dominates t's, so the cost objective sees the
    dominating-type minimum price (K1, ops/cuda_kernels.dominance_prices).
    Both pack modes run as one launch of the round-loop kernel (K2,
    ops/pack_kernel.pack_kernel_pair), and the LP relaxation's every Adam
    step as one launch of K3 (ops/score_kernel.lp_relax)."""
    valid_prices = torch.where(valid, prices, torch.inf)
    effective_prices = dominance_prices(capacity, valid_prices)
    rounds_ffd, rounds_cost = pack_kernel_pair(
        vectors, counts, capacity, total, valid, effective_prices
    )
    feasible_any = feasibility_mask(vectors, capacity, valid).any(dim=1)
    solvable = torch.where(feasible_any, counts, 0)
    lp = lp_relax(vectors, solvable, capacity, valid, effective_prices, steps=lp_steps)
    dense_ints = torch.cat(
        _rounds_ints(rounds_ffd)
        + _rounds_ints(rounds_cost)
        + [feasible_any.to(torch.int32).reshape(-1)]
    )
    compacted = compact_plan(rounds_ffd, rounds_cost, feasible_any)
    objective = lp.objective.reshape(1).to(torch.float32)
    return compacted, objective, dense_ints, lp.assignment.reshape(-1)


def unpack_dense(ints: np.ndarray, num_groups: int) -> Tuple:
    """Host-side inverse of the dense spill packing:
    (rounds_ffd, rounds_cost, feasible_any) from the flat int array, given
    the PADDED group count."""
    mr = max_rounds(num_groups)
    cursor = 0

    def take(n):
        nonlocal cursor
        out = ints[cursor : cursor + n]
        cursor += n
        return out

    def take_rounds() -> PackRounds:
        return PackRounds(
            round_type=take(mr),
            round_fill=take(mr * num_groups).reshape(mr, num_groups),
            round_repl=take(mr),
            num_rounds=take(1)[0],
            unschedulable=take(num_groups),
            overflow=bool(take(1)[0]),
        )

    rounds_ffd = take_rounds()
    rounds_cost = take_rounds()
    feasible_any = take(num_groups).astype(bool)
    return rounds_ffd, rounds_cost, feasible_any


class FusedHandle(NamedTuple):
    """A dispatched fused solve: in-flight device tensors plus the static
    padded shapes needed to decode them after the fetch. Only `compact` and
    `objective` (a few KB) are fetched on the hot path; `dense` is the spill
    for entry-budget overflow, and `lp` stays on the device unless the
    scoring pass realizes the LP plan (FetchedPlan.lp_assignment)."""

    compact: torch.Tensor  # [NW] int32
    objective: torch.Tensor  # [1] float32
    dense: torch.Tensor  # [NI] int32 — dense spill, fetched only on overflow
    lp: torch.Tensor  # [G*T] float32 — deferred LP assignment
    num_groups: int  # padded G
    num_types: int  # padded T
    # (pinned host payload, its event) once plan_start_fetch queued the copy;
    # cost_solve_dispatch passes an empty list.
    staged: Optional[list] = None


class FetchedPlan:
    """A fused solve's decoded eager payload plus the deferred LP handle.

    fetch_plans produces these; cost_solve_finish consumes them.
    lp_assignment() copies the [G, T] assignment off the device the first
    time the LP realization pass actually runs."""

    def __init__(self, rounds_ffd, rounds_cost, feasible_any, lp_objective, handle):
        self.rounds_ffd = rounds_ffd
        self.rounds_cost = rounds_cost
        self.feasible_any = feasible_any
        self.lp_objective = lp_objective
        self._handle = handle
        self._lp: Optional[np.ndarray] = None

    def lp_assignment(self) -> np.ndarray:
        if self._lp is None:
            handle = self._handle
            self._lp = handle.lp.cpu().numpy().reshape(
                handle.num_groups, handle.num_types
            )
        return self._lp


def _eager_payload(handle: FusedHandle) -> torch.Tensor:
    """The compact words and the objective's bits, as one int32 tensor."""
    return torch.cat([handle.compact, handle.objective.view(torch.int32)])


def plan_start_fetch(handle: FusedHandle) -> None:
    """Queue the EAGER payload's device->host copy behind the dispatched
    kernels: one cat on the device, one non-blocking copy into pinned host
    memory and an event the fetch waits on, with no host sync. A no-op on
    the CPU (nothing to overlap) and for a handle already staged."""
    if handle.staged is None or handle.staged or handle.compact.device.type != "cuda":
        return
    with torch.cuda.device(handle.compact.device):
        payload = _eager_payload(handle)
        host = torch.empty(payload.shape, dtype=payload.dtype, pin_memory=True)
        host.copy_(payload, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
    handle.staged.append((host, done))


def fetch_plans(handles: Sequence[FusedHandle]) -> List[FetchedPlan]:
    """THE compacted fetch, then host-side decode. A handle whose copy
    plan_start_fetch queued waits on its event; the others' eager payloads
    (compact words plus the objective's bits) are concatenated on the device
    and copied to the host in one transfer — one sync for the whole batch.
    A plan that overflowed the entry budget falls back to its dense
    spill."""
    unstaged = [handle for handle in handles if not handle.staged]
    payload = (
        torch.cat([_eager_payload(handle) for handle in unstaged]).cpu().numpy()
        if unstaged
        else None
    )
    plans: List[FetchedPlan] = []
    cursor = 0
    for handle in handles:
        size = int(handle.compact.shape[0])
        if handle.staged:
            host, done = handle.staged[0]
            done.synchronize()
            words = host.numpy()
        else:
            words = payload[cursor : cursor + size + 1]
            cursor += size + 1
        compact = words[:size]
        objective = words[size : size + 1].view(np.float32)
        rounds_ffd, rounds_cost, feasible_any, ok = decompact_plan(
            compact, handle.num_groups
        )
        if not ok:  # pragma: no cover — entry budget sized to never trip
            rounds_ffd, rounds_cost, feasible_any = unpack_dense(
                handle.dense.cpu().numpy(), handle.num_groups
            )
        plans.append(
            FetchedPlan(
                rounds_ffd, rounds_cost, feasible_any, float(objective[0]), handle
            )
        )
    return plans


def fetch_plan(handle: FusedHandle) -> FetchedPlan:
    return fetch_plans([handle])[0]


def pad_kernel_args(vectors, counts, capacity, total, prices):
    """Bucket-pad the six dense kernel inputs — THE padding/valid-mask
    convention, identical to the reference's single-device padding. Pod
    tensors already on the device (the incremental encode's sorted gather)
    come bucket-padded and pass through."""
    g_pad = bucket_size(int(vectors.shape[0]))
    t_pad = bucket_size(int(capacity.shape[0]))
    if isinstance(vectors, torch.Tensor):
        pods = (vectors, counts)
    else:
        pods = (pad_to(vectors, g_pad), pad_to(counts.astype(np.int32), g_pad))
    return pods + (
        pad_to(capacity, t_pad),
        pad_to(total, t_pad),
        pad_to(np.ones(int(capacity.shape[0]), bool), t_pad),
        pad_to(prices, t_pad),
    )


# Row budget for one launch request: the reference offers MAX_INSTANCE_TYPES
# types, each crossed with ~3 zone subnets (instance.go:173-207) — we spend
# the same number of override rows on individually price-ranked pools.
MAX_POOL_ROWS = 3 * ffd.MAX_INSTANCE_TYPES
# Pools priced within this band of the cheapest feasible pool are offered.
POOL_PRICE_BAND = 0.05
# Never offer fewer than this many pools (when they exist): a single-pool
# request is one ICE away from failure.
MIN_POOL_ROWS = 4
# Hard ceiling on any offered row relative to the cheapest feasible pool; it
# overrides the MIN_POOL_ROWS floor.
MAX_POOL_PRICE_RATIO = 1.15


def _pool_zones(fleet: InstanceFleet) -> List[str]:
    """The zone axis of the fleet's pool matrix (stable order)."""
    return fleet.allowed_zones or sorted(
        {z for it in fleet.instance_types for z in it.zones()}
    )


def _pool_price_matrix(fleet: InstanceFleet) -> Tuple[List[str], np.ndarray]:
    """[T, Z] price of each type's pool per zone at the fleet's capacity type
    (inf where not offered), computed once per solve so per-round option
    ranking is pure vectorized numpy. (The reference also folds a spot
    interruption-risk penalty in when a market PriceBook is active; the port
    has no market layer yet, and with no active book the reference's matrix
    is exactly this one.)"""
    zones = _pool_zones(fleet)
    matrix = np.full((fleet.num_types, len(zones)), np.inf, dtype=np.float64)
    zone_index = {zone: j for j, zone in enumerate(zones)}
    for ti, instance_type in enumerate(fleet.instance_types):
        for offering in instance_type.offerings:
            if offering.capacity_type != fleet.capacity_type:
                continue
            j = zone_index.get(offering.zone)
            if j is not None:
                matrix[ti, j] = min(matrix[ti, j], offering.price)
    return zones, matrix


# A dense pool row: (type index, zone index, price); priority is the row's
# position in the list.
PoolRow = Tuple[int, int, float]


def sort_pool_rows(pool_prices: np.ndarray):
    """Global price order of all (type, zone) pool rows — identical for every
    fill, so the sort is hoisted out of the per-fill option ranking: (row
    type, row zone, row price) each [N], price-ascending, non-offered (inf)
    rows dropped."""
    flat = pool_prices.ravel()
    finite = np.isfinite(flat)
    order = np.argsort(flat, kind="stable")
    order = order[finite[order]]
    num_zones = pool_prices.shape[1]
    return order // num_zones, order % num_zones, flat[order]


def _cheapest_feasible_pools(
    fill: np.ndarray,
    t: int,
    vectors: np.ndarray,
    capacity: np.ndarray,
    pool_prices: np.ndarray,
    pool_order=None,
) -> Tuple[List[int], Optional[List[PoolRow]]]:
    """Price-ranked launch options for a node with this fill (dense core):
    the cheapest (type, zone) pools whose type's usable capacity holds the
    node's demand, within POOL_PRICE_BAND (at least MIN_POOL_ROWS, at most
    MAX_POOL_ROWS, distinct types capped at MAX_INSTANCE_TYPES). Returns
    (type indices, pool rows)."""
    demand = (fill.astype(np.float64)[:, None] * vectors).sum(axis=0)
    feasible_mask = (capacity >= demand - 1e-6).all(axis=1)
    if pool_order is None:
        pool_order = sort_pool_rows(pool_prices)
    all_types, all_zones, all_prices = pool_order
    # The global price order restricted to feasible types keeps its sort.
    keep = feasible_mask[all_types]
    if not keep.any():
        # Degenerate: fall back to the feasibility anchor's type options.
        return [t], None
    row_types = all_types[keep]
    row_zones = all_zones[keep]
    prices_sorted = all_prices[keep]

    # Vectorized form of the sequential selection walk: rows of a type past
    # the MAX_INSTANCE_TYPES-th distinct one are skipped; the walk stops at
    # the first row where the appended-so-far count hits the row budget,
    # exits the price band past MIN_POOL_ROWS, or exceeds the ceiling with
    # anything appended.
    uniques, first_idx, inverse = np.unique(
        row_types, return_index=True, return_inverse=True
    )
    type_rank = np.argsort(np.argsort(first_idx))  # first-occurrence order
    admissible = type_rank[inverse] < ffd.MAX_INSTANCE_TYPES
    count_excl = np.concatenate(([0], np.cumsum(admissible)[:-1]))
    cheapest = prices_sorted[0]
    cutoff = cheapest * (1.0 + POOL_PRICE_BAND)
    ceiling = cheapest * MAX_POOL_PRICE_RATIO
    stop_mask = (
        (count_excl >= MAX_POOL_ROWS)
        | ((prices_sorted > cutoff) & (count_excl >= MIN_POOL_ROWS))
        | ((prices_sorted > ceiling) & (count_excl >= 1))
    )
    stops = np.nonzero(stop_mask)[0]
    stop = int(stops[0]) if stops.size else len(prices_sorted)
    selected = np.nonzero(admissible[:stop])[0]

    pool_rows: List[PoolRow] = [
        (int(row_types[i]), int(row_zones[i]), float(prices_sorted[i]))
        for i in selected
    ]
    sel_types = row_types[selected]
    _, sel_first = np.unique(sel_types, return_index=True)
    chosen_types = [int(sel_types[i]) for i in np.sort(sel_first)]
    return chosen_types, pool_rows


def pool_rows_to_options(
    rows: Optional[List[PoolRow]], fleet: InstanceFleet, zones: List[str]
) -> Optional[List[ffd.PoolOption]]:
    """Rehydrate dense pool rows into PoolOption objects on the fleet-holding
    side of the solver boundary."""
    if rows is None:
        return None
    return [
        ffd.PoolOption(
            instance_type=fleet.instance_types[ti],
            zone=zones[zi],
            price=price,
            priority=i,
        )
        for i, (ti, zi, price) in enumerate(rows)
    ]


def _decode_rounds(
    round_list: List[Tuple[int, np.ndarray, int]],
    unschedulable_counts: np.ndarray,
    groups: PodGroups,
    fleet: InstanceFleet,
    options_fn=None,
) -> ffd.PackResult:
    """Turn (type, fill, replication) rounds into Packing objects, merging by
    instance-option tuple (ref: packer.go:126-135 hashes options only).

    options_fn(t, fill) -> [type index] overrides the reference's
    ascending-size option window (the CostSolver passes its memoized
    cheapest-feasible selector). Per-node pod lists are LazyNodePods."""
    cursors = [0] * groups.num_groups
    by_options = {}
    packings: List[ffd.Packing] = []
    for t, fill, repl in round_list:
        pool_opts = None
        if options_fn is not None:
            type_indices, pool_opts = options_fn(t, fill)
            options = [fleet.instance_types[i] for i in type_indices]
        else:
            options = fleet.instance_types[t : t + ffd.MAX_INSTANCE_TYPES]
        repl = int(repl)
        slices = []
        for g in np.nonzero(fill > 0)[0]:
            g, n = int(g), int(fill[g])
            slices.append((g, cursors[g], n))
            cursors[g] += n * repl
        key = (
            tuple(it.name for it in options),
            tuple((p.instance_type.name, p.zone) for p in pool_opts)
            if pool_opts
            else None,
        )
        existing = by_options.get(key)
        if existing is not None:
            existing.node_quantity += repl
            existing.pods_per_node.add_segment(repl, slices)
        else:
            lazy = ffd.LazyNodePods(groups.members)
            lazy.add_segment(repl, slices)
            packing = ffd.Packing(
                pods_per_node=lazy,
                instance_type_options=list(options),
                node_quantity=repl,
                pool_options=pool_opts,
            )
            by_options[key] = packing
            packings.append(packing)

    unschedulable: List[PodSpec] = []
    for g in np.nonzero(unschedulable_counts > 0)[0]:
        n = int(unschedulable_counts[g])
        unschedulable.extend(groups.members[g][cursors[g] : cursors[g] + n])
        cursors[g] += n
    return ffd.PackResult(packings=packings, unschedulable=unschedulable)


def _kernel_rounds_to_list(host_rounds: PackRounds, num_groups: int):
    # Never read past the static round buffer.
    num_rounds = min(
        int(host_rounds.num_rounds), int(host_rounds.round_type.shape[0])
    )
    return [
        (
            int(host_rounds.round_type[r]),
            host_rounds.round_fill[r, :num_groups],
            int(host_rounds.round_repl[r]),
        )
        for r in range(num_rounds)
    ]


@dataclass
class DenseSolveResult:
    """Object-free cost-solve output — what crosses the solver boundary.

    rounds: (type index, fill[G], replication) per launch round;
    unschedulable: [G] pods per group that fit nowhere;
    options: fill-bytes -> (type indices, pool rows) launch options for each
    distinct fill appearing in rounds."""

    rounds: List[Tuple[int, np.ndarray, int]]
    unschedulable: np.ndarray
    options: Dict[bytes, Tuple[List[int], Optional[List[PoolRow]]]]


# Skip the host-side LP realization only when a kernel candidate beats the
# LP's fractional objective by this much (the two sides are priced in
# different models; the slack absorbs the gap).
LP_REALIZE_SLACK = 0.8

# Per-priority-rank weight decay for the expected realized node price: row
# i of a fill's price-ranked pool options carries weight PRIORITY_DECAY**i
# (normalized).
PRIORITY_DECAY = 0.5


def device_pod_args(groups: PodGroups):
    """The pod-side kernel tensors for a schedule: the encoded-state device
    tensors when the groups carry them (DeviceClusterState handles — already
    sorted + bucket-padded, and read-only to every solve kernel), None
    otherwise (caller uses the host numpy tensors)."""
    device_vectors = getattr(groups, "device_vectors", None)
    device_counts = getattr(groups, "device_counts", None)
    if device_vectors is None or device_counts is None:
        return None
    return device_vectors, device_counts


def cost_solve_dense(
    vectors: np.ndarray,
    counts: np.ndarray,
    capacity: np.ndarray,
    total: np.ndarray,
    prices: np.ndarray,
    pool_prices,
    lp_steps: int = 300,
    explain: Optional[dict] = None,
    device=None,
    device_pods=None,
) -> Optional[DenseSolveResult]:
    """The flagship solve on dense tensors only. Returns None when no
    candidate packing exists (caller falls back to host greedy).

    Runs pure-greedy FFD, cost-greedy, and the LP-relaxation plan as one
    fused device solve, scores each candidate by expected realized $/hr, and
    returns the winner's rounds + per-fill launch options.

    pool_prices may be the [T, Z] array itself or a zero-arg callable
    producing it: the device work is asynchronous, so a callable is
    evaluated in a worker thread while the card computes and the fetch
    waits. device_pods, when given, are the schedule's pod tensors already
    on the device (device_pod_args); the host arrays still serve the gate
    and the scoring."""
    # Adaptive dispatch: below the device break-even the host candidates
    # answer in milliseconds and carry the cost win.
    if host_solve_enabled(int(np.asarray(counts).sum())):
        if callable(pool_prices):
            pool_prices = pool_prices()
        dense = cost_solve_host(
            vectors, counts, capacity, total, prices, pool_prices,
            explain=explain,
        )
        if dense is not None:
            return dense

    pod_vectors, pod_counts = device_pods or (vectors, counts)
    fused = cost_solve_dispatch(
        pod_vectors, pod_counts, capacity, total, prices, lp_steps, device=device
    )
    # The pool matrix build and the column-LP mix candidate run in a worker
    # thread concurrently with the fetch, which waits on the device with the
    # interpreter lock released.
    plan_start_fetch(fused)
    overlap = _HostOverlap([(vectors, counts, capacity, pool_prices)])
    overlap.start()
    fetched = fetch_plan(fused)
    (pool_prices,), (mix_plan,) = overlap.join()

    return cost_solve_finish(
        fetched, vectors, counts, capacity, total, prices, pool_prices,
        mix_plan=mix_plan, explain=explain,
    )


class _HostOverlap:
    """THE fetch-overlap worker, shared by the single, the batched and the
    pipelined solve: for each item (vectors, counts, capacity,
    pool_prices-or-thunk), evaluate the pool-price matrix then the mix
    candidate, in a thread that runs concurrently with the blocking device
    fetch (which waits with the interpreter lock released). Mix candidates
    are best-effort (an internal error degrades that item to no-mix); a
    pool-matrix failure re-raises on join, since the finish path cannot
    proceed without it.

    Items complete IN ORDER and each completion sets a per-item event, so
    the pipelined consumer (solve_encoded_pipelined) can wait(k) for just
    its item instead of joining the whole batch — the hand-off that lets
    schedule k's decode start while later schedules' host work is still
    running."""

    def __init__(self, items: Sequence[Tuple]):
        self._items = list(items)
        self.pool_prices: List = [None] * len(self._items)
        self.mix_plans: List = [None] * len(self._items)
        self._error: Optional[BaseException] = None
        self._error_index = len(self._items)
        self._done = [threading.Event() for _ in self._items]
        self._thread = threading.Thread(
            target=self._run, name="solve-host-overlap", daemon=True
        )

    def start(self) -> "_HostOverlap":
        self._thread.start()
        return self

    def _run(self):
        for index, (vectors, counts, capacity, pool_prices) in enumerate(
            self._items
        ):
            try:
                if callable(pool_prices):
                    pool_prices = pool_prices()
                self.pool_prices[index] = pool_prices
            except BaseException as error:  # noqa: BLE001 — re-raised on join
                self._error = error
                self._error_index = index
                for event in self._done[index:]:
                    event.set()
                return
            try:
                self.mix_plans[index] = compute_mix_candidate(
                    vectors, counts, capacity, pool_prices
                )
            except Exception:  # noqa: BLE001 — optional candidate, not fatal
                klog.named("solver").warning(
                    "mix candidate failed; solving without it", exc_info=True
                )
            self._done[index].set()

    def wait(self, index: int) -> None:
        """Block until item `index` is finished; re-raise the pool-matrix
        error iff it poisoned this item (items before the failure stay
        usable — their slots were already filled in order)."""
        self._done[index].wait()
        if self._error is not None and index >= self._error_index:
            raise self._error

    def join(self) -> Tuple[List, List]:
        self._thread.join()
        if self._error is not None:
            raise self._error
        return self.pool_prices, self.mix_plans


def compute_mix_candidate(
    vectors: np.ndarray,
    counts: np.ndarray,
    capacity: np.ndarray,
    pool_prices: np.ndarray,
    allow_single_group: bool = False,
) -> Optional[Tuple[List[Tuple[int, np.ndarray, int]], np.ndarray]]:
    """The column-LP candidate (ops/mix_pack.py) as (rounds, unschedulable),
    or None when no covering plan exists. Pure host work — callers run it
    while the fused solve computes on the device (or as the whole cost
    engine on the cost_solve_host path, which sets allow_single_group)."""
    counts = counts.astype(np.int64)
    if int(vectors.shape[0]) < 2 and not allow_single_group:
        # On the device path a single request shape gains little from the
        # covering LP (the kernel's greedy candidates enumerate every
        # single-group fill).
        return None
    from karpenter_tpu_torch.ops import native

    if (
        not native.available()
        and int(vectors.shape[0])
        * min(int(capacity.shape[0]), mix_pack.TYPES_BUDGET)
        > 256
    ):
        # Without the native enumeration the numpy fallback is ~15x slower
        # and would outlast the fetch window at scale.
        return None
    pool_floor = np.where(
        np.isfinite(pool_prices), pool_prices, np.inf
    ).min(axis=1)
    feasible = (
        (capacity[None, :, :] >= vectors[:, None, :] - 1e-6).all(axis=2).any(axis=1)
    )
    solvable = np.where(feasible, counts, 0)
    unschedulable = counts - solvable
    if solvable.sum() == 0:
        return None
    rounds = mix_pack.mix_candidate(vectors, solvable, capacity, pool_floor)
    if rounds is None:
        return None
    return rounds, unschedulable


# Below this many pods a solve goes host-only: the host candidates (compiled
# FFD + the column-LP mix) answer faster than a device round trip with
# identical plans. The same defaults as the reference's never-calibrated
# gate; KARPENTER_HOST_SOLVE=0/1 forces the device/host path.
HOST_SOLVE_MAX_PODS = 10_000
# The batched path shares ONE device fetch across K schedules, so host
# solving there must clear a much lower bar.
HOST_SOLVE_MAX_PODS_BATCHED = 2_000


def cost_solve_host(
    vectors: np.ndarray,
    counts: np.ndarray,
    capacity: np.ndarray,
    total: np.ndarray,
    prices: np.ndarray,
    pool_prices: np.ndarray,
    explain: Optional[dict] = None,
) -> Optional[DenseSolveResult]:
    """Host-only cost solve for problems under HOST_SOLVE_MAX_PODS: the
    compiled-C++ greedy FFD (reference-parity guarantee — greedy is always
    among the candidates) plus the column-LP mix, scored identically to the
    device path's candidates. Returns None when the native library is
    unavailable — callers fall through to the device path."""
    from karpenter_tpu_torch.ops import native as native_mod

    ffd_result = native_mod.ffd_pack_rounds(
        vectors, counts.astype(np.int64), capacity, total, quirk=False
    )
    if ffd_result is None:
        return None
    SOLVE_DISPATCH_TOTAL.inc("host")
    mix_plan = compute_mix_candidate(
        vectors, counts, capacity, pool_prices, allow_single_group=True
    )
    return cost_solve_finish(
        None,
        vectors,
        counts,
        capacity,
        total,
        prices,
        pool_prices,
        mix_plan=mix_plan,
        host_candidates=[ffd_result],
        explain=explain,
    )


def host_solve_enabled(num_pods: int, batched: bool = False) -> bool:
    """Policy gate for the host path (KARPENTER_HOST_SOLVE=0 forces the
    device path, =1 forces host regardless of size). Requires the native
    library: without it cost_solve_host cannot run. batched=True applies the
    batch threshold."""
    from karpenter_tpu_torch.ops import native as native_mod

    flag = os.environ.get("KARPENTER_HOST_SOLVE", "").lower()
    if flag in ("0", "false", "off"):
        return False
    if not native_mod.available():
        return False
    if flag in ("1", "true", "on"):
        return True
    limit = HOST_SOLVE_MAX_PODS_BATCHED if batched else HOST_SOLVE_MAX_PODS
    return num_pods <= limit


# The fused solve's input dtypes, and which inputs are the fleet's (kept
# resident on the device across solves).
_FUSED_DTYPES = (np.float32, np.int32, np.float32, np.float32, np.bool_, np.float32)
_FLEET_RESIDENT = (False, False, True, True, True, True)


def cost_solve_dispatch(
    vectors, counts, capacity, total, prices, lp_steps: int = 300, device=None,
) -> FusedHandle:
    """Enqueue the fused solve on `device` (the card unless "cpu" is asked
    for); pair with a (batchable) fetch + cost_solve_finish. On the card the
    work is asynchronous and this returns before it finishes, with no host
    sync: the host overlap work starts while the card computes, and a batch
    of schedules shares one device->host round trip.

    Fleet-side arrays ride the device_resident cache: back-to-back solves
    over the same encoded fleet skip their host->device transfer. Pod
    tensors already on the device (the incremental encode's sorted gather)
    pass through untouched: no kernel writes into its inputs, so they stay
    readable after the solve. Whatever is left goes up in one packed copy."""
    SOLVE_DISPATCH_TOTAL.inc("device")
    device = resolve_device(device)
    padded = pad_kernel_args(vectors, counts, capacity, total, prices)
    args = device_resident(
        [
            array if isinstance(array, torch.Tensor) else np.asarray(array, dtype=dtype)
            for array, dtype in zip(padded, _FUSED_DTYPES)
        ],
        _FLEET_RESIDENT,
        device,
    )
    compact, objective, dense_ints, lp_flat = _cost_fused_body(*args, lp_steps=lp_steps)
    return FusedHandle(
        compact=compact,
        objective=objective,
        dense=dense_ints,
        lp=lp_flat,
        num_groups=int(padded[0].shape[0]),
        num_types=int(padded[2].shape[0]),
        staged=[],
    )


def _collect_candidates(fetched, num_groups: int, host_candidates, mix_plan):
    """Assemble the candidate pool for scoring — kernel outputs (decoded
    from the compacted fetch), host candidates, and the mix plan — in round
    form, with a parallel label list for explain output. Returns
    (candidates, labels, lp_supplier, feasible_any, lp_objective)."""
    lp_supplier = feasible_any = None
    lp_objective = np.inf
    candidates: List[Tuple[List[Tuple[int, np.ndarray, int]], np.ndarray]] = []
    labels: List[str] = []
    if fetched is not None:
        rounds_ffd = fetched.rounds_ffd
        rounds_cost = fetched.rounds_cost
        feasible_any = fetched.feasible_any
        lp_objective = fetched.lp_objective
        lp_supplier = fetched.lp_assignment
        for label, rounds in (("kernel_ffd", rounds_ffd), ("kernel_cost", rounds_cost)):
            if not bool(rounds.overflow):
                candidates.append(
                    (
                        _kernel_rounds_to_list(rounds, num_groups),
                        rounds.unschedulable[:num_groups],
                    )
                )
                labels.append(label)
    for index, host_candidate in enumerate(host_candidates or []):
        candidates.append(host_candidate)
        labels.append("host_ffd" if index == 0 else f"host_{index}")
    if mix_plan is not None:
        candidates.append(mix_plan)
        labels.append("mix")
    return candidates, labels, lp_supplier, feasible_any, lp_objective


def cost_solve_finish(
    fetched,
    vectors: np.ndarray,
    counts: np.ndarray,
    capacity: np.ndarray,
    total: np.ndarray,
    prices: np.ndarray,
    pool_prices: np.ndarray,
    mix_plan: Optional[
        Tuple[List[Tuple[int, np.ndarray, int]], np.ndarray]
    ] = None,
    host_candidates: Optional[
        List[Tuple[List[Tuple[int, np.ndarray, int]], np.ndarray]]
    ] = None,
    explain: Optional[dict] = None,
) -> Optional[DenseSolveResult]:
    """Host-side candidate scoring + LP realization over a fetched plan.
    fetched may be None (the cost_solve_host path): scoring then runs over
    host_candidates + mix_plan only. An `explain` dict, when passed, is
    filled with every scored candidate under "candidates"."""
    num_groups = int(vectors.shape[0])
    candidates, labels, lp_supplier, feasible_any, lp_objective = (
        _collect_candidates(fetched, num_groups, host_candidates, mix_plan)
    )

    # Score from rounds: a node's realized price is the cheapest of its
    # offered options. A candidate that leaves more pods unschedulable never
    # wins on price. Option sets are memoized per fill; the whole
    # distinct-fill set is selected in ONE native batch call up front.
    options_memo: Dict[bytes, Tuple[List[int], Optional[List[PoolRow]]]] = {}
    pool_order = sort_pool_rows(pool_prices)
    _batch_pool_options(candidates, vectors, capacity, pool_order, options_memo)

    def options_for(t: int, fill: np.ndarray):
        key = fill.tobytes()
        options = options_memo.get(key)
        if options is None:
            options = _cheapest_feasible_pools(
                fill, t, vectors, capacity, pool_prices, pool_order
            )
            options_memo[key] = options
        return options

    price_memo: Dict[bytes, float] = {}

    def round_price(t: int, fill: np.ndarray) -> float:
        """Expected realized price of one node: a geometric-decay weighted
        mean over the offered rows (PRIORITY_DECAY). Memoized per fill."""
        key = fill.tobytes()
        price = price_memo.get(key)
        if price is None:
            type_indices, pool_rows = options_for(t, fill)
            if pool_rows:
                row_prices = np.array([p for _, _, p in pool_rows])
                weights = PRIORITY_DECAY ** np.arange(len(row_prices))
                price = float((weights / weights.sum()) @ row_prices)
            else:
                # Degenerate: no pool anywhere can host this fill, and the
                # anchor t may be a padded phantom type index. Price it
                # unhostable — never cheap, never an IndexError.
                in_range = [i for i in type_indices if i < prices.shape[0]]
                price = (
                    float(prices[in_range].min()) if in_range else float("inf")
                )
            price_memo[key] = price
        return price

    def score(candidate):
        round_list, unschedulable_counts = candidate
        nodes = sum(repl for _, _, repl in round_list)
        cost = sum(
            repl * round_price(t, fill) for t, fill, repl in round_list
        )
        return (int(unschedulable_counts.sum()), cost, nodes)

    # The LP realization only adds fragmentation on top of the LP's relaxed
    # cost, so a kernel candidate clearly under the LP's fractional objective
    # skips it; only then is the deferred [G, T] assignment fetched.
    scores = {id(c): score(c) for c in candidates}
    best_kernel_cost = min(
        (s[1] for s in scores.values() if s[0] == 0), default=np.inf
    )
    if lp_supplier is not None and (
        not candidates
        or best_kernel_cost > float(lp_objective) * LP_REALIZE_SLACK
    ):
        lp_candidate = _realize_lp_dense(
            lp_supplier(), feasible_any, vectors, counts, capacity, total
        )
        if lp_candidate is not None:
            candidates.append(lp_candidate)
            labels.append("lp_realized")
            scores[id(lp_candidate)] = score(lp_candidate)
    if not candidates:
        return None

    def materialize(candidate) -> DenseSolveResult:
        rounds, unschedulable = candidate
        options: Dict[bytes, Tuple[List[int], Optional[List[PoolRow]]]] = {}
        for t, fill, _ in rounds:
            options[fill.tobytes()] = options_for(t, fill)
        return DenseSolveResult(
            rounds=rounds, unschedulable=unschedulable, options=options
        )

    if explain is not None:
        explain["candidates"] = [
            (label, materialize(candidate), scores[id(candidate)])
            for label, candidate in zip(labels, candidates)
        ]
    best = min(candidates, key=lambda c: scores[id(c)])
    return materialize(best)


def _batch_pool_options(
    candidates,
    vectors: np.ndarray,
    capacity: np.ndarray,
    pool_order,
    memo: Dict[bytes, Tuple[List[int], Optional[List[PoolRow]]]],
) -> None:
    """Pre-populate the per-fill options memo for every distinct fill across
    all candidates with one native ktpu_pool_select call (bit-identical to
    the per-fill _cheapest_feasible_pools walk). A missing native library
    leaves the memo empty — callers lazily fall back per fill."""
    from karpenter_tpu_torch.ops import native as native_mod

    row_types, row_zones, row_prices = pool_order
    if len(row_types) == 0:
        return
    distinct: Dict[bytes, Tuple[int, np.ndarray]] = {}
    for round_list, _ in candidates:
        for t, fill, _ in round_list:
            fill = np.asarray(fill)
            key = fill.tobytes()
            if key not in distinct and key not in memo:
                distinct[key] = (t, fill)
    if not distinct:
        return
    demand = np.stack(
        [fill for _, fill in distinct.values()]
    ).astype(np.float64) @ vectors
    out = native_mod.pool_select_batch(
        demand,
        capacity,
        row_types,
        row_prices,
        MAX_POOL_ROWS,
        MIN_POOL_ROWS,
        POOL_PRICE_BAND,
        MAX_POOL_PRICE_RATIO,
        ffd.MAX_INSTANCE_TYPES,
    )
    if out is None:
        return
    out_rows, out_counts = out
    for (key, (t, _)), selected, count in zip(
        distinct.items(), out_rows, out_counts
    ):
        if count < 0:
            memo[key] = ([int(t)], None)
            continue
        rows: List[PoolRow] = [
            (int(row_types[i]), int(row_zones[i]), float(row_prices[i]))
            for i in selected[:count]
        ]
        chosen: List[int] = []
        seen_types: set = set()
        for type_index, _, _ in rows:
            if type_index not in seen_types:
                seen_types.add(type_index)
                chosen.append(type_index)
        memo[key] = (chosen, rows)


def _realize_lp_dense(
    lp_assignment: np.ndarray,
    feasible_any: np.ndarray,
    vectors: np.ndarray,
    counts: np.ndarray,
    capacity: np.ndarray,
    total: np.ndarray,
) -> Optional[Tuple[List[Tuple[int, np.ndarray, int]], np.ndarray]]:
    """Integerize the relaxed [G, T] assignment (already fetched to host)
    and realize it as greedy per-type node fills."""
    num = int(vectors.shape[0])
    counts = counts.astype(np.int64)
    unschedulable_counts = np.where(feasible_any[:num], 0, counts)
    solvable_counts = np.where(feasible_any[:num], counts, 0)
    if solvable_counts.sum() == 0:
        return None
    padded_solvable = np.zeros(lp_assignment.shape[0], dtype=np.int64)
    padded_solvable[:num] = solvable_counts
    # Concentrate before rounding: keep each group's heaviest types (up to 8)
    # and renormalize — the realized node count drops sharply at negligible
    # objective cost.
    lp_assignment = np.asarray(lp_assignment, dtype=np.float64).copy()
    for g in range(num):
        row = lp_assignment[g]
        total_mass = row.sum()
        if total_mass <= 0:
            continue
        keep = np.argsort(-row)[:8]
        kept = np.zeros_like(row)
        kept[keep] = row[keep]
        kept_mass = kept.sum()
        if kept_mass > 0:
            lp_assignment[g] = kept * (total_mass / kept_mass)
    assignment = round_assignment(lp_assignment, padded_solvable)

    # Realize the plan: per type, greedily fill nodes (pure greedy, no
    # quirk) with that type's assigned pods. The compiled path does all
    # types in one call; pure Python below is the no-toolchain fallback.
    from karpenter_tpu_torch.ops import native

    native_rounds = native.lp_realize(
        vectors, assignment[:num, : capacity.shape[0]], capacity, total
    )
    if native_rounds is native.INFEASIBLE:
        return None  # proven unrealizable — don't redo the work in Python
    if native_rounds is not None:
        return native_rounds, unschedulable_counts

    round_list: List[Tuple[int, np.ndarray, int]] = []
    num_types = int(capacity.shape[0])
    for t in range(num_types):
        counts_t = assignment[:num, t].astype(np.int64).copy()
        guard = 0
        while counts_t.sum() > 0:
            fill = ffd.fill_node(
                capacity[t],
                total[t],
                vectors,
                counts_t,
                quirk=False,
            )
            if fill.sum() == 0:
                return None  # should not happen (feasibility pre-checked)
            repl_per_group = np.where(
                fill > 0, counts_t // np.maximum(fill, 1), np.iinfo(np.int64).max
            )
            repl = max(1, int(repl_per_group.min()))
            round_list.append((t, fill.copy(), repl))
            counts_t -= repl * fill
            guard += 1
            if guard > 4 * num + 16:
                return None
    return round_list, unschedulable_counts


# --- device-memory survival --------------------------------------------------
#
# A batch of schedules can exceed device memory even though every schedule
# fits alone: the batched path dispatches all K fused solves before the
# first fetch, so their [G, T] LP states are live together. Rather than let
# one oversized sweep crash provisioning, CostSolver bisects on an
# allocation failure and re-dispatches the halves — each half re-runs the
# identical per-schedule math, so the recovered plans are bit-identical to
# the unsplit solve.

# Markers scanned (case-insensitively) over the error text: the injected
# fault says RESOURCE_EXHAUSTED, torch's allocator "CUDA out of memory".
_RESOURCE_EXHAUSTED_MARKERS = (
    "resource_exhausted",
    "out of memory",
    "failed to allocate",
)


def _is_resource_exhausted(error: BaseException) -> bool:
    """True when `error` is a device allocation failure — the recoverable
    kind the bisect ladder retries: torch's CUDA out-of-memory error, or an
    error whose text carries one of the markers (the injected fault)."""
    if isinstance(error, torch.cuda.OutOfMemoryError):
        return True
    text = f"{type(error).__name__}: {error}".lower()
    return any(marker in text for marker in _RESOURCE_EXHAUSTED_MARKERS)


# Live [G, T] float32 copies per in-flight solve: LP assignment + Adam m/v +
# gradient + softmax activations + compaction scratch. A deliberate
# overestimate — the pre-split only has to be conservative enough that the
# bisect path stays the rare fallback, not a per-sweep tax.
_LIVE_TENSOR_COPIES = 6
# Fraction of the device budget the pre-split packs to — headroom for the
# runtime's own allocations and fetch staging buffers.
HBM_SAFETY_FACTOR = 0.8


def _hbm_budget_bytes(device=None) -> Optional[float]:
    """Device memory budget for the pre-dispatch estimator, or None to skip
    pre-splitting (the CPU reports no limit — the bisect ladder still covers
    it). KARPENTER_HBM_BYTES overrides for tests; else the card's total
    memory (torch.cuda.mem_get_info)."""
    raw = os.environ.get("KARPENTER_HBM_BYTES", "")
    if raw:
        try:
            return float(raw)
        except ValueError:
            return None
    device = torch.device("cpu" if device is None else device)
    if device.type != "cuda":
        return None
    return float(torch.cuda.mem_get_info(device)[1])


def _estimate_solve_bytes(groups: PodGroups, fleet: InstanceFleet) -> float:
    """Rough HBM footprint of one schedule's fused solve: the padded [G, T]
    LP tensors dominate (the dense plan state is [MR, G] int8 — noise next
    to float32 [G, T] at scale). Bucketed dims, because that's what the
    kernel actually allocates."""
    g = bucket_size(max(1, int(groups.num_groups)))
    t = bucket_size(max(1, int(fleet.num_types)))
    return float(g) * float(t) * 4.0 * _LIVE_TENSOR_COPIES


def _presplit_for_hbm(
    items: Sequence[Tuple[PodGroups, InstanceFleet]],
    device=None,
) -> List[List[Tuple[PodGroups, InstanceFleet]]]:
    """Greedily chunk a batch so each chunk's estimated footprint fits the
    device budget — the cheap pre-check that spares the common oversized
    sweep a guaranteed OOM + bisect round trip. One chunk (no split) when
    the budget is unknown or everything fits."""
    budget = _hbm_budget_bytes(device)
    if budget is None or len(items) <= 1:
        return [list(items)]
    cap = budget * HBM_SAFETY_FACTOR
    chunks: List[List[Tuple[PodGroups, InstanceFleet]]] = []
    current: List[Tuple[PodGroups, InstanceFleet]] = []
    current_bytes = 0.0
    for item in items:
        cost = _estimate_solve_bytes(*item)
        if current and current_bytes + cost > cap:
            chunks.append(current)
            current, current_bytes = [], 0.0
        current.append(item)
        current_bytes += cost
    chunks.append(current)
    return chunks


def _maybe_inject_device_oom() -> None:
    """The solver.dispatch faultpoint: chaos harnesses arm "oom" here to
    prove the bisect ladder recovers (count=N forces N failures, i.e. N
    split depths, before a dispatch goes through)."""
    from karpenter_tpu_torch.utils import faultpoints

    if faultpoints.draw("solver.dispatch") is not None:
        raise RuntimeError(
            "RESOURCE_EXHAUSTED: injected device allocation failure "
            "(faultpoint solver.dispatch)"
        )


class CostSolver(Solver):
    """The flagship: runs pure-greedy FFD, cost-greedy, and the LP-relaxation
    plan on the device, returns the cheapest feasible packing. Because greedy
    is always among the candidates, projected $/hr can only match or beat
    the baseline. Thin object shell over cost_solve_dense.

    device=None runs on the CUDA card and raises without one; "cpu" runs
    the kernels' plain PyTorch versions."""

    needs_device_warmup = True

    def __init__(self, lp_steps: int = 300, device=None):
        self.lp_steps = lp_steps
        self.device = resolve_device(device)

    def solve_encoded(
        self,
        groups: PodGroups,
        fleet: InstanceFleet,
        explain: Optional[dict] = None,
    ) -> ffd.PackResult:
        if fleet.num_types == 0 or groups.num_groups == 0:
            return ffd.pack_groups(fleet, groups)

        # The matrix build is handed down as a thunk so it runs while the
        # fused solve computes on the device.
        pool_zones: Optional[List[str]] = None

        def pool_prices_fn():
            nonlocal pool_zones
            pool_zones, matrix = _pool_price_matrix(fleet)
            return matrix

        dense = cost_solve_dense(
            groups.vectors,
            groups.counts,
            fleet.capacity,
            fleet.total,
            fleet.prices,
            pool_prices_fn,
            lp_steps=self.lp_steps,
            explain=explain,
            device=self.device,
            device_pods=device_pod_args(groups),
        )
        if dense is None:
            return ffd.pack_groups(fleet, groups)
        if pool_zones is None:
            raise AssertionError(
                "cost_solve_dense returned a plan without evaluating pool_prices"
            )
        return decode_dense_result(dense, groups, fleet, pool_zones)

    def _dispatch_batch(self, items, batched: Optional[bool] = None):
        """Shared first stage of the batched and pipelined paths: host-solve
        or dispatch every schedule (async, device->host copies queued), and
        start ONE overlap worker for the pending schedules' host work.
        Returns (results, pending, zones_box, overlap) where `results` holds
        the already-finished slots and pending the in-flight ones.

        `batched` pins the host-gate threshold independently of len(items):
        the OOM bisect re-dispatches HALVES of a batch, and a singleton half
        re-gated as unary would flip host/device routing — the recovered
        plan must be bit-identical to the unsplit solve's."""
        if batched is None:
            batched = len(items) > 1
        results: List[Optional[ffd.PackResult]] = [None] * len(items)
        pending = []  # (index, groups, fleet, fused, prebuilt_pool)
        for i, (groups, fleet) in enumerate(items):
            if fleet.num_types == 0 or groups.num_groups == 0:
                results[i] = ffd.pack_groups(fleet, groups)
                continue
            prebuilt_pool = None  # (zones, matrix) when the host gate ran
            if host_solve_enabled(int(groups.counts.sum()), batched=batched):
                # Small schedule: the host path answers in milliseconds —
                # cheaper than even a SHARED device fetch's slice of work.
                # A single-item "batch" has no fetch to amortize, so it uses
                # the unary threshold.
                prebuilt_pool = _pool_price_matrix(fleet)
                dense = cost_solve_host(
                    groups.vectors,
                    groups.counts,
                    fleet.capacity,
                    fleet.total,
                    fleet.prices,
                    prebuilt_pool[1],
                )
                if dense is not None:
                    results[i] = decode_dense_result(
                        dense, groups, fleet, prebuilt_pool[0]
                    )
                    continue
            pod_vectors, pod_counts = device_pod_args(groups) or (
                groups.vectors,
                groups.counts,
            )
            fused = cost_solve_dispatch(
                pod_vectors,
                pod_counts,
                fleet.capacity,
                fleet.total,
                fleet.prices,
                self.lp_steps,
                device=self.device,
            )
            plan_start_fetch(fused)
            pending.append((i, groups, fleet, fused, prebuilt_pool))

        overlap = None
        zones_box: List[Optional[List[str]]] = [None] * len(pending)
        if pending:
            # Per-schedule host work (pool matrices + mix candidates) runs in
            # a worker thread concurrently with the blocking fetches, exactly
            # like the single-solve path. The thunks stash each fleet's zone
            # axis so the finish loop doesn't rebuild it, and reuse a matrix
            # the host-gate branch already built (rare fallthrough: native
            # overflow after the gate passed).
            def _matrix_thunk(
                fleet: InstanceFleet, slot: int, prebuilt
            ) -> np.ndarray:
                zones, matrix = prebuilt or _pool_price_matrix(fleet)
                zones_box[slot] = zones
                return matrix

            overlap = _HostOverlap(
                [
                    (
                        groups.vectors,
                        groups.counts,
                        fleet.capacity,
                        functools.partial(_matrix_thunk, fleet, k, prebuilt),
                    )
                    for k, (_, groups, fleet, _, prebuilt) in enumerate(pending)
                ]
            ).start()
        return results, pending, zones_box, overlap

    def _finish_one(self, entry, zones, pool_prices, mix_plan, plan):
        """Score + decode one pending schedule from its fetched plan."""
        _, groups, fleet, _, _ = entry
        dense = cost_solve_finish(
            plan,
            groups.vectors,
            groups.counts,
            fleet.capacity,
            fleet.total,
            fleet.prices,
            pool_prices,
            mix_plan=mix_plan,
        )
        return (
            ffd.pack_groups(fleet, groups)
            if dense is None
            else decode_dense_result(dense, groups, fleet, zones)
        )

    def solve_encoded_many(
        self, items: Sequence[Tuple[PodGroups, InstanceFleet]]
    ) -> List[ffd.PackResult]:
        """Batch path: dispatch every schedule's fused kernel first (async),
        build all pool matrices while the device works, then fetch ALL
        compacted payloads in one device->host transfer — K schedules cost
        one round trip instead of K (the round trip dominates on tunneled
        devices). Rides the OOM-survival ladder: oversized batches are
        pre-split by the HBM estimator, and a live RESOURCE_EXHAUSTED
        bisects and re-dispatches instead of crashing the sweep."""
        return self._solve_batch_survive(list(items), batched=len(items) > 1)

    def _solve_batch_fetch(
        self,
        items: Sequence[Tuple[PodGroups, InstanceFleet]],
        batched: bool,
    ) -> List[ffd.PackResult]:
        """One dispatch->fetch->finish round for `items` — the unit the
        bisect retries. Raises (RESOURCE_EXHAUSTED included) instead of
        falling back; _solve_batch_survive owns recovery."""
        results, pending, zones_box, overlap = self._dispatch_batch(
            items, batched=batched
        )
        if pending:
            _maybe_inject_device_oom()
            plans = fetch_plans([entry[3] for entry in pending])
            pool_matrices, mix_plans = overlap.join()
            for entry, zones, pool_prices, mix_plan, plan in zip(
                pending, zones_box, pool_matrices, mix_plans, plans
            ):
                results[entry[0]] = self._finish_one(
                    entry, zones, pool_prices, mix_plan, plan
                )
        return results

    def _solve_batch_survive(
        self,
        items: List[Tuple[PodGroups, InstanceFleet]],
        batched: bool,
        depth: int = 0,
    ) -> List[ffd.PackResult]:
        """Device-memory survival ladder around the batched solve:

        1. depth 0 pre-splits by the HBM estimator — a batch whose estimated
           footprint exceeds the device budget never reaches the device
           whole (reason="estimate").
        2. A RESOURCE_EXHAUSTED from dispatch/fetch bisects the batch and
           re-dispatches the halves sequentially (reason="oom") — each half
           re-runs the identical per-schedule math under the ORIGINAL
           batched gate, so recovered plans are bit-identical to the
           unsplit solve's.
        3. A singleton that still OOMs is the floor (reason="floor"):
           answer from the host path, counted and logged — degraded
           latency, never a crash.

        Any non-memory error propagates unchanged: retrying a batch around
        a logic error would just re-fail, and the caller's fallback ladder
        owns those.
        """
        if not items:
            return []
        if depth == 0:
            chunks = _presplit_for_hbm(items, self.device)
            if len(chunks) > 1:
                SOLVER_BATCH_SPLIT_TOTAL.inc("estimate", amount=len(chunks) - 1)
                klog.named("solver").info(
                    "HBM estimator pre-split solve batch: %d schedules -> "
                    "%d chunks", len(items), len(chunks),
                )
                out: List[ffd.PackResult] = []
                for chunk in chunks:
                    out.extend(self._solve_batch_survive(chunk, batched, depth=1))
                return out
        try:
            return self._solve_batch_fetch(items, batched)
        except Exception as error:  # noqa: BLE001 — classifier gates the catch
            if not _is_resource_exhausted(error):
                raise
            if len(items) == 1:
                SOLVER_BATCH_SPLIT_TOTAL.inc("floor")
                klog.named("solver").warning(
                    "single schedule exhausted device memory (%s); "
                    "answering from the host path", error,
                )
                return [self._floor_solve(*items[0])]
            SOLVER_BATCH_SPLIT_TOTAL.inc("oom")
            mid = len(items) // 2
            klog.named("solver").warning(
                "device memory exhausted (%s); bisecting %d-schedule batch "
                "at depth %d", error, len(items), depth + 1,
            )
            # Sequential, not parallel: the halves must not be in flight
            # together — co-residency is exactly what just OOMed.
            return self._solve_batch_survive(
                items[:mid], batched, depth=depth + 1
            ) + self._solve_batch_survive(
                items[mid:], batched, depth=depth + 1
            )

    @staticmethod
    def _floor_solve(groups: PodGroups, fleet: InstanceFleet) -> ffd.PackResult:
        """The bisect floor's answer: host cost solve (compiled FFD + mix
        candidates — same scoring as the device candidates), or plain FFD
        when the native library is absent. Cannot touch the device, so it
        cannot re-OOM."""
        zones, matrix = _pool_price_matrix(fleet)
        dense = cost_solve_host(
            groups.vectors, groups.counts, fleet.capacity,
            fleet.total, fleet.prices, matrix,
        )
        if dense is None:
            return ffd.pack_groups(fleet, groups)
        return decode_dense_result(dense, groups, fleet, zones)

    def solve_encoded_pipelined(
        self, items: Sequence[Tuple[PodGroups, InstanceFleet]]
    ) -> Iterator[ffd.PackResult]:
        """The solve->bind pipeline: every schedule's kernel is dispatched
        and its compacted device->host copy queued UP FRONT (double-buffered
        — the copies stream behind the kernels on the device queue), then
        results yield in schedule order. While the caller binds/launches
        result N, schedules N+1.. are still computing and copying; each
        fetch here finds its payload already staged instead of starting a
        round trip.

        Dispatch happens EAGERLY at the call (not at the first pull): the
        caller's dispatch-stage timing stays honest, and the device starts
        working before the first bind regardless of when iteration
        begins."""
        results, pending, zones_box, overlap = self._dispatch_batch(items)

        def _results() -> Iterator[ffd.PackResult]:
            next_pending = 0
            # After a mid-stream RESOURCE_EXHAUSTED, the not-yet-fetched
            # tail is re-solved through the bisect ladder; `recovered`
            # holds those plans, indexed from pending slot `recovered_base`.
            recovered: Optional[List[ffd.PackResult]] = None
            recovered_base = 0
            for i in range(len(items)):
                if results[i] is not None:
                    yield results[i]
                    continue
                entry = pending[next_pending]
                k = next_pending
                next_pending += 1
                if recovered is not None:
                    yield recovered[k - recovered_base]
                    continue
                # Wait for THIS schedule's host work only — later schedules'
                # mix candidates keep computing while this one decodes/binds.
                overlap.wait(k)
                try:
                    _maybe_inject_device_oom()
                    plan = fetch_plan(entry[3])
                except Exception as error:  # noqa: BLE001 — classifier gates
                    if not _is_resource_exhausted(error):
                        raise
                    # The in-flight tail just proved it doesn't fit next to
                    # whatever else holds HBM: abandon those handles and
                    # re-solve pending[k:] through the bisect ladder, under
                    # the SAME batched gate so plans stay bit-identical.
                    SOLVER_BATCH_SPLIT_TOTAL.inc("oom")
                    klog.named("solver").warning(
                        "device memory exhausted mid-pipeline (%s); "
                        "re-solving %d remaining schedules via bisect",
                        error, len(pending) - k,
                    )
                    recovered = self._solve_batch_survive(
                        [(e[1], e[2]) for e in pending[k:]],
                        batched=len(items) > 1,
                        depth=1,
                    )
                    recovered_base = k
                    yield recovered[0]
                    continue
                yield self._finish_one(
                    entry, zones_box[k], overlap.pool_prices[k],
                    overlap.mix_plans[k], plan,
                )

        return _results()


def decode_dense_result(
    dense: DenseSolveResult,
    groups: PodGroups,
    fleet: InstanceFleet,
    zones: List[str],
) -> ffd.PackResult:
    """Rehydrate a DenseSolveResult into a PackResult on the object-holding
    side of the solver boundary."""

    def options_fn(t: int, fill: np.ndarray):
        type_indices, rows = dense.options[fill.tobytes()]
        return type_indices, pool_rows_to_options(rows, fleet, zones)

    return _decode_rounds(
        dense.rounds, dense.unschedulable, groups, fleet, options_fn=options_fn
    )
