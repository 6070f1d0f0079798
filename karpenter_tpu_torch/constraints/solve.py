"""Constrained solve: one [L, G, T] dispatch, then domain-aware decode.

The execution layer over the compiler (constraints/compiler.py): pad the
compiled tensors, upload them in one packed copy, run EVERY relaxation level
in one dispatch (ops/pack_kernel.pack_kernel_levels on the device solver's
device: K6 on the card, its plain version on the CPU; on a mesh K6 on every
shard over its block of levels; the numpy mirror on host solvers), fetch the
result once, then decode the chosen level's rounds into
Packings whose launch pools are pinned to each node's spread domain / ladder
zone envelope — replacing both the serialized Topology.inject pre-pass and
the host-side relax-retry loop with a single solve whose decode names the
chosen relaxation level per group.

Zone-keyed domains realize as pool pinning (the launch lands in the domain);
custom-label domains realize as node labels stamped at registration
(ffd.Packing.node_labels) — fresh nodes are born into their domain, which is
strictly more than the reference's "existing zones only" spread.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.pods import PodSpec
from karpenter_tpu_torch.constraints.compiler import (
    CompiledConstraints,
    CompilerCache,
    compile_constraints,
    shared_cache,
)
from karpenter_tpu_torch.constraints.mirror import pack_levels_host
from karpenter_tpu_torch.convert import upload_packed
from karpenter_tpu_torch.ops import ffd
from karpenter_tpu_torch.ops.encode import InstanceFleet, build_fleet, group_pods
from karpenter_tpu_torch.ops.pack_kernel import (
    NODE_CAP_NONE,
    bucket_size,
    level_pack_to_host,
    pack_kernel_levels,
    pad_to,
)
from karpenter_tpu_torch.utils.metrics import REGISTRY

# Which relaxation level constrained solves land on — a rising count at
# level > 0 means preferences are routinely unsatisfiable (capacity does not
# match what workloads prefer), the signal the reference could never surface
# because its relaxation was scattered across retries.
CONSTRAINT_LEVEL_TOTAL = REGISTRY.counter(
    "constraint_solve_level_total",
    "Constrained solves by kernel-chosen relaxation level",
    ["level"],
)
CONSTRAINT_DISPATCH_TOTAL = REGISTRY.counter(
    "constraint_dispatch_total",
    "Constrained solves by dispatch path (kernel|mirror)",
    ["path"],
)


@dataclass
class ConstraintDecision:
    """What the [L, G, T] dispatch decided, for bookkeeping: the schedule's
    chosen level plus per-base-group first-feasible levels. The selection
    controller's TTL cache records pod_levels instead of driving retries."""

    chosen_level: int
    group_levels: List[int]  # per base group (min over its sub-groups)
    pod_levels: Dict[str, int] = field(default_factory=dict)  # uid -> level
    description: str = ""


def _solve_mode(solver) -> str:
    mode = getattr(solver, "mode", None)
    if mode in ("ffd", "cost"):
        return mode
    return "cost" if getattr(solver, "needs_device_warmup", False) else "ffd"


def pad_levels(compiled: CompiledConstraints, fleet: InstanceFleet) -> List[np.ndarray]:
    """The [L, G, T] dispatch's operands, padded to their buckets, in
    pack_kernel_levels' order and dtypes: vectors, level counts, capacity,
    total, valid, prices, allow, penalty, conflict, node caps."""
    num_sub = compiled.num_subgroups
    num_levels = compiled.num_levels
    g_pad = bucket_size(max(num_sub, 1))
    t_pad = bucket_size(max(fleet.num_types, 1))
    l_pad = bucket_size(max(num_levels, 1), minimum=1)

    vectors = pad_to(compiled.vectors, g_pad)
    counts = pad_to(pad_to(compiled.level_counts, g_pad, axis=1), l_pad)
    # Padded levels repeat the last real level: identical totals, and the
    # strictest-first argmin can never pick a phantom level over a real one.
    if l_pad > num_levels:
        counts[num_levels:] = counts[num_levels - 1]
    allow = pad_to(pad_to(compiled.allow, g_pad, axis=1), t_pad, axis=2)
    allow = pad_to(allow, l_pad)
    penalty = pad_to(pad_to(compiled.penalty, g_pad, axis=1), t_pad, axis=2)
    penalty = pad_to(penalty, l_pad)
    if l_pad > num_levels:
        allow[num_levels:] = allow[num_levels - 1]
        penalty[num_levels:] = penalty[num_levels - 1]
    conflict = pad_to(pad_to(compiled.conflict, g_pad), g_pad, axis=1)
    node_cap = pad_to(compiled.node_cap, g_pad, value=NODE_CAP_NONE)
    capacity = pad_to(fleet.capacity, t_pad)
    total = pad_to(fleet.total, t_pad)
    valid = pad_to(np.ones(fleet.num_types, bool), t_pad)
    prices = pad_to(fleet.prices, t_pad)
    return [
        vectors.astype(np.float32), counts.astype(np.int32), capacity.astype(np.float32),
        total.astype(np.float32), valid.astype(bool), prices.astype(np.float32),
        allow.astype(bool), penalty.astype(np.float32), conflict.astype(bool),
        node_cap.astype(np.int32),
    ]


def _dispatch_kernel(compiled: CompiledConstraints, fleet: InstanceFleet, mode: str, device):
    """Pad and run the [L, G, T] dispatch for `device` (the solver's). On
    one device: one packed upload, K6 once, one device->host fetch. On a
    mesh (models/solver.constrained_level_hook): each shard runs K6 on its
    block of levels, then the cross-level selection and the fetch of the
    chosen level from the shard that holds it."""
    from karpenter_tpu_torch.models.solver import constrained_level_hook

    num_sub = compiled.num_subgroups
    dispatch, shards = constrained_level_hook(device=device)
    operands = pad_levels(compiled, fleet)
    try:
        if dispatch is None:
            host = level_pack_to_host(pack_kernel_levels(*upload_packed(operands, device), mode=mode))
        else:
            host = dispatch(operands, mode)
    except Exception as error:  # noqa: BLE001 — quarantine, then re-raise
        # Same hook as fetch_plans: the dispatch is asynchronous, so a card
        # that dies during the level-sharded solve surfaces at this fetch.
        # The quarantine shrinks the mesh for the NEXT constrained dispatch
        # (the pods stay pending and heal through that sweep).
        if shards > 1:
            from karpenter_tpu_torch.models.solver import quarantine_devices

            quarantine_devices(error, torch.device(device).type)
        raise
    num_rounds = min(int(host.rounds.num_rounds), int(host.rounds.round_type.shape[0]))
    rounds = [
        (
            int(host.rounds.round_type[r]),
            host.rounds.round_fill[r, :num_sub],
            int(host.rounds.round_repl[r]),
        )
        for r in range(num_rounds)
    ]
    return (
        rounds,
        host.rounds.unschedulable[:num_sub],
        int(host.chosen_level),
        host.group_level[:num_sub],
        bool(host.rounds.overflow),
        shards,
    )


def _dispatch_mirror(compiled: CompiledConstraints, fleet: InstanceFleet, mode: str):
    pack = pack_levels_host(
        compiled.vectors,
        compiled.level_counts,
        fleet.capacity,
        np.ones(fleet.num_types, bool),
        fleet.prices,
        compiled.allow,
        compiled.penalty,
        compiled.conflict,
        compiled.node_cap,
        mode=mode,
    )
    num_sub = compiled.num_subgroups
    return (
        pack.rounds,
        pack.unschedulable[:num_sub],
        int(pack.chosen_level),
        pack.group_level[:num_sub],
        pack.overflow,
        1,
    )


def decode_constrained(
    rounds: List[Tuple[int, np.ndarray, int]],
    unschedulable: np.ndarray,
    compiled: CompiledConstraints,
    level: int,
    fleet: InstanceFleet,
) -> ffd.PackResult:
    """Chosen-level rounds -> Packings with domain-pinned launch pools.

    Mirrors models/solver._decode_rounds (lazy member windows, merge by
    option key) plus the constraint realization: every sub-group active in a
    round shares one domain (the conflict matrix forbade mixing), so the
    round's pools pin to the intersection of its sub-groups' allowed zones,
    and custom-key domains stamp node labels."""
    from karpenter_tpu_torch.models.solver import _pool_price_matrix, sort_pool_rows

    level = min(level, compiled.num_levels - 1)
    members = compiled.members[level]
    num_sub = compiled.num_subgroups
    zones, pool_prices = _pool_price_matrix(fleet)
    pool_order = sort_pool_rows(pool_prices)

    cursors = [0] * num_sub
    by_key: Dict[Tuple, ffd.Packing] = {}
    packings: List[ffd.Packing] = []
    unsched_pods: List[PodSpec] = []
    for t, fill, repl in rounds:
        fill = np.asarray(fill)[:num_sub]  # vet: host-array(decode runs on fetched rounds)
        active = np.nonzero(fill > 0)[0]
        if active.size == 0:
            continue
        zone_restrict, node_labels = _round_realization(compiled, level, active)
        options, pool_opts = _round_pools(
            fill, t, compiled, fleet, zones, pool_prices, pool_order, zone_restrict
        )
        repl = int(repl)
        if options is None:
            # No pool survives the round's hard zone pin: the pods stay
            # pending and heal through a later sweep's fresh compile.
            for sub in active:
                sub, n = int(sub), int(fill[sub]) * repl
                unsched_pods.extend(members[sub][cursors[sub] : cursors[sub] + n])
                cursors[sub] += n
            continue
        slices = []
        for sub in active:
            sub, n = int(sub), int(fill[sub])
            slices.append((sub, cursors[sub], n))
            cursors[sub] += n * repl
        key = (
            tuple(it.name for it in options),
            tuple((p.instance_type.name, p.zone) for p in pool_opts)
            if pool_opts
            else None,
            tuple(sorted(node_labels.items())),
        )
        existing = by_key.get(key)
        if existing is not None:
            existing.node_quantity += repl
            existing.pods_per_node.add_segment(repl, slices)
        else:
            lazy = ffd.LazyNodePods(members)
            lazy.add_segment(repl, slices)
            packing = ffd.Packing(
                pods_per_node=lazy,
                instance_type_options=list(options),
                node_quantity=repl,
                pool_options=pool_opts,
                node_labels=dict(node_labels) or None,
            )
            by_key[key] = packing
            packings.append(packing)

    for sub in np.nonzero(np.asarray(unschedulable)[:num_sub] > 0)[0]:  # vet: host-array(decode runs on fetched rounds)
        sub = int(sub)
        n = int(unschedulable[sub])
        unsched_pods.extend(members[sub][cursors[sub] : cursors[sub] + n])
        cursors[sub] += n
    return ffd.PackResult(packings=packings, unschedulable=unsched_pods)


def _round_realization(compiled: CompiledConstraints, level: int, active):
    """(zone restriction, node labels) of one round: every active sub-group
    shares a domain (the conflict matrix forbade mixing), so zone pins
    intersect and custom-key domains stamp labels."""
    zone_sets = compiled.zone_sets[level]
    zone_restrict = None
    node_labels: Dict[str, str] = {}
    for sub in active:
        zs = zone_sets[int(sub)]
        if zs is not None:
            zone_restrict = zs if zone_restrict is None else zone_restrict & zs
        domain = compiled.sub_domain[int(sub)]
        if (
            domain is not None
            and compiled.spread_key
            and compiled.spread_key != wellknown.ZONE_LABEL
        ):
            node_labels[compiled.spread_key] = domain
    return zone_restrict, node_labels


def _round_pools(
    fill, t, compiled, fleet, zones, pool_prices, pool_order, zone_restrict
):
    """Price-ranked launch options for one round, pinned to its zone
    restriction. (None, None) when no pool survives the pin (e.g. the
    pinned zones are in the ICE blackout): the round must NOT launch
    unpinned — that would land in a domain the chosen level's spread or
    anti-affinity forbids — so its pods stay pending instead."""
    from karpenter_tpu_torch.models.solver import (
        _cheapest_feasible_pools,
        pool_rows_to_options,
    )

    rows = None
    if zone_restrict is not None and len(zone_restrict) < len(zones):
        pinned = pool_prices.copy()
        for j, z in enumerate(zones):
            if z not in zone_restrict:
                pinned[:, j] = np.inf
        if not np.isfinite(pinned).any():
            return None, None
        type_indices, rows = _cheapest_feasible_pools(
            fill, t, compiled.vectors, fleet.capacity, pinned
        )
    else:
        type_indices, rows = _cheapest_feasible_pools(
            fill, t, compiled.vectors, fleet.capacity, pool_prices, pool_order
        )
    options = [fleet.instance_types[i] for i in type_indices]
    return options, pool_rows_to_options(rows, fleet, zones)


def _dropped_pods(
    compiled: CompiledConstraints, groups, chosen: int
) -> List[PodSpec]:
    """Pods absent from EVERY sub-group's counts at the chosen level — e.g.
    anti-affinity excluded every spread domain, so the level filler's
    water-fill took zero pods. They never reached the kernel, whose
    unschedulable column only covers counted-but-unpacked pods; without this
    they would vanish from the result (neither packed nor reported) while
    still being recorded as solved. The filler assigns each group's pod list
    in order, so the dropped remainder is the tail past the level's total."""
    level = min(chosen, compiled.num_levels - 1)
    level_totals = [0] * groups.num_groups
    for sub, base in enumerate(compiled.sub_base):
        level_totals[base] += int(compiled.level_counts[level, sub])
    dropped: List[PodSpec] = []
    for g in range(groups.num_groups):
        dropped.extend(groups.members[g][level_totals[g]:])
    return dropped


def solve_constrained(
    solver,
    schedule,
    instance_types,
    daemons: Sequence[PodSpec] = (),
    cluster=None,
    cache: Optional[CompilerCache] = None,
    epoch: Optional[int] = None,
) -> Tuple[ffd.PackResult, ConstraintDecision]:
    """Solve one compiled schedule end-to-end: compile -> [L, G, T] dispatch
    -> domain-pinned decode. Device-backed solvers run the jitted kernel;
    host solvers run the bit-identical numpy mirror."""
    groups = group_pods(list(schedule.pods))
    pods_need = (
        groups.vectors.max(axis=0) if groups.num_groups else None
    )
    fleet = build_fleet(
        instance_types, schedule.constraints, schedule.pods, daemons,
        pods_need=pods_need,
    )
    trivial = ConstraintDecision(
        chosen_level=0, group_levels=[0] * groups.num_groups
    )
    if fleet.num_types == 0 or groups.num_groups == 0:
        return ffd.pack_groups(fleet, groups), trivial

    compiled = compile_constraints(
        schedule, groups, fleet, cluster,
        cache=cache or shared_cache(), epoch=epoch,
    )
    if compiled.num_subgroups == 0:
        return ffd.pack_groups(fleet, groups), trivial

    mode = _solve_mode(solver)
    if getattr(solver, "needs_device_warmup", False):
        CONSTRAINT_DISPATCH_TOTAL.inc("kernel")
        rounds, unsched, chosen, group_level, overflow, _ = _dispatch_kernel(
            compiled, fleet, mode, solver.device
        )
    else:
        CONSTRAINT_DISPATCH_TOTAL.inc("mirror")
        rounds, unsched, chosen, group_level, overflow, _ = _dispatch_mirror(
            compiled, fleet, mode
        )
    if overflow:
        # Static round budget exhausted — impossible by construction, but a
        # partial plan must never launch, and neither may an UNCONSTRAINED
        # greedy re-pack (it would drop the very masks/conflicts this solve
        # exists to enforce). The pods stay pending and heal through the
        # next sweep's fresh compile.
        return (
            ffd.PackResult(packings=[], unschedulable=list(schedule.pods)),
            trivial,
        )

    result = decode_constrained(rounds, unsched, compiled, chosen, fleet)
    dropped = _dropped_pods(compiled, groups, chosen)
    result.unschedulable.extend(dropped)
    dropped_uids = {pod.uid for pod in dropped}
    base_levels = [compiled.num_levels] * groups.num_groups
    for sub, level in enumerate(group_level):
        base = compiled.sub_base[sub]
        base_levels[base] = min(base_levels[base], int(level))
    decision = ConstraintDecision(
        chosen_level=chosen,
        group_levels=base_levels,
        pod_levels={
            pod.uid: chosen
            for pod in schedule.pods
            if pod.uid not in dropped_uids
        },
        description=compiled.ladder.describe(chosen),
    )
    CONSTRAINT_LEVEL_TOTAL.inc(str(chosen))
    return result, decision
