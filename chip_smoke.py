#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (karpenter_tpu_torch) on one NVIDIA Hopper card.

    python3 chip_smoke.py

Phases, one line each, then a `kernels` JSON line, the card's name and power
limit, and as the last line {"ok": true, "device": {...}}:

  1. card     the card, its power limit, torch and CUDA versions
  2. build    nvcc for every kernel source, all started together (timed)
  3. kernels  each kernel against its plain PyTorch version on the card: K1
              dominance pricing on small edge cases and at [512, 8] and K2
              the pack round loop in both modes on random problems and on
              the 50k-pod x 400-type encoded problem, bit for bit; K4 the
              plan compaction on those rounds and on dense rounds past the
              entry budget, word for word; K3 the LP relaxation on
              non-degenerate LPs padded to shapes that reach every launch
              plan (clusters of 2, 4, 8 and 16 blocks, a T the blocks do
              not divide, G 1 to 128, T 16 to 2048, the state in shared
              memory and in global scratch) and at the main path's shape on
              every cluster size, objective within rtol 1e-4 and assignment
              within 1e-3 pods, and on the 50k problem, objective within
              rtol 1e-4; two launches of K2 and of K3 on the same inputs
              give the same bits; K8 the incremental encode's scatter and
              gather on float32 rows, int32 and bool values (a delta, a
              1-element delta, sentinel-only index vectors, an empty
              permutation), bit for bit, the scatter's input untouched
  4. solve    the main path: 50,000 pending pods over 400 instance types
              through CostSolver(device="cuda").solve with the host gate off
              (KARPENTER_HOST_SOLVE=0); every pod placed exactly once, each
              of K1, K2, K3 and K4 launched exactly once; warm p50/p99 of
              solve_encoded over 10 runs
  5. cpu      the same encoded problem through the plain versions on the CPU:
              identical rounds and feasibility, $/hr within 1e-4 relative, LP
              objective within 1e-3 relative; the card's dispatch runs under
              torch.cuda.set_sync_debug_mode("error") (no host sync) and
              returns before the card is done
  6. batch    solve_encoded_many over 8 schedules (one fetch for the batch)
  7. incremental  the steady-state churn scenario of bench.py
              (bench_encode_incremental) over the port's Cluster and a
              DeviceClusterState on the card: 50,000 pods bound over 500
              nodes in 16 shapes, 1% churn a sweep, 12 sweeps; flush plus
              sorted view p50/p99, the full rebuild, K8's launches, the
              largest delta, rebuilds and compactions; every fourth
              sweep and at the end the view bit-identical to group_pods over
              the store, node_used equal to a pod walk, the device arrays
              equal to the host mirrors
     fast_path  the main path's 50,000 pending pods tracked by a
              DeviceClusterState: encode_schedule ->
              CostSolver.solve_many_pipelined on the pre-encoded pair; the
              plan identical to the snapshot path's, $/hr within 1e-4 of the
              CPU run, K1-K4 launched once each, no pod tensor uploaded and
              a warm solve uploading nothing (convert.upload_packed's
              counters), encode and dispatch under
              set_sync_debug_mode("error"); again after 1% churn (K8's
              scatters launched); warm p50 of the fast and the snapshot
              path, the encode skipped, and the time to the first result of
              an 8-schedule pipelined solve against the batch
     oom_ladder  on that 8-schedule batch: an injected out-of-memory fault
              at one and two split depths, a KARPENTER_HBM_BYTES pre-split
              and a fault in the middle of the pipeline give the unarmed
              plans bit for bit, counted by solver_batch_split_total; the
              floor is never reached
  8. consolidate  the consolidation path: one sweep of
              ops/consolidate.solve_candidates over a 5,000-node cluster
              (64 candidates, padded C 64, G 16, N 8192, T 512) built by the
              controller's rules; K7 launched once per sweep and bit-identical
              to its plain version there and on small problems (fits past
              2**24, the room in shared memory and in global scratch); every
              verdict equal to the CPU run; the winner's delete plan places
              each of its pods once within every receiver's headroom; a room
              sized for too few axes flagged; cold first sweep, warm p50 over
              10 sweeps, the fetch's bytes
  9. constrained  the constrained provisioning path: the main path's 50,000
              pods, each under one zonal topology spread (max_skew 1,
              DoNotSchedule) and two preferred node-affinity terms (a zone
              the catalog does not offer, weight 10; amd64, weight 1),
              through Scheduler(cluster).solve and
              constraints.solve.solve_constrained with CostSolver() on the
              card (padded G' 64, T 512, L 4); K6 launched once a solve;
              level 1 chosen; every pod placed once or reported
              unschedulable; the three zones' skew at most 1; $/hr equal to
              the CPU run within 1e-4; K6 equal to its plain version on the
              card in both modes and to the numpy mirror; the first solve,
              warm p50 and max over 10 solves, each layer of one solve
 10. large_shapes  CostSolver on the card over 12,000 pods in 1,100
              distinct shapes (padded G 2,048, T 512): every pod placed
              once, K2's rounds equal to the plain version's (the same
              dispatch on the CPU), K3's objective within rtol 1e-4 of its
              plain version; K2 at G 2,048 x T 512 and G 16 x T 8,192, K3
              at G 2,048 x T 512, G 16 x T 8,192 and G 2,048 x T 2,048 (its
              tables in global scratch) against their plain versions
 11. timing   each kernel's device time per call (torch.profiler: the
              kernels' own time, `ms`) and its time between CUDA events
              around the wrapper (host enqueue included, `event_ms`), its
              plain version's time (CUDA events) and its bound at the path's
              shapes; K3's time per Adam step and at every cluster size,
              K2's time per round of each mode; K6 at the constrained
              path's shapes; K8 on one steady-state sweep's scatters and
              gathers; K2 and K3 at padded G 2,048
 12. layers   one warm solve layer by layer (each bracketed by device syncs),
              and torch.profiler's device time against the solve's wall time

The kernels phase also holds K6, the constrained [L, G', T] dispatch, bit
for bit to its plain version on 22 seeded cases (both modes; conflicts, node
caps, penalties, padded levels, T 300 ragged, T 1,500, G' up to 2,048 with
its tables in global scratch).

Any failed check raises and the script exits non-zero. Without a CUDA card,
or without the rest of the repository beside it, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

# Published H100 SXM peaks: HBM bytes per second, fp32 (non-tensor) ops/s.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
ZONES = ("z-1a", "z-1b", "z-1c")
NODE_CAP_NONE = 2**30  # ops/pack_kernel.NODE_CAP_NONE: no per-node cap
NUM_PODS = 50_000
NUM_TYPES = 400


def check(condition: bool, message: str) -> None:
    if not condition:
        raise RuntimeError(f"check failed: {message}")


_START = time.perf_counter()


def phase(name: str, **fields) -> None:
    """One phase's line, with the seconds since the script started."""
    text = " ".join(f"{key}={value}" for key, value in fields.items())
    print(f"phase {name}: ok {text} at_s={time.perf_counter() - _START:.1f}", flush=True)


def kube_reserved_cpu_millis(vcpus: int) -> int:
    """Kube-reserved CPU of a node (the reference catalog's Bottlerocket
    formula): 6% of the first core, 1% of the second, 0.5% of cores 3-4,
    0.25% of the rest, plus 100m system-reserved."""
    millis = vcpus * 1000
    reserved = 100.0
    for start, end, percentage in (
        (0, 1000, 0.06), (1000, 2000, 0.01), (2000, 4000, 0.005), (4000, 1 << 31, 0.0025),
    ):
        if millis >= start:
            reserved += (min(millis, end) - start) * percentage
    return int(reserved)


def pod_shapes(seed: int = 0):
    """The 16 pod shapes of the north-star workload: (cpu millicores, MiB)."""
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(1, 17)) * 250, int(rng.integers(1, 33)) * 256) for _ in range(16)]


def zipf_weights(count: int = 16) -> np.ndarray:
    weights = 1.0 / np.arange(1, count + 1)
    return weights / weights.sum()


def make_catalog(num_types: int = NUM_TYPES, seed: int = 0, package=None):
    """400 types from 4 families x 10 sizes with on-demand prices linear in
    size, 3 zones, on-demand and spot offerings; spot prices come from a
    seeded generator. `package` supplies InstanceType and Offering (the
    port's by default)."""
    if package is None:
        package = port_package()
    families = [("c", 2.0, 0.17), ("m", 4.0, 0.192), ("r", 8.0, 0.252), ("x", 16.0, 0.333)]
    sizes = [1, 2, 3, 4, 6, 8, 12, 16, 24, 32]
    spot_rng = np.random.default_rng(seed + 1)
    catalog = []
    for idx in range(num_types):
        family, mem_per_cpu, base = families[idx % len(families)]
        size = sizes[(idx // len(families)) % len(sizes)]
        generation = idx // (len(families) * len(sizes))
        cpu = 2 * size
        on_demand = base * size * (1.0 + 0.03 * generation)
        max_pods = min(110, 8 + 15 * size)
        offerings = []
        for zone in ZONES:
            offerings.append(package.Offering(zone=zone, capacity_type="on-demand", price=on_demand))
            spot = on_demand * float(spot_rng.uniform(0.25, 0.75))
            offerings.append(package.Offering(zone=zone, capacity_type="spot", price=spot))
        catalog.append(
            package.InstanceType(
                name=f"{family}{generation}.{size}x",
                capacity={"cpu": cpu, "memory": f"{int(cpu * mem_per_cpu)}Gi", "pods": max_pods},
                overhead={
                    "cpu": f"{kube_reserved_cpu_millis(cpu)}m",
                    "memory": f"{11 * max_pods + 255 + 100 + 100}Mi",
                },
                offerings=offerings,
            )
        )
    return catalog


def make_workload(num_pods: int = NUM_PODS, num_types: int = NUM_TYPES, seed: int = 0):
    """The repository's north-star workload (the shapes of bench.make_workload):
    the 16 pod shapes, Zipf-weighted, over make_catalog's 400 types."""
    from karpenter_tpu_torch.api.pods import PodSpec

    shapes = pod_shapes(seed)
    shape_counts = (zipf_weights(len(shapes)) * num_pods).astype(int)
    shape_counts[0] += num_pods - shape_counts.sum()
    pods = [
        PodSpec(
            name=f"pod-{cpu}m-{mem}Mi-{i}",
            requests={"cpu": f"{cpu}m", "memory": f"{mem}Mi"},
            unschedulable=True,
        )
        for (cpu, mem), count in zip(shapes, shape_counts)
        for i in range(count)
    ]
    return pods, make_catalog(num_types, seed)


def port_package():
    """The port's classes and functions that the problem builders use; a test
    passes the reference package's in the same shape."""
    from types import SimpleNamespace

    from karpenter_tpu_torch.api import wellknown
    from karpenter_tpu_torch.api.pods import PodSpec, PreferredTerm, TopologySpreadConstraint
    from karpenter_tpu_torch.api.provisioner import Constraints
    from karpenter_tpu_torch.api.requirements import Requirement
    from karpenter_tpu_torch.cloudprovider import InstanceType, Offering
    from karpenter_tpu_torch.ops import consolidate, encode

    return SimpleNamespace(
        PodSpec=PodSpec, Constraints=Constraints, InstanceType=InstanceType, Offering=Offering,
        group_pods=encode.group_pods, build_fleet=encode.build_fleet,
        resource_vector=encode.resource_vector, accel_indexes=encode._ACCEL_INDEXES,
        consolidate=consolidate, TopologySpreadConstraint=TopologySpreadConstraint,
        PreferredTerm=PreferredTerm, Requirement=Requirement, wellknown=wellknown,
    )


# --- the constrained path: spread and preferences ---------------------------

SPREAD_LABELS = {"app": "web"}
MISSING_ZONE = "z-9z"  # a zone the catalog does not offer


def constrained_pods(num_pods: int = NUM_PODS, seed: int = 0, package=None):
    """The main path's pods in its 16 Zipf shapes, each with one zonal
    topology spread (max_skew 1, DoNotSchedule: the Kubernetes docs'
    Deployment example, kubernetes.io/docs/concepts/scheduling-eviction/
    topology-spread-constraints) and two preferred node-affinity terms:
    weight 10 for a zone the catalog does not offer, weight 1 for the amd64
    architecture every type has. The ladder's level 0 keeps both terms and
    can place nothing; level 1 drops the impossible one; level 2 drops
    both."""
    if package is None:
        package = port_package()
    wellknown = package.wellknown
    shapes = pod_shapes(seed)
    shape_counts = (zipf_weights(len(shapes)) * num_pods).astype(int)
    shape_counts[0] += num_pods - shape_counts.sum()
    spread = package.TopologySpreadConstraint(
        max_skew=1, topology_key=wellknown.ZONE_LABEL, match_labels=dict(SPREAD_LABELS))
    preferred = [
        package.PreferredTerm(weight=10, requirements=[
            package.Requirement.in_(wellknown.ZONE_LABEL, [MISSING_ZONE])]),
        package.PreferredTerm(weight=1, requirements=[
            package.Requirement.in_(wellknown.ARCH_LABEL, ["amd64"])]),
    ]
    return [
        package.PodSpec(
            name=f"web-{cpu}m-{mem}Mi-{i}", uid=f"web-{cpu}m-{mem}Mi-{i}",
            requests={"cpu": f"{cpu}m", "memory": f"{mem}Mi"}, unschedulable=True,
            labels=dict(SPREAD_LABELS), topology_spread=[spread], preferred_terms=list(preferred),
        )
        for (cpu, mem), count in zip(shapes, shape_counts)
        for i in range(count)
    ]


def zone_skew(result) -> tuple:
    """(pods per zone, skew) over the plan's packings, each pinned to one
    zone by its launch pools."""
    per_zone = {}
    for packing in result.packings:
        zones = {option.zone for option in packing.pool_options}
        if len(zones) != 1:
            raise RuntimeError(f"check failed: a packing is not pinned to one zone: {sorted(zones)}")
        (zone,) = zones
        per_zone[zone] = per_zone.get(zone, 0) + sum(len(node) for node in packing.pods_per_node)
    counts = [per_zone.get(zone, 0) for zone in ZONES]
    return per_zone, max(counts) - min(counts)


def placed_once_or_unschedulable(result, pods) -> bool:
    """Every pod is in the plan once or reported unschedulable, none both."""
    seen = [pod.uid for packing in result.packings for node in packing.pods_per_node for pod in node]
    seen += [pod.uid for pod in result.unschedulable]
    return len(seen) == len(pods) and set(seen) == {pod.uid for pod in pods}


def k6_problem(seed: int, num_groups: int, num_types: int, num_levels: int, real_groups=None):
    """A seeded [L, G', T] problem as pack_kernel_levels' ten numpy operands:
    pod-sized vectors in FFD order (the first `real_groups` real, the rest
    padding), nested allow masks that relax level by level with padded
    levels repeating the last real one, spread-penalty multiples and random
    penalties, zone-like domain conflicts plus random anti-affinity pairs,
    per-node caps, a ragged set of valid types."""
    rng = np.random.default_rng(seed)
    real = min(num_groups, real_groups or num_groups)
    vectors = np.zeros((num_groups, 8), np.float32)
    vectors[:real, 0] = np.sort(rng.integers(1, 17, real))[::-1] * 250
    vectors[:real, 1] = rng.integers(1, 33, real) * 256
    vectors[:real, 2] = 1
    if seed % 2:
        vectors[0, 0] = 70_000  # larger than any type: unschedulable at every level
    real_types = int(rng.integers(max(1, num_types // 2), num_types + 1))
    cpu = np.sort(rng.integers(1, 65, real_types)) * 1000
    capacity = np.zeros((num_types, 8), np.float32)
    capacity[:real_types, 0] = cpu - 100
    capacity[:real_types, 1] = cpu * rng.choice([2, 4, 8], real_types) - 600
    capacity[:real_types, 2] = 110
    valid = np.zeros(num_types, bool)
    valid[:real_types] = True
    prices = np.full(num_types, np.inf, np.float32)
    prices[:real_types] = cpu / 1000 * rng.uniform(0.03, 0.05, real_types)
    real_levels = int(rng.integers(1, num_levels + 1))
    level_counts = np.zeros((num_levels, num_groups), np.int32)
    allow = np.zeros((num_levels, num_groups, num_types), bool)
    base = rng.integers(1, 40, real)
    mask = rng.random((real, num_types)) < 0.3
    # Level 0 admits no type for a tenth of the groups (they retire as
    # unschedulable); each later real level admits more.
    mask[rng.random(real) < 0.1] = False
    for level in range(num_levels):
        if level < real_levels:
            if level > 0:
                mask = mask | (rng.random((real, num_types)) < 0.3)
            kept = base.copy()
            kept[rng.random(real) < 0.1 * (real_levels - 1 - level)] = 0
        level_counts[level, :real] = kept
        allow[level, :real] = mask
    penalty = np.zeros((num_levels, num_groups, num_types), np.float32)
    penalty[:, :real] = (0.005 * rng.integers(0, 4, (num_levels, real, num_types))).astype(np.float32)
    noisy = rng.random((num_levels, real, num_types)) < 0.2
    penalty[:, :real][noisy] = rng.uniform(0, 0.05, int(noisy.sum())).astype(np.float32)
    penalty[real_levels:] = penalty[real_levels - 1]
    domain = np.where(rng.random(real) < 0.6, rng.integers(0, 3, real), -1)
    conflict = np.zeros((num_groups, num_groups), bool)
    pinned = domain >= 0
    conflict[:real, :real] = pinned[:, None] & pinned[None, :] & (domain[:, None] != domain[None, :])
    pairs = rng.random((real, real)) < 0.02
    conflict[:real, :real] |= pairs | pairs.T
    np.fill_diagonal(conflict, False)
    node_cap = np.full(num_groups, NODE_CAP_NONE, np.int32)
    capped = rng.random(real) < 0.25
    node_cap[:real][capped] = rng.integers(1, 4, int(capped.sum()))
    return (vectors, level_counts, capacity, capacity.copy(), valid, prices, allow, penalty,
            conflict, node_cap)


# (G', T, L, real groups): a single level; the small and the main shapes;
# T 300 leaves part of the block's last warp without a type; L 8 every
# level a block; G' 512 and 2,048 keep the placed bits, and 2,048 the
# tables and fills, in global scratch; T 1,500 gives threads two types.
K6_SHAPES = ((8, 8, 1, None), (16, 64, 4, None), (16, 300, 4, None), (64, 512, 4, None),
             (64, 512, 8, None), (128, 256, 2, 80), (256, 512, 4, 60), (512, 256, 2, 50),
             (2048, 512, 2, 50), (32, 1024, 4, None), (16, 1500, 2, None))


def tied_weight_pack_problem(seed: int, groups: int, num_types: int = 16):
    """Two types of equal price, one with room for cpu only and one for
    memory only, over groups of one weight apiece: after a tiny first group
    both take, the cpu groups go to one type and the memory groups to the
    other, with the same (weight, count) pairs in another order. The exact
    weighted of both types is equal, so which one the first cost round
    takes is decided by the order and rounding of fills @ group_weight
    alone. The third type, the last valid one, sets the weights at a power
    of two per axis and costs too much to be taken. XLA vectorises the dot
    over the types as rows, one way from 9 rows on and another over 8 or
    fewer (`ops/pack_kernel._weighted_sums`)."""
    rng = np.random.default_rng(seed)
    half = (groups - 1) // 2
    weights = rng.uniform(0.001, 0.01, half).astype(np.float32)
    pods = rng.choice([3, 5, 7, 9, 11, 13], half).astype(np.int32)
    order = rng.permutation(half)
    vectors = np.zeros((groups, 3), np.float32)
    counts = np.zeros(groups, np.int32)
    vectors[0], counts[0] = (1e-3, 1e-3, 0), 2
    vectors[1 : 2 * half : 2, 0], counts[1 : 2 * half : 2] = weights * 1024, pods
    vectors[2 : 2 * half + 1 : 2, 1], counts[2 : 2 * half + 1 : 2] = weights[order] * 4096, pods[order]
    capacity = np.zeros((num_types, 3), np.float32)
    capacity[:3] = ((1e6, 0.5, 1), (0.5, 1e6, 1), (1024, 4096, 1))
    valid = np.zeros(num_types, bool)
    valid[:3] = True
    prices = np.zeros(num_types, np.float32)
    prices[:3] = (1, 1, 1e6)
    return vectors, counts, capacity, capacity.copy(), valid, prices


def tied_weight_levels_problem(seed: int, groups: int, levels: int, types: int = 16):
    """Two identical types that may take different halves of the groups
    (allow masks), each half the same (vector, count) pairs in another
    order: the exact weighted of both types is equal, so which one the
    first cost round takes is decided by the order and rounding of
    fills @ group_weight alone (equal prices, no penalty, one node holds
    every pod). XLA vectorises the dot over levels x types as rows, one way
    from 9 rows on and another over 8 or fewer
    (`ops/pack_kernel._weighted_sums`)."""
    rng = np.random.default_rng(seed)
    dims = 3
    half = groups // 2
    first, second = np.split(rng.permutation(groups), 2)
    sizes = rng.uniform(1, 10, half).astype(np.float32)
    pods = rng.choice([3, 5, 7, 9, 11, 13], half).astype(np.int32)
    order = rng.permutation(half)
    vectors = np.zeros((groups, dims), np.float32)
    counts = np.zeros(groups, np.int32)
    vectors[first, 0], counts[first] = sizes, pods
    vectors[second, 0], counts[second] = sizes[order], pods[order]
    capacity = np.zeros((types, dims), np.float32)
    capacity[:3] = 2.0**20
    valid = np.zeros(types, bool)
    valid[:3] = True
    prices = np.zeros(types, np.float32)
    prices[:3] = 1.0
    # Type 2, the last valid one, sets the weights and may take nothing.
    allow = np.zeros((levels, groups, types), bool)
    allow[:, first, 0] = True
    allow[:, second, 1] = True
    return (vectors, np.tile(counts, (levels, 1)), capacity, capacity.copy(), valid, prices, allow,
            np.zeros((levels, groups, types), np.float32), np.zeros((groups, groups), bool),
            np.full(groups, NODE_CAP_NONE, np.int32))


# Group counts of the tied-weight cases: one chain of fused multiply-adds
# below 64, the unrolled and the looped vectorised orders from 64 on.
TIED_GROUPS = (16, 64, 128, 256)
# Rows of the dot (types, or levels x types) over which XLA orders it
# another way: 8 or fewer.
NARROW_ROWS = (8, 4)


def tied_weight_cases():
    """(name, K2 problem or None, K6 operands or None) the kernels are held
    to their plain versions on where the order of `weighted` decides the
    round: three seeds a group count, K6 at one level and at four, and
    both over 8 and 4 rows (one level) from 64 groups on."""
    for groups in TIED_GROUPS:
        for seed in range(3):
            yield f"K2-G{groups}-s{seed}", tied_weight_pack_problem(seed, groups), None
            for levels in (1, 4):
                yield (f"K6-G{groups}-L{levels}-s{seed}", None,
                       tied_weight_levels_problem(seed, groups, levels))
            if groups < 64:
                continue
            for rows in NARROW_ROWS:
                yield (f"K2-G{groups}-T{rows}-s{seed}",
                       tied_weight_pack_problem(seed, groups, num_types=rows), None)
                yield (f"K6-G{groups}-L1-T{rows}-s{seed}", None,
                       tied_weight_levels_problem(seed, groups, 1, types=rows))


def k6_cases():
    """(name, operands, mode) K6 is held to its plain version on: every
    shape of K6_SHAPES in both modes."""
    for seed, (groups, types, levels, real) in enumerate(K6_SHAPES):
        operands = k6_problem(seed, groups, types, levels, real)
        for mode in ("ffd", "cost"):
            yield f"G{groups}-T{types}-L{levels}-{mode}", operands, mode


def many_shapes_pods(num_pods: int = 12_000, num_shapes: int = 1_100, seed: int = 5, package=None):
    """num_pods pending pods in num_shapes distinct (cpu, memory) shapes,
    cpu in 250m steps up to 4 cores and memory in 128Mi steps up to 16Gi,
    counts as even as the division allows."""
    if package is None:
        package = port_package()
    rng = np.random.default_rng(seed)
    cells = rng.choice(16 * 128, num_shapes, replace=False)
    shapes = [(int(c // 128 + 1) * 250, int(c % 128 + 1) * 128) for c in cells]
    counts = np.full(num_shapes, num_pods // num_shapes)
    counts[: num_pods % num_shapes] += 1
    return [
        package.PodSpec(name=f"pod-{cpu}m-{mem}Mi-{i}", requests={"cpu": f"{cpu}m", "memory": f"{mem}Mi"},
                        unschedulable=True)
        for (cpu, mem), count in zip(shapes, counts)
        for i in range(int(count))
    ]


def sparse_pack_problem(seed: int, num_groups: int, num_types: int, real_groups: int):
    """random_pack_problem's family with only the first real_groups groups
    holding pods (a few each), the rest padding: the launch plan of the
    padded size, at a cost the plain version can follow."""
    rng = np.random.default_rng(seed)
    real_groups = min(real_groups, num_groups)
    vectors, counts, capacity, total, valid, prices = random_pack_problem(rng, 16, num_types)
    vectors = np.zeros((num_groups, 8), np.float32)
    vectors[:real_groups, 0] = np.sort(rng.integers(1, 17, real_groups))[::-1] * 250
    vectors[:real_groups, 1] = rng.integers(1, 33, real_groups) * 256
    vectors[:real_groups, 2] = 1
    counts = np.zeros(num_groups, np.int32)
    counts[:real_groups] = rng.integers(1, 8, real_groups)
    return vectors, counts, capacity, total, valid, prices


# --- consolidation: a cluster of running nodes, by the controller's rules ---

CLUSTER_NODES = 5_000  # the large-cluster envelope Kubernetes documents
MAX_CANDIDATES = 64  # karpenter_tpu/controllers/consolidation.py:89
UNDERUTILIZED_FRACTION = 0.85  # karpenter_tpu/controllers/consolidation.py:86


def usable_capacity(catalog, package) -> np.ndarray:
    """[T, R] allocatable per type: capacity minus overhead, at least 0."""
    return np.stack([
        np.maximum(
            package.resource_vector(it.capacity).astype(np.float64)
            - package.resource_vector(it.overhead),
            0.0,
        )
        for it in catalog
    ])


def shape_vectors(shapes, package) -> np.ndarray:
    """[16, R] float64 request vectors of the pod shapes (the pods axis is 1)."""
    return np.stack([
        package.PodSpec(name="shape", requests={"cpu": f"{cpu}m", "memory": f"{mem}Mi"}).dense_vector[0]
        for cpu, mem in shapes
    ]).astype(np.float64)


def make_cluster(usable: np.ndarray, shape_vectors: np.ndarray, num_nodes: int = CLUSTER_NODES, seed: int = 11):
    """Running nodes as numbers: per node a catalog type (larger types more
    likely), a zone, a capacity type, whether its pods carry node-level
    scheduling requirements (one node in ten), and its pods per shape. Each
    node is filled with Zipf-drawn shapes while every axis stays within a
    seeded utilization of its allocatable capacity (the pods axis is
    max_pods). Only the node count is from a published envelope; the type
    weights, the utilization range [0.5, 0.98], the 30% spot and the 10%
    constrained share are this script's own choices, with no published
    trace behind them."""
    rng = np.random.default_rng(seed)
    num_types = usable.shape[0]
    weight = usable[:, 0] ** 2
    node_type = rng.choice(num_types, num_nodes, p=weight / weight.sum())
    zone = rng.integers(0, len(ZONES), num_nodes)
    spot = rng.random(num_nodes) < 0.3
    constrained = rng.random(num_nodes) < 0.1
    limit = rng.uniform(0.5, 0.98, num_nodes)[:, None] * usable[node_type]
    weights = zipf_weights(shape_vectors.shape[0])
    counts = np.zeros((num_nodes, shape_vectors.shape[0]), np.int64)
    used = np.zeros((num_nodes, shape_vectors.shape[1]))
    misses = np.zeros(num_nodes, np.int64)
    while (misses < 8).any():
        open_nodes = misses < 8
        shape = rng.choice(shape_vectors.shape[0], num_nodes, p=weights)
        grown = used + shape_vectors[shape]
        fits = open_nodes & (grown <= limit).all(axis=1)
        used[fits] = grown[fits]
        counts[fits, shape[fits]] += 1
        misses[fits] = 0
        misses[open_nodes & ~fits] += 1
    return {"node_type": node_type, "zone": zone, "spot": spot, "constrained": constrained, "counts": counts}


def consolidation_problem(cluster, catalog, shapes, package, max_candidates: int = MAX_CANDIDATES):
    """One consolidation sweep's ConsolidationProblem for `package`, built by
    the controller's rules (karpenter_tpu/controllers/consolidation.py):
    candidates are the least-utilized nodes below UNDERUTILIZED_FRACTION
    (utilization = the largest used/allocatable share over the tracked axes,
    :234-242, :364-371), their pods grouped by group_pods; receivers are every
    node with headroom = allocatable - used, tightest cpu first (:377-396),
    the victim masked out of its own row and a constrained candidate's row
    all False, so only its replace leg counts (:519-530); the replacement fleet is
    build_fleet over the catalog with the candidates' largest pods as
    pods_need (:398-428) and type_valid by the accelerator rule (:448-473).
    Returns (problem, each candidate's group members, receiver headroom in
    float64)."""
    vectors = shape_vectors(shapes, package)
    counts = cluster["counts"]
    num_nodes = counts.shape[0]
    names = [f"node-{i:05d}" for i in range(num_nodes)]
    usable = usable_capacity(catalog, package)[cluster["node_type"]]
    used = counts @ vectors
    tracked = usable > 0
    utilization = np.where(tracked, used / np.where(tracked, usable, 1.0), 0.0).max(axis=1)
    nominated = [i for i in range(num_nodes) if counts[i].sum() > 0 and utilization[i] < UNDERUTILIZED_FRACTION]
    candidates = sorted(nominated, key=lambda i: (utilization[i], names[i]))[:max_candidates]

    headroom = np.maximum(usable - used, 0.0)
    receivers = sorted(range(num_nodes), key=lambda i: (headroom[i, 0], names[i]))
    groups = []
    for i in candidates:
        pods = [
            package.PodSpec(name=f"{names[i]}-{k}-{j}", requests={"cpu": f"{cpu}m", "memory": f"{mem}Mi"},
                            node_name=names[i])
            for k, (cpu, mem) in enumerate(shapes)
            for j in range(int(counts[i, k]))
        ]
        groups.append(package.group_pods(pods))
    num_dims = vectors.shape[1]
    num_groups = max(max(g.num_groups for g in groups), 1)
    pod_vectors = np.zeros((len(candidates), num_groups, num_dims), np.float32)
    pod_counts = np.zeros((len(candidates), num_groups), np.int32)
    for c, g in enumerate(groups):
        pod_vectors[c, : g.num_groups] = g.vectors
        pod_counts[c, : g.num_groups] = g.counts
    receiver_index = np.array(receivers)
    bin_mask = receiver_index[None, :] != np.array(candidates)[:, None]
    bin_mask[cluster["constrained"][candidates]] = False
    pods_need = np.max([g.vectors.max(axis=0) for g in groups], axis=0)
    fleet = package.build_fleet(catalog, package.Constraints(), pods=[], daemons=[], pods_need=pods_need)
    demand = np.stack([g.vectors.T @ g.counts for g in groups])
    type_valid = np.ones((len(candidates), fleet.num_types), dtype=bool)
    for index in package.accel_indexes:
        type_valid &= ~((fleet.total[None, :, index] > 0) & (demand[:, None, index] <= 0))
    node_prices = np.array([
        next(
            o.price for o in catalog[cluster["node_type"][i]].offerings
            if o.zone == ZONES[cluster["zone"][i]]
            and o.capacity_type == ("spot" if cluster["spot"][i] else "on-demand")
        )
        for i in candidates
    ])
    problem = package.consolidate.ConsolidationProblem(
        pod_vectors=pod_vectors,
        pod_counts=pod_counts,
        headroom=headroom[receiver_index].astype(np.float32),
        bin_mask=bin_mask,
        node_prices=node_prices,
        type_capacity=fleet.capacity,
        type_prices=fleet.prices,
        type_valid=type_valid,
    )
    return problem, [g.members for g in groups], headroom[receiver_index]


def random_consolidation_problem(seed, num_candidates, num_groups, num_bins, num_types, dims: int = 8):
    """A seeded consolidation problem as numpy arrays (ConsolidationProblem's
    fields): zero-count and zero-vector groups, all-False bin_mask rows,
    candidates with no feasible type, tied prices and savings. The first
    `dims` axes carry requests; every axis past the pods axis is a count of 0
    or 1."""
    rng = np.random.default_rng(seed)
    vectors = np.zeros((num_candidates, num_groups, 8), np.float32)
    vectors[:, :, 0] = rng.integers(1, 17, (num_candidates, num_groups)) * 250
    vectors[:, :, 1] = rng.integers(1, 33, (num_candidates, num_groups)) * 256
    vectors[:, :, 2] = 1
    vectors[:, :, 3:dims] = rng.random((num_candidates, num_groups, max(dims - 3, 0))) < 0.1
    vectors[rng.random((num_candidates, num_groups)) < 0.15] = 0.0
    counts = rng.integers(0, 9, (num_candidates, num_groups)).astype(np.int32)
    counts[rng.random((num_candidates, num_groups)) < 0.15] = 0
    headroom = np.zeros((num_bins, 8), np.float32)
    headroom[:, 0] = rng.integers(0, 17, num_bins) * 1000
    headroom[:, 1] = rng.integers(0, 65, num_bins) * 1024
    headroom[:, 2] = rng.integers(0, 30, num_bins)
    headroom[:, 3:] = rng.integers(0, 2, (num_bins, 5))
    bin_mask = rng.random((num_candidates, num_bins)) < 0.8
    bin_mask[rng.random(num_candidates) < 0.2] = False
    capacity = np.zeros((num_types, 8), np.float32)
    capacity[:, 0] = rng.integers(1, 33, num_types) * 1000
    capacity[:, 1] = rng.integers(1, 129, num_types) * 1024
    capacity[:, 2] = 110
    capacity[:, 3:] = rng.integers(0, 2, (num_types, 5))
    prices = rng.choice([0.1, 0.2, 0.4, 0.8], num_types).astype(np.float32)
    type_valid = rng.random((num_candidates, num_types)) < 0.9
    type_valid[rng.random(num_candidates) < 0.15] = False  # no feasible type
    return dict(
        pod_vectors=vectors, pod_counts=counts, headroom=headroom, bin_mask=bin_mask,
        node_prices=rng.choice([0.3, 0.5, 1.0], num_candidates), type_capacity=capacity,
        type_prices=prices, type_valid=type_valid,
    )


def huge_fit_problem(num_bins: int = 3):
    """Bins whose fits pass 2**24 after small ones: the prefix sum must be
    the sequential float32 fold (fl(3 + 2**25) = 2**25 + 4)."""
    vectors = np.zeros((2, 1, 8), np.float32)
    vectors[:, 0, 0] = 1000.0
    headroom = np.zeros((num_bins, 8), np.float32)
    headroom[:, 0] = 5000.0
    headroom[0, 0] = 3000.0
    headroom[1::97, 0] = 2.0**25 * 1000.0
    return dict(
        pod_vectors=vectors, pod_counts=np.array([[10], [2]], np.int32), headroom=headroom,
        bin_mask=np.ones((2, num_bins), bool), node_prices=np.array([0.5, 0.6]),
        type_capacity=np.full((1, 8), 1e9, np.float32), type_prices=np.array([0.1], np.float32),
        type_valid=np.ones((2, 1), bool),
    )


def k7_problems():
    """(name, arrays) the card holds K7 to its plain version on, beside the
    real-size sweep: small seeded problems off their buckets, fits past 2**24
    (the kernel's sequential fold), and N = 8192 with 3 and with all 8 axes
    requested (the room in shared memory, then in global scratch)."""
    for seed, shape in enumerate([(1, 1, 1, 1), (3, 5, 9, 17), (13, 11, 70, 40), (17, 9, 1300, 20), (64, 16, 2000, 300)]):
        yield "C{}-G{}-N{}-T{}".format(*shape), random_consolidation_problem(seed, *shape)
    yield "fit-past-2^24-N3", huge_fit_problem(3)
    yield "fit-past-2^24-N3000", huge_fit_problem(3000)
    yield "N8192-3-axes", random_consolidation_problem(7, 8, 4, 8192, 64, dims=3)
    yield "N8192-8-axes", random_consolidation_problem(8, 8, 4, 8192, 64, dims=8)


def dominance_cases():
    """The edge cases K1 is held to: T = 1, a size ladder, random shapes with
    invalid (zero capacity, +inf price) rows and ties, T not a multiple of
    the block, an all-invalid problem."""
    rng = np.random.default_rng(3)
    yield np.zeros((1, 8), np.float32), np.array([1.5], np.float32)
    ladder = np.arange(1, 9, dtype=np.float32)[:, None] * np.ones((1, 8), np.float32)
    yield ladder, (0.1 * np.arange(1, 9)).astype(np.float32)
    for num_types in (2, 17, 39, 129, 300):
        capacity = rng.integers(0, 6, (num_types, 8)).astype(np.float32)
        prices = rng.choice([0.25, 0.5, 1.0], num_types).astype(np.float32)  # ties
        invalid = rng.random(num_types) < 0.2
        capacity[invalid] = 0.0
        yield capacity, np.where(invalid, np.inf, prices).astype(np.float32)
    yield np.zeros((5, 8), np.float32), np.full(5, np.inf, np.float32)


# K3 against its plain version: the CPU parity test's tolerances
# (tests/test_torch_kernels.py): 300 float32 Adam steps whose sums are taken
# in other orders drift apart by rounding.
LP_OBJECTIVE_RTOL = 1e-4
LP_ASSIGNMENT_ATOL = 1e-3
LP_SEEDS = (0, 1, 3, 4, 6, 7, 8, 9)


def lp_problem(seed: int):
    """The non-degenerate LP family of tests/test_torch_kernels.py (same
    draws, 8 groups x 16 types): every type has its own price per core."""
    rng = np.random.default_rng(seed)
    real_groups = int(rng.integers(2, 9))
    real_types = int(rng.integers(3, 17))
    vectors = np.zeros((8, 8), np.float32)
    vectors[:real_groups, 0] = np.sort(rng.integers(1, 17, real_groups))[::-1] * 250
    vectors[:real_groups, 1] = rng.integers(1, 33, real_groups) * 256
    vectors[:real_groups, 2] = 1
    counts = np.zeros(8, np.int32)
    counts[:real_groups] = rng.integers(1, 60, real_groups)
    cpu = np.sort(rng.integers(1, 17, real_types)) * 1000.0
    capacity = np.zeros((16, 8), np.float32)
    capacity[:real_types, 0] = cpu - 100
    capacity[:real_types, 1] = cpu * rng.choice([2.0, 4.0, 8.0], real_types) - 600
    capacity[:real_types, 2] = 110
    valid = np.zeros(16, bool)
    valid[:real_types] = True
    prices = np.full(16, np.inf, np.float32)
    prices[:real_types] = cpu / 1000 * rng.uniform(0.03, 0.06, real_types)
    return vectors, counts, capacity, valid, prices


def lp_inputs(seed: int, shape, device):
    """lp_problem(seed) padded to shape = (G, T) with zero-count groups and
    invalid types, as the bucket padding pads the main path, on the card:
    (vectors, solvable counts, capacity, valid, effective prices). A G
    under 8 keeps the first G groups."""
    import torch

    from karpenter_tpu_torch.ops import cuda_kernels, score_kernel

    vectors, counts, capacity, valid, prices = lp_problem(seed)
    num_groups, num_types = shape
    vectors = np.pad(vectors[:num_groups], ((0, max(num_groups - 8, 0)), (0, 0)))
    counts = np.pad(counts[:num_groups], (0, max(num_groups - 8, 0)))
    capacity = np.pad(capacity, ((0, num_types - 16), (0, 0)))
    valid = np.pad(valid, (0, num_types - 16))
    prices = np.pad(prices, (0, num_types - 16), constant_values=np.inf)
    vectors, counts, capacity, valid, prices = (
        torch.from_numpy(a).to(device) for a in (vectors, counts, capacity, valid, prices)
    )
    effective = cuda_kernels._dominance_prices_ref(capacity, torch.where(valid, prices, torch.inf))
    feasible_any = score_kernel.feasibility_mask(vectors, capacity, valid).any(dim=1)
    return vectors, torch.where(feasible_any, counts, 0), capacity, valid, effective


def lp_operations(groups: int, types: int, dims: int, steps: int) -> int:
    """fp32 operations of the LP relaxation, counting exp, log, square root
    and division as one each. Per step and cell (g, t): the masked softmax
    (select, max, subtract, exp, add, divide: 6), x = c * S (1), its share of
    D (2 per axis), dx and dS (2 per axis, 1), the row dot (2), the softmax
    backward (2) and Adam (16); per type and axis: f, the scaled smooth max,
    w and dD (9). The start takes about 4 per type plus 2 per axis and cell
    for the mask; the result a softmax, x and D again plus the max and the
    objective."""
    cells = groups * types
    per_step = cells * (6 + 1 + 2 * dims + 2 * dims + 1 + 2 + 2 + 16) + types * dims * 9
    start = types * (dims + 4) + cells * (2 * dims + 6)
    result = cells * (6 + 1 + 2 * dims) + types * (2 * dims + 2)
    return steps * per_step + start + result


def random_pack_problem(rng, num_groups: int, num_types: int):
    vectors = np.zeros((num_groups, 8), np.float32)
    real = int(rng.integers(1, num_groups + 1))
    vectors[:real, 0] = np.sort(rng.integers(1, 17, real))[::-1] * 250
    vectors[:real, 1] = rng.integers(1, 33, real) * 256
    vectors[:real, 2] = 1
    if rng.random() < 0.5:
        vectors[0, 0] = 70_000  # larger than any type: retired as unschedulable
    counts = np.zeros(num_groups, np.int32)
    counts[:real] = rng.integers(1, 3000, real)
    real_types = int(rng.integers(1, num_types + 1))
    capacity = np.zeros((num_types, 8), np.float32)
    cpu = np.sort(rng.integers(1, 65, real_types)) * 1000
    capacity[:real_types, 0] = cpu - 100
    capacity[:real_types, 1] = cpu * rng.choice([2, 4, 8], real_types) - 600
    capacity[:real_types, 2] = 110
    valid = np.zeros(num_types, bool)
    valid[:real_types] = True
    prices = np.full(num_types, np.inf, np.float32)
    prices[:real_types] = cpu / 1000 * rng.uniform(0.03, 0.05, real_types)
    return vectors, counts, capacity, capacity.copy(), valid, prices


def dense_rounds(num_groups: int, seed: int, density: float, device):
    """PackRounds on `device` whose fills are nonzero with the given density:
    sparse plans inside the compaction's entry budget, dense ones past it."""
    import torch

    from karpenter_tpu_torch.ops.pack_kernel import PackRounds, max_rounds

    rng = np.random.default_rng(seed)
    mr = max_rounds(num_groups)
    fill = rng.integers(1, 5, (mr, num_groups)) * (rng.random((mr, num_groups)) < density)
    fields = (
        rng.integers(0, 16, mr), fill, rng.integers(1, 5, mr), rng.integers(0, mr),
        rng.integers(0, 3, num_groups), seed % 2,
    )
    return PackRounds(*(torch.tensor(np.asarray(f), dtype=torch.int32, device=device) for f in fields))


def rounds_equal(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def rounds_abs_err(a, b) -> float:
    return max(float((x.long() - y.long()).abs().max()) for x, y in zip(a, b))


def synchronize(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_cuda(fn, reps: int, warmup: int = 3) -> float:
    """Median milliseconds of fn() over reps, each bracketed by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return float(np.median(samples))


def layer_breakdown(groups, fleet, device, reps: int = 5) -> dict:
    """Median wall milliseconds of each layer of one warm solve, each layer
    bracketed by device synchronizations so its own launches and device work
    are inside its bracket (the solve itself syncs once, at the fetch)."""
    import torch

    from karpenter_tpu_torch.convert import fused_args_from_numpy
    from karpenter_tpu_torch.models import solver
    from karpenter_tpu_torch.ops import cuda_kernels, pack_kernel, score_kernel

    samples: dict = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        samples.setdefault(name, []).append((time.perf_counter() - start) * 1e3)
        return out

    for _ in range(reps):
        padded = timed("pad", lambda: solver.pad_kernel_args(
            groups.vectors, groups.counts, fleet.capacity, fleet.total, fleet.prices))
        vectors, counts, capacity, total, valid, prices = timed(
            "h2d", lambda: fused_args_from_numpy(*padded, device=device))
        effective = timed("k1_dominance", lambda: cuda_kernels.dominance_prices(
            capacity, torch.where(valid, prices, torch.inf)))
        ffd, cost = timed("k2_pack", lambda: pack_kernel.pack_kernel_pair(
            vectors, counts, capacity, total, valid, effective))
        feasible_any = score_kernel.feasibility_mask(vectors, capacity, valid).any(dim=1)
        lp = timed("k3_lp", lambda: score_kernel.lp_relax(
            vectors, torch.where(feasible_any, counts, 0), capacity, valid, effective))
        compact = timed("compaction", lambda: pack_kernel.compact_plan(ffd, cost, feasible_any))
        handle = solver.FusedHandle(
            compact=compact, objective=lp.objective.reshape(1), dense=compact,
            lp=lp.assignment.reshape(-1), num_groups=padded[0].shape[0],
            num_types=padded[2].shape[0],
        )
        (plan,) = timed("fetch", lambda: solver.fetch_plans([handle]))
        zones, matrix = timed("pool_matrix", lambda: solver._pool_price_matrix(fleet))
        mix = timed("mix_candidate", lambda: solver.compute_mix_candidate(
            groups.vectors, groups.counts, fleet.capacity, matrix))
        dense = timed("scoring", lambda: solver.cost_solve_finish(
            plan, groups.vectors, groups.counts, fleet.capacity, fleet.total,
            fleet.prices, matrix, mix_plan=mix))
        timed("decode", lambda: solver.decode_dense_result(dense, groups, fleet, zones))
    return {name: float(np.median(values)) for name, values in samples.items()}


def device_busy(cost_solver, groups, fleet) -> dict:
    """torch.profiler over one warm solve: device time summed over kernels
    and copies, against the solve's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        cost_solver.solve_encoded(groups, fleet)
        wall_ms = (time.perf_counter() - start) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
    return {
        "wall_ms": wall_ms,
        "device_ms": device_ms,
        "busy_share": device_ms / wall_ms,
        "device_launches": sum(e.count for e in events),
        "top": [(e.key[:60], e.count, e.self_device_time_total / 1e3) for e in top],
    }


def all_pods_placed_once(result, pods) -> bool:
    placed = [pod.uid for packing in result.packings for node in packing.pods_per_node for pod in node]
    return (
        not result.unschedulable
        and len(placed) == len(pods)
        and set(placed) == {pod.uid for pod in pods}
    )


def k7_inputs(problem, device):
    """K7's padded operands on `device` and the count of requested axes its
    room is sized for, as ops/consolidate.solve_candidates makes them."""
    from karpenter_tpu_torch.convert import upload_packed
    from karpenter_tpu_torch.ops import consolidate, consolidate_kernel

    padded = consolidate._padded(problem)
    return upload_packed(padded, device), consolidate_kernel.requested_axes(padded[0])


def k7_needed_bytes(operands) -> int:
    """Bytes K7 must move on these operands: pod vectors and counts, the bin
    and type masks and node prices read once; headroom only on the bins some
    candidate may use and on the axes that candidate requests; capacity only
    of the types valid for some candidate, prices only of those that fit
    some candidate; the [C, G, N] plan and the eager buffer written once."""
    import torch

    from karpenter_tpu_torch.ops import consolidate_kernel
    from karpenter_tpu_torch.ops.score_kernel import feasibility_mask

    pod_vectors, pod_counts, headroom, bin_mask, capacity, prices, type_valid, node_prices, cand_valid = operands
    num_candidates, num_groups, dims = pod_vectors.shape
    num_bins = headroom.shape[0]
    requested = (pod_vectors > 0).any(dim=1)  # [C, R]
    headroom_cells = int((bin_mask[:, :, None] & requested[:, None, :]).any(dim=0).sum())
    counts = pod_counts.to(torch.float32)
    demand = torch.zeros_like(pod_vectors[:, 0, :])
    for g in range(num_groups):
        demand = demand + pod_vectors[:, g, :] * counts[:, g, None]
    fits = feasibility_mask(demand, capacity, torch.ones_like(type_valid[0])) & type_valid
    read = (
        pod_vectors.numel() * 4 + pod_counts.numel() * 4 + bin_mask.numel() + type_valid.numel()
        + node_prices.numel() * 4 + cand_valid.numel() + 4 * headroom_cells
        + 4 * dims * int(type_valid.any(dim=0).sum()) + 4 * int(fits.any(dim=0).sum())
    )
    written = 4 * (num_candidates * num_groups * num_bins
                   + consolidate_kernel.eager_words(num_candidates, num_groups, num_bins))
    return read + written


def k6_needed(operands, mode: str = "cost"):
    """(bytes, operations) K6 must spend on these operands: every input read
    once and the output written once; per distinct level and round, the
    scan of each group still holding pods over the types that may take it
    (a division, a minimum, a multiply and a subtract per axis the group
    requests, an add and a floor), counted from the level's own rounds (its
    plain version, one level at a time). A padded level repeats the last
    real one and adds no work of its own."""
    import torch

    from karpenter_tpu_torch.ops import pack_kernel

    vectors, counts, capacity, total, valid, prices, allow, penalty, conflict, node_cap = operands
    num_levels, num_groups = counts.shape
    read = sum(t.numel() * t.element_size() for t in operands if t is not total)
    written = 4 * pack_kernel.level_pack_words(num_groups, num_levels)
    fits = (vectors[:, None, :] <= capacity[None, :, :] + 1e-6).all(dim=-1)
    usable = allow & fits[None] & valid[None, None, :]
    # Per group, its usable types times the scan's operations a type.
    scan = (usable.sum(dim=2) * (4 * (vectors > 0).sum(dim=1) + 2)[None, :]).long().cpu().numpy()
    distinct = []
    ops = 0
    for level in range(num_levels):
        if any(torch.equal(counts[level], counts[other]) and torch.equal(allow[level], allow[other])
               and torch.equal(penalty[level], penalty[other]) for other in distinct):
            continue
        distinct.append(level)
        one = [vectors, counts[level : level + 1], capacity, total, valid, prices,
               allow[level : level + 1], penalty[level : level + 1], conflict, node_cap]
        rounds = plain_levels(one, mode).rounds
        remaining = torch.where(usable[level].any(dim=1), counts[level], 0).long().cpu().numpy()
        fills = rounds.round_fill.long().cpu().numpy()
        repl = rounds.round_repl.long().cpu().numpy()
        for r in range(int(rounds.num_rounds)):
            ops += int(scan[level][remaining > 0].sum())
            remaining -= repl[r] * fills[r]
    return read + written, ops


def device_ms_per_call(fn, kernel_names, reps: int = 20, launches_per_call: int = 0) -> float:
    """torch.profiler's device time of the named kernels per call of `fn`
    (which launches each once, or `launches_per_call` of them in all): the
    kernels' own time on the card, without the host's enqueue. The
    profiler now and then drops a few kernel records of a window; a window
    that did not see every launch is measured again, up to three times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    expected = reps * (launches_per_call or len(kernel_names))
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [
            e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and any(name in e.key for name in kernel_names)
        ]
        launches = sum(e.count for e in events)
        if launches == expected:
            return sum(e.self_device_time_total for e in events) / 1e3 / reps
        print(f"  the profiler saw {launches} launches of {kernel_names}, not {expected}: again")
    check(False, f"the profiler saw {launches} launches of {kernel_names}, not {expected}")


def consolidate_phase(catalog, device) -> dict:
    """One consolidation sweep at the large-cluster envelope through the
    entry point the controller calls (ops/consolidate.solve_candidates on
    `device`), its checks against the CPU run and K7 against its plain
    version. Returns K7's operands at this size, its launches in the sweep
    and its largest difference from the plain version."""
    import torch

    from karpenter_tpu_torch.ops import consolidate, consolidate_kernel

    start = time.perf_counter()
    package = port_package()
    shapes = pod_shapes(0)
    cluster = make_cluster(usable_capacity(catalog, package), shape_vectors(shapes, package))
    problem, members, receiver_headroom = consolidation_problem(cluster, catalog, shapes, package)
    problem_ms = (time.perf_counter() - start) * 1e3
    consolidate_kernel.solve_counterfactuals.launches = 0
    synchronize(device)
    start = time.perf_counter()
    verdicts = consolidate.solve_candidates(problem, device=device)
    sweep_cold_ms = (time.perf_counter() - start) * 1e3
    sweep_launches = consolidate_kernel.solve_counterfactuals.launches
    sweep_fetch_bytes = consolidate.LAST_FETCH_BYTES
    check(sweep_launches == 1, f"the consolidation sweep launched K7 {sweep_launches} times")
    sweep_ms = []
    for _ in range(10):
        start = time.perf_counter()
        consolidate.solve_candidates(problem, device=device)
        sweep_ms.append((time.perf_counter() - start) * 1e3)
    cpu_verdicts = consolidate.solve_candidates(problem, device="cpu")
    for name in ("delete_ok", "replace_type", "replace_price", "savings", "action"):
        check(np.array_equal(getattr(verdicts, name), getattr(cpu_verdicts, name)),
              f"consolidation verdict {name} differs between the card and the CPU")
    best = verdicts.best()
    check(best >= 0 and verdicts.action[best] == consolidate.ACTION_DELETE,
          f"the sweep's winner {best} is not a delete")
    check(np.array_equal(verdicts.take_row(best), cpu_verdicts.take_row(best)),
          "the winner's plan row differs between the card and the CPU")
    takes_host = verdicts.delete_take
    check(np.array_equal(takes_host, cpu_verdicts.delete_take), "the [C, G, N] plan differs between the card and the CPU")
    # The winner's delete plan: each of its pods placed once, and no
    # receiver past its headroom (float64).
    plan = consolidate.delete_assignment(verdicts, best, members[best])
    winner_pods = [pod for group in members[best] for pod in group]
    check(sorted(id(pod) for pod, _ in plan) == sorted(id(pod) for pod in winner_pods),
          "the winner's delete plan does not place each of its pods exactly once")
    usage = np.zeros_like(receiver_headroom)
    for pod, j in plan:
        usage[j] += pod.dense_vector[0]
    check((usage <= receiver_headroom).all(), "the winner's delete plan overfills a receiver")
    # Every delete-feasible candidate's plan, from the whole plan tensor.
    for c in np.nonzero(verdicts.delete_ok)[0]:
        row = takes_host[c].astype(np.float64)
        check(np.array_equal(takes_host[c].sum(axis=1), problem.pod_counts[c]), f"candidate {c} misplaces pods")
        check(not takes_host[c][:, ~problem.bin_mask[c]].any(), f"candidate {c} uses a masked receiver")
        check((row.T @ problem.pod_vectors[c].astype(np.float64) <= receiver_headroom).all(),
              f"candidate {c}'s delete plan overfills a receiver")
    # K7 against its plain version: this problem and the small ones, each
    # with its room sized as solve_candidates sizes it.
    k7_operands, k7_axes = k7_inputs(problem, device)
    k7_cases = 0
    k7_err = 0.0
    for name, (operands, axes) in [("cluster", (k7_operands, k7_axes))] + [
        (name, k7_inputs(consolidate.ConsolidationProblem(**arrays), device))
        for name, arrays in k7_problems()
    ]:
        takes, eager = consolidate_kernel.solve_counterfactuals(*operands, axes=axes)
        want = consolidate_kernel._counterfactual_ref(*operands)
        want_eager = consolidate_kernel._eager_from_outputs(*want[1:])
        synchronize(device)
        check(torch.equal(takes, want[0]) and torch.equal(eager, want_eager),
              f"K7 differs from its plain version on {name}")
        k7_err = max(k7_err, float((takes.long() - want[0].long()).abs().max()))
        k7_cases += 1
    # A room sized for fewer axes than a candidate requests is flagged
    # (best = -1), never overrun.
    _, eager = consolidate_kernel.solve_counterfactuals(*k7_operands, axes=k7_axes - 1)
    check(int(eager[3 * k7_operands[0].shape[0]]) == -1, "K7 did not flag a room sized too small")
    c_pad, g_pad, _ = k7_operands[0].shape
    phase(
        "consolidate", nodes=CLUSTER_NODES, pods=int(cluster["counts"].sum()),
        candidates=problem.num_candidates, shape=f"C={c_pad},G={g_pad},N={k7_operands[2].shape[0]},T={k7_operands[4].shape[0]}",
        deletes=int((verdicts.action == consolidate.ACTION_DELETE).sum()),
        replaces=int((verdicts.action == consolidate.ACTION_REPLACE).sum()),
        best=best, best_savings=f"{verdicts.savings[best]:.6f}", k7_cases=k7_cases, k7_max_abs_err=k7_err,
        problem_ms=f"{problem_ms:.3f}", cold_sweep_ms=f"{sweep_cold_ms:.3f}",
        p50_ms=f"{np.percentile(sweep_ms, 50):.3f}", launches_per_sweep=sweep_launches,
        fetch_bytes=sweep_fetch_bytes, requested_axes=k7_axes,
    )
    return {"operands": k7_operands, "axes": k7_axes, "launches": sweep_launches, "max_abs_err": k7_err}


def level_packs_equal(a, b) -> bool:
    import torch

    return (
        rounds_equal(a.rounds, b.rounds) and torch.equal(a.chosen_level, b.chosen_level)
        and torch.equal(a.group_level, b.group_level) and torch.equal(a.level_unsched, b.level_unsched)
    )


def level_pack_abs_err(a, b) -> float:
    fields = (a.chosen_level, a.group_level, a.level_unsched)
    others = (b.chosen_level, b.group_level, b.level_unsched)
    return max([rounds_abs_err(a.rounds, b.rounds)]
               + [float((x.long() - y.long()).abs().max()) for x, y in zip(fields, others)])


def plain_levels(operands, mode):
    """K6's plain version on pack_kernel_levels' ten operands (it takes no
    `total`)."""
    from karpenter_tpu_torch.ops import pack_kernel

    vectors, counts, capacity, _, valid, prices, allow, penalty, conflict, node_cap = operands
    return pack_kernel._pack_levels_ref(
        vectors, counts, capacity, valid, prices, allow, penalty, conflict, node_cap, mode=mode)


def mirror_agrees(host, pack, num_sub: int, num_levels: int) -> bool:
    """The numpy mirror's HostLevelPack (on the unpadded operands) against a
    padded LevelPack: the chosen level, its rounds, unschedulable and
    overflow, every real level's unschedulable, each real group's first
    feasible level (none: num_levels)."""
    rounds = pack.rounds
    count = int(rounds.num_rounds)
    if host.chosen_level != int(pack.chosen_level) or len(host.rounds) != count:
        return False
    for r, (t, fill, repl) in enumerate(host.rounds):
        if (t != int(rounds.round_type[r]) or repl != int(rounds.round_repl[r])
                or not np.array_equal(fill, rounds.round_fill[r, :num_sub].cpu().numpy())):
            return False
    group_level = np.minimum(pack.group_level[:num_sub].cpu().numpy(), num_levels)
    return (
        np.array_equal(host.unschedulable, rounds.unschedulable[:num_sub].cpu().numpy())
        and host.overflow == bool(rounds.overflow)
        and np.array_equal(host.group_level, group_level)
        and np.array_equal(host.level_unsched, pack.level_unsched[:num_levels, :num_sub].cpu().numpy())
    )


def constrained_phase(catalog, device, num_pods: int = NUM_PODS, mirror_modes=("cost", "ffd")) -> dict:
    """The constrained provisioning solve through the entry points the
    provisioning controller calls: Scheduler(cluster).solve -> one schedule
    that needs the compiler -> constraints.solve.solve_constrained with
    CostSolver() (K6 on `device`). Checks the chosen level, every pod placed
    once or reported unschedulable, the zones' skew, $/hr against the CPU
    run, and K6 at this size against its plain version (both modes) and the
    numpy mirror; times the layers of one warm solve. Returns K6's padded
    operands, launches a solve and differences."""
    import torch

    from karpenter_tpu_torch.api.provisioner import Provisioner, ProvisionerSpec
    from karpenter_tpu_torch.constraints import compiler
    from karpenter_tpu_torch.constraints import solve as constrained
    from karpenter_tpu_torch.constraints.mirror import pack_levels_host
    from karpenter_tpu_torch.controllers.cluster import Cluster
    from karpenter_tpu_torch.controllers.scheduling import Scheduler
    from karpenter_tpu_torch.convert import upload_packed
    from karpenter_tpu_torch.models import solver
    from karpenter_tpu_torch.ops import pack_kernel
    from karpenter_tpu_torch.ops.encode import build_fleet, group_pods

    pods = constrained_pods(num_pods)
    cluster = Cluster()
    provisioner = Provisioner(name="default", spec=ProvisionerSpec())
    schedules = Scheduler(cluster).solve(provisioner, pods)
    check(len(schedules) == 1 and schedules[0].needs_compiler,
          f"the spread schedule did not reach the compiler: {len(schedules)} schedules")
    schedule = schedules[0]
    card_solver = solver.CostSolver(device=device)

    def solve():
        return constrained.solve_constrained(card_solver, schedule, catalog, [], cluster=cluster)

    pack_kernel.pack_kernel_levels.launches = 0
    synchronize(device)
    start = time.perf_counter()
    result, decision = solve()
    first_ms = (time.perf_counter() - start) * 1e3
    launches = pack_kernel.pack_kernel_levels.launches
    if torch.device(device).type == "cuda":
        check(launches == 1, f"the constrained solve launched K6 {launches} times")
    check(decision.chosen_level == 1, f"the constrained solve chose level {decision.chosen_level}, not 1")
    check(placed_once_or_unschedulable(result, pods),
          "the constrained solve did not place every pod once or report it unschedulable")
    per_zone, skew = zone_skew(result)
    check(skew <= 1, f"the zones' skew is {skew}: {per_zone}")
    card_cost = result.projected_cost()
    warm_ms = []
    for _ in range(10):
        start = time.perf_counter()
        solve()
        warm_ms.append((time.perf_counter() - start) * 1e3)
    cpu_result, cpu_decision = constrained.solve_constrained(
        solver.CostSolver(device="cpu"), schedule, catalog, [], cluster=cluster)
    cpu_cost = cpu_result.projected_cost()
    check(cpu_decision.chosen_level == decision.chosen_level, "the CPU run chose another level")
    cost_rel = abs(card_cost - cpu_cost) / cpu_cost
    check(cost_rel <= 1e-4, f"$/hr differs between the card ({card_cost}) and the CPU ({cpu_cost})")

    # One warm solve layer by layer, each bracketed by device syncs.
    layers = {}

    def timed(name, fn):
        synchronize(device)
        start = time.perf_counter()
        out = fn()
        synchronize(device)
        layers[name] = (time.perf_counter() - start) * 1e3
        return out

    groups = timed("encode", lambda: group_pods(list(schedule.pods)))
    fleet = build_fleet(catalog, schedule.constraints, schedule.pods, [],
                        pods_need=groups.vectors.max(axis=0))
    compiled = timed("compile", lambda: compiler.compile_constraints(
        schedule, groups, fleet, cluster, cache=compiler.CompilerCache()))
    padded = timed("pad", lambda: constrained.pad_levels(compiled, fleet))
    operands = timed("h2d", lambda: upload_packed(padded, device))
    pack = timed("k6", lambda: pack_kernel.pack_kernel_levels(*operands, mode="cost"))
    host = timed("fetch", lambda: pack_kernel.level_pack_to_host(pack))
    num_sub, num_levels = compiled.num_subgroups, compiled.num_levels
    rounds = [
        (int(host.rounds.round_type[r]), host.rounds.round_fill[r, :num_sub], int(host.rounds.round_repl[r]))
        for r in range(int(host.rounds.num_rounds))
    ]
    timed("decode", lambda: constrained.decode_constrained(
        rounds, host.rounds.unschedulable[:num_sub], compiled, int(host.chosen_level), fleet))
    g_pad, t_pad, l_pad = operands[0].shape[0], operands[2].shape[0], operands[1].shape[0]
    print(f"  constrained sizes: G'={num_sub} padded {g_pad}, T={fleet.num_types} padded {t_pad}, "
          f"L={num_levels} padded {l_pad}, mirror modes {','.join(mirror_modes)}")
    if num_pods == NUM_PODS:
        # 16 shapes x 4 spread domains (the three zones and the missing
        # zone the preference names), 400 types, 3 ladder levels.
        check((num_sub, g_pad, t_pad, l_pad) == (64, 64, 512, 4),
              f"the constrained sizes are G'={num_sub}/{g_pad}, T={t_pad}, L={l_pad}")

    # K6 at this size against its plain version in both modes, and the
    # mirror on the unpadded operands.
    k6_err = 0.0
    packs = {}
    for mode in ("ffd", "cost"):
        got = pack_kernel.pack_kernel_levels(*operands, mode=mode)
        want = plain_levels(operands, mode)
        synchronize(device)
        check(level_packs_equal(got, want), f"K6 {mode} differs from its plain version on the constrained path")
        k6_err = max(k6_err, level_pack_abs_err(got, want))
        packs[mode] = got
    for mode in mirror_modes:
        mirror = pack_levels_host(
            compiled.vectors, compiled.level_counts, fleet.capacity, np.ones(fleet.num_types, bool),
            fleet.prices, compiled.allow, compiled.penalty, compiled.conflict, compiled.node_cap,
            mode=mode)
        check(mirror_agrees(mirror, packs[mode], num_sub, num_levels),
              f"K6 {mode} differs from the numpy mirror on the constrained path")
    phase(
        "constrained", pods=len(pods), schedules=len(schedules), chosen_level=decision.chosen_level,
        description=repr(decision.description), nodes=result.node_count,
        unschedulable=len(result.unschedulable),
        per_zone=json.dumps(per_zone, sort_keys=True, separators=(",", ":")), skew=skew,
        cost_per_hr=f"{card_cost:.6f}", cpu_cost_per_hr=f"{cpu_cost:.6f}", cost_rel_diff=f"{cost_rel:.3e}",
        shape=f"G={g_pad},T={t_pad},L={l_pad}", k6_launches_per_solve=launches, k6_max_abs_err=k6_err,
        first_solve_ms=f"{first_ms:.3f}", p50_ms=f"{np.percentile(warm_ms, 50):.3f}",
        max_ms=f"{max(warm_ms):.3f}", **{f"{name}_ms": f"{ms:.3f}" for name, ms in layers.items()},
    )
    return {"operands": operands, "launches": launches, "max_abs_err": k6_err, "packs": packs}


def large_shapes_phase(catalog, device, num_pods: int = 12_000, num_shapes: int = 1_100) -> dict:
    """CostSolver on `device` over a schedule of many distinct shapes (padded
    G 2,048 at the defaults): every pod placed once; K2's rounds equal the
    plain version's on the CPU (the same dispatch with device="cpu"), K3's
    objective within the LP tolerance of its plain version on the card.
    Returns the padded main-path operands."""
    import torch

    from karpenter_tpu_torch.api.provisioner import Constraints
    from karpenter_tpu_torch.convert import fused_args_from_numpy
    from karpenter_tpu_torch.models import solver
    from karpenter_tpu_torch.ops import cuda_kernels, pack_kernel, score_kernel
    from karpenter_tpu_torch.ops.encode import build_fleet, group_pods

    pods = many_shapes_pods(num_pods, num_shapes)
    start = time.perf_counter()
    result = solver.CostSolver(device=device).solve(pods, catalog, Constraints())
    solve_ms = (time.perf_counter() - start) * 1e3
    check(all_pods_placed_once(result, pods), "the many-shapes solve did not place every pod exactly once")
    groups = group_pods(pods)
    fleet = build_fleet(catalog, Constraints(), pods, pods_need=groups.vectors.max(axis=0))
    args = (groups.vectors, groups.counts, fleet.capacity, fleet.total, fleet.prices)
    card = solver.fetch_plan(solver.cost_solve_dispatch(*args, device=device))
    cpu = solver.fetch_plan(solver.cost_solve_dispatch(*args, device="cpu"))
    for name in ("rounds_ffd", "rounds_cost"):
        for a, b in zip(getattr(card, name), getattr(cpu, name)):
            check(np.array_equal(np.asarray(a), np.asarray(b)),
                  f"K2 {name} differs from the plain version on the many-shapes schedule")
    padded = solver.pad_kernel_args(*args)
    vectors, counts, capacity, total, valid, prices = fused_args_from_numpy(*padded, device=device)
    effective = cuda_kernels._dominance_prices_ref(capacity, torch.where(valid, prices, torch.inf))
    solvable = torch.where(score_kernel.feasibility_mask(vectors, capacity, valid).any(dim=1), counts, 0)
    lp_args = (vectors, solvable, capacity, valid, effective)
    got = score_kernel.lp_relax(*lp_args, steps=300)
    want = score_kernel.lp_relax_body(*lp_args, steps=300)
    synchronize(device)
    lp_rel = abs(float(got.objective) - float(want.objective)) / abs(float(want.objective))
    check(lp_rel <= LP_OBJECTIVE_RTOL, f"K3 objective differs on the many-shapes schedule: {lp_rel:.3e}")
    k2_plan = pack_kernel.pack_launch_plan(vectors.shape[0], capacity.shape[0], vectors.shape[1])
    k3_plan = score_kernel.lp_launch_plan(vectors.shape[0], capacity.shape[0], vectors.shape[1])
    phase(
        "large_shapes", pods=len(pods), shapes=groups.num_groups,
        shape=f"G={vectors.shape[0]},T={capacity.shape[0]}", nodes=result.node_count,
        cost_per_hr=f"{result.projected_cost():.6f}", solve_ms=f"{solve_ms:.3f}",
        rounds_ffd=int(card.rounds_ffd.num_rounds), rounds_cost=int(card.rounds_cost.num_rounds),
        k3_objective_rel_err=f"{lp_rel:.3e}", k2_plan=f"{k2_plan}".replace(" ", ""),
        k3_plan=f"{k3_plan}".replace(" ", ""),
    )
    return {"args": (vectors, counts, capacity, total, valid, effective), "lp": lp_args}


# --- K8, the incremental encode ----------------------------------------------

def k8_cases():
    """(name, op, array, index, rows) K8 is held to its plain version on, as
    numpy: the scatter and the gather over float32 rows, int32 and bool
    values; a delta, a 1-element delta, sentinel-only index vectors, every
    row, and an empty permutation."""
    from karpenter_tpu_torch.ops.incremental import pad_indices

    rng = np.random.default_rng(8)

    def array(kind, rows):
        if kind == "f32":
            return rng.uniform(-1e3, 1e3, (rows, 8)).astype(np.float32)
        if kind == "i32":
            return rng.integers(-(2**31), 2**31 - 1, rows, dtype=np.int64).astype(np.int32)
        return rng.random(rows) < 0.5

    for kind in ("f32", "i32", "bool"):
        for count in (13, 1, 0, 64):
            real = np.sort(rng.choice(64, count, replace=False)).astype(np.int32)
            idx = pad_indices(real, 64)
            yield f"scatter-{kind}-{count}", "scatter", array(kind, 64), idx, array(kind, len(idx))
        for count in (23, 1, 0, 40):
            live = rng.permutation(40)[:count].astype(np.int32)
            yield f"gather-{kind}-{count}", "gather", array(kind, 40), pad_indices(live, 40), None
        yield f"gather-{kind}-empty", "gather", array(kind, 40), np.zeros(0, np.int32), None
    # The main path's slot arrays: 512 node rows, a 256-row delta.
    real = np.sort(rng.choice(512, 250, replace=False)).astype(np.int32)
    idx = pad_indices(real, 512)
    yield "scatter-f32-nodes", "scatter", array("f32", 512), idx, array("f32", len(idx))


def same_bits(a, b) -> bool:
    """Equal shapes, dtypes and bits (float32 compared as int32 words)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def k8_check(device) -> dict:
    """Every case of k8_cases through K8 on the card and its plain version
    on the same tensors: bit for bit, the scatter's input untouched."""
    import torch

    from karpenter_tpu_torch.convert import upload_packed
    from karpenter_tpu_torch.ops import incremental

    cases = 0
    for name, op, array, index, rows in k8_cases():
        if op == "scatter":
            dst, idx, values = upload_packed([array, index, rows], device)
            kept = dst.clone()
            got = incremental.scatter(dst, idx, values)
            want = incremental._scatter_ref(dst, idx, values)
            torch.cuda.synchronize()
            check(same_bits(dst, kept), f"K8 wrote into its input on {name}")
        else:
            src, perm = upload_packed([array, index], device)
            got = incremental.gather(src, perm)
            want = incremental._gather_ref(src, perm)
            torch.cuda.synchronize()
        check(same_bits(got, want), f"K8 differs from its plain version on {name}")
        cases += 1
    return {"cases": cases}


def plan_signature(result):
    """Everything a plan says, in order: bit-identical plans give equal
    values."""
    packings = [
        (
            tuple(it.name for it in p.instance_type_options),
            tuple((o.instance_type.name, o.zone, o.price) for o in p.pool_options or ()),
            p.node_quantity,
            tuple(tuple(pod.name for pod in node) for node in p.pods_per_node),
        )
        for p in result.packings
    ]
    return packings, [pod.name for pod in result.unschedulable]


def device_arrays_match_mirrors(state) -> bool:
    """The state's device arrays hold its host mirrors (node_used cast to
    float32, as the flush casts it)."""
    import torch

    _, dev = state.device_view()
    with state._lock:
        mirrors = {
            "group_vectors": state._group_vectors,
            "group_counts": state._group_counts,
            "node_capacity": state._node_capacity,
            "node_used": state._node_used.astype(np.float32),
            "node_live": state._node_live,
        }
    for name, mirror in mirrors.items():
        if not same_bits(dev[name].cpu(), torch.from_numpy(np.ascontiguousarray(mirror))):
            return False
    return True


def incremental_phase(device, num_pods: int = NUM_PODS, churn_fraction: float = 0.01,
                      sweeps: int = 12, parity_every: int = 4) -> dict:
    """The repository's steady-state churn scenario (bench.py
    bench_encode_incremental) over the port's Cluster and a
    DeviceClusterState on `device`: 50,000 pods bound over 500 nodes in 16
    shapes, then 1% churn a sweep (half bound pods deleted, half new pending
    pods, a quarter of them in a new shape). A sample is one flush plus the
    sorted view, synced. Every `parity_every` sweeps and at the end, the
    view must be bit-identical to group_pods over the store, node_used equal
    a pod walk, and the device arrays equal the host mirrors."""
    import torch

    from karpenter_tpu_torch.api.pods import PodSpec
    from karpenter_tpu_torch.cloudprovider import NodeSpec
    from karpenter_tpu_torch.controllers.cluster import Cluster
    from karpenter_tpu_torch.models.cluster_state import DeviceClusterState
    from karpenter_tpu_torch.ops import incremental
    from karpenter_tpu_torch.ops.encode import group_pods

    setup_start = time.perf_counter()
    rng = np.random.default_rng(11)
    cluster = Cluster()
    state = DeviceClusterState(cluster, device=device)
    shapes = [(int(rng.integers(1, 17)) * 250, int(rng.integers(1, 33)) * 256) for _ in range(16)]
    serial = 0

    def add_pod(shape):
        nonlocal serial
        cpu, mem = shape
        pod = PodSpec(name=f"enc-{serial}", requests={"cpu": f"{cpu}m", "memory": f"{mem}Mi"},
                      unschedulable=True)
        serial += 1
        cluster.apply_pod(pod)
        return pod

    pods_per_node = 100
    nodes = []
    for n in range(num_pods // pods_per_node):
        node = NodeSpec(name=f"enc-n{n}", capacity={"cpu": 512.0, "memory": 1 << 20})
        cluster.create_node(node)
        nodes.append(node)
    bound = []
    for i in range(num_pods):
        pod = add_pod(shapes[i % len(shapes)])
        cluster.bind_pod(pod, nodes[i // pods_per_node])
        bound.append(pod)
    setup_s = time.perf_counter() - setup_start

    # Warm pass: the first flush (a rebuild and a full upload) and one
    # untimed churn sweep, so the timed sweeps are the steady state.
    state.pending_groups()
    cluster.delete_pod(bound[0].namespace, bound[0].name)
    bound.pop(0)
    state.pending_groups()
    synchronize(device)

    # The full snapshot rebuild a restarted consumer pays.
    start = time.perf_counter()
    DeviceClusterState(cluster, subscribe=False, device=device).pending_groups()
    synchronize(device)
    encode_rebuild_ms = (time.perf_counter() - start) * 1e3

    def assert_parity():
        got = state.pending_groups()
        want = group_pods([p for p in cluster.list_pods() if p.is_provisionable()])
        check(np.array_equal(got.vectors, want.vectors) and np.array_equal(got.counts, want.counts),
              "the incremental encode diverged from group_pods over the store")
        check(same_bits(got.device_vectors[: got.num_groups].cpu(), torch.from_numpy(want.vectors))
              and same_bits(got.device_counts[: got.num_groups].cpu(), torch.from_numpy(want.counts))
              and not got.device_counts[got.num_groups :].any(),
              "the sorted device view differs from group_pods over the store")
        for probe in (nodes[0], nodes[len(nodes) // 2], nodes[-1]):
            walk = np.zeros(8, np.float64)
            for p in cluster.list_pods(node_name=probe.name):
                if not p.is_terminal():
                    walk += p.dense_vector[0].astype(np.float64)
            used = state.node_used(probe.name)
            check(used is not None and np.array_equal(used, walk), "node_used diverged from the pod walk")
        check(device_arrays_match_mirrors(state), "the device arrays differ from the host mirrors")

    churn = max(int(num_pods * churn_fraction), 2)
    samples = []
    arrivals = []
    deltas = []

    def churn_sweep(sweep):
        nonlocal arrivals
        for pod, node in arrivals:
            cluster.bind_pod(pod, node)
        arrivals = []
        for pod in bound[: churn // 2]:
            cluster.delete_pod(pod.namespace, pod.name)
        del bound[: churn // 2]
        fresh_shape = (250 * (17 + sweep), 256 * (3 + sweep % 5))
        for i in range(churn - churn // 2):
            pod = add_pod(fresh_shape if i % 4 == 0 else shapes[i % len(shapes)])
            arrivals.append((pod, nodes[(sweep * 31 + i) % len(nodes)]))
            bound.append(pod)

    incremental.scatter.launches = 0
    incremental.gather.launches = 0
    flushes = 0
    for sweep in range(sweeps):
        churn_sweep(sweep)
        with state._lock:
            deltas.append((len(state._group_dirty), len(state._node_dirty)))
        synchronize(device)
        start = time.perf_counter()
        state.pending_groups()
        synchronize(device)
        samples.append((time.perf_counter() - start) * 1e3)
        flushes += 1
        if (sweep + 1) % parity_every == 0:
            assert_parity()
            flushes += 1
    assert_parity()
    flushes += 1
    launches = {"scatter": incremental.scatter.launches, "gather": incremental.gather.launches}
    check(launches["scatter"] > 0 and launches["gather"] > 0,
          f"the churn sweeps did not launch both K8 kernels: {launches}")
    group_density, node_density = state.tombstone_density()
    phase(
        "incremental", pods=num_pods, nodes=len(nodes), churn_per_sweep=churn, sweeps=sweeps,
        setup_s=f"{setup_s:.1f}",
        encode_delta_ms=f"{np.percentile(samples, 50):.3f}",
        encode_delta_p99_ms=f"{np.percentile(samples, 99):.3f}",
        encode_rebuild_ms=f"{encode_rebuild_ms:.3f}",
        scatter_launches=launches["scatter"], gather_launches=launches["gather"], flushes=flushes,
        delta_rows="{}/{}".format(*np.max(deltas, axis=0)),
        rebuilds=state.rebuild_count, compactions=state.compaction_count,
        tombstone_density=f"{group_density:.4f}", parity_checks=sweeps // parity_every + 2,
    )
    return {"state": state, "launches": launches, "flushes": flushes, "deltas": deltas}


def k8_sweep_operands(state, deltas, device):
    """The K8 work of one steady-state sweep on `state`'s arrays: the
    scatters of a flush with the largest delta the sweeps saw (group and
    node rows at their slots) and the two gathers of the sorted view."""
    from karpenter_tpu_torch.convert import upload_packed
    from karpenter_tpu_torch.ops.incremental import pad_indices

    rng = np.random.default_rng(5)
    _, dev = state.device_view()
    group_rows, node_rows = (int(n) for n in np.max(deltas, axis=0))
    g_cap, n_cap = dev["group_vectors"].shape[0], dev["node_capacity"].shape[0]
    with state._lock:
        live_groups = np.nonzero(state._group_live)[0].astype(np.int32)
        live_nodes = np.nonzero(state._node_live)[0].astype(np.int32)
    g_idx = pad_indices(np.sort(rng.choice(live_groups, min(group_rows, len(live_groups)), replace=False)), g_cap)
    n_idx = pad_indices(np.sort(rng.choice(live_nodes, min(node_rows, len(live_nodes)), replace=False)), n_cap)
    perm = pad_indices(live_groups, g_cap)
    host = [
        g_idx, rng.uniform(0, 1e4, (len(g_idx), 8)).astype(np.float32),
        rng.integers(0, 1000, len(g_idx)).astype(np.int32),
        n_idx, rng.uniform(0, 1e4, (len(n_idx), 8)).astype(np.float32),
        rng.uniform(0, 1e4, (len(n_idx), 8)).astype(np.float32), np.ones(len(n_idx), bool), perm,
    ]
    g_idx_t, g_rows, g_counts, n_idx_t, n_cap_rows, n_used, n_live, perm_t = upload_packed(host, device)
    scatters = [
        (dev["group_vectors"], g_idx_t, g_rows), (dev["group_counts"], g_idx_t, g_counts),
        (dev["node_capacity"], n_idx_t, n_cap_rows), (dev["node_used"], n_idx_t, n_used),
        (dev["node_live"], n_idx_t, n_live),
    ]
    gathers = [(dev["group_vectors"], perm_t), (dev["group_counts"], perm_t)]
    # Bytes the kernels move: every index read, each in-range row read and
    # written by the scatter; the permutation read, each in-range row read
    # and every output row written by the gather.
    real_g, real_n, real_p = group_rows, node_rows, len(live_groups)
    moved = 0
    for (dst, idx, rows), real in zip(scatters, (real_g, real_g, real_n, real_n, real_n)):
        row_bytes = rows[0].numel() * rows.element_size()
        moved += 4 * idx.shape[0] + 2 * real * row_bytes
    for src, index in gathers:
        row_bytes = src[0].numel() * src.element_size()
        moved += 4 * index.shape[0] + real_p * row_bytes + index.shape[0] * row_bytes
    return scatters, gathers, moved


def fast_path_phase(catalog, cost_solver, device, cpu_cost: float, num_pods: int = NUM_PODS) -> dict:
    """The provisioning pass's fast path: the main path's 50,000 pending
    pods tracked by a DeviceClusterState on the card; encode_schedule hands
    CostSolver.solve_many_pipelined a pre-encoded pair whose pod tensors are
    already on the card. Held to the snapshot path (solve_many over the
    same pods: the same plan) and to the port's CPU run of these pods
    (`cpu_cost`: $/hr within 1e-4); K1-K4 launched once each; no
    pod tensor crosses host->device, and a warm solve uploads nothing
    (convert.upload_packed's counters); encode and
    dispatch pass under torch.cuda.set_sync_debug_mode("error"). Then 1%
    churn on the backlog and the same again, K8 launched."""
    import torch

    from karpenter_tpu_torch.api.provisioner import Constraints
    from karpenter_tpu_torch.controllers.cluster import Cluster
    from karpenter_tpu_torch.convert import upload_packed
    from karpenter_tpu_torch.models import solver
    from karpenter_tpu_torch.models.cluster_state import DeviceClusterState
    from karpenter_tpu_torch.ops import cuda_kernels, incremental, pack_kernel, score_kernel
    from karpenter_tpu_torch.ops.encode import build_fleet, group_pods

    pods, _ = make_workload(num_pods)
    start = time.perf_counter()
    cluster = Cluster()
    state = DeviceClusterState(cluster, device=device)
    for pod in pods:
        cluster.apply_pod(pod)
    setup_s = time.perf_counter() - start
    constraints = Constraints()
    kernels = {
        "dominance_prices": cuda_kernels.dominance_prices, "pack_kernel": pack_kernel.pack_kernel,
        "lp_relax": score_kernel.lp_relax, "compact_plan": pack_kernel.compact_plan,
    }

    def pending():
        return [p for p in cluster.list_pods() if p.is_provisionable()]

    def uploads():
        return upload_packed.copies, upload_packed.arrays, upload_packed.bytes

    def fast_solve(batch):
        """One fast-path solve: counts zeroed just before, read after;
        encode and dispatch under the sync check."""
        for fn in kernels.values():
            fn.launches = 0
        incremental.scatter.launches = incremental.gather.launches = 0
        synchronize(device)
        torch.cuda.set_sync_debug_mode("error")
        try:
            start = time.perf_counter()
            pair = state.encode_schedule(batch, catalog, constraints, [])
            encode_ms = (time.perf_counter() - start) * 1e3
            check(pair is not None and pair[0].device_vectors is not None,
                  "encode_schedule did not cover the backlog")
            before = uploads()
            stream = cost_solver.solve_many_pipelined([pair])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        (result,) = list(stream)
        after = uploads()
        launches = {name: fn.launches for name, fn in kernels.items()}
        check(all(count == 1 for count in launches.values()),
              f"the fast-path solve did not launch each of K1-K4 exactly once: {launches}")
        k8 = {"scatter": incremental.scatter.launches, "gather": incremental.gather.launches}
        return pair, result, encode_ms, tuple(b - a for a, b in zip(before, after)), launches, k8

    fleet_arrays = None
    rounds = []
    for label in ("backlog", "churned"):
        batch = pending()
        pack_kernel.reset_device_resident()
        pair, result, encode_fast_ms, cold_uploads, launches, k8 = fast_solve(batch)
        fleet_arrays = fleet_arrays or sum(
            -(-np.asarray(a).nbytes // 16) * 16
            for a in solver.pad_kernel_args(pair[0].vectors, pair[0].counts, pair[1].capacity,
                                            pair[1].total, pair[1].prices)[2:])
        # Cold (the fleet not resident): exactly the four fleet arrays went
        # up, so no pod tensor did.
        check(cold_uploads == (1, 4, fleet_arrays),
              f"the {label} fast-path solve uploaded {cold_uploads}, not the fleet's 4 arrays alone")
        check(k8["gather"] == 2, f"the {label} encode launched K8's gather {k8['gather']} times, not 2")
        check(all_pods_placed_once(result, batch), f"the {label} fast path did not place every pod once")
        # Warm: the same pair again uploads nothing.
        before = uploads()
        (again,) = list(cost_solver.solve_many_pipelined([pair]))
        synchronize(device)
        warm_uploads = tuple(b - a for a, b in zip(before, uploads()))
        check(warm_uploads == (0, 0, 0), f"the warm {label} fast-path solve copied to the card: {warm_uploads}")
        check(plan_signature(again) == plan_signature(result), f"two {label} fast-path solves differ")
        (snapshot,) = cost_solver.solve_many([(batch, catalog, constraints, ())])
        check(plan_signature(result) == plan_signature(snapshot),
              f"the {label} fast path's plan differs from the snapshot path's")
        check(result.projected_cost() == snapshot.projected_cost(), "fast and snapshot $/hr differ")
        rounds.append({"label": label, "k8": k8, "encode_fast_ms": encode_fast_ms,
                       "cost": result.projected_cost(), "nodes": result.node_count})
        if label == "backlog":
            cpu_rel = abs(result.projected_cost() - cpu_cost) / cpu_cost
            check(cpu_rel <= 1e-4, f"fast-path $/hr differs between the card and the CPU by {cpu_rel:.3e}")
            # Warm p50s, 10 runs each: the fast path (encode + solve) and the
            # snapshot path (group_pods + build_fleet + solve).
            fast_ms, snap_ms, skipped_ms = [], [], []
            for _ in range(10):
                start = time.perf_counter()
                fast_pair = state.encode_schedule(batch, catalog, constraints, [])
                list(cost_solver.solve_many_pipelined([fast_pair]))
                fast_ms.append((time.perf_counter() - start) * 1e3)
                start = time.perf_counter()
                cost_solver.solve_many([(batch, catalog, constraints, ())])
                snap_ms.append((time.perf_counter() - start) * 1e3)
                start = time.perf_counter()
                snap_groups = group_pods(batch)
                build_fleet(catalog, constraints, batch, pods_need=snap_groups.vectors.max(axis=0))
                skipped_ms.append((time.perf_counter() - start) * 1e3)
            # 1% churn on the backlog, twice: half the churn deleted, half
            # new pending pods (a quarter of them in a new shape no larger
            # than the backlog's largest, so the fleet keeps its content).
            # The first churn grows the group slots past their bucket of 16
            # (a full upload, a new epoch); the second is the steady state,
            # a flush of K8 scatters.
            from karpenter_tpu_torch.api.pods import PodSpec

            churn = len(batch) // 100
            for step in range(2):
                for pod in batch[step * churn : step * churn + churn // 2]:
                    cluster.delete_pod(pod.namespace, pod.name)
                for i in range(churn - churn // 2):
                    cpu, mem = (1250, 1280) if i % 4 == 0 else pod_shapes(0)[i % 16]
                    cluster.apply_pod(PodSpec(name=f"churn-{step}-{i}", unschedulable=True,
                                              requests={"cpu": f"{cpu}m", "memory": f"{mem}Mi"}))
                if step == 0:
                    state.flush()
    check(rounds[1]["k8"]["scatter"] > 0, f"the churned encode launched no K8 scatter: {rounds[1]['k8']}")

    # Time to the first result of an 8-schedule pipelined solve, against
    # the batch solve of the same schedules.
    batch = pending()
    encoded = solver.Solver._encode_problems([(batch[k::8], catalog, constraints, ()) for k in range(8)])
    cost_solver.solve_encoded_many(encoded)  # warm
    start = time.perf_counter()
    stream = cost_solver.solve_encoded_pipelined(encoded)
    piped = [next(stream)]
    first_ms = (time.perf_counter() - start) * 1e3
    piped += list(stream)
    piped_ms = (time.perf_counter() - start) * 1e3
    start = time.perf_counter()
    batched = cost_solver.solve_encoded_many(encoded)
    batch_ms = (time.perf_counter() - start) * 1e3
    check([plan_signature(r) for r in piped] == [plan_signature(r) for r in batched],
          "the pipelined and batched solves of 8 schedules differ")
    phase(
        "fast_path", pods=num_pods, types=len(catalog), setup_s=f"{setup_s:.1f}",
        nodes=rounds[0]["nodes"], cost_per_hr=f"{rounds[0]['cost']:.6f}", cpu_cost_rel_diff=f"{cpu_rel:.3e}",
        plan="identical to the snapshot path", pod_h2d="none", warm_fleet_uploads=0,
        encode_dispatch_sync_free="yes", launches=json.dumps(launches, separators=(",", ":")),
        fast_p50_ms=f"{np.percentile(fast_ms, 50):.3f}", snapshot_p50_ms=f"{np.percentile(snap_ms, 50):.3f}",
        encode_fast_ms=f"{rounds[0]['encode_fast_ms']:.3f}",
        encode_skipped_ms=f"{np.percentile(skipped_ms, 50):.3f}",
        churned_k8=json.dumps(rounds[1]["k8"], separators=(",", ":")),
        churned_encode_ms=f"{rounds[1]['encode_fast_ms']:.3f}", churned_cost_per_hr=f"{rounds[1]['cost']:.6f}",
        first_result_ms=f"{first_ms:.3f}", pipelined8_ms=f"{piped_ms:.3f}", batch8_ms=f"{batch_ms:.3f}",
    )
    return {"encoded": encoded, "plans": [plan_signature(r) for r in batched]}


def oom_ladder_phase(cost_solver, encoded, clean) -> None:
    """The device-memory ladder on the card, on the fast path's 8-schedule
    batch: an injected out-of-memory fault at one and two split depths, the
    KARPENTER_HBM_BYTES pre-split, and a fault in the middle of the
    pipeline each give the unarmed run's plans bit for bit, and the split
    counter counts them; the floor is never reached."""
    from karpenter_tpu_torch.models import solver
    from karpenter_tpu_torch.utils import faultpoints

    def split(reason):
        return solver.SOLVER_BATCH_SPLIT_TOTAL.get(reason)

    floor = split("floor")
    counted = {}
    for depth in (1, 2):
        before = split("oom")
        faultpoints.arm("solver.dispatch", "oom", count=depth)
        try:
            plans = [plan_signature(r) for r in cost_solver.solve_encoded_many(encoded)]
            fired = faultpoints.fired("solver.dispatch")
        finally:
            faultpoints.disarm_all()
        check(plans == clean, f"the bisect at depth {depth} changed the plans")
        check(fired == depth and split("oom") == before + depth,
              f"depth {depth}: {fired} faults fired, {split('oom') - before} bisects counted")
        counted[f"oom{depth}"] = split("oom") - before
    one = max(solver._estimate_solve_bytes(*item) for item in encoded)
    before = split("estimate")
    os.environ["KARPENTER_HBM_BYTES"] = str(2.5 * one / solver.HBM_SAFETY_FACTOR)
    try:
        chunks = len(solver._presplit_for_hbm(encoded, cost_solver.device))
        plans = [plan_signature(r) for r in cost_solver.solve_encoded_many(encoded)]
    finally:
        del os.environ["KARPENTER_HBM_BYTES"]
    check(chunks > 1 and plans == clean and split("estimate") == before + chunks - 1,
          f"the HBM pre-split gave {chunks} chunks, {split('estimate') - before} counted")
    counted["estimate"] = split("estimate") - before
    before = split("oom")
    stream = cost_solver.solve_encoded_pipelined(encoded)
    plans = [plan_signature(next(stream))]
    faultpoints.arm("solver.dispatch", "oom", count=1)
    try:
        plans += [plan_signature(r) for r in stream]
    finally:
        faultpoints.disarm_all()
    check(plans == clean and split("oom") == before + 1, "the mid-pipeline fault changed the plans")
    counted["mid_pipeline"] = split("oom") - before
    check(split("floor") == floor, "the ladder reached its floor")
    phase("oom_ladder", schedules=len(encoded), plans="bit-identical", floor=0,
          **{key: value for key, value in counted.items()})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on the card", file=sys.stderr)
        return 2

    from karpenter_tpu_torch.api.provisioner import Constraints
    from karpenter_tpu_torch.convert import fused_args_from_numpy, upload_packed
    from karpenter_tpu_torch.models import solver
    from karpenter_tpu_torch.ops import (
        consolidate_kernel, cuda_build, cuda_kernels, incremental, native, pack_kernel, score_kernel,
    )
    from karpenter_tpu_torch.ops.encode import build_fleet, group_pods

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    capability = torch.cuda.get_device_capability(device)
    check(capability == (9, 0), f"compute capability {capability} is not sm_90")
    phase("card", smi=repr(smi), torch=torch.__version__, cuda=torch.version.cuda,
          capability=f"{capability[0]}.{capability[1]}")

    # 2. build: one nvcc per kernel source, started together; the host
    # library (g++) meanwhile.
    libraries = [
        cuda_kernels.LIBRARY, pack_kernel.LIBRARY, score_kernel.LIBRARY,
        pack_kernel.COMPACT_LIBRARY, consolidate_kernel.LIBRARY, pack_kernel.LEVELS_LIBRARY,
        incremental.LIBRARY,
    ]
    build_s = cuda_build.build_all(libraries)
    for library in libraries:
        library.load()
        for line in library.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {library.source.name}: {line.strip()}")
    check(native.available(), "host library csrc/host/ffd.cc did not build")
    phase("build", seconds=f"{build_s:.2f}", sources=",".join(lib.source.name for lib in libraries))

    # Encode the main path's workload once (host work, timed).
    pods, catalog = make_workload()
    start = time.perf_counter()
    groups = group_pods(pods)
    fleet = build_fleet(catalog, Constraints(), pods, pods_need=groups.vectors.max(axis=0))
    encode_ms = (time.perf_counter() - start) * 1e3
    padded = solver.pad_kernel_args(groups.vectors, groups.counts, fleet.capacity, fleet.total, fleet.prices)
    main_args = fused_args_from_numpy(*padded, device=device)
    vectors, counts, capacity, total, valid, prices = main_args
    main_prices = cuda_kernels._dominance_prices_ref(capacity, torch.where(valid, prices, torch.inf))

    # 3. every kernel against its plain version on the card: K1 and K2 bit
    # for bit, K3 to the LP tolerances.
    k1_cases = 0
    k1_err = 0.0
    for cap_np, price_np in list(dominance_cases()) + [
        (padded[2], np.where(padded[4], padded[5], np.inf).astype(np.float32))
    ]:
        cap_t = torch.from_numpy(np.ascontiguousarray(cap_np)).to(device)
        price_t = torch.from_numpy(np.ascontiguousarray(price_np)).to(device)
        got = cuda_kernels.dominance_prices(cap_t, price_t)
        want = cuda_kernels._dominance_prices_ref(cap_t, price_t)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K1 differs from its plain version at T={cap_np.shape[0]}")
        finite = torch.isfinite(want)
        if finite.any():
            k1_err = max(k1_err, float((got[finite] - want[finite]).abs().max()))
        k1_cases += 1
    rng = np.random.default_rng(7)
    k2_cases = 0
    k2_err = 0.0
    # (32, 512) needs more than 48 KB of shared memory; (64, 1024) and
    # (64, 2048) put the fills in global scratch; (16, 300) leaves part of
    # the block's last warp without a type; (16, 1024) fills a block of
    # 1,024 threads, one type each; (64, 2048) gives each thread two types.
    pack_shapes = ((8, 8), (16, 64), (16, 300), (16, 512), (32, 256), (32, 512), (16, 1024),
                   (64, 1024), (64, 2048))
    k2_plans = [pack_kernel.pack_launch_plan(g, t, 8) for g, t in pack_shapes]
    check({p.fills_in_shared for p in k2_plans} == {True, False}
          and {p.types_per_thread for p in k2_plans} >= {1, 2}
          and any(p.threads * p.types_per_thread > t for p, (_, t) in zip(k2_plans, pack_shapes)),
          "the K2 shapes do not cover every launch plan")
    problems = [random_pack_problem(rng, g, t) for g, t in pack_shapes]
    problems.append(tuple(padded[:5]) + (main_prices.cpu().numpy(),))
    problems += [problem for _, problem, _ in tied_weight_cases() if problem is not None]
    compact_pairs = []
    for problem in problems:
        args = fused_args_from_numpy(*problem, device=device)
        pair = pack_kernel.pack_kernel_pair(*args)
        for mode, from_pair in zip(("ffd", "cost"), pair):
            alone = pack_kernel.pack_kernel(*args, mode=mode)
            plain = pack_kernel._pack_kernel_ref(*args, mode=mode)
            torch.cuda.synchronize()
            check(rounds_equal(alone, plain), f"K2 {mode} differs from its plain version at G={problem[0].shape[0]} T={problem[2].shape[0]}")
            check(rounds_equal(from_pair, plain), f"K2 pair {mode} differs from its plain version")
            k2_err = max(k2_err, rounds_abs_err(from_pair, plain))
            k2_cases += 1
        again = pack_kernel.pack_kernel_pair(*args)
        torch.cuda.synchronize()
        check(all(rounds_equal(a, b) for a, b in zip(pair, again)),
              f"two launches of K2 differ at G={problem[0].shape[0]} T={problem[2].shape[0]}")
        feasible = score_kernel.feasibility_mask(args[0], args[2], args[4]).any(dim=1)
        compact_pairs.append((pair, feasible))
    # K4 on every pair of rounds above and on dense rounds past the entry
    # budget (G = 64 takes 35 tiles of the kernel's block).
    for num_groups, density in ((16, 0.9), (64, 0.5)):
        compact_pairs.append((
            tuple(dense_rounds(num_groups, seed, density, device) for seed in (0, 1)),
            torch.from_numpy(np.random.default_rng(2).random(num_groups) < 0.7).to(device),
        ))
    k4_cases = 0
    k4_err = 0
    for (ffd_rounds, cost_rounds), feasible in compact_pairs:
        got = pack_kernel.compact_plan(ffd_rounds, cost_rounds, feasible)
        want = pack_kernel._compact_plan_ref(ffd_rounds, cost_rounds, feasible)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K4 differs from its plain version at G={feasible.shape[0]}")
        k4_err = max(k4_err, int((got.long() - want.long()).abs().max()))
        k4_cases += 1
    # K3 on the non-degenerate LP family, padded out to each shape: every
    # seed at the shapes of the main path's bucket, two seeds at the shapes
    # that reach the rest of the launch plans (every cluster size the rule
    # chooses, a T the blocks do not divide, G 1 and G 64, T 1024, the state
    # in global scratch), and the main path's shape at every cluster size.
    k3_cases = 0
    k3_err = 0.0
    k3_obj_err = 0.0
    k3_shapes = ((8, 16), (16, 512), (32, 512))
    k3_plan_shapes = ((16, 64), (16, 128), (16, 256), (16, 300), (1, 512), (64, 512), (16, 1024), (128, 2048))
    k3_plans = [score_kernel.lp_launch_plan(g, t, 8) for g, t in k3_shapes + k3_plan_shapes]
    check({p.cluster for p in k3_plans} == {2, 4, 8, 16}
          and {p.state_in_shared for p in k3_plans} == {True, False}
          and any(t % p.types_per_block for p, (_, t) in zip(k3_plans, k3_shapes + k3_plan_shapes)),
          "the K3 shapes do not cover every launch plan")

    def k3_check(lp_args, got, label):
        nonlocal k3_cases, k3_err, k3_obj_err
        want = score_kernel.lp_relax_body(*lp_args, steps=300)
        torch.cuda.synchronize()
        obj_err = abs(float(got.objective) - float(want.objective)) / abs(float(want.objective))
        err = float((got.assignment - want.assignment).abs().max())
        check(obj_err <= LP_OBJECTIVE_RTOL and err <= LP_ASSIGNMENT_ATOL,
              f"K3 differs from its plain version at {label}: "
              f"objective {obj_err:.3e} relative, assignment {err:.3e}")
        k3_err = max(k3_err, err)
        k3_obj_err = max(k3_obj_err, obj_err)
        k3_cases += 1

    for seed in LP_SEEDS:
        for shape in k3_shapes + (k3_plan_shapes if seed in LP_SEEDS[:2] else ()):
            lp_args = lp_inputs(seed, shape, device)
            k3_check(lp_args, score_kernel.lp_relax(*lp_args, steps=300), f"seed {seed} shape {shape}")
    for cluster in (2, 4, 8, 16):
        lp_args = lp_inputs(LP_SEEDS[0], (16, 512), device)
        plan = score_kernel.lp_plan_for_cluster(16, 512, 8, cluster)
        k3_check(lp_args, score_kernel._launch(*lp_args, 300, plan), f"cluster {cluster}")
    # The 50k problem: its prices tie per core within a family, so the LP is
    # degenerate and only the objective is determined by the inputs (PERF.md).
    main_solvable = torch.where(
        score_kernel.feasibility_mask(vectors, capacity, valid).any(dim=1), counts, 0)
    main_lp = (vectors, main_solvable, capacity, valid, main_prices)
    got = score_kernel.lp_relax(*main_lp, steps=300)
    want = score_kernel.lp_relax_body(*main_lp, steps=300)
    torch.cuda.synchronize()
    main_obj_err = abs(float(got.objective) - float(want.objective)) / abs(float(want.objective))
    main_assign_err = float((got.assignment - want.assignment).abs().max())
    again = score_kernel.lp_relax(*main_lp, steps=300)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)), "two launches of K3 differ on the 50k problem")
    main_row_err = float((got.assignment.sum(dim=1) - main_solvable.float()).abs().max())
    print(f"  K3 on the 50k problem: objective {main_obj_err:.3e} relative, assignment "
          f"max abs {main_assign_err:.3e} pods (degenerate), row sums {main_row_err:.3e} pods off the counts")
    check(main_obj_err <= LP_OBJECTIVE_RTOL, f"K3 objective differs on the 50k problem: {main_obj_err:.3e}")
    # K6 on every case of k6_cases, bit for bit; two launches alike.
    k6_plans = [pack_kernel.levels_launch_plan(g, t, 8) for g, t, _, _ in K6_SHAPES]
    check({p.tables_in_shared for p in k6_plans} == {True, False}
          and {p.placed_in_registers for p in k6_plans} == {True, False}
          and any(t > p.threads for p, (_, t, _, _) in zip(k6_plans, K6_SHAPES))
          and any(t % 32 for _, t, _, _ in K6_SHAPES),
          "the K6 shapes do not cover every launch plan")
    k6_cases_run = 0
    k6_err = 0.0
    tied = [(name, operands, "cost") for name, _, operands in tied_weight_cases() if operands is not None]
    for name, operands, mode in list(k6_cases()) + tied:
        tensors = upload_packed(list(operands), device)
        got = pack_kernel.pack_kernel_levels(*tensors, mode=mode)
        want = plain_levels(tensors, mode)
        torch.cuda.synchronize()
        check(level_packs_equal(got, want), f"K6 differs from its plain version on {name}")
        k6_err = max(k6_err, level_pack_abs_err(got, want))
        k6_cases_run += 1
        if k6_cases_run == 4:
            again = pack_kernel.pack_kernel_levels(*tensors, mode=mode)
            torch.cuda.synchronize()
            check(level_packs_equal(got, again), f"two launches of K6 differ on {name}")
    # K8 on every case of k8_cases, bit for bit.
    k8 = k8_check(device)
    phase("kernels", k1_cases=k1_cases, k2_cases=k2_cases, k3_cases=k3_cases, k4_cases=k4_cases,
          k6_cases=k6_cases_run, k8_cases=k8["cases"], k1_max_abs_err=k1_err, k2_max_abs_err=k2_err,
          k3_max_abs_err=k3_err, k4_max_abs_err=k4_err, k6_max_abs_err=k6_err, k8_max_abs_err=0,
          k3_objective_rel_err=f"{k3_obj_err:.3e}", k3_main_objective_rel_err=f"{main_obj_err:.3e}")

    # 4. the main path, through the entry point a user calls.
    os.environ["KARPENTER_HOST_SOLVE"] = "0"
    cost_solver = solver.CostSolver(device="cuda")
    cuda_kernels.dominance_prices.launches = 0
    pack_kernel.pack_kernel.launches = 0
    score_kernel.lp_relax.launches = 0
    pack_kernel.compact_plan.launches = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    result = cost_solver.solve(pods, catalog, Constraints())
    first_solve_ms = (time.perf_counter() - start) * 1e3
    launches = {
        "dominance_prices": cuda_kernels.dominance_prices.launches,
        "pack_kernel": pack_kernel.pack_kernel.launches,
        "lp_relax": score_kernel.lp_relax.launches,
        "compact_plan": pack_kernel.compact_plan.launches,
    }
    check(all(count == 1 for count in launches.values()),
          f"the main path's solve did not launch each kernel exactly once: {launches}")
    check(all_pods_placed_once(result, pods), "the main path did not place every pod exactly once")
    gpu_cost = result.projected_cost()
    check(np.isfinite(gpu_cost) and gpu_cost > 0, f"projected cost {gpu_cost} is not a finite price")
    solve_ms = []
    for _ in range(10):
        start = time.perf_counter()
        cost_solver.solve_encoded(groups, fleet)
        solve_ms.append((time.perf_counter() - start) * 1e3)
    phase(
        "solve", pods=len(pods), types=len(catalog), nodes=result.node_count,
        cost_per_hr=f"{gpu_cost:.6f}", encode_ms=f"{encode_ms:.3f}",
        first_solve_ms=f"{first_solve_ms:.3f}",
        p50_ms=f"{np.percentile(solve_ms, 50):.3f}", p99_ms=f"{np.percentile(solve_ms, 99):.3f}",
        launches=json.dumps(launches, separators=(",", ":")),
    )

    # 5. the same encoded problem through the plain versions on the CPU. The
    # card's dispatch may not sync with the host, and returns before the card
    # is done: the host overlap work starts while the card computes.
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        start = time.perf_counter()
        handle = solver.cost_solve_dispatch(
            groups.vectors, groups.counts, fleet.capacity, fleet.total, fleet.prices, device="cuda")
        dispatch_ms = (time.perf_counter() - start) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode("default")
    still_running = not torch.cuda.current_stream().query()
    start = time.perf_counter()
    gpu_plan = solver.fetch_plan(handle)
    fetch_wait_ms = (time.perf_counter() - start) * 1e3
    check(still_running, "cost_solve_dispatch returned after the card had finished")
    cpu_plan = solver.fetch_plan(
        solver.cost_solve_dispatch(groups.vectors, groups.counts, fleet.capacity, fleet.total, fleet.prices, device="cpu")
    )
    for name in ("rounds_ffd", "rounds_cost"):
        for a, b in zip(getattr(gpu_plan, name), getattr(cpu_plan, name)):
            check(np.array_equal(np.asarray(a), np.asarray(b)), f"{name} differs between the card and the CPU")
    check(np.array_equal(gpu_plan.feasible_any, cpu_plan.feasible_any), "feasible_any differs between the card and the CPU")
    cpu_result = solver.CostSolver(device="cpu").solve_encoded(groups, fleet)
    cpu_cost = cpu_result.projected_cost()
    rel = abs(gpu_cost - cpu_cost) / cpu_cost
    check(rel <= 1e-4, f"$/hr differs between the card ({gpu_cost}) and the CPU ({cpu_cost})")
    check(all_pods_placed_once(cpu_result, pods), "the CPU run did not place every pod exactly once")
    lp_rel = abs(gpu_plan.lp_objective - cpu_plan.lp_objective) / abs(cpu_plan.lp_objective)
    check(lp_rel <= 1e-3, f"LP objective differs between the card and the CPU by {lp_rel:.3e} relative")
    phase("cpu", rounds="identical", cost_rel_diff=f"{rel:.3e}", lp_objective_rel_diff=f"{lp_rel:.3e}",
          rounds_ffd=int(gpu_plan.rounds_ffd.num_rounds), rounds_cost=int(gpu_plan.rounds_cost.num_rounds),
          gpu_cost_per_hr=f"{gpu_cost:.6f}", cpu_cost_per_hr=f"{cpu_cost:.6f}",
          dispatch_sync_free="yes", dispatch_ms=f"{dispatch_ms:.3f}", fetch_wait_ms=f"{fetch_wait_ms:.3f}")

    # 6. a batch of 8 schedules sharing one fetch.
    batch = [(pods[k::8], catalog, Constraints(), ()) for k in range(8)]
    encoded = solver.Solver._encode_problems(batch)
    cost_solver.solve_encoded_many(encoded)  # warm
    start = time.perf_counter()
    batch_results = cost_solver.solve_encoded_many(encoded)
    batch_ms = (time.perf_counter() - start) * 1e3
    for (schedule_pods, *_), schedule_result in zip(batch, batch_results):
        check(all_pods_placed_once(schedule_result, schedule_pods), "a batched schedule lost pods")
    phase("batch", schedules=len(batch), pods=sum(len(b[0]) for b in batch), batch8_ms=f"{batch_ms:.3f}")

    # 7. the incremental encode under steady-state churn (K8), the
    # provisioning pass's fast path through it, and the device-memory
    # ladder on the fast path's 8-schedule batch.
    churn = incremental_phase(device)
    fast = fast_path_phase(catalog, cost_solver, device, cpu_cost)
    oom_ladder_phase(cost_solver, fast["encoded"], fast["plans"])

    # 8. the consolidation path: one sweep at the large-cluster envelope.
    sweep = consolidate_phase(catalog, device)
    k7_operands = sweep["operands"]
    c_pad, g_pad, dims_c = k7_operands[0].shape

    # 9. the constrained path: the main path's pods under a zonal spread
    # and two preferences, through Scheduler and solve_constrained.
    levels = constrained_phase(catalog, device)

    # 10. many shapes: K2 and K3 past the sizes they once refused.
    large = large_shapes_phase(catalog, device)
    plan_cases = 0
    plan_err = 0.0
    for num_groups_x, num_types_x in ((2048, 512), (16, 8192)):
        args = fused_args_from_numpy(*sparse_pack_problem(3, num_groups_x, num_types_x, 200), device=device)
        pair = pack_kernel.pack_kernel_pair(*args)
        for mode, got in zip(("ffd", "cost"), pair):
            want = pack_kernel._pack_kernel_ref(*args, mode=mode)
            torch.cuda.synchronize()
            check(rounds_equal(got, want), f"K2 {mode} differs from its plain version at G={num_groups_x} T={num_types_x}")
            plan_err = max(plan_err, rounds_abs_err(got, want))
            plan_cases += 1
    for shape in ((2048, 512), (16, 8192), (2048, 2048)):
        lp_args = lp_inputs(LP_SEEDS[0], shape, device)
        k3_check(lp_args, score_kernel.lp_relax(*lp_args, steps=300), f"launch plan at {shape}")
        plan_cases += 1
    print(f"  launch plans past the old limits: {plan_cases} cases, K2 max abs err {plan_err}, "
          f"K2 at G 2048 T 512: {pack_kernel.pack_launch_plan(2048, 512, 8)}, "
          f"K2 at T 8192: {pack_kernel.pack_launch_plan(16, 8192, 8)}, "
          f"K3 at G 2048 T 2048: {score_kernel.lp_launch_plan(2048, 2048, 8)}")

    # 11. kernel timing at the main path's shapes.
    num_types, dims = capacity.shape
    num_groups = vectors.shape[0]
    valid_prices = torch.where(valid, prices, torch.inf)
    k1_call = functools.partial(cuda_kernels.dominance_prices, capacity, valid_prices)
    k1_event_ms = time_cuda(k1_call, reps=200)
    k1_ms = device_ms_per_call(k1_call, ["dominance_kernel"], reps=200)
    k1_plain_ms = time_cuda(lambda: cuda_kernels._dominance_prices_ref(capacity, valid_prices), reps=200)
    k1_bytes = 4 * (num_types * dims + 2 * num_types)
    k1_ops = num_types * num_types * (dims + 1)
    k2_call = functools.partial(
        pack_kernel.pack_kernel_pair, vectors, counts, capacity, total, valid, main_prices)
    k2_event_ms = time_cuda(k2_call, reps=50)
    k2_ms = device_ms_per_call(k2_call, ["pack_rounds_kernel"], reps=50)
    k2_plain_ms = time_cuda(
        lambda: [pack_kernel._pack_kernel_ref(vectors, counts, capacity, total, valid, main_prices, mode=m) for m in ("ffd", "cost")],
        reps=5, warmup=1,
    )
    # Each mode alone: its device time over its rounds; the pair takes as
    # long as its slower mode, whose time per round the line reports.
    k2_mode_us = {}
    for mode, plan_rounds in (("ffd", gpu_plan.rounds_ffd), ("cost", gpu_plan.rounds_cost)):
        mode_ms = device_ms_per_call(functools.partial(
            pack_kernel.pack_kernel, vectors, counts, capacity, total, valid, main_prices, mode=mode),
            ["pack_rounds_kernel"], reps=20)
        k2_mode_us[mode] = (mode_ms, mode_ms * 1e3 / max(int(plan_rounds.num_rounds), 1))
    k2_slow_mode = max(k2_mode_us, key=lambda m: k2_mode_us[m][0])
    print("  K2 per mode: " + ", ".join(
        f"{m} {ms:.4f} ms, {us:.3f} us a round" for m, (ms, us) in k2_mode_us.items()))
    words = pack_kernel.LIBRARY.load().ktt_pack_rounds_words(num_groups)
    k2_bytes = 4 * (num_groups * dims + num_groups + num_types * dims + num_types) + num_types + 2 * 4 * words
    # Operations this run's data needs: per mode and round, the group scan
    # over every valid type for the groups still holding pods (a division,
    # a minimum, a multiply and a subtract per axis the group requests, an
    # add and a floor).
    valid_types = int(valid.sum())
    scan = valid_types * (4 * (vectors[: groups.num_groups] > 0).sum(dim=1) + 2).long().cpu().numpy()
    k2_ops = 0
    for plan_rounds in (gpu_plan.rounds_ffd, gpu_plan.rounds_cost):
        remaining = groups.counts.astype(np.int64).copy()
        for r in range(int(plan_rounds.num_rounds)):
            k2_ops += int(scan[remaining > 0].sum())
            remaining -= plan_rounds.round_repl[r] * plan_rounds.round_fill[r, : groups.num_groups]

    def bound(byte_count, op_count):
        byte_ms = byte_count / HBM_BYTES_PER_S * 1e3
        op_ms = op_count / FP32_OPS_PER_S * 1e3
        return max(byte_ms, op_ms), ("bytes" if byte_ms >= op_ms else "operations")

    lp_steps = 300
    k3_call = functools.partial(score_kernel.lp_relax, *main_lp, steps=lp_steps)
    k3_event_ms = time_cuda(k3_call, reps=20)
    k3_ms = device_ms_per_call(k3_call, ["lp_relax_kernel"], reps=20)
    k3_plain_ms = time_cuda(lambda: score_kernel.lp_relax_body(*main_lp, steps=lp_steps), reps=5, warmup=1)
    # Every cluster size at the main path's shape; the rule's choice is
    # the launch plan lp_relax takes.
    k3_sweep = {}
    for cluster in (2, 4, 8, 16):
        plan = score_kernel.lp_plan_for_cluster(num_groups, num_types, dims, cluster)
        k3_sweep[cluster] = device_ms_per_call(
            functools.partial(score_kernel._launch, *main_lp, lp_steps, plan), ["lp_relax_kernel"], reps=20)
    k3_rule = score_kernel.lp_launch_plan(num_groups, num_types, dims)
    print(f"  K3 cluster sweep (device ms, rule picks {k3_rule.cluster}): " + ", ".join(
        f"{cluster}: {ms:.4f}" for cluster, ms in k3_sweep.items()))
    # Each input read once (the bias table included), each output written once.
    k3_bytes = (4 * (num_groups * dims + num_groups + num_types * dims + num_types + 2 * lp_steps)
                + num_types + 4 * (num_groups * num_types + num_types + 1))
    k3_ops = lp_operations(num_groups, num_types, dims, lp_steps)

    main_ffd, main_cost = pack_kernel.pack_kernel_pair(vectors, counts, capacity, total, valid, main_prices)
    main_feasible = score_kernel.feasibility_mask(vectors, capacity, valid).any(dim=1)
    k4_call = functools.partial(pack_kernel.compact_plan, main_ffd, main_cost, main_feasible)
    k4_event_ms = time_cuda(k4_call, reps=200)
    k4_ms = device_ms_per_call(k4_call, ["compact_kernel"], reps=200)
    k4_plain_ms = time_cuda(lambda: pack_kernel._compact_plan_ref(main_ffd, main_cost, main_feasible), reps=50)
    mr = pack_kernel.max_rounds(num_groups)
    # Per mode round_type and round_repl [MR], round_fill [MR, G],
    # unschedulable [G], num_rounds and overflow read, feasible_any read,
    # the payload written; a compare and a scan add per fill cell.
    k4_bytes = (2 * 4 * (2 * mr + 2 + mr * num_groups + num_groups) + num_groups
                + 4 * pack_kernel.compact_words(num_groups))
    k4_ops = 2 * 2 * mr * num_groups

    k7_axes = sweep["axes"]
    k7_call = functools.partial(consolidate_kernel.solve_counterfactuals, *k7_operands, axes=k7_axes)
    k7_event_ms = time_cuda(k7_call, reps=20)
    k7_ms = device_ms_per_call(k7_call, ["counterfactual_kernel", "winner_kernel"], reps=20)
    k7_plain_ms = time_cuda(lambda: consolidate_kernel._counterfactual_ref(*k7_operands), reps=5, warmup=1)
    k7_bins, k7_types = k7_operands[2].shape[0], k7_operands[4].shape[0]
    k7_bytes = k7_needed_bytes(k7_operands)
    # Per plan cell, for each axis the group requests: a division, a max, a
    # min, and the room's multiply and subtract; then the floor and its add,
    # the infinite check, the clamp, the scan's add and two subtracts and
    # the take's clip (9). Per candidate and type, an add and a compare per
    # axis, the select and the minimum; per candidate and group, the demand.
    requested = (k7_operands[0] > 0).sum(dim=2).cpu().numpy()  # [C, G]
    k7_ops = int(k7_bins * (5 * requested.sum() + 9 * requested.size)
                 + c_pad * k7_types * (2 * dims_c + 2) + 2 * c_pad * g_pad * dims_c)

    k1_bound, k1_by = bound(k1_bytes, k1_ops)
    k2_bound, k2_by = bound(k2_bytes, k2_ops)
    k3_bound, k3_by = bound(k3_bytes, k3_ops)
    k4_bound, k4_by = bound(k4_bytes, k4_ops)
    k7_bound, k7_by = bound(k7_bytes, k7_ops)
    kernels = [
        {
            "name": "dominance_prices", "route": "cuda",
            "source": "karpenter_tpu_torch/csrc/dominance.cu",
            "replaces": "karpenter_tpu/ops/pallas_kernels.py:63",
            "launches": launches["dominance_prices"], "max_abs_err": k1_err,
            "ms": k1_ms, "event_ms": k1_event_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
            "bound_by": k1_by, "library_ms": None,
        },
        {
            "name": "pack_kernel", "route": "cuda",
            "source": "karpenter_tpu_torch/csrc/pack_rounds.cu",
            "replaces": "karpenter_tpu/ops/pack_kernel.py:141",
            "launches": launches["pack_kernel"], "max_abs_err": k2_err,
            "ms": k2_ms, "event_ms": k2_event_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
            "bound_by": k2_by, "library_ms": None,
            "us_per_round": k2_mode_us[k2_slow_mode][1], "slower_mode": k2_slow_mode,
        },
        {
            "name": "lp_relax", "route": "cuda",
            "source": "karpenter_tpu_torch/csrc/lp_relax.cu",
            "replaces": "karpenter_tpu/ops/score_kernel.py:77",
            "launches": launches["lp_relax"], "max_abs_err": k3_err,
            "ms": k3_ms, "event_ms": k3_event_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound,
            "bound_by": k3_by, "library_ms": None,
            "us_per_step": k3_ms * 1e3 / lp_steps, "cluster": k3_rule.cluster,
        },
        {
            "name": "compact_plan", "route": "cuda",
            "source": "karpenter_tpu_torch/csrc/compact.cu",
            "replaces": "karpenter_tpu/ops/pack_kernel.py:616",
            "launches": launches["compact_plan"], "max_abs_err": k4_err,
            "ms": k4_ms, "event_ms": k4_event_ms, "plain_ms": k4_plain_ms, "bound_ms": k4_bound,
            "bound_by": k4_by, "library_ms": None,
        },
        {
            "name": "solve_counterfactuals", "route": "cuda",
            "source": "karpenter_tpu_torch/csrc/consolidate.cu",
            "replaces": "karpenter_tpu/ops/consolidate.py:142",
            "launches": sweep["launches"], "max_abs_err": sweep["max_abs_err"],
            "ms": k7_ms, "event_ms": k7_event_ms, "plain_ms": k7_plain_ms, "bound_ms": k7_bound,
            "bound_by": k7_by, "library_ms": None,
        },
    ]
    # K6 at the constrained path's shapes, in the mode the solve runs.
    k6_operands = levels["operands"]
    k6_call = functools.partial(pack_kernel.pack_kernel_levels, *k6_operands, mode="cost")
    k6_event_ms = time_cuda(k6_call, reps=20)
    k6_ms = device_ms_per_call(k6_call, ["pack_levels_kernel", "select_kernel"], reps=20)
    k6_plain_ms = time_cuda(lambda: plain_levels(k6_operands, "cost"), reps=3, warmup=1)
    k6_bytes, k6_ops = k6_needed(k6_operands)
    k6_bound, k6_by = bound(k6_bytes, k6_ops)
    kernels.append({
        "name": "pack_kernel_levels", "route": "cuda",
        "source": "karpenter_tpu_torch/csrc/pack_levels.cu",
        "replaces": "karpenter_tpu/ops/pack_kernel.py:446",
        "launches": levels["launches"], "max_abs_err": max(levels["max_abs_err"], k6_err),
        "ms": k6_ms, "event_ms": k6_event_ms, "plain_ms": k6_plain_ms, "bound_ms": k6_bound,
        "bound_by": k6_by, "library_ms": None,
    })
    # K8: one steady-state sweep's scatters and gathers on the churn
    # phase's arrays.
    k8_scatters, k8_gathers, k8_bytes = k8_sweep_operands(churn["state"], churn["deltas"], device)

    def k8_call(scatter=incremental.scatter, gather=incremental.gather):
        for dst, idx, rows in k8_scatters:
            scatter(dst, idx, rows)
        for src, perm in k8_gathers:
            gather(src, perm)

    k8_ms = device_ms_per_call(k8_call, ["scatter_kernel", "gather_kernel"], reps=50,
                               launches_per_call=len(k8_scatters) + len(k8_gathers))
    k8_event_ms = time_cuda(k8_call, reps=50)
    k8_plain_ms = time_cuda(functools.partial(
        k8_call, incremental._scatter_ref, incremental._gather_ref), reps=20)
    k8_bound, k8_by = bound(k8_bytes, 0)
    kernels.append({
        "name": "incremental_scatter_gather", "route": "cuda",
        "source": "karpenter_tpu_torch/csrc/incremental.cu",
        "replaces": "karpenter_tpu/ops/incremental.py:37",
        "launches": churn["launches"]["scatter"] + churn["launches"]["gather"], "max_abs_err": 0.0,
        "ms": k8_ms, "event_ms": k8_event_ms, "plain_ms": k8_plain_ms, "bound_ms": k8_bound,
        "bound_by": k8_by, "library_ms": None,
        "launches_scatter": churn["launches"]["scatter"], "launches_gather": churn["launches"]["gather"],
        "flushes": churn["flushes"], "cases": k8["cases"],
        "bytes": k8_bytes,
    })
    # K2 and K3 at the many-shapes schedule's padded G 2,048: milliseconds
    # a launch, so CUDA events around the wrapper.
    big_args = large["args"]
    k2_big_ms = time_cuda(functools.partial(pack_kernel.pack_kernel_pair, *big_args), reps=5, warmup=1)
    k3_big_ms = time_cuda(functools.partial(score_kernel.lp_relax, *large["lp"], steps=lp_steps),
                          reps=5, warmup=1)
    print(f"  at G={big_args[0].shape[0]} T={big_args[2].shape[0]}: K2 pair {k2_big_ms:.4f} ms, "
          f"K3 {k3_big_ms:.4f} ms (CUDA events)")
    phase("timing", shapes=f"T={num_types},R={dims},G={num_groups}", k7_shapes=f"C={c_pad},G={g_pad},N={k7_bins},T={k7_types}",
          k6_shapes="G={},T={},L={}".format(k6_operands[0].shape[0], k6_operands[2].shape[0], k6_operands[1].shape[0]),
          k2_g2048_ms=f"{k2_big_ms:.4f}", k3_g2048_ms=f"{k3_big_ms:.4f}")

    # 12. where one warm solve's time goes, layer by layer, and the device's
    # busy share of a solve.
    layers = layer_breakdown(groups, fleet, device)
    phase("layers", **{name: f"{ms:.3f}" for name, ms in layers.items()})
    busy = device_busy(cost_solver, groups, fleet)
    phase("profile", wall_ms=f"{busy['wall_ms']:.3f}", device_ms=f"{busy['device_ms']:.3f}",
          busy_share=f"{busy['busy_share']:.4f}", device_launches=busy["device_launches"])
    for key, count, ms in busy["top"]:
        print(f"  device {ms:9.3f} ms  x{count:<6d} {key}")
    check(solver.SOLVER_BATCH_SPLIT_TOTAL.get("floor") == 0,
          "a solve reached the device-memory ladder's floor")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
