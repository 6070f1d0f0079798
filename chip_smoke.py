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
              non-degenerate LPs padded to [8, 16], [16, 512] and [32, 512]
              (state in shared memory and in global scratch), objective
              within rtol 1e-4 and assignment within 1e-3 pods, and on the
              50k problem, objective within rtol 1e-4
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
  7. consolidate  the consolidation path: one sweep of
              ops/consolidate.solve_candidates over a 5,000-node cluster
              (64 candidates, padded C 64, G 16, N 8192, T 512) built by the
              controller's rules; K7 launched once per sweep and bit-identical
              to its plain version there and on small problems (fits past
              2**24, the room in shared memory and in global scratch); every
              verdict equal to the CPU run; the winner's delete plan places
              each of its pods once within every receiver's headroom; a room
              sized for too few axes flagged; cold first sweep, warm p50 over
              10 sweeps, the fetch's bytes
  8. timing   each kernel's device time per call (torch.profiler: the
              kernels' own time, `ms`) and its time between CUDA events
              around the wrapper (host enqueue included, `event_ms`), its
              plain version's time (CUDA events) and its bound at the path's
              shapes
  9. layers   one warm solve layer by layer (each bracketed by device syncs),
              and torch.profiler's device time against the solve's wall time

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
NUM_PODS = 50_000
NUM_TYPES = 400


def check(condition: bool, message: str) -> None:
    if not condition:
        raise RuntimeError(f"check failed: {message}")


def phase(name: str, **fields) -> None:
    text = " ".join(f"{key}={value}" for key, value in fields.items())
    print(f"phase {name}: ok {text}", flush=True)


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

    from karpenter_tpu_torch.api.pods import PodSpec
    from karpenter_tpu_torch.api.provisioner import Constraints
    from karpenter_tpu_torch.cloudprovider import InstanceType, Offering
    from karpenter_tpu_torch.ops import consolidate, encode

    return SimpleNamespace(
        PodSpec=PodSpec, Constraints=Constraints, InstanceType=InstanceType, Offering=Offering,
        group_pods=encode.group_pods, build_fleet=encode.build_fleet,
        resource_vector=encode.resource_vector, accel_indexes=encode._ACCEL_INDEXES,
        consolidate=consolidate,
    )


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
    (vectors, solvable counts, capacity, valid, effective prices)."""
    import torch

    from karpenter_tpu_torch.ops import cuda_kernels, score_kernel

    vectors, counts, capacity, valid, prices = lp_problem(seed)
    num_groups, num_types = shape
    vectors = np.pad(vectors, ((0, num_groups - 8), (0, 0)))
    counts = np.pad(counts, (0, num_groups - 8))
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


def device_ms_per_call(fn, kernel_names, reps: int = 20) -> float:
    """torch.profiler's device time of the named kernels per call of `fn`:
    the kernels' own time on the card, without the host's enqueue."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and any(name in e.key for name in kernel_names)
    ]
    launches = sum(e.count for e in events)
    check(launches == reps * len(kernel_names),
          f"the profiler saw {launches} launches of {kernel_names}, not {reps * len(kernel_names)}")
    return sum(e.self_device_time_total for e in events) / 1e3 / reps


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on the card", file=sys.stderr)
        return 2

    from karpenter_tpu_torch.api.provisioner import Constraints
    from karpenter_tpu_torch.convert import fused_args_from_numpy
    from karpenter_tpu_torch.models import solver
    from karpenter_tpu_torch.ops import (
        consolidate_kernel, cuda_build, cuda_kernels, native, pack_kernel, score_kernel,
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
        pack_kernel.COMPACT_LIBRARY, consolidate_kernel.LIBRARY,
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
    # (32, 512) needs more than 48 KB of shared memory and (64, 1024) puts
    # the fills in global scratch: both of the kernel's storage paths.
    problems = [random_pack_problem(rng, g, t) for g, t in ((8, 8), (16, 64), (16, 512), (32, 256), (32, 512), (64, 1024))]
    problems.append(tuple(padded[:5]) + (main_prices.cpu().numpy(),))
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
    # K3 on the non-degenerate LP family, padded out to each shape.
    k3_cases = 0
    k3_err = 0.0
    k3_obj_err = 0.0
    workspace = score_kernel.LIBRARY.load().ktt_lp_relax_workspace_bytes
    k3_shapes = ((8, 16), (16, 512), (32, 512))
    check(workspace(16, 512, 8) <= score_kernel._SHARED_STATE_LIMIT < workspace(32, 512, 8),
          "the K3 shapes do not cover both storage paths")
    for seed in LP_SEEDS:
        for shape in k3_shapes:
            lp_args = lp_inputs(seed, shape, device)
            got = score_kernel.lp_relax(*lp_args, steps=300)
            want = score_kernel.lp_relax_body(*lp_args, steps=300)
            torch.cuda.synchronize()
            obj_err = abs(float(got.objective) - float(want.objective)) / abs(float(want.objective))
            err = float((got.assignment - want.assignment).abs().max())
            check(obj_err <= LP_OBJECTIVE_RTOL and err <= LP_ASSIGNMENT_ATOL,
                  f"K3 differs from its plain version at seed {seed} shape {shape}: "
                  f"objective {obj_err:.3e} relative, assignment {err:.3e}")
            k3_err = max(k3_err, err)
            k3_obj_err = max(k3_obj_err, obj_err)
            k3_cases += 1
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
    main_row_err = float((got.assignment.sum(dim=1) - main_solvable.float()).abs().max())
    print(f"  K3 on the 50k problem: objective {main_obj_err:.3e} relative, assignment "
          f"max abs {main_assign_err:.3e} pods (degenerate), row sums {main_row_err:.3e} pods off the counts")
    check(main_obj_err <= LP_OBJECTIVE_RTOL, f"K3 objective differs on the 50k problem: {main_obj_err:.3e}")
    phase("kernels", k1_cases=k1_cases, k2_cases=k2_cases, k3_cases=k3_cases, k4_cases=k4_cases,
          k1_max_abs_err=k1_err, k2_max_abs_err=k2_err, k3_max_abs_err=k3_err, k4_max_abs_err=k4_err,
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

    # 7. the consolidation path: one sweep at the large-cluster envelope.
    sweep = consolidate_phase(catalog, device)
    k7_operands = sweep["operands"]
    c_pad, g_pad, dims_c = k7_operands[0].shape

    # 8. kernel timing at the main path's shapes.
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
    words = pack_kernel.LIBRARY.load().ktt_pack_rounds_words(num_groups)
    k2_bytes = 4 * (num_groups * dims + num_groups + num_types * dims + num_types) + num_types + 2 * 4 * words
    # Operations this run's data needs: per mode and round, the group scan
    # over every valid type for the groups still holding pods (a division,
    # a minimum, a multiply and a subtract per axis, an add and a floor).
    valid_types = int(valid.sum())
    k2_ops = 0
    for plan_rounds in (gpu_plan.rounds_ffd, gpu_plan.rounds_cost):
        remaining = groups.counts.astype(np.int64).copy()
        for r in range(int(plan_rounds.num_rounds)):
            k2_ops += valid_types * int((remaining > 0).sum()) * (4 * dims + 2)
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
        },
        {
            "name": "lp_relax", "route": "cuda",
            "source": "karpenter_tpu_torch/csrc/lp_relax.cu",
            "replaces": "karpenter_tpu/ops/score_kernel.py:77",
            "launches": launches["lp_relax"], "max_abs_err": k3_err,
            "ms": k3_ms, "event_ms": k3_event_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound,
            "bound_by": k3_by, "library_ms": None,
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
    phase("timing", shapes=f"T={num_types},R={dims},G={num_groups}", k7_shapes=f"C={c_pad},G={g_pad},N={k7_bins},T={k7_types}")

    # 9. where one warm solve's time goes, layer by layer, and the device's
    # busy share of a solve.
    layers = layer_breakdown(groups, fleet, device)
    phase("layers", **{name: f"{ms:.3f}" for name, ms in layers.items()})
    busy = device_busy(cost_solver, groups, fleet)
    phase("profile", wall_ms=f"{busy['wall_ms']:.3f}", device_ms=f"{busy['device_ms']:.3f}",
          busy_share=f"{busy['busy_share']:.4f}", device_launches=busy["device_launches"])
    for key, count, ms in busy["top"]:
        print(f"  device {ms:9.3f} ms  x{count:<6d} {key}")
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
