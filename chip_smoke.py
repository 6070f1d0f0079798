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
              the 50k-pod x 400-type encoded problem, bit for bit; K3 the LP
              relaxation on non-degenerate LPs padded to [8, 16], [16, 512]
              and [32, 512] (state in shared memory and in global scratch),
              objective within rtol 1e-4 and assignment within 1e-3 pods,
              and on the 50k problem, objective within rtol 1e-4
  4. solve    the main path: 50,000 pending pods over 400 instance types
              through CostSolver(device="cuda").solve with the host gate off
              (KARPENTER_HOST_SOLVE=0); every pod placed exactly once, each
              kernel launched exactly once; warm p50/p99 of solve_encoded
              over 10 runs
  5. cpu      the same encoded problem through the plain versions on the CPU:
              identical rounds and feasibility, $/hr within 1e-4 relative, LP
              objective within 1e-3 relative; the card's dispatch runs under
              torch.cuda.set_sync_debug_mode("error") (no host sync) and
              returns before the card is done
  6. batch    solve_encoded_many over 8 schedules (one fetch for the batch)
  7. timing   each kernel's time (CUDA events), its plain version's time and
              its bound at the main path's shapes
  8. layers   one warm solve layer by layer (each bracketed by device syncs),
              and torch.profiler's device time against the solve's wall time

Any failed check raises and the script exits non-zero. Without a CUDA card,
or without the rest of the repository beside it, it exits non-zero and prints
no result.
"""

from __future__ import annotations

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


def make_workload(num_pods: int = NUM_PODS, num_types: int = NUM_TYPES, seed: int = 0):
    """The repository's north-star workload (the shapes of bench.make_workload):
    16 Zipf-weighted pod shapes; 400 types from 4 families x 10 sizes with
    on-demand prices linear in size, 3 zones, on-demand and spot offerings.
    Spot prices come from a seeded generator."""
    from karpenter_tpu_torch.api.pods import PodSpec
    from karpenter_tpu_torch.cloudprovider import InstanceType, Offering

    rng = np.random.default_rng(seed)
    shapes = [
        (int(rng.integers(1, 17)) * 250, int(rng.integers(1, 33)) * 256) for _ in range(16)
    ]
    weights = 1.0 / np.arange(1, len(shapes) + 1)
    weights /= weights.sum()
    shape_counts = (weights * num_pods).astype(int)
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
            offerings.append(Offering(zone=zone, capacity_type="on-demand", price=on_demand))
            spot = on_demand * float(spot_rng.uniform(0.25, 0.75))
            offerings.append(Offering(zone=zone, capacity_type="spot", price=spot))
        catalog.append(
            InstanceType(
                name=f"{family}{generation}.{size}x",
                capacity={"cpu": cpu, "memory": f"{int(cpu * mem_per_cpu)}Gi", "pods": max_pods},
                overhead={
                    "cpu": f"{kube_reserved_cpu_millis(cpu)}m",
                    "memory": f"{11 * max_pods + 255 + 100 + 100}Mi",
                },
                offerings=offerings,
            )
        )
    return pods, catalog


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


def rounds_equal(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def rounds_abs_err(a, b) -> float:
    return max(float((x.long() - y.long()).abs().max()) for x, y in zip(a, b))


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on the card", file=sys.stderr)
        return 2

    from karpenter_tpu_torch.api.provisioner import Constraints
    from karpenter_tpu_torch.convert import fused_args_from_numpy
    from karpenter_tpu_torch.models import solver
    from karpenter_tpu_torch.ops import cuda_build, cuda_kernels, native, pack_kernel, score_kernel
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
    libraries = [cuda_kernels.LIBRARY, pack_kernel.LIBRARY, score_kernel.LIBRARY]
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
    phase("kernels", k1_cases=k1_cases, k2_cases=k2_cases, k3_cases=k3_cases, k1_max_abs_err=k1_err,
          k2_max_abs_err=k2_err, k3_max_abs_err=k3_err, k3_objective_rel_err=f"{k3_obj_err:.3e}",
          k3_main_objective_rel_err=f"{main_obj_err:.3e}")

    # 4. the main path, through the entry point a user calls.
    os.environ["KARPENTER_HOST_SOLVE"] = "0"
    cost_solver = solver.CostSolver(device="cuda")
    cuda_kernels.dominance_prices.launches = 0
    pack_kernel.pack_kernel.launches = 0
    score_kernel.lp_relax.launches = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    result = cost_solver.solve(pods, catalog, Constraints())
    first_solve_ms = (time.perf_counter() - start) * 1e3
    launches = {
        "dominance_prices": cuda_kernels.dominance_prices.launches,
        "pack_kernel": pack_kernel.pack_kernel.launches,
        "lp_relax": score_kernel.lp_relax.launches,
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

    # 7. kernel timing at the main path's shapes.
    num_types, dims = capacity.shape
    num_groups = vectors.shape[0]
    valid_prices = torch.where(valid, prices, torch.inf)
    k1_ms = time_cuda(lambda: cuda_kernels.dominance_prices(capacity, valid_prices), reps=200)
    k1_plain_ms = time_cuda(lambda: cuda_kernels._dominance_prices_ref(capacity, valid_prices), reps=200)
    k1_bytes = 4 * (num_types * dims + 2 * num_types)
    k1_ops = num_types * num_types * (dims + 1)
    k2_ms = time_cuda(lambda: pack_kernel.pack_kernel_pair(vectors, counts, capacity, total, valid, main_prices), reps=50)
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
    k3_ms = time_cuda(lambda: score_kernel.lp_relax(*main_lp, steps=lp_steps), reps=20)
    k3_plain_ms = time_cuda(lambda: score_kernel.lp_relax_body(*main_lp, steps=lp_steps), reps=5, warmup=1)
    # Each input read once (the bias table included), each output written once.
    k3_bytes = (4 * (num_groups * dims + num_groups + num_types * dims + num_types + 2 * lp_steps)
                + num_types + 4 * (num_groups * num_types + num_types + 1))
    k3_ops = lp_operations(num_groups, num_types, dims, lp_steps)

    k1_bound, k1_by = bound(k1_bytes, k1_ops)
    k2_bound, k2_by = bound(k2_bytes, k2_ops)
    k3_bound, k3_by = bound(k3_bytes, k3_ops)
    kernels = [
        {
            "name": "dominance_prices", "route": "cuda",
            "source": "karpenter_tpu_torch/csrc/dominance.cu",
            "replaces": "karpenter_tpu/ops/pallas_kernels.py:63",
            "launches": launches["dominance_prices"], "max_abs_err": k1_err,
            "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
            "bound_by": k1_by, "library_ms": None,
        },
        {
            "name": "pack_kernel", "route": "cuda",
            "source": "karpenter_tpu_torch/csrc/pack_rounds.cu",
            "replaces": "karpenter_tpu/ops/pack_kernel.py:141",
            "launches": launches["pack_kernel"], "max_abs_err": k2_err,
            "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
            "bound_by": k2_by, "library_ms": None,
        },
        {
            "name": "lp_relax", "route": "cuda",
            "source": "karpenter_tpu_torch/csrc/lp_relax.cu",
            "replaces": "karpenter_tpu/ops/score_kernel.py:77",
            "launches": launches["lp_relax"], "max_abs_err": k3_err,
            "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound,
            "bound_by": k3_by, "library_ms": None,
        },
    ]
    phase("timing", shapes=f"T={num_types},R={dims},G={num_groups}")

    # 8. where one warm solve's time goes, layer by layer, and the device's
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
