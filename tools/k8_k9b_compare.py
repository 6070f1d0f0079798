#!/usr/bin/env python3
"""K8 and K9b of one tree on the card, for comparing two trees in one call.

    python3 tools/k8_k9b_compare.py --tree DIR --label NAME

Imports DIR's chip_smoke and package (DIR defaults to this checkout), builds
DIR's kernel sources, and runs, with that tree's own code:

  * `chip_smoke.incremental_phase`: the churn cell (50,000 pods bound over
    500 nodes, 12 sweeps of 1% churn) with its parity checks; its
    `incremental` line carries encode_delta_ms (a flush plus the sorted
    view, synced);
  * one steady-state sweep's K8 work on that cell's arrays
    (`chip_smoke.k8_sweep_operands`): the flush of five slot arrays and the
    sorted view of two, through the tree's entry points (`scatter_flush`
    and `gather_view` where the tree has them, else five `scatter` and two
    `gather` calls). Device ms is torch.profiler's time of every device
    record of the call, copies included (`k8_ms`), and of its kernels
    alone (`k8_kernel_ms`); event ms is between CUDA events around the
    call; the records a call makes, by name;
  * K9b at the main path's shapes (50,000 pods x 400 types, padded G 16) on
    2x2 and 2x4 virtual meshes of the card: `compact_plan_sharded`'s
    launches a call, device ms over every record of the call and over the
    K9b kernels alone, event ms, the plain version's event ms, and its
    words against the plain version's;
  * the warm p50 of `CostSolver.solve_encoded` on the main path on one
    device, on 2x2 and on 2x4 (10 runs each), and of the fast path
    (`encode_schedule` + `solve_many_pipelined` on the 50,000 pending pods).

Prints one line `compare_result {json}` with the card's name and power limit.
Run two trees in turns (change, parent, parent, change) on one card in one
go: times from two machines do not compare.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import re
import subprocess
import sys
import time
from pathlib import Path


def _name(key: str) -> str:
    """A device record's name: a kernel by its function name, a copy or a
    fill by the profiler's."""
    match = re.search(r"(\w+_kernel)", key)
    return match.group(1) if match else key


def _records(call) -> dict:
    """{name: device records} of one call of `call`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    names = {}
    for event in prof.events():
        if event.device_type == torch.autograd.DeviceType.CUDA:
            names[_name(event.name)] = names.get(_name(event.name), 0) + 1
    return names


def _device_ms(call, reps: int, names) -> tuple:
    """torch.profiler's device time a call of the records named `names`
    ({name: records a call}), over `reps` calls: their mean time a record
    seen times their records a call (the profiler now and then drops a
    record), and the records seen of those expected."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    seen, total_us = 0, 0.0
    for event in prof.key_averages():
        if event.device_type == torch.autograd.DeviceType.CUDA and _name(event.key) in names:
            seen += event.count
            total_us += event.self_device_time_total
    per_call = sum(names.values())
    return (total_us / seen * per_call / 1e3 if seen else None), f"{seen}/{reps * per_call}"


def _timed(chip_smoke, call, reps: int, kernels) -> dict:
    """Device ms over every record of a call (`ms`) and over the records
    whose names hold one of `kernels` (`kernel_ms`), event ms, and the
    records a call makes."""
    records = _records(call)
    own = {name: count for name, count in records.items() if any(k in name for k in kernels)}
    ms, seen = _device_ms(call, reps, records)
    kernel_ms, kernel_seen = _device_ms(call, reps, own)
    return {"records": records, "ms": ms, "seen": seen, "kernel_ms": kernel_ms, "kernel_seen": kernel_seen,
            "event_ms": chip_smoke.time_cuda(call, reps=reps)}


def _p50(call, runs: int = 10) -> float:
    import numpy as np

    samples = []
    for _ in range(runs):
        start = time.perf_counter()
        call()
        samples.append((time.perf_counter() - start) * 1e3)
    return float(np.percentile(samples, 50))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=str(Path(__file__).resolve().parent.parent))
    parser.add_argument("--label", default="tree")
    args = parser.parse_args(argv)
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import os

    import torch

    import chip_smoke
    from karpenter_tpu_torch.api.provisioner import Constraints
    from karpenter_tpu_torch.controllers.cluster import Cluster
    from karpenter_tpu_torch.convert import fused_args_from_numpy
    from karpenter_tpu_torch.models import solver
    from karpenter_tpu_torch.models.cluster_state import DeviceClusterState
    from karpenter_tpu_torch.ops import cuda_build, cuda_kernels, incremental, pack_kernel, score_kernel
    from karpenter_tpu_torch.ops.encode import build_fleet, group_pods
    from karpenter_tpu_torch.parallel import mesh as mesh_mod

    if not torch.cuda.is_available():
        print("k8_k9b_compare: no CUDA device", file=sys.stderr)
        return 2
    os.environ["KARPENTER_HOST_SOLVE"] = "0"
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    start = time.perf_counter()
    build_s = cuda_build.build_all(cuda_build.port_libraries())
    result = {"label": args.label, "tree": str(tree), "card": smi, "build_s": build_s}

    # K8: the churn cell, then one steady-state sweep's flush and view.
    line = io.StringIO()
    with contextlib.redirect_stdout(line):
        churn = chip_smoke.incremental_phase(device)
    print(line.getvalue(), end="")
    result["encode_delta_ms"] = float(re.search(r"encode_delta_ms=([0-9.]+)", line.getvalue()).group(1))
    result["churn_launches"] = churn["launches"]
    scatters, gathers, _ = chip_smoke.k8_sweep_operands(churn["state"], churn["deltas"], device)
    batched = hasattr(incremental, "scatter_flush")

    def k8_call(plain=False):
        if batched:
            flush = incremental._scatter_flush_ref if plain else incremental.scatter_flush
            view = incremental._gather_view_ref if plain else incremental.gather_view
            flush(scatters)
            view([src for src, _ in gathers], gathers[0][1])
            return
        for dst, idx, rows in scatters:
            (incremental._scatter_ref if plain else incremental.scatter)(dst, idx, rows)
        for src, perm in gathers:
            (incremental._gather_ref if plain else incremental.gather)(src, perm)

    for key, value in _timed(chip_smoke, k8_call, 50, kernels=("scatter", "gather")).items():
        result[f"k8_{key}"] = value
    result["k8_plain_event_ms"] = chip_smoke.time_cuda(functools.partial(k8_call, True), reps=20)

    # K9b at the main path's shapes on 2x2 and 2x4, and the solve p50s.
    pods, catalog = chip_smoke.make_workload()
    groups = group_pods(pods)
    fleet = build_fleet(catalog, Constraints(), pods, pods_need=groups.vectors.max(axis=0))
    cost_solver = solver.CostSolver(device=device)
    solve = functools.partial(cost_solver.solve_encoded, groups, fleet)
    solve()
    result["single_p50_ms"] = _p50(solve)
    for shards in (4, 8):
        with mesh_mod.virtual_devices(device, shards):
            mesh = solver.solve_mesh(device)
            label = f"{mesh.shape[0]}x{mesh.shape[1]}"
            padded = solver.pad_kernel_args(groups.vectors, groups.counts, fleet.capacity, fleet.total,
                                            fleet.prices, g_mult=mesh.size, t_mult=mesh.shape[1])
            vectors, counts, capacity, total, valid, prices = fused_args_from_numpy(*padded, device=device)
            effective = cuda_kernels.dominance_prices(capacity, torch.where(valid, prices, torch.inf))
            ffd, cost = pack_kernel.pack_kernel_pair(vectors, counts, capacity, total, valid, effective)
            feasible = score_kernel.feasibility_mask(vectors, capacity, valid).any(dim=1)
            call = functools.partial(pack_kernel.compact_plan_sharded, ffd, cost, feasible, mesh=mesh)
            before = pack_kernel.compact_shard.launches
            words = call()
            result[f"k9b_{label}_launches"] = pack_kernel.compact_shard.launches - before
            with chip_smoke.plain_k9b():
                plain = call()
                result[f"k9b_{label}_plain_event_ms"] = chip_smoke.time_cuda(call, reps=20)
            torch.cuda.synchronize()
            result[f"k9b_{label}_words_equal_plain"] = bool(torch.equal(words, plain))
            for key, value in _timed(chip_smoke, call, 200, kernels=("compact_shard",)).items():
                result[f"k9b_{label}_{key}"] = value
            solve()
            result[f"sharded_{label}_p50_ms"] = _p50(solve)

    # The fast path on the 50,000 pending pods.
    cluster = Cluster()
    state = DeviceClusterState(cluster, device=device)
    for pod in pods:
        cluster.apply_pod(pod)
    pending = [pod for pod in cluster.list_pods() if pod.is_provisionable()]

    def fast():
        pair = state.encode_schedule(pending, catalog, Constraints(), [])
        list(cost_solver.solve_many_pipelined([pair]))

    fast()
    result["fast_p50_ms"] = _p50(fast)
    result["seconds"] = time.perf_counter() - start
    print("compare_result " + json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
