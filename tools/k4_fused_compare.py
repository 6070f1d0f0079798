#!/usr/bin/env python3
"""The fused cost solve of one tree on the card, for comparing two trees in one call.

    python3 tools/k4_fused_compare.py --tree DIR --label NAME

Imports DIR's chip_smoke and package (DIR defaults to this checkout), builds
DIR's kernel sources, and runs, with that tree's own code, at the main
path's shapes (50,000 pods x 400 types, padded G 16, T 512):

  * `models/solver._cost_fused_body`, the fused solve's device program: its
    device records a call by name (torch.profiler, copies and fills
    included), the device ms a call of each name and of all of them, the
    CUDA-event ms around the call, the host ms of its enqueue (no sync) and
    of the enqueue plus the payload's fetch;
  * K2's pair launch alone and, where the tree has `pack_pair_payload`,
    with its epilogue, the two called in turns in one profile (device ms a
    launch of each); where it has the standalone K4 (`compact_plan` on the
    card), that launch's device ms;
  * one warm `CostSolver.solve_encoded`: its device records by name;
  * the warm p50 of `CostSolver.solve_encoded` on one device, on 2x2 and on
    2x4 virtual meshes of the card (10 runs each).

Prints one line `compare_result {json}` with the card's name and power limit.
Run two trees in turns (change, parent, parent, change) on one card in one
go: times from two machines do not compare.
"""

from __future__ import annotations

import argparse
import functools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

LP_STEPS = 300


def _name(key: str) -> str:
    """A device record's name: a kernel by its function name, a copy or a
    fill by the profiler's."""
    match = re.search(r"(\w+_kernel)", key)
    return match.group(1) if match else key


def _profile(call, reps: int):
    import torch
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def _records(call) -> dict:
    """{name: device records} of one call of `call`."""
    names = {}
    for event in _profile(call, 1):
        names[_name(event.name)] = names.get(_name(event.name), 0) + 1
    return names


def _device_ms(call, reps: int, names: dict) -> dict:
    """Device ms a call of each name in `names` ({name: records a call}):
    the mean time a record seen times its records a call (the profiler now
    and then drops a record), with the records seen of those expected."""
    seen = {name: [0, 0.0] for name in names}
    for event in _profile(call, reps):
        name = _name(event.name)
        if name in seen:
            seen[name][0] += 1
            seen[name][1] += event.time_range.elapsed_us()
    out = {name: (us / count * names[name] / 1e3 if count else None) for name, (count, us) in seen.items()}
    return {"by_name": out, "total": sum(ms for ms in out.values() if ms is not None),
            "seen": f"{sum(c for c, _ in seen.values())}/{reps * sum(names.values())}"}


def _paired_ms(first, second, kernel: str, reps: int = 50):
    """Device ms a launch of `kernel` by `first` and by `second`, called in
    turns in one profile (the records alternate on the one stream); None
    when three windows each lost a record."""
    for _ in range(3):
        records = sorted((e for e in _profile(lambda: (first(), second()), reps) if kernel in e.name),
                         key=lambda e: e.time_range.start)
        if len(records) == 2 * reps:
            return [sum(e.time_range.elapsed_us() for e in records[k::2]) / reps / 1e3 for k in (0, 1)]
    return None


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
    from karpenter_tpu_torch.convert import fused_args_from_numpy
    from karpenter_tpu_torch.models import solver
    from karpenter_tpu_torch.ops import cuda_build, cuda_kernels, pack_kernel
    from karpenter_tpu_torch.ops.encode import build_fleet, group_pods
    from karpenter_tpu_torch.parallel import mesh as mesh_mod

    if not torch.cuda.is_available():
        print("k4_fused_compare: no CUDA device", file=sys.stderr)
        return 2
    os.environ["KARPENTER_HOST_SOLVE"] = "0"
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    start = time.perf_counter()
    build_s = cuda_build.build_all(cuda_build.port_libraries())
    result = {"label": args.label, "tree": str(tree), "card": smi, "build_s": build_s}
    # K2's registers and spills by template variant, when this run built it.
    result["k2_ptxas"] = [line.strip() for line in pack_kernel.LIBRARY.build_log.splitlines()
                          if "Compiling entry" in line or "spill" in line or "registers" in line]

    pods, catalog = chip_smoke.make_workload()
    groups = group_pods(pods)
    fleet = build_fleet(catalog, Constraints(), pods, pods_need=groups.vectors.max(axis=0))
    padded = solver.pad_kernel_args(groups.vectors, groups.counts, fleet.capacity, fleet.total, fleet.prices)
    main_args = fused_args_from_numpy(*padded, device=device)
    vectors, counts, capacity, total, valid, prices = main_args

    # The fused solve's device program.
    body = functools.partial(solver._cost_fused_body, *main_args, lp_steps=LP_STEPS)
    records = _records(body)
    result["fused_records"] = records
    result["fused_records_per_call"] = sum(records.values())
    timed = _device_ms(body, 20, records)
    result["fused_device_ms_by_name"] = timed["by_name"]
    result["fused_device_ms"] = timed["total"]
    result["fused_records_seen"] = timed["seen"]
    result["fused_event_ms"] = chip_smoke.time_cuda(body, reps=20)

    def enqueue():
        torch.cuda.synchronize()
        begin = time.perf_counter()
        body()
        return (time.perf_counter() - begin) * 1e3

    def enqueue_and_fetch():
        torch.cuda.synchronize()
        begin = time.perf_counter()
        body()[0].cpu()
        return (time.perf_counter() - begin) * 1e3

    import numpy as np

    result["fused_enqueue_ms_p50"] = float(np.median([enqueue() for _ in range(20)]))
    result["fused_to_payload_ms_p50"] = float(np.median([enqueue_and_fetch() for _ in range(20)]))

    # K2's pair, with and without its epilogue; the standalone K4 where the
    # tree has one.
    effective = cuda_kernels.dominance_prices(capacity, torch.where(valid, prices, torch.inf))
    bare = functools.partial(pack_kernel.pack_kernel_pair, vectors, counts, capacity, total, valid, effective)
    if hasattr(pack_kernel, "pack_pair_payload"):
        fused = functools.partial(pack_kernel.pack_pair_payload, vectors, counts, capacity, total, valid,
                                  effective)
        paired = _paired_ms(fused, bare, "pack_rounds_kernel")
        result["k2_with_epilogue_ms"], result["k2_without_epilogue_ms"] = paired or (None, None)
        result["k2_with_epilogue_event_ms"] = chip_smoke.time_cuda(fused, reps=50)
    else:
        paired = _paired_ms(bare, bare, "pack_rounds_kernel")
        result["k2_without_epilogue_ms"] = None if paired is None else sum(paired) / 2
        ffd, cost = bare()
        feasible = solver.feasibility_mask(vectors, capacity, valid).any(dim=1)
        k4 = functools.partial(pack_kernel.compact_plan, ffd, cost, feasible)
        result["k4_standalone_ms"] = _device_ms(k4, 200, {"compact_kernel": 1})["total"]
        result["k4_standalone_event_ms"] = chip_smoke.time_cuda(k4, reps=200)
    result["k2_without_epilogue_event_ms"] = chip_smoke.time_cuda(bare, reps=50)

    # A whole warm solve's device records, and the solve p50s.
    cost_solver = solver.CostSolver(device=device)
    solve = functools.partial(cost_solver.solve_encoded, groups, fleet)
    result["solve_records"] = _records(solve)
    result["single_p50_ms"] = _p50(solve)
    for shards in (4, 8):
        with mesh_mod.virtual_devices(device, shards):
            mesh = solver.solve_mesh(device)
            label = f"{mesh.shape[0]}x{mesh.shape[1]}"
            solve()
            result[f"sharded_{label}_p50_ms"] = _p50(solve)
            result[f"sharded_{label}_records"] = _records(solve)
    result["seconds"] = time.perf_counter() - start
    print("compare_result " + json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
