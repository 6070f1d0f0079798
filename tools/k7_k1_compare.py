#!/usr/bin/env python3
"""K7 and K1 of one tree on the card: the consolidation phase and the two
kernels' times, for comparing two trees in one call.

    python3 tools/k7_k1_compare.py --tree DIR --label NAME

Imports DIR's chip_smoke and package (DIR defaults to this checkout), builds
DIR's K7 and K1 sources, and runs, with that tree's own code:

  * `chip_smoke.consolidate_phase`: the 5,000-node sweep (padded C 64, G 16,
    N 8,192, T 512) through ops/consolidate.solve_candidates, its checks
    against the CPU run and K7 against its plain version; its `consolidate`
    line carries the sweep p50;
  * K7's device time a call (torch.profiler: the kernels one wrapper call
    launches, by name) and its time between CUDA events around the wrapper,
    at that sweep and at a 16-candidate sweep of the same cluster;
  * K1's device and event times at the main path's [512, 8] and at a seeded
    [4,096, 8].

Prints one line `compare_result {json}` with the card's name and power limit.
The kernels' names come from the profiler, so the tool times a tree with one
K7 launch a sweep and a tree with two alike. Run a pair of trees in turns
(change, parent, parent, change) inside one chip call.
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


def _kernel_names(call) -> dict:
    """{kernel function name: launches} of one call of `call`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    names = {}
    for event in prof.events():
        if event.device_type != torch.autograd.DeviceType.CUDA or event.name.startswith(("Memcpy", "Memset")):
            continue
        match = re.search(r"(\w+_kernel)", event.name)
        name = match.group(1) if match else event.name
        names[name] = names.get(name, 0) + 1
    return names


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=str(Path(__file__).resolve().parent.parent))
    parser.add_argument("--label", default="tree")
    args = parser.parse_args(argv)
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    import chip_smoke
    from karpenter_tpu_torch.api.provisioner import Constraints
    from karpenter_tpu_torch.convert import fused_args_from_numpy
    from karpenter_tpu_torch.models import solver
    from karpenter_tpu_torch.ops import consolidate, consolidate_kernel, cuda_build, cuda_kernels
    from karpenter_tpu_torch.ops.encode import build_fleet, group_pods

    if not torch.cuda.is_available():
        print("k7_k1_compare: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    start = time.perf_counter()
    build_s = cuda_build.build_all([consolidate_kernel.LIBRARY, cuda_kernels.LIBRARY])
    package = chip_smoke.port_package()
    catalog = chip_smoke.make_catalog(package=package)
    sweep = chip_smoke.consolidate_phase(catalog, device)
    result = {"label": args.label, "tree": str(tree), "card": smi, "build_s": build_s}

    def time_k7(operands, axes, key):
        call = functools.partial(consolidate_kernel.solve_counterfactuals, *operands, axes=axes)
        names = _kernel_names(call)
        result[f"k7_{key}_kernels"] = names
        result[f"k7_{key}_ms"] = chip_smoke.device_ms_per_call(call, names, reps=50)
        result[f"k7_{key}_event_ms"] = chip_smoke.time_cuda(call, reps=50)

    time_k7(sweep["operands"], sweep["axes"], "c64")
    shapes = chip_smoke.pod_shapes(0)
    cluster = chip_smoke.make_cluster(chip_smoke.usable_capacity(catalog, package),
                                      chip_smoke.shape_vectors(shapes, package))
    small = chip_smoke.consolidation_problem(cluster, catalog, shapes, package, max_candidates=16)[0]
    operands, axes = chip_smoke.k7_inputs(small, device)
    result["k7_c16_shape"] = [int(operands[0].shape[0]), int(operands[0].shape[1]),
                              int(operands[2].shape[0]), int(operands[4].shape[0])]
    time_k7(operands, axes, "c16")
    sweep_ms = []
    for _ in range(20):
        begin = time.perf_counter()
        consolidate.solve_candidates(small, device=device)
        sweep_ms.append((time.perf_counter() - begin) * 1e3)
    result["sweep_c16_p50_ms"] = float(np.percentile(sweep_ms, 50))

    pods, catalog = chip_smoke.make_workload()
    groups = group_pods(pods)
    fleet = build_fleet(catalog, Constraints(), pods, pods_need=groups.vectors.max(axis=0))
    padded = solver.pad_kernel_args(groups.vectors, groups.counts, fleet.capacity, fleet.total, fleet.prices)
    _, _, capacity, _, valid, prices = fused_args_from_numpy(*padded, device=device)
    rng = np.random.default_rng(4096)
    wide = torch.from_numpy(rng.integers(0, 9, (4096, 8)).astype(np.float32)).to(device)
    wide_prices = torch.from_numpy(rng.choice([0.25, 0.5, 1.0, 2.0], 4096).astype(np.float32)).to(device)
    for key, cap, price in (("t512", capacity, torch.where(valid, prices, torch.inf)),
                            ("t4096", wide, wide_prices)):
        call = functools.partial(cuda_kernels.dominance_prices, cap, price)
        got = call()
        torch.cuda.synchronize()
        if not torch.equal(got, cuda_kernels._dominance_prices_ref(cap, price)):
            raise SystemExit(f"k7_k1_compare: K1 differs from its plain version at {key}")
        result[f"k1_{key}_ms"] = chip_smoke.device_ms_per_call(call, ["dominance_kernel"], reps=200)
        result[f"k1_{key}_event_ms"] = chip_smoke.time_cuda(call, reps=200)
    result["seconds"] = time.perf_counter() - start
    print("compare_result " + json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
