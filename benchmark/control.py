#!/usr/bin/env python3
"""The control and the planted faults: runs whose `correct` has to read false.

    python3 benchmark/control.py --workload NAME --mode MODE [MODE ...] --seeds N [N ...] [--seconds S]

The configurations state no precision: they state guarantees. So the control
is the plain reference put in the program's place with one guarantee broken:
a first-fit-decreasing packer (`FfdSolver`) that fills nodes against the raw
capacity and leaves out the kube-reserved, system-reserved and eviction
overhead, the step a faster plan would be tempted to take. The faults are
planted in the program, at run time in this process:

- `state_unchanged`: every solve hands back the plan of the solve before it;
- `half_batch`: the program is handed half of each schedule's pods;
- `answer_altered`: each decoded packing launches as the dearest instance
  type that holds its nodes (every guarantee kept, the plan worse);
- `price_altered`: the decoded pool prices are cut by a fifth;
- `lp_unmoved`: the LP relaxation (K3) takes one Adam step of its 300, so
  its state all but keeps its start.

Each mode runs the cell's own sizes, a short window per seed, and prints
each seed's checks beside the limits. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import generate, reference, run  # noqa: E402

MODES = ("control", "state_unchanged", "half_batch", "answer_altered", "price_altered", "lp_unmoved")


def ffd_plan(types: Sequence[dict], shapes: Sequence[Tuple[int, int]], counts: np.ndarray,
             honour_overhead: bool) -> dict:
    """First-fit decreasing, as plain data: every node is of the type with the
    lowest price per vCPU among those that hold the largest pod left; its
    pods are taken greedily from the groups in descending (cpu, memory)
    order, and the fill is repeated while every group it takes from has
    enough pods left. With honour_overhead=False a node's room is its raw
    capacity."""
    caps = np.array([
        [t["vcpus"] * 1000, t["memory_mib"], t["max_pods"]] for t in types
    ], dtype=np.int64)
    if honour_overhead:
        caps = np.stack(list(reference.allocatable(types).values()))
    prices = reference.pool_prices(types)
    cheapest = [min(((prices[(t["name"], z)], z) for z, _, _ in t["offerings"])) for t in types]
    order = sorted(np.nonzero(counts)[0], key=lambda s: (-shapes[s][0], -shapes[s][1]))
    left = {int(s): int(counts[s]) for s in order}
    taken = {int(s): 0 for s in order}
    per_cpu = np.array([price for price, _ in cheapest]) / caps[:, 0]
    packings: List[dict] = []
    total = 0.0
    while any(left.values()):
        first = next(s for s in order if left[s])
        need = np.array([shapes[first][0], shapes[first][1], 1])
        holds = (caps >= need).all(axis=1)
        t = int(np.argmin(np.where(holds, per_cpu, np.inf)))
        room = caps[t].copy()
        fill: Dict[int, int] = {}
        for s in order:
            if not left[s]:
                continue
            vec = np.array([shapes[s][0], shapes[s][1], 1])
            n = min(left[s], int(np.min(room // vec)))
            if n:
                fill[s] = n
                room -= n * vec
        repl = max(1, min(left[s] // n for s, n in fill.items()))
        nodes = []
        for _ in range(repl):
            node = []
            for s, n in fill.items():
                node += [generate.pod_name(s, shapes[s], taken[s] + i) for i in range(n)]
                taken[s] += n
                left[s] -= n
            nodes.append(node)
        price, zone = cheapest[t]
        packings.append({"quantity": repl, "types": [types[t]["name"]],
                         "pools": [(types[t]["name"], zone, price)], "nodes": nodes})
        total += repl * price
    # The control's LP objective: the reference's own bound on the same raw capacity.
    raw = [{**t, "overhead_cpu_m": 0, "overhead_memory_mib": 0} for t in types]
    if honour_overhead:
        raw = types
    demand = np.array([sum(int(counts[s]) * shapes[s][k] for s in range(len(shapes))) for k in (0, 1)]
                      + [int(counts.sum())], dtype=np.int64)
    return {"packings": packings, "unschedulable": [], "projected_cost": total,
            "lp_objective": reference.fluid_bound(raw, demand)}


class FfdSolver:
    """The control in the program's place: reads each pod's shape from its
    name, as the generator wrote it, and returns a plain plan."""

    def __init__(self, types: Sequence[dict], shapes: Sequence[Tuple[int, int]], honour_overhead: bool = False):
        self.types, self.shapes, self.honour_overhead = types, shapes, honour_overhead

    def solve(self, pods, instance_types, constraints) -> dict:
        counts = np.zeros(len(self.shapes), dtype=np.int64)
        for pod in pods:
            counts[int(pod.name.split("-", 1)[0][1:])] += 1
        return ffd_plan(self.types, self.shapes, counts, self.honour_overhead)


@contextlib.contextmanager
def planted(mode: str):
    """Plant `mode`'s fault in the program for the duration of the block
    ("control" plants none: its solver replaces the program's)."""
    from karpenter_tpu_torch.models import solver as solver_module
    from karpenter_tpu_torch.ops import ffd

    undo = []

    def patch(owner, name, value):
        undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    try:
        if mode == "state_unchanged":
            original = solver_module.CostSolver.solve
            last = []

            def solve_lagged(self, *args, **kwargs):
                # Hands back the plan of the call before; the first call's own.
                plan = original(self, *args, **kwargs)
                last.append(plan)
                return last[-2] if len(last) > 1 else plan

            patch(solver_module.CostSolver, "solve", solve_lagged)
        elif mode == "half_batch":
            original = solver_module.CostSolver.solve
            patch(solver_module.CostSolver, "solve",
                  lambda self, pods, *args, **kwargs: original(self, list(pods)[: len(pods) // 2], *args, **kwargs))
        elif mode == "lp_unmoved":
            original = solver_module.lp_relax
            patch(solver_module, "lp_relax", lambda *args, steps, **kwargs: original(*args, steps=1, **kwargs))
        elif mode in ("answer_altered", "price_altered"):
            original = solver_module.decode_dense_result

            def altered(dense, groups, fleet, zones):
                result = original(dense, groups, fleet, zones)
                for packing in result.packings:
                    if mode == "price_altered":
                        for option in packing.pool_options or ():
                            option.price *= 0.8
                        continue
                    # fleet.capacity: each type's usable [cpu millicores, MiB, pods, ...].
                    holds = np.nonzero((fleet.capacity[:, :3] >= _node_demand(packing) - 1e-6).all(axis=1))[0]
                    dearest = max(holds, key=lambda i: fleet.instance_types[i].min_price())
                    chosen = fleet.instance_types[dearest]
                    zone = min(chosen.offerings, key=lambda o: o.price).zone
                    packing.instance_type_options = [chosen]
                    packing.pool_options = [ffd.PoolOption(instance_type=chosen, zone=zone,
                                                           price=chosen.min_price(zones=[zone]), priority=0)]
                return result

            patch(solver_module, "decode_dense_result", altered)
        elif mode != "control":
            raise ValueError(f"unknown mode {mode!r}")
        yield None
    finally:
        for owner, name, value in reversed(undo):
            setattr(owner, name, value)


def _node_demand(packing) -> np.ndarray:
    """The largest (cpu millicores, memory MiB, pods) any node of the
    packing holds, from its pods' requests."""
    most = np.zeros(3)
    for node in packing.pods_per_node:
        demand = np.array([
            sum(pod.requests.get("cpu", 0.0) for pod in node) * 1000.0,
            sum(pod.requests.get("memory", 0.0) for pod in node) / 2**20,
            len(node),
        ])
        most = np.maximum(most, demand)
    return most


def run_mode(cell: run.Cell, mode: str, seed: int, seconds: float, device: str = "cuda") -> dict:
    make_solver = None
    if mode == "control":
        types = generate.catalog(cell.config)
        shapes, _ = generate.population(cell.config)

        def make_solver():
            return FfdSolver(types, shapes, honour_overhead=False)

    # A reading needs the window's judged schedules only, not the cost metric's.
    cell = dataclasses.replace(cell, traffic={**cell.traffic, "cost_schedules": 0})
    with planted(mode):
        return run.run_cell(cell, seed, seconds, trace=False, device=device, make_solver=make_solver)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--mode", choices=MODES, nargs="+", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=10.0)
    args = parser.parse_args(argv)
    cell = run.load_cell(args.workload)
    run.require_card(cell.chips)
    for mode in args.mode:
        for seed in args.seeds:
            line = run_mode(cell, mode, seed, args.seconds)
            print(json.dumps({"mode": mode, "seed": seed, "correct": line["correct"],
                              "attempted": line["attempted"], "checks": line["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
