"""The plain reference: what a correct plan for a schedule is, in numpy alone.

It reads the plain data that generate.py made (the catalog's dicts, the
schedule's counts) and a plan as plain data (packings of nodes holding pod
names, the instance types and pools each may launch as, the plan's own
$/hr), and works out again, in whole millicores, MiB and pod slots:

- each type's allocatable: capacity less its overhead;
- where every pod went: a pod placed twice, a pod missing, a name the
  schedule does not hold, and a pod reported unschedulable though some type
  holds it, each count as misplaced;
- each node's demand against the allocatable of every type it may launch
  as: a node over any of them, and a packing whose node count differs from
  its nodes, count as bad nodes;
- the plan's $/hr: each node at the cheapest pool it lists, priced from the
  catalog (spot where the pool offers spot, as the provisioner allows it);
- a lower bound on any plan's $/hr: the fluid bound, the schedule's summed
  demand bought at the best price per unit any type offers, from the dual of
  that LP; any dual point gives a valid bound;
- the LP relaxation's objective as the program reports it, against that
  bound: a fractional assignment of every pod costs no less than the fluid
  bound, so an objective under it is wrong, and one far over it is an LP
  left unsolved.

It imports nothing of the program.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SPOT = "spot"
# The numbers compared, each against its limit in limits/<cell>.json.
CHECKS = ("misplaced_pods", "bad_nodes", "price_gap", "cost_excess", "lp_excess", "lp_under_bound")


def allocatable(types: Sequence[dict]) -> Dict[str, np.ndarray]:
    """{type name: [cpu millicores, memory MiB, pod slots]} as int64."""
    return {
        t["name"]: np.array(
            [t["vcpus"] * 1000 - t["overhead_cpu_m"], t["memory_mib"] - t["overhead_memory_mib"], t["max_pods"]],
            dtype=np.int64,
        )
        for t in types
    }


def pool_prices(types: Sequence[dict]) -> Dict[Tuple[str, str], float]:
    """{(type, zone): $/hr} of a node launched in that pool: spot where the
    pool offers spot, else the cheapest offering there."""
    prices: Dict[Tuple[str, str], float] = {}
    spot: Dict[Tuple[str, str], float] = {}
    for t in types:
        for zone, capacity_type, price in t["offerings"]:
            key = (t["name"], zone)
            prices[key] = min(prices.get(key, np.inf), price)
            if capacity_type == SPOT:
                spot[key] = min(spot.get(key, np.inf), price)
    prices.update(spot)
    return prices


def fluid_bound(types: Sequence[dict], demand: np.ndarray, steps: int = 200) -> float:
    """A lower bound on the $/hr of any plan for `demand` (cpu millicores,
    memory MiB, pods): the dual of min p.x s.t. A'x >= demand, x >= 0. Any
    y >= 0 with A y <= p bounds it by demand.y; the search walks weights w on
    the simplex, y_j = s w_j / demand_j scaled to feasibility, over a grid
    and then a finer grid around the best point."""
    caps = np.stack(list(allocatable(types).values())).astype(np.float64)  # [T, 3]
    prices = np.array([min(p for _, _, p in t["offerings"]) for t in types], dtype=np.float64)
    demand = np.asarray(demand, dtype=np.float64)
    live = demand > 0
    caps, demand = caps[:, live], demand[live]
    scaled = caps / demand  # [T, D]: share of the demand one node of each type covers

    def best_on(grid: np.ndarray) -> Tuple[float, np.ndarray]:
        covered = grid @ scaled.T  # [N, T]
        values = np.min(prices[None, :] / np.maximum(covered, 1e-300), axis=1)
        i = int(np.argmax(values))
        return float(values[i]), grid[i]

    def simplex(center: Optional[np.ndarray], radius: float) -> np.ndarray:
        dims = scaled.shape[1]
        axis = np.linspace(-radius, radius, steps + 1) if center is not None else np.linspace(0, 1, steps + 1)
        mesh = np.stack(np.meshgrid(*([axis] * (dims - 1)), indexing="ij"), axis=-1).reshape(-1, dims - 1)
        if center is not None:
            mesh = mesh + center[: dims - 1]
        last = 1.0 - mesh.sum(axis=1, keepdims=True)
        points = np.concatenate([mesh, last], axis=1)
        return points[(points >= 0).all(axis=1)]

    if scaled.shape[1] == 1:
        return float(np.min(prices / scaled[:, 0]))
    value, point = best_on(simplex(None, 0.0))
    for radius in (2.0 / steps, 2.0 / steps**2):
        finer, finer_point = best_on(simplex(point, radius))
        if finer > value:
            value, point = finer, finer_point
    return value


def judge(plan: dict, counts: np.ndarray, shapes: Sequence[Tuple[int, int]], types: Sequence[dict],
          pod_name) -> dict:
    """The numbers compared for one schedule's plan. `plan` is
    {"packings": [{"quantity", "types": [names], "pools": [(type, zone,
    price)] or None, "nodes": [[pod names]]}], "unschedulable": [names],
    "projected_cost": $/hr as the program reports it}."""
    alloc = allocatable(types)
    request_of: Dict[str, np.ndarray] = {}
    for s in np.nonzero(counts)[0]:
        need = np.array([shapes[s][0], shapes[s][1], 1], dtype=np.int64)
        for i in range(int(counts[s])):
            request_of[pod_name(int(s), shapes[s], i)] = need
    largest = np.stack(list(alloc.values()))

    placed: Counter = Counter()
    bad_nodes = 0
    for packing in plan["packings"]:
        nodes = packing["nodes"]
        bad_nodes += abs(len(nodes) - int(packing["quantity"]))
        pools = packing["pools"]
        names = set(packing["types"]) | {name for name, _, _ in pools or ()}
        if not names or any(name not in alloc for name in names):
            bad_nodes += len(nodes)
            continue
        caps = np.stack([alloc[name] for name in sorted(names)])
        for node in nodes:
            placed.update(node)
            demand = np.zeros(3, dtype=np.int64)
            for name in node:
                need = request_of.get(name)
                if need is not None:
                    demand += need
            if (demand[None, :] > caps).any():
                bad_nodes += 1

    unschedulable = Counter(plan["unschedulable"])
    misplaced = sum(count - 1 for count in placed.values() if count > 1)
    misplaced += sum(1 for name in placed if name not in request_of)
    misplaced += sum(1 for name in request_of if placed[name] == 0 and unschedulable[name] == 0)
    for name, count in unschedulable.items():
        need = request_of.get(name)
        if need is None or placed[name] or count > 1 or (need[None, :] <= largest).all(axis=1).any():
            misplaced += count
    demand = np.array(
        [sum(int(counts[s]) * shapes[s][k] for s in range(len(shapes))) for k in (0, 1)] + [int(counts.sum())],
        dtype=np.int64,
    )
    bound = fluid_bound(types, demand)
    cost = plan_cost(plan, types)
    reported = float(plan["projected_cost"])
    lp_ratio = lp_over_bound(plan.get("lp_objective"), bound)
    return {
        "misplaced_pods": int(misplaced),
        "bad_nodes": int(bad_nodes),
        "price_gap": abs(reported - cost) / cost if np.isfinite(cost) and cost > 0 else np.inf,
        "cost_excess": cost / bound - 1.0 if np.isfinite(cost) else np.inf,
        "lp_excess": max(lp_ratio - 1.0, 0.0) if np.isfinite(lp_ratio) else np.inf,
        "lp_under_bound": max(1.0 - lp_ratio, 0.0) if np.isfinite(lp_ratio) else np.inf,
        "cost": cost,
    }


def lp_over_bound(objective: Optional[float], bound: float) -> float:
    """The LP objective over the fluid bound; infinite where the program
    reported no objective or one that is not a number."""
    if objective is None or not np.isfinite(objective) or bound <= 0:
        return np.inf
    return float(objective) / bound


def plan_cost(plan: dict, types: Sequence[dict]) -> float:
    """The plan's $/hr priced from the catalog alone (judge's `cost`,
    without reading the nodes)."""
    prices = pool_prices(types)
    min_price = {t["name"]: min(p for _, _, p in t["offerings"]) for t in types}
    total = 0.0
    for packing in plan["packings"]:
        if packing["pools"]:
            price = min(prices.get((name, zone), np.inf) for name, zone, _ in packing["pools"])
        else:
            price = min((min_price.get(name, np.inf) for name in packing["types"]), default=np.inf)
        total += int(packing["quantity"]) * price
    return total


def worst(readings: List[dict]) -> dict:
    """Each number's worst reading over the judged schedules."""
    return {key: max(reading[key] for reading in readings) for key in CHECKS}
