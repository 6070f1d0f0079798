"""The benchmark's one traffic generator: plain data first, the port's objects after.

A configuration file (configs/<name>.json) fixes the instance-type catalog and
the population of pod shapes; a traffic file (traffic/<name>.json) fixes how
many pods a schedule holds and how many schedules set-up builds. `--seed`
draws each schedule's count of every shape. Everything here up to
`port_catalog` and `port_schedules` is plain Python and numpy: the reference
reads these tuples and dicts and never the port's classes.

The two populations are copies of chip_smoke.py's `pod_shapes`,
`zipf_weights` and `many_shapes_pods`, with their constants moved into the
configuration files. The catalog follows aws/karpenter v0.5's
instancetype.go (the ENI pod formula, the VM's share of memory, the
kube-reserved bands and the memory overhead) over EC2's size ladder and
per-vCPU prices, as the configuration file states them.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

SPOT = "spot"
ON_DEMAND = "on-demand"


def kube_reserved_cpu_millis(vcpus: int, config: dict) -> int:
    """Kube-reserved CPU of a node: a share of each band of its millicores
    (the bands of aws/karpenter v0.5's instancetype.go), plus the
    system-reserved millicores."""
    millis = vcpus * 1000
    reserved = float(config["system_reserved_cpu_m"])
    for start, end, share in config["kube_reserved_cpu_bands"]:
        if millis >= start:
            reserved += (min(millis, end) - start) * share
    return int(reserved)


def max_pods(enis: int, ipv4_per_eni: int) -> int:
    """Pod slots of a node, aws/karpenter v0.5's ENI formula: max ENIs x
    (IPv4 addresses per ENI - 1) + 2."""
    return enis * (ipv4_per_eni - 1) + 2


def catalog(config: dict) -> List[dict]:
    """The instance types as dicts: name, vcpus, memory_mib (the node's
    capacity: EC2's memory less the VM's share), max_pods, the overhead (cpu
    millicores, MiB) and the offerings (zone, capacity type, $/hr). Types
    cycle through families, then sizes, then price variants. A type's
    on-demand price is its family's price per vCPU (EC2's .large price over
    2) times its vCPUs, raised by `variant_step` for each variant; its pods
    and memory overhead follow instancetype.go from its size's ENI limits."""
    spec = config["catalog"]
    families = spec["families"]
    sizes = spec["sizes"]
    spot_rng = np.random.default_rng(spec["seed"] + 1)
    low, high = spec["spot_share"]
    types = []
    for index in range(spec["types"]):
        family, mib_per_vcpu, large_price = families[index % len(families)]
        size, vcpus, enis, ipv4_per_eni = sizes[(index // len(families)) % len(sizes)]
        variant = index // (len(families) * len(sizes))
        on_demand = large_price / 2 * vcpus * (1.0 + spec["variant_step"] * variant)
        pods = max_pods(enis, ipv4_per_eni)
        offerings = []
        for zone in spec["zones"]:
            offerings.append((zone, ON_DEMAND, on_demand))
            offerings.append((zone, SPOT, on_demand * float(spot_rng.uniform(low, high))))
        types.append({
            "name": f"{family}.{size}" if variant == 0 else f"{family}-v{variant}.{size}",
            "vcpus": vcpus,
            "memory_mib": int(vcpus * mib_per_vcpu * spec["vm_memory_factor"]),
            "max_pods": pods,
            "overhead_cpu_m": kube_reserved_cpu_millis(vcpus, spec),
            "overhead_memory_mib": spec["memory_overhead_mib_per_pod"] * pods + spec["memory_overhead_mib_base"],
            "offerings": offerings,
        })
    return types


def population(config: dict) -> Tuple[List[Tuple[int, int]], np.ndarray]:
    """The deployment's pod shapes as (cpu millicores, memory MiB) and the
    weight of each. `zipf`: shapes drawn on the grid with repetition, Zipf
    weights. `grid`: distinct cells of the grid, even weights."""
    spec = config["pods"]
    rng = np.random.default_rng(spec["seed"])
    cpu_step, cpu_steps = spec["cpu_step_m"], spec["cpu_steps"]
    mem_step, mem_steps = spec["memory_step_mib"], spec["memory_steps"]
    count = spec["shapes"]
    if spec["kind"] == "zipf":
        shapes = [
            (int(rng.integers(1, cpu_steps + 1)) * cpu_step, int(rng.integers(1, mem_steps + 1)) * mem_step)
            for _ in range(count)
        ]
        weights = 1.0 / np.arange(1, count + 1)
    elif spec["kind"] == "grid":
        cells = rng.choice(cpu_steps * mem_steps, count, replace=False)
        shapes = [(int(c // mem_steps + 1) * cpu_step, int(c % mem_steps + 1) * mem_step) for c in cells]
        weights = np.ones(count)
    else:
        raise ValueError(f"unknown pod population kind {spec['kind']!r}")
    return shapes, weights / weights.sum()


def pod_name(shape_index: int, shape: Tuple[int, int], ordinal: int) -> str:
    cpu, mem = shape
    return f"s{shape_index}-{cpu}m-{mem}Mi-{ordinal}"


def _rng_for(seed: int, stream: int) -> np.random.Generator:
    # Seeds may exceed 32 bits or be negative: fold them into 64 unsigned bits.
    return np.random.default_rng([seed % (1 << 64), stream])


def schedules(config: dict, traffic: dict, seed: int) -> np.ndarray:
    """The cycle's schedules as plain data: [cycle, shapes] pods of each
    shape, a multinomial draw of each schedule's pods over the population's
    weights. The pods of shape s are pod_name(s, shape, 0..count-1)."""
    _, weights = population(config)
    rng = _rng_for(seed, 0)
    return np.stack([
        rng.multinomial(traffic["pods_per_schedule"], weights) for _ in range(traffic["cycle"])
    ])


def check_rng(seed: int) -> np.random.Generator:
    """The generator that draws which completed schedules the check judges."""
    return _rng_for(seed, 1)


# --- the port's objects, built from the plain data --------------------------


def port_catalog(types: Sequence[dict]):
    from karpenter_tpu_torch.cloudprovider import InstanceType, Offering

    return [
        InstanceType(
            name=t["name"],
            capacity={"cpu": t["vcpus"], "memory": f"{t['memory_mib']}Mi", "pods": t["max_pods"]},
            overhead={"cpu": f"{t['overhead_cpu_m']}m", "memory": f"{t['overhead_memory_mib']}Mi"},
            offerings=[Offering(zone=z, capacity_type=c, price=p) for z, c, p in t["offerings"]],
        )
        for t in types
    ]


def port_schedules(shapes: Sequence[Tuple[int, int]], cycle: np.ndarray):
    """The cycle's schedules as lists of the port's PodSpec. A schedule with
    k pods of shape s holds the first k of one shared list of that shape's
    pods, so set-up builds each pod object once however long the cycle."""
    from karpenter_tpu_torch.api.pods import PodSpec

    most = cycle.max(axis=0)
    pools: Dict[int, list] = {}
    for s in np.nonzero(most)[0]:
        cpu, mem = shapes[s]
        requests = {"cpu": f"{cpu}m", "memory": f"{mem}Mi"}
        pools[int(s)] = [
            PodSpec(name=pod_name(int(s), shapes[s], i), requests=dict(requests), unschedulable=True)
            for i in range(int(most[s]))
        ]
    return [
        [pod for s in np.nonzero(counts)[0] for pod in pools[int(s)][: int(counts[s])]]
        for counts in cycle
    ]
