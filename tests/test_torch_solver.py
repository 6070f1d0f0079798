"""The port's provisioning solve against the JAX reference, as a whole.

The same encoded problem goes through the reference's fused device program
(`_cost_fused_body`) and the port's (on the CPU, through the kernels' plain
versions): the integer plans must be bit-identical and the LP objective
within a stated tolerance. Then one workload, built twice from one numpy
spec (once from each package's own api and cloudprovider types), goes through
both packages' CostSolver.solve: every pod placed exactly once, the same node
count, and $/hr within 1e-3.
"""

import numpy as np
import pytest
import torch

import bench
from karpenter_tpu.api import wellknown as ref_wellknown
from karpenter_tpu.api import pods as ref_pods
from karpenter_tpu.api import provisioner as ref_provisioner
from karpenter_tpu import cloudprovider as ref_cloud
from karpenter_tpu.models import solver as ref_solver
from karpenter_tpu.ops import encode as ref_encode
from karpenter_tpu_torch.api import pods as port_pods
from karpenter_tpu_torch.api import provisioner as port_provisioner
from karpenter_tpu_torch import cloudprovider as port_cloud
from karpenter_tpu_torch.convert import fused_args_from_numpy, fused_outputs_to_numpy
from karpenter_tpu_torch.device import resolve_device
from karpenter_tpu_torch.models import solver as port_solver
from karpenter_tpu_torch.ops import encode as port_encode
from karpenter_tpu_torch.ops import pack_kernel as port_pack

from tests import fixtures

torch.set_num_threads(2)

# The LP objective is a float32 sum after 300 Adam steps whose sums are taken
# in another order on each side (see tests/test_torch_kernels.py).
LP_OBJECTIVE_RTOL = 1e-4
# Whole-slice plans are scored in float64 on the host from identical integer
# candidates; the tolerance covers an LP-realized candidate whose rounding
# could differ by a pod between the two LP trajectories.
COST_RTOL = 1e-3

ZONES = ("z-1a", "z-1b", "z-1c")


@pytest.fixture
def device_path(monkeypatch):
    """Both packages on their device path: the host gate off, and the
    reference on its single-device program (the test process has an 8-device
    virtual CPU mesh)."""
    monkeypatch.setenv("KARPENTER_HOST_SOLVE", "0")
    monkeypatch.setenv("KARPENTER_SHARDED_SOLVE", "0")


# --- one spec, two packages' objects -----------------------------------------


def make_spec(seed, num_pods=2000, num_types=40, num_shapes=16):
    """The bench workload's shapes at a small size, as plain numbers: Zipf
    pod shapes; families x sizes of types; on-demand and spot per zone."""
    rng = np.random.default_rng(seed)
    shapes = [
        (int(rng.integers(1, 17)) * 250, int(rng.integers(1, 33)) * 256)
        for _ in range(num_shapes)
    ]
    weights = 1.0 / np.arange(1, num_shapes + 1)
    weights /= weights.sum()
    counts = (weights * num_pods).astype(int)
    counts[0] += num_pods - counts.sum()
    families = [("c", 2.0, 0.17), ("m", 4.0, 0.192), ("r", 8.0, 0.252), ("x", 16.0, 0.333)]
    sizes = [1, 2, 3, 4, 6, 8, 12, 16, 24, 32]
    types = []
    for idx in range(num_types):
        family, mem_per_cpu, base = families[idx % len(families)]
        size = sizes[(idx // len(families)) % len(sizes)]
        cpu = 2 * size
        on_demand = base * size * (1.0 + 0.03 * (idx // 40))
        max_pods = min(110, 8 + 15 * size)
        offerings = []
        for zone in ZONES:
            offerings.append((zone, "on-demand", on_demand))
            offerings.append((zone, "spot", on_demand * float(rng.uniform(0.25, 0.75))))
        types.append(
            dict(
                name=f"{family}{idx // 40}.{size}x",
                capacity={"cpu": cpu, "memory": f"{int(cpu * mem_per_cpu)}Gi", "pods": max_pods},
                overhead={"cpu": f"{100 + 60 * cpu}m", "memory": f"{11 * max_pods + 455}Mi"},
                offerings=offerings,
            )
        )
    return {"shapes": list(zip(shapes, counts)), "types": types}


def build(spec, pods_mod, cloud_mod):
    pods = [
        pods_mod.PodSpec(
            name=f"pod-{k}-{i}",
            requests={"cpu": f"{cpu}m", "memory": f"{mem}Mi"},
            unschedulable=True,
        )
        for k, ((cpu, mem), count) in enumerate(spec["shapes"])
        for i in range(count)
    ]
    catalog = [
        cloud_mod.InstanceType(
            name=t["name"],
            capacity=dict(t["capacity"]),
            overhead=dict(t["overhead"]),
            offerings=[
                cloud_mod.Offering(zone=z, capacity_type=c, price=p) for z, c, p in t["offerings"]
            ],
        )
        for t in spec["types"]
    ]
    return pods, catalog


def build_both(spec):
    return build(spec, ref_pods, ref_cloud), build(spec, port_pods, port_cloud)


def placed_once(result, pods) -> bool:
    names = [pod.name for packing in result.packings for node in packing.pods_per_node for pod in node]
    names += [pod.name for pod in result.unschedulable]
    return len(names) == len(pods) and set(names) == {pod.name for pod in pods}


# --- encode ---------------------------------------------------------------------

CONSTRAINT_LABELS = [
    {},
    {ref_wellknown.ZONE_LABEL: "z-1b"},
    {ref_wellknown.CAPACITY_TYPE_LABEL: "on-demand"},
    {ref_wellknown.CAPACITY_TYPE_LABEL: "spot", ref_wellknown.ZONE_LABEL: "z-1c"},
]


@pytest.mark.parametrize("labels", CONSTRAINT_LABELS, ids=["open", "zone", "on-demand", "spot-zone"])
def test_encode_arrays_equal_reference(labels):
    (ref_p, ref_c), (port_p, port_c) = build_both(make_spec(11, num_pods=600, num_types=24))
    ref_groups = ref_encode.group_pods(ref_p)
    port_groups = port_encode.group_pods(port_p)
    np.testing.assert_array_equal(port_groups.vectors, ref_groups.vectors)
    np.testing.assert_array_equal(port_groups.counts, ref_groups.counts)
    assert [[p.name for p in m] for m in port_groups.members] == [
        [p.name for p in m] for m in ref_groups.members
    ]
    ref_fleet = ref_encode.build_fleet(ref_c, ref_provisioner.Constraints(labels=dict(labels)), ref_p)
    port_fleet = port_encode.build_fleet(
        port_c, port_provisioner.Constraints(labels=dict(labels)), port_p
    )
    for name in ("capacity", "total", "prices"):
        np.testing.assert_array_equal(getattr(port_fleet, name), getattr(ref_fleet, name))
    assert [it.name for it in port_fleet.instance_types] == [it.name for it in ref_fleet.instance_types]
    assert port_fleet.allowed_zones == ref_fleet.allowed_zones
    assert port_fleet.capacity_type == ref_fleet.capacity_type
    ref_zones, ref_matrix = ref_solver._pool_price_matrix(ref_fleet)
    port_zones, port_matrix = port_solver._pool_price_matrix(port_fleet)
    assert port_zones == ref_zones
    np.testing.assert_array_equal(port_matrix, ref_matrix)


# --- the fused device program -----------------------------------------------------


FUSED_WORKLOADS = [(2000, 40, 0), (5000, 100, 1), (1000, 24, 2)]


@pytest.mark.parametrize("workload", FUSED_WORKLOADS, ids=lambda w: f"{w[0]}x{w[1]}")
def test_fused_body_matches_reference(workload, device_path):
    pods, catalog, _ = bench.make_workload(*workload[:2], seed=workload[2])
    groups = ref_encode.group_pods(pods)
    fleet = ref_encode.build_fleet(catalog, ref_provisioner.Constraints(), pods)
    padded = ref_solver.pad_kernel_args(
        groups.vectors, groups.counts, fleet.capacity, fleet.total, fleet.prices
    )
    port_padded = port_solver.pad_kernel_args(
        groups.vectors, groups.counts, fleet.capacity, fleet.total, fleet.prices
    )
    for a, b in zip(padded, port_padded):
        np.testing.assert_array_equal(a, b)
    want = [np.asarray(x) for x in ref_solver._cost_fused_kernel_nodonate(*padded, lp_steps=300)]
    got = fused_outputs_to_numpy(
        *port_solver._cost_fused_body(
            *fused_args_from_numpy(*padded, device="cpu"), lp_steps=300
        )
    )
    np.testing.assert_array_equal(got[0], want[0])  # compact payload, word for word
    np.testing.assert_array_equal(got[2], want[2])  # dense spill
    num_groups = padded[0].shape[0]
    ref_ffd, ref_cost, ref_feasible, _ = ref_pack_decompact(want[0], num_groups)
    port_ffd, port_cost, port_feasible, ok = port_pack.decompact_plan(got[0], num_groups)
    assert ok
    np.testing.assert_array_equal(port_feasible, ref_feasible)
    for port_rounds, ref_rounds in ((port_ffd, ref_ffd), (port_cost, ref_cost)):
        for a, b in zip(port_rounds, ref_rounds):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_allclose(got[1], want[1], rtol=LP_OBJECTIVE_RTOL)


def ref_pack_decompact(words, num_groups):
    from karpenter_tpu.ops.pack_kernel import decompact_plan

    return decompact_plan(words, num_groups)


# --- the slice as a whole ------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_cost_solver_device_path_matches_reference(seed, device_path):
    (ref_p, ref_c), (port_p, port_c) = build_both(make_spec(seed))
    want = ref_solver.CostSolver().solve(ref_p, ref_c, ref_provisioner.Constraints())
    got = port_solver.CostSolver(device="cpu").solve(
        port_p, port_c, port_provisioner.Constraints()
    )
    assert placed_once(want, ref_p) and placed_once(got, port_p)
    assert not got.unschedulable and not want.unschedulable
    assert got.node_count == want.node_count
    np.testing.assert_allclose(got.projected_cost(), want.projected_cost(), rtol=COST_RTOL)


def test_explained_candidates_match_reference(device_path):
    """Every scored candidate, by label: the kernel, mix and host candidates
    are scored in float64 from identical integer rounds, so their scores are
    equal; the LP-realized one rides the LP trajectory (COST_RTOL)."""
    (ref_p, ref_c), (port_p, port_c) = build_both(make_spec(4, num_pods=1200, num_types=32))
    ref_groups = ref_encode.group_pods(ref_p)
    ref_fleet = ref_encode.build_fleet(ref_c, ref_provisioner.Constraints(), ref_p)
    port_groups = port_encode.group_pods(port_p)
    port_fleet = port_encode.build_fleet(port_c, port_provisioner.Constraints(), port_p)
    want, got = {}, {}
    ref_solver.CostSolver().solve_encoded(ref_groups, ref_fleet, explain=want)
    port_solver.CostSolver(device="cpu").solve_encoded(port_groups, port_fleet, explain=got)
    want_scores = {label: score for label, _, score in want["candidates"]}
    got_scores = {label: score for label, _, score in got["candidates"]}
    assert list(got_scores) == list(want_scores)
    assert {"kernel_ffd", "kernel_cost"} <= set(got_scores)
    for label, score in got_scores.items():
        if label == "lp_realized":
            assert score[0] == want_scores[label][0]
            np.testing.assert_allclose(score[1], want_scores[label][1], rtol=COST_RTOL)
        else:
            assert score == want_scores[label], label


def test_cost_solver_host_path_matches_reference(monkeypatch):
    monkeypatch.setenv("KARPENTER_HOST_SOLVE", "1")
    monkeypatch.setenv("KARPENTER_SHARDED_SOLVE", "0")
    (ref_p, ref_c), (port_p, port_c) = build_both(make_spec(3, num_pods=1500, num_types=32))
    want = ref_solver.CostSolver().solve(ref_p, ref_c, ref_provisioner.Constraints())
    got = port_solver.CostSolver(device="cpu").solve(
        port_p, port_c, port_provisioner.Constraints()
    )
    assert placed_once(got, port_p)
    assert got.node_count == want.node_count
    np.testing.assert_allclose(got.projected_cost(), want.projected_cost(), rtol=COST_RTOL)


def test_solve_encoded_many_matches_single_solves(device_path):
    _, (pods, catalog) = build_both(make_spec(5, num_pods=900, num_types=24))
    problems = [(pods[k::3], catalog, port_provisioner.Constraints(), ()) for k in range(3)]
    solver = port_solver.CostSolver(device="cpu", lp_steps=50)
    batch = solver.solve_many(problems)
    for (schedule_pods, *_), result in zip(problems, batch):
        single = solver.solve(schedule_pods, catalog, port_provisioner.Constraints())
        assert placed_once(result, schedule_pods)
        assert result.node_count == single.node_count
        assert result.projected_cost() == pytest.approx(single.projected_cost(), rel=1e-12)


# --- host solvers --------------------------------------------------------------------

HOST_FIXTURES = {
    "mixed": lambda m: (
        [m.PodSpec(name=f"a{i}", requests={"cpu": "1500m", "memory": "1Gi"}) for i in range(40)]
        + [m.PodSpec(name=f"b{i}", requests={"cpu": "500m", "memory": "3Gi"}) for i in range(40)]
        + [m.PodSpec(name=f"c{i}", requests={"cpu": "4", "memory": "8Gi"}) for i in range(7)]
    ),
    "exact_fit": lambda m: (
        [m.PodSpec(name=f"a{i}", requests={"cpu": "1500m"}) for i in range(4)]
        + [m.PodSpec(name=f"b{i}", requests={"cpu": "500m"}) for i in range(4)]
    ),
    "giant": lambda m: (
        [m.PodSpec(name="giant", requests={"cpu": "64"})]
        + [m.PodSpec(name=f"a{i}", requests={"cpu": "1"}) for i in range(3)]
    ),
}


def _ladder(cloud_mod, n=8):
    return [
        cloud_mod.InstanceType(
            name=f"ladder-{i + 1}",
            capacity={"cpu": 2 * (i + 1), "memory": f"{4 * (i + 1)}Gi", "pods": 110},
            offerings=[cloud_mod.Offering(zone=z, price=0.05 * (i + 1)) for z in fixtures.ZONES],
        )
        for i in range(n)
    ]


def _canonical(result):
    return sorted(
        (tuple(it.name for it in p.instance_type_options), tuple(sorted(pod.name for pod in node)))
        for p in result.packings
        for node in p.pods_per_node
    ), sorted(pod.name for pod in result.unschedulable)


@pytest.mark.parametrize("solver_name", ["GreedySolver", "NativeSolver"])
@pytest.mark.parametrize("fixture", sorted(HOST_FIXTURES))
def test_host_solvers_match_reference(fixture, solver_name):
    make = HOST_FIXTURES[fixture]
    want = getattr(ref_solver, solver_name)().solve(
        make(ref_pods), _ladder(ref_cloud), ref_provisioner.Constraints()
    )
    got = getattr(port_solver, solver_name)().solve(
        make(port_pods), _ladder(port_cloud), port_provisioner.Constraints()
    )
    assert _canonical(got) == _canonical(want)


# --- the device verdict ------------------------------------------------------------


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the refusal path needs none")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_solver.CostSolver()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")


def test_cpu_only_when_asked():
    assert resolve_device("cpu") == torch.device("cpu")
    assert port_solver.CostSolver(device="cpu").device.type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")
