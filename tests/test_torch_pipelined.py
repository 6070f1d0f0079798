"""The port's pipelined solve, its encoded-state fast path and its
device-memory ladder, on the CPU.

`solve_many_pipelined` must hand back the plans `solve_many` computes, bit
for bit, and match the JAX package's pipelined solve within the main path's
cost tolerance (tests/test_torch_solver.py COST_RTOL). The fast path (a
`DeviceClusterState` handing the solver a pre-encoded pair whose pod tensors
are already on the device) must give the snapshot path's plan. An injected
out-of-memory fault, at one and two split depths and in the middle of the
pipeline, and the `KARPENTER_HBM_BYTES` pre-split, must leave the plans
bit-identical, and the split counters must count them.
"""

import numpy as np
import pytest
import torch

from karpenter_tpu.api import provisioner as ref_provisioner
from karpenter_tpu.controllers import cluster as ref_cluster
from karpenter_tpu.models import cluster_state as ref_state
from karpenter_tpu.models import solver as ref_solver
from karpenter_tpu_torch.api import provisioner as port_provisioner
from karpenter_tpu_torch.controllers.cluster import Cluster
from karpenter_tpu_torch.models import solver as port_solver
from karpenter_tpu_torch.models.cluster_state import DeviceClusterState
from karpenter_tpu_torch.ops import pack_kernel as port_pack
from karpenter_tpu_torch.utils import faultpoints

from tests.test_torch_solver import COST_RTOL, build_both, make_spec, placed_once

torch.set_num_threads(2)

# The LP runs fewer steps than production on the port-only comparisons: the
# plans under test are the solver's, whatever the LP's trajectory.
LP_STEPS = 60


@pytest.fixture
def device_path(monkeypatch):
    """Both packages on their device path: the host gate off, the reference
    on its single-device program, no armed faults after the test."""
    monkeypatch.setenv("KARPENTER_HOST_SOLVE", "0")
    monkeypatch.setenv("KARPENTER_SHARDED_SOLVE", "0")
    monkeypatch.delenv("KARPENTER_HBM_BYTES", raising=False)
    yield
    faultpoints.disarm_all()


def _plan(result):
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


def _problems(seed=5, schedules=4, num_pods=800, num_types=24):
    (ref_pods, ref_catalog), (pods, catalog) = build_both(
        make_spec(seed, num_pods=num_pods, num_types=num_types)
    )
    port = [
        (pods[k::schedules], catalog, port_provisioner.Constraints(), ())
        for k in range(schedules)
    ]
    ref = [
        (ref_pods[k::schedules], ref_catalog, ref_provisioner.Constraints(), ())
        for k in range(schedules)
    ]
    return port, ref


def _split(reason):
    return port_solver.SOLVER_BATCH_SPLIT_TOTAL.get(reason)


def test_pipelined_equals_the_batch_and_the_reference(device_path):
    port, ref = _problems(schedules=3, num_pods=600)
    solver = port_solver.CostSolver(device="cpu")
    stream = solver.solve_many_pipelined(port)
    batch = solver.solve_many(port)
    piped = list(stream)
    want = list(ref_solver.CostSolver().solve_many_pipelined(ref))
    assert len(piped) == len(batch) == len(want) == 3
    for (pods, *_), got, same, theirs, (ref_pods, *_) in zip(port, piped, batch, want, ref):
        assert _plan(got) == _plan(same)
        assert placed_once(got, pods) and placed_once(theirs, ref_pods)
        assert got.node_count == theirs.node_count
        np.testing.assert_allclose(got.projected_cost(), theirs.projected_cost(), rtol=COST_RTOL)


def test_fast_path_equals_the_snapshot_path_and_the_reference(device_path):
    (ref_pods, ref_catalog), (pods, catalog) = build_both(make_spec(8, num_pods=700, num_types=24))
    cluster = Cluster()
    state = DeviceClusterState(cluster, device="cpu")
    for pod in pods:
        cluster.apply_pod(pod)
    constraints = port_provisioner.Constraints()
    pending = [p for p in cluster.list_pods() if p.is_provisionable()]
    pair = state.encode_schedule(pending, catalog, constraints, [])
    assert pair is not None and pair[0].device_vectors is not None
    solver = port_solver.CostSolver(device="cpu")
    (fast,) = list(solver.solve_many_pipelined([pair]))
    (snapshot,) = solver.solve_many([(pending, catalog, constraints, ())])
    assert _plan(fast) == _plan(snapshot)
    assert placed_once(fast, pods) and not fast.unschedulable

    theirs_cluster = ref_cluster.Cluster()
    theirs_state = ref_state.DeviceClusterState(theirs_cluster)
    for pod in ref_pods:
        theirs_cluster.apply_pod(pod)
    theirs_pending = [p for p in theirs_cluster.list_pods() if p.is_provisionable()]
    theirs_pair = theirs_state.encode_schedule(
        theirs_pending, ref_catalog, ref_provisioner.Constraints(), []
    )
    (want,) = list(ref_solver.CostSolver().solve_many_pipelined([theirs_pair]))
    assert fast.node_count == want.node_count
    np.testing.assert_allclose(fast.projected_cost(), want.projected_cost(), rtol=COST_RTOL)


def test_fleet_arrays_stay_resident_across_solves(device_path):
    port, _ = _problems(schedules=1, num_pods=300)
    port_pack.reset_device_resident()
    (groups, fleet), = port_solver.Solver._encode_problems(port)
    args = (groups.vectors, groups.counts, fleet.capacity, fleet.total, fleet.prices)
    first = port_solver.cost_solve_dispatch(*args, lp_steps=5, device="cpu")
    again = port_solver.cost_solve_dispatch(*args, lp_steps=5, device="cpu")
    assert len(port_pack._DEVICE_RESIDENT) == 4  # capacity, total, valid, prices
    port_solver.fetch_plans([first, again])


@pytest.mark.parametrize("depth", [1, 2])
def test_injected_oom_bisects_to_identical_plans(device_path, depth):
    port, _ = _problems(schedules=4, num_pods=480)
    solver = port_solver.CostSolver(device="cpu", lp_steps=LP_STEPS)
    clean = [_plan(result) for result in solver.solve_many(port)]
    before = (_split("oom"), _split("floor"))
    faultpoints.arm("solver.dispatch", "oom", count=depth)
    recovered = [_plan(result) for result in solver.solve_many(port)]
    assert recovered == clean
    assert faultpoints.fired("solver.dispatch") == depth
    # Depth 1 bisects the batch once; depth 2 the first half again.
    assert (_split("oom"), _split("floor")) == (before[0] + depth, before[1])


def test_injected_oom_mid_pipeline_resolves_the_tail(device_path):
    port, _ = _problems(schedules=4, num_pods=480)
    solver = port_solver.CostSolver(device="cpu", lp_steps=LP_STEPS)
    clean = [_plan(result) for result in solver.solve_many(port)]
    before = _split("oom")
    stream = solver.solve_many_pipelined(port)
    first = _plan(next(stream))
    faultpoints.arm("solver.dispatch", "oom", count=1)
    rest = [_plan(result) for result in stream]
    assert [first] + rest == clean
    assert faultpoints.fired("solver.dispatch") == 1
    assert _split("oom") == before + 1


def test_a_singleton_that_still_exhausts_memory_answers_from_the_host(device_path):
    port, _ = _problems(schedules=1, num_pods=200)
    solver = port_solver.CostSolver(device="cpu", lp_steps=LP_STEPS)
    before = _split("floor")
    faultpoints.arm("solver.dispatch", "oom", count=1)
    (result,) = solver.solve_many(port)
    assert placed_once(result, port[0][0])
    assert _split("floor") == before + 1


def test_hbm_budget_presplits_the_batch(device_path, monkeypatch):
    port, _ = _problems(schedules=4, num_pods=480)
    solver = port_solver.CostSolver(device="cpu", lp_steps=LP_STEPS)
    clean = [_plan(result) for result in solver.solve_many(port)]
    items = port_solver.Solver._encode_problems(port)
    one = max(port_solver._estimate_solve_bytes(*item) for item in items)
    # Room for one schedule at a time under the safety factor.
    monkeypatch.setenv("KARPENTER_HBM_BYTES", str(1.2 * one / port_solver.HBM_SAFETY_FACTOR))
    assert len(port_solver._presplit_for_hbm(items, "cpu")) == 4
    before = (_split("estimate"), _split("oom"))
    assert [_plan(result) for result in solver.solve_many(port)] == clean
    assert (_split("estimate"), _split("oom")) == (before[0] + 3, before[1])


def test_hbm_budget_is_unknown_on_the_cpu(monkeypatch):
    monkeypatch.delenv("KARPENTER_HBM_BYTES", raising=False)
    assert port_solver._hbm_budget_bytes("cpu") is None
    monkeypatch.setenv("KARPENTER_HBM_BYTES", "12345")
    assert port_solver._hbm_budget_bytes("cpu") == 12345.0


def test_resource_exhausted_classifier():
    assert port_solver._is_resource_exhausted(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert port_solver._is_resource_exhausted(RuntimeError("RESOURCE_EXHAUSTED: injected"))
    assert not port_solver._is_resource_exhausted(ValueError("shape mismatch"))


def test_host_overlap_waits_per_item_and_reraises_from_the_failed_one():
    vectors = np.array([[1.0, 1.0]], np.float32)
    counts = np.array([3], np.int32)
    capacity = np.array([[4.0, 4.0]], np.float32)
    matrix = np.array([[1.0]])

    def broken():
        raise KeyError("pool matrix")

    overlap = port_solver._HostOverlap(
        [(vectors, counts, capacity, lambda: matrix), (vectors, counts, capacity, broken),
         (vectors, counts, capacity, matrix)]
    ).start()
    overlap.wait(0)
    assert overlap.pool_prices[0] is matrix
    for index in (1, 2):
        with pytest.raises(KeyError):
            overlap.wait(index)
    with pytest.raises(KeyError):
        overlap.join()
