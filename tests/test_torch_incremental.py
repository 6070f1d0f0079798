"""The port's incremental encode against the JAX reference, on the CPU.

K8's plain versions (the masked scatter and the fill-0 gather of
ops/incremental.py) are held bit for bit to the reference's jitted
`_scatter_rows`, `_scatter_vals` and `_gather_rows` on the same seeded
inputs, sentinels and bool included. One event sequence runs through both
packages' `Cluster` and `DeviceClusterState`: the slot mirrors, the sorted
views and the device arrays must be equal, and epoch, generation and
tombstone density the same. Then the reference's own tests of the layer
(tests/test_incremental_encode.py) run on the port.
"""

import zlib

import numpy as np
import pytest
import torch

from karpenter_tpu.api import pods as ref_pods
from karpenter_tpu import cloudprovider as ref_cloud
from karpenter_tpu.controllers import cluster as ref_cluster
from karpenter_tpu.models import cluster_state as ref_state
from karpenter_tpu.ops import incremental as ref_inc
from karpenter_tpu_torch.api.pods import PodSpec
from karpenter_tpu_torch.api.provisioner import Constraints
from karpenter_tpu_torch.cloudprovider import InstanceType, NodeSpec, Offering
from karpenter_tpu_torch.controllers.cluster import Cluster
from karpenter_tpu_torch.models import cluster_state as port_state
from karpenter_tpu_torch.models import solver as port_solver
from karpenter_tpu_torch.models.cluster_state import (
    ENCODE_REBUILDS_TOTAL,
    DeviceClusterState,
    DevicePodGroups,
    StaleEncodingError,
)
from karpenter_tpu_torch.ops import incremental as port_inc
from karpenter_tpu_torch.ops.encode import build_fleet, group_pods
from karpenter_tpu_torch.utils import crashpoints
from karpenter_tpu_torch.utils.crashpoints import SimulatedCrash

torch.set_num_threads(2)


# --- K8: the plain scatter and gather against the reference ---------------------


def _k8_array(rng, kind, rows):
    if kind == "f32":
        return rng.uniform(-1e3, 1e3, (rows, 8)).astype(np.float32)
    if kind == "i32":
        return rng.integers(-(2**31), 2**31 - 1, rows, dtype=np.int64).astype(np.int32)
    return rng.random(rows) < 0.5


# (name, how many real indices) over a 64-row array.
SCATTER_CASES = [("delta", 13), ("one", 1), ("sentinels_only", 0), ("full", 64)]


@pytest.mark.parametrize("kind", ["f32", "i32", "bool"])
@pytest.mark.parametrize("name,count", SCATTER_CASES, ids=[c[0] for c in SCATTER_CASES])
def test_plain_scatter_equals_reference(kind, name, count):
    rng = np.random.default_rng(zlib.crc32(f"scatter-{kind}-{name}".encode()))
    rows = 64
    dst = _k8_array(rng, kind, rows)
    real = np.sort(rng.choice(rows, count, replace=False)).astype(np.int32)
    idx = port_inc.pad_indices(real, rows)
    np.testing.assert_array_equal(idx, ref_inc.pad_indices(real, rows))
    values = _k8_array(rng, kind, len(idx))  # the padded lanes carry junk: dropped
    scatter = ref_inc._scatter_rows if kind == "f32" else ref_inc._scatter_vals
    want = np.asarray(scatter(dst, idx, values))
    before = dst.copy()
    got = port_inc.scatter(torch.from_numpy(dst), torch.from_numpy(idx), torch.from_numpy(values))
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(dst, before)  # functional: dst untouched


# (name, live slots gathered) out of 40 rows; the sentinel pads to the bucket.
GATHER_CASES = [("view", 23), ("one", 1), ("empty", 0), ("all", 40)]


@pytest.mark.parametrize("kind", ["f32", "i32", "bool"])
@pytest.mark.parametrize("name,count", GATHER_CASES, ids=[c[0] for c in GATHER_CASES])
def test_plain_gather_equals_reference(kind, name, count):
    rng = np.random.default_rng(zlib.crc32(f"gather-{kind}-{name}".encode()))
    rows = 40
    src = _k8_array(rng, kind, rows)
    live = rng.permutation(rows)[:count].astype(np.int32)
    for perm in (port_inc.pad_indices(live, rows), live):  # padded, and the raw (maybe empty) one
        want = np.asarray(ref_inc._gather_rows(src, perm))
        got = port_inc.gather(torch.from_numpy(src), torch.from_numpy(perm))
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), want)


def test_k8_wrappers_route_cpu_tensors_to_the_plain_versions():
    dst = torch.zeros((16, 8))
    idx = torch.from_numpy(port_inc.pad_indices(np.array([3], np.int32), 16))
    before = (port_inc.scatter.launches, port_inc.gather.launches)
    out = port_inc.scatter(dst, idx, torch.ones((len(idx), 8)))
    port_inc.gather(out, idx)
    assert (port_inc.scatter.launches, port_inc.gather.launches) == before
    assert out[3].eq(1).all() and out.sum() == 8 and dst.sum() == 0


def test_k8_rejects_bad_arguments():
    idx = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        port_inc.scatter(torch.zeros((16, 8), dtype=torch.float64), idx, torch.zeros((8, 8)))
    with pytest.raises(TypeError):
        port_inc.gather(torch.zeros((16, 8)), idx.to(torch.int64))
    with pytest.raises(ValueError):
        port_inc.scatter(torch.zeros((16, 8)), idx, torch.zeros((4, 8)))


# --- one event sequence through both packages --------------------------------------


def _drive(pods_mod, cloud_mod, cluster_mod, state_mod, **state_kwargs):
    """A seeded churn of pending pods, nodes, binds, deletes and
    displacements; returns a snapshot of the state every few steps."""
    rng = np.random.default_rng(17)
    cluster = cluster_mod.Cluster()
    state = state_mod.DeviceClusterState(cluster, compaction_threshold=0.5, **state_kwargs)
    shapes = [(250 * (k + 1), 256 * (1 + k % 5)) for k in range(30)]
    pods = {}
    nodes = []
    snapshots = []
    serial = 0
    node_serial = 0
    for step in range(60):
        for _ in range(int(rng.integers(1, 6))):
            cpu, mem = shapes[int(rng.integers(0, len(shapes) if step < 30 else 6))]
            name = f"p{serial}"
            serial += 1
            pods[name] = pods_mod.PodSpec(
                name=name, requests={"cpu": f"{cpu}m", "memory": f"{mem}Mi"}, unschedulable=True
            )
            cluster.apply_pod(pods[name])
        if step % 4 == 0:
            node = cloud_mod.NodeSpec(
                name=f"n{node_serial}", capacity={"cpu": 64.0, "memory": 262144.0}
            )
            node_serial += 1
            cluster.create_node(node)
            nodes.append(node)
        live = sorted(pods)
        for name in rng.choice(live, min(len(live), int(rng.integers(0, 4))), replace=False):
            pod = cluster.try_get_pod("default", name)
            if pod is not None and not pod.node_name and nodes:
                cluster.bind_pod(pod, nodes[int(rng.integers(0, len(nodes)))])
        for name in rng.choice(live, min(len(live), int(rng.integers(0, 3 if step < 30 else 8))), replace=False):
            cluster.delete_pod("default", name)
            pods.pop(name)
        if step % 9 == 5 and pods:
            name = sorted(pods)[int(rng.integers(0, len(pods)))]
            if cluster.try_get_pod("default", name).node_name:
                cluster.reschedule_pod("default", name, override_pdb=True)
        if step % 13 == 12 and len(nodes) > 1:
            gone = nodes.pop(int(rng.integers(0, len(nodes))))
            for pod in cluster.list_pods(node_name=gone.name):
                cluster.delete_pod(pod.namespace, pod.name)
                pods.pop(pod.name, None)
            cluster.delete_node(gone.name)
        if step % 3 == 2:
            snapshots.append(_snapshot(state))
    return snapshots


def _numpy(array):
    return array.numpy() if isinstance(array, torch.Tensor) else np.asarray(array)


def _snapshot(state):
    view = state.pending_groups()
    epoch, dev = state.device_view()
    with state._lock:
        mirrors = {
            name: getattr(state, name).copy()
            for name in ("_group_vectors", "_group_counts", "_group_live", "_node_capacity",
                         "_node_used", "_node_live")
        }
        mirrors["high"] = (state._group_high, state._node_high)
        mirrors["slots"] = (dict(state._group_slot), dict(state._node_slot))
    return {
        "vectors": view.vectors.copy(),
        "counts": view.counts.copy(),
        "members": [sorted(pod.name for pod in group) for group in view.members],
        "device_vectors": _numpy(view.device_vectors),
        "device_counts": _numpy(view.device_counts),
        "dev": {name: _numpy(array) for name, array in dev.items()},
        "mirrors": mirrors,
        "tags": (epoch, view.epoch, view.generation, state.generation, state.tombstone_density(),
                 state.compaction_count, state.rebuild_count, state.pending_count()),
    }


def test_state_follows_the_reference_event_for_event():
    want = _drive(ref_pods, ref_cloud, ref_cluster, ref_state)
    got = _drive(__import__("karpenter_tpu_torch.api.pods", fromlist=["x"]),
                 __import__("karpenter_tpu_torch.cloudprovider", fromlist=["x"]),
                 __import__("karpenter_tpu_torch.controllers.cluster", fromlist=["x"]),
                 port_state, device="cpu")
    assert len(got) == len(want) == 20
    assert any(snap["tags"][5] > 0 for snap in got), "the sequence never compacted"
    for step, (mine, theirs) in enumerate(zip(got, want)):
        assert mine["tags"] == theirs["tags"], step
        assert mine["members"] == theirs["members"], step
        for name in ("vectors", "counts", "device_vectors", "device_counts"):
            assert mine[name].dtype == theirs[name].dtype, (step, name)
            np.testing.assert_array_equal(mine[name], theirs[name], err_msg=f"{step} {name}")
        assert mine["dev"].keys() == theirs["dev"].keys()
        for name in mine["dev"]:
            np.testing.assert_array_equal(mine["dev"][name], theirs["dev"][name], err_msg=f"{step} {name}")
        for name, value in mine["mirrors"].items():
            if isinstance(value, np.ndarray):
                np.testing.assert_array_equal(value, theirs["mirrors"][name], err_msg=f"{step} {name}")
            else:
                assert value == theirs["mirrors"][name], (step, name)


def test_held_device_view_survives_a_flush():
    """A flush writes a new generation: arrays a consumer holds from
    device_view() keep their contents."""
    cluster = Cluster()
    state = DeviceClusterState(cluster, device="cpu")
    node = NodeSpec(name="n0", capacity={"cpu": 8.0, "memory": 8192.0})
    cluster.create_node(node)
    pods = [_pod(f"p{i}", cpu=f"{250 * (i % 3 + 1)}m") for i in range(9)]
    for pod in pods:
        cluster.apply_pod(pod)
    state.flush()
    _, held = state.device_view()
    kept = {name: array.clone() for name, array in held.items()}
    cluster.delete_pod("default", "p0")
    cluster.apply_pod(_pod("p9", cpu="3000m"))
    cluster.bind_pod(pods[1], node)
    state.flush()
    _, fresh = state.device_view()
    assert any(not torch.equal(fresh[name], kept[name]) for name in kept)
    for name, array in held.items():
        assert torch.equal(array, kept[name]), name


def test_state_raises_without_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the refusal path needs none")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceClusterState(Cluster())
    assert DeviceClusterState(Cluster(), device="cpu").device.type == "cpu"


# --- the reference's tests of the layer, on the port ---------------------------------


def _pod(name, cpu="500m", memory="512Mi", **kwargs):
    return PodSpec(
        name=name,
        requests={"cpu": cpu, "memory": memory},
        unschedulable=True,
        **kwargs,
    )


def _state(cluster, **kwargs):
    return DeviceClusterState(cluster, device="cpu", **kwargs)


def _pending_snapshot(cluster):
    return group_pods([p for p in cluster.list_pods() if p.is_provisionable()])


def _assert_parity(state, cluster):
    """Delta-maintained tensors must be BIT-IDENTICAL to the snapshot
    encode, members equal as sets."""
    got = state.pending_groups()
    want = _pending_snapshot(cluster)
    assert np.array_equal(got.vectors, want.vectors)
    assert np.array_equal(got.counts, want.counts)
    assert got.vectors.dtype == want.vectors.dtype
    assert got.counts.dtype == want.counts.dtype
    # Device copies decode to the same tensors (padding rows are zeros).
    dev_vec = got.device_vectors.numpy()
    dev_cnt = got.device_counts.numpy()
    assert np.array_equal(dev_vec[: got.num_groups], want.vectors)
    assert np.array_equal(dev_cnt[: got.num_groups], want.counts)
    assert not dev_vec[got.num_groups :].any() and not dev_cnt[got.num_groups :].any()
    for g in range(got.num_groups):
        assert {p.uid for p in got.members[g]} == {p.uid for p in want.members[g]}
    return got


def _catalog():
    return [
        InstanceType(
            name=f"m.{size}x",
            capacity={"cpu": 2 * size, "memory": f"{8 * size}Gi", "pods": 110},
            offerings=[Offering(zone=zone, price=0.1 * size) for zone in ("z-1a", "z-1b")],
        )
        for size in (1, 2, 4, 8, 16)
    ]


class TestSlotAllocator:
    def test_free_list_reuse_after_delete(self):
        cluster = Cluster()
        state = _state(cluster)
        a = [_pod(f"a{i}", cpu="250m") for i in range(3)]
        b = [_pod(f"b{i}", cpu="750m") for i in range(3)]
        for p in a + b:
            cluster.apply_pod(p)
        state.flush()
        with state._lock:
            high_before = state._group_high
        for p in b:
            cluster.delete_pod(p.namespace, p.name)
        with state._lock:
            assert len(state._group_free) == 1
            freed = state._group_free[0]
            assert not state._group_live[freed]
        cluster.apply_pod(_pod("c0", cpu="1250m"))
        with state._lock:
            assert state._group_free == []
            assert state._group_live[freed]
            assert state._group_high == high_before
        _assert_parity(state, cluster)

    def test_node_slot_free_list(self):
        cluster = Cluster()
        state = _state(cluster)
        for i in range(3):
            cluster.create_node(NodeSpec(name=f"n{i}", capacity={"cpu": 8.0, "memory": 8192.0}))
        cluster.delete_node("n1")
        with state._lock:
            assert len(state._node_free) == 1
        cluster.create_node(NodeSpec(name="n9", capacity={"cpu": 4.0, "memory": 4096.0}))
        with state._lock:
            assert state._node_free == []
            assert state._node_high == 3

    def test_pod_reapply_with_changed_requests_moves_groups(self):
        cluster = Cluster()
        state = _state(cluster)
        pod = _pod("p0", cpu="250m")
        cluster.apply_pod(pod)
        state.flush()
        changed = _pod("p0", cpu="1000m")
        changed.uid = pod.uid
        cluster.apply_pod(changed)
        got = _assert_parity(state, cluster)
        assert got.num_pods == 1


class TestCompaction:
    def _churn(self, cluster, state, shapes=24, keep=4):
        pods = {}
        for i in range(shapes):
            p = _pod(f"s{i}", cpu=f"{250 * (i + 1)}m")
            pods[i] = p
            cluster.apply_pod(p)
        state.flush()
        for i in range(shapes):
            if i >= keep:
                cluster.delete_pod(pods[i].namespace, pods[i].name)
        return pods

    def test_threshold_compaction_parity_vs_full_reencode(self):
        cluster = Cluster()
        state = _state(cluster, compaction_threshold=0.5)
        self._churn(cluster, state)
        with state._lock:
            density = state._density_locked(state._group_high, state._group_live)
        assert density >= 0.5
        epoch_before = state.epoch
        got = _assert_parity(state, cluster)
        assert state.compaction_count >= 1
        assert state.epoch > epoch_before
        assert got.num_groups == 4
        with state._lock:
            assert state._group_high == 4
            assert state._group_free == []
        cluster.apply_pod(_pod("post", cpu="9000m"))
        _assert_parity(state, cluster)

    def test_threshold_one_disables_compaction(self):
        cluster = Cluster()
        state = _state(cluster, compaction_threshold=1.0)
        self._churn(cluster, state)
        _assert_parity(state, cluster)
        assert state.compaction_count == 0

    def test_tombstone_density_reported(self):
        cluster = Cluster()
        state = _state(cluster, compaction_threshold=1.0)
        self._churn(cluster, state, shapes=20, keep=10)
        state.flush()
        group_density, _ = state.tombstone_density()
        assert group_density == pytest.approx(0.5)


class TestEpochProtocol:
    def test_epoch_mismatch_detected_and_rebuilt(self):
        cluster = Cluster()
        state = _state(cluster, compaction_threshold=0.5)
        for i in range(24):
            cluster.apply_pod(_pod(f"s{i}", cpu=f"{250 * (i + 1)}m"))
        handle = state.pending_groups()
        assert state.is_current(handle)
        for i in range(4, 24):
            cluster.delete_pod("default", f"s{i}")
        fresh = state.pending_groups()
        assert state.compaction_count >= 1
        assert not state.is_current(handle)
        with pytest.raises(StaleEncodingError):
            state.assert_current(handle)
        assert state.is_current(fresh)
        _assert_parity(state, cluster)

    def test_generation_advances_per_flush(self):
        cluster = Cluster()
        state = _state(cluster)
        cluster.apply_pod(_pod("p0"))
        g1 = state.pending_groups()
        cluster.apply_pod(_pod("p1"))
        g2 = state.pending_groups()
        assert g2.generation > g1.generation
        assert not state.is_current(g1)
        assert state.is_current(g2)


class TestMidApplyBattletest:
    """Kill the sync at encode.mid-apply: the torn state detects itself and
    rebuilds from the snapshot path; a 'restarted' state (a fresh object
    over the surviving cluster) is bit-identical to the snapshot encode."""

    @pytest.fixture(autouse=True)
    def _disarm(self):
        yield
        crashpoints.disarm_all()

    def _crashed_cluster(self):
        cluster = Cluster()
        state = _state(cluster)
        for i in range(10):
            cluster.apply_pod(_pod(f"p{i}", cpu=f"{250 * (i % 3 + 1)}m"))
        state.flush()
        crashpoints.arm("encode.mid-apply")
        with pytest.raises(SimulatedCrash):
            cluster.apply_pod(_pod("victim", cpu="2000m"))
        return cluster, state

    def test_torn_state_self_heals_via_snapshot_rebuild(self):
        cluster, state = self._crashed_cluster()
        with state._lock:
            assert state._torn is not None
        rebuilds_before = state.rebuild_count
        _assert_parity(state, cluster)
        assert state.rebuild_count == rebuilds_before + 1
        with state._lock:
            assert state._torn is None

    def test_restart_rebuilds_bit_identical_to_snapshot(self):
        cluster, _dead = self._crashed_cluster()
        reborn = _state(cluster)
        _assert_parity(reborn, cluster)
        assert reborn.rebuild_count == 1

    def test_store_survives_the_crash(self):
        cluster, _state_ = self._crashed_cluster()
        assert cluster.try_get_pod("default", "victim") is not None


class TestSolverFastPath:
    def _encoded(self, num_pods=30):
        cluster = Cluster()
        state = _state(cluster)
        for i in range(num_pods):
            cluster.apply_pod(_pod(f"p{i}", cpu=f"{250 * (i % 4 + 1)}m"))
        pods = [p for p in cluster.list_pods() if p.is_provisionable()]
        constraints = Constraints()
        types = _catalog()
        encoded = state.encode_schedule(pods, types, constraints, [])
        return cluster, state, pods, types, constraints, encoded

    def test_encode_schedule_covers_exact_batch(self):
        _, _, _, _, _, encoded = self._encoded()
        assert encoded is not None
        groups, fleet = encoded
        assert isinstance(groups, DevicePodGroups)
        assert fleet.num_types > 0

    def test_encode_schedule_rejects_partial_batch(self):
        cluster, state, pods, types, constraints, _ = self._encoded()
        assert state.encode_schedule(pods[:-1], types, constraints, []) is None
        foreign = _pod("foreign")
        assert state.encode_schedule(pods[:-1] + [foreign], types, constraints, []) is None

    def test_encode_problems_passes_encoded_pair_through(self):
        _, _, pods, types, constraints, encoded = self._encoded()
        out = port_solver.Solver._encode_problems([encoded, (pods, types, constraints, [])])
        assert out[0][0] is encoded[0]
        assert out[0][1] is encoded[1]
        assert np.array_equal(out[0][0].vectors, out[1][0].vectors)
        assert np.array_equal(out[0][0].counts, out[1][0].counts)

    def test_solve_over_encoded_state_matches_snapshot_solve(self):
        cluster, state, pods, types, constraints, encoded = self._encoded()
        groups, fleet = encoded
        snap_groups = group_pods(pods)
        snap_fleet = build_fleet(types, constraints, pods, pods_need=snap_groups.vectors.max(axis=0))
        solver = port_solver.GreedySolver()
        ours = solver.solve_encoded(groups, fleet)
        want = solver.solve_encoded(snap_groups, snap_fleet)
        assert ours.node_count == want.node_count
        assert len(ours.unschedulable) == len(want.unschedulable)

    def test_device_buffers_survive_a_solve(self):
        """No solve kernel writes into its inputs: the handle stays readable
        (and re-solvable) after a cost solve dispatched its device arrays."""
        cluster, state, pods, types, constraints, encoded = self._encoded()
        groups, fleet = encoded
        kept = (groups.device_vectors.clone(), groups.device_counts.clone())
        first = port_solver.cost_solve_dispatch(
            groups.device_vectors, groups.device_counts, fleet.capacity, fleet.total,
            fleet.prices, lp_steps=10, device="cpu",
        )
        plan = port_solver.fetch_plan(first)
        assert torch.equal(groups.device_vectors, kept[0])
        assert torch.equal(groups.device_counts, kept[1])
        assert np.array_equal(groups.device_vectors.numpy()[: groups.num_groups], groups.vectors)
        again = port_solver.fetch_plan(port_solver.cost_solve_dispatch(
            groups.device_vectors, groups.device_counts, fleet.capacity, fleet.total,
            fleet.prices, lp_steps=10, device="cpu",
        ))
        np.testing.assert_array_equal(again.rounds_cost.round_fill, plan.rounds_cost.round_fill)

    def test_fleet_cache_hits_and_invalidates(self):
        import dataclasses

        cluster, state, pods, types, constraints, encoded = self._encoded()
        need = encoded[0].vectors.max(axis=0)
        first = state.encode_fleet(types, constraints, [], need)
        assert state.encode_fleet(types, constraints, [], need) is first
        types[0].offerings[0] = dataclasses.replace(
            types[0].offerings[0], price=types[0].offerings[0].price + 0.01
        )
        assert state.encode_fleet(types, constraints, [], need) is not first


class TestNodeViews:
    def test_pods_on_node_and_used_track_bind_unbind(self):
        cluster = Cluster()
        state = _state(cluster)
        node = NodeSpec(name="n1", capacity={"cpu": 64.0, "memory": 65536.0})
        cluster.create_node(node)
        pods = [_pod(f"p{i}", cpu="500m", memory="256Mi") for i in range(4)]
        for p in pods:
            cluster.apply_pod(p)
            cluster.bind_pod(p, node)
        assert len(state.pods_on_node("n1")) == 4
        used = state.node_used("n1")
        expect = sum((p.dense_vector[0] for p in pods), np.zeros_like(used)).astype(np.float64)
        assert np.array_equal(used, expect)
        cluster.reschedule_pod(pods[0].namespace, pods[0].name, override_pdb=True)
        assert len(state.pods_on_node("n1")) == 3
        assert state.pending_count() == 1
        pods[1].phase = "Succeeded"
        cluster.apply_pod(pods[1])
        assert len(state.pods_on_node("n1")) == 3
        used = state.node_used("n1")
        assert used is not None and used[0] == pytest.approx(1000.0)

    def test_views_match_cluster_listing(self):
        cluster = Cluster()
        state = _state(cluster)
        node = NodeSpec(name="n1", capacity={"cpu": 8.0, "memory": 8192.0})
        cluster.create_node(node)
        p = _pod("p0")
        cluster.apply_pod(p)
        cluster.bind_pod(p, node)
        assert {q.uid for q in state.pods_on_node("n1")} == {
            q.uid for q in cluster.list_pods(node_name="n1")
        }


def test_rebuild_reasons_counted():
    cluster = Cluster()
    state = _state(cluster)
    before = ENCODE_REBUILDS_TOTAL.get("initial")
    state.flush()
    assert ENCODE_REBUILDS_TOTAL.get("initial") == before + 1
