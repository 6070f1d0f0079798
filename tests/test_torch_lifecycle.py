"""The port's node-lifecycle sweeps (podgc, instancegc, interruption,
health) against the JAX package's, on the CPU.

The reference's own scenarios run twice: once over the JAX package and once
over the port, with the same seeded world (pod uids and node names drawn
from counters reset to one start in both packages). Each scenario's source
(tests/test_interruption.py, tests/test_health.py, TestPodGc of
tests/test_node_lifecycle.py and TestInstanceGc of
tests/test_crash_consistency.py), its fixtures, its kubelet fleet and its
Harness are loaded a second time with every `karpenter_tpu` import pointed
at `karpenter_tpu_torch`, so the port meets the reference's own assertions.
Every Harness a scenario builds records its store's deltas; after the
scenario each one's outcome (the nodes with their annotations, taints and
deletion marks, the pods and the nodes they are bound to, the cloud's
deleted nodes and live instances, and every bind, reschedule and delete in
order) must equal the reference's. A scenario that builds no Harness (the
apiserver's uid precondition on a pod DELETE, over each package's kubeapi
client and fake apiserver) is held to its own assertions on both packages.
"""

import itertools
import sys
from pathlib import Path

import pytest
import torch

from tests import port_twins

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
TESTS = REPO / "tests"
# {reference test file: the classes whose scenarios run on both packages}.
SCENARIOS = {
    "test_interruption.py": ("TestInterruption", "TestInterruptionCrashMatrix"),
    "test_health.py": (
        "TestHealthDetection", "TestStuckDrain", "TestZombieDefense", "TestHealthCrashMatrix",
        "TestKubeletFleet", "TestReadinessRetaint", "TestNodeControllerStaleness",
    ),
    "test_node_lifecycle.py": ("TestPodGc",),
    "test_crash_consistency.py": ("TestInstanceGc",),
}
# The one scenario that builds no Harness: the apiserver's uid precondition on
# a pod DELETE, over each package's kubeapi client and fake apiserver.
NO_HARNESS = "test_apiserver_delete_honors_uid_precondition"


def _load_package(package: str):
    """The scenario modules of one package, twins of the reference's files
    (tests/port_twins.py: their fixtures, kubelet fleet, Harness and fake
    apiserver twins too); its Harness records every instance in
    `harness.CREATED` and every store delta in `h.deltas`."""
    twins = port_twins.TwinPackage(package, "lifecycle")
    modules = {"harness": twins.module("harness")}
    _record_harnesses(modules["harness"])
    for name in SCENARIOS:
        modules[name[:-3]] = twins.module(name[:-3])
    return modules


def _record_harnesses(module) -> None:
    module.CREATED = []
    init = module.Harness.__init__

    def recording_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.deltas = []
        self.cluster.watch_deltas(
            lambda verb, kind, obj: self.deltas.append((verb, kind, getattr(obj, "name", None))))
        module.CREATED.append(self)

    module.Harness.__init__ = recording_init


PACKAGES = {name: _load_package(name) for name in ("reference", "port")}


def _cases():
    """(file stem, class, method, parameters) of every scenario, the
    parametrised ones expanded from their marks."""
    for file_name, classes in SCENARIOS.items():
        stem = file_name[:-3]
        module = PACKAGES["reference"][stem]
        for class_name in classes:
            cls = getattr(module, class_name)
            for method in sorted(name for name in vars(cls) if name.startswith("test_")):
                marks = [mark for mark in getattr(getattr(cls, method), "pytestmark", [])
                         if mark.name == "parametrize"]
                if not marks:
                    yield pytest.param(stem, class_name, method, {}, id=f"{stem}::{class_name}::{method}")
                    continue
                [mark] = marks
                names = [name.strip() for name in mark.args[0].split(",")]
                ids = mark.kwargs.get("ids")
                for index, values in enumerate(mark.args[1]):
                    values = values if len(names) > 1 else (values,)
                    label = ids[index] if ids else "-".join(map(str, values))
                    yield pytest.param(stem, class_name, method, dict(zip(names, values)),
                                       id=f"{stem}::{class_name}::{method}[{label}]")


CASES = list(_cases())


def _outcome(h):
    nodes = sorted(
        (n.name, n.instance_type, n.zone, n.capacity_type, n.provider_id, bool(n.unschedulable),
         n.deletion_timestamp is not None, tuple(sorted(n.annotations.items())),
         tuple(sorted((t.key, t.value, t.effect) for t in n.taints)))
        for n in h.cluster.list_nodes()
    )
    pods = sorted((p.namespace, p.name, p.uid, p.node_name, p.deletion_timestamp is not None)
                  for p in h.cluster.list_pods())
    return {
        "nodes": nodes,
        "pods": pods,
        "cloud_deleted_nodes": list(h.cloud.deleted_nodes),
        "cloud_instances": sorted(h.cloud.instances),
        "cloud_terminated": list(getattr(h.cloud, "terminated_instances", [])),
        "deltas": [d for d in h.deltas if d[0] in ("bind", "reschedule", "delete", "create")],
        "clock": h.clock.now(),
    }


def _run(package: str, stem: str, class_name: str, method: str, params: dict, monkeypatch):
    modules = PACKAGES[package]
    scenario = modules[stem]
    base = "karpenter_tpu_torch" if package == "port" else "karpenter_tpu"
    pods_module = sys.modules[f"{base}.api.pods"]
    fake_module = sys.modules[f"{base}.cloudprovider.fake"]
    crashpoints = sys.modules[f"{base}.utils.crashpoints"]
    faultpoints = sys.modules[f"{base}.utils.faultpoints"]
    validation = sys.modules[f"{base}.api.validation"]
    monkeypatch.setattr(pods_module, "_uid_counter", itertools.count(1))
    monkeypatch.setattr(fake_module, "_node_counter", itertools.count(1))
    # The provider hooks a registry call left installed (tests of the
    # registry and of main end on the fake's): none, as at import, on both.
    monkeypatch.setattr(validation, "DEFAULT_HOOK", None)
    monkeypatch.setattr(validation, "VALIDATE_HOOK", None)
    crashpoints.disarm_all()
    faultpoints.disarm_all()
    modules["harness"].CREATED.clear()
    try:
        getattr(getattr(scenario, class_name)(), method)(**params)
    finally:
        crashpoints.disarm_all()
        faultpoints.disarm_all()
    return [_outcome(h) for h in modules["harness"].CREATED]


@pytest.fixture(autouse=True)
def _port_state_reset():
    """The port's process-global state: the active PriceBook."""
    from karpenter_tpu_torch.market.pricebook import set_active_book

    set_active_book(None)
    yield
    set_active_book(None)


def test_every_reference_class_contributes_scenarios():
    classes = {(case.values[0], case.values[1]) for case in CASES}
    assert classes == {(name[:-3], cls) for name, group in SCENARIOS.items() for cls in group}
    assert len(CASES) >= 40
    # The apiserver-only case runs too, over each package's own client.
    assert any(case.values[2] == NO_HARNESS for case in CASES)


@pytest.mark.parametrize("stem,class_name,method,params", CASES)
def test_lifecycle_scenario_matches_reference(stem, class_name, method, params, monkeypatch):
    want = _run("reference", stem, class_name, method, params, monkeypatch)
    got = _run("port", stem, class_name, method, params, monkeypatch)
    # Only the apiserver-only case builds no Harness (it passed its own
    # assertions on both packages); every other scenario must have built one.
    assert want or method == NO_HARNESS, "the scenario built no Harness"
    assert len(got) == len(want)
    for index, (port, reference) in enumerate(zip(got, want)):
        for key in reference:
            assert port[key] == reference[key], f"harness {index}: {key} differs"


# --- the four loops in the port's Manager ------------------------------------

LOOPS = ("podgc", "instancegc", "interruption", "health")


def _wait_until(condition, timeout: float = 30.0) -> bool:
    import time

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if condition():
            return True
        time.sleep(0.02)
    return bool(condition())


def _cpu_manager(solver: str = "greedy", **options):
    from karpenter_tpu_torch import runtime
    from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider
    from karpenter_tpu_torch.controllers.cluster import Cluster
    from karpenter_tpu_torch.utils.options import Options

    cluster = Cluster()
    manager = runtime.Manager(
        cluster, FakeCloudProvider(),
        Options(cluster_name="lifecycle", solver=solver, leader_election=False, **options),
        device="cpu",
    )
    return cluster, manager


def test_manager_wires_the_four_loops_as_the_reference():
    """The loops are registered next to the reference's, each sweep
    controller built over the Manager's own store, cloud, provisioning,
    termination, encoder and PriceBook, with the options' timeouts."""
    from karpenter_tpu import runtime as ref_runtime
    from karpenter_tpu.cloudprovider.fake import FakeCloudProvider as RefCloud
    from karpenter_tpu.controllers.cluster import Cluster as RefCluster
    from karpenter_tpu.market.pricebook import set_active_book as ref_set_active_book
    from karpenter_tpu.utils.options import Options as RefOptions

    options = dict(node_unreachable_timeout=77.0, drain_stuck_timeout=333.0,
                   interruption_escalate_fraction=0.25)
    _, manager = _cpu_manager(**options)
    reference = ref_runtime.Manager(
        RefCluster(), RefCloud(),
        RefOptions(cluster_name="lifecycle", solver="greedy", leader_election=False, **options))
    try:
        assert list(manager.loops) == list(reference.loops)
        for name in LOOPS:
            assert manager.loops[name].name == name and manager.loops[name].concurrency == 1
        assert manager.interruption.price_book is manager.price_book
        assert manager.interruption.cluster_state is manager.cluster_state
        assert manager.interruption.escalate_fraction == 0.25
        assert manager.interruption.provisioning is manager.provisioning
        assert manager.interruption.termination is manager.termination
        assert manager.health.unreachable_timeout == 77.0
        assert manager.health.drain_stuck_timeout == 333.0
        assert manager.health.cluster_state is manager.cluster_state
        assert manager.podgc.cluster is manager.cluster
        assert manager.instancegc.cloud is manager.cloud
    finally:
        ref_set_active_book(None)


def test_start_seeds_the_four_sweeps():
    from karpenter_tpu_torch.runtime import RECONCILE_TOTAL

    def swept(name):
        return sum(RECONCILE_TOTAL.get(name, result) for result in ("success", "requeue", "error"))

    before = {name: swept(name) for name in LOOPS}
    _, manager = _cpu_manager()
    try:
        manager.start()
        assert _wait_until(lambda: all(swept(name) > before[name] for name in LOOPS)), (
            {name: swept(name) - before[name] for name in LOOPS})
    finally:
        manager.stop()


def test_spot_interruption_is_drained_and_replaced_through_the_cost_solve(monkeypatch):
    """A spot reclaim injected through the fake cloud, with nothing but the
    threaded loops: the node is cordoned, drained and deleted, every pod on
    it is bound again elsewhere by a replacement solve through the port's
    CostSolver on the CPU (the device route, its kernels' plain versions),
    and the reclaimed pool is noted in the Manager's PriceBook."""
    from karpenter_tpu_torch.api.pods import PodSpec
    from karpenter_tpu_torch.api.provisioner import Provisioner, ProvisionerSpec
    from karpenter_tpu_torch.models import solver

    monkeypatch.setenv("KARPENTER_HOST_SOLVE", "0")
    monkeypatch.setenv("KARPENTER_WARMUP_SHAPES", "8x8")
    cluster, manager = _cpu_manager("cost")
    binds = []
    cluster.watch_deltas(lambda verb, kind, obj: binds.append((obj.uid, obj.node_name))
                         if kind == "pod" and verb == "bind" else None)
    try:
        manager.start()
        assert _wait_until(manager.ready.is_set)
        cluster.apply_provisioner(Provisioner(name="default", spec=ProvisionerSpec()))
        assert _wait_until(lambda: manager.provisioning.worker("default") is not None)
        pods = [PodSpec(name=f"reclaim-{i}", requests={"cpu": "1"}, unschedulable=True) for i in range(6)]
        for pod in pods:
            cluster.apply_pod(pod)
        assert _wait_until(lambda: all(cluster.get_pod(p.namespace, p.name).node_name for p in pods))
        victim = cluster.get_node(cluster.get_pod(pods[0].namespace, pods[0].name).node_name)
        pool = (victim.instance_type, victim.zone)
        displaced = [p for p in pods if cluster.get_pod(p.namespace, p.name).node_name == victim.name]
        device_before = solver.SOLVE_DISPATCH_TOTAL.get("device")
        host_before = solver.SOLVE_DISPATCH_TOTAL.get("host")
        risk_before = manager.price_book.pool_risk(pool)
        manager.cloud.inject_interruption(victim, deadline_in=120.0)

        def replaced():
            return cluster.try_get_node(victim.name) is None and all(
                cluster.get_pod(p.namespace, p.name).node_name not in (None, victim.name) for p in pods)

        assert _wait_until(replaced), "the interruption was not drained and replaced by the loops"
        assert manager.cloud.poll_interruptions() == []
        assert victim.name in manager.cloud.deleted_nodes
        for pod in displaced:
            history = [node for uid, node in binds if uid == pod.uid]
            assert history[0] == victim.name and len(history) == 2 and history[1] != victim.name
        assert solver.SOLVE_DISPATCH_TOTAL.get("device") > device_before
        assert solver.SOLVE_DISPATCH_TOTAL.get("host") == host_before
        assert manager.price_book.pool_risk(pool) > risk_before
    finally:
        manager.stop()
