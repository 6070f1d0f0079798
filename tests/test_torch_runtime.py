"""The port's controller process against the JAX package's, on the CPU.

The reconcile loops and leader election run the reference's own cases
(tests/test_runtime.py) on both packages; the boot warmup's cases run on a
CPU Manager (device="cpu"), the ladder stubbed where the reference stubs
it; the HTTP endpoints and `cmd/controller.main` run end to end; the
break-even calibration, the host gate and the synthetic warmup problem are
held to the reference's on the same inputs. Every wait is bounded by 30 s
and every Manager is stopped in `finally`.
"""

import json
import threading
import time
import urllib.error
import urllib.request
from collections import Counter

import numpy as np
import pytest
import torch

from karpenter_tpu import runtime as ref_runtime
from karpenter_tpu.controllers.cluster import Cluster as RefCluster
from karpenter_tpu.models import solver as ref_solver
from karpenter_tpu.models import warmup as ref_warmup
from karpenter_tpu.utils.clock import FakeClock as RefFakeClock
from karpenter_tpu_torch import runtime as port_runtime
from karpenter_tpu_torch.api.pods import PodSpec
from karpenter_tpu_torch.api.provisioner import Provisioner, ProvisionerSpec
from karpenter_tpu_torch.cloudprovider import registry
from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider
from karpenter_tpu_torch.cmd import controller
from karpenter_tpu_torch.controllers.cluster import Cluster
from karpenter_tpu_torch.market import pricebook as port_pricebook
from karpenter_tpu_torch.models import solver as port_solver
from karpenter_tpu_torch.models import warmup as port_warmup
from karpenter_tpu_torch.utils import backend_health
from karpenter_tpu_torch.utils.clock import FakeClock
from karpenter_tpu_torch.utils.options import Options

torch.set_num_threads(2)

WAIT_S = 30.0
RUNTIMES = {"reference": ref_runtime, "port": port_runtime}


@pytest.fixture(autouse=True)
def _fresh_process_state():
    """The Manager makes its PriceBook the process's active one; the
    calibration and the warming preference are process-global too."""
    port_pricebook.set_active_book(None)
    port_solver.reset_break_even()
    yield
    port_pricebook.set_active_book(None)
    port_solver.reset_break_even()
    while port_solver._WARMING_HOST_PREFERENCE.is_set():
        port_solver.set_warming_host_preference(False)


def wait_until(condition, timeout=WAIT_S, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if condition():
            return True
        time.sleep(interval)
    return bool(condition())


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as response:
            return response.status, response.read()
    except urllib.error.HTTPError as error:
        return error.code, error.read()


# --- ReconcileLoop: tests/test_runtime.py TestReconcileLoop, TestWakeCoalescing


@pytest.mark.parametrize("package", sorted(RUNTIMES))
def test_immediate_enqueue_pulls_key_out_of_backoff(package):
    seen = []
    loop = RUNTIMES[package].ReconcileLoop("test", lambda key: seen.append(key) and None)
    loop.start()
    try:
        loop.enqueue("pod-a", delay=600.0)
        loop.enqueue("pod-a", delay=0.0)
        assert wait_until(lambda: seen, 5.0)
        assert seen == ["pod-a"], "immediate enqueue was swallowed by backoff"
        time.sleep(0.2)
        assert seen == ["pod-a"]
    finally:
        loop.stop()


@pytest.mark.parametrize("package", sorted(RUNTIMES))
def test_duplicate_immediate_enqueues_still_collapse(package):
    gate = threading.Event()
    seen = []
    loop = RUNTIMES[package].ReconcileLoop("test", lambda key: (gate.wait(5), seen.append(key), None)[-1])
    loop.start()
    try:
        loop.enqueue("k", delay=0.05)
        loop.enqueue("k", delay=0.0)
        loop.enqueue("k", delay=0.0)
        gate.set()
        time.sleep(0.3)
        assert len(seen) == 1
    finally:
        loop.stop()


@pytest.mark.parametrize("package", sorted(RUNTIMES))
def test_enqueue_while_all_workers_busy_does_not_lose_the_wake(package):
    gate = threading.Event()
    seen = []

    def reconcile(key):
        seen.append(key)
        if key == "slow":
            gate.wait(timeout=10.0)
        return None

    loop = RUNTIMES[package].ReconcileLoop("coalesce", reconcile, concurrency=2, chunk=64)
    loop.start()
    try:
        loop.enqueue("slow")
        loop.enqueue(("busy", 1), delay=0.0)
        assert wait_until(lambda: len(seen) >= 1, 5.0)
        for i in range(5):
            loop.enqueue(("storm", i))
        gate.set()
        assert wait_until(lambda: sum(1 for k in seen if k[0] == "storm") == 5, 5.0), seen
        loop.enqueue(("after-idle", 0))
        assert wait_until(lambda: ("after-idle", 0) in seen, 5.0), "the wake after idle was lost"
    finally:
        gate.set()
        loop.stop()


@pytest.mark.parametrize("package", sorted(RUNTIMES))
def test_enqueue_many_pulls_delayed_keys_forward(package):
    seen = []
    loop = RUNTIMES[package].ReconcileLoop("many", lambda k: seen.append(k) and None, concurrency=1, chunk=8)
    loop.start()
    try:
        loop.enqueue("parked", delay=60.0)
        loop.enqueue_many([("parked", 0.0), ("fresh", 0.0)])
        assert wait_until(lambda: "parked" in seen and "fresh" in seen, 5.0), seen
        loop.enqueue("slow", delay=60.0)
        loop.enqueue_many([("slow", 120.0)])
        with loop._cv:
            assert loop._due["slow"] < time.monotonic() + 61
    finally:
        loop.stop()


@pytest.mark.parametrize("package", sorted(RUNTIMES))
def test_failing_reconcile_backs_off_and_counts(package):
    """A reconcile that raises keeps its loop alive, requeues the key after
    the error backoff and counts the failure by class; forget() drops the
    streak."""
    runtime = RUNTIMES[package]
    calls = []

    def reconcile(key):
        calls.append(key)
        raise ValueError("boom")

    before = runtime.SWEEP_FAILURES_TOTAL.get("failing", "ValueError")
    loop = runtime.ReconcileLoop("failing", reconcile)
    loop.start()
    try:
        loop.enqueue("k")
        assert wait_until(lambda: runtime.SWEEP_FAILURES_TOTAL.get("failing", "ValueError") > before, 5.0)
        assert loop.err_streak_size() == 1
        with loop._cv:
            assert loop._due["k"] > time.monotonic() + 0.5  # backed off, not hot-looping
        loop.forget("k")
        assert loop.err_streak_size() == 0
        assert calls == ["k"]
    finally:
        loop.stop()


# --- LeaderElector: tests/test_runtime.py TestLeaderElection ----------------


def _lease_world(package):
    if package == "reference":
        clock = RefFakeClock()
        return RefCluster(clock=clock), clock
    clock = FakeClock()
    return Cluster(clock=clock), clock


@pytest.mark.parametrize("package", sorted(RUNTIMES))
def test_leader_single_winner(package):
    cluster, _ = _lease_world(package)
    elector = RUNTIMES[package].LeaderElector
    a, b = elector(cluster, "a"), elector(cluster, "b")
    assert a.try_acquire()
    assert not b.try_acquire()
    assert a.is_leader.is_set() and not b.is_leader.is_set()
    assert a.generation == 1


@pytest.mark.parametrize("package", sorted(RUNTIMES))
def test_leader_renewal_keeps_leadership(package):
    cluster, clock = _lease_world(package)
    elector = RUNTIMES[package].LeaderElector
    a, b = elector(cluster, "a"), elector(cluster, "b")
    assert a.try_acquire()
    clock.advance(elector.LEASE_SECONDS - 1)
    assert a.try_acquire()
    clock.advance(elector.LEASE_SECONDS - 1)
    assert not b.try_acquire()


@pytest.mark.parametrize("package", sorted(RUNTIMES))
def test_leader_expired_lease_hands_over(package):
    cluster, clock = _lease_world(package)
    elector = RUNTIMES[package].LeaderElector
    a, b = elector(cluster, "a"), elector(cluster, "b")
    assert a.try_acquire()
    clock.advance(elector.LEASE_SECONDS + 1)
    assert b.try_acquire()
    assert b.generation == 2
    assert not cluster.acquire_lease(elector.LEASE_NAME, "a", elector.LEASE_SECONDS)


@pytest.mark.parametrize("package", sorted(RUNTIMES))
def test_leader_release_allows_immediate_takeover(package):
    cluster, _ = _lease_world(package)
    elector = RUNTIMES[package].LeaderElector
    a, b = elector(cluster, "a"), elector(cluster, "b")
    assert a.try_acquire()
    a.release()
    assert b.try_acquire()


@pytest.mark.parametrize("package", sorted(RUNTIMES))
def test_leader_lost_lease_fires_callback(package):
    cluster, clock = _lease_world(package)
    elector = RUNTIMES[package].LeaderElector
    lost = []
    a = elector(cluster, "a", on_lost=lambda: lost.append(True))
    assert a.try_acquire()
    clock.advance(elector.LEASE_SECONDS + 1)
    assert elector(cluster, "b").try_acquire()
    assert not a._renew_once()
    assert not a.is_leader.is_set()
    assert lost == [True]


@pytest.mark.parametrize("package", sorted(RUNTIMES))
def test_leader_missed_renew_deadline_fences_without_cas(package):
    cluster, clock = _lease_world(package)
    elector = RUNTIMES[package].LeaderElector
    lost = []
    a = elector(cluster, "a", on_lost=lambda: lost.append("a"))
    b = elector(cluster, "b")
    assert a.try_acquire()
    clock.advance(elector.LEASE_SECONDS + 1)
    assert b.try_acquire()
    assert a._renew_once() is False
    assert lost == ["a"]
    assert not a.is_leader.is_set()
    holder = cluster.get_lease(elector.LEASE_NAME)
    assert holder and holder[0] == "b"


@pytest.mark.parametrize("package", sorted(RUNTIMES))
def test_leader_missed_renew_deadline_fences_even_without_rival(package):
    cluster, clock = _lease_world(package)
    elector = RUNTIMES[package].LeaderElector
    lost = []
    a = elector(cluster, "a", on_lost=lambda: lost.append("a"))
    assert a.try_acquire()
    clock.advance(elector.LEASE_SECONDS + 1)
    assert a._renew_once() is False
    assert lost == ["a"]


def test_leader_lock_lies_in_the_temporary_directory(tmp_path, monkeypatch):
    """The file lock excludes a second holder and lives under TMPDIR."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    first, second = port_runtime.LeaderLock(), port_runtime.LeaderLock()
    assert first.path.startswith(str(tmp_path))
    try:
        assert first.acquire(blocking=False)
        assert not second.acquire(blocking=False)
        first.release()
        assert second.acquire(blocking=False)
    finally:
        first.release()
        second.release()


# --- boot warmup: tests/test_runtime.py TestBootWarmup on a CPU Manager -----


def _cpu_manager(solver):
    cluster = Cluster()
    return cluster, port_runtime.Manager(
        cluster, FakeCloudProvider(),
        Options(cluster_name="warm", solver=solver, leader_election=False), device="cpu",
    )


def _slow_compile(compiling, release):
    def slow_compile(shapes, device=None):
        compiling.set()
        assert release.wait(timeout=WAIT_S)

    return slow_compile


def test_host_solver_manager_is_ready_immediately():
    _, mgr = _cpu_manager("greedy")
    try:
        mgr.start()
        assert mgr.ready.is_set() and mgr.warm.is_set()
    finally:
        mgr.stop()


def test_cost_manager_gates_readyz_and_serves_host_side_while_warming(monkeypatch):
    """While the ladder warms: not ready, the warming host preference routes
    solves host-side (counted on solver_dispatch_total{host}), and a batch
    closing mid-warmup still provisions; then ready."""
    assert port_solver.CostSolver(device="cpu").host_fallback_available()
    release, compiling = threading.Event(), threading.Event()
    monkeypatch.setattr(port_warmup, "_compile_shapes", _slow_compile(compiling, release))
    cluster, mgr = _cpu_manager("cost")
    host_before = port_solver.SOLVE_DISPATCH_TOTAL.get("host")
    try:
        mgr.start()
        assert compiling.wait(timeout=WAIT_S)
        assert not mgr.ready.is_set() and not mgr.warm.is_set()
        assert port_solver._WARMING_HOST_PREFERENCE.is_set()
        cluster.apply_provisioner(Provisioner(name="warm"))
        cluster.apply_pod(PodSpec(name="storm-pod", unschedulable=True, requests={"cpu": "100m"}))
        assert wait_until(lambda: cluster.get_pod("default", "storm-pod").node_name), (
            "batch stalled behind warmup despite the host path")
        assert port_solver.SOLVE_DISPATCH_TOTAL.get("host") > host_before
        assert not mgr.ready.is_set()
        release.set()
        assert wait_until(mgr.ready.is_set)
        assert mgr.warm.is_set() and mgr.warmup_s is not None
        assert not port_solver._WARMING_HOST_PREFERENCE.is_set()
        assert port_solver.break_even() is not None
    finally:
        release.set()
        mgr.stop()


def test_first_solve_after_ready_is_steady_state(monkeypatch):
    """Wait for ready, then force the device path: the first live solve
    runs on a warm path."""
    monkeypatch.setenv("KARPENTER_HOST_SOLVE", "0")
    monkeypatch.setenv("KARPENTER_WARMUP_SHAPES", "8x8,8x16")
    cluster, mgr = _cpu_manager("cost")
    failures = port_warmup.WARMUP_RUNG_FAILURES.get()
    try:
        mgr.start()
        assert wait_until(mgr.ready.is_set), "never warmed"
        assert port_warmup.WARMUP_RUNG_FAILURES.get() == failures
        host_before = port_solver.SOLVE_DISPATCH_TOTAL.get("host")
        cluster.apply_provisioner(Provisioner(name="warm"))
        cluster.apply_pod(PodSpec(name="first-pod", unschedulable=True, requests={"cpu": "100m"}))
        start = time.perf_counter()
        assert wait_until(lambda: cluster.get_pod("default", "first-pod").node_name)
        assert time.perf_counter() - start < 8.0
        assert port_solver.SOLVE_DISPATCH_TOTAL.get("host") == host_before
    finally:
        mgr.stop()


def test_stopped_manager_never_reasserts_ready(monkeypatch):
    release, compiling = threading.Event(), threading.Event()
    monkeypatch.setattr(port_warmup, "_compile_shapes", _slow_compile(compiling, release))
    _, mgr = _cpu_manager("cost")
    try:
        mgr.start()
        assert compiling.wait(timeout=WAIT_S)
        mgr.stop()
        release.set()
        assert wait_until(mgr.warm.is_set)
        time.sleep(0.1)
        assert not mgr.ready.is_set()
    finally:
        release.set()
        mgr.stop()


def test_warming_preference_refcounts_across_overlapping_warmups():
    S = port_solver
    assert not S._WARMING_HOST_PREFERENCE.is_set()
    S.set_warming_host_preference(True)
    S.set_warming_host_preference(True)
    S.set_warming_host_preference(False)
    assert S._WARMING_HOST_PREFERENCE.is_set()
    S.set_warming_host_preference(False)
    assert not S._WARMING_HOST_PREFERENCE.is_set()
    S.set_warming_host_preference(False)
    S.set_warming_host_preference(True)
    assert S._WARMING_HOST_PREFERENCE.is_set()
    S.set_warming_host_preference(False)


def test_a_degraded_card_at_boot_stops_the_manager(monkeypatch):
    """No fallback: a DEGRADED verdict stops the Manager and raises with its
    reason; nothing is routed to the host."""
    verdict = backend_health.Verdict(backend_health.DEGRADED, "probe hung past 30s", 0.0, 30.0)
    monkeypatch.setattr(backend_health, "ensure_backend", lambda device=None: verdict)
    _, mgr = _cpu_manager("cost")
    try:
        with pytest.raises(RuntimeError, match="probe hung"):
            mgr.start()
        assert not mgr.healthy() and not mgr.ready.is_set()
        assert not port_solver._WARMING_HOST_PREFERENCE.is_set()
    finally:
        mgr.stop()


@pytest.mark.parametrize("device_type", ["cpu", "cuda"])
def test_a_failed_warmup_stops_the_manager_only_on_the_card(monkeypatch, device_type):
    """A kernel that does not build (the warmup raises): on the card the
    Manager stops with the error (/healthz 503, never ready, and a second
    start refuses); on the CPU it is logged and the Manager serves."""
    from karpenter_tpu_torch import device as device_module

    def failed_build(device=None):
        raise RuntimeError("nvcc failed on pack_rounds.cu")

    monkeypatch.setattr(port_warmup, "warmup_ladder", failed_build)
    monkeypatch.setattr(device_module, "resolve_device", lambda device=None: torch.device(device_type))
    _, mgr = _cpu_manager("cost")
    try:
        mgr.start()
        if device_type == "cuda":
            assert wait_until(lambda: not mgr.healthy())
            assert "nvcc failed" in str(mgr.warmup_error)
            assert not mgr.ready.is_set() and not mgr.warm.is_set()
            with pytest.raises(RuntimeError, match="warmup failed on the card"):
                mgr.start()
        else:
            assert wait_until(mgr.ready.is_set)
            assert mgr.healthy() and mgr.warmup_error is None
    finally:
        mgr.stop()


@pytest.mark.parametrize("device_type", ["cpu", "cuda"])
def test_a_failed_rung_or_build_raises_only_on_the_card(monkeypatch, device_type):
    """Each rung's failure is counted; on the card it also ends the warmup,
    and so does a failed kernel build."""
    from karpenter_tpu_torch import device as device_module
    from karpenter_tpu_torch.ops import cuda_build

    def failing_solve(*args, **kwargs):
        raise RuntimeError("the kernel did not launch")

    def failed_build(libraries):
        raise RuntimeError("nvcc failed on pack_rounds.cu")

    monkeypatch.setattr(device_module, "resolve_device", lambda device=None: torch.device(device_type))
    monkeypatch.setattr(port_warmup, "_timed_device_solve_ms", failing_solve)
    monkeypatch.setattr(cuda_build, "build_all", failed_build)
    failures = port_warmup.WARMUP_RUNG_FAILURES.get()
    if device_type == "cuda":
        with pytest.raises(RuntimeError, match="did not launch"):
            port_warmup._compile_shapes("8x8,8x16", device=device_type)
        assert port_warmup.WARMUP_RUNG_FAILURES.get() == failures + 1
        with pytest.raises(RuntimeError, match="nvcc failed"):
            port_warmup.warmup_ladder("8x8", device=device_type)
    else:
        port_warmup._compile_shapes("8x8,8x16", device=device_type)
        assert port_warmup.WARMUP_RUNG_FAILURES.get() == failures + 2
        assert port_warmup.warmup_ladder("8x8", device=device_type) >= 0.0
        assert port_solver.break_even() is None
    assert not port_solver._WARMING_HOST_PREFERENCE.is_set()


def test_backend_verdict_machine_matches_the_reference():
    """The trimmed verdict machine walks the reference's transitions under
    the same scripted probes; a CPU device settles healthy unprobed."""
    from karpenter_tpu.utils import backend_health as ref_health

    def run(module, clock):
        results = [module.ProbeResult(False, 0.1, "wedged"), module.ProbeResult(True, 0.2)]
        bh = module.BackendHealth(probe=lambda timeout: results.pop(0), clock=clock)
        first = bh.verdict()
        clock.advance(bh.ttl_s + 1)
        second = bh.verdict()
        return bh.transitions, first.state, first.reason, second.state

    assert run(backend_health, FakeClock()) == run(ref_health, RefFakeClock())
    calls = []
    bh = backend_health.BackendHealth(probe=lambda timeout: calls.append(timeout), clock=FakeClock())
    assert bh.ensure_backend(torch.device("cpu")).state == backend_health.HEALTHY
    assert calls == []


# --- the HTTP endpoints ---------------------------------------------------------


def test_http_endpoints():
    _, mgr = _cpu_manager("greedy")
    port = free_port()
    server = port_runtime.serve_http(mgr, port, address="127.0.0.1")
    url = f"http://127.0.0.1:{port}"
    try:
        assert get(url + "/healthz") == (200, b"ok")
        assert get(url + "/readyz") == (503, b"not ready")
        mgr.start_standby()
        assert get(url + "/readyz") == (503, b"standby")
        mgr.start()
        assert get(url + "/readyz") == (200, b"ok")
        status, body = get(url + "/metrics")
        assert status == 200 and b"karpenter_workqueue_depth" in body
        stacks = json.loads(get(url + "/debug/stacks")[1])
        assert stacks["profile_samples"] > 0 and stacks["thread_count"] >= 1
        assert set(json.loads(get(url + "/debug/slo")[1])) >= {"targets", "pending", "ttfl"}
        assert "dropped" in json.loads(get(url + "/debug/flightrecorder")[1])
        request = urllib.request.Request(url + "/debug/loglevel", data=b"debug", method="POST")
        with urllib.request.urlopen(request, timeout=10) as response:
            assert json.loads(response.read()) == {"level": "debug"}
        assert json.loads(get(url + "/debug/loglevel")[1]) == {"level": "debug"}
        assert get(url + "/nope")[0] == 404
        mgr.stop()
        assert get(url + "/healthz") == (503, b"stopped")
        assert get(url + "/readyz")[0] == 503
    finally:
        mgr.stop()
        server.shutdown()
        from karpenter_tpu_torch.utils import logging as klog

        klog.set_level("info")


# --- cmd/controller.main end to end -----------------------------------------


def test_controller_main_binds_every_pod_exactly_once():
    cluster = Cluster()
    metrics_port, probe_port = free_port(), free_port()
    argv = ["--cluster-name", "x", "--metrics-port", str(metrics_port),
            "--health-probe-port", str(probe_port)]
    binds = Counter()
    cluster.watch_deltas(lambda verb, kind, obj: binds.update([obj.uid]) if verb == "bind" and kind == "pod" else None)
    mgr = controller.main(argv, cluster=cluster, block=False, device="cpu")
    try:
        assert isinstance(mgr.solver, port_solver.CostSolver) and mgr.elector.is_leader.is_set()
        assert get(f"http://127.0.0.1:{probe_port}/healthz")[0] == 200
        assert wait_until(mgr.ready.is_set)
        assert get(f"http://127.0.0.1:{probe_port}/readyz")[0] == 200
        cluster.apply_provisioner(Provisioner(name="default", spec=ProvisionerSpec()))
        pods = [PodSpec(name=f"main-{i}", requests={"cpu": "500m"}, unschedulable=True) for i in range(200)]
        for pod in pods:
            cluster.apply_pod(pod)
        assert wait_until(lambda: all(cluster.get_pod(p.namespace, p.name).node_name for p in pods))
        assert {p.uid for p in pods} <= set(binds) and all(binds[p.uid] == 1 for p in pods)
        assert cluster.list_nodes()
    finally:
        mgr.stop()
        mgr.elector.release()
    assert get(f"http://127.0.0.1:{metrics_port}/healthz")[0] == 503


def test_controller_refuses_what_is_not_ported():
    """Nothing of the controller process is left unported: --solver remote
    builds the sidecar's client (the reference's RemoteSolver, which never
    touches the card), --cluster-store selects the in-memory store or an
    apiserver's transport, and the registry's ec2 builds the EC2
    provider."""
    from karpenter_tpu_torch.cloudprovider.ec2 import Ec2CloudProvider
    from karpenter_tpu_torch.kubeapi.client import HttpTransport
    from karpenter_tpu_torch.solver_service.client import RemoteSolver

    remote = port_runtime.make_solver("remote", "127.0.0.1:1")
    try:
        assert isinstance(remote, RemoteSolver) and remote.endpoint == "127.0.0.1:1"
        assert not getattr(remote, "needs_device_warmup", False)
    finally:
        remote.close()
    assert isinstance(controller.build_cluster(Options(cluster_name="x")), Cluster)
    assert HttpTransport.for_store("memory") is None
    transport = HttpTransport.for_store("http://127.0.0.1:8001")
    assert isinstance(transport, HttpTransport) and transport.base_url == "http://127.0.0.1:8001"
    try:
        assert isinstance(registry.new_cloud_provider("ec2"), Ec2CloudProvider)
    finally:
        assert isinstance(registry.new_cloud_provider("fake"), FakeCloudProvider)


# --- calibration and the host gate --------------------------------------------


def test_synthetic_problem_is_the_references():
    for shape in ((8, 8), (16, 64), (64, 16)):
        for got, want in zip(port_warmup.make_synthetic_problem(*shape, pods_per_group=3),
                             ref_warmup.make_synthetic_problem(*shape, pods_per_group=3)):
            assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("timings", [(0.5, 0.001, 3.0), (70.0, 0.004, 22.0), (0.2, 0.0, 5.0),
                                     (5.0, float("inf"), 10.0), (900.0, 0.01, 40.0)])
def test_calibration_matches_the_reference(timings):
    floor, rate, device_ms = timings
    try:
        got = port_solver.calibrate_break_even(fetch_floor_ms=floor, host_ms_per_pod=rate,
                                               device_compute_ms=device_ms)
        want = ref_solver.calibrate_break_even(fetch_floor_ms=floor, host_ms_per_pod=rate,
                                               device_compute_ms=device_ms)
        assert (got.fetch_floor_ms, got.host_ms_per_pod, got.max_pods, got.max_pods_batched) == (
            want.fetch_floor_ms, want.host_ms_per_pod, want.max_pods, want.max_pods_batched)
        assert port_solver.BREAK_EVEN_GAUGE.get("host_max_pods") == got.max_pods
    finally:
        ref_solver.reset_break_even()


def test_host_gate_decides_as_the_reference(monkeypatch):
    """Uncalibrated, calibrated and warming: the port's gate routes every
    size as the reference's does on one device (no mesh, a healthy
    backend)."""
    from karpenter_tpu.utils import backend_health as ref_health

    monkeypatch.setenv("KARPENTER_SHARDED_SOLVE", "0")
    monkeypatch.delenv("KARPENTER_HOST_SOLVE", raising=False)
    monkeypatch.setattr(ref_health, "degraded", lambda: False)
    sizes = [0, 1, 120, 599, 600, 601, 1999, 2000, 2001, 9999, 10_000, 10_001, 199_999, 200_000, 200_001]

    def decisions():
        return [(port_solver.host_solve_enabled(n, batched, device="cpu"),
                 ref_solver.host_solve_enabled(n, batched))
                for n in sizes for batched in (False, True)]

    try:
        states = {"uncalibrated": decisions()}
        for module in (port_solver, ref_solver):
            module.calibrate_break_even(fetch_floor_ms=1.0, host_ms_per_pod=0.01, device_compute_ms=5.0)
        states["calibrated"] = decisions()
        for module in (port_solver, ref_solver):
            module.set_warming_host_preference(True)
        states["warming"] = decisions()
        for module in (port_solver, ref_solver):
            module.set_warming_host_preference(False)
        monkeypatch.setenv("KARPENTER_HOST_SOLVE", "0")
        states["forced device"] = decisions()
    finally:
        ref_solver.reset_break_even()
        ref_solver.set_warming_host_preference(False)
    for state, pairs in states.items():
        assert all(port == ref for port, ref in pairs), state
    assert any(port for port, _ in states["warming"]) and not any(port for port, _ in states["forced device"])
    assert [p for p, _ in states["calibrated"]] != [p for p, _ in states["uncalibrated"]]


@pytest.mark.parametrize("device", [None, "cuda"])
def test_host_route_is_opt_in_on_the_card(monkeypatch, device):
    """On the card the host route is closed unless asked for: unset, no
    size goes to the host, warming or calibrated; =auto gives the adaptive
    gate that is the CPU's default (and the reference's); =1 forces the
    host and =0 closes it. Deciding needs no card."""
    sizes = [0, 1, 599, 600, 2000, 2001, 9999, 10_000, 10_001, 200_001]

    def decisions(on):
        return [port_solver.host_solve_enabled(n, batched, device=on)
                for n in sizes for batched in (False, True)]

    routes, card, cpu = {}, {}, {}
    try:
        for flag in (None, "auto", "1", "0"):
            if flag is None:
                monkeypatch.delenv("KARPENTER_HOST_SOLVE", raising=False)
            else:
                monkeypatch.setenv("KARPENTER_HOST_SOLVE", flag)
            routes[flag] = port_solver.host_route_open(device)
            port_solver.reset_break_even()
            for state in ("uncalibrated", "warming", "calibrated"):
                if state == "warming":
                    port_solver.set_warming_host_preference(True)
                if state == "calibrated":
                    port_solver.set_warming_host_preference(False)
                    port_solver.calibrate_break_even(fetch_floor_ms=1.0, host_ms_per_pod=0.01,
                                                     device_compute_ms=5.0)
                card[flag, state], cpu[flag, state] = decisions(device), decisions("cpu")
    finally:
        port_solver.reset_break_even()
    assert routes == {None: False, "auto": True, "1": True, "0": False}
    for state in ("uncalibrated", "warming", "calibrated"):
        assert not any(card[None, state]) and not any(card["0", state]) and not any(cpu["0", state])
        assert card["auto", state] == cpu["auto", state] == cpu[None, state]
        assert all(card["1", state])
    assert any(card["auto", "warming"]) and card["auto", "calibrated"] != card["auto", "uncalibrated"]
