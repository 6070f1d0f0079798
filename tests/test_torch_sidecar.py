"""The port's solver sidecar against the reference's, on the CPU.

The same seeded problems (the main path's mix of chip_smoke.make_workload
at 300 pods and 24 types) go as one SolveRequest to both packages'
SolverServers, in cost mode and in ffd mode with and without the quirk,
unary and over SolveStream: the answers must be equal, integers bit for bit
and prices within 1e-6 relative. Each package's RemoteSolver against the
other's server gives the PackResult of that server's package solving in
process. Both packages run their device path (KARPENTER_HOST_SOLVE=0, and
the reference on its single-device program: KARPENTER_SHARDED_SOLVE=0).

Then the port alone: the sidecar over two processes (gloo, a 2x2 mesh, a
row of shards a process) against one process's 2x2 mesh, bit for bit, and
both ranks ending on SIGTERM; a partial multi-process environment, a
DEGRADED card at boot and a failed warmup end the server; the solver's
device spans, under the sidecar's serve span when the solve comes through
it.
"""

import os
import signal
import socket
import subprocess
import sys
import textwrap
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from karpenter_tpu.api.pods import PodSpec as RefPodSpec
from karpenter_tpu.api.provisioner import Constraints as RefConstraints
from karpenter_tpu.cloudprovider import InstanceType as RefInstanceType
from karpenter_tpu.cloudprovider import Offering as RefOffering
from karpenter_tpu.models import solver as ref_solver
from karpenter_tpu.ops import encode as ref_encode
from karpenter_tpu.solver_service.client import RemoteSolver as RefRemoteSolver
from karpenter_tpu.solver_service.server import SolverServer as RefSolverServer
from karpenter_tpu_torch.models import solver as port_solver
from karpenter_tpu_torch.parallel import mesh as port_mesh
from karpenter_tpu_torch.solver_service import server as port_server
from karpenter_tpu_torch.solver_service.client import RemoteSolver as PortRemoteSolver
from karpenter_tpu_torch.utils import tracing as port_tracing
from tests.test_solver_service import _packing_signature

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
NUM_PODS = 300
NUM_TYPES = 24
PRICE_RTOL = 1e-6
# Every test here that starts processes kills them past this.
PROCESS_DEADLINE_S = 240.0


def _package(name):
    if name == "reference":
        return SimpleNamespace(PodSpec=RefPodSpec, InstanceType=RefInstanceType, Offering=RefOffering,
                               Constraints=RefConstraints, group_pods=ref_encode.group_pods,
                               build_fleet=ref_encode.build_fleet)
    return chip_smoke.port_package()


def _problem(name, seed):
    """(groups, fleet) of the main path's mix at NUM_PODS x NUM_TYPES in
    package `name`."""
    pkg = _package(name)
    shapes = chip_smoke.pod_shapes(seed)
    counts = (chip_smoke.zipf_weights(len(shapes)) * NUM_PODS).astype(int)
    counts[0] += NUM_PODS - counts.sum()
    pods = [pkg.PodSpec(name=f"pod-{k}-{i}", requests={"cpu": f"{cpu}m", "memory": f"{mem}Mi"},
                        unschedulable=True)
            for k, ((cpu, mem), count) in enumerate(zip(shapes, counts)) for i in range(count)]
    catalog = chip_smoke.make_catalog(NUM_TYPES, seed, package=pkg)
    return pkg.group_pods(pods), pkg.build_fleet(catalog, pkg.Constraints(), pods)


@pytest.fixture
def device_path(monkeypatch):
    monkeypatch.setenv("KARPENTER_HOST_SOLVE", "0")
    monkeypatch.setenv("KARPENTER_SHARDED_SOLVE", "0")


@pytest.fixture(scope="module")
def servers():
    ref = RefSolverServer(port=0).start(warmup=False)
    port = port_server.SolverServer(port=0, device="cpu").start(warmup=False)
    yield SimpleNamespace(reference=f"127.0.0.1:{ref.port}", port=f"127.0.0.1:{port.port}")
    ref.stop()
    port.stop()


def _fields(response):
    """A SolveResponse as comparable parts: its integers and strings, and
    its prices apart."""
    rounds = [(r.type_index, r.fill.shape[:], r.fill.dtype, r.fill.data, r.replication, r.option_set)
              for r in response.rounds]
    sets = [(list(s.type_indices), s.has_pools, [(p.type_index, p.zone_index) for p in s.pools])
            for s in response.option_sets]
    prices = np.array([p.price for s in response.option_sets for p in s.pools], np.float64)
    unschedulable = (response.unschedulable.shape[:], response.unschedulable.dtype,
                     response.unschedulable.data)
    return (rounds, sets, unschedulable, response.solver, response.fallback), prices


def assert_same_response(got, want):
    got_exact, got_prices = _fields(got)
    want_exact, want_prices = _fields(want)
    assert got_exact == want_exact
    np.testing.assert_allclose(got_prices, want_prices, rtol=PRICE_RTOL)


MODES = [("cost", False), ("ffd", False), ("ffd", True)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mode,quirk", MODES, ids=["cost", "ffd", "ffd-quirk"])
def test_the_port_server_answers_as_the_reference(mode, quirk, seed, servers, device_path):
    groups, fleet = _problem("port", seed)
    clients = {name: PortRemoteSolver(endpoint, mode=mode, quirk=quirk)
               for name, endpoint in vars(servers).items()}
    try:
        request, _ = clients["port"]._build_request(groups, fleet)
        other, _ = clients["port"]._build_request(*_problem("port", seed + 7))
        unary = {name: client._solve_rpc(request, timeout=60.0) for name, client in clients.items()}
        stream = {name: list(client._stream_rpc(iter([request, other]), timeout=60.0))
                  for name, client in clients.items()}
    finally:
        for client in clients.values():
            client.close()
    want = "tpu-cost" if mode == "cost" else "tpu-ffd"
    assert unary["port"].solver == want and not unary["port"].fallback
    assert len(unary["port"].rounds) > 0
    assert_same_response(unary["port"], unary["reference"])
    assert len(stream["port"]) == len(stream["reference"]) == 2
    for got, expected in zip(stream["port"], stream["reference"]):
        assert got.solver == want
        assert_same_response(got, expected)
    assert_same_response(stream["port"][0], unary["port"])


def _in_process(name, mode, quirk, groups, fleet):
    solvers = {"reference": ref_solver, "port": port_solver}[name]
    device = {} if name == "reference" else {"device": "cpu"}
    if mode == "cost":
        return solvers.CostSolver(**device).solve_encoded(groups, fleet)
    return solvers.TPUSolver(mode="ffd", quirk=quirk, **device).solve_encoded(groups, fleet)


@pytest.mark.parametrize("mode,quirk", MODES, ids=["cost", "ffd", "ffd-quirk"])
def test_each_client_works_against_the_other_server(mode, quirk, servers, device_path):
    """A reference RemoteSolver against the port's server gives the port's
    in-process solve; a port RemoteSolver against the reference's server
    gives the reference's; and the two in-process solves agree."""
    for client_side, server_side, Client in (("reference", "port", RefRemoteSolver),
                                             ("port", "reference", PortRemoteSolver)):
        groups, fleet = _problem(client_side, 0)
        client = Client(getattr(servers, server_side), mode=mode, quirk=quirk)
        try:
            over_wire = client.solve_encoded(groups, fleet)
            assert client._blackout_until == -float("inf")
        finally:
            client.close()
        local = _in_process(server_side, mode, quirk, *_problem(server_side, 0))
        assert _packing_signature(over_wire) == _packing_signature(local), (client_side, server_side)
    assert _packing_signature(_in_process("port", mode, quirk, *_problem("port", 0))) == \
        _packing_signature(_in_process("reference", mode, quirk, *_problem("reference", 0)))


# --- the sidecar over two processes ---------------------------------------------

_RANK_PROGRAM = textwrap.dedent(
    """
    import os, sys
    import torch

    torch.set_num_threads(1)
    rank, port_file = int(sys.argv[1]), sys.argv[2]
    from karpenter_tpu_torch.parallel import mesh as port_mesh
    from karpenter_tpu_torch.solver_service import server

    start = server.SolverServer.start

    def announce(self, warmup=True):
        started = start(self, warmup)
        with open(port_file + ".part", "w") as out:
            out.write(str(self.port))
        os.replace(port_file + ".part", port_file)
        return started

    server.SolverServer.start = announce
    with port_mesh.virtual_devices("cpu", 2):
        server.main(["--host", "127.0.0.1", "--port", "0"], device="cpu")
    print(f"rank {rank} done", flush=True)
    """
)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _environment(**extra):
    env = {key: value for key, value in os.environ.items() if not key.startswith("KARPENTER_")}
    env.update(PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", **extra)
    return env


def _finish(procs, deadline):
    """Each process's (returncode, output); kills them all past `deadline`
    (a monotonic time) and fails with their output."""
    outputs = [""] * len(procs)
    for index, proc in enumerate(procs):
        try:
            outputs[index], _ = proc.communicate(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            for other in procs:
                other.kill()
            outputs = [out or proc.communicate()[0] for out, proc in zip(outputs, procs)]
            pytest.fail("the sidecar's processes did not end in time:\n" + "\n---\n".join(
                out[-3000:] for out in outputs))
    return [(proc.returncode, out) for proc, out in zip(procs, outputs)]


def test_two_rank_sidecar_solves_as_one_process(tmp_path, monkeypatch):
    deadline = time.monotonic() + PROCESS_DEADLINE_S
    port_file = tmp_path / "port"
    coordinator = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _RANK_PROGRAM, str(rank), str(port_file)],
            env=_environment(KARPENTER_COORDINATOR=f"127.0.0.1:{coordinator}", KARPENTER_NUM_PROCESSES="2",
                             KARPENTER_PROCESS_ID=str(rank), KARPENTER_HOST_SOLVE="0",
                             KARPENTER_WARMUP_SHAPES="8x8"),
            cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)
    ]
    client = None
    try:
        while not port_file.exists():
            assert all(proc.poll() is None for proc in procs), "a rank ended before serving"
            assert time.monotonic() < deadline, "rank 0 never served"
            time.sleep(0.1)
        client = PortRemoteSolver(f"127.0.0.1:{port_file.read_text()}")
        health = client.healthy()
        while health is None or health.status != "ok":
            assert time.monotonic() < deadline, "the two-rank sidecar never warmed"
            time.sleep(0.2)
            health = client.healthy()
        assert health.platform == "cpu" and health.device_count == 4
        groups, fleet = _problem("port", 0)
        request, _ = client._build_request(groups, fleet)
        across = client._solve_rpc(request, timeout=120.0)
        procs[0].send_signal(signal.SIGTERM)
        results = _finish(procs, deadline)
    finally:
        if client is not None:
            client.close()
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for rank, (code, out) in enumerate(results):
        assert code == 0 and f"rank {rank} done" in out, f"rank {rank} (rc={code}):\n{out[-3000:]}"
    assert across.solver == "tpu-cost" and not across.fallback
    monkeypatch.setenv("KARPENTER_HOST_SOLVE", "0")
    with port_mesh.virtual_devices("cpu", 4):
        alone = port_server.SolverServer(port=0, device="cpu").start(warmup=False)
        one = PortRemoteSolver(f"127.0.0.1:{alone.port}")
        try:
            assert port_solver.solve_mesh("cpu").shape == (2, 2)
            want = one._solve_rpc(request, timeout=120.0)
        finally:
            one.close()
            alone.stop()
    assert _fields(across)[0] == _fields(want)[0]
    np.testing.assert_array_equal(_fields(across)[1], _fields(want)[1])


def test_partial_multiprocess_environment_fails_at_boot():
    program = ("from karpenter_tpu_torch.solver_service import server\n"
               "server.main(['--host', '127.0.0.1', '--port', '0'], device='cpu')\n")
    proc = subprocess.Popen([sys.executable, "-c", program],
                            env=_environment(KARPENTER_COORDINATOR="127.0.0.1:1"), cwd=str(REPO),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    [(code, out)] = _finish([proc], time.monotonic() + 60.0)
    assert code != 0 and "KARPENTER_" in out and "ValueError" in out, out[-3000:]


# --- no degraded serving ----------------------------------------------------------


def test_sidecar_needs_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the refusal path needs none")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_server.SolverServer(port=0)
    server = port_server.SolverServer(port=0, device="cpu")
    assert server.device == torch.device("cpu")
    server.stop()


def test_degraded_boot_ends_the_server_nonzero():
    program = textwrap.dedent(
        """
        from karpenter_tpu_torch.solver_service import server
        from karpenter_tpu_torch.utils import backend_health

        backend_health.ensure_backend = lambda device=None: backend_health.Verdict(
            backend_health.DEGRADED, "probe timed out", 0.0, 1.0)
        server.main(["--host", "127.0.0.1", "--port", "0"], device="cpu")
        print("served", flush=True)
        """
    )
    proc = subprocess.Popen([sys.executable, "-c", program], env=_environment(), cwd=str(REPO),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    [(code, out)] = _finish([proc], time.monotonic() + 60.0)
    assert code != 0 and "liveness probe at boot: probe timed out" in out and "served" not in out


def test_failed_warmup_stops_the_server(monkeypatch):
    from karpenter_tpu_torch.models import warmup

    def broken(shapes=None, device=None):
        raise RuntimeError("a kernel did not build")

    monkeypatch.setattr(warmup, "warmup_ladder", broken)
    server = port_server.SolverServer(port=0, device="cpu").start(warmup=True)
    client = PortRemoteSolver(f"127.0.0.1:{server.port}")
    try:
        statuses = set()
        deadline = time.monotonic() + 30.0
        while server.warmup_error is None and time.monotonic() < deadline:
            health = client.healthy(timeout_s=1.0)
            statuses.add(health.status if health else None)
            time.sleep(0.02)
        assert isinstance(server.warmup_error, RuntimeError)
        assert "ok" not in statuses
        assert client.healthy(timeout_s=1.0) is None  # stopped: nothing answers
        assert not server.handler.warmed.is_set()
    finally:
        client.close()
        server.stop()
    handlers = {signum: signal.getsignal(signum) for signum in (signal.SIGTERM, signal.SIGINT)}
    try:
        with pytest.raises(RuntimeError, match="warmup failed") as error:
            port_server.main(["--host", "127.0.0.1", "--port", "0"], device="cpu")
        assert "did not build" in str(error.value.__cause__)
    finally:
        for signum, handler in handlers.items():
            signal.signal(signum, handler)


# --- the solver's device spans -----------------------------------------------------


def test_device_spans_and_profiles(monkeypatch, tmp_path, device_path):
    tracer = port_tracing.Tracer(enabled=True)
    tracer.profile_dir = str(tmp_path / "profiles")
    monkeypatch.setattr(port_solver, "TRACER", tracer)
    monkeypatch.setattr(port_server, "TRACER", tracer)
    solver = port_solver.CostSolver(device="cpu")
    first, second = _problem("port", 0), _problem("port", 1)

    solver.solve_encoded(*first)
    [single] = tracer.spans("solve.device")
    assert single.parent is None
    assert single.attributes == {"groups": first[0].num_groups, "types": NUM_TYPES}
    solver.solve_encoded_many([first, second])
    [batch] = tracer.spans("solve.device.batch")
    assert batch.attributes == {"solves": 2}
    list(solver.solve_encoded_pipelined([first, second]))
    assert [s.attributes for s in tracer.spans("solve.device.pipelined")] == [{"solve": 0}, {"solve": 1}]
    # One torch.profiler trace each: the single solve, the batch's fetch
    # and each pipelined fetch.
    assert len(list((tmp_path / "profiles").glob("device-*.json"))) == 4

    server = port_server.SolverServer(port=0, device="cpu").start(warmup=False)
    client = PortRemoteSolver(f"127.0.0.1:{server.port}")
    try:
        client.solve_encoded(*first)
    finally:
        client.close()
        server.stop()
    [serve] = tracer.spans("solver.serve")
    [_, remote] = tracer.spans("solve.device")
    assert serve.attributes == {"mode": "cost"}
    assert remote.parent == "solver.serve" and remote.thread_id == serve.thread_id


def test_pipelined_stream_records_its_rpc_when_the_caller_stops_at_the_last_result(servers):
    """The provisioning pass pulls exactly one result a schedule from
    solve_many_pipelined and never resumes the generator after the last:
    the stream's RPC histogram and span are recorded by then."""
    from karpenter_tpu_torch.solver_service import client as client_mod

    tracer = port_tracing.Tracer(enabled=True)
    items = [_problem("port", 0), _problem("port", 1)]
    client = PortRemoteSolver(servers.port)
    before = client_mod._RPC_HISTOGRAM.count("ok")
    try:
        with pytest.MonkeyPatch.context() as monkeypatch:
            monkeypatch.setattr(client_mod, "TRACER", tracer)
            stream = client.solve_encoded_pipelined(items)
            results = [next(stream) for _ in items]
            assert client_mod._RPC_HISTOGRAM.count("ok") == before + 1
            [span] = tracer.spans("solver.rpc.stream")
            assert span.attributes["outcome"] == "ok" and span.attributes["solves"] == 2
            assert list(stream) == []
    finally:
        client.close()
    assert all(not r.unschedulable for r in results)


def test_a_first_launch_waits_for_the_warmups_build(tmp_path, monkeypatch):
    """A solve that reaches a kernel while the boot warmup builds it (the
    sidecar serves RPCs from the moment it listens) waits for that build:
    one compiler run a source, never two writing the same file."""
    import threading

    from karpenter_tpu_torch.ops import cuda_build

    calls = tmp_path / "calls"
    compiler = tmp_path / "nvcc"
    # Stands in for nvcc: counts its runs, takes a while, and writes a
    # loadable (empty) shared library where -o says.
    compiler.write_text(
        "#!/bin/sh\n"
        f"echo run >> {calls}\n"
        "sleep 1\n"
        "while [ $# -gt 0 ]; do if [ \"$1\" = -o ]; then out=$2; fi; shift; done\n"
        "echo 'int ktpu_probe(void) { return 7; }' > \"$out.c\"\n"
        "cc -shared -fPIC -o \"$out\" \"$out.c\"\n"
    )
    compiler.chmod(0o755)
    source = tmp_path / "probe.cu"
    source.write_text("// a kernel source\n")
    monkeypatch.setattr(cuda_build, "_nvcc_path", lambda: str(compiler))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    import ctypes

    library = cuda_build.CudaLibrary(str(source), {"ktpu_probe": (ctypes.c_int, [])})
    warmup = threading.Thread(target=cuda_build.build_all, args=([library],))
    warmup.start()
    time.sleep(0.3)  # the warmup's build is running
    assert library.load().ktpu_probe() == 7
    warmup.join()
    assert calls.read_text().splitlines() == ["run"]


def test_concurrent_solves_equal_serial_ones(servers, device_path, monkeypatch, tmp_path):
    """Four Solve RPCs at once (four of the server's handler threads in the
    port's dispatch together, each solve under device_profile with a
    profile directory set) answer what four serial RPCs do."""
    from concurrent.futures import ThreadPoolExecutor

    tracer = port_tracing.Tracer(enabled=True)
    tracer.profile_dir = str(tmp_path)
    monkeypatch.setattr(port_solver, "TRACER", tracer)
    client = PortRemoteSolver(servers.port)
    try:
        requests = [client._build_request(*_problem("port", seed))[0] for seed in range(4)]

        def answer(request):
            response = client._solve_rpc(request, timeout=120.0)
            return _fields(response)[0], _fields(response)[1].tolist()

        serial = [answer(request) for request in requests]
        with ThreadPoolExecutor(max_workers=4) as pool:
            together = list(pool.map(answer, requests))
    finally:
        client.close()
    assert together == serial
    assert all(exact[3] == "tpu-cost" for exact, _ in serial)
    assert len(tracer.spans("solve.device")) == 8
    assert list(tmp_path.glob("device-*.json"))
