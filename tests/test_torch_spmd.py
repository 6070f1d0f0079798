"""The port's multi-process lead/follower dispatch of the sharded solve
(parallel/spmd.py, parallel/multihost.py) and its cross-process
collectives, on the CPU.

1. Loopback (the reference's tests/test_spmd.py TestSpmdCpuMesh): the REAL
   lead and follower code wired back to back through an injected transport
   on a one-process 8-shard CPU mesh: the header, the shard mask
   (a shrunk mesh included), the operands, the trace id in the header, the
   stop header, an idempotent lead_stop, the transport-capability
   classification. The follower's decoded plan is held to the reference's
   single-device solve on the same padded operands.
2. Real processes: two OS processes join one gloo group on a free loopback
   port, two CPU shards a process (a 2x2 mesh, a row a process). Rank 0
   runs the production CostSolver.solve_encoded on the reference test's
   fixtures at two shapes, then lead_stop; rank 1 runs the follower loop.
   Every decoded plan, the LP and the final plan equal the one-process 2x2
   CPU mesh's bit for bit, and the decoded plans equal the reference's
   single-device solve. The same group holds the collectives across
   processes to the one-process collectives bit for bit, on 2x2, 1x4 and
   4x1 meshes and inputs whose float32 sums depend on their order.
   Each spawn is killed on a deadline of its own (RANK_DEADLINE_S) and the
   test fails rather than hangs.
"""

import json
import os
import re
import socket
import subprocess
import sys
import textwrap
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.models import solver as port_solver
from karpenter_tpu_torch.ops import pack_kernel as port_pack
from karpenter_tpu_torch.parallel import collectives, multihost, spmd
from karpenter_tpu_torch.parallel import mesh as port_mesh
from karpenter_tpu_torch.utils import backend_health as port_health
from karpenter_tpu_torch.utils import tracing

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
RANK_DEADLINE_S = 120.0
LP_STEPS = 12
# The reference test's two shapes (tests/test_spmd.py _RANK_PROGRAM):
# (count, cpu, memory) per pod group.
SHAPES = {
    "mixed": ((120, "500m", "1Gi"), (60, "1", "2Gi")),
    "wide": ((40, "2", "1Gi"),),
}
LP_OBJECTIVE_RTOL = 1e-4
COST_RTOL = 1e-3


@pytest.fixture(autouse=True)
def _clean_state():
    port_health.clear_wedged_chips()
    yield
    port_health.clear_wedged_chips()


# --- 1. loopback --------------------------------------------------------------


def _example(mesh):
    """The reference loopback's problem (8 groups x 16 types) padded for
    `mesh`, and a kernel running the port's sharded solve over it."""
    import __graft_entry__

    vectors, counts, capacity, total, _, prices = __graft_entry__._example_problem(num_groups=8, num_types=16)
    padded = port_solver.pad_kernel_args(vectors, counts, capacity, total, prices,
                                         g_mult=mesh.size, t_mult=mesh.shape[1])

    def kernel(*operands, lp_steps):
        return port_solver._sharded_fused_solve(operands, mesh, lp_steps, torch.device("cpu"))

    return kernel, padded


def _reference_single(padded, lp_steps):
    """The reference's single-device fused solve on the same padded
    operands: (rounds_ffd, rounds_cost, feasible_any, objective)."""
    from karpenter_tpu.models import solver as ref_solver
    from karpenter_tpu.ops.pack_kernel import decompact_plan

    out = ref_solver._cost_fused_kernel_nodonate(*(np.array(a) for a in padded), lp_steps=lp_steps)
    ffd, cost, feasible, ok = decompact_plan(np.asarray(out[0]), int(padded[0].shape[0]))
    assert ok
    return ffd, cost, feasible, float(np.asarray(out[1])[0])


def _assert_decodes_to_reference(compact, objective, padded, shards, lp_steps):
    ffd, cost, feasible, ok = port_pack.decompact_plan_sharded(
        compact.cpu().numpy(), int(padded[0].shape[0]), shards)
    assert ok
    want_ffd, want_cost, want_feasible, want_objective = _reference_single(padded, lp_steps)
    for got, want in ((ffd, want_ffd), (cost, want_cost)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(feasible, want_feasible)
    np.testing.assert_allclose(float(objective[0]), want_objective, rtol=LP_OBJECTIVE_RTOL)


def _recording(monkeypatch):
    wire = []
    monkeypatch.setattr(spmd, "_broadcast", lambda value: (wire.append(np.array(value)), value)[1])
    return wire


def _replaying(monkeypatch, wire):
    replay = list(wire)
    monkeypatch.setattr(spmd, "_broadcast", lambda _: replay.pop(0))
    return replay


def test_lead_follower_loopback(monkeypatch):
    with port_mesh.virtual_devices("cpu", 8):
        mesh = port_mesh.make_mesh(kind="cpu")
        kernel, padded = _example(mesh)
        wire = _recording(monkeypatch)
        lead_out = spmd.SpmdDispatcher().lead_dispatch(kernel, padded, 6, mesh=mesh)
        # Replay the wire as the follower: the same header, mask and
        # operands rebuild the same mesh and run the same solve.
        replay = _replaying(monkeypatch, wire)
        follower_out = spmd.follower_step(wellknown.NUM_RESOURCE_DIMS, "cpu")
    assert [len(np.asarray(leg).shape) for leg in wire] == [1, 1, 1]
    assert follower_out is not None and not replay, "the follower consumed another number of legs"
    assert torch.equal(lead_out[0], follower_out[0]) and torch.equal(lead_out[1], follower_out[1])
    assert torch.equal(lead_out[3].cpu(), follower_out[3].cpu())
    _assert_decodes_to_reference(follower_out[0], follower_out[1], padded, 8, 6)


def test_trace_id_rides_the_header_to_follower_spans(monkeypatch):
    tracer = tracing.Tracer(enabled=True)
    monkeypatch.setattr(spmd, "TRACER", tracer)
    with port_mesh.virtual_devices("cpu", 8):
        mesh = port_mesh.make_mesh(kind="cpu")
        kernel, padded = _example(mesh)
        wire = _recording(monkeypatch)
        trace_id = tracing.new_trace_id()
        with tracer.trace(trace_id):
            spmd.SpmdDispatcher().lead_dispatch(kernel, padded, 6, mesh=mesh)
        header = np.asarray(wire[0])
        assert header.shape == (spmd.HEADER_WORDS,)
        assert tracing.words_to_trace_id(header[4], header[5]) == trace_id
        _replaying(monkeypatch, wire)
        out = spmd.follower_step(wellknown.NUM_RESOURCE_DIMS, "cpu")
    [step] = tracer.spans("spmd.follower.step")
    assert step.trace == trace_id
    _assert_decodes_to_reference(out[0], out[1], padded, 8, 6)


def test_device_mask_replicates_shrunk_mesh(monkeypatch):
    """A lead whose mesh lost shard 7 hands the followers a mask (the
    reference's, bit for bit) that rebuilds the identical 7-shard mesh,
    and the follower's solve over it decodes to the reference's."""
    import jax

    from karpenter_tpu.parallel import mesh as ref_mesh
    from karpenter_tpu.parallel import spmd as ref_spmd

    with port_mesh.virtual_devices("cpu", 8) as shards:
        mesh = port_mesh.make_mesh(shards[:7])
        mask = spmd._device_mask(mesh)
        assert mask.tolist() == [1] * 7 + [0]
        np.testing.assert_array_equal(mask, ref_spmd._device_mask(ref_mesh.make_mesh(jax.devices()[:7])))
        rebuilt = spmd._mesh_from_mask(mask, "cpu")
        assert rebuilt.shape == mesh.shape == (1, 7) and rebuilt.ids() == mesh.ids()
        kernel, padded = _example(mesh)
        wire = _recording(monkeypatch)
        spmd.SpmdDispatcher().lead_dispatch(kernel, padded, 6, mesh=mesh)
        _replaying(monkeypatch, wire)
        out = spmd.follower_step(wellknown.NUM_RESOURCE_DIMS, "cpu")
    _assert_decodes_to_reference(out[0], out[1], padded, 7, 6)


def test_stop_header_ends_follower(monkeypatch):
    monkeypatch.setattr(spmd, "_broadcast", lambda _: np.zeros(spmd.HEADER_WORDS, np.int32))
    assert spmd.follower_step(wellknown.NUM_RESOURCE_DIMS, "cpu") is None


def test_lead_stop_idempotent(monkeypatch):
    sent = []
    monkeypatch.setattr(spmd, "is_multiprocess", lambda: True)
    monkeypatch.setattr(spmd, "_broadcast", lambda value: (sent.append(value), value)[1])
    dispatcher = spmd.SpmdDispatcher()
    dispatcher.lead_stop()
    dispatcher.lead_stop()
    assert len(sent) == 1, "a second stop must not issue a collective"
    np.testing.assert_array_equal(sent[0], np.zeros(spmd.HEADER_WORDS, np.int32))
    padded = (np.zeros((1, 8), np.float32),) * 6
    with pytest.raises(RuntimeError, match="stopped"):
        dispatcher.lead_dispatch(None, padded, 1)


def test_lead_stop_alone_is_a_no_op(monkeypatch):
    sent = []
    monkeypatch.setattr(spmd, "_broadcast", lambda value: sent.append(value))
    spmd.SpmdDispatcher().lead_stop()
    assert sent == []


@pytest.mark.parametrize("message,unsupported", [
    ("Backend gloo does not support allgather", True),
    ("ProcessGroupGloo::allgather: unsupported device type cuda", True),
    ("NCCL error: invalid usage, Duplicate GPU detected : rank 1 and rank 0 both on CUDA device 0", True),
    ("Connection closed by peer [127.0.0.1]:29500", False),
    ("other", False),
])
def test_unsupported_transport_classified(message, unsupported):
    assert spmd.collectives_unsupported(RuntimeError(message)) is unsupported


def test_unsupported_transport_is_raised_and_not_quarantined(monkeypatch):
    """A transport-capability failure on the lead surfaces as
    SpmdUnsupportedError: no probe, no quarantine, no retry."""
    probed = []
    monkeypatch.setattr(spmd, "is_multiprocess", lambda: True)
    monkeypatch.setattr(port_health, "quarantine_mesh", lambda ids, error: probed.append(ids) or ids)

    def refuse(value):
        raise spmd.SpmdUnsupportedError("the transport cannot carry the group's collectives")

    monkeypatch.setattr(spmd, "_broadcast", refuse)
    vectors, counts, capacity, total, _, prices = __import__("__graft_entry__")._example_problem()
    with port_mesh.virtual_devices("cpu", 4):
        mesh = port_mesh.make_mesh(kind="cpu")
        with pytest.raises(spmd.SpmdUnsupportedError):
            port_solver._dispatch_sharded(vectors, counts, capacity, total, prices, 6, mesh,
                                          torch.device("cpu"))
    assert probed == []


def test_a_failure_across_processes_never_shrinks_one_sidedly(monkeypatch):
    """A dispatch failure on a mesh across processes is quarantined as the
    reference does, then raised: no retry on a shrunk mesh."""
    attempts = []
    monkeypatch.setattr(spmd, "is_multiprocess", lambda: True)
    monkeypatch.setattr(port_health, "quarantine_mesh", lambda ids, error: [ids[-1]])

    def failing(kernel, padded, lp_steps, mesh=None):
        attempts.append(mesh.size)
        raise RuntimeError("a card died mid-solve")

    monkeypatch.setattr(spmd, "lead_dispatch", failing)
    vectors, counts, capacity, total, _, prices = __import__("__graft_entry__")._example_problem()
    with port_mesh.virtual_devices("cpu", 4):
        mesh = port_mesh.make_mesh(kind="cpu")
        with pytest.raises(RuntimeError, match="died"):
            port_solver._dispatch_sharded(vectors, counts, capacity, total, prices, 6, mesh,
                                          torch.device("cpu"))
    assert attempts == [4]


def test_distributed_config_matches_the_reference():
    from karpenter_tpu.parallel import multihost as ref_multihost

    full = {"KARPENTER_COORDINATOR": "127.0.0.1:1", "KARPENTER_NUM_PROCESSES": "2",
            "KARPENTER_PROCESS_ID": "1"}
    for environ in ({}, full):
        assert multihost.DistributedConfig.from_env(environ) == (
            None if not environ else multihost.DistributedConfig("127.0.0.1:1", 2, 1))
        want = ref_multihost.DistributedConfig.from_env(environ)
        got = multihost.DistributedConfig.from_env(environ)
        assert (want is None) == (got is None)
    for partial in ({"KARPENTER_COORDINATOR": "x:1"}, {**full, "KARPENTER_PROCESS_ID": "2"},
                    {**full, "KARPENTER_NUM_PROCESSES": "0"}):
        with pytest.raises(ValueError):
            multihost.DistributedConfig.from_env(partial)
        with pytest.raises(ValueError):
            ref_multihost.DistributedConfig.from_env(partial)
    assert multihost.init_distributed({}) is False
    assert multihost.process_count() == 1 and multihost.process_index() == 0


@pytest.mark.parametrize("device_type,shared,backend", [
    ("cpu", False, "gloo"), ("cuda", True, "gloo"), ("cuda", False, "nccl")])
def test_backend_is_chosen_explicitly(device_type, shared, backend):
    assert multihost.backend_for(device_type, shared_card=shared) == backend


def test_a_mesh_across_processes_holds_every_process():
    shards = [port_mesh.Shard(i, torch.device("cpu"), i // 2) for i in range(4)]
    mesh = port_mesh.Mesh(shards, (2, 2), rank=1)
    assert mesh.spans_processes and mesh.ranks == [0, 1]
    assert mesh.indices_of(1) == [2, 3] and [mesh.is_local(i) for i in range(4)] == [False, False, True, True]
    assert port_mesh.local_mesh(mesh).ids() == [2, 3]
    with pytest.raises(ValueError, match="none of its shards"):
        port_mesh.Mesh(shards[:2], (1, 2), rank=1)


# --- 2. real processes ----------------------------------------------------------

_PRELUDE = textwrap.dedent(
    """
    import json, re, sys, types
    import numpy as np
    import torch

    torch.set_num_threads(1)
    rank, port, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    from karpenter_tpu_torch.parallel import multihost

    assert multihost.init_distributed(
        {
            "KARPENTER_COORDINATOR": f"127.0.0.1:{port}",
            "KARPENTER_NUM_PROCESSES": "2",
            "KARPENTER_PROCESS_ID": str(rank),
        },
        backend=multihost.backend_for("cpu"),
        timeout_s=90.0,
    )
    assert multihost.process_count() == 2 and multihost.process_index() == rank
    """
)

_SOLVE_PROGRAM = _PRELUDE + textwrap.dedent(
    """
    from karpenter_tpu_torch.parallel import mesh as port_mesh, spmd

    with port_mesh.virtual_devices("cpu", 2):
        if rank > 0:
            solves = spmd.follower_loop(device="cpu")
            multihost.shutdown_distributed()
            print(f"follower done after {solves} solves", flush=True)
            sys.exit(0)
        from tests import test_torch_spmd as spec
        from karpenter_tpu_torch.models import solver

        mesh = solver.solve_mesh("cpu")
        assert mesh.shape == (2, 2) and mesh.spans_processes and mesh.ids() == [0, 1, 2, 3]
        assert [s.rank for s in mesh.flat] == [0, 0, 1, 1]
        records = {name: spec.solve_record(name) for name in spec.SHAPES}
        spmd.lead_stop()
        spmd.lead_stop()
        multihost.shutdown_distributed()
        np.savez(f"{out_dir}/solves.npz", **{f"{name}:{key}": value for name, record in records.items()
                                             for key, value in record.items()})
        print("lead done", flush=True)
    """
)

_COLLECTIVES_PROGRAM = _PRELUDE + textwrap.dedent(
    """
    from tests import test_torch_spmd as spec

    np.savez(f"{out_dir}/collectives-{rank}.npz", **spec.collective_records(rank))
    multihost.shutdown_distributed()
    print("collectives done", flush=True)
    """
)


def _port_fixtures():
    """tests/fixtures.py with its imports pointed at the port."""
    module = types.ModuleType("_port_fixtures")
    source = re.sub(r"\bkarpenter_tpu\b", "karpenter_tpu_torch", (REPO / "tests" / "fixtures.py").read_text())
    exec(compile(source, "tests/fixtures.py", "exec"), module.__dict__)
    return module


def _workload(name, fixtures):
    from karpenter_tpu_torch.api.provisioner import Constraints
    from karpenter_tpu_torch.ops.encode import build_fleet, group_pods

    fixtures._counter[0] = 0
    pods = [pod for count, cpu, memory in SHAPES[name] for pod in fixtures.pods(count, cpu=cpu, memory=memory)]
    return pods, group_pods(pods), build_fleet(fixtures.size_ladder(8), Constraints(), pods)


def _signature(result):
    nodes = sorted(
        (packing.instance_type_options[0].name, packing.node_quantity, tuple(sorted(pod.name for pod in node)))
        for packing in result.packings for node in packing.pods_per_node
    )
    return json.dumps({"nodes": nodes, "unschedulable": sorted(p.name for p in result.unschedulable)})


def solve_record(name: str) -> dict:
    """One shape through the production path on the CPU (the caller's mesh,
    or none): the decoded plan of one dispatch, its LP, and the final plan
    of CostSolver.solve_encoded with its $/hr, as arrays."""
    pods, groups, fleet = _workload(name, _port_fixtures())
    handle = port_solver.cost_solve_dispatch(groups.vectors, groups.counts, fleet.capacity, fleet.total,
                                             fleet.prices, LP_STEPS, device="cpu")
    plan = port_solver.fetch_plan(handle)
    exchanges = collectives.EXCHANGES["exchanges"]
    result = port_solver.CostSolver(lp_steps=LP_STEPS, device="cpu").solve_encoded(groups, fleet)
    record = {f"ffd_{field}": np.asarray(getattr(plan.rounds_ffd, field)) for field in port_pack.PackRounds._fields}
    record.update({f"cost_{field}": np.asarray(getattr(plan.rounds_cost, field))
                   for field in port_pack.PackRounds._fields})
    record.update(
        feasible_any=np.asarray(plan.feasible_any), lp_objective=np.float32(plan.lp_objective),
        lp_assignment=plan.lp_assignment(), shards=np.int32(handle.shards),
        signature=np.array(_signature(result)), cost=np.float64(result.projected_cost()),
        node_count=np.int32(result.node_count), placed=np.int32(sum(len(p.pods) for p in result.packings)),
        pods=np.int32(len(pods)), exchanges=np.int32(collectives.EXCHANGES["exchanges"] - exchanges),
    )
    return record


def _order_dependent(shape, seed):
    """float32 parts whose sums depend on their order: magnitudes 1e-8 to
    1e8 with both signs."""
    rng = np.random.default_rng(seed)
    return (rng.choice([-1.0, 1.0], shape) * 10.0 ** rng.uniform(-8, 8, shape)).astype(np.float32)


COLLECTIVE_MESHES = {"2x2": (2, 2), "1x4": (1, 4), "4x1": (4, 1)}
COLLECTIVE_OPS = ("sum_over_types", "max_over_types", "sum_over_groups")


def collective_records(rank: int) -> dict:
    """Every collective on every mesh shape of COLLECTIVE_MESHES over 4
    shards, two a process: the cross-process result at this process's
    shards, and the one-process result of the same grid (every shard local)
    at the same shards."""
    out = {}
    for label, shape in COLLECTIVE_MESHES.items():
        shards = [port_mesh.Shard(i, torch.device("cpu"), i // 2) for i in range(4)]
        mesh = port_mesh.Mesh(shards, shape)
        alone = port_mesh.Mesh([port_mesh.Shard(i, torch.device("cpu"), 0) for i in range(4)], shape, rank=0)
        full = [[torch.from_numpy(_order_dependent((64,), 10 * r + c)) for c in range(shape[1])]
                for r in range(shape[0])]
        mine = [[full[r][c] if mesh.is_local(r * shape[1] + c) else None for c in range(shape[1])]
                for r in range(shape[0])]
        for op in COLLECTIVE_OPS:
            across = getattr(collectives, op)(mesh, mine)
            within = getattr(collectives, op)(alone, full)
            for r in range(shape[0]):
                for c in range(shape[1]):
                    if mesh.is_local(r * shape[1] + c):
                        out[f"{label}:{op}:{r}{c}:across"] = across[r][c].numpy()
                        out[f"{label}:{op}:{r}{c}:within"] = within[r][c].numpy()
        replicated = collectives.replicate(mesh, mine)
        out[f"{label}:replicate"] = torch.stack([replicated[r][c] for r in range(shape[0])
                                                 for c in range(shape[1])]).numpy()
        out[f"{label}:full"] = torch.stack([full[r][c] for r in range(shape[0]) for c in range(shape[1])]).numpy()
    return out


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _spawn_ranks(program: str, out_dir: Path):
    """Run `program` as ranks 0 and 1 of a gloo group; kill both past
    RANK_DEADLINE_S and fail with their output; else their outputs."""
    port = _free_port()
    env = {key: value for key, value in os.environ.items() if not key.startswith("KARPENTER_")}
    env.update(PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", KARPENTER_HOST_SOLVE="0")
    procs = [
        subprocess.Popen([sys.executable, "-c", program, str(rank), str(port), str(out_dir)],
                         env=env, cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)
    ]
    deadline = time.monotonic() + RANK_DEADLINE_S
    outputs = [""] * 2
    timed_out = False
    for index, proc in enumerate(procs):
        try:
            outputs[index], _ = proc.communicate(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            timed_out = True
            for other in procs:
                other.kill()
            outputs[index], _ = proc.communicate()
    for index, proc in enumerate(procs):
        if proc.poll() is None:
            proc.kill()
            outputs[index], _ = proc.communicate()
    if timed_out:
        pytest.fail("the ranks did not finish within their deadline (collective mismatch?):\n"
                    + "\n---\n".join(out[-3000:] for out in outputs))
    for rank, (proc, out) in enumerate(zip(procs, outputs)):
        assert proc.returncode == 0, f"rank {rank} failed (rc={proc.returncode}):\n{out[-3000:]}"
    return outputs


def test_production_solve_spans_two_processes(tmp_path, monkeypatch):
    outputs = _spawn_ranks(_SOLVE_PROGRAM, tmp_path)
    assert "lead done" in outputs[0]
    assert f"follower done after {2 * len(SHAPES)} solves" in outputs[1]
    across = np.load(tmp_path / "solves.npz")
    monkeypatch.setenv("KARPENTER_HOST_SOLVE", "0")
    with port_mesh.virtual_devices("cpu", 4):
        alone = {name: solve_record(name) for name in SHAPES}
    monkeypatch.setenv("KARPENTER_SHARDED_SOLVE", "0")
    for name in SHAPES:
        want = alone[name]
        assert int(want["shards"]) == 4 and int(want["exchanges"]) == 0
        assert int(across[f"{name}:shards"]) == 4
        # The demand crosses the processes a step; the LP's blocks, the
        # payload's segments once a solve.
        assert int(across[f"{name}:exchanges"]) == LP_STEPS + 1 + 2
        for key, value in want.items():
            if key != "exchanges":
                np.testing.assert_array_equal(across[f"{name}:{key}"], value, err_msg=f"{name}: {key}")
        assert int(want["placed"]) == int(want["pods"])
        # The decoded plans equal the reference's single-device solve.
        pods, groups, fleet = _workload(name, _port_fixtures())
        padded = port_solver.pad_kernel_args(groups.vectors, groups.counts, fleet.capacity, fleet.total,
                                             fleet.prices, g_mult=4, t_mult=2)
        ffd, cost, feasible, objective = _reference_single(padded, LP_STEPS)
        num_groups = groups.num_groups
        for prefix, rounds in (("ffd", ffd), ("cost", cost)):
            for field in port_pack.PackRounds._fields:
                np.testing.assert_array_equal(across[f"{name}:{prefix}_{field}"], np.asarray(getattr(rounds, field)),
                                              err_msg=f"{name}: {prefix} {field}")
        np.testing.assert_array_equal(across[f"{name}:feasible_any"], feasible)
        np.testing.assert_allclose(float(across[f"{name}:lp_objective"]), objective, rtol=LP_OBJECTIVE_RTOL)
        assert num_groups <= int(padded[0].shape[0])


def test_collectives_across_processes_equal_one_process(tmp_path):
    outputs = _spawn_ranks(_COLLECTIVES_PROGRAM, tmp_path)
    assert all("collectives done" in out for out in outputs)
    records = [np.load(tmp_path / f"collectives-{rank}.npz") for rank in range(2)]
    checked = 0
    for record in records:
        for key in record.files:
            if key.endswith(":across"):
                within = record[key.replace(":across", ":within")]
                assert record[key].tobytes() == within.tobytes(), key
                checked += 1
    # Two shards a process, both processes.
    assert checked == 2 * 2 * len(COLLECTIVE_MESHES) * len(COLLECTIVE_OPS)
    for label in COLLECTIVE_MESHES:
        for record in records:
            np.testing.assert_array_equal(record[f"{label}:replicate"], record[f"{label}:full"])
    # The inputs are order-dependent: summing a line the other way round
    # gives other bits, so equal bits above pin the order.
    parts = [_order_dependent((64,), seed) for seed in (0, 1, 10, 11)]
    forward = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    backward = ((parts[3] + parts[2]) + parts[1]) + parts[0]
    assert forward.tobytes() != backward.tobytes()
