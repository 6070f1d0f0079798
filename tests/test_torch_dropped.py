"""The definitions the port's trimmed copies had dropped, against the
reference on the same seeded inputs, on the CPU.

- The reference's own cases over the port (tests/port_twins.py): ffd.pack
  (tests/test_ffd.py's TestPack), certified_lp_floor (test_mix_pack.py's
  TestCertifiedLpFloor) and _cheapest_feasible_options (test_market.py's
  TestPoolOptions and TestLaunchEnvelope).
- Both packages on the main path's mix at 300 pods and 24 types
  (tests/test_torch_sidecar._problem): pack_rounds_dense with and without
  the quirk, bit for bit, also against the port's native packer;
  certified_lp_floor, the objective within 1e-9 relative and the same
  certificate; _cheapest_feasible_options, every row.
- lp_relax_solve, K3's entry on bare arrays, against the reference's on
  the LP problems of tests/test_torch_kernels.py, within K3's plain-version
  tolerances.
- compact_bytes for G 1 to 2,048, and fetch_bytes of a fused solve's fetch
  against it, as tests/test_device_residency.py holds the reference's.
- The sidecar without the native library: its host FFD rounds answer
  "host-greedy" as the reference's do, for an ffd request whose kernel
  rounds overflow and for a cost request that takes the host route.
"""

import numpy as np
import pytest
import torch

from karpenter_tpu.models import solver as ref_solver
from karpenter_tpu.ops import ffd as ref_ffd
from karpenter_tpu.ops import mix_pack as ref_mix
from karpenter_tpu.ops import native as ref_native
from karpenter_tpu.ops import pallas_kernels
from karpenter_tpu.ops import pack_kernel as ref_pk
from karpenter_tpu.ops import score_kernel as ref_score
from karpenter_tpu.solver_service import server as ref_server
from karpenter_tpu_torch.models import solver as port_solver
from karpenter_tpu_torch.ops import ffd as port_ffd
from karpenter_tpu_torch.ops import mix_pack as port_mix
from karpenter_tpu_torch.ops import native as port_native
from karpenter_tpu_torch.ops import pack_kernel as port_pk
from karpenter_tpu_torch.ops import score_kernel as port_score
from karpenter_tpu_torch.solver_service import server as port_server
from karpenter_tpu_torch.solver_service.client import RemoteSolver as PortRemoteSolver
from tests import port_twins
from tests.test_torch_kernels import (
    LP_ASSIGNMENT_ATOL,
    LP_OBJECTIVE_RTOL,
    LP_SEEDS,
    _feasible_any,
    _lp_problem,
)
from tests.test_torch_sidecar import _problem, assert_same_response

torch.set_num_threads(2)

FLOOR_RTOL = 1e-9
SEEDS = [0, 1]

_TWINS = port_twins.TwinPackage("port", "dropped")
TestPack = _TWINS.module("test_ffd").TestPack
TestCertifiedLpFloor = _TWINS.module("test_mix_pack").TestCertifiedLpFloor
_MARKET = _TWINS.module("test_market")
TestPoolOptions = _MARKET.TestPoolOptions
TestLaunchEnvelope = _MARKET.TestLaunchEnvelope


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    port_twins.cpu_by_default(monkeypatch)
    port_twins.reset_port_state()
    yield
    port_twins.reset_port_state()


def test_the_twins_run_the_port():
    assert TestPack.test_homogeneous_pods_single_type.__globals__["ffd"] is port_ffd
    assert TestCertifiedLpFloor.test_returns_none_on_empty_problem.__globals__["mix_pack"] is port_mix
    options = _MARKET._cheapest_feasible_options
    assert options is port_solver._cheapest_feasible_options


def _arrays(seed):
    groups, fleet = _problem("port", seed)
    return groups, fleet, groups.vectors, groups.counts, fleet.capacity, fleet.total


def _expanded(rounds):
    """(type, fill) a node, replications unrolled."""
    return [(int(t), np.asarray(fill, np.int64).tolist()) for t, fill, repl in rounds
            for _ in range(int(repl))]


@pytest.mark.parametrize("quirk", [False, True], ids=["plain", "quirk"])
@pytest.mark.parametrize("seed", SEEDS)
def test_pack_rounds_dense_matches_the_reference_and_the_native_packer(seed, quirk):
    _, _, vectors, counts, capacity, total = _arrays(seed)
    got_rounds, got_unschedulable = port_ffd.pack_rounds_dense(
        vectors, counts, capacity, total, quirk=quirk)
    want_rounds, want_unschedulable = ref_ffd.pack_rounds_dense(
        vectors, counts, capacity, total, quirk=quirk)
    assert len(got_rounds) > 0
    assert [(t, fill.dtype, fill.tolist(), repl) for t, fill, repl in got_rounds] == \
        [(t, fill.dtype, fill.tolist(), repl) for t, fill, repl in want_rounds]
    assert got_unschedulable.dtype == want_unschedulable.dtype
    assert np.array_equal(got_unschedulable, want_unschedulable)
    native = port_native.ffd_pack_rounds(vectors, counts.astype(np.int64), capacity, total,
                                         quirk=quirk)
    assert native is not None, "the port's host library did not build"
    assert _expanded(native[0]) == _expanded(got_rounds)
    assert np.array_equal(native[1], got_unschedulable)


def _pool_floor(fleet):
    """bench.py's pool_floor: each type's cheapest pool price."""
    _, pool_prices = port_solver._pool_price_matrix(fleet)
    return np.where(np.isfinite(pool_prices), pool_prices, np.inf).min(axis=1)


@pytest.mark.parametrize("seed", SEEDS)
def test_certified_lp_floor_matches_the_reference(seed):
    _, fleet, vectors, counts, capacity, _ = _arrays(seed)
    pool_floor = _pool_floor(fleet)
    got = port_mix.certified_lp_floor(vectors, counts, capacity, pool_floor)
    want = ref_mix.certified_lp_floor(vectors, counts, capacity, pool_floor)
    assert got is not None and want is not None
    assert got[1] == want[1]
    np.testing.assert_allclose(got[0], want[0], rtol=FLOOR_RTOL)
    # A certified floor lies below the port's own plan.
    if got[1]:
        plan = port_solver.CostSolver(device="cpu").solve_encoded(*_problem("port", seed))
        assert got[0] <= plan.projected_cost() * (1 + 1e-6)


@pytest.mark.parametrize("seed", SEEDS)
def test_cheapest_feasible_options_match_the_reference(seed):
    port_groups, port_fleet = _problem("port", seed)
    ref_groups, ref_fleet = _problem("reference", seed)
    rng = np.random.default_rng(seed)
    for t in rng.integers(0, port_fleet.capacity.shape[0], 6):
        fill = np.zeros(port_groups.num_groups, np.int64)
        fill[rng.integers(0, port_groups.num_groups)] = int(rng.integers(1, 4))
        got = port_solver._cheapest_feasible_options(fill, int(t), port_groups, port_fleet)
        want = ref_solver._cheapest_feasible_options(fill, int(t), ref_groups, ref_fleet)
        assert got[0] == want[0]
        rows = [[(o.instance_type.name, o.zone, o.price, o.priority) for o in options or []]
                for options in (got[1], want[1])]
        assert rows[0] == rows[1]
        assert (got[1] is None) == (want[1] is None)


def _lp_inputs(seed):
    problem = _lp_problem(seed)
    vectors, counts, capacity, _, valid, prices = problem
    effective = np.asarray(
        pallas_kernels._dominance_prices_ref(capacity, np.where(valid, prices, np.inf))
    ).astype(np.float32)
    solvable = np.where(_feasible_any(problem), counts, 0).astype(np.int32)
    return vectors, solvable, capacity, valid, effective


@pytest.mark.parametrize("seed", LP_SEEDS)
def test_lp_relax_solve_matches_the_reference(seed):
    inputs = _lp_inputs(seed)
    before = port_score.lp_relax.launches
    got = port_score.lp_relax_solve(*inputs, steps=300, device="cpu")
    assert port_score.lp_relax.launches == before  # the plain version on the CPU
    want = ref_score.lp_relax_solve(*inputs, steps=300)
    np.testing.assert_allclose(float(got.objective), float(want.objective), rtol=LP_OBJECTIVE_RTOL)
    np.testing.assert_allclose(got.assignment.numpy(), np.asarray(want.assignment), rtol=0,
                               atol=LP_ASSIGNMENT_ATOL)
    # The same as K3's plain version on tensors.
    plain = port_score.lp_relax_body(*(torch.from_numpy(a) for a in inputs), steps=300)
    for field, a, b in zip(plain._fields, got, plain):
        assert torch.equal(a, b), field


def test_lp_relax_solve_takes_counts_of_any_integer_type():
    vectors, solvable, capacity, valid, effective = _lp_inputs(0)
    wide = port_score.lp_relax_solve(vectors, solvable.astype(np.int64), capacity, valid,
                                     effective, steps=20, device="cpu")
    narrow = port_score.lp_relax_solve(vectors, solvable, capacity, valid, effective, steps=20,
                                       device="cpu")
    assert torch.equal(wide.assignment, narrow.assignment)


@pytest.mark.skipif(torch.cuda.is_available(), reason="asks for the card where there is none")
def test_lp_relax_solve_without_a_device_asks_for_the_card(monkeypatch):
    monkeypatch.undo()  # the module's own default, not cpu_by_default's
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_score.lp_relax_solve(*_lp_inputs(0))


@pytest.mark.parametrize("groups", [1, 16, 512, 2048])
def test_compact_bytes_match_the_reference(groups):
    assert port_pk.compact_bytes(groups) == ref_pk.compact_bytes(groups)
    assert port_pk.compact_bytes(groups) == 4 * port_pk.compact_words(groups) + 4


@pytest.mark.parametrize("seed", SEEDS)
def test_fetch_bytes_of_the_fused_solve_are_the_shape_math(seed):
    _, fleet, vectors, counts, capacity, total = _arrays(seed)
    handle = port_solver.cost_solve_dispatch(vectors, counts, capacity, total, fleet.prices, 8,
                                             device="cpu")
    port_solver.LAST_FETCH_BYTES = 0
    plan = port_solver.fetch_plan(handle)
    assert plan.rounds_ffd.num_rounds > 0
    assert handle.shards == 1
    assert port_solver.LAST_FETCH_BYTES == port_pk.fetch_bytes([handle.compact, handle.objective])
    assert port_solver.LAST_FETCH_BYTES == port_pk.compact_bytes(handle.num_groups)
    assert port_solver.fetch_bytes is port_pk.fetch_bytes
    # The acceptance bar of the reference: 50k pods / 400 types = a 16-group bucket.
    assert port_pk.compact_bytes(16) <= 4096


def test_fetch_bytes_of_a_batch_count_every_handle():
    handles = []
    for seed in SEEDS:
        _, fleet, vectors, counts, capacity, total = _arrays(seed)
        handles.append(port_solver.cost_solve_dispatch(vectors, counts, capacity, total,
                                                       fleet.prices, 8, device="cpu"))
    port_solver.fetch_plans(handles)
    assert port_solver.LAST_FETCH_BYTES == sum(
        port_pk.compact_bytes(handle.num_groups) for handle in handles)


def _overflowing(to_host):
    def wrapped(rounds):
        return to_host(rounds)._replace(overflow=np.bool_(True))
    return wrapped


@pytest.mark.parametrize("mode,quirk", [("cost", False), ("ffd", False), ("ffd", True)],
                         ids=["cost", "ffd", "ffd-quirk"])
@pytest.mark.parametrize("seed", SEEDS)
def test_sidecar_answers_host_greedy_without_the_native_library(mode, quirk, seed, monkeypatch):
    """The sidecar's last resort, _host_rounds, with no native library:
    the port's server answers as the reference's."""
    monkeypatch.setenv("KARPENTER_HOST_SOLVE", "0")
    monkeypatch.setenv("KARPENTER_SHARDED_SOLVE", "0")
    for native in (port_native, ref_native):
        monkeypatch.setattr(native, "load", lambda: None)
    for solvers in (port_solver, ref_solver):
        if mode == "cost":  # no candidate packing: the host route
            monkeypatch.setattr(solvers, "cost_solve_dense", lambda *args, **kwargs: None)
        else:  # the kernel ran out of rounds
            monkeypatch.setattr(solvers, "_to_host", _overflowing(solvers._to_host))
    client = PortRemoteSolver("127.0.0.1:1", mode=mode, quirk=quirk)
    try:
        request, _ = client._build_request(*_problem("port", seed))
    finally:
        client.close()
    got = port_server._Handler(torch.device("cpu"))._solve(request, None)
    want = ref_server._Handler()._solve(request, None)
    assert got.solver == "host-greedy" and got.fallback
    assert len(got.rounds) > 0
    assert_same_response(got, want)
