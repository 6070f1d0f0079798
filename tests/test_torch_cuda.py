"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card.

Every test here needs a Hopper card and skips without one. The file imports
neither JAX nor the reference package, so it runs where the card is:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(--noconftest: tests/conftest.py sets up the JAX reference's virtual CPU
mesh, which this file does not use.)
"""

import numpy as np
import pytest
import torch

import chip_smoke
from karpenter_tpu_torch.api.pods import PodSpec
from karpenter_tpu_torch.api.provisioner import Constraints
from karpenter_tpu_torch.cloudprovider import InstanceType, Offering
from karpenter_tpu_torch.convert import fused_args_from_numpy
from karpenter_tpu_torch.models import solver
from karpenter_tpu_torch.ops import consolidate, consolidate_kernel, cuda_kernels, pack_kernel, score_kernel
from karpenter_tpu_torch.ops.encode import build_fleet, group_pods

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

# K1 and K2 run the same fp32 arithmetic as their plain versions
# (bit-identical). K3 and the plain LP take their softmax and einsum sums in
# other orders, so over 300 Adam steps they drift apart by rounding: the
# objective agrees to rtol 1e-4, each assignment cell to 1e-3 pods (the CPU
# parity test's tolerances, tests/test_torch_kernels.py).
LP_OBJECTIVE_RTOL = 1e-4
LP_ASSIGNMENT_ATOL = 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU build")
    return torch.device("cuda")


def _dominance_cases():
    rng = np.random.default_rng(3)
    yield np.zeros((1, 8), np.float32), np.array([1.5], np.float32)
    ladder = np.arange(1, 9, dtype=np.float32)[:, None] * np.ones((1, 8), np.float32)
    yield ladder, (0.1 * np.arange(1, 9)).astype(np.float32)
    for num_types in (2, 39, 129, 512):
        capacity = rng.integers(0, 6, (num_types, 8)).astype(np.float32)
        prices = rng.choice([0.25, 0.5, 1.0], num_types).astype(np.float32)
        invalid = rng.random(num_types) < 0.2
        capacity[invalid] = 0.0
        yield capacity, np.where(invalid, np.inf, prices).astype(np.float32)
    yield np.zeros((5, 8), np.float32), np.full(5, np.inf, np.float32)


DOMINANCE_CASES = list(_dominance_cases())


@pytest.mark.parametrize("case", DOMINANCE_CASES, ids=[f"T{c[0].shape[0]}-{i}" for i, c in enumerate(DOMINANCE_CASES)])
def test_dominance_kernel_equals_plain_version(case, cuda_device):
    capacity, prices = (torch.from_numpy(a).to(cuda_device) for a in case)
    before = cuda_kernels.dominance_prices.launches
    got = cuda_kernels.dominance_prices(capacity, prices)
    torch.cuda.synchronize()
    assert cuda_kernels.dominance_prices.launches == before + 1
    assert torch.equal(got, cuda_kernels._dominance_prices_ref(capacity, prices))


def _pack_problem(seed, num_groups, num_types):
    rng = np.random.default_rng(seed)
    real_groups = int(rng.integers(1, num_groups + 1))
    vectors = np.zeros((num_groups, 8), np.float32)
    vectors[:real_groups, 0] = np.sort(rng.integers(1, 17, real_groups))[::-1] * 250
    vectors[:real_groups, 1] = rng.integers(1, 33, real_groups) * 256
    vectors[:real_groups, 2] = 1
    if seed % 2:
        vectors[0, 0] = 70_000  # fits no type: retired as unschedulable
    counts = np.zeros(num_groups, np.int32)
    counts[:real_groups] = rng.integers(1, 3000, real_groups)
    real_types = int(rng.integers(1, num_types + 1))
    cpu = np.sort(rng.integers(1, 65, real_types)) * 1000.0
    capacity = np.zeros((num_types, 8), np.float32)
    capacity[:real_types, 0] = cpu - 100
    capacity[:real_types, 1] = cpu * rng.choice([2.0, 4.0, 8.0], real_types) - 600
    capacity[:real_types, 2] = 110
    valid = np.zeros(num_types, bool)
    valid[:real_types] = True
    prices = np.full(num_types, np.inf, np.float32)
    prices[:real_types] = cpu / 1000 * rng.uniform(0.03, 0.05, real_types)
    return vectors, counts, capacity, capacity.copy(), valid, prices


# (32, 512) needs more than 48 KB of shared memory; (64, 1024) and
# (64, 2048) put the fills in global scratch; (16, 300) leaves 20 threads of
# the block without a type; (16, 1024) fills a block of 1,024 threads, one
# type each; (64, 2048) gives each thread two types.
PACK_SHAPES = [(8, 8), (16, 64), (16, 300), (16, 512), (32, 512), (16, 1024), (64, 1024), (64, 2048)]


@pytest.mark.parametrize("mode", ["ffd", "cost"])
@pytest.mark.parametrize("shape", PACK_SHAPES, ids=lambda s: f"G{s[0]}xT{s[1]}")
@pytest.mark.parametrize("seed", [0, 1])
def test_pack_kernel_equals_plain_version(seed, shape, mode, cuda_device):
    args = fused_args_from_numpy(*_pack_problem(seed, *shape), device=cuda_device)
    got = pack_kernel.pack_kernel(*args, mode=mode)
    pair = pack_kernel.pack_kernel_pair(*args)[("ffd", "cost").index(mode)]
    want = pack_kernel._pack_kernel_ref(*args, mode=mode)
    torch.cuda.synchronize()
    for field, a, b, c in zip(want._fields, got, pair, want):
        assert torch.equal(a, c), field
        assert torch.equal(b, c), field


def test_pack_shapes_cover_every_plan(cuda_device):
    """The shapes above reach one, two types a thread, a ragged last warp,
    the fills in shared memory and in global scratch; the plan's shared
    bytes are the kernel's."""
    lib = pack_kernel.LIBRARY.load()
    plans = [pack_kernel.pack_launch_plan(g, t, 8) for g, t in PACK_SHAPES]
    assert {plan.types_per_thread for plan in plans} >= {1, 2}
    assert {plan.fills_in_shared for plan in plans} == {True, False}
    assert any(plan.threads * plan.types_per_thread > t for plan, (_, t) in zip(plans, PACK_SHAPES))
    for plan, (g, t) in zip(plans, PACK_SHAPES):
        assert lib.ktt_pack_rounds_shared_bytes(
            g, t, 8, int(plan.fills_in_shared), int(plan.tables_in_shared)) == plan.shared_bytes


@pytest.mark.parametrize("shape", [(16, 300), (16, 512), (64, 1024)], ids=lambda s: f"G{s[0]}xT{s[1]}")
def test_pack_kernel_is_deterministic(shape, cuda_device):
    args = fused_args_from_numpy(*_pack_problem(1, *shape), device=cuda_device)
    first = pack_kernel.pack_kernel_pair(*args)
    second = pack_kernel.pack_kernel_pair(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert chip_smoke.rounds_equal(a, b)


def _quirk_problem(name):
    """K2q's card cases: the exact-fit case (a 1.5-pod pairs with a 0.5-pod,
    the reason for the quirk's replication rule), random problems at G 16,
    padded G 2,048 (the fills in global scratch) and padded G 8,192 (the
    tables too)."""
    if name == "exact_fit":
        pods, catalog = [(p, c) for n, p, c in chip_smoke.go_parity_cases() if n == "exact_fit"][0]
        return chip_smoke.encoded_problem(pods, catalog)
    if name == "G2048":
        return chip_smoke.sparse_pack_problem(3, 2048, 512, 200)
    if name == "G8192":
        return chip_smoke.sparse_pack_problem(4, 8192, 64, 40)
    return _pack_problem(int(name[-1]), 16, 512)


# Padded G 2,048 and 8,192 in ffd mode alone, the Go-parity solver's.
QUIRK_CASES = [(name, mode) for name in ("exact_fit", "G16-seed0", "G16-seed1") for mode in ("ffd", "cost")]
QUIRK_CASES += [("G2048", "ffd"), ("G8192", "ffd")]


@pytest.mark.parametrize("name,mode", QUIRK_CASES, ids=[f"{n}-{m}" for n, m in QUIRK_CASES])
def test_pack_kernel_quirk_equals_plain_version(name, mode, cuda_device):
    args = fused_args_from_numpy(*_quirk_problem(name), device=cuda_device)
    before = pack_kernel.pack_kernel.quirk_launches
    got = pack_kernel.pack_kernel(*args, quirk=True, mode=mode)
    want = pack_kernel._pack_kernel_ref(*args, quirk=True, mode=mode)
    torch.cuda.synchronize()
    assert pack_kernel.pack_kernel.quirk_launches == before + 1
    for field, a, b in zip(want._fields, got, want):
        assert torch.equal(a, b), field
    if name == "G2048":
        assert not pack_kernel.pack_launch_plan(2048, 512, 8).fills_in_shared
    if name == "G8192":
        assert not pack_kernel.pack_launch_plan(8192, 64, 8).tables_in_shared


@pytest.mark.parametrize("name", ["homogeneous", "size_ladder", "mixed_shapes", "exact_fit"])
def test_go_parity_solver_matches_greedy_on_the_card(name, cuda_device):
    """The reference's tests/test_pack_kernel.py parity shapes: the Go-parity
    solver on the card (K2q) places node for node what GreedySolver does."""
    pods, catalog = [(p, c) for n, p, c in chip_smoke.go_parity_cases() if n == name][0]
    fallbacks = solver.TPUSolver.host_fallbacks
    got = solver.TPUSolver(mode="ffd", quirk=True, device=cuda_device).solve(pods, catalog, Constraints())
    want = solver.GreedySolver().solve(pods, catalog, Constraints())
    assert chip_smoke.go_parity_signature(got) == chip_smoke.go_parity_signature(want)
    assert solver.TPUSolver.host_fallbacks == fallbacks
    if name == "exact_fit":
        assert got.node_count == chip_smoke.GO_PARITY_EXACT_FIT_NODES


def _workload(num_pods=2000, num_types=40, seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(int(rng.integers(1, 17)) * 250, int(rng.integers(1, 33)) * 256) for _ in range(16)]
    weights = 1.0 / np.arange(1, 17)
    counts = (weights / weights.sum() * num_pods).astype(int)
    counts[0] += num_pods - counts.sum()
    pods = [
        PodSpec(name=f"pod-{k}-{i}", requests={"cpu": f"{cpu}m", "memory": f"{mem}Mi"})
        for k, ((cpu, mem), count) in enumerate(zip(shapes, counts))
        for i in range(count)
    ]
    catalog = []
    for idx in range(num_types):
        size = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)[(idx // 4) % 10]
        mem_per_cpu, base = ((2.0, 0.17), (4.0, 0.192), (8.0, 0.252), (16.0, 0.333))[idx % 4]
        cpu = 2 * size
        offerings = []
        for zone in ("z-1a", "z-1b", "z-1c"):
            offerings.append(Offering(zone=zone, capacity_type="on-demand", price=base * size))
            offerings.append(
                Offering(zone=zone, capacity_type="spot", price=base * size * float(rng.uniform(0.25, 0.75)))
            )
        catalog.append(
            InstanceType(
                name=f"t{idx}.{size}x",
                capacity={"cpu": cpu, "memory": f"{int(cpu * mem_per_cpu)}Gi", "pods": 110},
                overhead={"cpu": "100m", "memory": "455Mi"},
                offerings=offerings,
            )
        )
    return pods, catalog


def test_fused_body_on_card_equals_cpu(cuda_device):
    pods, catalog = _workload()
    groups = group_pods(pods)
    fleet = build_fleet(catalog, Constraints(), pods)
    padded = solver.pad_kernel_args(groups.vectors, groups.counts, fleet.capacity, fleet.total, fleet.prices)
    card = solver._cost_fused_body(*fused_args_from_numpy(*padded, device=cuda_device), lp_steps=300)
    cpu = solver._cost_fused_body(*fused_args_from_numpy(*padded, device="cpu"), lp_steps=300)
    assert torch.equal(card[0].cpu(), cpu[0])  # compact payload, word for word
    assert torch.equal(card[2].cpu(), cpu[2])  # dense spill
    np.testing.assert_allclose(card[1].cpu().numpy(), cpu[1].numpy(), rtol=LP_OBJECTIVE_RTOL)


def test_cost_solver_on_card_equals_cpu(cuda_device, monkeypatch):
    monkeypatch.setenv("KARPENTER_HOST_SOLVE", "0")
    pods, catalog = _workload(seed=1)
    before = (
        cuda_kernels.dominance_prices.launches,
        pack_kernel.pack_kernel.launches,
        score_kernel.lp_relax.launches,
    )
    compact_before = pack_kernel.compact_plan.launches
    got = solver.CostSolver(device="cuda").solve(pods, catalog, Constraints())
    assert cuda_kernels.dominance_prices.launches == before[0] + 1
    assert pack_kernel.pack_kernel.launches == before[1] + 1
    assert score_kernel.lp_relax.launches == before[2] + 1
    assert pack_kernel.compact_plan.launches == compact_before + 1
    want = solver.CostSolver(device="cpu").solve(pods, catalog, Constraints())
    placed = [pod.uid for p in got.packings for node in p.pods_per_node for pod in node]
    assert not got.unschedulable and sorted(placed) == sorted(pod.uid for pod in pods)
    assert got.node_count == want.node_count
    np.testing.assert_allclose(got.projected_cost(), want.projected_cost(), rtol=1e-4)


# The non-degenerate LP family of tests/test_torch_kernels.py, padded out to
# each shape with zero-count groups and invalid types as the bucket padding
# pads the main path's 400 types to 512 (chip_smoke.lp_inputs; at many valid
# types the family's prices per core crowd together and the LP turns
# degenerate, PERF.md §6). The plan's rule gives clusters of 2 ((8, 16),
# (16, 64)), 4 ((16, 128)), 8 ((16, 256)) and 16 ((16, 512) the main path's
# shape, (16, 300) whose last block owns fewer types, G 1, G 32, G 64 and
# (16, 1024)), the state in shared memory; (128, 2048) puts it in global
# scratch.
LP_SHAPES = [(8, 16), (16, 64), (16, 128), (16, 256), (16, 300), (16, 512), (1, 512),
             (32, 512), (64, 512), (16, 1024), (128, 2048)]


def test_lp_shapes_cover_every_plan(cuda_device):
    """Every cluster size the rule can choose, both storage paths, a T the
    blocks do not divide evenly; the plan's shared bytes are the kernel's."""
    lib = score_kernel.LIBRARY.load()
    plans = [score_kernel.lp_launch_plan(g, t, 8) for g, t in LP_SHAPES]
    assert {plan.cluster for plan in plans} == {2, 4, 8, 16}
    assert {plan.state_in_shared for plan in plans} == {True, False}
    assert any(t % plan.types_per_block for plan, (_, t) in zip(plans, LP_SHAPES))
    for plan, (g, _) in zip(plans, LP_SHAPES):
        args = (g, 8, plan.types_per_block, plan.threads, plan.group_lanes)
        assert lib.ktt_lp_relax_shared_bytes(
            *args, plan.cluster, int(plan.state_in_shared), int(plan.tables_in_shared)) == plan.shared_bytes
        assert lib.ktt_lp_relax_state_bytes(*args) == plan.state_bytes


def _assert_lp_close(got, want):
    np.testing.assert_allclose(
        float(got.objective), float(want.objective), rtol=LP_OBJECTIVE_RTOL
    )
    np.testing.assert_allclose(
        got.assignment.cpu().numpy(), want.assignment.cpu().numpy(),
        rtol=0, atol=LP_ASSIGNMENT_ATOL,
    )
    np.testing.assert_allclose(
        got.fractional_nodes.cpu().numpy(), want.fractional_nodes.cpu().numpy(),
        rtol=0, atol=LP_ASSIGNMENT_ATOL,
    )


@pytest.mark.parametrize("shape", LP_SHAPES, ids=lambda s: f"G{s[0]}xT{s[1]}")
@pytest.mark.parametrize("seed", chip_smoke.LP_SEEDS)
def test_lp_kernel_equals_plain_version(seed, shape, cuda_device):
    args = chip_smoke.lp_inputs(seed, shape, cuda_device)
    before = score_kernel.lp_relax.launches
    got = score_kernel.lp_relax(*args, steps=300)
    want = score_kernel.lp_relax_body(*args, steps=300)
    torch.cuda.synchronize()
    assert score_kernel.lp_relax.launches == before + 1
    _assert_lp_close(got, want)


@pytest.mark.parametrize("cluster", [2, 4, 8, 16])
@pytest.mark.parametrize("seed", chip_smoke.LP_SEEDS[:3])
def test_lp_kernel_at_every_cluster_size(seed, cluster, cuda_device):
    """The main path's shape spread over each cluster size the card takes."""
    args = chip_smoke.lp_inputs(seed, (16, 512), cuda_device)
    plan = score_kernel.lp_plan_for_cluster(16, 512, 8, cluster)
    got = score_kernel._launch(*args, 300, plan)
    want = score_kernel.lp_relax_body(*args, steps=300)
    torch.cuda.synchronize()
    _assert_lp_close(got, want)


@pytest.mark.parametrize("shape", [(16, 300), (16, 512), (128, 2048)], ids=lambda s: f"G{s[0]}xT{s[1]}")
def test_lp_kernel_is_deterministic(shape, cuda_device):
    """The blocks combine their partials in rank order: two launches on the
    same inputs give the same bits."""
    args = chip_smoke.lp_inputs(0, shape, cuda_device)
    first = score_kernel.lp_relax(*args, steps=300)
    second = score_kernel.lp_relax(*args, steps=300)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_cost_solve_dispatch_does_not_sync(cuda_device):
    pods, catalog = _workload(seed=2)
    groups = group_pods(pods)
    fleet = build_fleet(catalog, Constraints(), pods)
    args = (groups.vectors, groups.counts, fleet.capacity, fleet.total, fleet.prices)
    warm = solver.fetch_plan(solver.cost_solve_dispatch(*args, device=cuda_device))
    torch.cuda.synchronize()
    before = pack_kernel.compact_plan.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        handle = solver.cost_solve_dispatch(*args, device=cuda_device)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert pack_kernel.compact_plan.launches == before + 1
    plan = solver.fetch_plan(handle)
    assert int(plan.rounds_cost.num_rounds) == int(warm.rounds_cost.num_rounds)
    np.testing.assert_allclose(plan.lp_objective, warm.lp_objective, rtol=0)


# --- K4: the plan compaction ----------------------------------------------------


# G = 8 and 16 fit one tile of the kernel's 256 threads per block only at low
# density; 64 and 1024 (MAX_GROUPS) take 35 and 8,224 tiles.
@pytest.mark.parametrize("num_groups,density", [(8, 0.05), (16, 0.1), (16, 0.9), (64, 0.02), (64, 0.5), (1024, 0.001)])
def test_compact_kernel_word_identical_to_plain_version(num_groups, density, cuda_device):
    ffd = chip_smoke.dense_rounds(num_groups, 0, density, cuda_device)
    cost = chip_smoke.dense_rounds(num_groups, 1, density, cuda_device)
    feasible = torch.from_numpy(np.random.default_rng(2).random(num_groups) < 0.7).to(cuda_device)
    before = pack_kernel.compact_plan.launches
    got = pack_kernel.compact_plan(ffd, cost, feasible)
    want = pack_kernel._compact_plan_ref(ffd, cost, feasible)
    torch.cuda.synchronize()
    assert pack_kernel.compact_plan.launches == before + 1
    assert torch.equal(got, want)
    assert pack_kernel.COMPACT_LIBRARY.load().ktt_compact_words(num_groups) == want.shape[0]


def test_compact_kernel_on_pack_rounds(cuda_device):
    for seed, shape in enumerate(PACK_SHAPES):
        args = fused_args_from_numpy(*_pack_problem(seed, *shape), device=cuda_device)
        ffd, cost = pack_kernel.pack_kernel_pair(*args)
        feasible = score_kernel.feasibility_mask(args[0], args[2], args[4]).any(dim=1)
        got = pack_kernel.compact_plan(ffd, cost, feasible)
        torch.cuda.synchronize()
        assert torch.equal(got, pack_kernel._compact_plan_ref(ffd, cost, feasible)), shape


def test_compact_kernel_rejects_bad_arguments(cuda_device):
    ffd = chip_smoke.dense_rounds(8, 0, 0.1, cuda_device)
    feasible = torch.ones(8, dtype=torch.bool, device=cuda_device)
    with pytest.raises(TypeError):
        pack_kernel.compact_plan(ffd, ffd, feasible.to(torch.int32))
    with pytest.raises(ValueError):
        pack_kernel.compact_plan(ffd._replace(round_repl=ffd.round_repl.long()), ffd, feasible)
    with pytest.raises(ValueError):
        pack_kernel.compact_plan(ffd, ffd, feasible.cpu())


# --- K7: the consolidation counterfactual --------------------------------------


def _assert_k7_equals_plain(operands, axes=None):
    before = consolidate_kernel.solve_counterfactuals.launches
    takes, eager = consolidate_kernel.solve_counterfactuals(*operands, axes=axes)
    want = consolidate_kernel._counterfactual_ref(*operands)
    torch.cuda.synchronize()
    assert consolidate_kernel.solve_counterfactuals.launches == before + 1
    assert torch.equal(takes, want[0])
    assert torch.equal(eager, consolidate_kernel._eager_from_outputs(*want[1:]))


K7_PROBLEMS = list(chip_smoke.k7_problems())


@pytest.mark.parametrize("name,arrays", K7_PROBLEMS, ids=[name for name, _ in K7_PROBLEMS])
def test_counterfactual_kernel_equals_plain_version(name, arrays, cuda_device):
    operands, axes = chip_smoke.k7_inputs(consolidate.ConsolidationProblem(**arrays), cuda_device)
    _assert_k7_equals_plain(operands, axes)
    # A room sized for every axis gives the same bits.
    _assert_k7_equals_plain(operands)


def test_counterfactual_kernel_flags_a_room_sized_too_small(cuda_device):
    operands, axes = chip_smoke.k7_inputs(
        consolidate.ConsolidationProblem(**dict(K7_PROBLEMS)["N8192-3-axes"]), cuda_device)
    assert axes == 3
    _, eager = consolidate_kernel.solve_counterfactuals(*operands, axes=axes - 1)
    assert int(eager[3 * operands[0].shape[0]]) == -1


def test_k7_problems_cover_both_room_paths(cuda_device):
    lib = consolidate_kernel.LIBRARY.load()
    threads = lib.ktt_consolidate_threads(8192)
    assert 4 * threads * lib.ktt_consolidate_room_words(8192, 3) <= consolidate_kernel._SHARED_ROOM_LIMIT
    assert 4 * threads * lib.ktt_consolidate_room_words(8192, 8) > consolidate_kernel._SHARED_ROOM_LIMIT


@pytest.fixture(scope="module")
def cluster_problem():
    """chip_smoke's real-size sweep: 5,000 nodes, 64 candidates, padded to
    C 64, G 16, N 8192, T 512."""
    package = chip_smoke.port_package()
    catalog = chip_smoke.make_catalog(package=package)
    shapes = chip_smoke.pod_shapes(0)
    vectors = chip_smoke.shape_vectors(shapes, package)
    cluster = chip_smoke.make_cluster(chip_smoke.usable_capacity(catalog, package), vectors)
    return chip_smoke.consolidation_problem(cluster, catalog, shapes, package)


def test_counterfactual_kernel_at_real_size(cluster_problem, cuda_device):
    problem = cluster_problem[0]
    operands, axes = chip_smoke.k7_inputs(problem, cuda_device)
    assert tuple(operands[0].shape) == (64, 16, 8)
    assert operands[2].shape[0] == 8192 and operands[4].shape[0] == 512
    # The real pods request cpu, memory and pods: the room fits in shared
    # memory, and no scratch is needed.
    lib = consolidate_kernel.LIBRARY.load()
    assert axes == 3
    assert 4 * lib.ktt_consolidate_threads(8192) * lib.ktt_consolidate_room_words(8192, axes) \
        <= consolidate_kernel._SHARED_ROOM_LIMIT
    _assert_k7_equals_plain(operands, axes)


def test_solve_candidates_on_card_equals_cpu(cluster_problem, cuda_device):
    problem, members = cluster_problem[:2]
    before = consolidate_kernel.solve_counterfactuals.launches
    got = consolidate.solve_candidates(problem, device="cuda")
    assert consolidate_kernel.solve_counterfactuals.launches == before + 1
    want = consolidate.solve_candidates(problem, device="cpu")
    for name in ("delete_ok", "replace_type", "replace_price", "savings", "action"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    best = got.best()
    assert best >= 0
    np.testing.assert_array_equal(got.take_row(best), want.take_row(best))
    np.testing.assert_array_equal(got.delete_take, want.delete_take)
    assert consolidate.delete_assignment(got, best, members[best]) == consolidate.delete_assignment(
        want, best, members[best])


# --- past the old limits: K2 and K3 take any size --------------------------

# (G, T, real groups): padded G 2,048 at the main path's T (K2's fills in
# global scratch, K3 at its smallest block), T 8,192 (K2 streams eight types
# a thread), G 8,192 at T 1,024 (K2's tables in global scratch).
LARGE_PACK_SHAPES = [(2048, 512, 200), (16, 8192, 16), (8192, 1024, 60)]


@pytest.mark.parametrize("mode", ["ffd", "cost"])
@pytest.mark.parametrize("shape", LARGE_PACK_SHAPES, ids=lambda s: f"G{s[0]}xT{s[1]}")
def test_pack_kernel_past_the_old_limits(shape, mode, cuda_device):
    groups, types, real = shape
    args = fused_args_from_numpy(*chip_smoke.sparse_pack_problem(2, groups, types, real), device=cuda_device)
    got = pack_kernel.pack_kernel(*args, mode=mode)
    want = pack_kernel._pack_kernel_ref(*args, mode=mode)
    torch.cuda.synchronize()
    assert chip_smoke.rounds_equal(got, want)


def test_large_pack_shapes_cover_the_new_paths(cuda_device):
    lib = pack_kernel.LIBRARY.load()
    plans = [pack_kernel.pack_launch_plan(g, t, 8) for g, t, _ in LARGE_PACK_SHAPES]
    assert {plan.tables_in_shared for plan in plans} == {True, False}
    assert max(plan.types_per_thread for plan in plans) == 8
    for plan, (g, t, _) in zip(plans, LARGE_PACK_SHAPES):
        assert lib.ktt_pack_rounds_shared_bytes(
            g, t, 8, int(plan.fills_in_shared), int(plan.tables_in_shared)) == plan.shared_bytes
        assert lib.ktt_pack_rounds_table_words(g, t, 8) == pack_kernel.pack_table_words(g, t, 8)


# Padded G 2,048 at T 512 (the tables in shared memory at the smallest
# block) and at T 2,048, G 4,096 at T 16 (the group tables in global
# scratch), T 8,192 (cluster 16, 512 types a block).
LARGE_LP_SHAPES = [(2048, 512), (2048, 2048), (4096, 16), (16, 8192)]


@pytest.mark.parametrize("shape", LARGE_LP_SHAPES, ids=lambda s: f"G{s[0]}xT{s[1]}")
def test_lp_kernel_past_the_old_limits(shape, cuda_device):
    args = chip_smoke.lp_inputs(chip_smoke.LP_SEEDS[0], shape, cuda_device)
    got = score_kernel.lp_relax(*args, steps=300)
    want = score_kernel.lp_relax_body(*args, steps=300)
    torch.cuda.synchronize()
    _assert_lp_close(got, want)


def test_large_lp_shapes_cover_the_new_paths(cuda_device):
    lib = score_kernel.LIBRARY.load()
    plans = [score_kernel.lp_launch_plan(g, t, 8) for g, t in LARGE_LP_SHAPES]
    assert {plan.tables_in_shared for plan in plans} == {True, False}
    for plan, (g, _) in zip(plans, LARGE_LP_SHAPES):
        args = (g, 8, plan.types_per_block, plan.threads, plan.group_lanes)
        assert lib.ktt_lp_relax_shared_bytes(
            *args, plan.cluster, int(plan.state_in_shared), int(plan.tables_in_shared)) == plan.shared_bytes
        if not plan.tables_in_shared:
            assert lib.ktt_lp_relax_table_bytes(*args, plan.cluster) == plan.table_bytes


# --- K6: the constrained [L, G', T] dispatch ---------------------------------

K6_CASES = list(chip_smoke.k6_cases())


@pytest.mark.parametrize("name,operands,mode", K6_CASES, ids=[name for name, _, _ in K6_CASES])
def test_levels_kernel_equals_plain_version(name, operands, mode, cuda_device):
    from karpenter_tpu_torch.convert import upload_packed

    tensors = upload_packed(list(operands), cuda_device)
    before = pack_kernel.pack_kernel_levels.launches
    got = pack_kernel.pack_kernel_levels(*tensors, mode=mode)
    want = chip_smoke.plain_levels(tensors, mode)
    torch.cuda.synchronize()
    assert pack_kernel.pack_kernel_levels.launches == before + 1
    assert chip_smoke.level_packs_equal(got, want)


TIED_CASES = list(chip_smoke.tied_weight_cases())


@pytest.mark.parametrize("name,problem,operands", TIED_CASES, ids=[name for name, _, _ in TIED_CASES])
def test_kernels_take_the_weighted_sum_in_the_plain_order(name, problem, operands, cuda_device):
    """K2 and K6 on instances where the order of the cost score's weighted
    sum alone decides the first round."""
    from karpenter_tpu_torch.convert import upload_packed

    if problem is not None:
        args = fused_args_from_numpy(*problem, device=cuda_device)
        got = pack_kernel.pack_kernel(*args, mode="cost")
        want = pack_kernel._pack_kernel_ref(*args, mode="cost")
        torch.cuda.synchronize()
        assert chip_smoke.rounds_equal(got, want)
    else:
        tensors = upload_packed(list(operands), cuda_device)
        got = pack_kernel.pack_kernel_levels(*tensors, mode="cost")
        want = chip_smoke.plain_levels(tensors, "cost")
        torch.cuda.synchronize()
        assert chip_smoke.level_packs_equal(got, want)


def test_levels_shapes_cover_every_plan(cuda_device):
    lib = pack_kernel.LEVELS_LIBRARY.load()
    plans = [pack_kernel.levels_launch_plan(g, t, 8) for g, t, _, _ in chip_smoke.K6_SHAPES]
    assert {plan.tables_in_shared for plan in plans} == {True, False}
    assert {plan.placed_in_registers for plan in plans} == {True, False}
    for plan, (g, t, _, _) in zip(plans, chip_smoke.K6_SHAPES):
        assert lib.ktt_pack_levels_shared_bytes(
            g, t, 8, int(plan.fills_in_shared), int(plan.tables_in_shared)) == plan.shared_bytes
        assert lib.ktt_pack_levels_table_words(g, t, 8) == pack_kernel.levels_table_words(g, t, 8)
        assert lib.ktt_pack_levels_words(g) == pack_kernel.rounds_words(g)


def test_constrained_solve_on_card_equals_cpu(cuda_device):
    from karpenter_tpu_torch.api.provisioner import Provisioner, ProvisionerSpec
    from karpenter_tpu_torch.constraints.solve import solve_constrained
    from karpenter_tpu_torch.controllers.cluster import Cluster
    from karpenter_tpu_torch.controllers.scheduling import Scheduler

    catalog = chip_smoke.make_catalog(40)
    pods = chip_smoke.constrained_pods(900)
    cluster = Cluster()
    (schedule,) = Scheduler(cluster).solve(Provisioner(name="default", spec=ProvisionerSpec()), pods)
    before = pack_kernel.pack_kernel_levels.launches
    card, card_decision = solve_constrained(solver.CostSolver(), schedule, catalog, [], cluster=cluster)
    assert pack_kernel.pack_kernel_levels.launches == before + 1
    cpu, cpu_decision = solve_constrained(
        solver.CostSolver(device="cpu"), schedule, catalog, [], cluster=cluster)
    assert card_decision.chosen_level == cpu_decision.chosen_level == 1
    assert card_decision.group_levels == cpu_decision.group_levels
    assert chip_smoke.placed_once_or_unschedulable(card, pods)
    assert chip_smoke.zone_skew(card)[1] <= 1
    np.testing.assert_allclose(card.projected_cost(), cpu.projected_cost(), rtol=1e-4)


# --- K8: the incremental encode's scatter and gather ------------------------------

K8_CASES = list(chip_smoke.k8_cases())


@pytest.mark.parametrize("name,op,array,index,rows", K8_CASES, ids=[case[0] for case in K8_CASES])
def test_incremental_kernels_equal_plain_versions(name, op, array, index, rows, cuda_device):
    """K8 bit for bit against its plain version: sentinel-only index
    vectors, a 1-element delta, the bool dtype and an empty permutation
    included; the scatter leaves its input untouched."""
    from karpenter_tpu_torch.convert import upload_packed
    from karpenter_tpu_torch.ops import incremental

    if op == "scatter":
        dst, idx, values = upload_packed([array, index, rows], cuda_device)
        kept = dst.clone()
        before = incremental.scatter.launches
        got = incremental.scatter(dst, idx, values)
        want = incremental._scatter_ref(dst, idx, values)
        torch.cuda.synchronize()
        assert incremental.scatter.launches == before + 1
        assert chip_smoke.same_bits(dst, kept)
    else:
        src, perm = upload_packed([array, index], cuda_device)
        before = incremental.gather.launches
        got = incremental.gather(src, perm)
        want = incremental._gather_ref(src, perm)
        torch.cuda.synchronize()
        assert incremental.gather.launches == before + (1 if got.numel() else 0)
    assert chip_smoke.same_bits(got, want)


def test_fast_path_dispatch_uploads_no_pod_tensor(cuda_device, monkeypatch):
    """The fast path on the card: a DeviceClusterState hands the solver pod
    tensors already there; with the fleet resident, the solve uploads
    nothing, and its plan is the snapshot path's."""
    from karpenter_tpu_torch.controllers.cluster import Cluster
    from karpenter_tpu_torch.convert import upload_packed
    from karpenter_tpu_torch.models.cluster_state import DeviceClusterState

    monkeypatch.setenv("KARPENTER_HOST_SOLVE", "0")
    pods, catalog = chip_smoke.make_workload(3000, 60)
    cluster = Cluster()
    state = DeviceClusterState(cluster)
    for pod in pods:
        cluster.apply_pod(pod)
    pair = state.encode_schedule(pods, catalog, Constraints(), [])
    assert pair[0].device_vectors.device.type == "cuda"
    cost_solver = solver.CostSolver()
    (first,) = list(cost_solver.solve_many_pipelined([pair]))
    before = (upload_packed.copies, upload_packed.arrays)
    (again,) = list(cost_solver.solve_many_pipelined([pair]))
    assert (upload_packed.copies, upload_packed.arrays) == before
    (snapshot,) = cost_solver.solve_many([(pods, catalog, Constraints(), ())])
    assert chip_smoke.plan_signature(first) == chip_smoke.plan_signature(again)
    assert chip_smoke.plan_signature(first) == chip_smoke.plan_signature(snapshot)
    assert chip_smoke.all_pods_placed_once(first, pods)


# --- K10: the forecast penalty -------------------------------------------------

K10_CASES = chip_smoke.k10_cases_list()


@pytest.mark.parametrize("case", K10_CASES, ids=[f"T{c[0].shape[0]}-{i}" for i, c in enumerate(K10_CASES)])
def test_forecast_kernel_bit_identical_to_numpy_and_plain(case, cuda_device):
    from karpenter_tpu_torch.market import forecast
    from karpenter_tpu_torch.ops import forecast_kernel

    prices, risks = case
    want = forecast.penalize_prices(prices, risks)
    before = forecast_kernel.penalize_prices.launches
    got = forecast.penalize_prices_torch(torch.from_numpy(prices).to(cuda_device), risks)
    plain = forecast_kernel._penalize_prices_ref(
        torch.from_numpy(prices).to(cuda_device), torch.from_numpy(risks).to(cuda_device),
        forecast.RISK_PRICE_WEIGHT)
    torch.cuda.synchronize()
    assert forecast_kernel.penalize_prices.launches == before + 1
    assert got.cpu().numpy().tobytes() == want.tobytes()
    assert torch.equal(got.view(torch.int32), plain.view(torch.int32))


def test_forecast_kernel_rejects_bad_arguments(cuda_device):
    from karpenter_tpu_torch.ops import forecast_kernel

    prices = torch.ones(8, device=cuda_device)
    with pytest.raises(TypeError):
        forecast_kernel.penalize_prices(prices.double(), prices.double(), 1.0)
    with pytest.raises(ValueError):
        forecast_kernel.penalize_prices(prices, torch.ones(4, device=cuda_device), 1.0)
    with pytest.raises(ValueError):
        forecast_kernel.penalize_prices(prices[::2], prices[::2], 1.0)
