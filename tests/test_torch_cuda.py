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


def _large_dominance_cases():
    """chip_smoke's three largest cases (T 513: a block's rows ragged; T
    4,096: 32 rows a block; an all-invalid T 513) and 3 axes (the kernel's
    scalar loads)."""
    for (capacity, prices), name in zip(list(chip_smoke.dominance_cases())[-3:],
                                        ("T513", "T4096", "T513-invalid")):
        yield name, capacity, prices
    rng = np.random.default_rng(5)
    capacity = rng.integers(0, 6, (300, 3)).astype(np.float32)
    yield "T300-R3", capacity, rng.choice([0.25, 0.5], 300).astype(np.float32)


LARGE_DOMINANCE_CASES = list(_large_dominance_cases())


@pytest.mark.parametrize("name,capacity,prices", LARGE_DOMINANCE_CASES,
                         ids=[case[0] for case in LARGE_DOMINANCE_CASES])
def test_dominance_kernel_at_large_and_ragged_sizes(name, capacity, prices, cuda_device):
    capacity, prices = (torch.from_numpy(a).to(cuda_device) for a in (capacity, prices))
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
    fused_before = pack_kernel.pack_pair_payload.launches
    got = solver.CostSolver(device="cuda").solve(pods, catalog, Constraints())
    assert cuda_kernels.dominance_prices.launches == before[0] + 1
    # One K2 launch, the pair with its epilogue: the compaction has no
    # launch of its own.
    assert pack_kernel.pack_kernel.launches == before[1] + 1
    assert score_kernel.lp_relax.launches == before[2] + 1
    assert pack_kernel.pack_pair_payload.launches == fused_before + 1
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
    before = pack_kernel.pack_pair_payload.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        handle = solver.cost_solve_dispatch(*args, device=cuda_device)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert pack_kernel.pack_pair_payload.launches == before + 1
    plan = solver.fetch_plan(handle)
    assert int(plan.rounds_cost.num_rounds) == int(warm.rounds_cost.num_rounds)
    np.testing.assert_allclose(plan.lp_objective, warm.lp_objective, rtol=0)


# --- K4: the plan compaction, in K2's pair launch ------------------------------


def _assert_fused_equals_plain(args, payload=True):
    """One launch of the pair with its epilogue, word for word equal to the
    plain composition; its rounds bit-identical to the launch without it."""
    before = (pack_kernel.pack_kernel.launches, pack_kernel.pack_pair_payload.launches)
    got = pack_kernel.pack_pair_payload(*args, payload=payload)
    assert (pack_kernel.pack_kernel.launches, pack_kernel.pack_pair_payload.launches) == (
        before[0] + 1, before[1] + 1)
    want = pack_kernel._pack_pair_payload_ref(*args, payload)
    bare = pack_kernel.pack_kernel_pair(*args)
    torch.cuda.synchronize()
    for rounds, plain, alone in zip(got[:2], want[:2], bare):
        assert chip_smoke.rounds_equal(rounds, plain)
        assert chip_smoke.rounds_equal(rounds, alone)
    for name in ("feasible_any", "solvable", "dense"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    if payload:
        assert torch.equal(got.payload, want.payload)
    else:
        assert got.payload is None
    return got


# Random problems at G 8 to 64 and the dense ones past the entry budget.
FUSED_CASES = [(f"G{g}-seed{seed}", seed, g) for g in (8, 16, 33, 64) for seed in (0, 1)] + [
    (f"dense-G{g}-seed{seed}", seed, g) for seed, g in chip_smoke.DENSE_PACK_CASES]


@pytest.mark.parametrize("label,seed,num_groups", FUSED_CASES, ids=[c[0] for c in FUSED_CASES])
def test_compact_kernel_word_identical_to_plain_version(label, seed, num_groups, cuda_device):
    problem = (chip_smoke.dense_pack_problem(seed, num_groups) if label.startswith("dense")
               else _pack_problem(seed, num_groups, 64))
    args = fused_args_from_numpy(*problem, device=cuda_device)
    got = _assert_fused_equals_plain(args)
    assert pack_kernel.LIBRARY.load().ktt_pack_rounds_payload_words(num_groups) == got.payload.shape[0]
    if label.startswith("dense"):
        assert not pack_kernel.decompact_plan(got.payload.cpu().numpy(), num_groups)[3]


def test_compact_kernel_on_pack_rounds(cuda_device):
    """Every K2 launch plan (one and two types a thread, a ragged warp, the
    fills in shared memory and in global scratch), and padded G 8,192 (the
    tables in global scratch too), with and without the payload."""
    for seed, shape in enumerate(PACK_SHAPES):
        args = fused_args_from_numpy(*_pack_problem(seed, *shape), device=cuda_device)
        _assert_fused_equals_plain(args, payload=seed % 3 != 2)
    args = fused_args_from_numpy(*chip_smoke.sparse_pack_problem(4, 8192, 64, 40), device=cuda_device)
    assert not pack_kernel.pack_launch_plan(8192, 64, 8).tables_in_shared
    _assert_fused_equals_plain(args)


def test_compact_kernel_rejects_bad_arguments(cuda_device):
    """compact_plan has no card route: the payload comes from the pair."""
    ffd = chip_smoke.dense_rounds(8, 0, 0.1, cuda_device)
    feasible = torch.ones(8, dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="pack_pair_payload"):
        pack_kernel.compact_plan(ffd, ffd, feasible)
    args = list(fused_args_from_numpy(*_pack_problem(0, 8, 8), device=cuda_device))
    args[1] = args[1].long()
    with pytest.raises(TypeError):
        pack_kernel.pack_pair_payload(*args)


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
    # The C 8 cases run clusters of 8, their rooms in shared memory even at
    # 8 axes; forced onto one block a candidate, 8 axes go to global scratch.
    lib = consolidate_kernel.LIBRARY.load()
    assert lib.ktt_consolidate_control_bytes() == consolidate_kernel.CONTROL_BYTES
    sms = cuda_kernels.sm_count(cuda_device.index or 0)
    for axes in (3, 8):
        plan = consolidate_kernel.counterfactual_launch_plan(8, 4, 8192, axes, sms)
        assert plan.cluster == 8 and plan.room_in_shared
    assert consolidate_kernel.counterfactual_launch_plan(8, 4, 8192, 3, sms, cluster=1).room_in_shared
    assert not consolidate_kernel.counterfactual_launch_plan(8, 4, 8192, 8, sms, cluster=1).room_in_shared


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("name,arrays", K7_PROBLEMS, ids=[name for name, _ in K7_PROBLEMS])
def test_counterfactual_kernel_at_every_cluster_size(name, arrays, cluster, cuda_device):
    """K7 at a cluster size the rule may not pick, bit for bit against its
    plain version: the fits past 2**24 fold across block boundaries (N 3,000
    at clusters of 2 and 4), the room in shared memory and in scratch, N off
    every multiple of 4 x threads x k (N 4,101 and 4,100)."""
    operands, axes = chip_smoke.k7_inputs(consolidate.ConsolidationProblem(**arrays), cuda_device)
    before = consolidate_kernel.solve_counterfactuals.launches
    takes, eager = consolidate_kernel.solve_counterfactuals(*operands, axes=axes, cluster=cluster)
    want = consolidate_kernel._counterfactual_ref(*operands)
    torch.cuda.synchronize()
    assert consolidate_kernel.solve_counterfactuals.launches == before + 1
    assert torch.equal(takes, want[0])
    assert torch.equal(eager, consolidate_kernel._eager_from_outputs(*want[1:]))
    # A room sized too small is flagged at every cluster size.
    if axes > 0:
        _, eager = consolidate_kernel.solve_counterfactuals(*operands, axes=axes - 1, cluster=cluster)
        assert int(eager[3 * operands[0].shape[0]]) == -1
    # The ticket counter is left at 0: the next launch gives the same bits.
    again, eager_again = consolidate_kernel.solve_counterfactuals(*operands, axes=axes, cluster=cluster)
    torch.cuda.synchronize()
    assert torch.equal(again, want[0])
    assert torch.equal(eager_again, consolidate_kernel._eager_from_outputs(*want[1:]))


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
    # The real pods request cpu, memory and pods: clusters of 2 blocks, the
    # room in shared memory, even sized for all 8 axes.
    assert axes == 3
    sms = cuda_kernels.sm_count(cuda_device.index or 0)
    for room_axes in (3, 8):
        plan = consolidate_kernel.counterfactual_launch_plan(64, 16, 8192, room_axes, sms)
        assert plan.room_in_shared and plan.cluster == (2 if sms >= 128 else 1)
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


def test_a_sweep_is_one_call_and_one_kernel_record(cluster_problem, cuda_device):
    from torch.profiler import ProfilerActivity, profile

    problem = cluster_problem[0]
    consolidate.solve_candidates(problem, device="cuda")
    torch.cuda.synchronize()
    before = consolidate_kernel.solve_counterfactuals.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        consolidate.solve_candidates(problem, device="cuda")
        torch.cuda.synchronize()
    assert consolidate_kernel.solve_counterfactuals.launches == before + 1
    kernels = [event for event in prof.events()
               if event.device_type == torch.autograd.DeviceType.CUDA
               and not event.name.startswith(("Memcpy", "Memset"))]
    k7 = [event for event in kernels if "counterfactual_kernel" in event.name]
    assert len(k7) == 1, [event.name for event in kernels]
    assert not [event for event in kernels if "winner_kernel" in event.name]


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
    assert {plan.cluster for plan in plans} == {1, 2, 4, 8, 16}
    for plan, (g, t, _, _) in zip(plans, chip_smoke.K6_SHAPES):
        tb = plan.types_per_block
        assert lib.ktt_pack_levels_shared_bytes(
            g, tb, 8, int(plan.fills_in_shared), int(plan.tables_in_shared)) == plan.shared_bytes
        assert lib.ktt_pack_levels_table_words(g, tb, 8) == pack_kernel.levels_table_words(g, tb, 8)
        assert lib.ktt_pack_levels_fill_words(g, tb) == pack_kernel.levels_fill_words(g, tb)
        assert lib.ktt_pack_levels_words(g) == pack_kernel.rounds_words(g)


# Every cluster size at a shape with G' past 256 (placed bits in scratch)
# and one with T past 1,024, each at one lane and at the rule's lanes.
K6_CLUSTER_SHAPES = [(512, 256, 2, 50), (16, 1500, 2, None)]


@pytest.mark.parametrize("lanes", [1, None], ids=["one-lane", "rule-lanes"])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("shape", K6_CLUSTER_SHAPES, ids=lambda s: "G{}-T{}".format(*s[:2]))
def test_levels_kernel_at_every_cluster_size(shape, cluster, lanes, cuda_device):
    """K6 at a plan the rule would not pick, bit for bit against its plain
    version in both modes."""
    from karpenter_tpu_torch.convert import upload_packed

    groups, types, levels, real = shape
    operands = chip_smoke.k6_problem(cluster, groups, types, levels, real)
    tensors = upload_packed(list(operands), cuda_device)
    lanes = lanes or pack_kernel.levels_launch_plan(groups, types, 8).lanes
    plan = pack_kernel.levels_plan_for(groups, types, 8, cluster, lanes)
    for mode in ("ffd", "cost"):
        out = pack_kernel._launch_levels(*tensors[:3], *tensors[4:], mode, plan=plan)
        got = pack_kernel.level_pack_from_words(out, groups, levels)
        want = chip_smoke.plain_levels(tensors, mode)
        torch.cuda.synchronize()
        assert chip_smoke.level_packs_equal(got, want), mode


def test_levels_kernel_is_deterministic(cuda_device):
    from karpenter_tpu_torch.convert import upload_packed

    tensors = upload_packed(list(chip_smoke.k6_problem(5, 64, 512, 4)), cuda_device)
    first = pack_kernel.pack_kernel_levels(*tensors, mode="cost")
    again = pack_kernel.pack_kernel_levels(*tensors, mode="cost")
    torch.cuda.synchronize()
    assert chip_smoke.level_packs_equal(first, again)


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


def test_batched_incremental_kernels_equal_plain_versions(cuda_device):
    """K8's flush and view on every k8_cases case batched together: one
    launch a flush of up to eight arrays and one a view, bit for bit equal
    to their plain versions, the inputs untouched."""
    result = chip_smoke.k8_batched_check(cuda_device)
    assert result["flushes"] >= 2 and result["views"] >= 15


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


# --- K9a and K9b: the sharded solve's kernels on meshes of the card ----------------


MESHES = [(4, (2, 2)), (8, (2, 4)), (7, (1, 7))]


def _lp_for(shards, seed, device):
    """chip_smoke's LP family at the main path's padded shape for the mesh
    (16 x 512; 21 x 518 on 1x7, padded to multiples of 7)."""
    shape = (21, 518) if shards == 7 else (16, 512)
    return chip_smoke.lp_inputs(seed, shape, device)


def _card_mesh(shards, device):
    from karpenter_tpu_torch.parallel import mesh

    return mesh.make_mesh([mesh.Shard(i, device) for i in range(shards)])


@pytest.mark.parametrize("shards,shape", MESHES, ids=["2x2", "2x4", "1x7"])
@pytest.mark.parametrize("seed", chip_smoke.LP_SEEDS[:3])
def test_sharded_lp_kernel_equals_plain_version(seed, shards, shape, cuda_device):
    """K9a over a mesh of the card (every shard on one card: one launch of
    its persistent kernel for the whole LP) against the same solve through
    the plain versions on the card: K3's LP tolerances."""
    from karpenter_tpu_torch.ops import lp_shard_kernel
    from karpenter_tpu_torch.parallel import sharded_solver

    mesh = _card_mesh(shards, cuda_device)
    assert mesh.shape == shape
    lp_args = _lp_for(shards, seed, cuda_device)
    problem = sharded_solver.shard_lp_problem(mesh, {cuda_device: lp_args})
    before = lp_shard_kernel.launches()
    got = sharded_solver.sharded_lp_blocks(mesh, problem, 300)
    torch.cuda.synchronize()
    assert lp_shard_kernel.launches() - before == 1
    with chip_smoke.plain_k9a():
        want = sharded_solver.sharded_lp_blocks(mesh, sharded_solver.shard_lp_problem(mesh, {cuda_device: lp_args}), 300)
    from karpenter_tpu_torch.parallel.collectives import assemble

    obj_err = abs(float(got.objective) - float(want.objective)) / abs(float(want.objective))
    assert obj_err <= LP_OBJECTIVE_RTOL
    err = float((assemble(mesh, got.assignment) - assemble(mesh, want.assignment)).abs().max())
    assert err <= LP_ASSIGNMENT_ATOL


@pytest.mark.parametrize("shards,shape", MESHES[:2], ids=["2x2", "2x4"])
def test_sharded_lp_kernel_phases_equal_plain_versions(shards, shape, cuda_device):
    """Each phase alone on one shard's block: the kernel against its plain
    version on the same inputs (float32 sums in other orders)."""
    from karpenter_tpu_torch.ops import lp_shard_kernel

    for case in chip_smoke.k9a_phase_cases(shards, cuda_device):
        name, kernel_args, plain_args, outputs = case
        got = getattr(lp_shard_kernel, name)(*kernel_args)
        want = getattr(lp_shard_kernel, outputs)(*plain_args)
        torch.cuda.synchronize()
        assert chip_smoke.phase_close(got, want, kernel_args, plain_args), name


@pytest.mark.parametrize("width", ["main", "g2048"])
def test_sharded_lp_per_phase_route_equals_plain_version(width, cuda_device):
    """K9a's per-phase route (the route of a mesh across cards: three
    kernels a shard a step, the collectives between) forced on the one-card
    2x4 mesh, on the main path's LP and at G 2,048 x T 512: shards x (3 x
    300 + 3) phase launches and no persistent one, the objective and the
    pods within the LP tolerances of the plain versions'."""
    from karpenter_tpu_torch.parallel import sharded_solver

    mesh = _card_mesh(8, cuda_device)
    lp_args = _lp_for(8, 1, cuda_device) if width == "main" else _wide_lp(6, 2048, 512, cuda_device)
    problem = sharded_solver.shard_lp_problem(mesh, {cuda_device: lp_args})
    with chip_smoke.plain_k9a():
        want = sharded_solver.sharded_lp_blocks(mesh, problem, 300)
    obj_err, pods_err = chip_smoke.k9a_per_phase_against_plain(mesh, problem, want, lp_args[1], 300)
    assert obj_err <= LP_OBJECTIVE_RTOL
    assert pods_err <= chip_smoke.LP_PODS_RTOL


@pytest.mark.parametrize("shards,shape", MESHES, ids=["2x2", "2x4", "1x7"])
def test_sharded_lp_kernel_gives_the_same_bits_twice(shards, shape, cuda_device):
    from karpenter_tpu_torch.parallel import collectives, sharded_solver

    mesh = _card_mesh(shards, cuda_device)
    problem = sharded_solver.shard_lp_problem(mesh, {cuda_device: _lp_for(shards, 4, cuda_device)})
    first = sharded_solver.sharded_lp_blocks(mesh, problem, 300)
    again = sharded_solver.sharded_lp_blocks(mesh, problem, 300)
    torch.cuda.synchronize()
    assert torch.equal(collectives.assemble(mesh, first.assignment), collectives.assemble(mesh, again.assignment))
    assert torch.equal(first.objective, again.objective)


def _wide_lp(seed, groups, types, device):
    """A dense LP of `groups` real groups over `types` types (a tenth of
    them invalid), effective prices, on the card."""
    from karpenter_tpu_torch.ops import cuda_kernels, score_kernel

    rng = np.random.default_rng(seed)
    vectors = np.zeros((groups, 8), np.float32)
    vectors[:, 0] = rng.integers(1, 17, groups) * 250
    vectors[:, 1] = rng.integers(1, 33, groups) * 256
    vectors[:, 2] = 1
    counts = rng.integers(1, 20, groups).astype(np.int32)
    cpu = np.sort(rng.integers(4, 65, types)) * 1000.0
    capacity = np.zeros((types, 8), np.float32)
    capacity[:, 0] = cpu - 100
    capacity[:, 1] = cpu * rng.choice([2.0, 4.0, 8.0], types) - 600
    capacity[:, 2] = 110
    valid = rng.random(types) < 0.9
    prices = (cpu / 1000 * rng.uniform(0.03, 0.06, types)).astype(np.float32)
    vectors, counts, capacity, valid, prices = (
        torch.from_numpy(a).to(device) for a in (vectors, counts, capacity, valid, prices))
    effective = cuda_kernels._dominance_prices_ref(capacity, torch.where(valid, prices, torch.inf))
    solvable = torch.where(score_kernel.feasibility_mask(vectors, capacity, valid).any(dim=1), counts, 0)
    return vectors, solvable, capacity, valid, effective


def test_sharded_lp_kernel_at_g2048(cuda_device):
    """G 2,048 x T 512 over 2x4: 128 blocks, the state in shared memory; one
    launch, the objective to rtol 1e-4 and the pods conserved to 1e-3."""
    from karpenter_tpu_torch.ops import lp_shard_kernel
    from karpenter_tpu_torch.parallel import collectives, sharded_solver

    mesh = _card_mesh(8, cuda_device)
    lp_args = _wide_lp(6, 2048, 512, cuda_device)
    problem = sharded_solver.shard_lp_problem(mesh, {cuda_device: lp_args})
    assert lp_shard_kernel.lp_shard_launch_plan(8, 1024, 128, 8).blocks == 128
    before = lp_shard_kernel.launches()
    got = sharded_solver.sharded_lp_blocks(mesh, problem, 300)
    torch.cuda.synchronize()
    assert lp_shard_kernel.launches() - before == 1
    with chip_smoke.plain_k9a():
        want = sharded_solver.sharded_lp_blocks(mesh, problem, 300)
    obj_err = abs(float(got.objective) - float(want.objective)) / abs(float(want.objective))
    assert obj_err <= LP_OBJECTIVE_RTOL
    pods = float(lp_args[1].sum())
    assert abs(float(collectives.assemble(mesh, got.assignment).double().sum()) - pods) <= 1e-3 * pods


def test_sharded_lp_kernel_shared_bytes_match_the_plan(cuda_device):
    from karpenter_tpu_torch.ops import lp_shard_kernel

    lib = lp_shard_kernel.LIBRARY.load()
    for shape in ((4, 8, 256), (8, 8, 128), (7, 3, 74), (7, 21, 74), (8, 1024, 128), (8, 4096, 128)):
        plan = lp_shard_kernel.lp_shard_launch_plan(*shape, 8)
        assert lib.ktt_lp_shard_persistent_shared_bytes(
            plan.tile_rows, plan.tile_cols, 8, int(plan.state_in_shared)) == plan.shared_bytes


def test_sharded_lp_kernel_with_its_state_in_global_scratch(cuda_device):
    """G 8,192 x T 512 over 2x4: no block holds its tile's state, so S and
    dS go to global scratch; the objective against the plain version."""
    from karpenter_tpu_torch.ops import lp_shard_kernel
    from karpenter_tpu_torch.parallel import sharded_solver

    mesh = _card_mesh(8, cuda_device)
    assert not lp_shard_kernel.lp_shard_launch_plan(8, 4096, 128, 8).state_in_shared
    problem = sharded_solver.shard_lp_problem(mesh, {cuda_device: _wide_lp(7, 8192, 512, cuda_device)})
    got = sharded_solver.sharded_lp_blocks(mesh, problem, 60)
    with chip_smoke.plain_k9a():
        want = sharded_solver.sharded_lp_blocks(mesh, problem, 60)
    obj_err = abs(float(got.objective) - float(want.objective)) / abs(float(want.objective))
    assert obj_err <= LP_OBJECTIVE_RTOL


@pytest.mark.parametrize("shards", [2, 4, 7, 8])
def test_compact_shard_kernel_word_identical_to_plain_version(shards, cuda_device):
    """K9b over a mesh of the card (2x2, 2x4, and 1x7 as the shrunk mesh
    pads G to a multiple of 7): one launch for the whole payload, word for
    word equal to the plain version's and to the per-card route forced on
    the card (runs of three shards, a launch each), overflow included, and
    decoded to the dense fills."""
    small, large = (16, 64) if shards != 7 else (21, 70)
    for num_groups, density in ((small, 0.05), (large, 0.02), (small, 0.9)):
        ffd, cost = (chip_smoke.dense_rounds(num_groups, seed, density, cuda_device) for seed in (0, 1))
        feasible = torch.ones(num_groups, dtype=torch.bool, device=cuda_device)
        mesh = _card_mesh(shards, cuda_device)
        before = pack_kernel.compact_shard.launches
        got = pack_kernel.compact_plan_sharded(ffd, cost, feasible, mesh=mesh)
        assert pack_kernel.compact_shard.launches == before + 1
        per_card = pack_kernel.compact_plan_sharded(ffd, cost, feasible, mesh=mesh, per_card=3)
        assert pack_kernel.compact_shard.launches == before + 1 + -(-shards // 3)
        with chip_smoke.plain_k9b():
            want = pack_kernel.compact_plan_sharded(ffd, cost, feasible, mesh=mesh)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert torch.equal(per_card, got)
        decoded_ffd, decoded_cost, _, ok = pack_kernel.decompact_plan_sharded(got.cpu().numpy(), num_groups, shards)
        budget = pack_kernel.shard_entry_budget(num_groups, shards)
        width = num_groups // shards
        fits = all(
            int((rounds.round_fill[:, s * width : (s + 1) * width] != 0).sum()) <= budget
            for rounds in (ffd, cost) for s in range(shards))
        assert ok is fits
        if ok:
            assert np.array_equal(decoded_ffd.round_fill, ffd.round_fill.cpu().numpy())
            assert np.array_equal(decoded_cost.round_fill, cost.round_fill.cpu().numpy())


def test_wrappers_launch_on_the_current_stream(cuda_device, monkeypatch):
    """The card twin of tests/test_torch_launch_stream.py: under a side
    stream, each kernel of the mesh path gets that stream's handle."""
    from karpenter_tpu_torch.ops import lp_shard_kernel

    handles = []

    class Recording:
        def __init__(self, lib):
            self._lib = lib

        def __getattr__(self, name):
            function = getattr(self._lib, name)

            def call(*args):
                handles.append(args[-1])
                return function(*args)

            return call

    from karpenter_tpu_torch.ops import incremental

    for library in (lp_shard_kernel.LIBRARY, pack_kernel.COMPACT_SHARD_LIBRARY, cuda_kernels.LIBRARY,
                    incremental.LIBRARY):
        real = library.load()
        monkeypatch.setattr(library, "load", lambda real=real: Recording(real))
    side = torch.cuda.Stream(device=cuda_device)
    with torch.cuda.stream(side):
        mesh = _card_mesh(4, cuda_device)
        ffd, cost = (chip_smoke.dense_rounds(16, seed, 0.1, cuda_device) for seed in (0, 1))
        pack_kernel.compact_plan_sharded(ffd, cost, torch.ones(16, dtype=torch.bool, device=cuda_device), mesh=mesh)
        pack_kernel.compact_plan_sharded(ffd, cost, torch.ones(16, dtype=torch.bool, device=cuda_device), mesh=mesh,
                                         per_card=3)
        slots = torch.ones((32, 8), device=cuda_device)
        idx = torch.arange(8, dtype=torch.int32, device=cuda_device)
        flushed = incremental.scatter_flush([(slots, idx, torch.zeros((8, 8), device=cuda_device)),
                                             (slots[:, 0].contiguous().bool(), idx,
                                              torch.zeros(8, dtype=torch.bool, device=cuda_device))])
        incremental.gather_view(list(flushed), idx)
        lp_shard_kernel.shard_softmax(*(torch.zeros((4, 8), device=cuda_device) for _ in range(5)),
                                      torch.ones((4, 8), dtype=torch.bool, device=cuda_device), None, None, None)
        from karpenter_tpu_torch.parallel import sharded_solver

        problem = sharded_solver.shard_lp_problem(mesh, {cuda_device: chip_smoke.lp_inputs(0, (16, 512), cuda_device)})
        sharded_solver.sharded_lp_blocks(mesh, problem, 3)
        capacity = torch.ones((8, 8), device=cuda_device)
        cuda_kernels.dominance_prices(capacity, torch.ones(8, device=cuda_device))
    side.synchronize()
    assert handles and all(handle == side.cuda_stream for handle in handles)
    assert side.cuda_stream != torch.cuda.current_stream(cuda_device).cuda_stream
