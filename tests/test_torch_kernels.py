"""The port's device modules against the JAX reference on the CPU.

K1 (dominance pricing), K2 (the pack round loop), plan compaction and the LP
relaxation of karpenter_tpu_torch, each run through its plain PyTorch version
(what the wrappers route CPU tensors to) and held against the reference on
the same numpy inputs. The hand-written CUDA kernels behind the same wrappers
are held against these plain versions on the card by tests/test_torch_cuda.py
and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from karpenter_tpu.api.provisioner import Constraints
from karpenter_tpu.ops import pack_kernel as ref_pack
from karpenter_tpu.ops import pallas_kernels
from karpenter_tpu.ops import score_kernel as ref_score
from karpenter_tpu.ops.encode import build_fleet, group_pods
from karpenter_tpu_torch.ops import cuda_kernels
from karpenter_tpu_torch.ops import pack_kernel as port_pack
from karpenter_tpu_torch.ops import score_kernel as port_score

from tests import fixtures

torch.set_num_threads(2)


# --- K1: dominance pricing ----------------------------------------------------


def _numpy_oracle(capacity: np.ndarray, prices: np.ndarray) -> np.ndarray:
    out = np.full(capacity.shape[0], np.inf, dtype=np.float64)
    for t in range(capacity.shape[0]):
        for u in range(capacity.shape[0]):
            if np.all(capacity[u] >= capacity[t] - 1e-6):
                out[t] = min(out[t], prices[u])
    return out


def _cases():
    """The inputs of tests/test_pallas_kernels.py, made again with its seed."""
    rng = np.random.default_rng(3)
    yield np.zeros((1, 8), np.float32), np.array([1.5], np.float32)
    size_ladder = np.arange(1, 9, dtype=np.float32)[:, None] * np.ones(
        (1, 8), np.float32
    )
    yield size_ladder, (0.1 * np.arange(1, 9)).astype(np.float32)
    for _ in range(6):
        num_types = int(rng.integers(2, 40))
        capacity = rng.integers(0, 6, (num_types, 8)).astype(np.float32)
        prices = rng.uniform(0.05, 2.0, num_types).astype(np.float32)
        invalid = rng.random(num_types) < 0.2
        capacity[invalid] = 0.0
        prices = np.where(invalid, np.inf, prices).astype(np.float32)
        yield capacity, prices


DOMINANCE_CASES = list(_cases())
_case_ids = [f"T{c[0].shape[0]}-{i}" for i, c in enumerate(DOMINANCE_CASES)]


def _port_dominance(capacity, prices):
    return cuda_kernels._dominance_prices_ref(
        torch.from_numpy(capacity), torch.from_numpy(prices)
    ).numpy()


class TestDominancePrices:
    # The kernel only compares and takes minimums, so every comparison is
    # exact equality (infinities included).

    @pytest.mark.parametrize("case", DOMINANCE_CASES, ids=_case_ids)
    def test_plain_equals_reference_formulation(self, case):
        capacity, prices = case
        want = np.asarray(pallas_kernels._dominance_prices_ref(capacity, prices))
        np.testing.assert_array_equal(_port_dominance(capacity, prices), want)

    @pytest.mark.parametrize("case", DOMINANCE_CASES, ids=_case_ids)
    def test_plain_equals_pallas_body_interpreted(self, case):
        from jax.experimental import pallas as pl

        capacity, prices = case
        num_types = capacity.shape[0]
        want = pl.pallas_call(
            pallas_kernels._dominance_kernel,
            out_shape=jax.ShapeDtypeStruct((1, num_types), np.float32),
            interpret=True,
        )(capacity, capacity.T.copy(), prices.reshape(num_types, 1))
        np.testing.assert_array_equal(
            _port_dominance(capacity, prices), np.asarray(want).reshape(num_types)
        )

    @pytest.mark.parametrize("case", DOMINANCE_CASES, ids=_case_ids)
    def test_plain_equals_numpy_oracle(self, case):
        capacity, prices = case
        np.testing.assert_array_equal(
            _port_dominance(capacity, prices).astype(np.float64),
            _numpy_oracle(capacity, prices),
        )

    @pytest.mark.parametrize("case", DOMINANCE_CASES, ids=_case_ids)
    def test_wrapper_routes_cpu_tensors_to_plain_version(self, case):
        capacity, prices = case
        before = cuda_kernels.dominance_prices.launches
        got = cuda_kernels.dominance_prices(
            torch.from_numpy(capacity), torch.from_numpy(prices)
        )
        assert cuda_kernels.dominance_prices.launches == before
        np.testing.assert_array_equal(got.numpy(), _port_dominance(capacity, prices))

    def test_wrapper_rejects_bad_arguments(self):
        capacity = torch.zeros((4, 8))
        with pytest.raises(TypeError):
            cuda_kernels.dominance_prices(capacity.double(), torch.zeros(4).double())
        with pytest.raises(ValueError):
            cuda_kernels.dominance_prices(capacity, torch.zeros(5))


# --- K2: the pack round loop --------------------------------------------------


def _randomized_pods(seed):
    rng = np.random.default_rng(seed + 100)
    pods = []
    for _ in range(int(rng.integers(1, 7))):
        cpu = int(rng.integers(1, 17)) * 250
        mem = int(rng.integers(1, 33)) * 256
        pods += fixtures.pods(int(rng.integers(1, 60)), cpu=f"{cpu}m", memory=f"{mem}Mi")
    return pods, fixtures.size_ladder(int(rng.integers(1, 12)))


def _fixture_problems():
    """The problems of tests/test_pack_kernel.py, as (id, pods, catalog)."""
    yield "homogeneous", fixtures.pods(100), [fixtures.cpu_instance("only", cpu=16, mem_gib=64)]
    yield "size_ladder", fixtures.pods(50), fixtures.size_ladder(10)
    yield "mixed_shapes", (
        fixtures.pods(40, cpu="1500m", memory="1Gi")
        + fixtures.pods(40, cpu="500m", memory="3Gi")
        + fixtures.pods(7, cpu="4", memory="8Gi")
    ), fixtures.size_ladder(8)
    yield "exact_fit", (
        fixtures.pods(4, cpu="1500m") + fixtures.pods(4, cpu="500m")
    ), [fixtures.cpu_instance("two", cpu=2, mem_gib=8)]
    yield "giant", (
        [fixtures.pod(cpu="64", name="giant")] + fixtures.pods(3)
    ), [fixtures.cpu_instance("small", cpu=4, mem_gib=8)]
    for seed in range(6):
        yield (f"randomized{seed}", *_randomized_pods(seed))
    yield "cost_ladder", fixtures.pods(120, cpu="900m", memory="1Gi"), fixtures.size_ladder(10)
    yield "cost_deal", fixtures.pods(64, cpu="1", memory="1Gi"), [
        fixtures.cpu_instance("small", cpu=4, mem_gib=8, price=0.5),
        fixtures.cpu_instance("deal", cpu=16, mem_gib=32, price=0.9),
        fixtures.cpu_instance("big", cpu=32, mem_gib=64, price=4.0),
    ]
    yield "packs_everything", fixtures.pods(200, cpu="700m", memory="900Mi"), fixtures.size_ladder(6)
    yield "replication", fixtures.pods(5000), [fixtures.cpu_instance("only", cpu=16, mem_gib=64)]


def _encode(pods, catalog):
    """Reference encode + the kernel tests' padding (tests/test_pack_kernel.py)."""
    groups = group_pods(pods)
    fleet = build_fleet(catalog, Constraints(), pods)
    g_pad = ref_pack.bucket_size(groups.num_groups)
    t_pad = ref_pack.bucket_size(fleet.num_types)
    return (
        ref_pack.pad_to(groups.vectors, g_pad),
        ref_pack.pad_to(groups.counts.astype(np.int32), g_pad),
        ref_pack.pad_to(fleet.capacity, t_pad),
        ref_pack.pad_to(fleet.total, t_pad),
        ref_pack.pad_to(np.ones(fleet.num_types, bool), t_pad),
        ref_pack.pad_to(fleet.prices, t_pad),
    )


def _random_problem(seed):
    """A padded problem with invalid types, +inf padded prices, groups no
    type admits, and ties in price."""
    rng = np.random.default_rng(seed)
    num_groups, num_types = (8, 16, 32)[seed % 3], (8, 32, 64)[seed % 3]
    real_groups = int(rng.integers(1, num_groups + 1))
    vectors = np.zeros((num_groups, 8), np.float32)
    vectors[:real_groups, 0] = np.sort(rng.integers(1, 33, real_groups))[::-1] * 250
    vectors[:real_groups, 1] = rng.integers(1, 65, real_groups) * 256
    vectors[:real_groups, 2] = 1
    counts = np.zeros(num_groups, np.int32)
    counts[:real_groups] = rng.integers(1, 400, real_groups)
    real_types = int(rng.integers(1, num_types + 1))
    cpu = np.sort(rng.integers(1, 9, real_types)) * 1000.0
    capacity = np.zeros((num_types, 8), np.float32)
    capacity[:real_types, 0] = cpu - 150
    capacity[:real_types, 1] = cpu * rng.choice([2.0, 4.0], real_types) - 700
    capacity[:real_types, 2] = 110
    total = capacity.copy()
    total[:real_types, 0] += 150
    total[:real_types, 1] += 700
    valid = np.zeros(num_types, bool)
    valid[:real_types] = True
    prices = np.full(num_types, np.inf, np.float32)
    prices[:real_types] = np.round(cpu / 1000 * rng.choice([0.04, 0.05], real_types), 3)
    return vectors, counts, capacity, total, valid, prices


def _many_shapes_problem(num_shapes=1100, padded=2048, num_types=16, seed=0):
    rng = np.random.default_rng(seed)
    cpu = rng.integers(1, 4001, num_shapes).astype(np.float32)
    mem = rng.integers(1, 8193, num_shapes).astype(np.float32)
    order = np.lexsort((-mem, -cpu))  # FFD: largest cpu first
    vectors = np.zeros((padded, 8), np.float32)
    vectors[:num_shapes, 0] = cpu[order]
    vectors[:num_shapes, 1] = mem[order]
    vectors[:num_shapes, 2] = 1
    counts = np.zeros(padded, np.int32)
    counts[:num_shapes] = 3
    capacity = np.zeros((num_types, 8), np.float32)
    capacity[:, 0] = np.arange(1, num_types + 1) * 2000 - 100
    capacity[:, 1] = np.arange(1, num_types + 1) * 8192 - 600
    capacity[:, 2] = 110
    prices = (np.arange(1, num_types + 1) * 0.1).astype(np.float32)
    return vectors, counts, capacity, capacity.copy(), np.ones(num_types, bool), prices


def _first_pick_of_a_sequential_chain(problem):
    """The type the first cost round of a tied-weight problem would take if
    weighted were one chain of fused multiply-adds over ascending g."""
    vectors, counts, capacity = (torch.from_numpy(a) for a in problem[:3])
    weight = (vectors / capacity[2].clamp(min=1.0)).amax(dim=1)
    fills = torch.stack([torch.where(vectors[:, axis] == 0, 0, counts) for axis in (0, 1)])
    fills[:, 0] = counts[0]
    weighted = torch.zeros(2)
    for g in range(fills.shape[1]):
        weighted = port_pack._fma32(fills[:, g].to(torch.float32), weight[g].expand(2), weighted)
    return int(torch.argmin(1.0 / weighted))


PACK_PROBLEMS = [(name, _encode(pods, catalog)) for name, pods, catalog in _fixture_problems()]
PACK_PROBLEMS += [(f"random{seed}", _random_problem(seed)) for seed in range(6)]
_pack_ids = [name for name, _ in PACK_PROBLEMS]


def _torch_args(args):
    return tuple(torch.from_numpy(np.array(a)) for a in args)


def _rounds_numpy(rounds):
    return [np.asarray(field).astype(np.int64) for field in rounds]


def _assert_rounds_equal(port, ref):
    for name, got, want in zip(port._fields, _rounds_numpy(port), _rounds_numpy(ref)):
        np.testing.assert_array_equal(got, want, err_msg=name)


class TestPackKernel:
    @pytest.mark.parametrize("quirk", [False, True])
    @pytest.mark.parametrize("mode", ["ffd", "cost"])
    @pytest.mark.parametrize("problem", [p for _, p in PACK_PROBLEMS], ids=_pack_ids)
    def test_plain_version_bit_identical_to_reference(self, problem, mode, quirk):
        ref = ref_pack.pack_kernel(*problem, quirk=quirk, mode=mode)
        port = port_pack.pack_kernel(*_torch_args(problem), quirk=quirk, mode=mode)
        _assert_rounds_equal(port, ref)

    @pytest.mark.parametrize("problem", [p for _, p in PACK_PROBLEMS[:6]], ids=_pack_ids[:6])
    def test_pair_equals_each_mode(self, problem):
        args = _torch_args(problem)
        before = port_pack.pack_kernel.launches
        pair = port_pack.pack_kernel_pair(*args)
        assert port_pack.pack_kernel.launches == before  # CPU tensors: plain version
        for mode, rounds in zip(("ffd", "cost"), pair):
            _assert_rounds_equal(rounds, port_pack.pack_kernel(*args, mode=mode))

    @pytest.mark.parametrize("mode", ["ffd", "cost"])
    def test_many_shapes_bit_identical_to_reference(self, mode):
        """1,100 distinct FFD-sorted shapes padded to 2,048 groups, 3 pods a
        shape, over a 16-type cpu/memory ladder: past the 1,024 groups the
        card's kernel once refused, the plain version still gives the
        reference's rounds in both modes."""
        problem = _many_shapes_problem()
        ref = ref_pack.pack_kernel(*problem, mode=mode)
        port = port_pack.pack_kernel(*_torch_args(problem), mode=mode)
        assert int(port.num_rounds) > 100 and not int(port.overflow)
        _assert_rounds_equal(port, ref)

    @pytest.mark.parametrize("groups", [16, 32, 64, 128, 256])
    def test_cost_mode_takes_the_weighted_sum_in_the_reference_order(self, groups):
        chain_misses = 0
        for seed in range(12):
            problem = chip_smoke.tied_weight_pack_problem(seed, groups)
            ref = ref_pack.pack_kernel(*problem, mode="cost")
            port = port_pack.pack_kernel(*_torch_args(problem), mode="cost")
            _assert_rounds_equal(port, ref)
            chain_misses += _first_pick_of_a_sequential_chain(problem) != int(ref.round_type[0])
        # Under 64 groups the reference's order is that chain; from 64 on it
        # is not, and these probes tell the two apart.
        assert (chain_misses > 0) == (groups >= 64)

    def test_rejects_bad_arguments(self):
        args = list(_torch_args(PACK_PROBLEMS[0][1]))
        with pytest.raises(ValueError):
            port_pack.pack_kernel(*args, mode="bogus")
        args[1] = args[1].to(torch.int64)
        with pytest.raises(TypeError):
            port_pack.pack_kernel(*args)


# --- plan compaction ------------------------------------------------------------


def _ref_rounds(problem):
    return [ref_pack.pack_kernel(*problem, mode=mode) for mode in ("ffd", "cost")]


def _feasible_any(problem):
    vectors, _, capacity, _, valid, _ = problem
    return np.asarray(ref_score.feasibility_mask(vectors, capacity, valid).any(axis=1))


def _to_port_rounds(rounds):
    return port_pack.PackRounds(
        *(torch.from_numpy(np.array(field, dtype=np.int32)) for field in rounds)
    )


def _dense_synthetic_rounds(num_groups=8, seed=0):
    """Rounds whose fills are mostly nonzero: nnz overflows the entry budget,
    so the compaction must drop the excess as the reference's scatter does."""
    rng = np.random.default_rng(seed)
    mr = ref_pack.max_rounds(num_groups)
    fill = rng.integers(0, 4, (mr, num_groups)).astype(np.int32)
    return ref_pack.PackRounds(
        round_type=jnp.asarray(rng.integers(0, 16, mr).astype(np.int32)),
        round_fill=jnp.asarray(fill),
        round_repl=jnp.asarray(rng.integers(1, 5, mr).astype(np.int32)),
        num_rounds=jnp.asarray(mr, jnp.int32),
        unschedulable=jnp.asarray(np.zeros(num_groups, np.int32)),
        overflow=jnp.asarray(False),
    )


class TestCompaction:
    @pytest.mark.parametrize("problem", [p for _, p in PACK_PROBLEMS], ids=_pack_ids)
    def test_payload_word_identical(self, problem):
        ffd, cost = _ref_rounds(problem)
        feasible = _feasible_any(problem)
        want = np.asarray(ref_pack.compact_plan(ffd, cost, jnp.asarray(feasible)))
        got = port_pack.compact_plan(
            _to_port_rounds(ffd), _to_port_rounds(cost), torch.from_numpy(feasible.copy())
        )
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.shape[0] == port_pack.compact_words(problem[0].shape[0])

    @pytest.mark.parametrize("problem", [p for _, p in PACK_PROBLEMS], ids=_pack_ids)
    def test_decompact_round_trips(self, problem):
        rounds = [
            port_pack.pack_kernel(*_torch_args(problem), mode=mode) for mode in ("ffd", "cost")
        ]
        feasible = torch.from_numpy(np.array(_feasible_any(problem)))
        words = port_pack.compact_plan(*rounds, feasible).numpy()
        ffd, cost, feasible_back, ok = port_pack.decompact_plan(words, problem[0].shape[0])
        assert ok
        np.testing.assert_array_equal(feasible_back, feasible.numpy())
        for decoded, original in zip((ffd, cost), rounds):
            for got, want in zip(_rounds_numpy(decoded), _rounds_numpy(original)):
                np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("seed", range(3))
    def test_budget_overflow_drops_like_reference(self, seed):
        ffd = _dense_synthetic_rounds(seed=seed)
        cost = _dense_synthetic_rounds(seed=seed + 10)
        feasible = np.ones(8, bool)
        want = np.asarray(ref_pack.compact_plan(ffd, cost, jnp.asarray(feasible)))
        got = port_pack.compact_plan(
            _to_port_rounds(ffd), _to_port_rounds(cost), torch.from_numpy(feasible.copy())
        ).numpy()
        np.testing.assert_array_equal(got, want)
        assert not port_pack.decompact_plan(got, 8)[3]


# --- the LP relaxation ----------------------------------------------------------

# Tolerances: both sides run 300 Adam steps in float32 through a softmax and
# an einsum whose sums are taken in different orders (XLA vs PyTorch's CPU
# kernels), so the trajectories drift apart by rounding; the objective is a
# sum over types and agrees to rtol 1e-4, each assignment cell to 1e-3 pods.
LP_OBJECTIVE_RTOL = 1e-4
LP_ASSIGNMENT_ATOL = 1e-3
LP_ROW_SUM_ATOL = 1e-3


def _lp_problem(seed, num_groups=8, num_types=16):
    """An LP whose optimum is a point: every type has its own price per
    core. (Where several types tie on price per capacity, as on the linear
    fixture ladders, the objective is flat along the ties, its gradient sits
    at rounding-noise level, and Adam's normalized steps follow the noise:
    there neither side's assignment is determined, and the reference itself
    moves with the summation order.)"""
    rng = np.random.default_rng(seed)
    real_groups = int(rng.integers(2, num_groups + 1))
    real_types = int(rng.integers(3, num_types + 1))
    vectors = np.zeros((num_groups, 8), np.float32)
    vectors[:real_groups, 0] = np.sort(rng.integers(1, 17, real_groups))[::-1] * 250
    vectors[:real_groups, 1] = rng.integers(1, 33, real_groups) * 256
    vectors[:real_groups, 2] = 1
    counts = np.zeros(num_groups, np.int32)
    counts[:real_groups] = rng.integers(1, 60, real_groups)
    cpu = np.sort(rng.integers(1, 17, real_types)) * 1000.0
    capacity = np.zeros((num_types, 8), np.float32)
    capacity[:real_types, 0] = cpu - 100
    capacity[:real_types, 1] = cpu * rng.choice([2.0, 4.0, 8.0], real_types) - 600
    capacity[:real_types, 2] = 110
    valid = np.zeros(num_types, bool)
    valid[:real_types] = True
    prices = np.full(num_types, np.inf, np.float32)
    prices[:real_types] = cpu / 1000 * rng.uniform(0.03, 0.06, real_types)
    return vectors, counts, capacity, capacity.copy(), valid, prices


LP_SEEDS = [0, 1, 3, 4, 6, 7, 8, 9]


@pytest.mark.parametrize("seed", LP_SEEDS)
def test_lp_relax_body_matches_reference(seed):
    problem = _lp_problem(seed)
    vectors, counts, capacity, _, valid, prices = problem
    effective = np.asarray(
        pallas_kernels._dominance_prices_ref(capacity, np.where(valid, prices, np.inf))
    ).astype(np.float32)
    solvable = np.where(_feasible_any(problem), counts, 0).astype(np.int32)
    want = ref_score.lp_relax_solve(vectors, solvable, capacity, valid, effective, steps=300)
    got = port_score.lp_relax_body(
        *_torch_args((vectors, solvable, capacity, valid, effective)), steps=300
    )
    np.testing.assert_allclose(
        float(got.objective), float(want.objective), rtol=LP_OBJECTIVE_RTOL
    )
    assignment = got.assignment.numpy()
    np.testing.assert_allclose(
        assignment, np.asarray(want.assignment), rtol=0, atol=LP_ASSIGNMENT_ATOL
    )
    np.testing.assert_allclose(
        assignment.sum(axis=1), solvable.astype(np.float32), rtol=0, atol=LP_ROW_SUM_ATOL
    )


def test_round_assignment_matches_reference():
    rng = np.random.default_rng(5)
    assignment = rng.uniform(0, 10, (6, 9))
    counts = np.floor(assignment.sum(axis=1)).astype(np.int64)
    np.testing.assert_array_equal(
        port_score.round_assignment(assignment, counts),
        ref_score.round_assignment(assignment, counts),
    )
