"""The port's consolidation counterfactual solve against the JAX reference on
the CPU.

The same numpy arrays go through karpenter_tpu.ops.consolidate.solve_candidates
(its jitted XLA program on the CPU) and the port's
solve_candidates(problem, device="cpu"), which runs K7's plain PyTorch version
(ops/consolidate_kernel._counterfactual_ref). Both sides run the same float32
operations, so every verdict field and plan row must be equal exactly. The
hand-written kernel behind the same wrapper is held against the plain version
on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from karpenter_tpu.api.pods import PodSpec as RefPodSpec
from karpenter_tpu.api.provisioner import Constraints as RefConstraints
from karpenter_tpu.cloudprovider import InstanceType as RefInstanceType
from karpenter_tpu.cloudprovider import Offering as RefOffering
from karpenter_tpu.ops import consolidate as ref
from karpenter_tpu.ops import encode as ref_encode
from karpenter_tpu.ops import pack_kernel as ref_pack
from karpenter_tpu_torch.ops import consolidate as port
from karpenter_tpu_torch.ops import consolidate_kernel
from karpenter_tpu_torch.ops import pack_kernel as port_pack

torch.set_num_threads(2)

R = 8  # wellknown.NUM_RESOURCE_DIMS
FIELDS = ("pod_vectors", "pod_counts", "headroom", "bin_mask", "node_prices",
          "type_capacity", "type_prices", "type_valid")


def _both(**arrays):
    return ref.ConsolidationProblem(**arrays), port.ConsolidationProblem(**arrays)


def _solve_both(**arrays):
    ref_problem, port_problem = _both(**arrays)
    return ref.solve_candidates(ref_problem), port.solve_candidates(port_problem, device="cpu")


def assert_same_verdicts(want, got, members=None):
    for name in ("delete_ok", "replace_type", "action"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    # Both sides run the same float32 (device) and float64 (host) operations.
    np.testing.assert_array_equal(got.replace_price, want.replace_price)
    np.testing.assert_array_equal(got.savings, want.savings)
    assert got.best() == want.best()
    # The prefetched winner's row first, then every row, then the whole tensor.
    for c in range(len(want.action)):
        np.testing.assert_array_equal(got.take_row(c), want.take_row(c), err_msg=f"row {c}")
    np.testing.assert_array_equal(got.delete_take, want.delete_take)
    if members is not None:
        for c, candidate_members in enumerate(members):
            assert port.delete_assignment(got, c, candidate_members) == ref.delete_assignment(
                want, c, candidate_members
            )


def test_constants_match_reference():
    assert port.ACTION_NONE == ref.ACTION_NONE
    assert port.ACTION_DELETE == ref.ACTION_DELETE
    assert port.ACTION_REPLACE == ref.ACTION_REPLACE
    assert port.MIN_SAVINGS_DOLLARS == ref.MIN_SAVINGS_DOLLARS


# --- the scenarios of tests/test_consolidation.py::TestConsolidationSolve ------


def _vec(cpu, pods=1.0):
    v = np.zeros(R, np.float32)
    v[0] = cpu
    v[2] = pods
    return v


def _scenario(**overrides):
    base = dict(
        pod_vectors=np.stack([_vec(4000.0)])[None, :, :],
        pod_counts=np.array([[2]], np.int32),
        headroom=np.stack([_vec(8000.0, pods=100.0)]),
        bin_mask=np.ones((1, 1), bool),
        node_prices=np.array([0.48]),
        type_capacity=np.stack([_vec(8000.0, 100.0), _vec(16000.0, 100.0)]),
        type_prices=np.array([0.24, 0.48], np.float32),
        type_valid=np.ones((1, 2), bool),
    )
    base.update(overrides)
    return base


SCENARIOS = {
    "delete_wins": _scenario(),
    "replace_when_headroom_short": _scenario(headroom=np.stack([_vec(4000.0, 100.0)])),
    "no_action": _scenario(
        headroom=np.stack([_vec(0.0, 0.0)]),
        type_prices=np.array([0.48, 0.9], np.float32),
        type_capacity=np.stack([_vec(16000.0, 100.0), _vec(32000.0, 100.0)]),
    ),
    "bin_mask_excludes_victim": _scenario(
        pod_vectors=np.stack([np.stack([_vec(4000.0)]), np.stack([_vec(9000.0)])]),
        pod_counts=np.array([[1], [1]], np.int32),
        headroom=np.stack([_vec(9000.0, 100.0), _vec(4000.0, 100.0)]),
        bin_mask=np.array([[False, True], [True, False]]),
        node_prices=np.array([0.48, 0.48]),
        type_valid=np.ones((2, 2), bool),
    ),
    "type_valid_blocks_accelerated": _scenario(type_valid=np.array([[False, True]])),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_reference(name):
    want, got = _solve_both(**SCENARIOS[name])
    assert_same_verdicts(want, got)


def test_scenario_verdicts():
    """The reference's own expectations hold for the port."""
    _, got = _solve_both(**SCENARIOS["delete_wins"])
    assert got.action[0] == port.ACTION_DELETE and got.savings[0] == pytest.approx(0.48)
    _, got = _solve_both(**SCENARIOS["replace_when_headroom_short"])
    assert got.action[0] == port.ACTION_REPLACE and got.replace_type[0] == 0
    _, got = _solve_both(**SCENARIOS["no_action"])
    assert got.best() == -1
    _, got = _solve_both(**SCENARIOS["bin_mask_excludes_victim"])
    assert got.delete_take[0, 0, 1] == 1 and got.delete_take[1, 0, 0] == 1


def test_delete_assignment_cursor_order_matches_reference():
    pods = [object(), object()]
    want, got = _solve_both(**SCENARIOS["delete_wins"])
    plan = port.delete_assignment(got, 0, [pods])
    assert plan == ref.delete_assignment(want, 0, [pods])
    assert [pod for pod, _ in plan] == pods and all(j == 0 for _, j in plan)


def test_bench_problem_matches_reference():
    """bench.py's consolidation fetch problem (8 candidates x 4 groups x 16
    bins x 32 types), drawn with its seed."""
    rng = np.random.default_rng(7)
    want, got = _solve_both(
        pod_vectors=rng.integers(1, 9, (8, 4, 8)).astype(np.float32) * 250.0,
        pod_counts=rng.integers(0, 5, (8, 4)).astype(np.int32),
        headroom=rng.integers(1, 17, (16, 8)).astype(np.float32) * 1000.0,
        bin_mask=np.ones((8, 16), bool),
        node_prices=np.linspace(0.5, 2.0, 8),
        type_capacity=rng.integers(1, 33, (32, 8)).astype(np.float32) * 1000.0,
        type_prices=np.linspace(0.1, 3.2, 32).astype(np.float32),
        type_valid=np.ones((8, 32), bool),
    )
    assert_same_verdicts(want, got)


# --- seeded random problems ------------------------------------------------------


def random_problem(seed, num_candidates, num_groups, num_bins, num_types):
    """chip_smoke's seeded problem: zero-count and zero-vector groups,
    all-False bin_mask rows, candidates with no feasible type, tied prices
    (tied savings), a gpu axis on some groups."""
    return chip_smoke.random_consolidation_problem(
        seed, num_candidates, num_groups, num_bins, num_types, dims=4)


RANDOM_SHAPES = [(1, 1, 1, 1), (3, 5, 9, 17), (9, 3, 33, 7), (13, 11, 70, 40), (17, 9, 130, 20)]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("shape", RANDOM_SHAPES, ids=lambda s: "C{}-G{}-N{}-T{}".format(*s))
def test_random_problem_matches_reference(shape, seed):
    want, got = _solve_both(**random_problem(seed, *shape))
    assert_same_verdicts(want, got)


def test_fit_above_2_24_folds_like_reference():
    """A bin whose fit exceeds 2**24 after a small one: the reference's prefix
    sum is a sequential float32 fold, fl(3 + 2**25) = 2**25 + 4, so the
    second bin takes one pod less than exact arithmetic would give and the
    delete leg fails. A float64 prefix sum would place every pod."""
    want, got = _solve_both(**chip_smoke.huge_fit_problem(3))
    assert_same_verdicts(want, got)
    np.testing.assert_array_equal(got.take_row(0)[0], [3, 6, 0])
    assert not got.delete_ok[0] and got.delete_ok[1]


def test_fits_past_2_24_over_many_bins_match_reference():
    want, got = _solve_both(**chip_smoke.huge_fit_problem(3000))
    assert_same_verdicts(want, got)


K7_PROBLEMS = dict(chip_smoke.k7_problems())


@pytest.mark.parametrize("name", sorted(K7_PROBLEMS))
def test_chip_smoke_k7_problem_matches_reference(name):
    """The small problems chip_smoke holds K7 to its plain version on."""
    want, got = _solve_both(**K7_PROBLEMS[name])
    assert_same_verdicts(want, got)


def test_fold_cumsum_equals_sequential_fold():
    rng = np.random.default_rng(5)
    fit = np.floor(rng.uniform(0, 2.0**26, (4, 257))).astype(np.float32)
    fit[0] = rng.integers(0, 50, 257)  # exact row
    folded = np.zeros_like(fit)
    for row in range(fit.shape[0]):
        acc = np.float32(0.0)
        for n in range(fit.shape[1]):
            acc = np.float32(acc + fit[row, n])
            folded[row, n] = acc
    got = consolidate_kernel._fold_cumsum(torch.from_numpy(fit)).numpy()
    np.testing.assert_array_equal(got, folded)


# --- the whole slice: a cluster encoded by each package -----------------------


def _reference_package():
    return SimpleNamespace(
        PodSpec=RefPodSpec, Constraints=RefConstraints, InstanceType=RefInstanceType,
        Offering=RefOffering, group_pods=ref_encode.group_pods,
        build_fleet=ref_encode.build_fleet, resource_vector=ref_encode.resource_vector,
        accel_indexes=ref_encode._ACCEL_INDEXES, consolidate=ref,
    )


@pytest.mark.parametrize("seed", [1, 2])
def test_cluster_sweep_matches_reference(seed):
    """chip_smoke's consolidation problem at a small size (60 nodes of a
    40-type catalog, 12 candidates), built through each package's own
    PodSpec, group_pods and build_fleet."""
    shapes = chip_smoke.pod_shapes(0)
    port_package = chip_smoke.port_package()
    ref_package = _reference_package()
    port_catalog = chip_smoke.make_catalog(40, package=port_package)
    ref_catalog = chip_smoke.make_catalog(40, package=ref_package)
    usable = chip_smoke.usable_capacity(port_catalog, port_package)
    np.testing.assert_array_equal(usable, chip_smoke.usable_capacity(ref_catalog, ref_package))
    vectors = chip_smoke.shape_vectors(shapes, port_package)
    np.testing.assert_array_equal(vectors, chip_smoke.shape_vectors(shapes, ref_package))
    cluster = chip_smoke.make_cluster(usable, vectors, num_nodes=60, seed=seed)
    port_problem, members, _ = chip_smoke.consolidation_problem(
        cluster, port_catalog, shapes, port_package, max_candidates=12)
    ref_problem, _, _ = chip_smoke.consolidation_problem(
        cluster, ref_catalog, shapes, ref_package, max_candidates=12)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(port_problem, name), getattr(ref_problem, name), err_msg=name)
    want = ref.solve_candidates(ref_problem)
    got = port.solve_candidates(port_problem, device="cpu")
    assert_same_verdicts(want, got, members)
    assert (got.action != port.ACTION_NONE).any()


# --- routing ----------------------------------------------------------------------


def _operands(device="cpu"):
    padded = port._padded(port.ConsolidationProblem(**random_problem(0, 3, 5, 9, 17)))
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in padded]


def test_wrapper_routes_cpu_tensors_to_plain_version():
    operands = _operands()
    before = consolidate_kernel.solve_counterfactuals.launches
    takes, eager = consolidate_kernel.solve_counterfactuals(*operands)
    assert consolidate_kernel.solve_counterfactuals.launches == before
    want = consolidate_kernel._counterfactual_ref(*operands)
    assert torch.equal(takes, want[0])
    assert torch.equal(eager, consolidate_kernel._eager_from_outputs(*want[1:]))
    c_pad, g_pad = operands[1].shape
    n_pad = operands[2].shape[0]
    assert eager.shape[0] == consolidate_kernel.eager_words(c_pad, g_pad, n_pad)
    delete_ok, replace_type, replace_price, best, best_take = consolidate_kernel.split_eager(
        eager.numpy(), c_pad, g_pad, n_pad)
    np.testing.assert_array_equal(delete_ok, want[1].numpy())
    np.testing.assert_array_equal(replace_type, want[2].numpy())
    np.testing.assert_array_equal(replace_price, want[3].numpy())
    assert best == int(want[4])
    np.testing.assert_array_equal(best_take, want[5].numpy())


@pytest.mark.parametrize("index,bad", [
    (0, lambda t: t.double()),
    (1, lambda t: t.long()),
    (3, lambda t: t.to(torch.uint8)),
    (6, lambda t: t.float()),
])
def test_wrapper_rejects_bad_dtypes(index, bad):
    operands = _operands()
    operands[index] = bad(operands[index])
    with pytest.raises(TypeError):
        consolidate_kernel.solve_counterfactuals(*operands)


@pytest.mark.parametrize("index,bad", [
    (1, lambda t: t[:, :-1]),
    (2, lambda t: t[:-1]),
    (4, lambda t: t[:, :-1]),
    (7, lambda t: t[:-1]),
    (0, lambda t: t[0]),
])
def test_wrapper_rejects_bad_shapes(index, bad):
    operands = _operands()
    operands[index] = bad(operands[index])
    with pytest.raises(ValueError):
        consolidate_kernel.solve_counterfactuals(*operands)


def test_wrapper_rejects_mixed_and_unsupported_devices():
    operands = _operands()
    operands[2] = operands[2].to("meta")
    with pytest.raises(ValueError):
        consolidate_kernel.solve_counterfactuals(*operands)
    with pytest.raises(ValueError):
        consolidate_kernel.solve_counterfactuals(*_operands("meta"))


@pytest.mark.parametrize("axes", [-1, R + 1])
def test_wrapper_rejects_axes_outside_the_vectors(axes):
    with pytest.raises(ValueError):
        consolidate_kernel.solve_counterfactuals(*_operands(), axes=axes)


def test_requested_axes_counts_one_candidates_positive_axes():
    vectors = np.zeros((3, 2, R), np.float32)
    assert consolidate_kernel.requested_axes(vectors) == 0
    vectors[0, 0, 0] = vectors[0, 1, 2] = 1.0  # candidate 0: axes 0 and 2
    vectors[1, 0, [0, 1, 5]] = 1.0  # candidate 1: three axes
    vectors[2, 1, 7] = 1.0
    assert consolidate_kernel.requested_axes(vectors) == 3
    assert consolidate_kernel.requested_axes(np.zeros((0, 4, R), np.float32)) == 0


def test_wrapper_on_cpu_ignores_the_room_size():
    """The plain version keeps the whole room: a hint below the requested
    axes changes nothing on the CPU."""
    operands = _operands()
    want = consolidate_kernel.solve_counterfactuals(*operands)
    got = consolidate_kernel.solve_counterfactuals(*operands, axes=0)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_solve_candidates_defaults_to_the_card():
    """No device means the card; without one it raises rather than run the
    plain version."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid here")
    problem = port.ConsolidationProblem(**random_problem(0, 2, 2, 3, 4))
    with pytest.raises(RuntimeError):
        port.solve_candidates(problem)


def test_fetch_bytes_counts_the_eager_buffer():
    port.solve_candidates(port.ConsolidationProblem(**random_problem(1, 3, 5, 9, 17)), device="cpu")
    assert port.LAST_FETCH_BYTES == 4 * consolidate_kernel.eager_words(8, 8, 16)


# --- K4's plain version ------------------------------------------------------------


@pytest.mark.parametrize("num_groups,density", [(8, 0.05), (16, 0.5), (64, 0.01), (64, 0.2)])
def test_compact_plan_ref_word_identical_to_reference(num_groups, density):
    """Sparse plans inside the entry budget and dense ones past it."""
    port_rounds = [chip_smoke.dense_rounds(num_groups, seed, density, "cpu") for seed in (0, 1)]
    feasible = np.random.default_rng(2).random(num_groups) < 0.7
    want = np.asarray(ref_pack.compact_plan(
        *(ref_pack.PackRounds(*(jnp.asarray(f.numpy()) for f in plan)) for plan in port_rounds),
        jnp.asarray(feasible),
    ))
    got = port_pack._compact_plan_ref(*port_rounds, torch.from_numpy(feasible))
    np.testing.assert_array_equal(got.numpy(), want)
    routed = port_pack.compact_plan(*port_rounds, torch.from_numpy(feasible))
    assert torch.equal(routed, got)


def test_compact_plan_rejects_mixed_devices():
    rounds = chip_smoke.dense_rounds(8, 0, 0.1, "cpu")
    with pytest.raises(ValueError):
        port_pack.compact_plan(rounds, rounds, torch.ones(8, dtype=torch.bool, device="meta"))


# --- the uploader and the bounds chip_smoke reports --------------------------------


def test_upload_packed_on_cpu_keeps_values_and_dtypes():
    from karpenter_tpu_torch.convert import fused_args_from_numpy, upload_packed

    rng = np.random.default_rng(0)
    arrays = [rng.random((3, 5)).astype(np.float32), np.arange(7, dtype=np.int32), rng.random(5) < 0.5]
    for array, tensor in zip(arrays, upload_packed(arrays, "cpu")):
        assert tensor.shape == array.shape
        np.testing.assert_array_equal(tensor.numpy(), array)
    args = fused_args_from_numpy(
        rng.random((4, R)), np.arange(4), rng.random((6, R)), rng.random((6, R)),
        np.ones(6, np.int64), rng.random(6), device="cpu",
    )
    assert [t.dtype for t in args] == [torch.float32, torch.int32, torch.float32, torch.float32,
                                       torch.bool, torch.float32]


def test_k7_needed_bytes_counts_only_what_the_data_needs():
    operands = [torch.from_numpy(np.ascontiguousarray(a)) for a in port._padded(
        port.ConsolidationProblem(**chip_smoke.huge_fit_problem(3)))]
    c, g, r = operands[0].shape
    n, t = operands[2].shape[0], operands[4].shape[0]
    # One requested axis on the 3 real bins (bins past them are masked off),
    # the one valid type fits both candidates.
    read = 4 * c * g * r + 4 * c * g + c * n + c * t + 4 * c + c + 4 * 3 + 4 * r + 4
    written = 4 * (c * g * n + consolidate_kernel.eager_words(c, g, n))
    assert chip_smoke.k7_needed_bytes(operands) == read + written
