"""K2's pair launch with its epilogue (`pack_pair_payload`) against the JAX
package's tail of the fused solve, on the CPU.

The epilogue takes the place of the reference's separate steps after its two
pack_kernel calls (karpenter_tpu/models/solver.py:278-303):
feasibility_mask(...).any(axis=1), jnp.where(feasible_any, counts, 0), the
dense spill's concatenation and compact_plan (K4). The port's plain version
(what the wrapper runs on a CPU tensor, and what the card's kernel is held to
word for word by tests/test_torch_cuda.py and chip_smoke.py) is held here to
that composition on the same numpy inputs: every integer output
word-identical, at G 1, 16, 33 and 64 and on dense problems whose fills
overflow the compaction's entry budget. Then the fused body on a mesh of one
shard, whose payload now comes from the same call, against the reference's
fused body.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import chip_smoke
from karpenter_tpu.models import solver as ref_solver
from karpenter_tpu.ops import encode as ref_encode
from karpenter_tpu.ops import pack_kernel as ref_pack
from karpenter_tpu.ops import score_kernel as ref_score
from karpenter_tpu.api import provisioner as ref_provisioner
from karpenter_tpu_torch.convert import fused_args_from_numpy
from karpenter_tpu_torch.models import solver as port_solver
from karpenter_tpu_torch.ops import pack_kernel as port_pack
from karpenter_tpu_torch.parallel import mesh as port_mesh

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
# The LP objective after 300 Adam steps whose sums are taken in another order
# on each side (tests/test_torch_kernels.py).
LP_OBJECTIVE_RTOL = 1e-4


def _random_problem(num_groups, seed):
    return chip_smoke.random_pack_problem(np.random.default_rng(seed), num_groups, 24)


PROBLEMS = [
    pytest.param(_random_problem(groups, seed), id=f"G{groups}-seed{seed}")
    for groups in (1, 16, 33, 64) for seed in (0, 1)
] + [
    pytest.param(chip_smoke.dense_pack_problem(seed, groups), id=f"dense-G{groups}-seed{seed}")
    for seed, groups in chip_smoke.DENSE_PACK_CASES
]


def _reference_tail(problem):
    """The reference's composition: both pack modes, then feasible_any, the
    LP's counts, the dense spill and the payload, as its fused body takes
    them."""
    vectors, counts, capacity, _, valid, _ = problem
    ffd, cost = (ref_pack.pack_kernel(*problem, quirk=False, mode=mode) for mode in ("ffd", "cost"))
    feasible_any = ref_score.feasibility_mask(vectors, capacity, valid).any(axis=1)
    solvable = jnp.where(feasible_any, counts, 0)

    def rounds_ints(r):
        return [
            r.round_type.ravel(), r.round_fill.ravel(), r.round_repl.ravel(),
            r.num_rounds.reshape(1), r.unschedulable.ravel(), r.overflow.astype(jnp.int32).reshape(1),
        ]

    dense = jnp.concatenate(rounds_ints(ffd) + rounds_ints(cost) + [feasible_any.astype(jnp.int32).ravel()])
    payload = ref_pack.compact_plan(ffd, cost, feasible_any)
    return ffd, cost, feasible_any, solvable, dense, payload


def _port(problem, payload=True):
    return port_pack.pack_pair_payload(*(torch.from_numpy(np.array(a)) for a in problem), payload=payload)


@pytest.mark.parametrize("problem", PROBLEMS)
def test_plain_version_word_identical_to_reference(problem):
    want_ffd, want_cost, want_feasible, want_solvable, want_dense, want_payload = _reference_tail(problem)
    before = port_pack.pack_pair_payload.launches
    got = _port(problem)
    assert port_pack.pack_pair_payload.launches == before  # CPU tensors: the plain version
    for rounds, want in ((got.rounds_ffd, want_ffd), (got.rounds_cost, want_cost)):
        for name, a, b in zip(rounds._fields, rounds, want):
            np.testing.assert_array_equal(a.numpy().astype(np.int64), np.asarray(b).astype(np.int64), err_msg=name)
    np.testing.assert_array_equal(got.feasible_any.numpy(), np.asarray(want_feasible))
    assert got.solvable.dtype == torch.int32 and got.dense.dtype == torch.int32
    np.testing.assert_array_equal(got.solvable.numpy(), np.asarray(want_solvable))
    np.testing.assert_array_equal(got.dense.numpy(), np.asarray(want_dense))
    np.testing.assert_array_equal(got.payload.numpy(), np.asarray(want_payload))
    num_groups = problem[0].shape[0]
    assert got.dense.shape[0] == 2 * port_pack.rounds_words(num_groups) + num_groups
    assert got.payload.shape[0] == port_pack.compact_words(num_groups)


@pytest.mark.parametrize("seed,groups", chip_smoke.DENSE_PACK_CASES, ids=lambda v: str(v))
def test_dense_cases_overflow_the_entry_budget(seed, groups):
    """The dense problems reach the budget: the payload's decode asks for
    the dense spill, and the spill decodes to the rounds."""
    got = _port(chip_smoke.dense_pack_problem(seed, groups))
    budget = port_pack.entry_budget(groups)
    assert max(int((r.round_fill != 0).sum()) for r in (got.rounds_ffd, got.rounds_cost)) > budget
    assert not port_pack.decompact_plan(got.payload.numpy(), groups)[3]
    ffd, cost, feasible = port_solver.unpack_dense(got.dense.numpy(), groups)
    for decoded, rounds in ((ffd, got.rounds_ffd), (cost, got.rounds_cost)):
        for a, b in zip(decoded, rounds):
            np.testing.assert_array_equal(np.asarray(a).astype(np.int64), b.numpy().astype(np.int64))
    np.testing.assert_array_equal(feasible, got.feasible_any.numpy())


def test_without_payload_the_rest_is_the_same():
    problem = _random_problem(16, 3)
    full, bare = _port(problem), _port(problem, payload=False)
    assert bare.payload is None
    for a, b in zip(full[:5], bare[:5]):
        if isinstance(a, tuple):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
        else:
            assert torch.equal(a, b)


def test_rounds_equal_the_plain_pair():
    problem = tuple(torch.from_numpy(np.array(a)) for a in _random_problem(33, 4))
    got = port_pack.pack_pair_payload(*problem)
    for rounds, pair in zip((got.rounds_ffd, got.rounds_cost), port_pack.pack_kernel_pair(*problem)):
        assert all(torch.equal(a, b) for a, b in zip(rounds, pair))


# --- the fused body on a mesh of one shard ---------------------------------------


@pytest.mark.parametrize("workload", [(2000, 40, 0), (1000, 24, 2)], ids=lambda w: f"{w[0]}x{w[1]}")
def test_one_shard_mesh_equals_reference_fused_body(workload):
    """A mesh of one shard (a wedged mesh shrunk to its last survivor) takes
    its payload from the pair call: the same words as the reference's fused
    body, the dense spill too, and the LP objective within its tolerance."""
    pods, catalog, _ = bench.make_workload(*workload[:2], seed=workload[2])
    groups = ref_encode.group_pods(pods)
    fleet = ref_encode.build_fleet(catalog, ref_provisioner.Constraints(), pods)
    padded = ref_solver.pad_kernel_args(groups.vectors, groups.counts, fleet.capacity, fleet.total, fleet.prices)
    want = [np.asarray(x) for x in ref_solver._cost_fused_kernel_nodonate(*padded, lp_steps=300)]
    mesh = port_mesh.make_mesh([port_mesh.Shard(0, torch.device("cpu"))])
    compacted, objective, dense, assignment = port_solver._sharded_fused_solve(
        padded, mesh, 300, torch.device("cpu"))
    np.testing.assert_array_equal(compacted.numpy(), want[0])
    np.testing.assert_array_equal(dense.numpy(), want[2])
    np.testing.assert_allclose(objective.numpy(), want[1], rtol=LP_OBJECTIVE_RTOL)
    single = port_solver._cost_fused_body(*fused_args_from_numpy(*padded, device="cpu"), lp_steps=300)
    assert torch.equal(single[0], compacted) and torch.equal(single[2], dense)
    assert assignment.cpu().shape == single[3].reshape(padded[0].shape[0], -1).shape


# --- K4 has no launch of its own -------------------------------------------------


def test_standalone_compaction_source_is_gone():
    csrc = REPO / "karpenter_tpu_torch" / "csrc"
    assert not (csrc / "compact.cu").exists()
    sources = "".join(path.read_text() for path in sorted(csrc.glob("*.cu*")))
    assert "ktt_compact_plan" not in sources and "compact_rounds(" in sources
    assert not hasattr(port_pack, "COMPACT_LIBRARY")


def test_compact_plan_raises_off_the_cpu():
    rounds = port_pack.PackRounds(*(torch.empty(shape, dtype=torch.int32, device="meta")
                                    for shape in ((40,), (40, 16), (40,), (), (16,), ())))
    with pytest.raises(ValueError, match="pack_pair_payload"):
        port_pack.compact_plan(rounds, rounds, torch.ones(16, dtype=torch.bool, device="meta"))


def test_pair_payload_raises_off_cpu_and_cuda():
    args = [torch.from_numpy(np.array(a)).to("meta") for a in _random_problem(16, 0)]
    with pytest.raises(ValueError, match="unsupported device"):
        port_pack.pack_pair_payload(*args)
