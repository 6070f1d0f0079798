"""The port's mesh path against the JAX package's, on the CPU.

The reference runs its sharded programs on an 8-device virtual CPU mesh
(tests/conftest.py); the port declares the same thing, a virtual device set
of N CPU shards in one process (parallel/mesh.virtual_devices), and each
side builds its mesh over its first k devices. The same numpy inputs go
through both:

  * mesh factoring for 1, 2, 4, 7 and 8 shards, and the wedged filter;
  * the shard-local plan compaction (`compact_plan_sharded`, K9b's plain
    version): words bit-identical to the reference's shard_map program at
    2, 4 and 8 shards, a shard past its entry budget included, then the
    decode round trip; on 2x2 and 2x4 the one-card payload's plain version,
    the per-card route forced on one device and a mesh over two devices
    give the same words, and a mesh on one device is one payload call;
  * the sharded LP (K9a's plain version over the mesh) against the
    reference's GSPMD LP: the objective within rtol 1e-4 (GSPMD and the port
    sum in other orders; `objective_gaps()` below gives the measured gaps,
    2.1e-7 relative at most in two runs on an x86 CPU), pods conserved
    within 1e-3; one `sharded_lp_train_step` from a state carried
    over by `convert.lp_train_state_from_numpy`;
  * the production CostSolver on an 8-shard mesh: its decoded plans
    bit-identical to the single-device solve, $/hr at most 1.02x;
  * the route the mesh takes (the wrappers replaced by counting
    recorders): a mesh on one card is one call of the persistent K9a
    wrapper per LP, its blocks stacked in the mesh's flat order; a mesh
    across cards, and off the card one on one CPU device or two (cpu:0 and
    cpu:1), the three phase wrappers on every shard, with the same bits;
  * a wedged shard, the retry on the shrunk mesh and the quarantine after
    a failed fetch (a fake probe), and MeshHealth's cases. No test here
    spawns a process: the chip probe's subprocess is replaced by a fake.
"""

import functools
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from karpenter_tpu.models import solver as ref_solver
from karpenter_tpu.ops import pack_kernel as ref_pack
from karpenter_tpu.parallel import mesh as ref_mesh
from karpenter_tpu.parallel import sharded_solver as ref_sharded
from karpenter_tpu_torch import convert
from karpenter_tpu_torch.api import pods as port_pods
from karpenter_tpu_torch.api.provisioner import Constraints
from karpenter_tpu_torch import cloudprovider as port_cloud
from karpenter_tpu_torch.models import solver as port_solver
from karpenter_tpu_torch.ops import cuda_kernels
from karpenter_tpu_torch.ops import pack_kernel as port_pack
from karpenter_tpu_torch.ops import score_kernel as port_score
from karpenter_tpu_torch.parallel import mesh as port_mesh
from karpenter_tpu_torch.parallel import sharded_solver as port_sharded
from karpenter_tpu_torch.utils import backend_health as port_health

from tests.test_torch_solver import build, make_spec, placed_once

torch.set_num_threads(2)

# The sharded LP's objective: the port's shards and GSPMD take the softmax,
# demand and row-dot sums in other orders, so over the Adam steps the two
# trajectories drift apart by float32 rounding (the single-device parity
# tests hold the plain LP to rtol 1e-4 after 300 steps).
LP_OBJECTIVE_RTOL = 1e-4
PODS_RTOL = 1e-3


@pytest.fixture(autouse=True)
def _clean_mesh_health():
    """Every test leaves the port's process-wide quarantine set empty."""
    port_health.clear_wedged_chips()
    yield port_health.MESH
    port_health.clear_wedged_chips()


def _port_mesh(shards):
    """The port's mesh over `shards` CPU shards of one virtual set (make_mesh
    with an explicit list, as the reference's tests pass jax.devices()[:k])."""
    return port_mesh.make_mesh([port_mesh.Shard(i, torch.device("cpu")) for i in range(shards)])


def _ref_mesh(shards):
    return ref_mesh.make_mesh(jax.devices()[:shards])


# --- the mesh ------------------------------------------------------------------


@pytest.mark.parametrize("shards", [1, 2, 4, 7, 8])
def test_mesh_factoring_matches_reference(shards):
    port = _port_mesh(shards)
    reference = _ref_mesh(shards)
    assert port.shape == reference.devices.shape
    assert port.axis_names == reference.axis_names
    assert port.ids() == [int(d.id) for d in reference.devices.flat]
    assert port_mesh._factor(shards) == ref_mesh._factor(shards)


def test_virtual_set_is_the_visible_device_set():
    assert port_mesh.mesh_devices("cpu") == [port_mesh.Shard(0, torch.device("cpu"))]
    with port_mesh.virtual_devices("cpu", 8) as shards:
        assert [s.id for s in shards] == list(range(8))
        assert port_mesh.make_mesh(kind="cpu").shape == (2, 4)
        # A virtual CPU set leaves the card set alone (none here).
        assert port_mesh.mesh_devices("cuda") == []
    assert port_mesh.mesh_devices("cpu") == [port_mesh.Shard(0, torch.device("cpu"))]


def test_wedged_filter_shrinks_the_mesh():
    with port_mesh.virtual_devices("cpu", 8) as shards:
        port_health.report_chip_wedged(7, "test wedge")
        shrunk = port_mesh.make_mesh(kind="cpu")
        assert shrunk.size == 7 and shrunk.shape == (1, 7) and 7 not in shrunk.ids()
        # An explicit shard list bypasses the filter, as in the reference.
        assert port_mesh.make_mesh(shards).size == 8
        for shard in range(7):
            port_health.report_chip_wedged(shard, "test wedge")
        with pytest.raises(RuntimeError, match="no healthy devices"):
            port_mesh.make_mesh(kind="cpu")


def test_solve_mesh_selects_sharded(monkeypatch):
    monkeypatch.delenv("KARPENTER_SHARDED_SOLVE", raising=False)
    assert port_solver.solve_mesh("cpu") is None  # one device: no mesh
    with port_mesh.virtual_devices("cpu", 8):
        mesh = port_solver.solve_mesh("cpu")
        assert mesh is not None and mesh.size == 8 and mesh.shape == (2, 4)
        assert port_solver.sharded_solve_active("cpu")
        monkeypatch.setenv("KARPENTER_SHARDED_SOLVE", "0")
        assert port_solver.solve_mesh("cpu") is None
        assert not port_solver.sharded_solve_active("cpu")


def test_a_mesh_on_the_cpu_refuses_a_card_solve():
    mesh = _port_mesh(4)
    padded = port_solver.pad_kernel_args(*_example()[:5], g_mult=4, t_mult=2)
    with pytest.raises(ValueError, match="cannot run a solve on cuda"):
        port_solver._sharded_fused_solve(padded, mesh, 4, torch.device("cuda", 0))


def test_pad_kernel_args_rounds_up_to_the_mesh():
    vectors, counts, capacity, total, prices = _example()[:5]
    for g_mult, t_mult in ((8, 4), (7, 7), (4, 2)):
        port = port_solver.pad_kernel_args(vectors, counts, capacity, total, prices, g_mult, t_mult)
        reference = ref_solver.pad_kernel_args(
            vectors, counts, capacity, total, prices, g_mult=g_mult, t_mult=t_mult)
        for a, b in zip(port, reference):
            np.testing.assert_array_equal(a, b)
        # Pod tensors already on the device are padded the same way.
        on_device = port_solver.pad_kernel_args(
            torch.from_numpy(port_pack.pad_to(vectors, 8)),
            torch.from_numpy(port_pack.pad_to(counts.astype(np.int32), 8)),
            capacity, total, prices, g_mult, t_mult)
        np.testing.assert_array_equal(on_device[0].numpy(), reference[0])
        np.testing.assert_array_equal(on_device[1].numpy(), reference[1])


# --- the shard-local compaction (K9b's plain version) ----------------------------


def _rounds(seed, num_groups):
    """Random PackRounds as numpy (the reference's test_parallel.py draws)."""
    rng = np.random.default_rng(seed)
    mr = port_pack.max_rounds(num_groups)
    fill = np.zeros((mr, num_groups), np.int32)
    entries = rng.integers(0, mr * num_groups, 3 * num_groups)
    fill.ravel()[entries] = rng.integers(1, 50, len(entries)).astype(np.int32)
    return port_pack.PackRounds(
        round_type=rng.integers(0, 16, mr).astype(np.int32),
        round_fill=fill,
        round_repl=rng.integers(1, 9, mr).astype(np.int32),
        num_rounds=np.int32(rng.integers(1, mr)),
        unschedulable=rng.integers(0, 3, num_groups).astype(np.int32),
        overflow=np.int32(0),
    )


def _torch_rounds(rounds):
    return port_pack.PackRounds(*(torch.as_tensor(np.asarray(f)) for f in rounds))


def _ref_words(rounds_ffd, rounds_cost, feasible, shards):
    mesh = _ref_mesh(shards)
    tree = [ref_pack.PackRounds(*(jnp.asarray(np.asarray(f)) for f in r)) for r in (rounds_ffd, rounds_cost)]
    tree = [r._replace(overflow=r.overflow.astype(bool)) for r in tree]
    return np.asarray(jax.jit(
        lambda a, b, f: ref_pack.compact_plan_sharded(a, b, f, mesh=mesh)
    )(*tree, jnp.asarray(feasible)))


def _sharded_case(seed, num_groups, shards, overflow):
    rounds_ffd = _rounds(seed, num_groups)
    rounds_cost = _rounds(seed + 1, num_groups)
    if overflow:  # saturate shard 1's block far past its budget
        width = num_groups // shards
        fill = rounds_cost.round_fill.copy()
        fill[:, width : 2 * width] = 7
        assert (fill[:, width : 2 * width] != 0).sum() > port_pack.shard_entry_budget(num_groups, shards)
        rounds_cost = rounds_cost._replace(round_fill=fill)
    feasible = np.random.default_rng(seed).random(num_groups) < 0.8
    return rounds_ffd, rounds_cost, feasible


@pytest.mark.parametrize("overflow", [False, True], ids=["fits", "overflow"])
@pytest.mark.parametrize("shards", [2, 4, 8])
def test_sharded_compaction_words_bit_identical_to_reference(shards, overflow):
    num_groups = 32
    rounds_ffd, rounds_cost, feasible = _sharded_case(3, num_groups, shards, overflow)
    want = _ref_words(rounds_ffd, rounds_cost, feasible, shards)
    got = port_pack.compact_plan_sharded(
        _torch_rounds(rounds_ffd), _torch_rounds(rounds_cost), torch.from_numpy(feasible),
        mesh=_port_mesh(shards),
    ).numpy()
    assert got.shape == (port_pack.compact_words_sharded(num_groups, shards),)
    np.testing.assert_array_equal(got, want)
    _, _, _, ok = port_pack.decompact_plan_sharded(got, num_groups, shards)
    assert ok is not overflow


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_sharded_compaction_round_trip(shards):
    num_groups = 64
    rounds_ffd, rounds_cost, feasible = _sharded_case(5, num_groups, shards, False)
    words = port_pack.compact_plan_sharded(
        _torch_rounds(rounds_ffd), _torch_rounds(rounds_cost), torch.from_numpy(feasible),
        mesh=_port_mesh(shards),
    ).numpy()
    out_ffd, out_cost, out_feasible, ok = port_pack.decompact_plan_sharded(words, num_groups, shards)
    assert ok
    np.testing.assert_array_equal(out_feasible, feasible)
    for decoded, original in ((out_ffd, rounds_ffd), (out_cost, rounds_cost)):
        for field in ("round_type", "round_fill", "round_repl", "num_rounds", "unschedulable"):
            np.testing.assert_array_equal(
                np.asarray(getattr(decoded, field)), np.asarray(getattr(original, field)), err_msg=field)
    # The reference's decoder reads the port's words the same way.
    ref_ffd, _, ref_feasible, ref_ok = ref_pack.decompact_plan_sharded(words, num_groups, shards)
    assert ref_ok
    np.testing.assert_array_equal(ref_ffd.round_fill, out_ffd.round_fill)
    np.testing.assert_array_equal(ref_feasible, out_feasible)


def test_single_shard_layout_is_the_dense_layout():
    num_groups = 16
    assert port_pack.compact_words_sharded(num_groups, 1) == port_pack.compact_words(num_groups)
    rounds = [_torch_rounds(_rounds(seed, num_groups)) for seed in (5, 6)]
    feasible = torch.ones(num_groups, dtype=torch.bool)
    dense = port_pack.compact_plan(*rounds, feasible).numpy()
    one = port_pack.compact_plan_sharded(*rounds, feasible, mesh=_port_mesh(1)).numpy()
    np.testing.assert_array_equal(one, dense)
    via_sharded = port_pack.decompact_plan_sharded(dense, num_groups, 1)
    via_dense = port_pack.decompact_plan(dense, num_groups)
    for a, b in zip(via_sharded[:2], via_dense[:2]):
        np.testing.assert_array_equal(a.round_fill, b.round_fill)


def test_compact_shard_plain_version_is_the_reference_block_compaction():
    """K9b's plain version, one shard at a time, equals the reference's
    _compact_entry_block on the same block."""
    num_groups, shards = 32, 4
    rounds_ffd, rounds_cost, _ = _sharded_case(9, num_groups, shards, True)
    budget = port_pack.shard_entry_budget(num_groups, shards)
    width = num_groups // shards
    for shard in range(shards):
        got = port_pack.compact_shard(
            torch.from_numpy(rounds_ffd.round_fill), torch.from_numpy(rounds_cost.round_fill),
            shard, shards).numpy()
        for mode, rounds in enumerate((rounds_ffd, rounds_cost)):
            block = jnp.asarray(rounds.round_fill[:, shard * width : (shard + 1) * width])
            want = np.asarray(ref_pack._compact_entry_block(block, budget))
            np.testing.assert_array_equal(got[mode], want)


@functools.lru_cache(maxsize=None)
def _ref_case_words(seed, num_groups, shards, overflow):
    return _ref_words(*_sharded_case(seed, num_groups, shards, overflow), shards)


# K9b's routes: the one-card payload's plain version, the per-card route
# forced on one device (runs of 1 and of 3 shards, each run as if it lay on
# a card of its own), and a mesh over two devices (its shards alternate, so
# the per-device segments come back out of the mesh's flat order).
K9B_ROUTES = ["payload", "per_card_1", "per_card_3", "two_devices"]


@pytest.mark.parametrize("route", K9B_ROUTES)
@pytest.mark.parametrize("overflow", [False, True], ids=["fits", "overflow"])
@pytest.mark.parametrize("shards", [4, 8], ids=["2x2", "2x4"])
def test_sharded_compaction_routes_give_the_reference_words(shards, overflow, route):
    num_groups = 32
    rounds_ffd, rounds_cost, feasible = _sharded_case(7, num_groups, shards, overflow)
    want = _ref_case_words(7, num_groups, shards, overflow)
    args = (_torch_rounds(rounds_ffd), _torch_rounds(rounds_cost), torch.from_numpy(feasible))
    if route == "payload":
        got = port_pack._compact_sharded_payload_ref(*args, shards)
    elif route == "two_devices":
        got = port_pack.compact_plan_sharded(*args, mesh=_two_device_mesh(shards))
    else:
        got = port_pack.compact_plan_sharded(*args, mesh=_port_mesh(shards), per_card=int(route[-1]))
    np.testing.assert_array_equal(got.numpy(), want)
    _, _, _, ok = port_pack.decompact_plan_sharded(got.numpy(), num_groups, shards)
    assert ok is not overflow


@pytest.fixture
def k9b_calls(monkeypatch):
    """K9b's two wrappers counted: {"payload": calls, "shards": the shard
    ids of each compact_shards call}."""
    calls = {"payload": 0, "shards": []}
    payload, shards = port_pack.compact_sharded_payload, port_pack.compact_shards

    def counted_payload(*args):
        calls["payload"] += 1
        return payload(*args)

    def counted_shards(fill_ffd, fill_cost, shard_ids, count):
        calls["shards"].append(list(shard_ids))
        return shards(fill_ffd, fill_cost, shard_ids, count)

    monkeypatch.setattr(port_pack, "compact_sharded_payload", counted_payload)
    monkeypatch.setattr(port_pack, "compact_shards", counted_shards)
    return calls


@pytest.mark.parametrize("shards", [4, 8])
def test_sharded_compaction_takes_one_call_a_card(shards, k9b_calls):
    """Shards on one device: one compact_sharded_payload call, none of the
    per-card route. per_card=3: a compact_shards call a run of three. Two
    devices: one compact_shards call a device, its shards in flat order."""
    args = [_torch_rounds(r) for r in _sharded_case(5, 32, shards, False)[:2]]
    feasible = torch.ones(32, dtype=torch.bool)
    port_pack.compact_plan_sharded(*args, feasible, mesh=_port_mesh(shards))
    assert k9b_calls == {"payload": 1, "shards": []}
    port_pack.compact_plan_sharded(*args, feasible, mesh=_port_mesh(shards), per_card=3)
    flat = list(range(shards))
    assert k9b_calls == {"payload": 1, "shards": [flat[k : k + 3] for k in range(0, shards, 3)]}
    k9b_calls["shards"].clear()
    port_pack.compact_plan_sharded(*args, feasible, mesh=_two_device_mesh(shards))
    assert k9b_calls == {"payload": 1, "shards": [flat[0::2], flat[1::2]]}


def test_per_card_route_groups_shards_by_device():
    mesh = _two_device_mesh(8)
    cpu0, cpu1 = torch.device("cpu", 0), torch.device("cpu", 1)
    assert port_pack._card_shards(mesh, None) == [(cpu0, [0, 2, 4, 6]), (cpu1, [1, 3, 5, 7])]
    assert port_pack._card_shards(mesh, 3) == [(cpu0, [0, 2, 4]), (cpu0, [6]), (cpu1, [1, 3, 5]), (cpu1, [7])]
    assert port_pack._card_shards(_port_mesh(4), 2) == [(torch.device("cpu"), [0, 1]), (torch.device("cpu"), [2, 3])]


# --- the sharded LP (K9a's plain version) ------------------------------------------


def _example():
    return __graft_entry__._example_problem(num_groups=8, num_types=16)


def _lp_family(seed):
    """chip_smoke's non-degenerate LP family (8 x 16), effective prices."""
    import chip_smoke

    vectors, counts, capacity, valid, prices = chip_smoke.lp_problem(seed)
    effective = cuda_kernels._dominance_prices_ref(
        torch.from_numpy(capacity), torch.from_numpy(np.where(valid, prices, np.inf).astype(np.float32)))
    return vectors, counts, capacity, valid, effective.numpy()


LP_CASES = {"example": lambda: _example()[:3] + _example()[4:], "family0": lambda: _lp_family(0),
            "family3": lambda: _lp_family(3)}


def _sharded_lp_pair(case, shards, steps=50):
    """(reference, port) sharded LP results on one case and mesh size."""
    vectors, counts, capacity, valid, prices = LP_CASES[case]()
    want = ref_sharded.sharded_lp_solve(
        vectors, counts, capacity, valid, prices, steps=steps, mesh=_ref_mesh(shards))
    got = port_sharded.sharded_lp_solve(
        vectors, counts, capacity, valid, prices, steps=steps, mesh=_port_mesh(shards))
    return want, got


def objective_gaps():
    """{(case, shards): relative objective gap} of the port's sharded LP to
    the reference's, over the cases and meshes the test below runs:
    `JAX_PLATFORMS=cpu python -c "import tests.test_torch_parallel as t;
    print(t.objective_gaps())"` (with tests/conftest.py's 8-device mesh
    set up first, as pytest does)."""
    gaps = {}
    for case in sorted(LP_CASES):
        for shards in (2, 4, 8):
            want, got = _sharded_lp_pair(case, shards)
            gaps[case, shards] = abs(float(got.objective) - float(want.objective)) / abs(float(want.objective))
    return gaps


@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("case", sorted(LP_CASES))
def test_sharded_lp_matches_reference(case, shards):
    counts = LP_CASES[case]()[1]
    want, got = _sharded_lp_pair(case, shards)
    assert np.isfinite(float(got.objective))
    np.testing.assert_allclose(float(got.objective), float(want.objective), rtol=LP_OBJECTIVE_RTOL)
    np.testing.assert_allclose(float(got.assignment.sum()), counts.sum(), rtol=PODS_RTOL)
    assert got.assignment.shape == tuple(np.asarray(want.assignment).shape)


def test_sharded_lp_equals_the_single_device_lp():
    """Over the mesh, the same LP as the port's single-device plain LP."""
    vectors, counts, capacity, valid, prices = _lp_family(4)
    single = port_score.lp_relax_body(
        *(torch.from_numpy(np.asarray(a)) for a in (vectors, counts, capacity, valid, prices)), steps=300)
    got = port_sharded.sharded_lp_solve(vectors, counts, capacity, valid, prices, steps=300, mesh=_port_mesh(8))
    np.testing.assert_allclose(float(got.objective), float(single.objective), rtol=LP_OBJECTIVE_RTOL)
    np.testing.assert_allclose(got.assignment.numpy(), single.assignment.numpy(), atol=1e-3)


def test_sharded_lp_at_north_star_shape():
    """256 groups x 400 types (~50k pods), 24 steps (the reference's
    tests/test_parallel.py:100-127)."""
    rng = np.random.default_rng(7)
    num_groups, num_types = 256, 400
    vectors = np.zeros((num_groups, 8), np.float32)
    vectors[:, 0] = rng.integers(1, 17, num_groups) * 125.0
    vectors[:, 1] = rng.integers(1, 33, num_groups) * 128.0
    vectors[:, 2] = 1.0
    counts = rng.integers(150, 250, num_groups).astype(np.int32)
    sizes = 1.0 + np.arange(num_types, dtype=np.float32) % 100
    capacity = np.zeros((num_types, 8), np.float32)
    capacity[:, 0] = 4000.0 * sizes
    capacity[:, 1] = 16384.0 * sizes
    capacity[:, 2] = 110.0
    valid = np.ones(num_types, bool)
    prices = (0.05 * sizes * rng.uniform(0.8, 1.2, num_types)).astype(np.float32)
    want = ref_sharded.sharded_lp_solve(vectors, counts, capacity, valid, prices, steps=24, mesh=_ref_mesh(8))
    got = port_sharded.sharded_lp_solve(vectors, counts, capacity, valid, prices, steps=24, mesh=_port_mesh(8))
    assert np.isfinite(float(got.objective)) and torch.isfinite(got.assignment).all()
    np.testing.assert_allclose(float(got.assignment.sum()), counts.sum(), rtol=PODS_RTOL)
    np.testing.assert_allclose(float(got.objective), float(want.objective), rtol=LP_OBJECTIVE_RTOL)


@pytest.mark.parametrize("shards", [4, 8])
def test_train_step_from_a_carried_state(shards):
    """One sharded_lp_train_step on both packages from the same state: the
    reference's state after 5 steps, carried over by convert."""
    vectors, counts, capacity, valid, prices = _lp_family(1)
    counts = counts.astype(np.float32)
    feasible = np.asarray(ref_sharded.feasibility_mask(vectors, capacity, valid))
    density = prices / np.maximum(capacity.max(axis=1), 1.0)
    logits0 = np.broadcast_to(-np.log(density + 1e-9), feasible.shape).astype(np.float32)
    ref_step, _ = ref_sharded.sharded_lp_train_step(_ref_mesh(shards))
    state = ref_sharded.lp_train_init(jnp.asarray(logits0))
    for _ in range(5):
        state, _ = ref_step(state, vectors, counts, capacity, prices, feasible)
    adam = state.opt_state[0]
    port_state = convert.lp_train_state_from_numpy(
        np.asarray(state.logits), np.asarray(adam.mu), np.asarray(adam.nu), int(adam.count),
        _port_mesh(shards))
    want_state, want_loss = ref_step(state, vectors, counts, capacity, prices, feasible)
    port_step, mesh = port_sharded.sharded_lp_train_step(_port_mesh(shards))
    got_state, got_loss = port_step(port_state, vectors, counts, capacity, prices, feasible)
    assert got_state.count == int(want_state.opt_state[0].count) == 6
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)
    from karpenter_tpu_torch.parallel.collectives import assemble

    np.testing.assert_allclose(
        assemble(mesh, got_state.logits).numpy(), np.asarray(want_state.logits), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        assemble(mesh, got_state.nu).numpy(), np.asarray(want_state.opt_state[0].nu), rtol=1e-4, atol=1e-12)


# --- the route the mesh takes: one persistent launch, or the phases ---------------


@pytest.fixture
def routed(monkeypatch):
    """K9a's wrappers replaced by recorders that count their calls: the
    three phases hand theirs on (the plain versions, on CPU tensors), the
    persistent one, which takes CUDA tensors only, records its arguments,
    writes each shard's index into its stacked logits and returns zeros of
    its outputs' shapes. {"shard_lp": calls, "phases":
    calls, "args": the persistent wrapper's last arguments}."""
    from karpenter_tpu_torch.ops import lp_shard_kernel

    calls = {"shard_lp": 0, "phases": 0}

    def counted(real):
        def call(*args, **kwargs):
            calls["phases"] += 1
            return real(*args, **kwargs)

        return call

    def shard_lp(vectors, counts, capacity, prices, feasible, logits, mu, nu, bias, steps, mesh_shape,
                 final=True):
        calls["shard_lp"] += 1
        calls["args"] = (vectors, counts, capacity, prices, feasible, logits, steps, mesh_shape, final)
        for shard in range(logits.shape[0]):
            logits[shard] = shard
        demand = torch.zeros((mesh_shape[1], feasible.shape[2], vectors.shape[2]))
        return (torch.zeros_like(logits) if final else None), demand

    monkeypatch.setattr(lp_shard_kernel, "shard_lp", shard_lp)
    for name in ("shard_softmax", "shard_demand", "shard_row_dot"):
        monkeypatch.setattr(lp_shard_kernel, name, counted(getattr(lp_shard_kernel, name)))
    return calls


def _card_mesh(shards, cards):
    """A mesh of `shards` shards over `cards` cards, shard i on cuda:(i %
    cards). Its route follows from its devices; no tensor is made."""
    return port_mesh.make_mesh([port_mesh.Shard(i, torch.device("cuda", i % cards)) for i in range(shards)])


def _two_device_mesh(shards):
    """A mesh whose shards alternate between two devices (cpu:0 and cpu:1:
    distinct devices to the mesh, one memory to torch)."""
    return port_mesh.make_mesh([port_mesh.Shard(i, torch.device("cpu", i % 2)) for i in range(shards)])


def _problem(mesh):
    vectors, counts, capacity, valid, prices = _lp_family(2)
    arrays = [np.asarray(vectors, np.float32), np.asarray(counts, np.float32),
              np.asarray(capacity, np.float32), np.asarray(valid, bool), np.asarray(prices, np.float32)]
    return port_sharded.shard_lp_problem(mesh, port_sharded._replicas(mesh, arrays))


def _blocks(mesh, steps):
    return port_sharded.sharded_lp_blocks(mesh, _problem(mesh), steps)


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_one_device_mesh_takes_the_persistent_kernel(shards, routed):
    """A mesh on one card routes to the persistent kernel; that route is
    one call of its wrapper an LP, with the blocks stacked in the mesh's
    flat order and the state's blocks updated from it."""
    assert port_sharded._route(_card_mesh(shards, 1)) is port_sharded._run_persistent
    mesh = _port_mesh(shards)
    problem = _problem(mesh)
    state = port_sharded.lp_train_init(mesh, problem)
    bias = {mesh.devices[0]: torch.zeros((7, 2))}
    assignment, demand = port_sharded._run_persistent(mesh, problem, state, bias, 7, True)
    assert routed["shard_lp"] == 1 and routed["phases"] == 0
    vectors, counts, capacity, prices, feasible, _, steps, mesh_shape, final = routed["args"]
    rows, cols = mesh.shape
    assert (steps, mesh_shape, final) == (7, mesh.shape, True)
    for r in range(rows):
        assert torch.equal(vectors[r], problem.vectors[r][0]) and torch.equal(counts[r], problem.counts[r][0])
        for c in range(cols):
            assert torch.equal(feasible[r * cols + c], problem.feasible[r][c])
            assert torch.equal(capacity[c], problem.capacity[r][c]) and torch.equal(prices[c], problem.prices[r][c])
            assert bool((state.logits[r][c] == r * cols + c).all())
            assert assignment[r][c].shape == problem.feasible[r][c].shape
    assert demand[0][cols - 1].shape == (problem.capacity[0][cols - 1].shape)


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_mesh_on_two_devices_takes_the_per_phase_kernels(shards, routed):
    """A mesh across cards routes to the per-phase kernels; on two CPU
    devices (cpu:0 and cpu:1) that route calls the phases on every shard,
    with the same bits as on one CPU device (the collectives reduce in a
    fixed shard order). Off the card every mesh takes that route, its
    wrappers running the plain versions."""
    assert port_sharded._route(_card_mesh(shards, 2)) is port_sharded._run_phases
    mesh = _two_device_mesh(shards)
    assert len(mesh.devices) == 2 and port_sharded._route(mesh) is port_sharded._run_phases
    lp = _blocks(mesh, 7)
    # Per shard: two softmaxes to start, three phases a step, the final demand.
    assert routed["phases"] == shards * (2 + 3 * 7 + 1) and routed["shard_lp"] == 0
    one_mesh = _port_mesh(shards)
    assert port_sharded._route(one_mesh) is port_sharded._run_phases
    one = _blocks(one_mesh, 7)
    assert float(lp.objective) == float(one.objective)
    from karpenter_tpu_torch.parallel.collectives import assemble

    assert torch.equal(assemble(mesh, lp.assignment), assemble(one_mesh, one.assignment))


def test_persistent_kernel_takes_cuda_tensors_only():
    from karpenter_tpu_torch.ops import lp_shard_kernel

    mesh = _port_mesh(4)
    problem = _problem(mesh)
    state = port_sharded.lp_train_init(mesh, problem)
    with pytest.raises(ValueError, match="CUDA tensors"):
        port_sharded._run_persistent(mesh, problem, state, {mesh.devices[0]: torch.zeros((7, 2))}, 7, True)
    assert lp_shard_kernel.shard_lp.launches == 0


@pytest.mark.parametrize("two_devices", [False, True], ids=["one-device", "two-devices"])
def test_train_step_takes_the_route_of_its_mesh(two_devices, routed, monkeypatch):
    """One train step: on a one-card mesh one call of the persistent
    wrapper without the final pass; across devices the phases (two
    softmaxes, then the step's three) on every shard."""
    vectors, counts, capacity, valid, prices = _lp_family(1)
    feasible = np.asarray(port_score.feasibility_mask(
        torch.from_numpy(vectors), torch.from_numpy(capacity), torch.from_numpy(valid)))
    mesh = _two_device_mesh(4) if two_devices else _port_mesh(4)
    if not two_devices:
        # The CPU mesh given the one-card mesh's route.
        monkeypatch.setattr(port_sharded, "_route", lambda mesh: port_sharded._run_persistent)
    logits = np.zeros(feasible.shape, np.float32)
    state = convert.lp_train_state_from_numpy(logits, logits, logits, 0, mesh)
    step, _ = port_sharded.sharded_lp_train_step(mesh)
    state, loss = step(state, vectors, counts.astype(np.float32), capacity, prices, feasible)
    assert state.count == 1 and np.isfinite(float(loss))
    if two_devices:
        assert routed["shard_lp"] == 0 and routed["phases"] == 4 * (2 + 3)
    else:
        assert routed["shard_lp"] == 1 and routed["phases"] == 0 and routed["args"][6:] == (1, (2, 2), False)


# --- the production solve on a mesh ------------------------------------------------


@pytest.fixture
def device_path(monkeypatch):
    monkeypatch.setenv("KARPENTER_HOST_SOLVE", "0")
    monkeypatch.delenv("KARPENTER_SHARDED_SOLVE", raising=False)


def _workload(num_pods=5000, num_types=24, seed=3):
    return build(make_spec(seed, num_pods=num_pods, num_types=num_types), port_pods, port_cloud)


def _fetched(groups, fleet, lp_steps=60):
    handle = port_solver.cost_solve_dispatch(
        groups.vectors, groups.counts, fleet.capacity, fleet.total, fleet.prices, lp_steps, device="cpu")
    return handle, port_solver.fetch_plan(handle)


def test_production_solve_on_an_8_shard_mesh(device_path):
    from karpenter_tpu_torch.ops.encode import build_fleet, group_pods

    pods, catalog = _workload()
    groups = group_pods(pods)
    fleet = build_fleet(catalog, Constraints(), pods)
    single_handle, single = _fetched(groups, fleet)
    single_result = port_solver.CostSolver(lp_steps=60, device="cpu").solve(pods, catalog, Constraints())
    with port_mesh.virtual_devices("cpu", 8):
        handle, sharded = _fetched(groups, fleet)
        sharded_result = port_solver.CostSolver(lp_steps=60, device="cpu").solve(pods, catalog, Constraints())
    assert handle.shards == 8 and single_handle.shards == 1
    assert handle.num_groups == single_handle.num_groups
    for name in ("rounds_ffd", "rounds_cost"):
        for a, b in zip(getattr(sharded, name), getattr(single, name)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)
    np.testing.assert_array_equal(sharded.feasible_any, single.feasible_any)
    np.testing.assert_allclose(sharded.lp_objective, single.lp_objective, rtol=LP_OBJECTIVE_RTOL)
    np.testing.assert_allclose(sharded.lp_assignment(), single.lp_assignment(), atol=PODS_RTOL * 10)
    assert placed_once(sharded_result, pods) and not sharded_result.unschedulable
    assert sharded_result.projected_cost() <= single_result.projected_cost() * 1.02 + 1e-6


def test_shrunk_mesh_solve_places_every_pod(device_path):
    """A wedged shard: the solve runs over the 7 survivors (1x7, T padded
    to a multiple of 7) and still places every pod."""
    pods, catalog = _workload(num_pods=600, num_types=16, seed=4)
    with port_mesh.virtual_devices("cpu", 8):
        port_health.report_chip_wedged(7, "test wedge")
        from karpenter_tpu_torch.ops.encode import build_fleet, group_pods

        groups = group_pods(pods)
        fleet = build_fleet(catalog, Constraints(), pods)
        handle, plan = _fetched(groups, fleet, lp_steps=8)
        result = port_solver.CostSolver(lp_steps=8, device="cpu").solve(pods, catalog, Constraints())
    assert handle.shards == 7 and handle.num_groups % 7 == 0 and handle.num_types % 7 == 0
    assert np.isfinite(plan.lp_objective)
    assert np.isclose(plan.lp_assignment().sum(), groups.counts.sum(), rtol=PODS_RTOL)
    assert placed_once(result, pods) and not result.unschedulable


def test_all_but_one_wedged_pins_the_survivor(monkeypatch):
    monkeypatch.delenv("KARPENTER_SHARDED_SOLVE", raising=False)
    with port_mesh.virtual_devices("cpu", 8):
        for shard in range(7):
            port_health.report_chip_wedged(shard, "test wedge")
        assert port_solver.sharded_solve_active("cpu")
        survivor = port_solver.solve_mesh("cpu")
        assert survivor is not None and survivor.ids() == [7]
        assert not port_health.BACKEND.degraded()


def test_host_gate_stays_closed_on_a_mesh(monkeypatch):
    monkeypatch.delenv("KARPENTER_HOST_SOLVE", raising=False)
    monkeypatch.delenv("KARPENTER_SHARDED_SOLVE", raising=False)
    from karpenter_tpu_torch.ops import native

    if not native.available():
        pytest.skip("needs the host library")
    assert port_solver.host_solve_enabled(100, device="cpu")
    with port_mesh.virtual_devices("cpu", 4):
        assert not port_solver.host_solve_enabled(100, device="cpu")


# --- dispatch retry and fetch quarantine ----------------------------------------------


def _fake_quarantine(wedged_id):
    def quarantine(device_ids, error):
        port_health.report_chip_wedged(wedged_id, f"test: {error}")
        return [wedged_id]

    return quarantine


def test_wedged_dispatch_quarantines_and_retries_on_shrunk_mesh(monkeypatch):
    monkeypatch.delenv("KARPENTER_SHARDED_SOLVE", raising=False)
    real = port_solver._sharded_fused_solve
    meshes = []

    def failing_once(padded, mesh, lp_steps, device):
        meshes.append(mesh)
        if len(meshes) == 1:
            raise RuntimeError("simulated card wedge")
        return real(padded, mesh, lp_steps, device)

    monkeypatch.setattr(port_solver, "_sharded_fused_solve", failing_once)
    monkeypatch.setattr(port_health, "quarantine_mesh", _fake_quarantine(7))
    vectors, counts, capacity, total, valid, prices = _example()
    with port_mesh.virtual_devices("cpu", 8):
        mesh = port_solver.solve_mesh("cpu")
        assert mesh.size == 8
        out, padded, shards = port_solver._dispatch_sharded(
            vectors, counts, capacity, total, prices, 4, mesh, torch.device("cpu"))
    assert shards == 7 and meshes[-1].size == 7 and 7 not in meshes[-1].ids()
    assert len(meshes) == 2
    assert padded[0].shape[0] % 7 == 0 and padded[2].shape[0] % 7 == 0


def test_no_wedged_card_reraises(monkeypatch):
    monkeypatch.delenv("KARPENTER_SHARDED_SOLVE", raising=False)

    def always_fails(padded, mesh, lp_steps, device):
        raise RuntimeError("not a card problem")

    monkeypatch.setattr(port_solver, "_sharded_fused_solve", always_fails)
    monkeypatch.setattr(port_health, "quarantine_mesh", lambda device_ids, error: [])
    vectors, counts, capacity, total, valid, prices = _example()
    with port_mesh.virtual_devices("cpu", 8):
        mesh = port_solver.solve_mesh("cpu")
        with pytest.raises(RuntimeError, match="not a card problem"):
            port_solver._dispatch_sharded(
                vectors, counts, capacity, total, prices, 4, mesh, torch.device("cpu"))


def test_fetch_failure_quarantines_sharded_handles(monkeypatch):
    """A failed fetch of sharded outputs runs the quarantine over every
    mesh id (so the next dispatch shrinks the mesh) and still raises; a
    single-device handle's does not."""
    quarantined = []
    monkeypatch.setattr(
        port_health, "quarantine_mesh",
        lambda device_ids, error: quarantined.append(list(device_ids)) or [],
    )

    def exploding_fetch(handles):
        raise RuntimeError("card died mid-solve")

    monkeypatch.setattr(port_solver, "_eager_words", exploding_fetch)
    empty = torch.zeros(4, dtype=torch.int32)
    handle = port_solver.FusedHandle(
        compact=empty, objective=torch.zeros(1), dense=empty, lp=torch.zeros(4),
        num_groups=8, num_types=16, shards=8, staged=[],
    )
    with port_mesh.virtual_devices("cpu", 8):
        with pytest.raises(RuntimeError, match="card died"):
            port_solver.fetch_plans([handle])
        assert quarantined == [list(range(8))]
        quarantined.clear()
        with pytest.raises(RuntimeError, match="card died"):
            port_solver.fetch_plans([handle._replace(shards=1)])
    assert not quarantined


# --- MeshHealth (the reference's tests/test_backend_health.py:410-560) ------------------


def test_report_and_clear(_clean_mesh_health):
    assert not port_health.mesh_degraded()
    port_health.report_chip_wedged(3, "test wedge")
    assert port_health.mesh_degraded()
    assert port_health.wedged_chips() == {3: "test wedge"}
    _clean_mesh_health.clear(3)
    assert not port_health.mesh_degraded()


def test_gauge_tracks_quarantine_size():
    port_health.report_chip_wedged(1, "a")
    port_health.report_chip_wedged(2, "b")
    assert port_health.WEDGED_CHIPS.get() == 2.0
    port_health.clear_wedged_chips()
    assert port_health.WEDGED_CHIPS.get() == 0.0


class _FakeRun:
    """subprocess.run for the chip probe, without a process: prints the
    given ids, then exits or (hang=True) times out with them as partial
    output."""

    def __init__(self, ids, hang=False):
        self.ids = ids
        self.hang = hang
        self.codes = []

    def __call__(self, argv, timeout, capture_output, env):
        self.codes.append(argv[-1])
        stdout = "".join(f"CHIP_OK {i}\n" for i in self.ids).encode()
        if self.hang:
            raise subprocess.TimeoutExpired(argv, timeout, output=stdout, stderr=b"")
        return subprocess.CompletedProcess(argv, 0, stdout=stdout, stderr=b"")


def test_partial_output_names_the_survivors(monkeypatch):
    fake = _FakeRun([0, 1], hang=True)
    monkeypatch.setattr(subprocess, "run", fake)
    ok_ids, result = port_health.run_chip_probe(3.0)
    assert ok_ids == [0, 1] and not result.ok and "hung" in result.reason
    assert "torch.cuda.device_count()" in fake.codes[0]  # the torch probe, one card at a time


def test_clean_probe_reports_every_card(monkeypatch):
    monkeypatch.setattr(subprocess, "run", _FakeRun([0, 1, 2, 3]))
    ok_ids, result = port_health.run_chip_probe(30.0)
    assert ok_ids == [0, 1, 2, 3] and result.ok


def test_quarantine_marks_only_non_responders(monkeypatch):
    monkeypatch.setattr(subprocess, "run", _FakeRun([0, 1, 2], hang=True))
    assert port_health.quarantine_mesh([0, 1, 2, 3], RuntimeError("boom")) == [3]
    assert set(port_health.wedged_chips()) == {3}


def test_quarantine_with_every_card_answering_reports_nothing(monkeypatch):
    monkeypatch.setattr(subprocess, "run", _FakeRun([0, 1, 2, 3]))
    assert port_health.quarantine_mesh([0, 1, 2, 3], RuntimeError("boom")) == []
    assert not port_health.mesh_degraded()


def test_parse_chip_ok_matches_reference():
    from karpenter_tpu.utils import backend_health as ref_health

    text = "CHIP_OK 0\nnoise\nCHIP_OK 12\nCHIP_OK x\nCHIP_OK 3"
    assert port_health._parse_chip_ok(text) == ref_health._parse_chip_ok(text) == [0, 12, 3]
