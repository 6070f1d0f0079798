"""The constrained provisioning solve of the port against the JAX package,
on the CPU.

The same inputs, made from a seed with numpy or built the same way through
each package's own classes, go through the reference and the port:

  * K6's plain version (`ops/pack_kernel.pack_kernel_levels` on CPU
    tensors) against the JAX `pack_kernel_levels` (plain JAX on the CPU)
    and the port's numpy mirror (`constraints/mirror.pack_levels_host`):
    every LevelPack field bit-identical, at G 5 as the reference's own
    parity test and at padded G' 16-64, where the order of the cost score's
    sums matters. The reference's XLA program takes pen = sum_g fill *
    penalty as a chain of fused multiply-adds up to G' 32 and as rounded
    products in windows of 32 past that; instances whose types differ only
    by a permutation of equal-fill penalties pin that order. It takes
    weighted = fills @ group_weight in the vectorised order
    `ops/pack_kernel._weighted_sums` describes; instances whose types take
    permuted counts of equal-weight groups pin that order at G' 8-256.
  * `compile_constraints` of both packages on the same schedules: the
    allow, penalty, level_counts, conflict and node_cap tensors array-equal.
  * `solve_constrained` through each package's own `Scheduler`, the port's
    `CostSolver(device="cpu")` against the reference's CostSolver on JAX's
    CPU: the same chosen level, group levels, instance-type options, node
    quantities, pods per node by uid, and $/hr within 1e-6.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

import chip_smoke

from karpenter_tpu.api import pods as ref_pods
from karpenter_tpu.api import provisioner as ref_provisioner
from karpenter_tpu.api import requirements as ref_requirements
from karpenter_tpu.api import wellknown as ref_wellknown
from karpenter_tpu import cloudprovider as ref_cloud
from karpenter_tpu.constraints import compiler as ref_compiler
from karpenter_tpu.constraints import solve as ref_solve
from karpenter_tpu.controllers import cluster as ref_cluster
from karpenter_tpu.controllers import scheduling as ref_scheduling
from karpenter_tpu.models import solver as ref_solver
from karpenter_tpu.ops import encode as ref_encode
from karpenter_tpu.ops import pack_kernel as ref_pack

from karpenter_tpu_torch.api import pods as port_pods
from karpenter_tpu_torch.api import provisioner as port_provisioner
from karpenter_tpu_torch.api import requirements as port_requirements
from karpenter_tpu_torch.api import wellknown as port_wellknown
from karpenter_tpu_torch import cloudprovider as port_cloud
from karpenter_tpu_torch.constraints import compiler as port_compiler
from karpenter_tpu_torch.constraints import mirror as port_mirror
from karpenter_tpu_torch.constraints import solve as port_solve
from karpenter_tpu_torch.controllers import cluster as port_cluster
from karpenter_tpu_torch.controllers import scheduling as port_scheduling
from karpenter_tpu_torch.models import solver as port_solver
from karpenter_tpu_torch.ops import encode as port_encode
from karpenter_tpu_torch.ops import pack_kernel as port_pack

torch.set_num_threads(2)

NODE_CAP_NONE = port_pack.NODE_CAP_NONE
ZONES = ("test-zone-1", "test-zone-2", "test-zone-3")


def _package(pods, provisioner, requirements, wellknown, cloud, compiler, solve, cluster,
             scheduling, solver, encode, pack):
    return SimpleNamespace(
        PodSpec=pods.PodSpec, PreferredTerm=pods.PreferredTerm,
        TopologySpreadConstraint=pods.TopologySpreadConstraint,
        Provisioner=provisioner.Provisioner, ProvisionerSpec=provisioner.ProvisionerSpec,
        Requirement=requirements.Requirement, wellknown=wellknown,
        InstanceType=cloud.InstanceType, Offering=cloud.Offering, NodeSpec=cloud.NodeSpec,
        compiler=compiler, solve=solve, Cluster=cluster.Cluster, Scheduler=scheduling.Scheduler,
        solver=solver, encode=encode, pack=pack,
    )


REF = _package(ref_pods, ref_provisioner, ref_requirements, ref_wellknown, ref_cloud,
               ref_compiler, ref_solve, ref_cluster, ref_scheduling, ref_solver, ref_encode,
               ref_pack)
PORT = _package(port_pods, port_provisioner, port_requirements, port_wellknown, port_cloud,
                port_compiler, port_solve, port_cluster, port_scheduling, port_solver,
                port_encode, port_pack)


# --- K6: the [L, G', T] dispatch ----------------------------------------------


def _level_instance(seed, groups, types, dims, levels, integral):
    """A seeded [L, G, T] instance in the shape of the reference's parity
    test (tests/test_constraints.py): masks, penalties, symmetric conflicts
    and per-node caps; `integral` draws pod-sized vectors and a capacity
    ladder instead of uniform floats."""
    rng = np.random.default_rng(seed)
    if integral:
        vectors = np.zeros((groups, dims), np.float32)
        vectors[:, 0] = np.sort(rng.integers(1, 17, groups))[::-1] * 250
        vectors[:, 1] = rng.integers(1, 33, groups) * 256
        capacity = np.zeros((types, dims), np.float32)
        cpu = np.sort(rng.integers(1, 65, types)) * 1000
        capacity[:, 0] = cpu - 100
        capacity[:, 1] = cpu * rng.choice([2, 4, 8], types) - 600
    else:
        vectors = np.sort(rng.uniform(0.2, 4, (groups, dims)).astype(np.float32), axis=0)[::-1].copy()
        capacity = np.sort(rng.uniform(2, 20, (types, dims)).astype(np.float32), axis=0)
    counts = rng.integers(0, 25, (levels, groups)).astype(np.int32)
    valid = rng.random(types) > 0.1
    valid[0] = True
    prices = rng.uniform(0.1, 3, types).astype(np.float32)
    allow = rng.random((levels, groups, types)) > 0.4
    penalty = rng.uniform(0, 0.05, (levels, groups, types)).astype(np.float32)
    conflict = rng.random((groups, groups)) > 0.8
    conflict = conflict | conflict.T
    np.fill_diagonal(conflict, False)
    node_cap = np.where(rng.random(groups) > 0.7, rng.integers(1, 4, groups), NODE_CAP_NONE)
    return (vectors, counts, capacity, capacity.copy(), valid, prices, allow, penalty,
            conflict, node_cap.astype(np.int32))


def _tied_penalty_instance(seed, groups):
    """Two identical types that differ only in their penalties, a
    permutation of each other among groups of equal fill: the exact pen of
    both is equal, so which type the first cost round takes is decided by
    the order and rounding of the sum alone (prices 0, one node holds every
    pod)."""
    rng = np.random.default_rng(seed)
    types, dims = 8, 3
    counts = rng.choice([3, 5, 7, 9, 11], groups).astype(np.int32)
    first = rng.uniform(0.001, 0.05, groups).astype(np.float32)
    second = first.copy()
    for count in np.unique(counts):
        index = np.nonzero(counts == count)[0]
        second[index] = first[rng.permutation(index)]
    vectors = np.full((groups, dims), 0.001, np.float32)
    capacity = np.zeros((types, dims), np.float32)
    capacity[:2] = 1000.0
    valid = np.zeros(types, bool)
    valid[:2] = True
    penalty = np.zeros((1, groups, types), np.float32)
    penalty[0, :, 0] = first
    penalty[0, :, 1] = second
    return (vectors, counts[None], capacity, capacity.copy(), valid, np.zeros(types, np.float32),
            np.ones((1, groups, types), bool), penalty, np.zeros((groups, groups), bool),
            np.full(groups, NODE_CAP_NONE, np.int32))


def _port_levels(args, mode):
    tensors = [torch.from_numpy(np.ascontiguousarray(array)) for array in args]
    return port_pack.pack_kernel_levels(*tensors, mode=mode)


def _assert_levels_equal(ref, port):
    assert int(ref.chosen_level) == int(port.chosen_level)
    assert np.array_equal(np.asarray(ref.group_level), port.group_level.numpy())
    assert np.array_equal(np.asarray(ref.level_unsched), port.level_unsched.numpy())
    for field in port_pack.PackRounds._fields:
        assert np.array_equal(
            np.asarray(getattr(ref.rounds, field)), getattr(port.rounds, field).numpy()
        ), field


LEVEL_SHAPES = [(5, 4, 3, 4), (16, 12, 3, 4), (32, 20, 3, 2), (64, 24, 3, 4)]


@pytest.mark.parametrize("mode", ["ffd", "cost"])
@pytest.mark.parametrize("integral", [False, True], ids=["uniform", "integral"])
@pytest.mark.parametrize("shape", LEVEL_SHAPES, ids=lambda s: "G{}xT{}xR{}xL{}".format(*s))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_k6_bit_identical_to_jax(seed, shape, integral, mode):
    args = _level_instance(seed, *shape, integral)
    ref = jax.device_get(ref_pack.pack_kernel_levels(*args, mode=mode))
    _assert_levels_equal(ref, _port_levels(args, mode))


@pytest.mark.parametrize("groups", [8, 16, 32, 64])
def test_plain_k6_takes_the_penalty_sum_in_the_reference_order(groups):
    for seed in range(12):
        args = _tied_penalty_instance(seed, groups)
        ref = jax.device_get(ref_pack.pack_kernel_levels(*args, mode="cost"))
        port = _port_levels(args, "cost")
        assert int(ref.rounds.round_type[0]) == int(port.rounds.round_type[0]), seed
        _assert_levels_equal(ref, port)


def _first_pick_of_a_sequential_chain(args):
    """The type the first cost round of a tied-weight instance would take
    if weighted were one chain of fused multiply-adds over ascending g."""
    vectors, counts, capacity, _, valid, _, allow, _, _, _ = (torch.from_numpy(a) for a in args)
    weight = (vectors / capacity[2].clamp(min=1.0)).amax(dim=1)
    fills = torch.where(allow[0, :, :2].T, counts[0], 0).to(torch.float32)  # [2, G]
    weighted = torch.zeros(2)
    for g in range(fills.shape[1]):
        weighted = port_pack._fma32(fills[:, g], weight[g].expand(2), weighted)
    return int(torch.argmin(1.0 / weighted))


_TIED_LEVEL_CASES = [
    pytest.param(groups, levels, 16, id=f"{groups}-{levels}")
    for levels in (1, 4) for groups in (8, 16, 32, 64, 128, 256)
] + [
    # 8 and 4 rows of levels x types: XLA orders the dot another way.
    pytest.param(groups, 1, rows, id=f"{groups}-1-T{rows}")
    for rows in chip_smoke.NARROW_ROWS for groups in (64, 128, 256)
]


@pytest.mark.parametrize("groups,levels,types", _TIED_LEVEL_CASES)
def test_plain_k6_takes_the_weighted_sum_in_the_reference_order(groups, levels, types):
    chain_misses = 0
    for seed in range(12):
        args = chip_smoke.tied_weight_levels_problem(seed, groups, levels, types=types)
        ref = jax.device_get(ref_pack.pack_kernel_levels(*args, mode="cost"))
        port = _port_levels(args, "cost")
        assert int(ref.rounds.round_type[0]) == int(port.rounds.round_type[0]), seed
        _assert_levels_equal(ref, port)
        chain_misses += _first_pick_of_a_sequential_chain(args) != int(ref.rounds.round_type[0])
    # Under 64 groups the reference's order is that chain; from 64 on it is
    # not, and these probes tell the two apart.
    assert (chain_misses > 0) == (groups >= 64)


# The mirror scans every type in Python: G' 64 once, the rest three times.
MIRROR_CASES = [(seed, shape) for seed in (0, 1, 2) for shape in LEVEL_SHAPES[:3]] + [
    (0, LEVEL_SHAPES[3])]


@pytest.mark.parametrize("mode", ["ffd", "cost"])
@pytest.mark.parametrize("seed,shape", MIRROR_CASES,
                         ids=lambda c: "G{}xT{}xR{}xL{}".format(*c) if isinstance(c, tuple) else str(c))
def test_plain_k6_equals_the_mirror(seed, shape, mode):
    args = _level_instance(seed, *shape, integral=True)
    vectors, counts, capacity, _, valid, prices, allow, penalty, conflict, node_cap = args
    host = port_mirror.pack_levels_host(
        vectors, counts, capacity, valid, prices, allow, penalty, conflict, node_cap, mode=mode)
    port = _port_levels(args, mode)
    assert host.chosen_level == int(port.chosen_level)
    assert np.array_equal(host.group_level, port.group_level.numpy())
    assert np.array_equal(host.level_unsched, port.level_unsched.numpy())
    assert np.array_equal(host.unschedulable, port.rounds.unschedulable.numpy())
    assert host.overflow == bool(port.rounds.overflow)
    assert len(host.rounds) == int(port.rounds.num_rounds)
    for r, (t, fill, repl) in enumerate(host.rounds):
        assert t == int(port.rounds.round_type[r])
        assert np.array_equal(fill, port.rounds.round_fill[r].numpy())
        assert repl == int(port.rounds.round_repl[r])


def test_plain_k6_retires_groups_no_type_admits():
    # Level 0 masks group 0 out everywhere: its pods go to unschedulable
    # before the first round, and the strictest feasible level (1) wins.
    args = list(_level_instance(3, 5, 4, 3, 3, integral=True))
    args[1][:] = 4
    args[6][:] = True
    args[6][0, 0, :] = False
    args[9][:] = NODE_CAP_NONE
    args[8][:] = False
    ref = jax.device_get(ref_pack.pack_kernel_levels(*args, mode="cost"))
    port = _port_levels(args, "cost")
    _assert_levels_equal(ref, port)
    assert int(port.level_unsched[0, 0]) == 4 and int(port.chosen_level) == 1


def test_chip_smoke_k6_cases_use_the_kernel_sentinel():
    import chip_smoke

    assert chip_smoke.NODE_CAP_NONE == port_pack.NODE_CAP_NONE == ref_pack.NODE_CAP_NONE
    names = [name for name, _, _ in chip_smoke.k6_cases()]
    assert len(names) == len(set(names)) == 2 * len(chip_smoke.K6_SHAPES)


def test_fma32_rounds_once():
    rng = np.random.default_rng(5)
    a = (rng.integers(0, 200, 4000)).astype(np.float32)
    b = (rng.random(4000) * np.exp(rng.normal(0, 6, 4000))).astype(np.float32)
    c = (rng.random(4000) * np.exp(rng.normal(0, 6, 4000))).astype(np.float32)
    got = port_pack._fma32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    from fractions import Fraction

    for x, y, z, value in zip(a[:600], b[:600], c[:600], got[:600]):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        below = np.nextafter(value, np.float32(-np.inf))
        above = np.nextafter(value, np.float32(np.inf))
        error = abs(Fraction(float(value)) - exact)
        assert error <= abs(Fraction(float(below)) - exact)
        assert error <= abs(Fraction(float(above)) - exact)


@pytest.mark.parametrize("shape", [(64, 512, 8), (16, 8192, 8), (2048, 512, 8), (8192, 8192, 8)],
                         ids=lambda s: "G{}xT{}".format(*s[:2]))
def test_levels_plan_fits_the_card(shape):
    groups, types, dims = shape
    plan = port_pack.levels_launch_plan(groups, types, dims)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= port_pack.MAX_THREADS
    assert plan.threads >= min(plan.types_per_block * plan.lanes, port_pack.MAX_THREADS)
    assert plan.cluster * plan.types_per_block >= types
    assert plan.shared_bytes <= port_pack.SHARED_LIMIT
    tables = 4 * port_pack.levels_table_words(groups, plan.types_per_block, dims)
    fills = 4 * port_pack.levels_fill_words(groups, plan.types_per_block)
    control = port_pack._LEVELS_CONTROL_BYTES
    assert plan.tables_in_shared == (control + tables <= port_pack.SHARED_LIMIT)
    assert plan.fills_in_shared == (
        plan.tables_in_shared and control + tables + fills <= port_pack.SHARED_LIMIT)
    assert plan.placed_in_registers == (groups <= 256)


def test_levels_plan_at_the_constrained_path_shape():
    # G' 64, T 512: a cluster of 8 blocks of 64 types a level, 8 lanes a
    # type (one an axis), tables and fills in shared memory, the placed bits
    # in registers.
    plan = port_pack.levels_launch_plan(64, 512, 8)
    assert (plan.cluster, plan.lanes, plan.types_per_block, plan.threads, plan.fills_in_shared,
            plan.tables_in_shared, plan.placed_in_registers) == (8, 8, 64, 512, True, True, True)


def test_level_pack_words_match_the_views():
    words = torch.arange(port_pack.level_pack_words(16, 4), dtype=torch.int32)
    pack = port_pack.level_pack_from_words(words, 16, 4)
    sizes = [field.numel() for field in pack.rounds] + [
        pack.chosen_level.numel(), pack.group_level.numel(), pack.level_unsched.numel()]
    assert sum(sizes) == words.numel()
    host = port_pack.level_pack_to_host(pack)
    assert int(host.chosen_level) == int(pack.chosen_level)
    assert np.array_equal(host.rounds.round_fill, pack.rounds.round_fill.numpy())


# --- scenarios through each package's Scheduler -------------------------------


def _catalog(pkg):
    """A ladder of general-purpose types in three zones, on-demand and spot."""
    catalog = []
    for size in (1, 2, 4, 8, 16):
        price = 0.05 * size
        offerings = []
        for zone in ZONES:
            offerings.append(pkg.Offering(zone=zone, capacity_type="on-demand", price=price))
            offerings.append(pkg.Offering(zone=zone, capacity_type="spot", price=price * 0.7))
        catalog.append(pkg.InstanceType(
            name=f"ladder-{size}", capacity={"cpu": 2 * size, "memory": f"{4 * size}Gi", "pods": 110},
            offerings=offerings,
        ))
    return catalog


def _pod(pkg, name, cpu="1", memory="512Mi", **kwargs):
    return pkg.PodSpec(name=name, uid=f"uid-{name}", requests={"cpu": cpu, "memory": memory},
                       unschedulable=True, **kwargs)


def _spread(pkg, key, labels, max_skew=1):
    return pkg.TopologySpreadConstraint(max_skew=max_skew, topology_key=key, match_labels=labels)


def _occupy(pkg, cluster, node_name, zone, labels):
    node = pkg.NodeSpec(name=node_name, zone=zone)
    cluster.create_node(node)
    pod = _pod(pkg, f"{node_name}-pod", labels=labels)
    cluster.apply_pod(pod)
    cluster.bind_pod(pod, node)


def _scenario(name, pkg):
    """(cluster, pods) of one scenario, built through `pkg`'s classes."""
    wk = pkg.wellknown
    cluster = pkg.Cluster()
    if name == "zonal-spread":
        pods = [_pod(pkg, f"web-{i}", labels={"app": "web"},
                     topology_spread=[_spread(pkg, wk.ZONE_LABEL, {"app": "web"})]) for i in range(7)]
    elif name == "hostname-spread":
        pods = [_pod(pkg, f"web-{i}", cpu="500m", labels={"app": "web"},
                     topology_spread=[_spread(pkg, wk.HOSTNAME_LABEL, {"app": "web"}, max_skew=2)])
                for i in range(6)]
    elif name == "hostname-anti-affinity":
        term = {"topologyKey": wk.HOSTNAME_LABEL, "labelSelector": {"matchLabels": {"app": "db"}}}
        pods = [_pod(pkg, f"db-{i}", labels={"app": "db"}, pod_anti_affinity_terms=[dict(term)])
                for i in range(5)]
    elif name == "zone-anti-affinity":
        _occupy(pkg, cluster, "occupied", ZONES[0], {"app": "rival"})
        term = {"topologyKey": wk.ZONE_LABEL, "labelSelector": {"matchLabels": {"app": "rival"}}}
        pods = [_pod(pkg, f"shy-{i}", pod_anti_affinity_terms=[dict(term)]) for i in range(3)]
    elif name == "zone-affinity":
        _occupy(pkg, cluster, "anchor", ZONES[1], {"app": "cache"})
        term = {"topologyKey": wk.ZONE_LABEL, "labelSelector": {"matchLabels": {"app": "cache"}}}
        pods = [_pod(pkg, f"near-{i}", pod_affinity_terms=[dict(term)]) for i in range(3)]
    elif name == "unsatisfiable-preference":
        preferred = [
            pkg.PreferredTerm(weight=10, requirements=[pkg.Requirement.in_(wk.ZONE_LABEL, ["nowhere"])]),
            pkg.PreferredTerm(weight=1, requirements=[pkg.Requirement.in_(wk.ZONE_LABEL, [ZONES[2]])]),
        ]
        pods = [_pod(pkg, f"picky-{i}", preferred_terms=list(preferred)) for i in range(4)]
    elif name == "spread-and-preference":
        preferred = [pkg.PreferredTerm(weight=5, requirements=[pkg.Requirement.in_(wk.ZONE_LABEL, ["mars"])])]
        pods = [_pod(pkg, f"web-{i}", labels={"app": "web"}, preferred_terms=list(preferred),
                     topology_spread=[_spread(pkg, wk.ZONE_LABEL, {"app": "web"})]) for i in range(6)]
    elif name == "custom-key-spread":
        pods = [_pod(pkg, f"rack-{i}", labels={"app": "web"},
                     topology_spread=[_spread(pkg, "rack", {"app": "web"})],
                     required_terms=[[pkg.Requirement.in_("rack", ["r-1", "r-2"])]])
                for i in range(4)]
    else:
        raise ValueError(name)
    return cluster, pods


SCENARIOS = [
    "zonal-spread", "hostname-spread", "hostname-anti-affinity", "zone-anti-affinity",
    "zone-affinity", "unsatisfiable-preference", "spread-and-preference", "custom-key-spread",
]


def _schedules(pkg, name):
    cluster, pods = _scenario(name, pkg)
    provisioner = pkg.Provisioner(name="default", spec=pkg.ProvisionerSpec())
    schedules = pkg.Scheduler(cluster).solve(provisioner, pods)
    return cluster, schedules


@pytest.mark.parametrize("name", SCENARIOS)
def test_compiled_tensors_equal_the_reference(name):
    compiled = []
    for pkg in (REF, PORT):
        cluster, schedules = _schedules(pkg, name)
        (schedule,) = [s for s in schedules if s.needs_compiler]
        groups = pkg.encode.group_pods(list(schedule.pods))
        fleet = pkg.encode.build_fleet(
            _catalog(pkg), schedule.constraints, schedule.pods, [],
            pods_need=groups.vectors.max(axis=0),
        )
        compiled.append(pkg.compiler.compile_constraints(
            schedule, groups, fleet, cluster, cache=pkg.compiler.CompilerCache()))
    ref, port = compiled
    for field in ("allow", "penalty", "level_counts", "conflict", "node_cap", "vectors"):
        a, b = getattr(ref, field), getattr(port, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field


def _solve(pkg, name, device_solver):
    cluster, schedules = _schedules(pkg, name)
    (schedule,) = [s for s in schedules if s.needs_compiler]
    return pkg.solve.solve_constrained(
        device_solver, schedule, _catalog(pkg), [], cluster=cluster,
        cache=pkg.compiler.CompilerCache(),
    )


def _plan(result):
    return [
        (
            [it.name for it in packing.instance_type_options],
            packing.node_quantity,
            [[pod.uid for pod in node] for node in packing.pods_per_node],
        )
        for packing in result.packings
    ]


@pytest.mark.parametrize("name", SCENARIOS)
def test_solve_constrained_equals_the_reference(name, monkeypatch):
    monkeypatch.setenv("KARPENTER_SHARDED_SOLVE", "0")
    ref_result, ref_decision = _solve(REF, name, ref_solver.CostSolver())
    port_result, port_decision = _solve(PORT, name, port_solver.CostSolver(device="cpu"))
    assert port_decision.chosen_level == ref_decision.chosen_level
    assert port_decision.group_levels == ref_decision.group_levels
    assert port_decision.pod_levels == ref_decision.pod_levels
    assert _plan(port_result) == _plan(ref_result)
    assert sorted(p.uid for p in port_result.unschedulable) == sorted(
        p.uid for p in ref_result.unschedulable)
    ref_cost = ref_result.projected_cost()
    assert abs(port_result.projected_cost() - ref_cost) <= 1e-6 * max(abs(ref_cost), 1.0)


def test_unsatisfiable_preference_takes_the_relaxed_level():
    result, decision = _solve(PORT, "unsatisfiable-preference", port_solver.CostSolver(device="cpu"))
    assert decision.chosen_level == 1
    assert not result.unschedulable
    zones = {opt.zone for packing in result.packings for opt in packing.pool_options}
    assert zones == {ZONES[2]}


def test_host_solvers_take_the_mirror():
    assert port_solver.GreedySolver.needs_device_warmup is False
    assert port_solver.NativeSolver.needs_device_warmup is False
    assert port_solver.CostSolver.needs_device_warmup is True
    result, decision = _solve(PORT, "zonal-spread", port_solver.GreedySolver())
    ref_result, ref_decision = _solve(REF, "zonal-spread", ref_solver.GreedySolver())
    assert decision.chosen_level == ref_decision.chosen_level
    assert _plan(result) == _plan(ref_result)


def test_chip_smoke_constrained_workload_equals_the_reference(monkeypatch):
    """chip_smoke's constrained configuration (the main path's Zipf shapes
    under one zonal spread and two preferred terms, one naming a zone the
    catalog does not offer), cut to 400 pods over 40 types, through both
    packages: level 1 wins, the same plan and $/hr. The reference's compiler
    counts the missing zone as a fourth spread domain, so a quarter of the
    pods are reported unschedulable on both sides."""
    import chip_smoke

    monkeypatch.setenv("KARPENTER_SHARDED_SOLVE", "0")
    plans = []
    for pkg, device_solver in ((REF, ref_solver.CostSolver()), (PORT, port_solver.CostSolver(device="cpu"))):
        catalog = chip_smoke.make_catalog(40, package=pkg)
        pods = chip_smoke.constrained_pods(400, package=pkg)
        cluster = pkg.Cluster()
        (schedule,) = pkg.Scheduler(cluster).solve(
            pkg.Provisioner(name="default", spec=pkg.ProvisionerSpec()), pods)
        result, decision = pkg.solve.solve_constrained(
            device_solver, schedule, catalog, [], cluster=cluster, cache=pkg.compiler.CompilerCache())
        assert decision.chosen_level == 1
        assert chip_smoke.placed_once_or_unschedulable(result, pods)
        assert chip_smoke.zone_skew(result)[1] <= 1
        plans.append((_plan(result), sorted(p.uid for p in result.unschedulable),
                      result.projected_cost(), decision.group_levels))
    (ref_plan, ref_unsched, ref_cost, ref_levels), (port_plan, port_unsched, port_cost, port_levels) = plans
    assert port_plan == ref_plan and port_unsched == ref_unsched and port_levels == ref_levels
    assert len(port_unsched) == 100
    assert abs(port_cost - ref_cost) <= 1e-6 * ref_cost


# --- the level-sharded dispatch (the reference's tests/test_constraints.py:816-) ----


def _level_sharded(args, mode, shards):
    """The port's level-sharded dispatch over `shards` CPU shards."""
    from karpenter_tpu_torch.parallel import mesh as port_mesh
    from karpenter_tpu_torch.parallel.sharded_solver import constrained_level_sharding

    mesh = port_mesh.make_mesh([port_mesh.Shard(i, torch.device("cpu")) for i in range(shards)])
    dispatch, count = constrained_level_sharding(mesh)
    assert count == shards
    return dispatch([np.ascontiguousarray(a) for a in args], mode)


def _assert_host_levels_equal(want, got):
    assert int(want.chosen_level) == int(got.chosen_level)
    np.testing.assert_array_equal(np.asarray(want.group_level), np.asarray(got.group_level))
    np.testing.assert_array_equal(np.asarray(want.level_unsched), np.asarray(got.level_unsched))
    for field in port_pack.PackRounds._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(want.rounds, field)), np.asarray(getattr(got.rounds, field)), err_msg=field)


LEVEL_SHARD_CASES = [(0, (4, 4, 3, 8)), (1, (16, 12, 3, 4)), (2, (16, 24, 3, 2)), (3, (32, 20, 3, 8))]


@pytest.mark.parametrize("mode", ["ffd", "cost"])
@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("case", LEVEL_SHARD_CASES, ids=lambda c: "s{}-G{}xT{}xR{}xL{}".format(c[0], *c[1]))
def test_level_sharded_dispatch_bit_identical_to_single(case, shards, mode):
    """Each shard runs K6's plain version on its block of levels (padded by
    repeating the last level when the shards do not divide L), the
    cross-level selection picks the chosen level: every field equals the
    single-device dispatch's, and the reference's level-sharded one."""
    seed, shape = case
    args = _level_instance(seed, *shape, integral=bool(seed % 2))
    single = port_pack.level_pack_to_host(_port_levels(args, mode))
    got = _level_sharded(args, mode, shards)
    _assert_host_levels_equal(single, got)
    from karpenter_tpu.parallel import mesh as ref_mesh
    from karpenter_tpu.parallel.sharded_solver import constrained_level_sharding as ref_sharding

    constrain, _ = ref_sharding(ref_mesh.make_mesh(jax.devices()[:shards]))
    reference = jax.device_get(ref_pack.pack_kernel_levels(*args, mode=mode, constrain=constrain))
    _assert_host_levels_equal(reference, got)


@pytest.mark.parametrize("name", ["zonal-spread", "unsatisfiable-preference", "spread-and-preference"])
def test_solve_constrained_on_a_mesh_equals_single(name, monkeypatch):
    """solve_constrained with the port's CostSolver on an 8-shard CPU mesh
    (the level hook) decodes as on one device."""
    from karpenter_tpu_torch.parallel import mesh as port_mesh

    monkeypatch.delenv("KARPENTER_SHARDED_SOLVE", raising=False)
    single_result, single_decision = _solve(PORT, name, port_solver.CostSolver(device="cpu"))
    with port_mesh.virtual_devices("cpu", 8):
        assert port_solver.constrained_level_hook(device="cpu")[1] == 8
        result, decision = _solve(PORT, name, port_solver.CostSolver(device="cpu"))
    assert decision.chosen_level == single_decision.chosen_level
    assert decision.group_levels == single_decision.group_levels
    assert decision.pod_levels == single_decision.pod_levels
    assert _plan(result) == _plan(single_result)
    assert result.projected_cost() == single_result.projected_cost()


def test_a_failed_sharded_level_fetch_quarantines(monkeypatch):
    from karpenter_tpu_torch.parallel import mesh as port_mesh
    from karpenter_tpu_torch.parallel import sharded_solver as port_sharded
    from karpenter_tpu_torch.utils import backend_health as port_health

    monkeypatch.delenv("KARPENTER_SHARDED_SOLVE", raising=False)
    quarantined = []
    monkeypatch.setattr(port_health, "quarantine_mesh",
                        lambda ids, error: quarantined.append(list(ids)) or [])

    def dies(mesh, operands, mode):
        raise RuntimeError("card died mid-solve")

    monkeypatch.setattr(port_sharded, "_level_dispatch", dies)
    with port_mesh.virtual_devices("cpu", 4):
        with pytest.raises(RuntimeError, match="card died"):
            _solve(PORT, "zonal-spread", port_solver.CostSolver(device="cpu"))
    assert quarantined == [[0, 1, 2, 3]]
