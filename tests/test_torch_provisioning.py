"""The provisioning controllers under a live spot market: the port's Manager
against the JAX reference's controllers, on the CPU.

The reference's ProvisioningController + SelectionController +
MarketController over its FakeCloudProvider (with a PriceBook active and
attached, and a DeviceClusterState) and the port's `runtime.Manager`
(device="cpu") take the same storm: a seeded MarketFeed over every spot
pool folded by the market sweep, a few pools given an observed
interruption, a provisioner of capacity type spot only (so every node
bought is priced by the market and chosen by the risk-ranked pools), about
300 pods over 24 types in 3 zones (30 of
them under a zonal spread and an impossible preferred term, a constrained
schedule), drained by worker passes in windows of 100 pods, the market
repricing between two passes.

Tolerances: every pod bound exactly once on both; with
`make_solver("ffd")` (K2 in one mode) the launched nodes' multiset (type,
zone, capacity type, bound pods) identical, every node spot, and no
solve sent to the host FFD; with the CostSolver the bought
fleet's $/hr within 1e-3 relative of the reference's (as for the main path:
the LP is held to a tolerance, not to bits); the constrained schedule goes
through K6's route on both and chooses the same relaxation level for every
pod. The chip_smoke storm phase's own `run_storm` runs here at a small size.
"""

from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from karpenter_tpu_torch.market import pricebook as port_pricebook
from karpenter_tpu_torch.utils.options import Options

import chip_smoke

torch.set_num_threads(2)

NUM_PLAIN = 270
NUM_CONSTRAINED = 30
NUM_TYPES = 24
WINDOW = 100
FEED_SEED = 3
RISKY = 3  # the cheapest spot pools given an observed interruption
REPRICE_BEFORE = 2  # the market reprices before this pass (1-based)
IMPOSSIBLE_TYPE = "no-such-type"


@pytest.fixture(autouse=True)
def _port_book_reset():
    """The port's active PriceBook is process-global like the reference's
    (whose own reset lives in tests/conftest.py): a book leaking into a
    later port test on this worker would reprice its fleets."""
    port_pricebook.set_active_book(None)
    yield
    port_pricebook.set_active_book(None)


@pytest.fixture
def one_device(monkeypatch):
    """Both packages' cost solves on one device and never on the host path
    (the reference's test process sees an 8-device virtual mesh)."""
    monkeypatch.setenv("KARPENTER_SHARDED_SOLVE", "0")
    monkeypatch.setenv("KARPENTER_HOST_SOLVE", "0")


@pytest.fixture
def small_windows(monkeypatch):
    """Windows of WINDOW pods in both packages' provisioning workers (the
    reference's MAX_PODS_PER_BATCH is 2,000)."""
    from karpenter_tpu.controllers import provisioning as ref_provisioning
    from karpenter_tpu_torch.controllers import provisioning as port_provisioning

    for module in (ref_provisioning, port_provisioning):
        monkeypatch.setattr(module, "MAX_PODS_PER_BATCH", WINDOW)


def _package(reference: bool):
    if not reference:
        return chip_smoke.port_package()
    from karpenter_tpu import cloudprovider
    from karpenter_tpu.api import wellknown
    from karpenter_tpu.api.pods import PodSpec, PreferredTerm, TopologySpreadConstraint
    from karpenter_tpu.api.requirements import Requirement

    return SimpleNamespace(
        PodSpec=PodSpec, PreferredTerm=PreferredTerm, TopologySpreadConstraint=TopologySpreadConstraint,
        Requirement=Requirement, wellknown=wellknown, InstanceType=cloudprovider.InstanceType,
        Offering=cloudprovider.Offering,
    )


def _pods(package):
    """NUM_PLAIN pods in the main path's 16 Zipf shapes and NUM_CONSTRAINED
    under one zonal spread (max_skew 1) and a preferred term naming an
    instance type no catalog has (level 0 places nothing, level 1 drops
    it), in one seeded random order."""
    wellknown = package.wellknown
    shapes = chip_smoke.pod_shapes(0)
    counts = (chip_smoke.zipf_weights(len(shapes)) * NUM_PLAIN).astype(int)
    counts[0] += NUM_PLAIN - counts.sum()
    pods = [
        package.PodSpec(name=f"p-{k}-{i}", uid=f"p-{k}-{i}",
                        requests={"cpu": f"{cpu}m", "memory": f"{mem}Mi"}, unschedulable=True)
        for k, ((cpu, mem), count) in enumerate(zip(shapes, counts))
        for i in range(count)
    ]
    spread = package.TopologySpreadConstraint(
        max_skew=1, topology_key=wellknown.ZONE_LABEL, match_labels={"app": "spread"})
    preferred = package.PreferredTerm(weight=10, requirements=[
        package.Requirement.in_(wellknown.INSTANCE_TYPE_LABEL, [IMPOSSIBLE_TYPE])])
    pods += [
        package.PodSpec(name=f"c-{i}", uid=f"c-{i}", requests={"cpu": "500m", "memory": "1Gi"},
                        unschedulable=True, labels={"app": "spread"}, topology_spread=[spread],
                        preferred_terms=[preferred])
        for i in range(NUM_CONSTRAINED)
    ]
    order = np.random.default_rng(11).permutation(len(pods))
    return [pods[i] for i in order]


def _risky_pools(pools, catalog):
    spot = sorted((o.price, it.name, o.zone) for it in catalog for o in it.offerings
                  if o.capacity_type == "spot")
    return [(name, zone) for _, name, zone in spot[:RISKY]]


def _reference_world(solver):
    from karpenter_tpu.cloudprovider.fake import FakeCloudProvider
    from karpenter_tpu.controllers.cluster import Cluster
    from karpenter_tpu.controllers.market import MarketController
    from karpenter_tpu.controllers.provisioning import ProvisioningController
    from karpenter_tpu.controllers.selection import SelectionController
    from karpenter_tpu.market.feed import MarketFeed, catalog_pools
    from karpenter_tpu.market.pricebook import PriceBook, set_active_book
    from karpenter_tpu.models.cluster_state import DeviceClusterState
    from karpenter_tpu.utils.clock import FakeClock

    package = _package(True)
    catalog = chip_smoke.make_catalog(NUM_TYPES, package=package)
    clock = FakeClock()
    cluster = Cluster(clock=clock)
    cloud = FakeCloudProvider(instance_types=catalog, clock=clock)
    feed = MarketFeed(catalog_pools(catalog), seed=FEED_SEED)
    cloud.attach_market_feed(feed)
    book = PriceBook(clock=clock)
    set_active_book(book)
    cloud.attach_market(book)
    provisioning = ProvisioningController(cluster, cloud, solver, cluster_state=DeviceClusterState(cluster))
    market = MarketController(cluster, cloud, book)
    requeues = []

    def requeue():
        requeues.append(1)
        for provisioner in cluster.list_provisioners():
            provisioning.reconcile(provisioner.name)

    market.requeue = requeue
    return SimpleNamespace(
        package=package, catalog=catalog, clock=clock, cluster=cluster, cloud=cloud, feed=feed,
        book=book, provisioning=provisioning, selection=SelectionController(cluster, provisioning),
        market=market, requeues=requeues)


def _port_world(solver_name):
    from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider
    from karpenter_tpu_torch.controllers.cluster import Cluster
    from karpenter_tpu_torch.market.feed import MarketFeed, catalog_pools
    from karpenter_tpu_torch.runtime import Manager
    from karpenter_tpu_torch.utils.clock import FakeClock

    package = _package(False)
    catalog = chip_smoke.make_catalog(NUM_TYPES, package=package)
    clock = FakeClock()
    cluster = Cluster(clock=clock)
    cloud = FakeCloudProvider(instance_types=catalog, clock=clock)
    feed = MarketFeed(catalog_pools(catalog), seed=FEED_SEED)
    cloud.attach_market_feed(feed)
    manager = Manager(cluster, cloud, Options(cluster_name="parity", solver=solver_name), device="cpu")
    assert port_pricebook.active_book() is manager.price_book
    return SimpleNamespace(
        package=package, catalog=catalog, clock=clock, cluster=cluster, cloud=cloud, feed=feed,
        book=manager.price_book, provisioning=manager.provisioning, selection=manager.selection,
        market=manager.market, manager=manager)


def _storm(world, provisioner):
    """Fold the market, note the risky pools, provision every pod in
    windows with a reprice before pass REPRICE_BEFORE; returns what the
    storm bought."""
    world.clock.advance(4 * world.feed.tick_interval_s)
    world.market.reconcile()
    for pool in _risky_pools(world.feed.pools, world.catalog):
        world.book.note_interruption(pool)
    world.cluster.apply_provisioner(provisioner)
    world.provisioning.reconcile("default")
    binds = Counter()
    world.cluster.watch_deltas(
        lambda verb, kind, obj: binds.update([obj.uid]) if verb == "bind" and kind == "pod" else None)
    pods = _pods(world.package)
    for pod in pods:
        world.cluster.apply_pod(pod)
        world.selection.reconcile(pod.namespace, pod.name)
    passes = 0
    generations = []
    cost = 0.0
    seen = set()
    while world.provisioning.workers["default"].queue_depth():
        passes += 1
        if passes == REPRICE_BEFORE:
            world.feed.force_spike(world.feed.pools[RISKY: RISKY + 4], 1.6)
            world.clock.advance(world.feed.tick_interval_s)
            before = world.book.generation
            world.market.reconcile()
            generations.append(world.book.generation - before)
        world.provisioning.workers["default"].provision()
        price_of = {(it.name, o.zone, o.capacity_type): o.price
                    for it in world.cloud.get_instance_types() for o in it.offerings}
        for node in world.cluster.list_nodes():
            if node.name not in seen:
                seen.add(node.name)
                cost += price_of[(node.instance_type, node.zone, node.capacity_type)]
    on = Counter(p.node_name for p in world.cluster.list_pods() if p.node_name)
    return SimpleNamespace(
        pods=pods, binds=binds, passes=passes, generations=generations, cost=cost,
        nodes=Counter((n.instance_type, n.zone, n.capacity_type, on[n.name])
                      for n in world.cluster.list_nodes()),
        levels={p.uid: world.selection.preferences.level(p) for p in pods if p.preferred_terms},
    )


def _reference_storm(solver):
    from karpenter_tpu.api import provisioner, requirements, wellknown

    return _storm(_reference_world(solver), chip_smoke.spot_provisioner(provisioner, requirements, wellknown))


def _port_storm(solver_name):
    from karpenter_tpu_torch.api import provisioner, requirements, wellknown

    return _storm(_port_world(solver_name), chip_smoke.spot_provisioner(provisioner, requirements, wellknown))


def _k6_route(monkeypatch):
    """Counts the port's K6 dispatches (constraints/solve._dispatch_kernel)."""
    from karpenter_tpu_torch.constraints import solve as port_solve

    calls = []
    original = port_solve._dispatch_kernel

    def counted(*args, **kwargs):
        calls.append(1)
        return original(*args, **kwargs)

    monkeypatch.setattr(port_solve, "_dispatch_kernel", counted)
    return calls


def _bound_once(storm) -> bool:
    return (set(storm.binds) == {p.uid for p in storm.pods}
            and set(storm.binds.values()) == {1})


def test_ffd_storm_buys_the_reference_nodes(one_device, small_windows, monkeypatch):
    from karpenter_tpu.models.solver import TPUSolver
    from karpenter_tpu_torch.models.solver import TPUSolver as PortTPUSolver

    k6 = _k6_route(monkeypatch)
    reference = _reference_storm(TPUSolver(mode="ffd"))
    fallbacks = PortTPUSolver.host_fallbacks
    port = _port_storm("ffd")
    assert PortTPUSolver.host_fallbacks == fallbacks
    assert _bound_once(reference) and _bound_once(port)
    assert {node[2] for node in port.nodes} == {"spot"}
    assert port.passes == reference.passes == -(-(NUM_PLAIN + NUM_CONSTRAINED) // WINDOW)
    assert port.generations == reference.generations and port.generations[0] >= 1
    assert port.nodes == reference.nodes
    assert k6 and port.levels == reference.levels and set(port.levels.values()) == {1}


def test_cost_storm_prices_within_tolerance_of_the_reference(one_device, small_windows, monkeypatch):
    from karpenter_tpu.models.solver import CostSolver

    k6 = _k6_route(monkeypatch)
    reference = _reference_storm(CostSolver())
    port = _port_storm("cost")
    assert _bound_once(reference) and _bound_once(port)
    assert port.passes == reference.passes
    assert abs(port.cost - reference.cost) <= 1e-3 * reference.cost
    assert {node[2] for node in port.nodes} == {node[2] for node in reference.nodes} == {"spot"}
    assert k6 and port.levels == reference.levels and set(port.levels.values()) == {1}


def test_tpu_solver_rounds_match_the_reference(one_device):
    """TPUSolver(mode="ffd") on the CPU (K2's plain version in one mode)
    gives the reference's packing on the same encoded problem."""
    from karpenter_tpu.api.provisioner import Constraints as RefConstraints
    from karpenter_tpu.models.solver import TPUSolver as RefTPUSolver
    from karpenter_tpu_torch.api.provisioner import Constraints
    from karpenter_tpu_torch.models.solver import TPUSolver

    ref_package = _package(True)
    ref_pods = [p for p in _pods(ref_package) if not p.preferred_terms]
    port_pods = [p for p in _pods(_package(False)) if not p.preferred_terms]
    ref_result = RefTPUSolver(mode="ffd").solve(
        ref_pods, chip_smoke.make_catalog(NUM_TYPES, package=ref_package), RefConstraints())
    port_result = TPUSolver(mode="ffd", device="cpu").solve(
        port_pods, chip_smoke.make_catalog(NUM_TYPES), Constraints())

    def packing(result):
        return [([it.name for it in p.instance_type_options], p.node_quantity,
                 [[pod.uid for pod in node] for node in p.pods_per_node]) for p in result.packings]

    assert packing(port_result) == packing(ref_result)
    assert [p.uid for p in port_result.unschedulable] == [p.uid for p in ref_result.unschedulable]


@pytest.mark.parametrize("mode", ["ffd", "cost"])
def test_tpu_solver_counts_its_host_fallback(monkeypatch, mode):
    """When K2 runs out of its round budget, TPUSolver answers with the host
    FFD (the reference's branch) and counts it in host_fallbacks."""
    from karpenter_tpu_torch.models.solver import TPUSolver
    from karpenter_tpu_torch.ops import encode, ffd
    from karpenter_tpu_torch.ops import pack_kernel as port_pack_kernel
    from karpenter_tpu_torch.api.provisioner import Constraints

    pods = [p for p in _pods(_package(False)) if not p.preferred_terms]
    groups = encode.group_pods(pods)
    fleet = encode.build_fleet(chip_smoke.make_catalog(NUM_TYPES), Constraints(), [],
                               pods_need=groups.vectors.max(axis=0))
    solver = TPUSolver(mode=mode, device="cpu")
    before = TPUSolver.host_fallbacks
    solver.solve_encoded(groups, fleet)
    assert TPUSolver.host_fallbacks == before
    monkeypatch.setattr(port_pack_kernel, "max_rounds", lambda num_groups: 1)
    result = solver.solve_encoded(groups, fleet)
    assert TPUSolver.host_fallbacks == before + 1
    host = ffd.pack_groups(fleet, groups)
    assert [(p.node_quantity, [[pod.uid for pod in node] for node in p.pods_per_node])
            for p in result.packings] == [
        (p.node_quantity, [[pod.uid for pod in node] for node in p.pods_per_node])
        for p in host.packings]


@pytest.mark.parametrize("reference", [True, False], ids=["reference", "port"])
def test_spot_provisioner_allows_spot_only(reference):
    """The storm's provisioner, built from either package, allows capacity
    type spot alone, and the fake cloud's defaulting keeps it so."""
    if reference:
        from karpenter_tpu.api import provisioner, requirements, wellknown
        from karpenter_tpu.cloudprovider.fake import FakeCloudProvider
    else:
        from karpenter_tpu_torch.api import provisioner, requirements, wellknown
        from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider

    spot = chip_smoke.spot_provisioner(provisioner, requirements, wellknown)
    FakeCloudProvider(instance_types=[]).default(spot)
    assert spot.spec.constraints.requirements.capacity_types() == {wellknown.CAPACITY_TYPE_SPOT}


def test_storm_checks_refuse_a_node_that_is_not_spot():
    """chip_smoke's storm checks fail a storm that bought an on-demand node,
    all else being right."""
    pods = [SimpleNamespace(uid=f"p-{i}") for i in range(3)]
    storm = {
        "pods": pods, "binds": Counter(p.uid for p in pods), "bound": len(pods),
        "passes": [{"unschedulable": 0, "errors": 0, "scheduled": len(pods)}],
        "nodes": Counter({("c0.1x", "zone-a", "spot", 2): 1, ("c0.1x", "zone-b", "on-demand", 1): 1}),
    }
    with pytest.raises(RuntimeError, match="not spot"):
        chip_smoke.storm_checks(storm, "storm")
    del storm["nodes"][("c0.1x", "zone-b", "on-demand", 1)]
    chip_smoke.storm_checks(storm, "storm")


def test_make_solver_builds_each_solver():
    from karpenter_tpu_torch.models.solver import CostSolver, GreedySolver, NativeSolver, TPUSolver
    from karpenter_tpu_torch.runtime import make_solver

    assert isinstance(make_solver("greedy"), GreedySolver)
    assert isinstance(make_solver("native"), (NativeSolver, GreedySolver))
    ffd = make_solver("ffd", device="cpu")
    assert isinstance(ffd, TPUSolver) and ffd.mode == "ffd" and ffd.device.type == "cpu"
    assert isinstance(make_solver("cost", device="cpu"), CostSolver)
    from karpenter_tpu_torch.solver_service.client import RemoteSolver

    remote = make_solver("remote", "localhost:1")
    assert isinstance(remote, RemoteSolver) and remote.endpoint == "localhost:1"
    remote.close()
    with pytest.raises(ValueError, match="unknown"):
        make_solver("bogus")


def test_manager_wires_the_market():
    """The Manager makes its book the active one and the cloud's, and a
    debounced reprice reconciles the provisioners."""
    world = _port_world("greedy")
    manager = world.manager
    assert world.cloud._market_book is manager.price_book
    world.clock.advance(3 * world.feed.tick_interval_s)
    manager.market.reconcile()
    assert manager.price_book.last_seq > 0
    generation, requeues = manager.price_book.generation, manager.reprice_requeues
    world.feed.force_spike(world.feed.pools[:2], 1.6)
    world.clock.advance(world.feed.tick_interval_s)
    manager.market.reconcile()
    assert manager.price_book.generation > generation and manager.reprice_requeues == requeues + 1


def test_chip_smoke_run_storm_on_the_cpu(monkeypatch):
    """chip_smoke.run_storm at a small size on the CPU (the card run
    takes 50,000 pods in 25 windows): every pod bound once, one fleet upload
    after the reprice and none while calm, K10's plain version beside every
    published column."""
    monkeypatch.setenv("KARPENTER_HOST_SOLVE", "0")
    storm = chip_smoke.run_storm("cpu", "cost", num_pods=2_500, num_types=NUM_TYPES, reprice_pass=2)
    chip_smoke.storm_checks(storm, "CPU storm")
    uploads = [p["fleet_uploads"] for p in storm["passes"]]
    assert uploads[1] == 1 and uploads[0] >= 1
    assert all(p["columns"] >= 1 for p in storm["passes"])
    assert storm["prices"]["risked_types"] > 0 and storm["prices"]["max_abs_err"] == 0.0
    assert port_pricebook.active_book() is None


def test_tracing_spans_ride_the_torch_profiler(tmp_path):
    """With a profile directory set, a span enters a torch.profiler range and
    device_profile writes a Chrome trace that names it (the reference enters
    jax.profiler there)."""
    import json

    from karpenter_tpu_torch.utils.tracing import Tracer, device_profile

    tracer = Tracer(enabled=True)
    tracer.profile_dir = str(tmp_path)
    with device_profile(tracer):
        with tracer.span("provision.solve", pods=3):
            torch.ones(4).sum()
    assert [span.name for span in tracer._spans] == ["provision.solve"]
    (trace,) = list(tmp_path.glob("device-*.json"))
    names = {event.get("name") for event in json.loads(trace.read_text())["traceEvents"]}
    assert "provision.solve" in names
