"""The port's consolidation, termination and node controllers and the
disruption ledger against the JAX package's, on the CPU.

Both packages get the same seeded world (the fake cloud's consolidation
catalog, the same pods with the same names and uids, nodes named from the
same counter) and are driven by the same reconcile calls, as the
reference's tests/test_consolidation.py converges its Harness. The
consolidation sweeps' actions (kind, victim, the replacement's type), the
evictions and the final placement must be identical; the port's
counterfactual solve runs K7's plain version (device="cpu").
"""

import itertools
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from karpenter_tpu.api import provisioner as ref_provisioner
from karpenter_tpu.api import wellknown as ref_wellknown
from karpenter_tpu.api.pods import PodSpec as RefPodSpec
from karpenter_tpu.cloudprovider import NodeSpec as RefNodeSpec
from karpenter_tpu.cloudprovider import fake as ref_fake
from karpenter_tpu.controllers import consolidation as ref_consolidation
from karpenter_tpu.controllers import eligibility as ref_eligibility
from karpenter_tpu.controllers.cluster import Cluster as RefCluster
from karpenter_tpu.controllers.node import NodeController as RefNodeController
from karpenter_tpu.controllers.provisioning import ProvisioningController as RefProvisioning
from karpenter_tpu.controllers.selection import SelectionController as RefSelection
from karpenter_tpu.controllers.termination import TerminationController as RefTermination
from karpenter_tpu.utils.clock import FakeClock as RefFakeClock
from karpenter_tpu_torch.api import provisioner as port_provisioner
from karpenter_tpu_torch.api import wellknown as port_wellknown
from karpenter_tpu_torch.api.pods import PodSpec as PortPodSpec
from karpenter_tpu_torch.cloudprovider import NodeSpec as PortNodeSpec
from karpenter_tpu_torch.cloudprovider import fake as port_fake
from karpenter_tpu_torch.controllers import consolidation as port_consolidation
from karpenter_tpu_torch.controllers import eligibility as port_eligibility
from karpenter_tpu_torch.controllers.cluster import Cluster as PortCluster
from karpenter_tpu_torch.controllers.node import NodeController as PortNodeController
from karpenter_tpu_torch.controllers.provisioning import ProvisioningController as PortProvisioning
from karpenter_tpu_torch.controllers.selection import SelectionController as PortSelection
from karpenter_tpu_torch.controllers.termination import TerminationController as PortTermination
from karpenter_tpu_torch.utils.clock import FakeClock as PortFakeClock

torch.set_num_threads(2)

PACKAGES = {
    "reference": SimpleNamespace(
        PodSpec=RefPodSpec, NodeSpec=RefNodeSpec, fake=ref_fake, provisioner=ref_provisioner,
        wellknown=ref_wellknown, consolidation=ref_consolidation, eligibility=ref_eligibility,
        Cluster=RefCluster, NodeController=RefNodeController, Provisioning=RefProvisioning,
        Selection=RefSelection, Termination=RefTermination, FakeClock=RefFakeClock, device={}),
    "port": SimpleNamespace(
        PodSpec=PortPodSpec, NodeSpec=PortNodeSpec, fake=port_fake, provisioner=port_provisioner,
        wellknown=port_wellknown, consolidation=port_consolidation, eligibility=port_eligibility,
        Cluster=PortCluster, NodeController=PortNodeController, Provisioning=PortProvisioning,
        Selection=PortSelection, Termination=PortTermination, FakeClock=PortFakeClock,
        device={"device": "cpu"}),
}
CPU_SIZES = ("1", "2", "4")


def _world(name, monkeypatch, max_disruption=2, ttl_empty=None, ttl_expired=None):
    """One package's world: store, fake cloud (the consolidation catalog),
    the provisioning, selection, termination, node and consolidation
    controllers over one ledger; nodes named from 1,000 in both packages."""
    pkg = PACKAGES[name]
    monkeypatch.setattr(pkg.fake, "_node_counter", itertools.count(1000))
    clock = pkg.FakeClock()
    cluster = pkg.Cluster(clock=clock)
    cloud = pkg.fake.FakeCloudProvider(instance_types=pkg.fake.consolidation_instance_types(), clock=clock)
    provisioning = pkg.Provisioning(cluster, cloud, None)
    termination = pkg.Termination(cluster, cloud)
    ledger = pkg.eligibility.DisruptionLedger(cluster)
    world = SimpleNamespace(
        pkg=pkg, clock=clock, cluster=cluster, cloud=cloud, provisioning=provisioning,
        selection=pkg.Selection(cluster, provisioning), termination=termination, ledger=ledger,
        node=pkg.NodeController(cluster, ledger=ledger),
        consolidation=pkg.consolidation.ConsolidationController(
            cluster, cloud, provisioning, termination, max_disruption=max_disruption, **pkg.device),
        events=[],
    )
    cluster.watch_deltas(lambda verb, kind, obj: world.events.append((verb, obj.name))
                         if kind == "pod" and verb in ("bind", "reschedule") else None)
    spec = pkg.provisioner.ProvisionerSpec(ttl_seconds_after_empty=ttl_empty,
                                           ttl_seconds_until_expired=ttl_expired)
    cluster.apply_provisioner(pkg.provisioner.Provisioner(name="default", spec=spec))
    provisioning.reconcile("default")
    return world


def _pods(world, specs):
    return [world.pkg.PodSpec(name=name, uid=f"uid-{name}", requests={"cpu": cpu, "memory": "1Gi"},
                              unschedulable=True) for name, cpu in specs]


# Markers the harness records around each provisioning pass. A pass binds
# through a thread pool, so the order of its binds is up to the scheduler.
PASS_START, PASS_END = ("pass", "start"), ("pass", "end")


def _provision_pass(world):
    world.events.append(PASS_START)
    for worker in list(world.provisioning.workers.values()):
        worker.provision()
    world.events.append(PASS_END)


def _provision(world, pods):
    for pod in pods:
        world.cluster.apply_pod(pod)
        world.selection.reconcile(pod.namespace, pod.name)
    _provision_pass(world)


def _canonical(events):
    """The event log with each provisioning pass's binds as a multiset: the
    other events, in and between passes, keep their order."""
    out, binds, others, inside = [], Counter(), [], False
    for event in events:
        if event == PASS_START:
            inside, binds, others = True, Counter(), []
        elif event == PASS_END:
            inside = False
            out.append(("pass", tuple(sorted(binds.items())), tuple(others)))
        elif inside and event[0] == "bind":
            binds[event] += 1
        elif inside:
            others.append(event)
        else:
            out.append(event)
    assert not inside, "a provisioning pass without its end marker"
    return out


def _ready_all(world):
    for node in world.cluster.list_nodes():
        if not node.ready:
            node.ready = True
            node.status_reported_at = world.clock.now()
            world.cluster.update_node(node)
        if node.deletion_timestamp is None:
            world.node.reconcile(node.name)


def _terminations(world, rounds=3):
    for _ in range(rounds):
        progressed = False
        for node in list(world.cluster.list_nodes()):
            if world.termination.reconcile(node.name) is not None:
                progressed = True
        world.termination.evictions.drain_once()
        if not progressed:
            return


def _snapshot(world):
    annotation = world.pkg.wellknown.CONSOLIDATION_ACTION_ANNOTATION
    nodes = sorted((n.name, n.instance_type, n.zone, n.capacity_type, n.annotations.get(annotation),
                    n.deletion_timestamp is not None) for n in world.cluster.list_nodes())
    pods = sorted((p.name, p.node_name) for p in world.cluster.list_pods())
    return nodes, pods


def _converge(world, rounds=6):
    """Consolidation sweeps, provisioning, kubelet joins and terminations to
    a fixpoint (the reference's test_consolidation.converge); the snapshot
    after every sweep."""
    history = []
    for _ in range(rounds):
        world.consolidation.reconcile()
        history.append(_snapshot(world))
        _provision_pass(world)
        _ready_all(world)
        _terminations(world)
        history.append(_snapshot(world))
    return history


def _scenario(seed):
    """Seeded pods (name, cpu) and the seeded share deleted before the
    sweeps."""
    rng = np.random.default_rng(seed)
    count = int(rng.integers(12, 30))
    specs = [(f"p{seed}-{i}", CPU_SIZES[int(rng.integers(0, len(CPU_SIZES)))]) for i in range(count)]
    doomed = sorted(rng.choice(count, size=int(count * rng.uniform(0.3, 0.6)), replace=False).tolist())
    return specs, doomed


def _run(name, seed, monkeypatch):
    specs, doomed = _scenario(seed)
    world = _world(name, monkeypatch)
    pods = _pods(world, specs)
    _provision(world, pods)
    _ready_all(world)
    start = _snapshot(world)
    for i in doomed:
        world.cluster.delete_pod(pods[i].namespace, pods[i].name)
    actions = {kind: world.pkg.consolidation.CONSOLIDATION_ACTIONS_TOTAL.get(kind, "executed")
               for kind in ("delete", "replace")}
    history = _converge(world)
    executed = {kind: world.pkg.consolidation.CONSOLIDATION_ACTIONS_TOTAL.get(kind, "executed") - before
                for kind, before in actions.items()}
    return start, history, world.events, executed


@pytest.mark.parametrize("seed", range(6))
def test_consolidation_takes_the_references_actions(seed, monkeypatch):
    ref = _run("reference", seed, monkeypatch)
    port = _run("port", seed, monkeypatch)
    start, history, events, executed = port
    assert start == ref[0], "the two packages provisioned different clusters"
    for step, (got, want) in enumerate(zip(history, ref[1])):
        assert got == want, f"the packages diverge at step {step} of the sweeps"
    assert _canonical(events) == _canonical(ref[2]), "evictions and binds differ"
    assert executed == ref[3]


def test_the_scenarios_exercise_both_actions(monkeypatch):
    """Across the seeds the sweeps delete and replace nodes, evict pods and
    lower the fleet's price."""
    kinds = Counter()
    evictions = 0
    for seed in range(6):
        start, history, events, executed = _run("port", seed, monkeypatch)
        kinds.update(executed)
        evictions += sum(1 for verb, _ in events if verb == "reschedule")
        assert len(history[-1][0]) <= len(start[0])
    assert kinds["delete"] > 0 and kinds["replace"] > 0 and evictions > 0


# --- the disruption ledger ---------------------------------------------------


LEDGER_TABLE = [
    # (budget, caps, claims per reason) -> headroom per reason
    (10, {}, {}),
    (10, {"consolidation": 1, "drift": 2}, {}),
    (10, {"consolidation": 1, "drift": 2}, {"consolidation": 1}),
    (3, {"consolidation": 5}, {"drift": 2, "emptiness": 1}),
    (0, {}, {}),
    (5, {"consolidation": 0}, {"emptiness": 2}),
    (4, {"drift": 2}, {"drift": 3, "consolidation": 1}),
    (10, {}, {"emptiness-scheduled": 3}),
]


def _ledger_headroom(name, budget, caps, claims):
    pkg = PACKAGES[name]
    wellknown = pkg.wellknown
    cluster = pkg.Cluster(clock=pkg.FakeClock())
    count = itertools.count()
    for reason, n in claims.items():
        for _ in range(n):
            node = pkg.NodeSpec(name=f"n-{next(count)}", instance_type="t", zone="z", capacity_type="spot",
                                finalizers=[wellknown.TERMINATION_FINALIZER])
            if reason == "consolidation":
                node.annotations[wellknown.CONSOLIDATION_ACTION_ANNOTATION] = "delete"
            elif reason == "drift":
                node.annotations[wellknown.DRIFT_ACTION_ANNOTATION] = "replace"
            else:
                node.annotations[wellknown.EMPTINESS_TIMESTAMP_ANNOTATION] = "1"
            cluster.create_node(node)
            if reason == "emptiness":
                cluster.delete_node(node.name)
    ledger = pkg.eligibility.DisruptionLedger(cluster, budget=budget, reason_caps=caps)
    reasons = (pkg.eligibility.REASON_CONSOLIDATION, pkg.eligibility.REASON_DRIFT,
               pkg.eligibility.REASON_EMPTINESS)
    return ledger.in_flight(), [ledger.headroom(reason) for reason in reasons]


@pytest.mark.parametrize("row", range(len(LEDGER_TABLE)))
def test_disruption_ledger_decides_as_the_reference(row):
    budget, caps, claims = LEDGER_TABLE[row]
    assert _ledger_headroom("port", budget, caps, claims) == _ledger_headroom("reference", budget, caps, claims)


# --- node lifecycle under a fake clock -----------------------------------------


def _one_node(name, monkeypatch, **ttls):
    world = _world(name, monkeypatch, **ttls)
    pod = _pods(world, [("solo", "1")])[0]
    _provision(world, [pod])
    node = world.cluster.get_node(world.cluster.get_pod(pod.namespace, pod.name).node_name)
    return world, node, pod


def _node_state(world, node_name):
    wellknown = world.pkg.wellknown
    node = world.cluster.try_get_node(node_name)
    if node is None:
        return "gone"
    return (node.ready, sorted(t.key for t in node.taints),
            sorted(k for k in node.annotations if k in (wellknown.EMPTINESS_TIMESTAMP_ANNOTATION,
                                                       wellknown.DRIFT_ACTION_ANNOTATION)),
            node.deletion_timestamp is not None)


def _readiness(name, monkeypatch):
    world, node, _ = _one_node(name, monkeypatch)
    states = [_node_state(world, node.name)]
    world.node.reconcile(node.name)
    states.append(_node_state(world, node.name))
    world.cluster.heartbeat_node(node.name, ready=True)
    world.node.reconcile(node.name)
    states.append(_node_state(world, node.name))
    return states


def _emptiness(name, monkeypatch):
    world, node, pod = _one_node(name, monkeypatch, ttl_empty=30)
    world.cluster.heartbeat_node(node.name, ready=True)
    world.cluster.delete_pod(pod.namespace, pod.name)
    requeue = world.node.reconcile(node.name)
    states = [_node_state(world, node.name), requeue]
    world.clock.advance(31)
    world.node.reconcile(node.name)
    states.append(_node_state(world, node.name))
    return states


def _expiration(name, monkeypatch):
    world, node, _ = _one_node(name, monkeypatch, ttl_expired=300)
    world.cluster.heartbeat_node(node.name, ready=True)
    requeue = world.node.reconcile(node.name)
    states = [_node_state(world, node.name), requeue]
    world.clock.advance(301)
    world.node.reconcile(node.name)
    states.append(_node_state(world, node.name))
    _terminations(world)
    states.append(_node_state(world, node.name))
    return states


@pytest.mark.parametrize("scenario", [_readiness, _emptiness, _expiration],
                         ids=["readiness", "emptiness", "expiration"])
def test_node_lifecycle_matches_the_reference(scenario, monkeypatch):
    got = scenario("port", monkeypatch)
    assert got == scenario("reference", monkeypatch)
    assert len({str(state) for state in got}) > 1, "the scenario changed nothing"


def _bound_pod(cluster):
    """A port store holding node a with one pod bound to it, and node b."""
    nodes = [PortNodeSpec(name=name, capacity={"cpu": 8.0, "memory": 8192.0}) for name in ("a", "b")]
    for node in nodes:
        cluster.create_node(node)
    pod = PortPodSpec(name="p", namespace="default", requests={"cpu": 1.0})
    cluster.apply_pod(pod)
    cluster.bind_pod(pod, nodes[0])
    return pod, nodes


def test_a_second_binding_to_another_node_is_refused():
    """Provisioning and consolidation can both hold one displaced pod: the
    first binding stands and the second is a 409, as the apiserver answers
    it; binding again to the same node stays idempotent."""
    from karpenter_tpu_torch.controllers.cluster import BindConflictError

    cluster = PortCluster()
    binds = []
    cluster.watch_deltas(lambda verb, kind, obj: binds.append(obj.node_name) if verb == "bind" else None)
    pod, (node_a, node_b) = _bound_pod(cluster)
    with pytest.raises(BindConflictError) as refused:
        cluster.bind_pod(pod, node_b)
    assert refused.value.status == 409
    cluster.bind_pod(pod, node_a)
    assert cluster.try_get_pod("default", "p").node_name == "a"
    assert binds == ["a", "a"]
    cluster.reschedule_pod("default", "p", override_pdb=True)
    cluster.bind_pod(pod, node_b)
    assert cluster.try_get_pod("default", "p").node_name == "b"


def test_a_pod_displaced_twice_is_rescheduled_once():
    """Two displacements that both saw the pod bound: the second finds it
    unbound under the store's lock, returns it unchanged and notifies
    nothing, so the reschedule epoch moves once."""
    cluster = PortCluster()
    verbs = []
    cluster.watch_deltas(lambda verb, kind, obj: verbs.append(verb))
    _bound_pod(cluster)
    first = cluster._reschedule_local("default", "p")
    second = cluster._reschedule_local("default", "p")
    assert first is second and first.node_name is None
    assert verbs.count("reschedule") == 1
    assert first.annotations[port_wellknown.RESCHEDULE_EPOCH_ANNOTATION] == "1"
