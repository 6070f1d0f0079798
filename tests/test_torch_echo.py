"""The apiserver store's watch-echo race, fixed in the port's
kubeapi/cluster.py, driven deterministically on the CPU.

A write-through PATCHes (or POSTs, or PUTs) and only then records the rv of
the server's answer. A watch pump that delivers the echo of that very write
in between must not replace the cached instance the caller holds. Here the
fake apiserver client's write delivers the MODIFIED echo of its own answer
to the store's `_on_watch` before it returns, as the pump would in the worst
interleaving, and may deliver an external change (rv one past the write's)
or raise. No pump runs and nothing sleeps: every event arrives from the
writing thread at the point under test.
"""

import copy
from contextlib import contextmanager

import pytest

from karpenter_tpu_torch.api.pods import PodSpec
from karpenter_tpu_torch.api.provisioner import Provisioner
from karpenter_tpu_torch.cloudprovider import NodeSpec
from karpenter_tpu_torch.kubeapi import ApiServerCluster, KubeClient
from karpenter_tpu_torch.kubeapi.client import ApiError
from karpenter_tpu_torch.utils.fence import FencedWriteError
from tests import port_twins

_FAKE = port_twins.TwinPackage("port", "echo").module("fake_apiserver")


@pytest.fixture()
def store():
    """A store over the fake apiserver with no watch pump, holding a pod
    bound to a node and a provisioner."""
    server = _FAKE.FakeApiServer()
    cluster = ApiServerCluster(KubeClient(_FAKE.DirectTransport(server), qps=1e6, burst=10**6))
    node = cluster.create_node(NodeSpec(name="n1"))
    pod = cluster.apply_pod(PodSpec(name="web", unschedulable=True))
    cluster.bind_pod(pod, node)
    cluster.apply_provisioner(Provisioner(name="default"))
    yield server, cluster
    assert cluster._in_flight == {} and cluster._held == {}
    cluster.close()


def _rv(obj) -> int:
    return int(obj["metadata"]["resourceVersion"])


def _external(obj, key="external"):
    """Another writer's change to `obj`, one rv past it."""
    change = copy.deepcopy(obj)
    change["metadata"]["resourceVersion"] = str(_rv(obj) + 1)
    change["metadata"].setdefault("annotations", {})[key] = "yes"
    return change


@contextmanager
def echoing(cluster, kind, external=False, fail=False):
    """Wrap the client's writes: each delivers the MODIFIED echo of its own
    answer to the store before it returns; with `external`, then a change at
    the next rv; with `fail`, the external change and then an ApiError 500
    in place of the answer."""
    api = cluster.api
    originals = {verb: getattr(api, verb) for verb in ("create", "update", "patch")}

    def wrap(verb):
        def write(path, body):
            answer = originals[verb](path, body)
            if not fail:
                cluster._on_watch(kind, "MODIFIED", copy.deepcopy(answer))
            if external or fail:
                cluster._on_watch(kind, "MODIFIED", _external(answer))
            if fail:
                raise ApiError(500, "injected")
            return answer
        return write

    for verb in originals:
        setattr(api, verb, wrap(verb))
    try:
        yield
    finally:
        for verb, original in originals.items():
            setattr(api, verb, original)


# (kind, the cached object's getter, a write of it) for a node, a pod and a
# provisioner write-through.
def _node(cluster):
    return cluster.get_node("n1")


def _pod(cluster):
    return cluster.get_pod("default", "web")


def _provisioner(cluster):
    return cluster.try_get_provisioner("default")


def _update_node(cluster, node):
    node.labels["team"] = "a"
    cluster.update_node(node)


def _reschedule(cluster, pod):
    cluster.reschedule_pod("default", "web", override_pdb=True)


def _provisioner_status(cluster, provisioner):
    cluster.update_provisioner_status(provisioner)


WRITES = {
    "update_node": ("node", _node, _update_node),
    "pod": ("pod", _pod, _reschedule),
    "provisioner_status": ("provisioner", _provisioner, _provisioner_status),
}


@pytest.mark.parametrize("write", sorted(WRITES))
def test_the_echo_of_an_in_flight_write_keeps_the_cached_instance(store, write):
    _, cluster = store
    kind, cached, act = WRITES[write]
    held = cached(cluster)
    with echoing(cluster, kind):
        act(cluster, held)
    assert cached(cluster) is held
    assert (cluster.echoes_held, cluster.echoes_dropped, cluster.echoes_applied) == (1, 1, 0)


_PATHS = {"node": ("nodes", "", "n1"), "pod": ("pods", "default", "web"),
          "provisioner": ("provisioners", "", "default")}
_KEYS = {"node": "n1", "pod": ("default", "web"), "provisioner": "default"}


@pytest.mark.parametrize("write", sorted(WRITES))
def test_an_external_change_during_the_write_is_applied_after_it(store, write):
    server, cluster = store
    kind, cached, act = WRITES[write]
    held = cached(cluster)
    with echoing(cluster, kind, external=True):
        act(cluster, held)
    assert cached(cluster) is not held
    if kind != "provisioner":  # the store's Provisioner keeps no annotations
        assert cached(cluster).annotations["external"] == "yes"
    assert cluster._rv[(kind, _KEYS[kind])] == _rv(server.get_object(*_PATHS[kind])) + 1
    assert (cluster.echoes_held, cluster.echoes_dropped, cluster.echoes_applied) == (2, 1, 1)


@pytest.mark.parametrize("write", sorted(WRITES))
def test_a_failed_write_releases_the_external_change_it_held(store, write):
    server, cluster = store
    kind, cached, act = WRITES[write]
    held = cached(cluster)
    with echoing(cluster, kind, fail=True), pytest.raises(ApiError):
        act(cluster, held)
    assert cached(cluster) is not held
    assert cluster._rv[(kind, _KEYS[kind])] == _rv(server.get_object(*_PATHS[kind])) + 1
    assert (cluster.echoes_held, cluster.echoes_dropped, cluster.echoes_applied) == (1, 0, 1)


def test_a_refused_fence_holds_nothing(store):
    server, cluster = store
    node = _node(cluster)
    cluster.fence.arm("leader", 1)
    cluster.fence.revoke("leader")
    with pytest.raises(FencedWriteError):
        cluster.update_node(node)
    assert cluster._in_flight == {}
    # An external change right after is applied at once.
    cluster._on_watch("node", "MODIFIED", _external(server.get_object("nodes", "", "n1")))
    assert _node(cluster) is not node and cluster.echoes_held == 0


def test_the_last_of_two_writes_in_flight_releases(store):
    """A second write of the object starts inside the first's RPC: the
    events of both wait for the first to end, and both are dropped as the
    echoes they are."""
    _, cluster = store
    node = _node(cluster)
    api = cluster.api
    patch = api.patch

    def patch_with_echo(path, body):
        answer = patch(path, body)
        cluster._on_watch("node", "MODIFIED", copy.deepcopy(answer))
        return answer

    def outer_patch(path, body):
        api.patch = patch_with_echo
        node.labels["inner"] = "1"
        cluster.update_node(node)
        assert cluster._in_flight == {("node", "n1"): 1}  # the inner write ended
        assert len(cluster._held[("node", "n1")]) == 1  # its echo waits for this one
        return patch_with_echo(path, body)

    api.patch = outer_patch
    try:
        node.labels["outer"] = "1"
        cluster.update_node(node)
    finally:
        api.patch = patch
    assert _node(cluster) is node
    assert (cluster.echoes_held, cluster.echoes_dropped, cluster.echoes_applied) == (2, 2, 0)


def test_deleted_and_list_items_are_not_held(store):
    server, cluster = store
    node = _node(cluster)
    api = cluster.api
    patch = api.patch

    def patch_then_delete(path, body):
        answer = patch(path, body)
        gone = copy.deepcopy(answer)
        gone["metadata"]["resourceVersion"] = str(_rv(answer) + 5)
        cluster._on_watch("node", "DELETED", gone)
        # The DELETED event is applied at once: the node left the cache
        # while its write is still in flight.
        assert cluster.try_get_node("n1") is None
        return answer

    api.patch = patch_then_delete
    try:
        cluster.update_node(node)
    finally:
        api.patch = patch
    assert cluster.echoes_held == 0
    # A re-LIST during a write applies its items at once too.
    pod = _pod(cluster)
    relisted = []

    def patch_then_relist(path, body):
        answer = patch(path, body)
        cluster._relist("pod", "/api/v1/pods")
        relisted.append(_pod(cluster))
        return answer

    api.patch = patch_then_relist
    try:
        cluster.reschedule_pod("default", "web", override_pdb=True)
    finally:
        api.patch = patch
    assert relisted[0] is not pod
    assert cluster.echoes_held == 0
