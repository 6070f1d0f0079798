"""The controller on an apiserver with the EC2 provider: the port against the
JAX package, on the CPU.

One provisioning pass on the apiserver backend under both packages: each
package's Harness (a twin of tests/harness.py, tests/port_twins.py) over its
`ApiServerCluster` in front of its fake apiserver, the EC2 provider over
`FakeEc2` with chip_smoke's EC2 catalog (24 types, 3 zones), the cost solve
on one device (the port's plain versions on the CPU, the reference's XLA
on the CPU; the host route shut on both), 200 pods in the main path's Zipf
shapes. The store's deltas (binds, reschedules, deletes), every pod's node,
the Binding POSTs the apiserver received, the nodes bought and every
`create_fleet` input must be equal.

Then `cmd/controller.main` with `--cluster-store http://...` (the fake
apiserver served over HTTP in this process) and `--cloud-provider ec2`
binds 200 pods applied through the API, each once, on nodes that are live
FakeEc2 instances.
"""

import dataclasses
import itertools
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch

import chip_smoke
from tests import port_twins

torch.set_num_threads(2)

NUM_PODS = 200
NUM_TYPES = 24


@pytest.fixture(autouse=True)
def _port_state():
    port_twins.reset_port_state()
    yield
    port_twins.reset_port_state()


def _pods(twins):
    PodSpec = twins.library("api.pods").PodSpec
    shapes = chip_smoke.pod_shapes(0)
    counts = (chip_smoke.zipf_weights(len(shapes)) * NUM_PODS).astype(int)
    counts[0] += NUM_PODS - counts.sum()
    pods = [
        PodSpec(name=f"p-{k}-{i}", uid=f"p-{k}-{i}",
                requests={"cpu": f"{cpu}m", "memory": f"{mem}Mi"}, unschedulable=True)
        for k, ((cpu, mem), count) in enumerate(zip(shapes, counts))
        for i in range(count)
    ]
    order = np.random.default_rng(5).permutation(len(pods))
    return [pods[i] for i in order]


def _binding_posts(server) -> Counter:
    """Count the Binding POSTs a fake apiserver answers, by pod name."""
    posts = Counter()
    handle = server.handle

    def counting(method, path, query="", body=None):
        if method == "POST" and path.endswith("/binding"):
            posts[path.split("/")[-2]] += 1
        return handle(method, path, query, body)

    server.handle = counting
    return posts


def _provision(package: str, monkeypatch):
    twins = port_twins.TwinPackage(package, "apiserver")
    lib = twins.library
    monkeypatch.setattr(lib("cloudprovider.fake"), "_node_counter", itertools.count(1))
    clock = lib("utils.clock").FakeClock()
    api = lib("cloudprovider.ec2.fake").FakeEc2(
        instance_type_infos=chip_smoke.ec2_instance_type_infos(lib("cloudprovider.ec2.api"), NUM_TYPES),
        zones=chip_smoke.ZONES, cluster_name=chip_smoke.APISERVER_CLUSTER)
    cloud = lib("cloudprovider.ec2").Ec2CloudProvider(
        api=api, cluster_name=chip_smoke.APISERVER_CLUSTER, clock=clock)
    validation = lib("api.validation")
    monkeypatch.setattr(validation, "DEFAULT_HOOK", cloud.default)
    monkeypatch.setattr(validation, "VALIDATE_HOOK", cloud.validate)
    solver_module = lib("models.solver")
    solver = (solver_module.CostSolver(device="cpu") if package == "port"
              else solver_module.CostSolver())
    h = twins.module("harness").Harness(clock=clock, cloud=cloud, solver=solver, backend="apiserver")
    try:
        posts = _binding_posts(h.apiserver)
        deltas = Counter()
        h.cluster.watch_deltas(lambda verb, kind, obj: deltas.update(
            [(verb, kind, obj.name)] if verb in ("bind", "reschedule", "delete") else []))
        h.apply_provisioner(chip_smoke.ec2_provisioner(
            lib("api.provisioner"), lib("api.requirements"), lib("api.wellknown")))
        pods = _pods(twins)
        h.provision(*pods)
        stored = {obj["metadata"]["name"]: obj["spec"].get("nodeName")
                  for obj in h.apiserver.handle("GET", "/api/v1/pods")[1]["items"]}
        return {
            "deltas": deltas,
            "cache_bindings": {p.name: h.cluster.get_pod(p.namespace, p.name).node_name for p in pods},
            "apiserver_bindings": stored,
            "binding_posts": posts,
            "nodes": sorted((n.name, n.instance_type, n.zone, n.capacity_type, n.provider_id)
                            for n in h.cluster.list_nodes()),
            "create_fleet": [dataclasses.asdict(request) for request in api.calls["create_fleet"]],
            "live_instances": sorted(api.instances),
        }
    finally:
        h.cluster.close()


def test_provisioning_on_the_apiserver_with_ec2_matches_the_reference(monkeypatch):
    monkeypatch.setenv("KARPENTER_SHARDED_SOLVE", "0")
    monkeypatch.setenv("KARPENTER_HOST_SOLVE", "0")
    want = _provision("reference", monkeypatch)
    got = _provision("port", monkeypatch)
    bound = want["apiserver_bindings"]
    assert len(bound) == NUM_PODS and all(bound.values())
    assert set(want["binding_posts"]) == set(bound) and set(want["binding_posts"].values()) == {1}
    assert want["create_fleet"] and len(want["nodes"]) == len(want["live_instances"])
    for key in want:
        assert got[key] == want[key], f"{key} differs"


# --- cmd/controller.main on an http:// store --------------------------------


def _wait_until(condition, timeout: float = 60.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if condition():
            return True
        time.sleep(0.05)
    return bool(condition())


def test_controller_main_on_an_http_store_binds_every_pod_once(monkeypatch):
    from karpenter_tpu_torch.api import provisioner as provisioner_module
    from karpenter_tpu_torch.api import requirements as requirements_module
    from karpenter_tpu_torch.api import wellknown
    from karpenter_tpu_torch.cloudprovider import registry
    from karpenter_tpu_torch.cloudprovider.ec2 import Ec2CloudProvider
    from karpenter_tpu_torch.cloudprovider.ec2.fake import FakeEc2
    from karpenter_tpu_torch.cloudprovider.ec2.instances import PROVIDER_ID_FORMAT
    from karpenter_tpu_torch.cmd import controller
    from karpenter_tpu_torch.kubeapi import ApiServerCluster, KubeClient, convert
    from karpenter_tpu_torch.kubeapi.client import HttpTransport
    from karpenter_tpu_torch.kubeapi.cluster import PROVISIONERS

    monkeypatch.setenv("KARPENTER_WARMUP_SHAPES", "8x8")
    fake_apiserver = port_twins.TwinPackage("port", "controller_http").module("fake_apiserver")
    server = fake_apiserver.FakeApiServer()
    posts = _binding_posts(server)
    httpd = fake_apiserver.serve_http(server, 0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    metrics_port, probe_port = chip_smoke.free_port(), chip_smoke.free_port()
    argv = ["--cluster-name", chip_smoke.APISERVER_CLUSTER, "--cluster-store", url,
            "--cloud-provider", "ec2", "--metrics-port", str(metrics_port),
            "--health-probe-port", str(probe_port)]
    manager = None
    try:
        manager = controller.main(argv, block=False, device="cpu")
        cloud = manager.cloud
        assert isinstance(manager.cluster, ApiServerCluster)
        assert isinstance(manager.cluster.api.transport, HttpTransport)
        assert isinstance(cloud, Ec2CloudProvider) and isinstance(cloud.api, FakeEc2)
        assert _wait_until(manager.ready.is_set)
        # kubectl's side: the provisioner and the pods through the API.
        client = KubeClient(HttpTransport(url), qps=1e6, burst=10**6)
        provisioner = chip_smoke.ec2_provisioner(provisioner_module, requirements_module, wellknown)
        client.create(PROVISIONERS, convert.provisioner_to_kube(provisioner))
        pods = _pods(port_twins.TwinPackage("port", "controller_http"))
        threads = [threading.Thread(target=lambda chunk=pods[i::8]: [
            client.create(f"/api/v1/namespaces/{p.namespace}/pods", convert.pod_to_kube(p)) for p in chunk])
            for i in range(8)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join()

        def bound():
            return {obj["metadata"]["name"]: obj["spec"].get("nodeName")
                    for obj in server.handle("GET", "/api/v1/pods")[1]["items"]}

        assert _wait_until(lambda: len(bound()) == NUM_PODS and all(bound().values()), 120.0), (
            sum(1 for node in bound().values() if node))
        assert set(posts) == {p.name for p in pods} and set(posts.values()) == {1}
        nodes = server.handle("GET", "/api/v1/nodes")[1]["items"]
        provider_ids = {node["spec"]["providerID"] for node in nodes}
        live = {PROVIDER_ID_FORMAT.format(zone=i.zone, instance_id=i.instance_id)
                for i in cloud.api.instances.values()}
        assert provider_ids == live and set(bound().values()) <= {n["metadata"]["name"] for n in nodes}
    finally:
        if manager is not None:
            manager.stop()
            manager.elector.release()
            manager.cluster.close()
        httpd.shutdown()
        registry.new_cloud_provider("fake")


def test_chip_smokes_apiserver_phase_rehearses_on_the_cpu(monkeypatch):
    """chip_smoke's `apiserver` phase at a small size with the controller on
    the CPU: the store process's checks (every pod bound once through the
    Binding subresource, nodes equal to the live FakeEc2 instances, every
    displaced pod bound again once, the $/hr lower) hold; the kernel launch
    checks are the card's."""
    monkeypatch.setenv("KARPENTER_HOST_SOLVE", "0")
    monkeypatch.setenv("KARPENTER_WARMUP_SHAPES", "8x8")
    result = chip_smoke.apiserver_phase("cpu", num_pods=300, consolidation_s=10.0)
    assert result["pods"] == 300 and result["device_solves"] >= 1
    assert result["requests"]["POST pods/binding"] >= 300
    assert result["cost_after"] < result["cost_before"]
