"""The port's apiserver-backed cluster store (kubeapi) under the reference's
own suite, on the CPU.

tests/test_apiserver_cluster.py runs here a second time with every
`karpenter_tpu` name pointed at `karpenter_tpu_torch` (tests/port_twins.py),
its fake apiserver and helpers too: write-through, the finalizer protocol,
eviction, watch sync and 410 resync, Lease CAS, the HTTP wire and a Manager
over the store. The reference's file runs the same cases on the JAX
package's store, so each case holds both packages to one assertion on one
input. The port's Manager runs on the CPU (port_twins.cpu_by_default).
"""

import pytest
import torch

from tests import port_twins

torch.set_num_threads(2)

SUITE = port_twins.TwinPackage("port", "kubeapi").module("test_apiserver_cluster")
CLASSES = port_twins.expose(SUITE, globals())


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    port_twins.cpu_by_default(monkeypatch)
    port_twins.reset_port_state()
    yield
    port_twins.reset_port_state()


def test_every_reference_class_runs_on_the_port():
    import ast

    tree = ast.parse((port_twins.TESTS / "test_apiserver_cluster.py").read_text())
    assert set(CLASSES) == {node.name for node in tree.body
                            if isinstance(node, ast.ClassDef) and node.name.startswith("Test")}
    assert SUITE.ApiServerCluster.__module__ == "karpenter_tpu_torch.kubeapi.cluster"
    assert SUITE.FakeApiServer.__module__.startswith("_twin_kubeapi_port")
