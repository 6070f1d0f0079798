"""The controller suites on the port's apiserver-backed store, on the CPU.

tests/test_backend_parity.py runs here a second time with every
`karpenter_tpu` name pointed at `karpenter_tpu_torch` (tests/port_twins.py):
each controller suite it re-runs (provisioning, selection, termination,
node lifecycle, scheduling, crash consistency, interruption,
consolidation, market, chaos, health, drift) and its Lease CAS cases run
over the port's `ApiServerCluster` in front of the fake apiserver, through
the suite's own autouse fixture that flips the Harness's default backend.
The solves and consolidation sweeps the suites build without naming a
device run on the CPU (port_twins.cpu_by_default).
The reference's file runs the same cases on the JAX package's store.
"""

import pytest
import torch

from tests import port_twins

torch.set_num_threads(2)

SUITE = port_twins.TwinPackage("port", "parity").module("test_backend_parity")
CLASSES = port_twins.expose(SUITE, globals())


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    port_twins.cpu_by_default(monkeypatch)
    port_twins.reset_port_state()
    yield
    port_twins.reset_port_state()


def test_every_reference_class_runs_on_the_port():
    import ast

    tree = ast.parse((port_twins.TESTS / "test_backend_parity.py").read_text())
    assert set(CLASSES) == {node.name for node in tree.body
                            if isinstance(node, ast.ClassDef) and node.name.startswith("Test")}
    harness = SUITE.harness_mod.Harness(backend="apiserver")
    try:
        assert type(harness.cluster).__module__ == "karpenter_tpu_torch.kubeapi.cluster"
    finally:
        harness.cluster.close()
