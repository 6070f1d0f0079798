"""The port's solver sidecar (solver_service) under the reference's own
suites, on the CPU.

tests/test_solver_service.py runs here a second time with every
`karpenter_tpu` name pointed at `karpenter_tpu_torch` (tests/port_twins.py):
the wire codecs, server parity with the in-process solvers, the client's
fallback and blackout, health, the boot warmup, the warming gate and
SolveStream. So does TestPipelineWiring of tests/test_tracing.py: the
provisioning pass's spans, and the RPC spans with the trace id that rides
the call's metadata to the server. The port's server and solvers run on the
CPU (port_twins.cpu_by_default, for the whole module: the reference's
suite starts one server per module).
"""

import ast

import pytest
import torch

from tests import port_twins

torch.set_num_threads(2)

_TWINS = port_twins.TwinPackage("port", "solver_service")
SUITE = _TWINS.module("test_solver_service")
CLASSES = port_twins.expose(SUITE, globals())
TRACING = _TWINS.module("test_tracing")
TestPipelineWiring = TRACING.TestPipelineWiring
tracer = TRACING.tracer


@pytest.fixture(scope="module", autouse=True)
def _on_the_cpu():
    """Before the suite's module-scoped server: a device of None is the
    CPU while this module runs."""
    with pytest.MonkeyPatch.context() as monkeypatch:
        port_twins.cpu_by_default(monkeypatch)
        yield


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    port_twins.cpu_by_default(monkeypatch)
    port_twins.reset_port_state()
    yield
    port_twins.reset_port_state()


def _classes(stem):
    tree = ast.parse((port_twins.TESTS / f"{stem}.py").read_text())
    return {node.name for node in tree.body if isinstance(node, ast.ClassDef) and node.name.startswith("Test")}


def test_every_reference_class_runs_on_the_port():
    assert set(CLASSES) == _classes("test_solver_service")
    assert "TestPipelineWiring" in _classes("test_tracing")
    assert SUITE.SolverServer.__module__ == "karpenter_tpu_torch.solver_service.server"
    assert SUITE.RemoteSolver.__module__ == "karpenter_tpu_torch.solver_service.client"
    assert SUITE.CostSolver.__module__ == "karpenter_tpu_torch.models.solver"
    assert TRACING.tracing.__name__ == "karpenter_tpu_torch.utils.tracing"
