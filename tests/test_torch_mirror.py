"""Mirror test: the port's copies of host-only reference modules stay
AST-equal to their references apart from import statements, so a later fix
to the reference cannot silently miss the port.

Verbatim copies are compared whole. Trimmed copies are compared definition
by definition: every top-level function, class and public constant the port
keeps must equal the reference's of the same name, except the few the port
adapted, which are listed with the reason."""

import ast
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
VERBATIM = [
    "api/__init__.py",
    "api/resources.py",
    "api/wellknown.py",
    "api/requirements.py",
    "api/taints.py",
    "api/pods.py",
    "api/provisioner.py",
    "cloudprovider/__init__.py",
    "utils/__init__.py",
    "utils/logging.py",
    "utils/metrics.py",
    "utils/clock.py",
    "utils/crashpoints.py",
    "controllers/__init__.py",
    "controllers/errors.py",
    "controllers/cluster.py",
    "controllers/scheduling.py",
    "constraints/__init__.py",
    "constraints/terms.py",
    "constraints/ladder.py",
    "constraints/mirror.py",
    "constraints/compiler.py",
]
_DOCSTRING = "docstring only: names the port's files and devices"
_NO_MESH = "one device: no mesh, no sharded variant, no tracing spans"
# Trimmed copies: {module: {adapted definition: why}}.
TRIMMED = {
    "ops/ffd.py": {},
    "ops/mix_pack.py": {},
    "ops/encode.py": {"build_fleet": "no market hook: the port has no PriceBook yet"},
    "ops/native.py": {
        "_library_path": "the port builds csrc/host/ffd.cc into its own build directory",
        "_build": "g++ directly, without the reference's Makefile",
        "load": "loads the port's library path",
    },
    "ops/consolidate.py": {
        "_fetch": "copies a torch tensor to the host in place of jax.device_get",
        "_padded": "no device_resident handles: the port uploads the type arrays each sweep",
        "solve_candidates": "runs on a device the caller picks; K7 returns one eager buffer",
    },
    "utils/fence.py": {
        "WriteFence": "check records no flight-recorder event: the port has no flight "
                      "recorder, and no leader election arms a fence yet",
    },
    "constraints/solve.py": {
        "_dispatch_kernel": "no mesh hook or quarantine (one device); one packed upload, "
                            "the port's K6 on the solver's device, one fetch",
        "solve_constrained": "passes the solver's device to _dispatch_kernel",
        "pad_levels": "the reference's padding, split out of _dispatch_kernel so the "
                      "padding can be timed on its own",
    },
    "models/solver.py": {
        "Solver": "no pipelined solve and no pre-encoded pass-through yet",
        "NativeSolver": _DOCSTRING,
        "_rounds_ints": "the int32 dense spill of PackRounds as torch tensors",
        "_cost_fused_body": "K1-K4 on a torch device in one launch stream; " + _NO_MESH,
        "FusedHandle": "torch tensors; " + _NO_MESH,
        "FetchedPlan": "copies the LP assignment with .cpu() in place of device_get",
        "fetch_plans": "one cat and one device->host copy in place of device_get; " + _NO_MESH,
        "fetch_plan": "annotation names a class defined above it",
        "pad_kernel_args": _NO_MESH,
        "_pool_price_matrix": "no market hook: the port has no PriceBook yet",
        "sort_pool_rows": _DOCSTRING,
        "_cheapest_feasible_pools": _DOCSTRING,
        "_decode_rounds": _DOCSTRING,
        "_kernel_rounds_to_list": "annotation names a class the port imports",
        "cost_solve_dense": "runs on a device the caller picks; " + _NO_MESH,
        "_HostOverlap": "no pipelined solve yet, so no per-item wait",
        "compute_mix_candidate": _DOCSTRING,
        "cost_solve_host": "no dispatch counters yet",
        "host_solve_enabled": "no mesh: the gate is the pod count alone",
        "cost_solve_dispatch": "K1-K4 on a torch device with one packed upload; " + _NO_MESH,
        "_collect_candidates": "takes fetched plans only (no host-tuple candidates)",
        "cost_solve_finish": _DOCSTRING,
        "CostSolver": "runs on a device the caller picks and raises without a card; no "
                      "pipelined solve, warmup or device-memory ladder yet",
        "decode_dense_result": _DOCSTRING,
    },
}


class _DropImports(ast.NodeTransformer):
    def visit_Import(self, node):
        return None

    def visit_ImportFrom(self, node):
        return None


def _tree(path: Path) -> ast.Module:
    return _DropImports().visit(ast.parse(path.read_text()))


def _definitions(path: Path):
    """Top-level functions, classes and public constants (NAME = value), by
    name."""
    found = {}
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            found[node.name] = ast.dump(node)
        elif isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
            if isinstance(target, ast.Name) and target.id.isupper() and target.id[0] != "_":
                found[target.id] = ast.dump(node)
    return found


@pytest.mark.parametrize("relative", VERBATIM)
def test_verbatim_copy_matches_reference(relative):
    port = REPO / "karpenter_tpu_torch" / relative
    reference = REPO / "karpenter_tpu" / relative
    assert ast.dump(_tree(port)) == ast.dump(_tree(reference)), (
        f"karpenter_tpu_torch/{relative} drifted from karpenter_tpu/{relative}; "
        "carry the reference's change over (imports excepted)"
    )


@pytest.mark.parametrize("relative", sorted(TRIMMED))
def test_trimmed_copy_matches_reference_per_definition(relative):
    port = _definitions(REPO / "karpenter_tpu_torch" / relative)
    reference = _definitions(REPO / "karpenter_tpu" / relative)
    adapted = TRIMMED[relative]
    assert set(adapted) <= set(port), f"stale adapted entries: {set(adapted) - set(port)}"
    drifted = [
        name for name in port if name not in adapted and port[name] != reference.get(name)
    ]
    assert drifted == [], (
        f"karpenter_tpu_torch/{relative}: {drifted} differ from karpenter_tpu/{relative}"
    )
