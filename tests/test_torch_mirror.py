"""Mirror test: the port's copies of host-only reference modules stay
AST-equal to their references apart from import statements, so a later fix
to the reference cannot silently miss the port.

Verbatim copies are compared whole. Trimmed copies are compared definition
by definition: every top-level function, class and public constant the port
keeps must equal the reference's of the same name, except the few the port
adapted, which are listed with the reason. A class named in an adapted
entry as "Class.method" is compared method by method: the class's other
methods, and the class without its methods, must equal the reference's."""

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
_PORT_ONLY = "the port's own helper"
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
        "_padded": "returns numpy arrays; solve_candidates keeps the type arrays resident "
                   "as it uploads (the device is the caller's)",
        "solve_candidates": "runs on a device the caller picks; one packed upload with the "
                            "type arrays resident; K7 returns one eager buffer",
    },
    "ops/incremental.py": {
        "LIBRARY": "K8's CUDA source and its C functions",
        "pad_indices": "docstring only: the port has no jit cache to key",
        "_scatter_ref": _PORT_ONLY + ": K8's plain scatter",
        "_gather_ref": _PORT_ONLY + ": K8's plain gather",
        "_width": _PORT_ONLY,
        "_check": _PORT_ONLY,
        "_stream": _PORT_ONLY,
        "scatter": "K8's scatter (the reference's scatter_rows and scatter_vals): "
                   "csrc/incremental.cu on the card, the plain version on the CPU, "
                   "into a copy of dst",
        "gather": "K8's gather (the reference's gather_rows): csrc/incremental.cu on "
                  "the card, the plain version on the CPU",
    },
    "models/cluster_state.py": {
        "DeviceClusterState.__init__": "takes the device its arrays live on",
        "DeviceClusterState._dispatch_plan": "one packed copy of every mirror (full), or of "
                                             "the delta rows and index vectors, then K8's "
                                             "scatters",
        "DeviceClusterState.pending_groups": "uploads the permutation, then K8's gathers",
        "DeviceClusterState.encode_fleet": "no market fingerprint: the port has no "
                                           "PriceBook yet, so it keys None (no active book)",
    },
    "utils/faultpoints.py": {
        "draw": "records no flight-recorder event: the port has no flight recorder",
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
        "NativeSolver": _DOCSTRING,
        "_rounds_ints": "the int32 dense spill of PackRounds as torch tensors",
        "_cost_fused_body": "K1-K4 on a torch device in one launch stream; " + _NO_MESH,
        "FusedHandle": "torch tensors and a slot for the staged copy; " + _NO_MESH,
        "FetchedPlan": "copies the LP assignment with .cpu() in place of device_get",
        "_eager_payload": _PORT_ONLY,
        "plan_start_fetch": "one non-blocking copy into pinned memory behind an event, "
                            "in place of copy_to_host_async",
        "fetch_plans": "waits on a staged copy's event, else one cat and one device->host "
                       "copy, in place of device_get; " + _NO_MESH,
        "fetch_plan": "annotation names a class defined above it",
        "device_pod_args": _DOCSTRING,
        "_HostOverlap": _DOCSTRING,
        "pad_kernel_args": "pads pod tensors already on the device with torch; " + _NO_MESH,
        "_pool_price_matrix": "no market hook: the port has no PriceBook yet",
        "sort_pool_rows": _DOCSTRING,
        "_cheapest_feasible_pools": _DOCSTRING,
        "_decode_rounds": _DOCSTRING,
        "_kernel_rounds_to_list": "annotation names a class the port imports",
        "cost_solve_dense": "runs on a device the caller picks; " + _NO_MESH,
        "compute_mix_candidate": _DOCSTRING,
        "host_solve_enabled": "no mesh: the gate is the pod count alone",
        "cost_solve_dispatch": "K1-K4 on a torch device, the fleet resident and the rest in "
                               "one packed upload; " + _NO_MESH,
        "_collect_candidates": "takes fetched plans only (no host-tuple candidates)",
        "cost_solve_finish": _DOCSTRING,
        "_is_resource_exhausted": "also takes torch.cuda.OutOfMemoryError",
        "_hbm_budget_bytes": "the card's total memory from torch.cuda.mem_get_info",
        "_presplit_for_hbm": "reads the budget of the solver's device",
        "CostSolver": "runs on a device the caller picks and raises without a card; the "
                      "floor answers from the host path with no backend pin; no tracing "
                      "spans; no warmup",
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


def _definitions(path: Path, split=()):
    """Top-level functions, classes and public constants (NAME = value), by
    name; the classes named in `split` as their methods ("Class.method")
    and the class without them."""
    found = {}
    for node in _tree(path).body:
        if isinstance(node, ast.ClassDef) and node.name in split:
            methods = [item for item in node.body if isinstance(item, ast.FunctionDef)]
            for method in methods:
                found[f"{node.name}.{method.name}"] = ast.dump(method)
            node.body = [item for item in node.body if item not in methods]
            found[node.name] = ast.dump(node)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
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
    adapted = TRIMMED[relative]
    split = {name.split(".")[0] for name in adapted if "." in name}
    port = _definitions(REPO / "karpenter_tpu_torch" / relative, split)
    reference = _definitions(REPO / "karpenter_tpu" / relative, split)
    assert set(adapted) <= set(port), f"stale adapted entries: {set(adapted) - set(port)}"
    drifted = [
        name for name in port if name not in adapted and port[name] != reference.get(name)
    ]
    assert drifted == [], (
        f"karpenter_tpu_torch/{relative}: {drifted} differ from karpenter_tpu/{relative}"
    )
