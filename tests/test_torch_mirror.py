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
    "controllers/scheduling.py",
    "constraints/__init__.py",
    "constraints/terms.py",
    "constraints/ladder.py",
    "constraints/mirror.py",
    "constraints/compiler.py",
    "ops/encode.py",
    "utils/faultpoints.py",
    "utils/fence.py",
    "utils/cache.py",
    "api/validation.py",
    "drift/__init__.py",
    "cloudprovider/market.py",
    "cloudprovider/fake.py",
    "market/feed.py",
    "controllers/market.py",
    "controllers/provisioning.py",
    "controllers/selection.py",
    "utils/obs.py",
    "utils/backoff.py",
    "utils/workqueue.py",
    "utils/stackprof.py",
    "utils/gctune.py",
    "controllers/eligibility.py",
    "controllers/termination.py",
    "controllers/counter.py",
    "controllers/metrics.py",
    "controllers/drift.py",
    "controllers/node.py",
    "cmd/__init__.py",
]
_DOCSTRING = "docstring only: names the port's files and devices"
_NO_SPANS = "no tracing spans"
_MESH = "a mesh is a grid of shards in one process (parallel/mesh.py), not a jax Mesh"
_PORT_ONLY = "the port's own helper"
_HISTORY = "docstring only: without the reference's history of which change added what"
# Trimmed copies: {module: {adapted definition: why}}.
TRIMMED = {
    "controllers/cluster.py": {
        "BindConflictError": _PORT_ONLY + ": the apiserver's 409 on a second Binding",
        "Cluster.bind_pod": "refuses a pod already bound to another node, as the apiserver "
                            "does (the threaded Manager's provisioning and consolidation "
                            "raced to bind one pod twice on the card)",
        "Cluster._reschedule_local": "re-checks under the lock that the pod is still bound, "
                                     "so two displacements of one pod notify once",
    },
    "ops/ffd.py": {},
    "ops/mix_pack.py": {},
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
        "scatter": "K8's scatter (the reference's scatter_rows and scatter_vals): "
                   "csrc/incremental.cu on the card, the plain version on the CPU, "
                   "into a copy of dst",
        "gather": "K8's gather (the reference's gather_rows): csrc/incremental.cu on "
                  "the card, the plain version on the CPU",
        "MAX_ARRAYS": _PORT_ONLY + ": the arrays one K8 launch takes",
        "_scatter_flush_ref": _PORT_ONLY + ": K8's plain flush",
        "_gather_view_ref": _PORT_ONLY + ": K8's plain view",
        "_route": _PORT_ONLY,
        "_outputs": _PORT_ONLY,
        "scatter_flush": _PORT_ONLY + ": a flush's scatters of every slot array in one K8 launch",
        "gather_view": _PORT_ONLY + ": a view's gathers of every source in one K8 launch",
    },
    "models/cluster_state.py": {
        "DeviceClusterState.__init__": "takes the device its arrays live on",
        "DeviceClusterState._dispatch_plan": "one packed copy of every mirror (full), or of "
                                             "the delta rows and index vectors, then one K8 "
                                             "flush of every changed array",
        "DeviceClusterState.pending_groups": "uploads the permutation, then one K8 view of "
                                             "both group arrays",
        "DeviceClusterState.encode_fleet": _HISTORY,
    },
    "utils/tracing.py": {
        "_SpanContext": "enters torch.profiler.record_function in place of "
                        "jax.profiler.TraceAnnotation",
        "_ProfileSession": "a torch.profiler capture exported as a Chrome trace in place of "
                           "jax.profiler.start_trace",
    },
    "utils/options.py": {
        "LAUNCH_GRACE_SECONDS": "a copy of controllers/instancegc's constant, which "
                                "Options validates against: the GC controller is not ported",
    },
    "market/__init__.py": {},
    "market/pricebook.py": {"stamp_epoch": _HISTORY},
    "market/forecast.py": {
        "penalize_prices_torch": "the torch mirror of penalize_prices_jnp: K10 on the card, "
                                 "its plain version on the CPU",
    },
    "runtime.py": {
        "make_solver": "places the device solvers on a device the caller picks; the sidecar "
                       "(remote) is not ported and raises",
        "LeaderLock.__init__": "the lock file lies in the process's temporary directory",
        "Manager.__init__": "places the solver, encoder and consolidation solve on a device "
                            "the caller picks; no podgc, instancegc, interruption or health "
                            "controllers or loops; keeps the error of a failed card warmup",
        "Manager._reprice_requeue": "counts its calls (reprice_requeues)",
        "Manager.start": "no podgc, instancegc, interruption or health seed enqueues; refuses "
                         "after a failed card warmup",
        "Manager.start_standby": "docstring only: the warmup's debt is the kernels' builds "
                                 "and first launches",
        "Manager._kick_warmup": "probes the solver's device; a DEGRADED verdict stops the "
                                "Manager and raises (no CPU pin, no host routing)",
        "Manager._warmup": "warms the solver's device; on the card a failed warmup stops the "
                           "Manager (no serving from a card that cannot solve)",
    },
    "cmd/controller.py": {
        "build_cluster": "the in-memory store only: kubeapi is not ported",
        "main": "takes the device the Manager runs on; hands the elector to a caller that "
                "does not block; no JAX donation advisory to suppress; a Manager stopped by a "
                "failed card warmup ends the blocking process with its error",
    },
    "cloudprovider/registry.py": {
        "_register_builtins": "registers fake; asking for ec2 raises KeyError (not ported)",
    },
    "utils/backend_health.py": {
        "BackendHealth.ensure_backend": "settles HEALTHY for a CPU device without a probe, "
                                        "else takes the verdict; no CPU pin",
        "ensure_backend": "passes the device asked for",
    },
    "models/warmup.py": {
        "WARMUP_RUNG_FAILURES": _PORT_ONLY + ": counts the rungs that failed",
        "warmup_ladder": "builds every kernel source first, then the ladder and the "
                         "calibration on a device the caller picks; on the card a failed "
                         "build, rung or calibration raises",
        "_compile_shapes": "passes the device; counts a failed rung, and raises it on the card",
        "_timed_device_solve_ms": "device pods are torch tensors already on the device; "
                                  "the solve runs on a device the caller picks and counts on "
                                  "the dispatch metric; finish=True finishes the plan with its "
                                  "host half (the LP solver's first import) at boot",
    },
    "controllers/consolidation.py": {
        "ConsolidationController.__init__": "takes the device K7 runs on",
        "ConsolidationController._solve_group": "passes that device to solve_candidates",
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
        "_cost_fused_body": "K1-K4 on a torch device in one launch stream, the K2 pair's "
                            "epilogue writing feasible_any, the LP's counts, the dense spill "
                            "and the payload; the mesh path is _sharded_fused_solve, so no "
                            "constrain or compact hook",
        "FusedHandle": "torch tensors, a slot for the staged copy; on a mesh lp is a "
                       "ShardedAssignment",
        "FetchedPlan": "copies the LP assignment with .cpu() in place of device_get",
        "_eager_payload": _PORT_ONLY,
        "plan_start_fetch": "one non-blocking copy into pinned memory behind an event, "
                            "in place of copy_to_host_async",
        "fetch_plans": "waits on a staged copy's event, else one cat and one device->host "
                       "copy, in place of device_get (_eager_words), quarantine around it; "
                       "decodes with decompact_plan_sharded at every shard count",
        "fetch_plan": "annotation names a class defined above it",
        "device_pod_args": _DOCSTRING,
        "_HostOverlap": _DOCSTRING,
        "pad_kernel_args": "pads pod tensors already on the device with torch, to the mesh's "
                           "multiples too",
        "run_kernel_dense": "uploads the padded inputs to a device the caller picks",
        "_run_kernel": "passes the solver's device",
        "_to_host": "one flat int32 copy of the rounds to the host in place of device_get",
        "TPUSolver": "runs on a device the caller picks and raises without a card; counts "
                     "its host FFD fallbacks",
        "sort_pool_rows": _DOCSTRING,
        "_cheapest_feasible_pools": _DOCSTRING,
        "_decode_rounds": _DOCSTRING,
        "_kernel_rounds_to_list": "annotation names a class the port imports",
        "cost_solve_dense": "runs on a device the caller picks; " + _NO_SPANS,
        "compute_mix_candidate": _DOCSTRING,
        "_probe_fetch_floor_ms": "one flat int32 copy from a device the caller picks",
        "host_route_open": _PORT_ONLY + ": the host route is open on the CPU by default and "
                           "on the card only when asked for (KARPENTER_HOST_SOLVE=1 or auto)",
        "host_solve_enabled": "takes the solver's device and asks host_route_open first; no "
                              "degraded-backend host routing (the port has no fallback); the "
                              "mesh branch asks sharded_solve_active(device)",
        "cost_solve_dispatch": "K1-K4 on a torch device, the fleet resident and the rest in "
                               "one packed upload; every dispatch counts on the dispatch "
                               "metric (no count= option: boot warmup ends before ready); "
                               + "the mesh from solve_mesh(device); " + _NO_SPANS,
        "_collect_candidates": "takes fetched plans only (no host-tuple candidates)",
        "cost_solve_finish": _DOCSTRING,
        "_is_resource_exhausted": "also takes torch.cuda.OutOfMemoryError",
        "_hbm_budget_bytes": "the card's total memory from torch.cuda.mem_get_info",
        "_presplit_for_hbm": "reads the budget of the solver's device",
        "CostSolver": "runs on a device the caller picks and raises without a card; the "
                      "floor answers from the host path with no backend pin; no tracing "
                      "spans; no warmup; the host route is opt-in on the card "
                      "(host_fallback_available reads host_route_open)",
        "decode_dense_result": _DOCSTRING,
        "_eager_words": _PORT_ONLY + ": the device->host copy of every eager payload, the step "
                        "the fetch quarantine wraps",
        "_quarantine_after_fetch_failure": "quarantines the mesh ids of the handles' device type",
        "quarantine_devices": "takes the device type whose mesh ids it quarantines",
        "ShardedAssignment": _PORT_ONLY + ": the deferred LP assignment in shard blocks",
        "_sharded_fused_solve": "the counterpart of _sharded_fused_kernel: K1 and the K2 pair "
                                "(its epilogue's tail) once a device of the mesh, K9a over the "
                                "mesh, K9b on every shard; raises for a mesh of another device "
                                "type",
        "_kind": _PORT_ONLY + ": the device type of a solve",
        "_device_count": "the mesh ids of a device type, not cached (a virtual set may be "
                         "declared for a while)",
        "_multi_device": "per device type, not cached",
        "sharded_solve_active": "per device type of the solve",
        "solve_mesh": "per device type of the solve",
        "constrained_level_hook": "(dispatch, shards) from the solve's device's mesh",
        "_dispatch_sharded": "retries through _sharded_fused_solve on the shrunk mesh; no "
                             "multi-host dispatch (the sidecar's, not ported)",
    },
    "parallel/__init__.py": {},
    "parallel/mesh.py": {
        "Shard": _PORT_ONLY + ": one position of the mesh, an id and a torch.device",
        "Mesh": _PORT_ONLY + ": " + _MESH,
        "virtual_devices": _PORT_ONLY + ": declares N shards of one device, the counterpart "
                           "of --xla_force_host_platform_device_count",
        "mesh_devices": _PORT_ONLY + ": the counterpart of jax.devices()",
        "make_mesh": "shards of a device type in place of jax devices; " + _MESH,
        "block": _PORT_ONLY + ": contiguous blocks in place of solver_shardings",
    },
    "parallel/sharded_solver.py": {
        "LPTrainState": "the logits and Adam's moments as grids of shard blocks and the step "
                        "count, in place of an optax state",
        "ShardedProblem": _PORT_ONLY + ": an LP's operands in shard blocks",
        "ShardedLP": _PORT_ONLY + ": the relaxed plan in shard blocks",
        "_grid": _PORT_ONLY,
        "_check_divides": _PORT_ONLY,
        "shard_lp_problem": _PORT_ONLY + ": lays an LP over the mesh",
        "lp_train_init": "takes the mesh and the sharded problem",
        "_Scratch": _PORT_ONLY,
        "_bias_rows": _PORT_ONLY + ": Adam's bias corrections on a device",
        "_softmax": _PORT_ONLY + ": K9a's softmax phase, then its reductions",
        "_demand": _PORT_ONLY + ": K9a's demand phase, then its reduction",
        "_row_dot": _PORT_ONLY + ": K9a's row-dot phase, then its reduction",
        "_start": _PORT_ONLY,
        "Phases": _PORT_ONLY + ": K9a's three phases, kernels or plain versions",
        "_kernel_phases": _PORT_ONLY + ": the phases' wrappers, looked up at the call",
        "_run_phases": _PORT_ONLY + ": Adam steps over a mesh of devices, phase by phase "
                       "(the reference's lax.scan)",
        "_run_persistent": _PORT_ONLY + ": the whole LP in one launch on a one-card mesh",
        "_route": _PORT_ONLY + ": the route the mesh takes, persistent or per phase",
        "_run_steps": _PORT_ONLY + ": Adam steps over the mesh, by the route the mesh takes",
        "sharded_lp_blocks": _PORT_ONLY + ": the LP over a mesh, in shard blocks",
        "_replicas": _PORT_ONLY + ": one copy of the operands a device of the mesh",
        "_pad": "pads with zeros (every caller's value)",
        "sharded_lp_solve": "K9a (its persistent kernel on one device, its phases with the "
                            "collectives between across devices) in place of one jitted GSPMD scan",
        "sharded_lp_train_step": "one step of K9a, by the mesh's route, from a state in shard "
                                 "blocks; returns (step, mesh)",
        "constrained_level_sharding": "returns a dispatch running K6 on each shard's block of "
                                      "levels, in place of a sharding constraint",
        "_level_dispatch": _PORT_ONLY + ": K6 per shard, the cross-level selection, the chosen "
                           "level's fetch",
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


# Definitions copied verbatim into port modules that are not copies as a
# whole (or whose other definitions are adapted): each must stay AST-equal
# to the reference's of the same name.
VERBATIM_DEFINITIONS = [
    ("ops/pack_kernel.py", "shard_entry_budget"),
    ("ops/pack_kernel.py", "compact_words_sharded"),
    ("ops/pack_kernel.py", "decompact_plan_sharded"),
    ("parallel/mesh.py", "_factor"),
    ("parallel/mesh.py", "pad_multiple"),
    ("utils/backend_health.py", "MeshHealth"),
    ("utils/backend_health.py", "run_chip_probe"),
    ("utils/backend_health.py", "_parse_chip_ok"),
    ("utils/backend_health.py", "quarantine_mesh"),
    ("models/solver.py", "_pad_multiple"),
]


@pytest.mark.parametrize("relative,name", VERBATIM_DEFINITIONS, ids=lambda v: str(v))
def test_verbatim_definition_matches_reference(relative, name):
    port = _definitions(REPO / "karpenter_tpu_torch" / relative)
    reference = _definitions(REPO / "karpenter_tpu" / relative)
    assert name in port and name in reference
    assert port[name] == reference[name], (
        f"karpenter_tpu_torch/{relative}: {name} drifted from the reference's"
    )
