"""Mirror test: the port's copies of host-only reference modules stay
AST-equal to their references apart from import statements, so a later fix
to the reference cannot silently miss the port.

Verbatim copies are compared whole. Trimmed copies are compared definition
by definition: every top-level function, class and public constant the port
keeps must equal the reference's of the same name, except the few the port
adapted, which are listed with the reason. A class named in an adapted
entry as "Class.method" is compared method by method: the class's other
methods, and the class without its methods, must equal the reference's.

No definition goes missing without a word: every top-level definition,
method and public constant of a reference module that is not a verbatim
copy must be in the port's module (defined or imported there), or listed in
DROPPED with what replaces it or why the port has none. A reference module
the port has no file for is listed in COUNTERPARTS (its port module) or
NO_COUNTERPART. No parameter goes missing either: every parameter of a
reference function or method that the port's module also defines is in the
port's signature, or listed in PARAMS_DROPPED with what replaces it."""

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
    "controllers/podgc.py",
    "controllers/instancegc.py",
    "controllers/interruption.py",
    "controllers/health.py",
    "utils/options.py",
    "api/serialization.py",
    "kubeapi/__init__.py",
    "kubeapi/client.py",
    "kubeapi/convert.py",
    "kubeapi/chaos.py",
    "cloudprovider/registry.py",
    "cloudprovider/ec2/__init__.py",
    "cloudprovider/ec2/api.py",
    "cloudprovider/ec2/vendor.py",
    "cloudprovider/ec2/network.py",
    "cloudprovider/ec2/instancetypes.py",
    "cloudprovider/ec2/launchtemplates.py",
    "cloudprovider/ec2/instances.py",
    "cloudprovider/ec2/fake.py",
    "cloudprovider/ec2/aws_http.py",
    "solver_service/__init__.py",
    "solver_service/solver_pb2.py",
    "solver_service/wire.py",
    "utils/certs.py",
    "cmd/webhook.py",
]
_DOCSTRING = "docstring only: names the port's files and devices"
_MESH = "a mesh is a grid of shards in one process (parallel/mesh.py), not a jax Mesh"
_PORT_ONLY = "the port's own helper"
_SPANS = "records the span(s) of the cost solve's layer boundaries (utils/tracing.SPAN_NAMES)"
_HISTORY = "docstring only: without the reference's history of which change added what"
_ECHO = "keeps the cached instance on the echo of an in-flight write (ROADMAP Queue 3 item 1)"
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
    "kubeapi/cluster.py": {
        name: _ECHO
        for name in (
            "ApiServerCluster.__init__",
            "ApiServerCluster._on_watch",
            "ApiServerCluster._hold",
            "ApiServerCluster._write_through",
            "ApiServerCluster._end_write",
            "ApiServerCluster.apply_pod",
            "ApiServerCluster._reschedule_local",
            "ApiServerCluster.create_node",
            "ApiServerCluster.update_node",
            "ApiServerCluster.heartbeat_node",
            "ApiServerCluster.remove_node_annotation",
            "ApiServerCluster.remove_finalizer",
            "ApiServerCluster.apply_provisioner",
            "ApiServerCluster.update_provisioner_status",
        )
    },
    "ops/ffd.py": {},
    "ops/mix_pack.py": {
        "mix_candidate": _SPANS + ": \"host.mix.columns\", \"host.mix.cover_lp\" and "
                         "\"host.mix.integerize\" (with the emission of rounds)",
    },
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
        "SPAN_NAMES": "adds the spans inside the cost solve",
        "Tracer": "records while recording(): KARPENTER_TRACE or a torch.profiler session; "
                  "span() is a shared no-op when not recording; trace() takes a parent for "
                  "a worker thread; the export's epoch anchor is read at each export",
        "_TraceContext": "pushes the parent a worker thread's spans name",
        "_torch_profiler_recording": _PORT_ONLY + ": whether a torch.profiler session records",
        "_epoch_offset_ns": _PORT_ONLY + ": the epoch anchor, read at export",
        "_NoopSpan": _PORT_ONLY + ": the span handed out while not recording",
        "_SpanContext": "enters torch.profiler.record_function in place of "
                        "jax.profiler.TraceAnnotation; stamped with perf_counter_ns",
        "_ProfileSession": "a torch.profiler capture exported as a Chrome trace in place of "
                           "jax.profiler.start_trace, one at a time in a process (the sidecar "
                           "solves in several threads)",
    },
    "utils/options.py": {},
    "market/__init__.py": {},
    "market/pricebook.py": {"stamp_epoch": _HISTORY},
    "market/forecast.py": {
        "penalize_prices_torch": "the torch mirror of penalize_prices_jnp: K10 on the card, "
                                 "its plain version on the CPU",
    },
    "runtime.py": {
        "make_solver": "places the device solvers on a device the caller picks",
        "LeaderLock.__init__": "the lock file lies in the process's temporary directory",
        "Manager.__init__": "places the solver, encoder and consolidation solve on a device "
                            "the caller picks; keeps the error of a failed card warmup",
        "Manager._reprice_requeue": "counts its calls (reprice_requeues)",
        "Manager.start": "refuses after a failed card warmup",
        "Manager.start_standby": "docstring only: the warmup's debt is the kernels' builds "
                                 "and first launches",
        "Manager._kick_warmup": "probes the solver's device; a DEGRADED verdict stops the "
                                "Manager and raises (no CPU pin, no host routing)",
        "Manager._warmup": "warms the solver's device; on the card a failed warmup stops the "
                           "Manager (no serving from a card that cannot solve)",
    },
    "cmd/controller.py": {
        "main": "takes the device the Manager runs on; hands the elector to a caller that "
                "does not block; no JAX donation advisory to suppress; a Manager stopped by a "
                "failed card warmup ends the blocking process with its error",
    },
    "solver_service/client.py": {
        "RemoteSolver._record_stream_span": "records while TRACER.recording()",
        "RemoteSolver.solve_encoded_pipelined": "records the stream's RPC histogram, span and "
                                                "blackout before it yields the last result: the "
                                                "provisioning pass pulls exactly one result a "
                                                "schedule, so the reference's bookkeeping after "
                                                "the last yield never runs",
    },
    "solver_service/server.py": {
        "_Handler.__init__": "keeps the device the solves run on",
        "_Handler._solve": "solves on the handler's device",
        "_Handler._ingest_stream": "gates and dispatches on the handler's device; "
                                   "dispatches through dispatch_staged",
        "_Handler._ffd_rounds": "takes the device K2 runs on",
        "_Handler.health": "platform and device count from torch (\"gpu\" on the card), in "
                           "place of jax.default_backend() and jax.device_count()",
        "SolverServer": "docstring only: names the device and the failed warmup",
        "SolverServer.__init__": "takes the device the solves run on (None: the card, which "
                                 "raises without one); keeps a failed warmup's error",
        "SolverServer._warmup": "warms that device; a warmup that raises stops the server "
                                "(no serving from a device that could not warm)",
        "main": "takes the device; a DEGRADED card at boot raises (no CPU pin); the process "
                "group through the port's init_distributed, followers leave it after their "
                "loop and the lead after lead_stop; a failed warmup ends the process with its "
                "error; no JAX donation advisory to suppress",
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
        "Solver.solve": _SPANS + ": the root span \"solve\", in a trace of its own for a "
                        "bare solve; encodes through _encode",
        "Solver._encode_problems": "encodes through _encode (the encode spans)",
        "_encode": _PORT_ONLY + ": group_pods and build_fleet, each under its span",
        "dispatch_staged": _PORT_ONLY + ": cost_solve_dispatch and plan_start_fetch under the "
                           "\"dispatch\" span",
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
                       "decodes with decompact_plan_sharded at every shard count; "
                       "under the \"fetch\" span",
        "fetch_plan": "annotation names a class defined above it",
        "device_pod_args": _DOCSTRING,
        "_HostOverlap": _SPANS + ": the worker joins its creator's trace and parent span, "
                        "\"host.pool_matrix\" and \"host.mix\" (its CPU seconds); join and "
                        "wait are \"host.wait\"",
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
        "cost_solve_dense": "runs on a device the caller picks; dispatches through "
                            "dispatch_staged",
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
                               + "the mesh from solve_mesh(device)",
        "_collect_candidates": "takes fetched plans only (no host-tuple candidates)",
        "cost_solve_finish": _SPANS + ": \"host.finish\" (the winner's label) and "
                             "\"host.finish.lp_realize\"",
        "_is_resource_exhausted": "also takes torch.cuda.OutOfMemoryError",
        "_hbm_budget_bytes": "the card's total memory from torch.cuda.mem_get_info",
        "_presplit_for_hbm": "reads the budget of the solver's device",
        "CostSolver": "runs on a device the caller picks and raises without a card; the "
                      "floor answers from the host path with no backend pin; no warmup; "
                      "the host route is opt-in on the card "
                      "(host_fallback_available reads host_route_open); dispatches through "
                      "dispatch_staged, joins the overlap inside \"solve.device.batch\" and "
                      "decodes under \"decode\"",
        "decode_dense_result": _DOCSTRING,
        "_eager_words": _PORT_ONLY + ": the device->host copy of every eager payload, the step "
                        "the fetch quarantine wraps; counts its bytes (LAST_FETCH_BYTES)",
        "LAST_FETCH_BYTES": _PORT_ONLY + ": the eager payload's bytes of the last fetch, by "
                            "fetch_bytes",
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
        "_dispatch_sharded": "retries through _sharded_fused_solve on the shrunk mesh; across "
                             "processes spmd.lead_dispatch of a call of it",
    },
    "parallel/__init__.py": {},
    "parallel/mesh.py": {
        "Shard": _PORT_ONLY + ": one position of the mesh, an id and a torch.device",
        "Mesh": _PORT_ONLY + ": " + _MESH,
        "virtual_devices": _PORT_ONLY + ": declares N shards of one device, the counterpart "
                           "of --xla_force_host_platform_device_count",
        "_local_devices": _PORT_ONLY + ": this process's shards' devices",
        "mesh_devices": _PORT_ONLY + ": the counterpart of jax.devices(), global across a "
                        "process group",
        "local_mesh": _PORT_ONLY + ": the mesh of this process's shards, for the dispatches "
                      "that stay in one process",
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
    ("utils/tracing.py", "trace_id_to_words"),
    ("utils/tracing.py", "words_to_trace_id"),
    ("parallel/multihost.py", "DistributedConfig"),
    ("parallel/spmd.py", "OP_STOP"),
    ("parallel/spmd.py", "OP_SOLVE"),
    ("parallel/spmd.py", "HEADER_WORDS"),
]


@pytest.mark.parametrize("relative,name", VERBATIM_DEFINITIONS, ids=lambda v: str(v))
def test_verbatim_definition_matches_reference(relative, name):
    port = _definitions(REPO / "karpenter_tpu_torch" / relative)
    reference = _definitions(REPO / "karpenter_tpu" / relative)
    assert name in port and name in reference
    assert port[name] == reference[name], (
        f"karpenter_tpu_torch/{relative}: {name} drifted from the reference's"
    )


_K8 = "K8 (csrc/incremental.cu): scatter, gather, scatter_flush and gather_view"
_NO_CPU_PIN = "pins JAX to its CPU backend; the port has no CPU fallback to pin"
# Reference definitions the port's module does not have: {module: {name: why}}.
# Each is JAX machinery; the reason names what replaces it or why the port
# has none.
DROPPED = {
    "ops/consolidate.py": {
        "_counterfactual_body": "K7: ops/consolidate_kernel.solve_counterfactuals "
                                "(csrc/consolidate.cu), its plain version _counterfactual_ref",
    },
    "ops/incremental.py": {
        "_scatter_rows": _K8,
        "_scatter_vals": _K8,
        "_gather_rows": _K8,
        "scatter_rows": "K8's scatter",
        "scatter_vals": "K8's scatter",
        "gather_rows": "K8's gather",
        "device_slots": "the jit cache's slot count; K8 takes any slot count",
    },
    "ops/pack_kernel.py": {
        "_LoopState": "the lax.while_loop carry of the JAX pack kernel; K2 (csrc/pack_rounds.cu) "
                      "keeps it in registers, its plain version _pack_kernel_ref in locals",
        "_pack_one_level": "one level of the JAX constrained pack; K6 (csrc/pack_levels.cu) "
                           "packs every level in one launch, its plain version _pack_levels_ref",
        "_compact_rounds_sharded": "K9b: compact_shards and compact_sharded_payload "
                                   "(csrc/compact_shard.cu)",
        "suppress_donation_advisory": "silences JAX's buffer-donation warning; torch donates "
                                      "no buffers",
    },
    "ops/pallas_kernels.py": {
        "_dominance_kernel": "K1's Pallas body; K1 is csrc/dominance.cu",
        "_dominance_prices_pallas": "K1's pallas_call; the port's dominance_prices launches "
                                    "csrc/dominance.cu",
        "_in_active_trace": "asks whether JAX is tracing; the port does not trace",
        "ensure_probed": "probes whether Pallas lowers on the backend; the port's K1 is "
                         "built with the other kernels (ops/cuda_build)",
    },
    "models/solver.py": {
        "_sharded_fused_kernel": "_sharded_fused_solve",
        "_start_fetch": "plan_start_fetch",
        "FusedHandle.eager": "_eager_payload(handle); fetch_bytes counts its tensors",
    },
    "parallel/mesh.py": {
        "solver_shardings": "a mesh is a grid of shards in one process; block lays the "
                            "operands out in shard blocks",
    },
    "parallel/sharded_solver.py": {
        "_state_shardings": "LPTrainState holds its shard blocks; there is no sharding to annotate",
        "lp_train_step": "sharded_lp_train_step",
    },
    "parallel/spmd.py": {
        "COLLECTIVES_UNSUPPORTED_MSG": "XLA:CPU's refusal of multi-process programs; the port "
                                       "recognises torch.distributed's refusals "
                                       "(COLLECTIVES_UNSUPPORTED_SIGNATURES)",
    },
    "utils/backend_health.py": {
        "pin_cpu": _NO_CPU_PIN,
        "force_cpu_backend": _NO_CPU_PIN,
        "BackendHealth.pin_cpu": _NO_CPU_PIN,
        "device_alive": "utils/jaxenv's one-shot JAX probe; the port probes the card with "
                        "run_chip_probe and BackendHealth.probe",
    },
    "market/forecast.py": {
        "penalize_prices_jnp": "penalize_prices_torch: K10 (csrc/forecast.cu) on the card, "
                               "its plain version on the CPU",
    },
}
_SHARDING_HOOK = "the jax sharding hook of the mesh path; the port's sharded solve is its own function"
_PYTREE = "fetches any jax pytree; the port's fetches take its own tensors"
# Reference parameters the port's function of the same name does not take:
# {module: {"function" or "Class.method": {parameter: what replaces it}}}.
PARAMS_DROPPED = {
    "models/solver.py": {
        "_cost_fused_body": {
            "constrain": _SHARDING_HOOK + " (_sharded_fused_solve)",
            "compact": "the shard-local compaction hook of the jax mesh path; _sharded_fused_solve "
                       "compacts with K9b (compact_sharded_payload)",
        },
        "_to_host": {"tree": _PYTREE + ": a PackRounds in one copy"},
    },
    "ops/consolidate.py": {"_fetch": {"tree": _PYTREE + ": one tensor"}},
    "ops/pack_kernel.py": {
        "_fill_one_node_constrained": {
            "allow": "usable: the [L, G, T] mask of every level at once, allow and the remaining fit "
                     "combined (the plain version of K6 fills every level in one pass)",
        },
        "pack_kernel_levels": {
            "constrain": _SHARDING_HOOK + " (parallel/sharded_solver.constrained_level_sharding's "
                         "dispatch)",
        },
        "fetch_bytes": {"tree": "tensors: the sequence of tensors one fetch copies"},
        "device_resident": {
            "array": "arrays, resident, device: a batch of arrays in one packed upload, the flags of "
                     "those kept in the content-keyed cache, and the device",
        },
    },
    "ops/score_kernel.py": {"lp_relax_body": {"constrain": _SHARDING_HOOK + " (sharded_lp_solve)"}},
    "parallel/mesh.py": {
        "make_mesh": {"devices": "shards: an explicit list of Shard (id, device, rank), and kind"},
    },
    "parallel/sharded_solver.py": {
        "lp_train_init": {
            "logits0": "mesh, problem: the start is computed from the sharded problem in shard blocks",
        },
        "_pad": {"value": "the pad value is always 0 on the port's host operands"},
    },
}

# Reference modules whose port module has another name.
COUNTERPARTS = {"ops/pallas_kernels.py": "ops/cuda_kernels.py"}
# Reference modules the port has no module for.
NO_COUNTERPART = {
    "utils/jaxenv.py": "sets up JAX's platforms and re-exports the CPU pin; the port has no JAX",
}


def _defined(path: Path):
    """Every top-level definition, method ("Class.method") and public
    constant of a module."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, ast.ClassDef):
            names.add(node.name)
            names.update(
                f"{node.name}.{item.name}"
                for item in node.body
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
            )
        elif isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
            if isinstance(target, ast.Name) and target.id.isupper() and target.id[0] != "_":
                names.add(target.id)
    return names


def _imported(path: Path):
    """Every name a module's top-level imports bind."""
    return {
        (alias.asname or alias.name).split(".")[0]
        for node in ast.parse(path.read_text()).body
        if isinstance(node, (ast.Import, ast.ImportFrom))
        for alias in node.names
    }


def _non_verbatim_modules():
    reference = REPO / "karpenter_tpu"
    return sorted(
        str(path.relative_to(reference))
        for path in reference.rglob("*.py")
        if str(path.relative_to(reference)) not in VERBATIM
    )


def test_every_reference_module_has_a_port_module():
    missing = [
        relative
        for relative in _non_verbatim_modules()
        if relative not in NO_COUNTERPART
        and not (REPO / "karpenter_tpu_torch" / COUNTERPARTS.get(relative, relative)).exists()
    ]
    assert missing == [], f"reference modules with no port module and no reason: {missing}"


@pytest.mark.parametrize(
    "relative", [m for m in _non_verbatim_modules() if m not in NO_COUNTERPART]
)
def test_no_reference_definition_dropped_silently(relative):
    port_path = REPO / "karpenter_tpu_torch" / COUNTERPARTS.get(relative, relative)
    port = _defined(port_path) | _imported(port_path)
    reference = _defined(REPO / "karpenter_tpu" / relative)
    dropped = DROPPED.get(relative, {})
    assert all(reason for reason in dropped.values())
    assert sorted(set(dropped) & port) == [], f"{relative}: stale DROPPED entries"
    silent = sorted(reference - port - set(dropped))
    assert silent == [], (
        f"karpenter_tpu_torch/{relative} lacks {silent}: port them, or list them in DROPPED "
        "with what replaces them"
    )



def _parameters(path: Path):
    """{"function" or "Class.method": its parameter names} of a module."""
    def names(args):
        listed = [arg.arg for arg in args.posonlyargs + args.args + args.kwonlyargs]
        return listed + [arg.arg for arg in (args.vararg, args.kwarg) if arg is not None]

    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = names(node.args)
        elif isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{item.name}"] = names(item.args)
    return out


@pytest.mark.parametrize(
    "relative", [m for m in _non_verbatim_modules() if m not in NO_COUNTERPART]
)
def test_no_reference_parameter_dropped_silently(relative):
    """Every parameter of a reference function the port's module also
    defines is in the port's signature (the port may add its own, such as
    `device`), or listed in PARAMS_DROPPED with what replaces it."""
    port = _parameters(REPO / "karpenter_tpu_torch" / COUNTERPARTS.get(relative, relative))
    reference = _parameters(REPO / "karpenter_tpu" / relative)
    dropped = PARAMS_DROPPED.get(relative, {})
    silent, stale = [], []
    for name, parameters in reference.items():
        if name not in port:
            continue
        listed = dropped.get(name, {})
        assert all(listed.values())
        silent += [f"{name}({p})" for p in parameters if p not in port[name] and p not in listed]
        stale += [f"{name}({p})" for p in listed if p in port[name] or p not in parameters]
    stale += [name for name in dropped if name not in reference or name not in port]
    assert stale == [], f"{relative}: stale PARAMS_DROPPED entries {stale}"
    assert silent == [], (
        f"karpenter_tpu_torch/{relative} drops the reference's parameters {silent}: take them, "
        "or list them in PARAMS_DROPPED with what replaces them"
    )
