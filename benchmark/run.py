#!/usr/bin/env python3
"""The benchmark of karpenter_tpu_torch's cost solve on one NVIDIA H100.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1 [--out DIR]

Run from the root of a checkout. The cell NAME is an entry of BENCHMARK.json's
`workloads`; its configuration file, its traffic file
(benchmark/traffic/<traffic>.json), its limits (benchmark/limits/<NAME>.json)
and each per-layer metric's reader (benchmark/metrics/<metric>.py) are found
by name, so a new cell or metric is new files and no edit.

A run builds the kernels it needs into the port's fixed build directory (the
first run in a checkout compiles, later runs load), makes the catalog and a
cycle of schedules from the configuration, the traffic and --seed, solves
one schedule to warm up, and then drives
`CostSolver(device="cuda").solve(pods, instance_types, Constraints())` back to
back, one schedule at a time, for --seconds. Then it judges a sample of the
window's plans, drawn from the seed, against the plain reference
(benchmark/reference.py), and prints one JSON line: `correct`, `attempted`
and `failed` schedules, the metrics (the cell's end-to-end metrics with
--trace 0, its per-layer metrics with --trace 1), the device, and under
`checks`, last, each number compared beside its limit. With --trace 1 the
layer entry points are wrapped in spans (benchmark/tracing.py), the window
runs under torch.profiler, and the spans are written to DIR.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from benchmark import generate, reference, tracing  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "karpenter_tpu")
# Build and kernel caches live at fixed paths inside the checkout.
CACHE_DIR = ROOT / "bench_cache"
EXIT_NO_CARD = 3
EXIT_FORBIDDEN = 4


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its files, found by name."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    matches = [w for w in spec["workloads"] if w["name"] == name]
    if not matches:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    workload = matches[0]
    config_file = next(c["file"] for c in spec["configs"] if c["name"] == workload["config"])
    bench = root / "benchmark"

    def applies(metric: dict) -> bool:
        return name in metric.get("workloads", [name])

    return Cell(
        name=name,
        chips=int(workload["chips"]),
        config=json.loads((root / config_file).read_text()),
        traffic=json.loads((bench / "traffic" / f"{workload['traffic']}.json").read_text()),
        limits=json.loads((bench / "limits" / f"{name}.json").read_text()),
        end_to_end=[m for m in spec["end_to_end"] if applies(m)],
        per_layer=[m for m in spec["per_layer"] if applies(m)],
        root=root,
    )


def metric_reader(root: Path, name: str) -> Callable:
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot, whole) is
    JAX's, its libraries' or the JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def plain_plan(result, with_nodes: bool = True) -> dict:
    """The program's PackResult as plain data for the reference (a plan
    that is plain data already passes through)."""
    if isinstance(result, dict):
        return result
    return {
        "packings": [
            {
                "quantity": int(p.node_quantity),
                "types": [t.name for t in p.instance_type_options],
                "pools": [(o.instance_type.name, o.zone, float(o.price)) for o in p.pool_options]
                if p.pool_options else None,
                "nodes": [[pod.name for pod in node] for node in p.pods_per_node] if with_nodes else [],
            }
            for p in result.packings
        ],
        "unschedulable": [pod.name for pod in result.unschedulable],
        "projected_cost": float(result.projected_cost()),
    }


def unschedulable_count(result) -> int:
    return len(result["unschedulable"] if isinstance(result, dict) else result.unschedulable)


def pods_per_second(meta: List[dict]) -> float:
    """Pods placed by every schedule that completed inside the window, over
    the seconds from the window's start to the last of those completions: a
    schedule still running when the window closed counts for nothing."""
    inside = [m for m in meta if m["in_window"]]
    return sum(m["pods"] for m in inside) / max(m["end"] for m in inside)


class Reservoir:
    """A uniform sample of `size` schedule indices drawn from `rng` as the
    schedules complete (Algorithm R), so the run keeps only the results it
    will judge."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size, self.rng, self.seen = size, rng, 0
        self.slots: List[int] = []

    @property
    def chosen(self) -> set:
        return set(self.slots)

    def offer(self, index: int) -> None:
        self.seen += 1
        if len(self.slots) < self.size:
            self.slots.append(index)
            return
        slot = int(self.rng.integers(0, self.seen))
        if slot < self.size:
            self.slots[slot] = index


def capture_lp_objectives(seen: Dict[int, List[float]], schedule: Callable[[], int]) -> Callable[[], None]:
    """Record the LP relaxation's objective of each fused solve where the
    timed path fetches it (models/solver.fetch_plans, which every fused solve
    of the program goes through), under the schedule being solved. Returns
    the function that takes the wrapper out again."""
    from karpenter_tpu_torch.models import solver

    original = solver.fetch_plans

    def fetch_plans(handles):
        plans = original(handles)
        seen.setdefault(schedule(), []).extend(float(plan.lp_objective) for plan in plans)
        return plans

    solver.fetch_plans = fetch_plans

    def undo() -> None:
        solver.fetch_plans = original

    return undo


def require_card(chips: int) -> None:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"this cell needs {chips} CUDA card(s); found {found}", file=sys.stderr)
        raise SystemExit(EXIT_NO_CARD)


def build_kernels() -> None:
    """Build (first run in a checkout) or find the libraries the cost solve
    launches, and the host library its scoring uses."""
    from karpenter_tpu_torch.ops import cuda_build, cuda_kernels, native, pack_kernel, score_kernel

    start = time.perf_counter()
    cuda_build.build_all([cuda_kernels.LIBRARY, pack_kernel.LIBRARY, score_kernel.LIBRARY])
    if not native.available():
        print("the port's native host library did not build (g++): scoring runs without it", file=sys.stderr)
    print(f"kernels built or found in {time.perf_counter() - start:.1f} s", file=sys.stderr)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             out_dir: Optional[Path] = None, make_solver: Optional[Callable] = None) -> dict:
    """One run of `cell`; returns the result line as a dict. `make_solver`
    replaces the program's solver (the control and the fault tests use it)."""
    import torch

    from karpenter_tpu_torch.api.provisioner import Constraints
    from karpenter_tpu_torch.models.solver import CostSolver
    from karpenter_tpu_torch.utils.gctune import tune_gc

    # The collector's thresholds as the controller and the sidecar set them at boot.
    gc_thresholds = gc.get_threshold()
    tune_gc()
    on_card = torch.device(device).type == "cuda"
    if on_card:
        build_kernels()
    types = generate.catalog(cell.config)
    shapes, _ = generate.population(cell.config)
    cycle = generate.schedules(cell.config, cell.traffic, seed)
    catalog = generate.port_catalog(types)
    pod_lists = generate.port_schedules(shapes, cycle)
    solver = make_solver() if make_solver is not None else CostSolver(device=device)
    constraints = Constraints()

    spans = tracing.Spans() if trace else None
    if spans is not None:
        spans.install()
    lp_seen: Dict[int, List[float]] = {}
    lp_capture = capture_lp_objectives(lp_seen, lambda: current)
    cost_count, check_count = cell.traffic["cost_schedules"], cell.traffic["check_schedules"]
    sample = Reservoir(check_count, generate.check_rng(seed))
    kept: Dict[int, object] = {}  # the results the cost metric and the check read
    failures = 0
    current = -1
    try:
        solver.solve(pod_lists[0], catalog, constraints)  # the warm schedule, at the cell's own shape
        if on_card:
            torch.cuda.synchronize()
        profiler = None
        if trace:
            from torch.profiler import ProfilerActivity, profile, record_function

            activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
            profiler = profile(activities=activities)
            profiler.start()

        meta = []
        window_start = time.perf_counter()
        cpu_start = time.process_time()
        setup_s = window_start - PROCESS_START
        while not meta or time.perf_counter() - window_start < seconds:
            current = index = len(meta)
            pods = pod_lists[index % len(pod_lists)]
            if spans is not None:
                spans.schedule = index
            scope = record_function("bench.schedule") if trace else contextlib.nullcontext()
            start = time.perf_counter()
            try:
                with scope:
                    result = solver.solve(pods, catalog, constraints)
            except Exception:  # noqa: BLE001 — a failed schedule is counted, and the run goes on
                traceback.print_exc()
                failures += 1
                result = None
            end = time.perf_counter()
            placed = len(pods) - unschedulable_count(result) if result is not None else 0
            meta.append({"index": index, "start": start - window_start, "end": end - window_start,
                         "cpu_end": time.process_time() - cpu_start, "pods": placed,
                         "in_window": end - window_start <= seconds})
            sample.offer(index)
            if index < cost_count or index in sample.chosen:
                kept[index] = result
            for stale in [i for i in kept if i >= cost_count and i not in sample.chosen]:
                del kept[stale]
        if profiler is not None:
            profiler.stop()
        attempted = len(meta)
        # The cost metric reads the window's first schedules; a window that
        # completed fewer solves the rest now, untimed.
        for index in range(attempted, cost_count):
            current = index
            if spans is not None:
                spans.schedule = index
            try:
                kept[index] = solver.solve(pod_lists[index % len(pod_lists)], catalog, constraints)
            except Exception:  # noqa: BLE001
                traceback.print_exc()
                failures += 1
                kept[index] = None
    finally:
        lp_capture()
        if spans is not None:
            spans.uninstall()
        gc.set_threshold(*gc_thresholds)

    memory_peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    del solver
    if on_card:
        torch.cuda.empty_cache()

    inside = [m for m in meta if m["in_window"]]
    if not inside:
        raise SystemExit(f"no schedule completed inside the {seconds} s window (the first took "
                         f"{meta[0]['end']:.1f} s): give the run more --seconds")
    values = {"setup_s": setup_s, "pods_per_s": pods_per_second(meta)}
    cost_results = [(i, kept[i]) for i in range(cost_count) if kept[i] is not None]
    cost = sum(reference.plan_cost(plain_plan(r, with_nodes=False), types) for _, r in cost_results)
    cost_pods = sum(int(cycle[i % len(cycle)].sum()) for i, _ in cost_results)
    values["usd_per_hr_per_kpod"] = 1000.0 * cost / cost_pods if cost_pods else sys.float_info.max

    # The check: a sample of the window's schedules drawn from the seed.
    readings, judged_bad = [], 0
    for i in sorted(sample.chosen):
        counts = cycle[i % len(cycle)]
        if kept[i] is None:
            reading = {k: np.inf for k in reference.CHECKS}
            reading["misplaced_pods"] = int(counts.sum())
        else:
            plan = dict(plain_plan(kept[i]))
            if i in lp_seen:
                plan["lp_objective"] = sum(lp_seen[i])
            reading = reference.judge(plan, counts, shapes, types, generate.pod_name)
        judged_bad += any(reading[k] > cell.limits[k] for k in reference.CHECKS)
        readings.append(reading)
    worst = reference.worst(readings)
    correct = failures == 0 and all(worst[k] <= cell.limits[k] for k in reference.CHECKS)

    line = {"correct": bool(correct), "attempted": attempted, "failed": failures + judged_bad}
    line["device"] = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": cell.chips if on_card else 0,
        "memory_peak_bytes": memory_peak,
    }
    if trace:
        profile_parts = tracing.read_profile(profiler, len(inside))
        host_spans = [{**s, "start": s["start"] - window_start, "end": s["end"] - window_start}
                      for s in spans.records]
        trace_view = tracing.Trace(
            workload=cell.name,
            schedules=meta,
            spans=host_spans,
            device=profile_parts["device"],
            host=tracing.host_on_profile_clock(host_spans, profile_parts["schedule_starts"], meta),
            window_s=profile_parts["window_s"],
            busy_s=tracing.union_seconds((r["start"], r["end"]) for r in profile_parts["device"]),
        )
        line["metrics"] = {}
        for metric in cell.per_layer:
            value = metric_reader(cell.root, metric["name"])(trace_view)
            if value is not None:
                line["metrics"][metric["name"]] = {"value": float(value), "unit": metric["unit"]}
        line["device"]["busy_s"] = trace_view.busy_s
        line["device"]["window_s"] = trace_view.window_s
        line["breakdown"] = tracing.breakdown(trace_view)
        if out_dir is not None:
            out_dir.mkdir(parents=True, exist_ok=True)
            with open(out_dir / f"{cell.name}-{seed}-spans.jsonl", "w") as spans_file:
                for record in spans.records:
                    spans_file.write(json.dumps({**record, "thread": int(record["thread"])}) + "\n")
    else:
        line["metrics"] = {
            m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]} for m in cell.end_to_end
        }
    if not trace:
        line["cpu_ms_per_schedule"] = 1e3 * inside[-1]["cpu_end"] / len(inside)
    # JSON has no infinity: a number that could not be read prints as the largest float.
    line["checks"] = {
        k: {"value": min(float(worst[k]), sys.float_info.max), "limit": float(cell.limits[k])}
        for k in reference.CHECKS
    }
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--out", default=str(ROOT / "bench_out"), help="where a traced run writes its spans")
    args = parser.parse_args(argv)

    # The port builds into its own fixed karpenter_tpu_torch/build/; these
    # keep any torch extension or Triton cache inside the checkout too.
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE_DIR / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE_DIR / "triton")
    cell = load_cell(args.workload)
    require_card(cell.chips)
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace), out_dir=Path(args.out))
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {', '.join(found)}", file=sys.stderr)
        return EXIT_FORBIDDEN
    for name, check in line["checks"].items():
        print(f"check {name}: {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
