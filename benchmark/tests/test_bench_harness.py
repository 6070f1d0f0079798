"""CPU tests of the benchmark harness: generators, reference, rates,
rooflines, the data-driven discovery of cells, the no-JAX guard, the control
and the planted faults. The card test at the end skips without a card.

    python -m pytest -q benchmark/tests
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import control, generate, reference, roofline, run, tracing  # noqa: E402

CONFIGS = ROOT / "benchmark" / "configs"


def config(name: str) -> dict:
    return json.loads((CONFIGS / f"{name}.json").read_text())


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tiny runs' tensors are small: with the default thread pool, test
    workers run side by side oversubscribe the cores and a schedule can
    outlast its window."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TINY_TRAFFIC = {"pods_per_schedule": 300, "cycle": 2, "cost_schedules": 2, "check_schedules": 2}
TINY_LIMITS = {"misplaced_pods": 0, "bad_nodes": 0, "price_gap": 1e-9, "cost_excess": 0.5, "lp_excess": 0.3,
               "lp_under_bound": 1e-4}


def tiny_config() -> dict:
    tiny = config("shapes1100-t400")
    tiny["name"] = "tiny"
    tiny["catalog"]["types"] = 40
    tiny["pods"]["shapes"] = 30
    return tiny


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    """A copy of the benchmark with one more cell, made of new files and a
    new BENCHMARK.json entry only."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = tmp_path / "benchmark"
    (bench / "configs" / "tiny.json").write_text(json.dumps(tiny_config()))
    (bench / "traffic" / "small.json").write_text(json.dumps(TINY_TRAFFIC))
    (bench / "limits" / "tiny.small.json").write_text(json.dumps(TINY_LIMITS))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny", "source": "https://example.org", "file": "benchmark/configs/tiny.json",
                            "reduced": [], "why": "a test cell"})
    spec["workloads"].append({"name": "tiny.small", "config": "tiny", "traffic": "small", "chips": 1,
                              "why": "a test cell"})
    for metric in spec["per_layer"]:
        if metric["name"] != "schedule_p95_ms":
            metric["workloads"].append("tiny.small")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path


# --- the generators --------------------------------------------------------


@pytest.mark.parametrize("name", ["zipf16-t400", "shapes1100-t400"])
def test_generators_are_deterministic_per_seed(name):
    spec = config(name)
    traffic = {"pods_per_schedule": 1000, "cycle": 3}
    first = generate.schedules(spec, traffic, 2**31 + 17)
    assert np.array_equal(first, generate.schedules(spec, traffic, 2**31 + 17))
    assert not np.array_equal(first, generate.schedules(spec, traffic, 2**31 + 18))
    assert (first.sum(axis=1) == 1000).all()
    assert generate.catalog(spec) == generate.catalog(spec)
    assert generate.population(spec)[0] == generate.population(spec)[0]


def raw_rows(spec: dict):
    """The catalog's types as the raw EC2 records the port's EC2 provider
    adapts (machine memory, ENI limits, on-demand price)."""
    from karpenter_tpu_torch.cloudprovider.ec2.api import InstanceTypeInfo

    cat = spec["catalog"]
    rows = []
    for index, plain in enumerate(generate.catalog(spec)):
        family = cat["families"][index % len(cat["families"])]
        size = cat["sizes"][(index // len(cat["families"])) % len(cat["sizes"])]
        rows.append(InstanceTypeInfo(
            name=plain["name"], vcpus=size[1], memory_mib=size[1] * family[1],
            max_network_interfaces=size[2], ipv4_addresses_per_interface=size[3],
            price_on_demand=plain["offerings"][0][2]))
    return rows


def test_catalog_follows_instancetype_go_as_the_port_adapts_it():
    """Capacity, pods and overhead as the port's EC2 provider (its port of
    aws/karpenter v0.5's instancetype.go) makes them from the same rows."""
    from karpenter_tpu_torch.cloudprovider.ec2.instancetypes import adapt_instance_type

    spec = config("zipf16-t400")
    ours = generate.port_catalog(generate.catalog(spec))
    assert len(ours) == 400 and len({t.name for t in ours}) == 400
    for mine, row in zip(ours, raw_rows(spec)):
        theirs = adapt_instance_type(row, [])
        assert mine.name == theirs.name
        assert mine.capacity == theirs.capacity
        assert mine.overhead == theirs.overhead
    assert generate.catalog(config("shapes1100-t400")) == generate.catalog(spec)


def test_catalog_rows_equal_ec2s_where_the_repository_lists_them():
    """The first variant's rows carry the vCPUs, memory, ENI limits and
    on-demand price of the EC2 rows the port's fake EC2 lists."""
    from karpenter_tpu_torch.cloudprovider.ec2.fake import default_instance_type_infos

    ours = {row.name: row for row in raw_rows(config("zipf16-t400"))}
    listed = [info for info in default_instance_type_infos() if info.name in ours]
    assert {info.name for info in listed} >= {"m5.large", "m5.xlarge", "m5.2xlarge", "m5.4xlarge", "c5.large",
                                              "r5.large"}
    for info in listed:
        row = ours[info.name]
        assert (row.vcpus, row.memory_mib, row.max_network_interfaces, row.ipv4_addresses_per_interface) == (
            info.vcpus, info.memory_mib, info.max_network_interfaces, info.ipv4_addresses_per_interface)
        assert row.price_on_demand == pytest.approx(info.price_on_demand, rel=1e-12)
    assert generate.max_pods(3, 10) == 29 and generate.max_pods(15, 50) == 737


def test_populations_equal_chip_smokes():
    import chip_smoke

    shapes, weights = generate.population(config("zipf16-t400"))
    assert shapes == chip_smoke.pod_shapes(0)
    assert np.allclose(weights, chip_smoke.zipf_weights(16))
    shapes, weights = generate.population(config("shapes1100-t400"))
    theirs = {(int(p.requests["cpu"] * 1000 + 0.5), int(p.requests["memory"]) >> 20)
              for p in chip_smoke.many_shapes_pods(2_200, 1_100)}
    assert set(shapes) == theirs and len(shapes) == 1_100
    assert np.allclose(weights, 1 / 1_100)


def test_port_schedules_hold_the_plain_counts():
    spec = tiny_config()
    shapes, _ = generate.population(spec)
    cycle = generate.schedules(spec, TINY_TRAFFIC, 5)
    for counts, pods in zip(cycle, generate.port_schedules(shapes, cycle)):
        names = [generate.pod_name(s, shapes[s], i) for s in np.nonzero(counts)[0] for i in range(counts[s])]
        assert [p.name for p in pods] == names
        assert len({id(p) for p in pods}) == counts.sum()


# --- the reference ---------------------------------------------------------


def sound_plan():
    spec = tiny_config()
    types = generate.catalog(spec)
    shapes, _ = generate.population(spec)
    counts = generate.schedules(spec, TINY_TRAFFIC, 3)[0]
    plan = control.ffd_plan(types, shapes, counts, honour_overhead=True)
    return plan, counts, shapes, types


def judged(plan, counts, shapes, types):
    return reference.judge(plan, counts, shapes, types, generate.pod_name)


def test_reference_accepts_a_sound_plan():
    reading = judged(*sound_plan())
    assert reading["misplaced_pods"] == 0 and reading["bad_nodes"] == 0 and reading["price_gap"] == 0
    assert reading["cost_excess"] > 0


def test_reference_refuses_a_pod_placed_twice():
    plan, *rest = sound_plan()
    plan["packings"][0]["nodes"][0].append(plan["packings"][-1]["nodes"][-1][0])
    assert judged(plan, *rest)["misplaced_pods"] >= 1


def test_reference_refuses_a_missing_pod():
    plan, *rest = sound_plan()
    plan["packings"][-1]["nodes"][-1].pop()
    assert judged(plan, *rest)["misplaced_pods"] == 1


def test_reference_refuses_a_node_over_its_allocatable():
    plan, counts, shapes, types = sound_plan()
    smallest = min(types, key=lambda t: t["vcpus"] * 1000 - t["overhead_cpu_m"])["name"]
    plan["packings"][0]["types"] = [smallest]
    plan["packings"][0]["pools"] = None
    assert judged(plan, counts, shapes, types)["bad_nodes"] >= 1


def test_reference_refuses_a_wrong_price():
    plan, *rest = sound_plan()
    plan["projected_cost"] *= 1.001
    assert judged(plan, *rest)["price_gap"] > 1e-9


@pytest.mark.parametrize("objective, number", [(0.97, "lp_under_bound"), (1.5, "lp_excess"), (None, "lp_excess")])
def test_reference_refuses_an_lp_objective_off_the_bound(objective, number):
    plan, counts, shapes, types = sound_plan()
    bound = reference.fluid_bound(types, demand_of(counts, shapes))
    plan["lp_objective"] = bound * 1.01
    sound = judged(plan, counts, shapes, types)
    assert sound["lp_under_bound"] == 0 and sound["lp_excess"] == pytest.approx(0.01)
    plan["lp_objective"] = None if objective is None else bound * objective
    assert judged(plan, counts, shapes, types)[number] > 0.02


def demand_of(counts, shapes):
    return np.array([sum(int(counts[s]) * shapes[s][k] for s in range(len(shapes))) for k in (0, 1)]
                    + [int(counts.sum())])


def test_fluid_bound_is_a_lower_bound():
    plan, counts, shapes, types = sound_plan()
    demand = np.array([sum(int(counts[s]) * shapes[s][k] for s in range(len(shapes))) for k in (0, 1)]
                      + [int(counts.sum())])
    bound = reference.fluid_bound(types, demand)
    assert 0 < bound < reference.plan_cost(plan, types)
    # The one-axis bound: every type's price per cpu on the cpu demand alone.
    caps = np.stack(list(reference.allocatable(types).values()))
    prices = np.array([min(p for _, _, p in t["offerings"]) for t in types])
    assert bound >= demand[0] * np.min(prices / caps[:, 0]) * (1 - 1e-9)


# --- the rate and the rooflines ---------------------------------------------


def test_pods_per_second_counts_whole_schedules_only():
    meta = [
        {"start": 0.0, "end": 4.0, "pods": 100, "in_window": True},
        {"start": 4.0, "end": 8.0, "pods": 100, "in_window": True},
        {"start": 8.0, "end": 12.5, "pods": 100, "in_window": False},
    ]
    assert run.pods_per_second(meta) == 200 / 8.0


def test_reservoir_keeps_a_seeded_sample_of_the_schedules():
    def drawn(seed, offered):
        sample = run.Reservoir(4, generate.check_rng(seed))
        for index in range(offered):
            sample.offer(index)
        return sorted(sample.chosen)

    assert drawn(2**40 + 1, 3) == [0, 1, 2]
    assert drawn(2**40 + 1, 300) == drawn(2**40 + 1, 300)
    assert drawn(2**40 + 1, 300) != drawn(2**40 + 2, 300)
    assert len(drawn(7, 300)) == 4 and max(drawn(7, 300)) < 300
    # Every index is about equally likely to be judged.
    hits = np.zeros(20)
    for seed in range(2_000):
        hits[drawn(seed, 20)] += 1
    assert hits.min() > 0.8 * 400 and hits.max() < 1.2 * 400


def test_cpu_time_per_schedule_reads_the_window_only():
    read = run.metric_reader(ROOT, "cpu_ms_per_schedule")
    schedules = [{"index": i, "start": i, "end": i + 1.0, "cpu_end": 0.5 * (i + 1), "pods": 1,
                  "in_window": i < 2} for i in range(3)]
    assert read(tracing.Trace("w", schedules, [], [], [], 2.0, 0.0)) == pytest.approx(500.0)
    assert read(tracing.Trace("w", [], [], [], [], 0.0, 0.0)) is None


def trace_with(groups: int, types: int, kernel_s: float, rounds=(3, 5), cells=(30, 50)) -> tracing.Trace:
    schedules = [{"index": 0, "start": 0.0, "end": 1.0, "pods": 10, "in_window": True}]
    spans = [
        {"name": "dispatch.cost_solve_dispatch", "layer": "dispatch", "schedule": 0, "start": 0.0, "end": 0.1,
         "info": {"groups": groups, "types": types, "dims": 8}},
        {"name": "fetch.fetch_plan", "layer": "fetch", "schedule": 0, "start": 0.1, "end": 0.2,
         "info": {"rounds_ffd": rounds[0], "rounds_cost": rounds[1], "cells_ffd": cells[0], "cells_cost": cells[1]}},
    ]
    device = [{"name": "lp_relax_kernel<true>", "start": 0.0, "end": kernel_s},
              {"name": "pack_rounds_kernel<1>", "start": 0.0, "end": kernel_s}]
    return tracing.Trace("w", schedules, spans, device, [], 1.0, kernel_s)


def test_rooflines_count_the_real_groups_and_types():
    lp = run.metric_reader(ROOT, "lp_relax_roofline")
    pack = run.metric_reader(ROOT, "pack_rounds_roofline")
    trace = trace_with(1_100, 400, 2.0)
    want = roofline.bound_seconds(roofline.lp_operations(1_100, 400, 8), roofline.lp_bytes(1_100, 400, 8))
    assert lp(trace) == pytest.approx(100 * want / 2.0)
    assert lp(trace) < lp(trace_with(2_048, 512, 2.0))
    operations = roofline.pack_operations(30, 400, 3, 1_100, 8, False) + roofline.pack_operations(
        50, 400, 5, 1_100, 8, True)
    want = roofline.bound_seconds(operations, roofline.pack_bytes(1_100, 400, 8, [3, 5]))
    assert pack(trace) == pytest.approx(100 * want / 2.0)
    assert lp(tracing.Trace("w", [], [], [], [], 0.0, 0.0)) is None


def test_active_cells_follow_the_rounds():
    class Rounds:
        num_rounds = 3
        round_fill = np.array([[2, 1, 0, 0], [1, 0, 0, 0], [0, 0, 1, 0], [9, 9, 9, 9]], dtype=np.int32)
        round_repl = np.array([2, 1, 4, 0], dtype=np.int32)

    # counts [5, 2, 4]: before round 0 all three hold pods; after it [1, 0, 4];
    # after round 1 [0, 0, 4].
    assert tracing.active_cells(np.array([5, 2, 4]), Rounds) == 3 + 2 + 1


def test_idle_gaps_go_to_the_innermost_host_span():
    trace = tracing.Trace(
        "w", [], [], [{"name": "k", "start": 1.0, "end": 2.0}],
        [{"name": "a", "start": 0.0, "end": 3.0}, {"name": "b", "start": 2.5, "end": 2.75}], 4.0, 1.0)
    gaps = dict(tracing.breakdown(trace)["idle_gaps"])
    assert gaps == pytest.approx({"a": 1.75, "b": 0.25, "harness": 1.0})


# --- cells found by name, the guard, the control and the faults ------------


def test_a_cell_of_new_files_is_found_and_built(tiny_root):
    cell = run.load_cell("tiny.small", root=tiny_root)
    assert cell.config["name"] == "tiny" and cell.traffic == TINY_TRAFFIC and cell.limits == TINY_LIMITS
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "pods_per_s", "usd_per_hr_per_kpod"}
    assert {m["name"] for m in cell.per_layer} == {
        "encode_ms", "dispatch_ms", "launches_per_schedule", "lp_relax_roofline", "pack_rounds_roofline",
        "fetch_ms", "host_score_ms", "decode_ms", "device_idle_pct", "cpu_ms_per_schedule"}
    for metric in cell.per_layer:
        assert callable(run.metric_reader(tiny_root, metric["name"]))
    types = generate.catalog(cell.config)
    shapes, _ = generate.population(cell.config)
    cycle = generate.schedules(cell.config, cell.traffic, 9)
    assert len(generate.port_catalog(types)) == 40 and len(cycle) == 2
    plan = control.ffd_plan(types, shapes, cycle[0], honour_overhead=True)
    assert judged(plan, cycle[0], shapes, types)["misplaced_pods"] == 0


def test_no_jax_guard_compares_whole_top_level_names(monkeypatch):
    import types as pytypes

    before = set(run.forbidden_modules())
    for name in ("karpenter_tpu_torch.models", "jaxtyping", "benchmark.jax"):
        monkeypatch.setitem(sys.modules, name, pytypes.ModuleType(name))
    assert set(run.forbidden_modules()) == before
    for name in ("karpenter_tpu.ops", "optax"):
        monkeypatch.setitem(sys.modules, name, pytypes.ModuleType(name))
    assert set(run.forbidden_modules()) == before | {"karpenter_tpu", "optax"}


def test_the_harness_imports_no_jax():
    import subprocess

    code = ("import sys; sys.path.insert(0, %r); from benchmark import run, control; "
            "import karpenter_tpu_torch.models.solver; print(run.forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_tiny_run_is_correct(tiny_root, tmp_path, monkeypatch, trace):
    """Through the program's device route (its kernels' plain versions on
    the CPU), which the cells' schedules take on the card."""
    monkeypatch.setenv("KARPENTER_HOST_SOLVE", "0")
    cell = run.load_cell("tiny.small", root=tiny_root)
    line = run.run_cell(cell, 2**33 + 5, 15.0, trace=trace, device="cpu", out_dir=tmp_path / "out")
    assert line["correct"] and line["failed"] == 0, line["checks"]
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == set(reference.CHECKS)
    if trace:
        # On the CPU no device record exists: the device metrics stay out.
        assert {"encode_ms", "host_score_ms", "decode_ms"} <= set(line["metrics"])
        assert not {"lp_relax_roofline", "device_idle_pct"} & set(line["metrics"])
        assert line["metrics"]["cpu_ms_per_schedule"]["value"] > 0
        assert line["breakdown"]["idle_gaps"] and (tmp_path / "out").is_dir()
    else:
        assert set(line["metrics"]) == {"setup_s", "pods_per_s", "usd_per_hr_per_kpod"}
        assert line["cpu_ms_per_schedule"] > 0


class _Flaky:
    """A solver that fails on the schedules it is told to, and records the
    collector's thresholds it ran under."""

    def __init__(self, fail_on, inner):
        self.fail_on, self.inner, self.calls, self.thresholds = set(fail_on), inner, 0, set()

    def solve(self, pods, instance_types, constraints):
        import gc

        self.calls += 1
        self.thresholds.add(gc.get_threshold())
        if self.calls - 1 in self.fail_on:
            raise RuntimeError("planted failure")
        return self.inner.solve(pods, instance_types, constraints)


@pytest.mark.parametrize("fail_on", [[1], [3, 5]], ids=["first_timed", "later"])
def test_a_failed_schedule_is_counted_not_fatal(tiny_root, fail_on):
    """Call 0 is the warm schedule; a failure among the cost metric's
    schedules or the judged ones reads correct false, and the run ends."""
    import gc

    from karpenter_tpu_torch.utils import gctune

    cell = run.load_cell("tiny.small", root=tiny_root)
    types = generate.catalog(cell.config)
    shapes, _ = generate.population(cell.config)
    made = []

    def make_solver():
        made.append(_Flaky(fail_on, control.FfdSolver(types, shapes, honour_overhead=True)))
        return made[0]

    before = gc.get_threshold()
    line = run.run_cell(cell, 11, 1.0, trace=False, device="cpu", make_solver=make_solver)
    assert line["correct"] is False and line["failed"] >= 1
    assert made[0].thresholds == {(gctune.GEN0_THRESHOLD, gctune.GEN1_THRESHOLD, gctune.GEN2_THRESHOLD)}
    assert gc.get_threshold() == before


@pytest.mark.parametrize("mode", control.MODES)
def test_control_and_faults_come_out_not_correct(tiny_root, monkeypatch, mode):
    """Each runs the rest of a run on the CPU, through the program's device
    route (its kernels' plain versions), with the timed path broken."""
    monkeypatch.setenv("KARPENTER_HOST_SOLVE", "0")
    cell = run.load_cell("tiny.small", root=tiny_root)
    line = control.run_mode(cell, mode, 31, 8.0, device="cpu")
    assert line["correct"] is False


# --- on the card -------------------------------------------------------------


@pytest.mark.cuda
def test_a_short_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell runs the port's kernels")
    cell = run.load_cell("zipf16.backlog50k")
    line = run.run_cell(cell, 2**31 + 3, 3.0, trace=False)
    assert line["correct"] and line["device"]["platform"] == "gpu"
