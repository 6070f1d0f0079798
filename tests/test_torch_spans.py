"""The spans inside the port's cost solve (utils/tracing.SPAN_NAMES), on the
CPU: when they record (KARPENTER_TRACE, or a torch.profiler session), which
trace and parent they carry (the overlap thread's included), what the
benchmark's readers of them (benchmark/program_spans.py and its metrics)
make of a tiny traced run, and that their Chrome export shares the
profiler's epoch clock."""

from __future__ import annotations

import dataclasses
import glob
import json
import math
import os
import shutil
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import generate, program_spans, run
from benchmark import tracing as bench_tracing
from karpenter_tpu_torch.api.provisioner import Constraints
from karpenter_tpu_torch.models import solver as port_solver
from karpenter_tpu_torch.models.solver import CostSolver
from karpenter_tpu_torch.utils import tracing
from karpenter_tpu_torch.utils.tracing import TRACER

ROOT = Path(__file__).resolve().parent.parent

# The spans one device-route solve opens, each once; host.finish.lp_realize
# besides where the finish realized the LP.
SOLVE_SPANS = {
    "solve", "encode.group_pods", "encode.build_fleet", "solve.device", "dispatch", "fetch",
    "host.wait", "host.pool_matrix", "host.mix", "host.mix.columns", "host.mix.cover_lp",
    "host.mix.integerize", "host.finish", "decode",
}
OVERLAP_SPANS = {"host.pool_matrix", "host.mix", "host.mix.columns", "host.mix.cover_lp", "host.mix.integerize"}
NEW_METRICS = ("host_wait_ms", "mix_columns_ms", "mix_lp_ms", "mix_integerize_ms", "mix_cpu_ms",
               "lp_realize_ms", "mix_win_pct")
# Their per-layer entries, as a benchmark that lists them would have them.
NEW_PER_LAYER = [
    {"name": name, "unit": "%" if name == "mix_win_pct" else "ms",
     "better": "higher" if name == "mix_win_pct" else "lower", "source": "host_clock",
     "layer": "host scoring", "moves": "pods_per_s", "workloads": ["tiny.small"]}
    for name in NEW_METRICS
]

TINY_TRAFFIC = {"pods_per_schedule": 300, "cycle": 2, "cost_schedules": 2, "check_schedules": 2}
TINY_LIMITS = {"misplaced_pods": 0, "bad_nodes": 0, "price_gap": 1e-9, "cost_excess": 0.5, "lp_excess": 0.3,
               "lp_under_bound": 1e-4}


def tiny_config() -> dict:
    """The benchmark's shapes1100 configuration at 30 shapes over 40 types."""
    tiny = json.loads((ROOT / "benchmark" / "configs" / "shapes1100-t400.json").read_text())
    tiny["name"] = "tiny"
    tiny["catalog"]["types"] = 40
    tiny["pods"]["shapes"] = 30
    return tiny


@pytest.fixture(autouse=True)
def quiet_tracer(monkeypatch):
    """The device route on the CPU (its kernels' plain versions), one torch
    thread, and a tracer that records only when a test asks it to."""
    monkeypatch.setenv("KARPENTER_HOST_SOLVE", "0")
    monkeypatch.setattr(TRACER, "enabled", False)
    monkeypatch.setattr(TRACER, "profile_dir", None)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    TRACER.clear()
    yield
    TRACER.clear()
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def problem():
    config = tiny_config()
    shapes, _ = generate.population(config)
    cycle = generate.schedules(config, TINY_TRAFFIC, 2**33 + 7)
    catalog = generate.port_catalog(generate.catalog(config))
    return generate.port_schedules(shapes, cycle)[0], catalog


def solve(problem):
    pods, catalog = problem
    return CostSolver(device="cpu").solve(pods, catalog, Constraints())


@pytest.mark.parametrize("slack, realized", [(0.0, True), (math.inf, False)], ids=["realized", "not_realized"])
def test_a_solve_under_the_profiler_records_every_span_once(problem, monkeypatch, slack, realized):
    monkeypatch.setattr(port_solver, "LP_REALIZE_SLACK", slack)
    solve(problem)
    assert TRACER.spans() == []
    with profile(activities=[ProfilerActivity.CPU]):
        solve(problem)
    spans = TRACER.spans()
    by_name = {s.name: s for s in spans}
    expected = SOLVE_SPANS | ({"host.finish.lp_realize"} if realized else set())
    assert sorted(s.name for s in spans) == sorted(expected)
    # One trace id, minted by the bare solve's root.
    assert len({s.trace for s in spans}) == 1 and by_name["solve"].trace
    # The overlap thread's spans name the span open where it was made.
    assert {s.name for s in spans if s.thread_name == "solve-host-overlap"} == OVERLAP_SPANS
    parents = {s.name: s.parent for s in spans}
    assert parents["solve"] is None
    for name in ("encode.group_pods", "encode.build_fleet", "solve.device", "host.finish", "decode"):
        assert parents[name] == "solve"
    for name in ("dispatch", "fetch", "host.wait", "host.pool_matrix", "host.mix"):
        assert parents[name] == "solve.device"
    for name in ("host.mix.columns", "host.mix.cover_lp", "host.mix.integerize"):
        assert parents[name] == "host.mix"
    if realized:
        assert parents["host.finish.lp_realize"] == "host.finish"
    # The counts a metric reads, and no others on the new spans.
    assert set(by_name["host.mix"].attributes) == {"cpu_s"} and by_name["host.mix"].attributes["cpu_s"] > 0
    assert by_name["host.finish"].attributes["winner"] in ("kernel_ffd", "kernel_cost", "mix", "lp_realized")
    assert set(by_name["host.finish"].attributes) == {"winner"}
    assert all(not s.attributes for s in spans if s.name not in ("solve.device", "host.mix", "host.finish"))


def test_a_solve_with_tracing_off_records_nothing(problem):
    assert not TRACER.recording()
    assert TRACER.span("solve").recording is False
    solve(problem)
    assert TRACER.spans() == []


def test_a_solve_inside_a_batch_keeps_the_batch_trace(problem, monkeypatch):
    monkeypatch.setattr(TRACER, "enabled", True)
    batch = tracing.new_trace_id()
    with TRACER.trace(batch):
        solve(problem)
    spans = TRACER.spans()
    assert {s.name for s in spans} >= SOLVE_SPANS
    assert {s.trace for s in spans} == {batch}
    assert TRACER.current_trace() is None


def test_the_profilers_flag_is_read_from_every_thread():
    import threading

    seen = []
    with profile(activities=[ProfilerActivity.CPU]):
        worker = threading.Thread(target=lambda: seen.append(TRACER.recording()))
        worker.start()
        worker.join()
    assert seen == [True] and not TRACER.recording()


def test_the_export_shares_the_profilers_epoch_clock(problem, monkeypatch, tmp_path):
    """With KARPENTER_JAX_PROFILE_DIR set, each device solve writes a
    torch.profiler trace in which the recorded spans appear as
    record_function ranges: a span's exported epoch time lies within 1 ms of
    its copy's ts plus the export's baseTimeNanoseconds.

    Compared are the profiled spans that open while their thread runs
    alone, `solve.device` and `dispatch`, before the overlap thread starts
    (whose ranges the profiler does not record). Where two threads compete
    for the interpreter lock, a switch (5 ms) can fall between the
    profiler's stamp of a range and the tracer's of its span, which is no
    clock's fault."""
    monkeypatch.setattr(TRACER, "profile_dir", str(tmp_path))
    solve(problem)
    TRACER.clear()
    for stale in tmp_path.iterdir():
        stale.unlink()
    solve(problem)
    [path] = glob.glob(os.path.join(tmp_path, "device-*.json"))
    exported = json.loads(Path(path).read_text())
    base_us = exported["baseTimeNanoseconds"] / 1e3
    ours = {e["name"]: e for e in TRACER.chrome_trace_events()}
    ALONE = ("solve.device", "dispatch")
    compared = 0
    for event in exported["traceEvents"]:
        if event.get("cat") == "user_annotation" and event.get("name") in ALONE:
            assert abs(event["ts"] + base_us - ours[event["name"]]["ts"]) < 1e3, event["name"]
            compared += 1
    assert compared == len(ALONE)
    assert TRACER.chrome_trace_document()["metadata"]["clock_epoch_offset_s"] == TRACER.epoch_offset_s


# --- the benchmark's readers on a tiny traced run ----------------------------


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """One traced run of a tiny cell, built as the benchmark's own tests
    build theirs (new files and a new BENCHMARK.json entry only) and with
    the seven readers' per-layer entries appended, with the harness's view
    of it (the Trace its readers got)."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "benchmark", root / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = root / "benchmark"
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
    spec["per_layer"].extend(NEW_PER_LAYER)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    made = []

    class Seen(bench_tracing.Trace):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    saved = {name: os.environ.get(name) for name in ("KARPENTER_HOST_SOLVE",)}
    os.environ["KARPENTER_HOST_SOLVE"] = "0"
    enabled, profile_dir, threads = TRACER.enabled, TRACER.profile_dir, torch.get_num_threads()
    TRACER.enabled, TRACER.profile_dir = False, None
    torch.set_num_threads(1)
    run.tracing.Trace = Seen
    TRACER.clear()
    try:
        line = run.run_cell(run.load_cell("tiny.small", root=root), 2**33 + 11, 3.0, trace=True, device="cpu",
                            out_dir=root / "out")
        spans = TRACER.spans()
    finally:
        run.tracing.Trace = bench_tracing.Trace
        TRACER.enabled, TRACER.profile_dir = enabled, profile_dir
        torch.set_num_threads(threads)
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value
    [trace] = made
    return {"line": line, "trace": trace, "spans": spans}


def replay(tiny_run) -> None:
    """Put the run's spans back in the tracer, which each test starts
    empty, for the readers that read it after the window."""
    for span in tiny_run["spans"]:
        TRACER.record(span)


def test_the_tiny_traced_run_is_correct(tiny_run):
    line = tiny_run["line"]
    assert line["correct"] and line["failed"] == 0, line["checks"]


@pytest.mark.parametrize("name", NEW_METRICS)
def test_each_new_reader_returns_a_number(tiny_run, name):
    value = tiny_run["line"]["metrics"][name]["value"]
    assert value >= 0 and math.isfinite(value)
    assert name == "lp_realize_ms" or name == "mix_win_pct" or value > 0


def test_the_mix_phases_sum_to_most_of_the_mix(tiny_run):
    """Per solve and per schedule: the columns, the LP and the
    integerization take at most the host.mix span and at least 80% of it."""
    by_trace = {}
    for span in tiny_run["spans"]:
        by_trace.setdefault(span.trace, []).append(span)
    solves = 0
    for spans in by_trace.values():
        [mix] = [s.duration_s for s in spans if s.name == "host.mix"] or [None]
        if mix is None:
            continue
        phases = sum(s.duration_s for s in spans if s.name.startswith("host.mix."))
        assert 0.8 * mix <= phases <= mix
        solves += 1
    assert solves >= 1
    metrics = tiny_run["line"]["metrics"]
    phases_ms = sum(metrics[name]["value"] for name in ("mix_columns_ms", "mix_lp_ms", "mix_integerize_ms"))
    replay(tiny_run)
    mix_ms = program_spans.mean_ms(tiny_run["trace"], "host.mix")
    assert 0.8 * mix_ms <= phases_ms <= mix_ms


@pytest.mark.parametrize("layer, names", [("encode_ms", ("encode.group_pods", "encode.build_fleet")),
                                          ("decode_ms", ("decode",))])
def test_the_programs_spans_agree_with_the_harness(tiny_run, layer, names):
    harness = tiny_run["line"]["metrics"][layer]["value"]
    replay(tiny_run)
    ours = sum(program_spans.mean_ms(tiny_run["trace"], name) for name in names)
    assert abs(ours - harness) <= 0.1 * harness, (ours, harness)


def test_a_solve_that_opens_late_in_its_schedule_still_matches(tiny_run):
    """A pause of the interpreter between the harness's stamp of a
    schedule and the solve's root span (a few ms on the card, among
    hundreds of schedules) leaves the span inside its schedule: the
    readers still read the run."""
    first_root = min((s for s in tiny_run["spans"] if s.name == "solve"), key=lambda s: s.start_s)
    for span in tiny_run["spans"]:
        late = span is first_root
        TRACER.record(dataclasses.replace(span, start_s=span.start_s + 0.003, duration_s=span.duration_s - 0.003)
                      if late else span)
    assert program_spans.by_schedule(tiny_run["trace"]) is not None
    for name in NEW_METRICS:
        assert run.metric_reader(ROOT, name)(tiny_run["trace"]) is not None


def test_the_readers_report_nothing_without_the_programs_spans(tiny_run):
    """A run whose solves opened no spans (the parent program, the control
    solver, a run without a profiler) reads None, and does not raise; so do
    spans that match no schedule by time."""
    for name in NEW_METRICS:
        assert run.metric_reader(ROOT, name)(tiny_run["trace"]) is None
    last_root = max((s for s in tiny_run["spans"] if s.name == "solve"), key=lambda s: s.start_s)
    for span in tiny_run["spans"]:
        late = span is last_root
        TRACER.record(dataclasses.replace(span, start_s=span.start_s + 0.5) if late else span)
    for name in NEW_METRICS:
        assert run.metric_reader(ROOT, name)(tiny_run["trace"]) is None
