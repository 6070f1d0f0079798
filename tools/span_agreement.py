#!/usr/bin/env python3
"""One traced run of a benchmark cell, and the program's own spans of it
beside the harness's layer metrics.

    python3 tools/span_agreement.py --workload NAME --seed N [--seconds S] [--device cuda]

Runs `benchmark/run.run_cell(..., trace=True)` and reads, per schedule
completed inside the window, the mean milliseconds of each span the cost
solve opened (benchmark/program_spans.py) and which candidate won the
finish. Prints one JSON line: `harness` (the traced line's metrics),
`readers` (what each reader under benchmark/metrics/ that reads the
program's spans makes of the run, listed in BENCHMARK.json or not),
`program` (ms per schedule by span name), `agreement` (each of the
harness's encode, dispatch, fetch and decode metrics against the sum of the
program's spans at the same boundary), `mix_phase_share` (the three phases
of the mix candidate over its span), `winners` and `realized` (the
schedules whose finish realized the LP).
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# The harness's layer metric -> the program's spans at the same boundary.
BOUNDARIES = {
    "encode_ms": ("encode.group_pods", "encode.build_fleet"),
    "dispatch_ms": ("dispatch",),
    "fetch_ms": ("fetch",),
    "decode_ms": ("decode",),
}
MIX_PHASES = ("host.mix.columns", "host.mix.cover_lp", "host.mix.integerize")
READERS = ("host_wait_ms", "mix_columns_ms", "mix_lp_ms", "mix_integerize_ms", "mix_cpu_ms",
           "lp_realize_ms", "mix_win_pct")


def agreement(harness: dict, program: dict) -> dict:
    """Each harness layer metric beside the program's spans at its boundary."""
    out = {}
    for metric, spans in BOUNDARIES.items():
        theirs = harness.get(metric)
        if not theirs:
            continue
        ours = sum(program.get(name, 0.0) for name in spans)
        out[metric] = {"harness": theirs, "program": ours, "diff_ms": ours - theirs,
                       "diff_share": (ours - theirs) / theirs}
    return out


def finishes(groups) -> tuple:
    """(winner label -> schedules, schedules whose finish realized the LP)."""
    spans = [s for group in groups for s in group if s.name == "host.finish"]
    winners = Counter(s.attributes.get("winner") for s in spans)
    return dict(winners), sum(any(s.name == "host.finish.lp_realize" for s in group) for group in groups)


def traced_run(workload: str, seed: int, seconds: float, device: str):
    """run_cell with --trace 1, and the Trace its readers got."""
    from benchmark import run
    from benchmark import tracing as bench_tracing

    seen = []

    class Seen(bench_tracing.Trace):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen.append(self)

    run.tracing.Trace = Seen
    try:
        line = run.run_cell(run.load_cell(workload), seed, seconds, trace=True, device=device)
    finally:
        run.tracing.Trace = bench_tracing.Trace
    return line, seen[0]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=51.0)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from benchmark import program_spans, run
    from karpenter_tpu_torch.utils.tracing import SPAN_NAMES

    line, trace = traced_run(args.workload, args.seed, args.seconds, args.device)
    read = {name: program_spans.mean_ms(trace, name) for name in SPAN_NAMES}
    program = {name: ms for name, ms in read.items() if ms is not None}
    harness = {name: metric["value"] for name, metric in line["metrics"].items()}
    readers = {name: run.metric_reader(ROOT, name)(trace) for name in READERS}
    groups = program_spans.by_schedule(trace) or []
    winners, realized = finishes(groups)
    mix = program.get("host.mix")
    print(json.dumps({
        "workload": args.workload, "seed": args.seed, "correct": line["correct"], "schedules": len(groups),
        "harness": harness, "readers": readers, "program": program, "agreement": agreement(harness, program),
        "mix_phase_share": sum(program.get(name, 0.0) for name in MIX_PHASES) / mix if mix else None,
        "winners": winners, "realized": realized,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
