#!/usr/bin/env python3
"""What the port's tracing costs: nanoseconds per span with the tracer off
and on, and the spans one cost solve of a benchmark configuration opens.

    python3 tools/span_cost.py [--config zipf16-t400] [--pods 50000] [--device cuda]

Off is the production default (no KARPENTER_TRACE, no profiler session):
a span is one check of `Tracer.recording()` and a shared no-op. On is
KARPENTER_TRACE=1: the span is stamped and kept in the ring. Prints one JSON
line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def ns_per_span(tracer, calls: int) -> float:
    """Best of five timings of `calls` spans shaped as the solve's are (a
    count set under `if span.recording:`)."""
    best = float("inf")
    for _ in range(5):
        start = time.perf_counter_ns()
        for _ in range(calls):
            with tracer.span("dispatch") as span:
                if span.recording:
                    span.set(groups=1)
        best = min(best, (time.perf_counter_ns() - start) / calls)
        tracer.clear()
    return best


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", default="zipf16-t400")
    parser.add_argument("--pods", type=int, default=50_000)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--calls", type=int, default=200_000)
    args = parser.parse_args(argv)

    from benchmark import generate, run
    from karpenter_tpu_torch.api.provisioner import Constraints
    from karpenter_tpu_torch.models.solver import CostSolver
    from karpenter_tpu_torch.utils.tracing import TRACER

    enabled = TRACER.enabled
    TRACER.enabled = False
    off_ns = ns_per_span(TRACER, args.calls)
    TRACER.enabled = True
    on_ns = ns_per_span(TRACER, args.calls)

    config = json.loads((ROOT / "benchmark" / "configs" / f"{args.config}.json").read_text())
    if args.device == "cuda":
        run.build_kernels()
    shapes, _ = generate.population(config)
    cycle = generate.schedules(config, {"pods_per_schedule": args.pods, "cycle": 2}, 2**31 + 9)
    catalog = generate.port_catalog(generate.catalog(config))
    pods = generate.port_schedules(shapes, cycle)
    solver = CostSolver(device=args.device)
    TRACER.enabled = False
    solver.solve(pods[0], catalog, Constraints())
    TRACER.enabled = True
    TRACER.clear()
    solver.solve(pods[1], catalog, Constraints())
    spans = TRACER.spans()
    TRACER.enabled = enabled
    TRACER.clear()
    print(json.dumps({
        "off_ns_per_span": off_ns,
        "on_ns_per_span": on_ns,
        "spans_per_solve": len(spans),
        "names": sorted({s.name for s in spans}),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
