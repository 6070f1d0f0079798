"""The program's own spans of a traced run, matched to the run's schedules.

A `--trace 1` run records the window under torch.profiler, and while a
profiler session records, the port's tracer (`karpenter_tpu_torch.utils.
tracing.TRACER`) collects the spans the cost solve opens at its layer
boundaries: a root `solve` a schedule, with a trace id of its own that every
span of that solve carries, the overlap thread's included. A per-layer
metric reads them here after the window.

Matching: the most recent `solve` spans, one for each of the run's
schedules, are paired with the schedules in order, and one clock offset
(the window's start on the spans' clock; both are perf_counter readings)
must put every span inside its schedule. A span paired with the wrong
schedule, or left from an earlier run, cannot fit; a span that opens a few
ms into its schedule (a pause of the interpreter before the solve) does.
Then the schedules inside the window are kept, each with the spans of its
trace id. Where the spans are
absent or do not match (a program without them, a solver that is not the
program's, a run without a profiler, spans left from an earlier run in the
process), the readers get None and report nothing.
"""

from __future__ import annotations

from typing import Dict, List, Optional

ROOT_SPAN = "solve"


def _recorded() -> list:
    try:
        from karpenter_tpu_torch.utils.tracing import TRACER
    except Exception:  # noqa: BLE001 — no program, nothing to read
        return []
    return list(TRACER.spans()) if hasattr(TRACER, "spans") else []


def by_schedule(trace) -> Optional[List[list]]:
    """For each schedule completed inside the window, the program's spans
    of its solve; None where they are absent or do not match."""
    schedules = trace.schedules
    spans = _recorded()
    roots = sorted((s for s in spans if s.name == ROOT_SPAN and getattr(s, "trace", "")),
                   key=lambda s: s.start_s)
    if not schedules or len(roots) < len(schedules):
        return None
    roots = roots[-len(schedules):]
    pairs = list(zip(roots, schedules))
    # The window's start can be no later than any span's start less its
    # schedule's, and no earlier than any span's end less its schedule's.
    latest = min(root.start_s - schedule["start"] for root, schedule in pairs)
    earliest = max(root.start_s + root.duration_s - schedule["end"] for root, schedule in pairs)
    if earliest > latest:
        return None
    by_trace: Dict[str, list] = {}
    for span in spans:
        by_trace.setdefault(span.trace, []).append(span)
    kept = [by_trace[root.trace] for root, schedule in zip(roots, schedules) if schedule["in_window"]]
    return kept or None


def mean_ms(trace, name: str, attribute: Optional[str] = None, absent_is_zero: bool = False) -> Optional[float]:
    """Mean over the window's schedules of the seconds of the spans named
    `name` in each (or of their `attribute`, in seconds), in ms. None where
    no schedule has such a span, unless `absent_is_zero`."""
    groups = by_schedule(trace)
    if groups is None:
        return None
    named = [[s for s in spans if s.name == name] for spans in groups]
    if not absent_is_zero and not any(named):
        return None

    def seconds(span) -> float:
        return float(span.attributes.get(attribute, 0.0)) if attribute else span.duration_s

    return 1e3 * sum(sum(seconds(s) for s in spans) for spans in named) / len(named)
