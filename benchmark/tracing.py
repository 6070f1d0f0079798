"""Spans around the port's layer entry points, and the device trace of a run.

With `--trace 1` the harness wraps, at run time and from this file, the
functions that `CostSolver.solve` reaches through the module globals of
`karpenter_tpu_torch.models.solver`. No file of the port changes. Each call
records a span (name, layer, start, end, schedule, thread) in memory and
opens a `torch.profiler.record_function` of the same name, so that the host
spans and the device records share the profiler's clock. A wrapper adds no
device synchronisation: the solve's overlap of host scoring with the card
stays as it is.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

# A device operation's name in the breakdown: its first characters (the
# kernel's name and the start of its template arguments).
NAME_CHARS = 120
# (attribute of karpenter_tpu_torch.models.solver, layer)
WRAPPED = (
    ("group_pods", "encode"),
    ("build_fleet", "encode"),
    ("cost_solve_dispatch", "dispatch"),
    ("plan_start_fetch", "dispatch"),
    ("fetch_plan", "fetch"),
    ("_pool_price_matrix", "host_score"),
    ("compute_mix_candidate", "host_score"),
    ("cost_solve_finish", "host_score"),
    ("decode_dense_result", "decode"),
)


def active_cells(counts: np.ndarray, rounds) -> int:
    """Sum over the rounds of one pack mode of the groups that still hold
    pods when the round starts: the (group) scans a round makes for each
    type."""
    groups = int(counts.shape[0])
    num_rounds = min(int(rounds.num_rounds), int(rounds.round_fill.shape[0]))
    if num_rounds == 0:
        return 0
    fills = rounds.round_fill[:num_rounds, :groups].astype(np.int64)
    taken = np.cumsum(fills * rounds.round_repl[:num_rounds, None].astype(np.int64), axis=0)
    before = counts[None, :].astype(np.int64) - np.concatenate([np.zeros((1, groups), np.int64), taken[:-1]])
    return int((before > 0).sum())


@dataclass
class Spans:
    """The spans of one run, in memory until the run ends."""

    records: List[dict] = field(default_factory=list)
    schedule: int = -1
    _lock: threading.Lock = field(default_factory=threading.Lock)
    _undo: List[Callable[[], None]] = field(default_factory=list)

    def add(self, record: dict) -> None:
        with self._lock:
            self.records.append(record)

    def install(self) -> None:
        from torch.profiler import record_function

        from karpenter_tpu_torch.models import solver

        for attribute, layer in WRAPPED:
            original = getattr(solver, attribute)
            setattr(solver, attribute, self._wrapper(original, attribute, layer, record_function))
            self._undo.append(lambda attribute=attribute, original=original: setattr(solver, attribute, original))

    def uninstall(self) -> None:
        while self._undo:
            self._undo.pop()()

    def _wrapper(self, original, attribute: str, layer: str, record_function):
        name = f"{layer}.{attribute}"

        def wrapped(*args, **kwargs):
            schedule = self.schedule
            start = time.perf_counter()
            with record_function(f"bench.{name}"):
                out = original(*args, **kwargs)
            end = time.perf_counter()
            self.add({
                "name": name, "layer": layer, "schedule": schedule, "start": start, "end": end,
                "thread": threading.get_ident(), "info": self._info(attribute, args, out),
            })
            return out

        return wrapped

    def _info(self, attribute: str, args, out) -> Optional[dict]:
        """What the rooflines need, read from the layer's own arguments and
        results: the real groups and types at dispatch, the rounds each pack
        mode took at fetch."""
        if attribute == "cost_solve_dispatch":
            counts = np.asarray(args[1])
            self._counts = counts
            return {"groups": int((counts > 0).sum()), "types": int(np.asarray(args[2]).shape[0]),
                    "dims": int(np.asarray(args[0]).shape[1])}
        if attribute == "fetch_plan":
            counts = getattr(self, "_counts", None)
            if counts is None:
                return None
            return {
                "rounds_ffd": int(out.rounds_ffd.num_rounds), "rounds_cost": int(out.rounds_cost.num_rounds),
                "cells_ffd": active_cells(counts, out.rounds_ffd),
                "cells_cost": active_cells(counts, out.rounds_cost),
            }
        return None


@dataclass
class Trace:
    """What a per-layer metric reads. Times are seconds. `schedules` and
    `spans` are on the host's clock, from the window's start; `device` (the
    profiler's device records) and `host` (the spans moved onto the
    profiler's clock) are from the first timed schedule's start, and end at
    the last schedule that completed inside the window."""

    workload: str
    schedules: List[dict]
    spans: List[dict]
    device: List[dict]
    host: List[dict]
    window_s: float
    busy_s: float

    def window_schedules(self) -> List[dict]:
        return [s for s in self.schedules if s["in_window"]]

    def spans_of(self, layer: str) -> List[dict]:
        inside = {s["index"] for s in self.window_schedules()}
        return [span for span in self.spans if span["layer"] == layer and span["schedule"] in inside]

    def ms_per_schedule(self, layer: str) -> Optional[float]:
        """Mean over the window's schedules of the host wall time the layer's
        spans took in each (spans in the overlap thread included)."""
        schedules = self.window_schedules()
        spans = self.spans_of(layer)
        if not schedules or not spans:
            return None
        return 1e3 * sum(span["end"] - span["start"] for span in spans) / len(schedules)

    def kernel_seconds(self, marker: str) -> float:
        return sum(r["end"] - r["start"] for r in self.device if marker in r["name"])


def union_seconds(intervals) -> float:
    total, reach = 0.0, -np.inf
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def read_profile(prof, window_schedules: int) -> Dict[str, object]:
    """The profiler's device records, cut to the window: from the first
    bench.schedule record's start to the end of the `window_schedules`-th,
    on the profiler's clock from that start; and the schedules' starts on
    that clock. The records of bench.* ranges that the profiler mirrors on
    the device's timeline are user annotations, not device work, and are
    left out."""
    from torch.autograd import DeviceType

    device, schedules = [], []
    for event in prof.events():
        start, end = event.time_range.start * 1e-6, event.time_range.end * 1e-6
        if event.name.startswith("bench."):
            if event.name == "bench.schedule" and event.device_type != DeviceType.CUDA:
                schedules.append((start, end))
        elif event.device_type == DeviceType.CUDA:
            device.append({"name": event.name, "start": start, "end": end})
    schedules.sort()
    if not schedules or window_schedules == 0:
        return {"device": [], "schedule_starts": [], "window_s": 0.0}
    origin = schedules[0][0]
    close = schedules[min(window_schedules, len(schedules)) - 1][1]
    return {
        "device": [
            {**r, "start": r["start"] - origin, "end": r["end"] - origin}
            for r in device if r["start"] >= origin and r["end"] <= close
        ],
        "schedule_starts": [start - origin for start, _ in schedules],
        "window_s": close - origin,
    }


def host_on_profile_clock(spans: List[dict], schedule_starts: List[float], schedules: List[dict]) -> List[dict]:
    """The host spans (every thread's) moved onto the profiler's clock by the
    mean offset between each schedule's start on the two clocks."""
    pairs = list(zip(schedule_starts, (s["start"] for s in schedules)))
    if not pairs:
        return []
    offset = float(np.mean([profiled - hosted for profiled, hosted in pairs]))
    return [{"name": s["name"], "start": s["start"] + offset, "end": s["end"] + offset} for s in spans]


def host_timeline(host: List[dict]) -> List[tuple]:
    """(start, end, name) pieces of the window, each named by the innermost
    (latest-started) bench.* span open over it, "harness" where none is."""
    events = sorted(
        [(r["start"], 1, i) for i, r in enumerate(host)] + [(r["end"], -1, i) for i, r in enumerate(host)],
        key=lambda e: (e[0], e[1]),
    )
    pieces, open_spans, last = [], {}, None
    for t, kind, i in events:
        if last is not None and t > last:
            name = host[max(open_spans, key=lambda j: host[j]["start"])]["name"] if open_spans else "harness"
            pieces.append((last, t, name))
        last = t
        if kind == 1:
            open_spans[i] = True
        else:
            open_spans.pop(i, None)
    return pieces


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the card's idle gaps
    summed by the innermost host span open over each piece of a gap."""
    by_op: Dict[str, float] = {}
    for record in trace.device:
        name = record["name"][:NAME_CHARS]
        by_op[name] = by_op.get(name, 0.0) + record["end"] - record["start"]
    gaps_by: Dict[str, float] = {}
    gaps, reach = [], 0.0
    for start, end in sorted((r["start"], r["end"]) for r in trace.device) + [(trace.window_s,) * 2]:
        if start > reach:
            gaps.append((reach, start))
        reach = max(reach, end)
    pieces = host_timeline(trace.host)
    k = 0
    for gap_start, gap_end in gaps:
        covered = 0.0
        while k < len(pieces) and pieces[k][1] <= gap_start:
            k += 1
        j = k
        while j < len(pieces) and pieces[j][0] < gap_end:
            overlap = min(gap_end, pieces[j][1]) - max(gap_start, pieces[j][0])
            if overlap > 0:
                gaps_by[pieces[j][2]] = gaps_by.get(pieces[j][2], 0.0) + overlap
                covered += overlap
            j += 1
        if gap_end - gap_start > covered:
            gaps_by["harness"] = gaps_by.get("harness", 0.0) + (gap_end - gap_start - covered)

    def largest(sums: Dict[str, float]) -> list:
        return sorted(([name, value] for name, value in sums.items()), key=lambda kv: -kv[1])[:top]

    return {"device_ops": largest(by_op), "idle_gaps": largest(gaps_by)}
