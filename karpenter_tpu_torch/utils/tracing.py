"""Tracing: spans around the provisioning pipeline and the solver boundary.

The reference ships no tracing at all (SURVEY.md §5 — only Prometheus
duration histograms); the rebuild adds it because the solve path now crosses
a process boundary (gRPC sidecar) and a device boundary (host↔card), where
aggregate histograms can't show *which* hop ate the latency budget.

Design: an in-process tracer with explicit context-manager spans. Spans
nest via a thread-local stack, live in a bounded ring buffer, and export as
Chrome trace events (chrome://tracing / Perfetto load them directly).
Spans record while `Tracer.recording()` holds, and production runs pay one
check per span when it does not:

  KARPENTER_TRACE=1                 enable span collection
  (a torch.profiler session)        collect spans while it records in the
                                    process, so whoever takes a device
                                    trace of the process gets the
                                    program's spans with it
  KARPENTER_TRACE_FILE=/path.json   flush Chrome trace events there on exit
  KARPENTER_JAX_PROFILE_DIR=/path   capture a torch.profiler trace of the
                                    card around each device solve, and
                                    mirror each recorded span there as a
                                    record_function range (the reference's
                                    variable, kept so both packages read
                                    one setting)

Spans enter record_function only under KARPENTER_JAX_PROFILE_DIR: a range
mirrored on the card's timeline becomes a device annotation record, which
a reader counting the card's records would count as work.

Clock: spans are stamped with `perf_counter_ns`, which is incomparable
across processes, so the exporter rebases every `ts` onto the Unix epoch,
as torch.profiler's export does (its `ts` plus `baseTimeNanoseconds`). The
anchor is read at each export (and recorded in its metadata), so a
long-running process's wall-clock slew cannot move the spans off a device
trace taken beside them. Traces from the controller, the sidecar, and SPMD
followers concatenate into one aligned timeline.

Trace ids: one minted per provisioning batch (new_trace_id / Tracer.trace),
or per bare solve around its root span "solve", is stamped on every
span recorded while it is current and rides the solver RPC metadata and the
SPMD broadcast header, so one batch's spans correlate across all three
processes. A worker thread joins its creator's trace and names the
creator's innermost open span as its spans' parent (Tracer.trace(id,
parent)).
"""

from __future__ import annotations

import atexit
import json
import os
import random
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

_MAX_SPANS = 65536

# The span-name inventory: every TRACER.span(...) literal in production code
# must appear here (enforced by tools/vet's span-consistency checker, the
# tracing analogue of the metrics one-home discipline) — a renamed span that
# kept an old dashboard/trace query alive would otherwise drift silently.
SPAN_NAMES = (
    "provision.schedule",
    "provision.resolve",
    "provision.bind",
    "provision.solve",
    "provision.solve.constrained",
    "provision.solve.dispatch",
    "solve.device",
    "solve.device.batch",
    "solve.device.pipelined",
    "solver.rpc",
    "solver.rpc.stream",
    "solver.serve",
    "solver.serve.stream",
    "spmd.follower.step",
    # Inside the cost solve (models/solver, ops/mix_pack): a bare solve's
    # root, its layer boundaries, and the overlap thread's host work.
    "solve",
    "encode.group_pods",
    "encode.build_fleet",
    "dispatch",
    "fetch",
    "host.wait",
    "host.pool_matrix",
    "host.mix",
    "host.mix.columns",
    "host.mix.cover_lp",
    "host.mix.integerize",
    "host.finish",
    "host.finish.lp_realize",
    "decode",
)

# gRPC metadata key carrying the batch trace id across the sidecar boundary.
TRACE_METADATA_KEY = "karpenter-trace-id"

_trace_rng = random.Random()


def new_trace_id() -> str:
    """A fresh 62-bit trace id as 16 hex chars (62 bits so the SPMD header
    can carry it as two non-negative int32 words)."""
    return f"{_trace_rng.getrandbits(62) | 1:016x}"


def trace_id_to_words(trace_id: Optional[str]) -> Tuple[int, int]:
    """(lo, hi) 31-bit words for fixed-shape int32 transports (SPMD header);
    (0, 0) means no trace."""
    if not trace_id:
        return 0, 0
    try:
        value = int(trace_id, 16)
    except ValueError:
        return 0, 0
    return value & 0x7FFFFFFF, (value >> 31) & 0x7FFFFFFF


def words_to_trace_id(lo: int, hi: int) -> Optional[str]:
    value = ((int(hi) & 0x7FFFFFFF) << 31) | (int(lo) & 0x7FFFFFFF)
    return f"{value:016x}" if value else None


@dataclass
class Span:
    name: str
    start_s: float
    duration_s: float = 0.0
    attributes: Dict[str, object] = field(default_factory=dict)
    parent: Optional[str] = None
    thread_id: int = 0
    thread_name: str = ""
    trace: str = ""


def _torch_profiler_recording() -> bool:
    """True while a torch.profiler session records in this process (any
    thread's). torch keeps the flag in a module global; a process that
    never imported the profiler has none running."""
    profiler = sys.modules.get("torch.autograd.profiler")
    return profiler is not None and getattr(profiler, "_is_profiler_enabled", False)


class _TraceContext:
    __slots__ = ("tracer", "trace_id", "parent", "_previous")

    def __init__(self, tracer: "Tracer", trace_id: Optional[str], parent: Optional[str] = None):
        self.tracer = tracer
        self.trace_id = trace_id
        self.parent = parent

    def __enter__(self):
        local = self.tracer._local
        self._previous = getattr(local, "trace", None)
        if self.trace_id is not None:
            local.trace = self.trace_id
        if self.parent is not None:
            self.tracer._stack().append(self.parent)
        return self

    def __exit__(self, *exc):
        self.tracer._local.trace = self._previous
        if self.parent is not None:
            self.tracer._stack().pop()
        return False


class Tracer:
    def __init__(self, enabled: Optional[bool] = None):
        self.enabled = (
            enabled
            if enabled is not None
            else os.environ.get("KARPENTER_TRACE", "") not in ("", "0", "false")
        )
        self.profile_dir = os.environ.get("KARPENTER_JAX_PROFILE_DIR") or None
        # Wall-clock anchor of the most recent Chrome export: start_s values
        # are perf_counter readings (monotonic, process-local); adding this
        # offset rebases them onto the epoch so `ts` values from different
        # processes align in one merged timeline. Read anew at each export.
        self.epoch_offset_s = _epoch_offset_ns() * 1e-9
        self._spans: deque = deque(maxlen=_MAX_SPANS)  # vet: guarded-by(self._lock)
        self._local = threading.local()
        self._lock = threading.Lock()

    def recording(self) -> bool:
        """THE predicate every span and every span attribute checks:
        KARPENTER_TRACE, or a torch.profiler session recording in the
        process."""
        return self.enabled or _torch_profiler_recording()

    # -- trace context -------------------------------------------------------

    def trace(self, trace_id: Optional[str], parent: Optional[str] = None) -> _TraceContext:
        """Context manager making `trace_id` current for this thread; spans
        recorded inside carry it. None is a no-op (keeps any outer trace).
        `parent`, a span name, is the parent of the outermost spans opened
        inside: a worker thread names its creator's open span so."""
        return _TraceContext(self, trace_id, parent)

    def current_trace(self) -> Optional[str]:
        return getattr(self._local, "trace", None)

    def current_parent(self) -> Optional[str]:
        """Name of the innermost open span on this thread, or None — parent
        attribution for spans recorded manually via record() (e.g. the
        pipelined RPC span, whose wire time is stamped off-thread)."""
        stack = self._stack()
        return stack[-1] if stack else None

    # -- spans ---------------------------------------------------------------

    def span(self, name: str, **attributes):
        """Context manager: times the block, records nesting. While the
        tracer is not recording it is a shared no-op whose `recording` is
        False: attributes that cost anything are set inside
        `if span.recording:`."""
        if not self.recording():
            return _NOOP_SPAN
        return _SpanContext(self, name, attributes)

    def record(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)

    def spans(self, name: Optional[str] = None) -> List[Span]:
        with self._lock:
            out = list(self._spans)
        if name is not None:
            out = [s for s in out if s.name == name]
        return out

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    # -- export --------------------------------------------------------------

    def chrome_trace_events(self) -> List[dict]:
        """Complete ('X') events in the Chrome trace event format, with `ts`
        rebased onto the wall clock (see epoch_offset_s, read anew here)."""
        offset_s = self.epoch_offset_s = _epoch_offset_ns() * 1e-9
        pid = os.getpid()
        return [
            {
                "name": span.name,
                "ph": "X",
                "ts": (offset_s + span.start_s) * 1e6,
                "dur": span.duration_s * 1e6,
                "pid": pid,
                "tid": span.thread_id,
                "args": {
                    **span.attributes,
                    "parent": span.parent or "",
                    "trace": span.trace,
                },
            }
            for span in self.spans()
        ]

    def chrome_trace_document(self) -> dict:
        """The full export: span events plus process_name/thread_name
        metadata ('M') events per pid/tid and the wall-clock anchor, so a
        merged multi-process trace labels every lane and stays aligned."""
        events = self.chrome_trace_events()
        pid = os.getpid()
        metadata: List[dict] = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {"name": f"karpenter-tpu:{pid}"},
            }
        ]
        named: Dict[int, str] = {}
        for span in self.spans():
            if span.thread_id not in named:
                named[span.thread_id] = span.thread_name or str(span.thread_id)
        metadata.extend(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": tid,
                "args": {"name": name},
            }
            for tid, name in sorted(named.items())
        )
        return {
            "traceEvents": metadata + events,
            "metadata": {
                "pid": pid,
                "clock_epoch_offset_s": self.epoch_offset_s,
                "clock_domain": "epoch-anchored perf_counter",
            },
        }

    def flush(self, path: Optional[str] = None) -> Optional[str]:
        path = path or os.environ.get("KARPENTER_TRACE_FILE")
        if not path:
            return None
        with open(path, "w") as f:
            json.dump(self.chrome_trace_document(), f)
        return path

    # -- stack ---------------------------------------------------------------

    def _stack(self) -> List[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack


def _epoch_offset_ns() -> int:
    """Unix-epoch nanoseconds less perf_counter nanoseconds, now."""
    return time.time_ns() - time.perf_counter_ns()


class _NoopSpan:
    """What span() hands out while the tracer is not recording."""

    __slots__ = ()
    recording = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attributes) -> None:
        pass


_NOOP_SPAN = _NoopSpan()


class _SpanContext:
    __slots__ = ("tracer", "name", "attributes", "_start_ns", "_profiler_ctx")
    recording = True

    def __init__(self, tracer: Tracer, name: str, attributes: dict):
        self.tracer = tracer
        self.name = name
        self.attributes = attributes
        self._profiler_ctx = None

    def __enter__(self):
        tracer = self.tracer
        tracer._stack().append(self.name)
        if tracer.profile_dir is not None:
            # Line this host span up with the card's kernels in the profile.
            import torch.profiler

            self._profiler_ctx = torch.profiler.record_function(self.name)
            self._profiler_ctx.__enter__()
        self._start_ns = time.perf_counter_ns()
        return self

    def set(self, **attributes) -> None:
        self.attributes.update(attributes)

    def __exit__(self, *exc):
        end_ns = time.perf_counter_ns()
        tracer = self.tracer
        if self._profiler_ctx is not None:
            self._profiler_ctx.__exit__(*exc)
        stack = tracer._stack()
        stack.pop()
        current = threading.current_thread()
        tracer.record(
            Span(
                name=self.name,
                start_s=self._start_ns * 1e-9,
                duration_s=(end_ns - self._start_ns) * 1e-9,
                attributes=dict(self.attributes),
                parent=stack[-1] if stack else None,
                # Full idents: the old `& 0xFFFF` truncation collided thread
                # lanes in big pools, merging unrelated spans in the viewer.
                thread_id=threading.get_ident(),
                thread_name=current.name,
                trace=tracer.current_trace() or "",
            )
        )
        return False


# One torch.profiler session at a time in a process: a block that starts
# while another thread's capture is open (the sidecar's concurrent solves)
# runs without one rather than fail.
_PROFILE_LOCK = threading.Lock()


class _ProfileSession:
    """torch.profiler capture around a block (KARPENTER_JAX_PROFILE_DIR):
    the host and the card, exported as a Chrome trace into the directory.
    Captures do not nest or overlap: a block entered while one is open
    (another thread's, or an enclosing one) records no trace of its own."""

    def __init__(self, tracer: Tracer):
        self.tracer = tracer
        self._profile = None

    def __enter__(self):
        if self.tracer.profile_dir is not None and _PROFILE_LOCK.acquire(blocking=False):
            import torch.profiler

            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            try:
                profile = torch.profiler.profile(activities=activities)
                profile.__enter__()
            except BaseException:
                _PROFILE_LOCK.release()
                raise
            self._profile = profile
        return self

    def __exit__(self, *exc):
        if self._profile is not None:
            try:
                self._profile.__exit__(*exc)
                os.makedirs(self.tracer.profile_dir, exist_ok=True)
                self._profile.export_chrome_trace(
                    os.path.join(self.tracer.profile_dir, f"device-{os.getpid()}-{time.time_ns()}.json")
                )
            finally:
                self._profile = None
                _PROFILE_LOCK.release()
        return False


def device_profile(tracer: Optional[Tracer] = None) -> _ProfileSession:
    return _ProfileSession(tracer or TRACER)


# The process-wide tracer, mirroring metrics.REGISTRY. When a trace file is
# configured, collected spans flush there at interpreter exit (the documented
# KARPENTER_TRACE_FILE contract); flush() can also be called any time.
TRACER = Tracer()
if TRACER.recording() and os.environ.get("KARPENTER_TRACE_FILE"):
    atexit.register(TRACER.flush)
