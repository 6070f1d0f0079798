"""RemoteSolver: the control plane's side of the solver-plugin boundary.

A `Solver` implementation that ships each schedule's densified problem to the
sidecar and rehydrates the returned rounds/options against the fleet objects
it holds. When the sidecar is unreachable or errors, it degrades to the
in-process compiled-host greedy packer and blacks out the endpoint for
BLACKOUT_SECONDS before trying again — the same failure-detection pattern the
reference applies to exhausted capacity pools (ICE blackout cache,
ref: aws/instancetypes.go:37,174-183).

The port of karpenter_tpu/solver_service/client.py. It never touches the
card: the sidecar owns it, and the fallback is the host's NativeSolver.
Against the reference, the pipelined stream records its RPC histogram, span
and blackout before it yields its last result, so a caller that pulls one
result a schedule (the provisioning pass) still gets them.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional

import grpc
import numpy as np

from karpenter_tpu_torch.models.solver import (
    NativeSolver,
    Solver,
    _decode_rounds,
    _pool_price_matrix,
    pool_rows_to_options,
)
from karpenter_tpu_torch.ops import ffd
from karpenter_tpu_torch.ops.encode import InstanceFleet, PodGroups
from karpenter_tpu_torch.solver_service import solver_pb2 as pb
from karpenter_tpu_torch.solver_service import wire
from karpenter_tpu_torch.utils import logging as klog
from karpenter_tpu_torch.utils.clock import SYSTEM_CLOCK
from karpenter_tpu_torch.utils.metrics import REGISTRY
from karpenter_tpu_torch.utils.tracing import TRACE_METADATA_KEY, TRACER, Span

log = klog.named("remote-solver")


def _trace_metadata():
    """gRPC call metadata carrying the current batch trace id, or None —
    the sidecar enters the same trace for its serve spans, so one merged
    Chrome trace stitches the host, RPC, and solve lanes."""
    trace_id = TRACER.current_trace()
    if not trace_id:
        return None
    return ((TRACE_METADATA_KEY, trace_id),)

# Endpoint blackout after a failed RPC (the ICE-cache pattern).
BLACKOUT_SECONDS = 30.0
# Generous per-solve deadline: the 50k x 400 north-star config solves in
# ~110ms; anything past this is a wedged sidecar, not a slow solve.
DEFAULT_TIMEOUT_SECONDS = 10.0
# Stream deadline: base covers compile-on-first-shape, then a small per-item
# increment, hard-capped — a wedged sidecar must degrade to host fallback in
# seconds regardless of batch size (timeout_s * len(items) let a large pass
# block provisioning for minutes).
STREAM_PER_ITEM_SECONDS = 0.25
STREAM_TIMEOUT_CAP_SECONDS = 30.0

_RPC_HISTOGRAM = REGISTRY.histogram(
    "solver_rpc_duration_seconds",
    "Wall time of sidecar Solve RPCs",
    labels=("outcome",),
)

# Every blackout arming is a sidecar outage window the fleet should see
# climbing BEFORE operators notice solves running host-side (the ICE-cache
# observability gap, closed): labeled by which failure shape armed it.
BLACKOUT_TOTAL = REGISTRY.counter(
    "remote_solver_blackout_total",
    "Sidecar endpoint blackouts armed, by failure shape",
    ["reason"],
)


def _await_half_close(received, stream_done, failure) -> None:
    """After every pipelined item yielded, give the stream's half-close
    event a moment to land so the RPC histogram records true wire time (the
    drain stamps stream_done before its terminal put)."""
    if failure is None and stream_done[0] is None:
        try:
            received.get(timeout=1.0)
        except queue.Empty:  # pragma: no cover — wedged half-close
            pass


class RemoteSolver(Solver):
    def __init__(
        self,
        endpoint: str,
        mode: str = "cost",
        lp_steps: int = 300,
        quirk: bool = False,
        fallback: Optional[Solver] = None,
        timeout_s: float = DEFAULT_TIMEOUT_SECONDS,
        blackout_s: float = BLACKOUT_SECONDS,
        clock: Callable[[], float] = SYSTEM_CLOCK.monotonic,
    ):
        self.endpoint = endpoint
        self.mode = mode
        self.lp_steps = lp_steps
        self.quirk = quirk
        self.fallback = fallback or NativeSolver()
        self.timeout_s = timeout_s
        self.blackout_s = blackout_s
        self.clock = clock
        self._blackout_until = -float("inf")
        # Until the sidecar's boot warmup finishes (health status
        # "warming"), solves go straight to host fallback WITHOUT arming
        # the failure blackout: a warming sidecar is healthy-but-not-ready,
        # and the first live batch must not pay its jit compile. Checked
        # once; an "ok" sticks for the client's lifetime (readiness probes
        # own steady-state gating).
        self._warm_verified = False
        self._channel = grpc.insecure_channel(endpoint)
        self._solve_rpc = self._channel.unary_unary(
            wire.SOLVE_METHOD,
            request_serializer=pb.SolveRequest.SerializeToString,
            response_deserializer=pb.SolveResponse.FromString,
        )
        self._stream_rpc = self._channel.stream_stream(
            wire.SOLVE_STREAM_METHOD,
            request_serializer=pb.SolveRequest.SerializeToString,
            response_deserializer=pb.SolveResponse.FromString,
        )
        self._health_rpc = self._channel.unary_unary(
            wire.HEALTH_METHOD,
            request_serializer=pb.HealthRequest.SerializeToString,
            response_deserializer=pb.HealthResponse.FromString,
        )

    def healthy(self, timeout_s: float = 2.0) -> Optional[pb.HealthResponse]:
        try:
            return self._health_rpc(pb.HealthRequest(), timeout=timeout_s)
        except grpc.RpcError:
            return None

    def _check_warm(self) -> bool:
        """True once the sidecar has reported status "ok" (warmup done).
        While it reports "warming", callers host-solve WITHOUT arming the
        blackout — the sidecar is healthy, just precompiling; the next
        batch re-checks. An UNREACHABLE sidecar returns True on purpose:
        the solve proceeds to its RPC, whose failure path owns arming the
        blackout (this method must never swallow an outage silently)."""
        if self._warm_verified:
            return True
        health = self.healthy(timeout_s=1.0)
        if health is None or health.status == "ok":
            # Unreachable: proceed to the RPC (its error path arms the
            # blackout properly). "ok": verified warm.
            self._warm_verified = health is not None
            return True
        log.info(
            "sidecar %s warming; host-solving this batch", self.endpoint
        )
        return False

    def _build_request(self, groups: PodGroups, fleet: InstanceFleet):
        zones, pool_prices = _pool_price_matrix(fleet)
        request = pb.SolveRequest(
            group_vectors=wire.encode_tensor(groups.vectors),
            group_counts=wire.encode_tensor(groups.counts.astype(np.int32)),
            capacity=wire.encode_tensor(fleet.capacity),
            total=wire.encode_tensor(fleet.total),
            prices=wire.encode_tensor(fleet.prices),
            pool_prices=wire.encode_tensor(pool_prices),
            zones=zones,
            capacity_type=fleet.capacity_type,
            mode=self.mode,
            lp_steps=self.lp_steps,
            quirk=self.quirk,
        )
        return request, zones

    def solve_encoded_many(self, items) -> list:
        """Batch of schedules over the streaming RPC: the sidecar dispatches
        every kernel before fetching, so the batch shares one device round
        trip. Falls back (whole batch) to the host solver on RPC failure."""
        items = list(items)
        if not items:
            return []
        if self.clock() < self._blackout_until:
            return self.fallback.solve_encoded_many(items)
        if not self._check_warm():
            return self.fallback.solve_encoded_many(items)
        built = [self._build_request(groups, fleet) for groups, fleet in items]
        start = self.clock()
        responses = None
        rpc_error = None
        with TRACER.span(
            "solver.rpc.stream", endpoint=self.endpoint, solves=len(items)
        ) as span:
            try:
                deadline = min(
                    STREAM_TIMEOUT_CAP_SECONDS,
                    self.timeout_s + STREAM_PER_ITEM_SECONDS * len(items),
                )
                responses = list(
                    self._stream_rpc(
                        iter(request for request, _ in built),
                        timeout=deadline,
                        metadata=_trace_metadata(),
                    )
                )
                span.set(outcome="ok")
            except grpc.RpcError as error:
                span.set(outcome="error")
                rpc_error = error
        if responses is None or len(responses) != len(items):
            _RPC_HISTOGRAM.observe(self.clock() - start, "error")
            self._blackout_until = self.clock() + self.blackout_s
            BLACKOUT_TOTAL.inc("stream")
            log.warning(
                "sidecar %s stream failed (%s); host fallback for %.0fs",
                self.endpoint,
                getattr(rpc_error, "code", lambda: "short stream")(),
                self.blackout_s,
            )
            return self.fallback.solve_encoded_many(items)
        _RPC_HISTOGRAM.observe(self.clock() - start, "ok")
        # A per-request "error" marker means the sidecar isolated a failure
        # to that item (server solve_stream); host-solve it alone instead of
        # failing or blacking out the whole batch. But a batch where EVERY
        # item errored (e.g. the server's batched fetch is poisoned) is a
        # sidecar failure in a well-formed envelope — arm the blackout like
        # an RPC failure so the next passes don't repeat the doomed trip.
        if responses and all(r.solver == "error" for r in responses):
            self._blackout_until = self.clock() + self.blackout_s
            BLACKOUT_TOTAL.inc("stream_poisoned")
            log.warning(
                "sidecar %s errored every stream item; host fallback for %.0fs",
                self.endpoint,
                self.blackout_s,
            )
        return [
            self.fallback.solve_encoded(groups, fleet)
            if response.solver == "error"
            else self._decode(response, groups, fleet, zones)
            for response, (groups, fleet), (_, zones) in zip(
                responses, items, built
            )
        ]

    def solve_encoded_pipelined(self, items):
        """The remote half of the solve->bind pipeline: responses decode and
        yield AS THEY ARRIVE off the stream (the sidecar yields each
        schedule's response the moment it finishes —
        solver_service/server.solve_stream), so the provisioner binds
        schedule N while the sidecar still solves N+1.. across the wire.

        Failure semantics degrade per item instead of per batch: results
        already yielded are live (they may already be binding), so a
        mid-stream RPC failure arms the blackout and host-solves only the
        REMAINING schedules; per-request "error" markers host-solve that
        item inline, and a stream where EVERY item errored arms the
        poisoned-batch blackout exactly like solve_encoded_many.

        A receiver thread drains the stream EAGERLY into a queue: the gRPC
        deadline (sized for solve time) must never span the caller's
        bind/launch work between pulls — lazy next() calls over seconds of
        binds would hit DEADLINE_EXCEEDED on a perfectly healthy sidecar.
        The same thread stamps stream completion, so the RPC histogram
        records wire time only, not bind time."""
        items = list(items)
        if not items:
            return
        if self.clock() < self._blackout_until or not self._check_warm():
            yield from self.fallback.solve_encoded_pipelined(items)
            return
        built = [self._build_request(groups, fleet) for groups, fleet in items]
        deadline = min(
            STREAM_TIMEOUT_CAP_SECONDS,
            self.timeout_s + STREAM_PER_ITEM_SECONDS * len(items),
        )
        start = self.clock()
        span_trace = TRACER.current_trace()
        span_parent = TRACER.current_parent()
        span_start = time.perf_counter()
        responses = self._stream_rpc(
            iter(request for request, _ in built),
            timeout=deadline,
            metadata=_trace_metadata(),
        )
        received, stream_done = self._start_stream_drain(responses)
        produced = 0
        errored = 0
        failure = None
        last = None
        while produced < len(items):
            kind, payload = received.get()
            if kind == "error":
                failure = getattr(payload, "code", lambda: payload)()
                break
            if kind == "end":
                failure = "short stream"
                break
            groups, fleet = items[produced]
            _, zones = built[produced]
            if payload.solver == "error":
                errored += 1
                result = self.fallback.solve_encoded(groups, fleet)
            else:
                result = self._decode(payload, groups, fleet, zones)
            produced += 1
            if produced < len(items):
                yield result
            else:
                # The last result waits for the bookkeeping below: a caller
                # that pulls exactly len(items) results (the provisioning
                # pass does) never resumes this generator past it.
                last = result
        _await_half_close(received, stream_done, failure)
        rpc_elapsed = (stream_done[0] or self.clock()) - start
        self._record_stream_span(
            span_trace, span_parent, span_start, rpc_elapsed,
            len(items), failure,
        )
        fall_back = self._note_stream_outcome(
            failure, produced, len(items), errored, rpc_elapsed
        )
        if last is not None:
            yield last
        if fall_back:
            for groups, fleet in items[produced:]:
                yield self.fallback.solve_encoded(groups, fleet)

    def _record_stream_span(
        self, trace, parent, start_s: float, duration_s: float,
        solves: int, failure,
    ) -> None:
        """The pipelined stream's RPC span, recorded manually: a `with`
        span around the generator would charge the caller's bind work
        between pulls to the wire, so this takes the drain thread's
        wire-time stamps instead (the same reason the RPC histogram does).
        Trace/parent were captured before the first yield, while the
        caller's batch trace context and span stack were still current."""
        if not TRACER.recording():
            return
        TRACER.record(
            Span(
                name="solver.rpc.stream",
                start_s=start_s,
                duration_s=duration_s,
                attributes={
                    "endpoint": self.endpoint,
                    "solves": solves,
                    "pipelined": True,
                    "outcome": "ok" if failure is None else "error",
                },
                parent=parent,
                thread_id=threading.get_ident(),
                thread_name=threading.current_thread().name,
                trace=trace or "",
            )
        )

    def _start_stream_drain(self, responses):
        """Eagerly drain a SolveStream response iterator into a queue from a
        background thread (see solve_encoded_pipelined). Returns the queue
        and a 1-box stamped with the stream's end time (wire time, bind-free
        — the terminal put always follows the stamp)."""
        received: "queue.Queue" = queue.Queue()
        stream_done = [None]

        def _drain():
            try:
                for response in responses:
                    received.put(("item", response))
            except grpc.RpcError as error:
                stream_done[0] = self.clock()
                received.put(("error", error))
            else:
                stream_done[0] = self.clock()
                received.put(("end", None))

        threading.Thread(
            target=_drain, name="remote-solve-drain", daemon=True
        ).start()
        return received, stream_done

    def _note_stream_outcome(
        self, failure, produced: int, total: int, errored: int,
        rpc_elapsed: float,
    ) -> bool:
        """Histogram + blackout bookkeeping after a pipelined stream ends;
        True means the caller must host-solve the unyielded remainder."""
        if failure is not None:
            _RPC_HISTOGRAM.observe(rpc_elapsed, "error")
            self._blackout_until = self.clock() + self.blackout_s
            BLACKOUT_TOTAL.inc("stream")
            log.warning(
                "sidecar %s pipelined stream failed after %d/%d (%s); host "
                "fallback for %.0fs",
                self.endpoint, produced, total, failure, self.blackout_s,
            )
            return True
        _RPC_HISTOGRAM.observe(rpc_elapsed, "ok")
        if errored == total:
            self._blackout_until = self.clock() + self.blackout_s
            BLACKOUT_TOTAL.inc("stream_poisoned")
            log.warning(
                "sidecar %s errored every stream item; host fallback for %.0fs",
                self.endpoint, self.blackout_s,
            )
        return False

    def solve_encoded(self, groups: PodGroups, fleet: InstanceFleet) -> ffd.PackResult:
        if self.clock() < self._blackout_until:
            return self.fallback.solve_encoded(groups, fleet)
        if not self._check_warm():
            return self.fallback.solve_encoded(groups, fleet)

        request, zones = self._build_request(groups, fleet)
        start = self.clock()
        response = None
        # The span covers ONLY the RPC hop — the fallback solve runs outside
        # it so an outage doesn't misattribute host solve time to the wire.
        with TRACER.span(
            "solver.rpc",
            endpoint=self.endpoint,
            mode=self.mode,
            groups=groups.num_groups,
            types=fleet.num_types,
        ) as span:
            try:
                response = self._solve_rpc(
                    request, timeout=self.timeout_s, metadata=_trace_metadata()
                )
            except grpc.RpcError as error:
                span.set(outcome="error")
                rpc_error = error
            else:
                span.set(
                    outcome="ok", server_ms=response.solve_ms, solver=response.solver
                )
        if response is None:
            _RPC_HISTOGRAM.observe(self.clock() - start, "error")
            self._blackout_until = self.clock() + self.blackout_s
            BLACKOUT_TOTAL.inc("unary")
            log.warning(
                "sidecar %s unavailable (%s); host greedy for %.0fs",
                self.endpoint,
                getattr(rpc_error, "code", lambda: rpc_error)(),
                self.blackout_s,
            )
            return self.fallback.solve_encoded(groups, fleet)
        _RPC_HISTOGRAM.observe(self.clock() - start, "ok")
        return self._decode(response, groups, fleet, zones)

    @staticmethod
    def _decode(
        response: pb.SolveResponse,
        groups: PodGroups,
        fleet: InstanceFleet,
        zones,
    ) -> ffd.PackResult:
        rounds = [
            (
                round.type_index,
                wire.decode_tensor(round.fill),
                round.replication,
            )
            for round in response.rounds
        ]
        unschedulable = wire.decode_tensor(response.unschedulable)

        # fill bytes -> OptionSet (the server dedups option sets by fill, so
        # the mapping is well-defined); -1 rounds use the reference window.
        option_for_fill = {}
        for round in response.rounds:
            if round.option_set >= 0:
                option_for_fill[round.fill.data] = response.option_sets[
                    round.option_set
                ]

        def options_fn(t: int, fill: np.ndarray):
            option_set = option_for_fill.get(fill.astype(np.int64).tobytes())
            if option_set is None:
                upper = min(t + ffd.MAX_INSTANCE_TYPES, fleet.num_types)
                return list(range(t, upper)), None
            rows = (
                [(p.type_index, p.zone_index, p.price) for p in option_set.pools]
                if option_set.has_pools
                else None
            )
            return list(option_set.type_indices), pool_rows_to_options(
                rows, fleet, zones
            )

        return _decode_rounds(rounds, unschedulable, groups, fleet, options_fn)

    def close(self) -> None:
        self._channel.close()
