"""The solver sidecar: a stateless gRPC service owning the CUDA card.

The port of karpenter_tpu/solver_service/server.py. It speaks the
reference's wire protocol (solver_pb2, wire): a client of either package
calls a server of either.

Ref: SURVEY.md §2.7 / §7 step 5 — the north star's `pkg/cloudprovider/solver`
plugin analogue. The control plane (any process, any language with protobuf)
sends one SolveRequest per schedule; the sidecar runs the fused cost solve
on the card (models/solver.cost_solve_dense: K1, K2's pair launch with the
plan compaction in its epilogue, K3) and streams back launch rounds +
price-ranked pool options as indices. No request state survives a call
(ref: SURVEY.md §5 checkpoint/resume — the reference keeps all state in the
cluster API; the sidecar keeps none at all), so a crashed sidecar is replaced
by simply restarting it; the client meanwhile degrades to host greedy.

The device is explicit: `SolverServer(..., device=None)` and `main(argv,
device=None)` serve from the card and raise without one; `device="cpu"`
runs the kernels' plain versions. A DEGRADED card at boot, or a warmup that
fails, ends the server: it never serves from the CPU behind the card's back.
The `solver` strings of a response ("tpu-cost", "tpu-ffd", "host-greedy",
"empty", "error") are the wire contract and keep the reference's names.

Run: python -m karpenter_tpu_torch.solver_service.server --port 9090
"""

from __future__ import annotations

import argparse
import threading
import time
from concurrent import futures
from typing import Optional

import grpc
import numpy as np

from karpenter_tpu_torch.models import solver as solver_models
from karpenter_tpu_torch.ops import ffd, native
from karpenter_tpu_torch.solver_service import solver_pb2 as pb
from karpenter_tpu_torch.solver_service import wire
from karpenter_tpu_torch.utils import logging as klog
from karpenter_tpu_torch.utils.tracing import TRACE_METADATA_KEY, TRACER

log = klog.named("solver-server")


def _trace_from_context(context) -> Optional[str]:
    """The batch trace id the client rode in on the RPC metadata, or None.
    Request-scoped stream contexts (no invocation_metadata) read as None —
    the enclosing stream handler already entered the trace."""
    metadata_fn = getattr(context, "invocation_metadata", None)
    if metadata_fn is None:
        return None
    for key, value in metadata_fn():
        if key == TRACE_METADATA_KEY:
            return value
    return None


class _RequestAbort(Exception):
    def __init__(self, code, details):
        super().__init__(details)
        self.code = code
        self.details = details


class _RequestScopedContext:
    """abort() raises instead of killing the stream: one malformed request in
    a SolveStream batch must not tear down every other in-flight response and
    trip the client's 30s blackout + whole-batch fallback."""

    def abort(self, code, details):
        raise _RequestAbort(code, details)


def _error_response(detail: str) -> pb.SolveResponse:
    """Per-request failure marker inside a stream: the client host-solves
    this item and keeps the rest of the batch."""
    log.warning("stream request failed, marking for client fallback: %s", detail)
    response = pb.SolveResponse()
    response.solver = "error"
    response.fallback = True
    return response


def _host_rounds(vectors, counts, capacity, total, quirk):
    """Compiled-host FFD with pure-Python fallback — the no-accelerator path."""
    result = native.ffd_pack_rounds(
        vectors, counts.astype(np.int64), capacity, total, quirk=quirk
    )
    if result is not None:
        return result
    return ffd.pack_rounds_dense(vectors, counts, capacity, total, quirk=quirk)


def _encode_rounds(response, rounds, options_by_fill=None):
    """Fill Round/OptionSet messages; option sets dedup by fill bytes."""
    set_index: dict = {}
    for t, fill, repl in rounds:
        option_set = -1
        if options_by_fill is not None:
            # Key from the solver's own fill array (kernel fills are i32, LP
            # fills i64) BEFORE widening for the wire.
            key = fill.tobytes()
            option_set = set_index.get(key)
            if option_set is None:
                type_indices, pool_rows = options_by_fill[key]
                message = pb.OptionSet(
                    type_indices=list(type_indices),
                    has_pools=pool_rows is not None,
                )
                if pool_rows is not None:
                    for ti, zi, price in pool_rows:
                        message.pools.add(type_index=ti, zone_index=zi, price=price)
                option_set = len(response.option_sets)
                response.option_sets.append(message)
                set_index[key] = option_set
        response.rounds.add(
            type_index=int(t),
            fill=wire.encode_tensor(fill.astype(np.int64)),
            replication=int(repl),
            option_set=option_set,
        )


class _Handler:
    """RPC implementations. gRPC handlers are hand-wired generic method
    handlers (no generated stubs — grpc_tools isn't vendored)."""

    def __init__(self, device):
        self.device = device
        self.solves = 0
        self._lock = threading.Lock()
        # Flips after boot warmup precompiles the bucket ladder; readiness
        # probes (client.healthy / k8s) gate traffic on it so the first
        # production batch never pays a multi-second jit compile.
        self.warmed = threading.Event()

    def solve(self, request: pb.SolveRequest, context) -> pb.SolveResponse:
        with TRACER.trace(_trace_from_context(context)), TRACER.span(
            "solver.serve", mode=request.mode or "cost"
        ):
            return self._solve(request, context)

    def _solve(self, request: pb.SolveRequest, context) -> pb.SolveResponse:
        start = time.perf_counter()
        vectors = wire.decode_tensor(request.group_vectors)
        counts = wire.decode_tensor(request.group_counts)
        capacity = wire.decode_tensor(request.capacity)
        total = wire.decode_tensor(request.total)
        prices = wire.decode_tensor(request.prices)

        response = pb.SolveResponse()
        num_groups = int(vectors.shape[0])
        if num_groups == 0 or capacity.shape[0] == 0:
            # Nothing to pack / nothing to pack onto: every pod is
            # unschedulable, mirroring pack_groups' empty-fleet path.
            response.solver = "empty"
            response.unschedulable.CopyFrom(
                wire.encode_tensor(counts.astype(np.int64))
            )
            response.solve_ms = (time.perf_counter() - start) * 1e3
            return response

        mode = request.mode or "cost"
        if mode == "cost":
            pool_prices = wire.decode_tensor(request.pool_prices)
            dense = solver_models.cost_solve_dense(
                vectors,
                counts,
                capacity,
                total,
                prices,
                pool_prices,
                lp_steps=int(request.lp_steps) or 300,
                device=self.device,
            )
            unschedulable = self._encode_cost(
                response, dense, vectors, counts, capacity, total
            )
        elif mode == "ffd":
            rounds, unschedulable, used = self._ffd_rounds(
                vectors, counts, capacity, total, prices, request.quirk,
                device=self.device,
            )
            response.solver = used
            response.fallback = used != "tpu-ffd"
            _encode_rounds(response, rounds)
        else:
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT, f"unknown mode {mode!r}"
            )

        response.unschedulable.CopyFrom(
            wire.encode_tensor(
                np.asarray(unschedulable, dtype=np.int64)  # vet: host-array(post-fetch counts)
            )
        )
        response.solve_ms = (time.perf_counter() - start) * 1e3
        with self._lock:
            self.solves += 1
        return response

    @staticmethod
    def _encode_cost(response, dense, vectors, counts, capacity, total):
        """Encode a cost-solve outcome (host-greedy fallback when dense is
        None); returns the unschedulable counts for the caller to attach."""
        if dense is None:
            rounds, unschedulable = _host_rounds(
                vectors, counts, capacity, total, quirk=True
            )
            response.solver = "host-greedy"
            response.fallback = True
            _encode_rounds(response, rounds)
            return unschedulable
        response.solver = "tpu-cost"
        _encode_rounds(response, dense.rounds, dense.options)
        return dense.unschedulable

    def solve_stream(self, request_iterator, context):
        """SolveStream entry: enter the client's batch trace (RPC metadata)
        for the whole stream — ingest, serve span, and every per-item
        solve record under the one id the host minted."""
        with TRACER.trace(_trace_from_context(context)):
            yield from self._solve_stream(request_iterator, context)

    def _ingest_stream(self, request_iterator):
        """Dispatch phase of the pipelined stream: every cost-mode request's
        kernel launched (and its compacted device->host copy staged) before
        any result is fetched. Returns (ready, pending, order) — inline
        answers by slot, dispatched work in arrival order, total count."""
        ready = {}  # order -> finished SolveResponse
        pending = []  # (order, start, fused, arrays..., pool_prices)
        order = 0
        for request in request_iterator:
            mode = request.mode or "cost"
            # Route on the shape fields alone — full tensor decode only on
            # the path that consumes the data.
            num_groups = (list(request.group_vectors.shape) or [0])[0]
            num_types = (list(request.capacity.shape) or [0])[0]
            try:
                if mode != "cost" or num_groups == 0 or num_types == 0:
                    # Request-scoped context: an unknown mode aborts THIS
                    # request only, not the whole stream.
                    ready[order] = self.solve(request, _RequestScopedContext())
                elif solver_models.host_solve_enabled(
                    int(np.sum(wire.decode_tensor(request.group_counts))),
                    batched=True,
                    device=self.device,
                ):
                    # Small schedule: the unary path's adaptive host solve
                    # answers inline in milliseconds — no reason to ride
                    # the batched device fetch.
                    ready[order] = self.solve(request, _RequestScopedContext())
                else:
                    start = time.perf_counter()
                    vectors = wire.decode_tensor(request.group_vectors)
                    counts = wire.decode_tensor(request.group_counts)
                    capacity = wire.decode_tensor(request.capacity)
                    total = wire.decode_tensor(request.total)
                    prices = wire.decode_tensor(request.prices)
                    pool_prices = wire.decode_tensor(request.pool_prices)
                    fused = solver_models.cost_solve_dispatch(
                        vectors,
                        counts,
                        capacity,
                        total,
                        prices,
                        int(request.lp_steps) or 300,
                        device=self.device,
                    )
                    solver_models.plan_start_fetch(fused)
                    pending.append(
                        (order, start, fused, vectors, counts, capacity, total,
                         prices, pool_prices)
                    )
            except _RequestAbort as err:
                ready[order] = _error_response(err.details)
            except Exception as err:  # noqa: BLE001 — isolate malformed input
                ready[order] = _error_response(repr(err))
            order += 1
        return ready, pending, order

    def _solve_stream(self, request_iterator, context):
        """Batched, pipelined solve: dispatch every cost-mode request's
        kernel before fetching any result (_ingest_stream), then yield
        responses IN REQUEST ORDER as each finishes — the client starts
        decoding/binding schedule N while schedules N+1.. are still
        computing and copying on the device. Each per-item fetch finds its
        payload already staged (plan_start_fetch at dispatch), so the
        stream still pays ~one round trip of latency, not one per item.
        Non-cost / empty requests take the unary path inline."""
        ready, pending, order = self._ingest_stream(request_iterator)
        # Column-LP mix candidates: host work running in a worker thread
        # CONCURRENTLY with the (staged) fetches — the same _HostOverlap the
        # in-process paths use, consumed per item so request N's response
        # doesn't wait on request N+1's mix candidate. Best-effort per slot;
        # pool matrices arrive off the wire, so wait() cannot raise here.
        # The finish phase stays isolated per request: a poisoned fetch or
        # finish failure marks only ITS slot for client fallback — completed
        # responses always reach the client, and the responses already
        # yielded were on the wire before the failure happened.
        overlap = None
        if pending:
            overlap = solver_models._HostOverlap(
                [
                    (entry[3], entry[4], entry[5], entry[8])
                    for entry in pending
                ]
            ).start()
        next_pending = 0
        with TRACER.span("solver.serve.stream", solves=len(pending)):
            for slot in range(order):
                if slot in ready:
                    yield ready[slot]
                    continue
                k = next_pending
                next_pending += 1
                (_, start, fused, vectors, counts, capacity, total, prices,
                 pool_prices) = pending[k]
                try:
                    overlap.wait(k)
                    plan = solver_models.fetch_plan(fused)
                    response = pb.SolveResponse()
                    dense = solver_models.cost_solve_finish(
                        plan, vectors, counts, capacity, total, prices,
                        pool_prices, mix_plan=overlap.mix_plans[k],
                    )
                    unschedulable = self._encode_cost(
                        response, dense, vectors, counts, capacity, total
                    )
                    response.unschedulable.CopyFrom(
                        wire.encode_tensor(
                            np.asarray(unschedulable, dtype=np.int64)  # vet: host-array(post-fetch counts)
                        )
                    )
                    response.solve_ms = (time.perf_counter() - start) * 1e3
                    with self._lock:
                        self.solves += 1
                except Exception as err:  # noqa: BLE001
                    response = _error_response(repr(err))
                yield response

    @staticmethod
    def _ffd_rounds(vectors, counts, capacity, total, prices, quirk, device=None):
        """Reference-parity FFD on `device` (K2, or K2q with quirk), host
        fallback on overflow."""
        num_groups = int(vectors.shape[0])
        rounds = solver_models._to_host(
            solver_models.run_kernel_dense(
                vectors, counts, capacity, total, prices, mode="ffd", quirk=quirk,
                device=device,
            )
        )
        if bool(rounds.overflow):
            round_list, unschedulable = _host_rounds(
                vectors, counts, capacity, total, quirk=quirk
            )
            return round_list, unschedulable, "host-greedy"
        return (
            solver_models._kernel_rounds_to_list(rounds, num_groups),
            rounds.unschedulable[:num_groups],
            "tpu-ffd",
        )

    def health(self, request: pb.HealthRequest, context) -> pb.HealthResponse:
        """platform "gpu" on the card and "cpu" on the CPU; device_count is
        every device of the serving type across the process group (the
        reference's jax.device_count())."""
        from karpenter_tpu_torch.parallel.mesh import mesh_devices

        kind = self.device.type
        return pb.HealthResponse(
            status="ok" if self.warmed.is_set() else "warming",
            platform="gpu" if kind == "cuda" else kind,
            device_count=len(mesh_devices(kind)),
            solves=self.solves,
        )

    def health_v1_check(self, request: bytes, context) -> bytes:
        """Standard grpc.health.v1.Health/Check, hand-encoded (no
        grpc_health dependency): HealthCheckResponse{status} where
        SERVING=1 / NOT_SERVING=2 wire-encodes as field-1 varint. This is
        what a Kubernetes gRPC readinessProbe calls, so the probe gates pod
        traffic on the boot warmup — the consumer of the 'warming' state."""
        return b"\x08\x01" if self.warmed.is_set() else b"\x08\x02"


class SolverServer:
    """In-process harness around the gRPC server — tests start it on port 0
    and read back the bound port; __main__ serves forever. `device` is
    where the solves run: None is the card (raises without one), "cpu" the
    kernels' plain versions. A warmup that raises stops the server and
    keeps its error in warmup_error."""

    def __init__(
        self, port: int = 0, host: str = "127.0.0.1", workers: int = 4, device=None
    ):
        from karpenter_tpu_torch.device import resolve_device

        self.device = resolve_device(device)
        self.warmup_error: Optional[BaseException] = None
        self.handler = _Handler(self.device)
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=workers))
        method_handlers = {
            "Solve": grpc.unary_unary_rpc_method_handler(
                self.handler.solve,
                request_deserializer=pb.SolveRequest.FromString,
                response_serializer=pb.SolveResponse.SerializeToString,
            ),
            "SolveStream": grpc.stream_stream_rpc_method_handler(
                self.handler.solve_stream,
                request_deserializer=pb.SolveRequest.FromString,
                response_serializer=pb.SolveResponse.SerializeToString,
            ),
            "Health": grpc.unary_unary_rpc_method_handler(
                self.handler.health,
                request_deserializer=pb.HealthRequest.FromString,
                response_serializer=pb.HealthResponse.SerializeToString,
            ),
        }
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(wire.SERVICE, method_handlers),)
        )
        identity = lambda raw: raw  # noqa: E731 — hand-encoded wire bytes
        self._server.add_generic_rpc_handlers(
            (
                grpc.method_handlers_generic_handler(
                    "grpc.health.v1.Health",
                    {
                        "Check": grpc.unary_unary_rpc_method_handler(
                            self.handler.health_v1_check,
                            request_deserializer=identity,
                            response_serializer=identity,
                        )
                    },
                ),
            )
        )
        self.port = self._server.add_insecure_port(f"{host}:{port}")

    def start(self, warmup: bool = True) -> "SolverServer":
        self._server.start()
        log.info("solver sidecar listening on :%d", self.port)
        if warmup:
            threading.Thread(
                target=self._warmup, name="solver-warmup", daemon=True
            ).start()
        else:
            self.handler.warmed.set()
        return self

    def _warmup(self) -> None:
        """Precompile the bucket ladder (and, via cost_solve_dispatch's mesh
        auto-selection, the sharded kernel on multi-chip runtimes) BEFORE
        health reports ok, so warmup_compile_s is paid at boot, never by a
        live batch (models/warmup.py — shared with the in-process Manager).

        Ref: the reference has no compile step at all — its first batch is
        never seconds late; with this, neither is ours (VERDICT r3 §missing
        3). Serving starts immediately; readiness (health != ok) keeps
        traffic away until the ladder is warm.

        A warmup that raises (on the card: a kernel that does not build or
        launch, a calibration that fails) stops the server with its error in
        warmup_error: health never reports ok, and no solve is served by a
        device that could not warm."""
        from karpenter_tpu_torch.models.warmup import warmup_ladder

        try:
            warmup_ladder(device=self.device)
        except Exception as error:  # noqa: BLE001 — the verdict is the device's
            log.exception("solver warmup failed on %s; stopping the sidecar", self.device)
            self.warmup_error = error
            self.stop()
            return
        self.handler.warmed.set()

    def stop(self, grace: Optional[float] = None) -> None:
        self._server.stop(grace).wait()

    def wait(self) -> None:
        self._server.wait_for_termination()


def main(argv=None, device=None) -> None:
    """Serve until SIGTERM or SIGINT on `device` (None: the card). Raises,
    so the process exits non-zero, on a DEGRADED card at boot or a warmup
    that failed."""
    from karpenter_tpu_torch.utils.gctune import tune_gc

    tune_gc()  # long-running service: GOGC-style collector headroom
    parser = argparse.ArgumentParser(description="karpenter-tpu solver sidecar")
    parser.add_argument("--port", type=int, default=9090)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--workers", type=int, default=4)
    args = parser.parse_args(argv)
    from karpenter_tpu_torch.device import resolve_device

    device = resolve_device(device)
    # One device-liveness verdict before ANY in-process device touch (the
    # distributed init and the warmup ladder below both touch the card): a
    # wedged card is refused with its reason, never served from the CPU.
    from karpenter_tpu_torch.utils import backend_health

    boot_verdict = backend_health.ensure_backend(device)
    if boot_verdict.state == backend_health.DEGRADED:
        raise RuntimeError(
            f"the card failed its liveness probe at boot: {boot_verdict.reason}"
        )
    # Multi-process slice (KARPENTER_COORDINATOR/_NUM_PROCESSES/_PROCESS_ID):
    # join the process group BEFORE the first solve, so mesh_devices() is
    # the global set and cost_solve_dispatch selects the mesh spanning every
    # process's devices. Rank 0 serves RPCs and replicates each solve to the
    # group; other ranks mirror its dispatches in the follower loop
    # (parallel/spmd.py). A partial environment raises here.
    from karpenter_tpu_torch.parallel import multihost

    distributed = multihost.init_distributed(
        backend=multihost.backend_for(device.type)
    )
    if distributed and multihost.process_index() > 0:
        from karpenter_tpu_torch.parallel import spmd

        spmd.follower_loop(device)
        multihost.shutdown_distributed()
        return
    server = SolverServer(
        port=args.port, host=args.host, workers=args.workers, device=device
    )
    server.start()
    # Terminate on SIGTERM (Kubernetes pod shutdown) as well as SIGINT, so
    # the finally block actually runs under a rollout and the followers get
    # their OP_STOP instead of timing out in a dead collective.
    import signal

    stop = threading.Event()
    for signum in (signal.SIGTERM, signal.SIGINT):
        signal.signal(signum, lambda *_: stop.set())
    try:
        # A server stopped by its failed warmup ends the process too.
        while not stop.wait(timeout=1.0) and server.warmup_error is None:
            pass
        server.stop(grace=5.0)
    finally:
        if distributed:
            from karpenter_tpu_torch.parallel import spmd

            spmd.lead_stop()
            multihost.shutdown_distributed()
    if server.warmup_error is not None:
        raise RuntimeError("the solver warmup failed") from server.warmup_error


if __name__ == "__main__":
    main()
