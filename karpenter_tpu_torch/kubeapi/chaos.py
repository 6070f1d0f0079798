"""ChaosTransport — fault injection between the kube client and any
Transport (the socket-free fake-apiserver DirectTransport or the real
HttpTransport alike).

Ref: the reference survives a degraded apiserver via client-go's retrying,
rate-limited reflector stack (cmd/controller/main.go:66-69); this wrapper
exists to *prove* the analogous envelope here (kubeapi/client.py) actually
absorbs every fault class instead of assuming it. Sites and rates come from
utils/faultpoints (armed by tests and `make chaos-smoke`); with nothing
armed every call is a straight passthrough plus one dict read.

Request faults (site ``api.request.<verb>``):

- ``latency``       sleep delay_s through the Clock, then forward
- ``reset``         TransportError(reset) WITHOUT forwarding — the request
                    never reached the server (connection refused/reset)
- ``timeout``       forward the request, then TransportError(timeout) — the
                    server may have COMMITTED the write and the response
                    died; the fault class the per-verb idempotency story
                    exists for
- ``throttle``      429 Status carrying details.retryAfterSeconds, without
                    forwarding
- ``server-error``  5xx Status (fault.status) without forwarding
- ``conflict``      409 Status without forwarding — from the client's view
                    this is exactly the delete-between-409-and-GET race
                    shape (a 409 for an object a subsequent GET cannot find)

Watch faults (``watch.open`` / ``watch.event``):

- ``tear``        TransportError mid-open / mid-stream (socket died)
- ``gone``        ApiError 410 at open (compacted resume point)
- ``latency``     delayed delivery
- ``duplicate``   the same event delivered twice (at-least-once watch)
- ``reorder``     event held and delivered AFTER its successor
- ``drop-410``    event silently swallowed, then the stream errors 410 —
                  the only cure is the re-list rebuild path, which is the
                  point of the fault
"""

from __future__ import annotations

import copy
from typing import Iterator, Optional, Tuple

from karpenter_tpu_torch.kubeapi.client import ApiError, Transport, TransportError
from karpenter_tpu_torch.utils import faultpoints
from karpenter_tpu_torch.utils.clock import Clock, SYSTEM_CLOCK


def _status_body(code: int, reason: str, message: str, **details) -> dict:
    body = {"kind": "Status", "code": code, "reason": reason, "message": message}
    if details:
        body["details"] = dict(details)
    return body


# Literal site names per HTTP method (LIST is a collection GET) — spelled
# out, not an f-string, so the chaos site-inventory lint
# (tests/test_chaos.py) can hold these literals to faultpoints.SITES the
# same way the crashpoint lint pins crash sites to instrumented code.
SITE_BY_METHOD = {
    "GET": "api.request.get",
    "POST": "api.request.post",
    "PUT": "api.request.put",
    "PATCH": "api.request.patch",
    "DELETE": "api.request.delete",
}


class ChaosTransport(Transport):
    """Wrap `inner`, consulting faultpoints on every request and delivered
    watch event. Faults are ordinary Exceptions / status codes — they must
    travel the retry and reconnect paths, never punch through them."""

    def __init__(self, inner: Transport, clock: Optional[Clock] = None):
        self.inner = inner
        self.clock = clock or SYSTEM_CLOCK

    # --- requests -----------------------------------------------------------

    def request(self, method, path, query="", body=None, timeout_s=None) -> Tuple[int, dict]:
        fault = faultpoints.draw(SITE_BY_METHOD.get(method, "api.request.get"))
        if fault is None:
            return self.inner.request(method, path, query, body, timeout_s=timeout_s)
        if fault.kind == "latency":
            self.clock.sleep(fault.delay_s)
            return self.inner.request(method, path, query, body, timeout_s=timeout_s)
        if fault.kind == "reset":
            raise TransportError(
                f"injected connection reset before {method} {path}",
                reason="reset",
            )
        if fault.kind == "timeout":
            # The dangerous half of a timeout: the server did the work, the
            # response never arrived.
            self.inner.request(method, path, query, body, timeout_s=timeout_s)
            raise TransportError(
                f"injected timeout after {method} {path} executed",
                reason="timeout",
            )
        if fault.kind == "throttle":
            return 429, _status_body(
                429, "TooManyRequests", "injected throttle",
                retryAfterSeconds=fault.retry_after_s,
            )
        if fault.kind == "server-error":
            return fault.status, _status_body(
                fault.status, "InternalError", "injected server error"
            )
        # conflict
        return 409, _status_body(409, "Conflict", "injected conflict")

    # --- watch streams ------------------------------------------------------

    def stream(self, path, query="") -> Iterator[dict]:
        fault = faultpoints.draw("watch.open")
        if fault is not None:
            if fault.kind == "gone":
                raise ApiError(410, "injected watch expiry")
            raise TransportError(
                f"injected watch-open reset for {path}", reason="reset"
            )
        inner = self.inner.stream(path, query)
        held: Optional[dict] = None  # reorder buffer
        try:
            for event in inner:
                fault = faultpoints.draw("watch.event")
                if fault is not None:
                    if fault.kind == "reorder":
                        if held is not None:
                            yield held  # one deep: release the older hold
                        held = event  # delivered after its successor
                        continue
                    if fault.kind == "tear":
                        # A torn socket loses in-flight data (any held event
                        # included); the reconnect replays from the last rv.
                        raise TransportError(
                            "injected watch stream tear", reason="reset"
                        )
                    if fault.kind == "drop-410":
                        # Silent drop, then the compaction verdict: the
                        # client cannot resume past the hole — only the
                        # re-list rebuild converges.
                        raise ApiError(410, "injected expiry after dropped event")
                    if fault.kind == "latency":
                        self.clock.sleep(fault.delay_s)
                yield event
                if fault is not None and fault.kind == "duplicate":
                    yield copy.deepcopy(event)
                if held is not None:
                    yield held  # the reorder: successor first, held second
                    held = None
            if held is not None:
                # Stream ended with an event still held: deliver it late
                # rather than silently losing it (reorder, not drop).
                yield held
        finally:
            close = getattr(inner, "close", None)
            if close is not None:
                close()

    def close(self) -> None:
        self.inner.close()
