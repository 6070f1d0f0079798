"""Minimal Kubernetes REST client.

Ref: cmd/controller/main.go:66-69 — the reference builds a rate-limited
client-go client (200 qps / 300 burst token bucket). Here the same envelope
over a pluggable Transport:

- `HttpTransport` speaks real HTTPS to an apiserver with bearer-token auth
  and the cluster CA (in-cluster serviceaccount files by default).
- tests inject a direct-call transport into the fake apiserver (no sockets),
  and exercise the HTTP path separately.
- `ChaosTransport` (kubeapi/chaos.py) wraps either and injects faults at
  named faultpoint sites — the substrate `make chaos-smoke` storms with.

Only the verbs the controllers use exist: get/list/create/update/patch/
delete, the binding and eviction subresources, and line-delimited watch
streams.

Every request crosses ONE retry envelope (`KubeClient._request_enveloped`,
pinned by the vet transport-discipline checker): per-verb deadlines, capped
exponential backoff with jitter through the Clock abstraction, Retry-After
honored on 429. Idempotency rationale per verb (docs/design/chaos.md):

- GET/LIST/DELETE/PATCH/PUT are retried freely — re-executing any of them
  converges (DELETE answers 404, PATCH re-merges, PUT either lands or
  answers a 409 CAS conflict the caller already handles).
- POST (create/binding/eviction) is retried too, but its safety leans on
  the strict-409 semantics the write paths already carry: a retried create
  whose first attempt committed answers 409, which callers treat as
  already-exists (node adoption, _create_or_update's GET+PUT, bind_pod's
  bound-to-whom check) — nothing double-creates.

Network faults surface as a typed `TransportError` (retryable) instead of
raw urllib/socket exceptions, so callers — and the envelope — can tell a
connection reset from an apiserver verdict (`ApiError`).
"""

from __future__ import annotations

import http.client
import json
import random
import ssl
import threading
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Dict, Iterator, Optional, Tuple

from karpenter_tpu_torch.utils.backoff import capped_backoff_s
from karpenter_tpu_torch.utils.clock import Clock, SYSTEM_CLOCK
from karpenter_tpu_torch.utils.metrics import REGISTRY

SERVICEACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

# Control-plane client health: a rising retry rate is the first symptom of
# apiserver degradation (docs/operations.md, "API degradation" runbook).
KUBE_API_RETRY_TOTAL = REGISTRY.counter(
    "kube_api_retry_total",
    "Kube API request retries by verb and fault reason",
    ["verb", "reason"],
)
KUBE_API_REQUEST_DURATION = REGISTRY.histogram(
    "kube_api_request_duration_seconds",
    "Kube API request latency per attempt (failed attempts included)",
    ["verb"],
)
KUBE_API_LANE_WAIT = REGISTRY.histogram(
    "kube_api_lane_wait_seconds",
    "Time a request waited for a rate-limiter token, by priority lane "
    "(critical lane waits spiking means the reserve is sized wrong)",
    ["lane"],
)

# --- priority lanes ----------------------------------------------------------
#
# The kube analogue of API Priority & Fairness, client-side: the token
# bucket keeps a small reserve only CRITICAL requests may drain, so a bulk
# LIST/bind storm saturating the limiter cannot park the control-plane
# heartbeat traffic behind it. Critical today: lease renew/acquire (losing
# the lease mid-storm deposes the leader and trips the write fence),
# node heartbeat status writes, and finalizer removal/node deletes (a
# stuck drain holds capacity). The lane rides a thread-local so call
# sites stay signature-free: kubeapi/cluster.py wraps its critical verbs
# in `with critical_lane():` and every nested request inherits it.

# Fraction of the bucket's burst reserved for the critical lane.
CRITICAL_RESERVE_FRACTION = 0.1

_lane_local = threading.local()


def current_lane() -> str:
    """The calling thread's lane: "critical" inside a critical_lane() block,
    else "bulk"."""
    return getattr(_lane_local, "lane", "bulk")


class critical_lane:
    """Context manager marking every kube request on this thread critical
    (reserved-token lane) for the duration. Re-entrant; restores the prior
    lane on exit so a critical section nested in another stays critical."""

    def __enter__(self) -> "critical_lane":
        self._prior = getattr(_lane_local, "lane", "bulk")
        _lane_local.lane = "critical"
        return self

    def __exit__(self, *exc_info) -> None:
        _lane_local.lane = self._prior


class ApiError(Exception):
    """The apiserver answered with a non-2xx verdict."""

    def __init__(self, status: int, message: str = ""):
        super().__init__(f"apiserver {status}: {message}")
        self.status = status
        self.message = message


class TransportError(Exception):
    """A network-layer fault: the request may or may not have reached the
    server (a timeout can follow a committed write). `retryable` says the
    fault is transient; `reason` labels the retry metric
    (timeout | reset | network | idle-timeout)."""

    def __init__(self, message: str, retryable: bool = True, reason: str = "network"):
        super().__init__(message)
        self.retryable = retryable
        self.reason = reason


def _as_transport_error(error: Exception) -> TransportError:
    """Classify a raw urllib/socket/http.client fault. URLError wraps its
    cause in .reason; unwrap so a connection reset inside a URLError still
    labels as a reset."""
    cause = error
    if isinstance(error, urllib.error.URLError) and isinstance(
        error.reason, Exception
    ):
        cause = error.reason
    if isinstance(cause, TimeoutError):  # socket.timeout is an alias
        reason = "timeout"
    elif isinstance(cause, (ConnectionResetError, ConnectionAbortedError,
                            BrokenPipeError, http.client.RemoteDisconnected)):
        reason = "reset"
    else:
        reason = "network"
    return TransportError(f"{type(cause).__name__}: {cause}", reason=reason)


def _status_code(obj: dict) -> int:
    """The integer .code of an in-band Status object, 0 when unparsable."""
    try:
        return int(obj.get("code", 0) or 0)
    except (TypeError, ValueError):
        return 0


class Transport:
    """request() returns (status, parsed-JSON body); stream() yields parsed
    JSON objects from a line-delimited watch response until closed.
    Network-layer faults raise TransportError; HTTP-layer error Statuses on
    a stream open raise ApiError. `timeout_s` is the per-request deadline
    the retry envelope selects per verb (socketless transports ignore it)."""

    def request(
        self,
        method: str,
        path: str,
        query: str = "",
        body: Optional[dict] = None,
        timeout_s: Optional[float] = None,
    ) -> Tuple[int, dict]:
        raise NotImplementedError

    def stream(self, path: str, query: str = "") -> Iterator[dict]:
        raise NotImplementedError

    def close(self) -> None:
        """Terminate open streams so watch pumps can exit."""


class HttpTransport(Transport):
    def __init__(
        self,
        base_url: str,
        token: str = "",
        ca_file: Optional[str] = None,
        insecure: bool = False,
        timeout_s: float = 30.0,
        watch_idle_s: float = 300.0,
    ):
        self.base_url = base_url.rstrip("/")
        self.token = token
        self.timeout_s = timeout_s
        # Watch read-deadline: an apiserver that stops sending bytes without
        # closing the connection would otherwise hang the watch pump forever
        # (the stream used to open with timeout=None). Each blocking read is
        # bounded by this; a quiet-too-long stream tears with a retryable
        # idle-timeout TransportError and the pump reconnects from its last
        # rv. Must exceed the server's bookmark cadence (~1/min) by a wide
        # margin so healthy-idle watches don't churn.
        self.watch_idle_s = watch_idle_s
        if insecure:
            self.ssl_context: Optional[ssl.SSLContext] = ssl._create_unverified_context()
        elif ca_file:
            self.ssl_context = ssl.create_default_context(cafile=ca_file)
        else:
            self.ssl_context = None

    @classmethod
    def in_cluster(cls) -> "HttpTransport":
        """The in-cluster configuration every kube client defaults to:
        serviceaccount token + CA against kubernetes.default.svc."""
        with open(f"{SERVICEACCOUNT_DIR}/token") as f:
            token = f.read().strip()
        return cls(
            "https://kubernetes.default.svc",
            token=token,
            ca_file=f"{SERVICEACCOUNT_DIR}/ca.crt",
        )

    @classmethod
    def for_store(cls, store: str) -> Optional["HttpTransport"]:
        """THE --cluster-store selection, shared by every binary (controller,
        webhook): "memory" -> None (in-memory store), "incluster" ->
        serviceaccount transport, anything else -> an apiserver URL with
        KUBE_TOKEN / KUBE_CA_FILE / KUBE_INSECURE env credentials."""
        if store == "memory":
            return None
        if store == "incluster":
            return cls.in_cluster()
        import os

        return cls(
            store,
            token=os.environ.get("KUBE_TOKEN", ""),
            ca_file=os.environ.get("KUBE_CA_FILE") or None,
            insecure=os.environ.get("KUBE_INSECURE", "") == "true",
        )

    def _request(self, method: str, url: str, body: Optional[dict], timeout: float):
        data = None if body is None else json.dumps(body).encode()
        request = urllib.request.Request(url, data=data, method=method)
        request.add_header("Accept", "application/json")
        if body is not None:
            content_type = "application/json"
            if method == "PATCH":
                content_type = "application/merge-patch+json"
            request.add_header("Content-Type", content_type)
        if self.token:
            request.add_header("Authorization", f"Bearer {self.token}")
        return urllib.request.urlopen(
            request, timeout=timeout, context=self.ssl_context
        )

    def request(self, method, path, query="", body=None, timeout_s=None):
        url = self.base_url + path + (f"?{query}" if query else "")
        try:
            with self._request(
                method, url, body, timeout_s or self.timeout_s
            ) as response:
                payload = response.read()
                return response.status, json.loads(payload) if payload else {}
        except urllib.error.HTTPError as error:
            detail = error.read().decode(errors="replace")
            try:
                parsed = json.loads(detail)
            except (ValueError, json.JSONDecodeError):
                parsed = {"message": detail}
            # Surface the throttle header where the apiserver used it instead
            # of (or in addition to) Status.details — the retry envelope reads
            # details.retryAfterSeconds.
            retry_after = error.headers.get("Retry-After") if error.headers else None
            if retry_after and isinstance(parsed, dict):
                try:
                    parsed.setdefault("details", {}).setdefault(
                        "retryAfterSeconds", float(retry_after)
                    )
                except (TypeError, ValueError):
                    pass
            return error.code, parsed
        except (urllib.error.URLError, http.client.HTTPException, OSError) as error:
            # Raw network faults (connection reset/refused, socket timeout,
            # torn keep-alive) become a typed retryable TransportError — a
            # bare URLError escaping into a controller thread was the
            # pre-chaos failure mode.
            raise _as_transport_error(error) from error

    def stream(self, path, query=""):
        url = self.base_url + path + (f"?{query}" if query else "")
        try:
            # Read-deadline, not a request deadline: timeout bounds each
            # blocking socket read, so a stalled-but-open stream tears after
            # watch_idle_s instead of hanging the pump forever.
            response = self._request("GET", url, None, timeout=self.watch_idle_s)
        except urllib.error.HTTPError as error:
            # A watch opened with an expired resourceVersion answers 410 Gone
            # at the HTTP layer; surface it so the reflector can re-LIST.
            detail = error.read().decode(errors="replace")
            raise ApiError(error.code, detail) from None
        except (urllib.error.URLError, http.client.HTTPException, OSError) as error:
            raise _as_transport_error(error) from error
        try:
            for line in self._stream_lines(response):
                line = line.strip()
                if line:
                    yield json.loads(line)
        finally:
            response.close()

    @staticmethod
    def _stream_lines(response):
        """Iterate the response, mapping mid-stream socket faults (incl. the
        idle-timeout read deadline) to TransportError so the watch pump's
        reconnect path — not a raw socket.timeout — sees them."""
        while True:
            try:
                line = response.readline()
            except (TimeoutError, OSError, http.client.HTTPException) as error:
                mapped = _as_transport_error(error)
                if mapped.reason == "timeout":
                    raise TransportError(
                        "watch stream idle past the read deadline",
                        reason="idle-timeout",
                    ) from error
                raise mapped from error
            if not line:
                return
            yield line


class RateLimiter:
    """Token bucket matching the reference's client-side throttle
    (ref: cmd/controller/main.go:67, options qps/burst), with a critical
    reserve: bulk callers may not drain the bucket below `critical_reserve`
    tokens — only critical-lane callers take the bucket to zero, so a bulk
    storm's worst case delays a lease renew by refill arithmetic, never by
    the storm's own queue."""

    def __init__(
        self,
        qps: float,
        burst: int,
        clock: Optional[Clock] = None,
        critical_reserve: int = 0,
    ):
        self.qps = qps
        self.burst = burst
        # Reserve clamped inside the bucket: a reserve >= burst would
        # starve bulk entirely.
        self.critical_reserve = max(0, min(int(critical_reserve), burst - 1))
        self.clock = clock or SYSTEM_CLOCK
        self._tokens = float(burst)  # vet: guarded-by(self._lock)
        self._last = self.clock.monotonic()  # vet: guarded-by(self._lock)
        self._lock = threading.Lock()

    # Shortest throttle sleep: refill arithmetic can leave a sub-ULP token
    # deficit (tokens + (deficit/qps)*qps rounds just below the grant line),
    # and the matching sub-nanosecond sleep is absorbed by double-precision
    # rounding on any clock with a large absolute value (1e6 + 1e-18 == 1e6)
    # — the refill never lands and wait() livelocks. One scheduler quantum
    # is the floor; the overshoot is noise against a >= 1-token wait.
    MIN_SLEEP_S = 0.0005

    def wait(self, critical: bool = False) -> float:
        """Block until a token is available in the caller's lane; returns
        the seconds slept (0.0 for an unthrottled call) so the envelope can
        publish per-lane wait."""
        floor = 0.0 if critical else float(self.critical_reserve)
        waited = 0.0
        while True:
            with self._lock:
                now = self.clock.monotonic()
                self._tokens = min(
                    self.burst, self._tokens + (now - self._last) * self.qps
                )
                self._last = now
                if self._tokens >= floor + 1.0:
                    self._tokens -= 1.0
                    return waited
                needed = max(
                    (floor + 1.0 - self._tokens) / self.qps, self.MIN_SLEEP_S
                )
            # Deliberately OUTSIDE the bucket lock (the blocking-under-lock
            # checker enforces this shape): a throttled caller must not hold
            # up token refill arithmetic for everyone else while it sleeps.
            self.clock.sleep(needed)
            waited += needed


# Per-verb request deadlines (the envelope passes these to the transport).
# LIST gets the long deadline — a 50k-pod collection takes real time to
# serialize; point reads and writes should fail fast and retry instead.
DEFAULT_VERB_TIMEOUTS_S: Dict[str, float] = {
    "GET": 15.0,
    "LIST": 120.0,
    "POST": 30.0,
    "PUT": 30.0,
    "PATCH": 30.0,
    "DELETE": 30.0,
}

# Statuses the envelope retries with backoff (besides 429-with-Retry-After):
# transient server-side trouble, per client-go's default retry set.
RETRYABLE_STATUSES = frozenset({500, 502, 503, 504})


class RetryPolicy:
    """The envelope's tuning knobs (Options --kube-retry-* flags): attempt
    budget, capped exponential backoff with 0.5x-1.5x jitter, a cap on how
    long a server-sent Retry-After can park the client, and the per-verb
    deadline table."""

    def __init__(
        self,
        max_attempts: int = 5,
        backoff_base_s: float = 0.1,
        backoff_cap_s: float = 5.0,
        retry_after_cap_s: float = 30.0,
        timeouts_s: Optional[Dict[str, float]] = None,
        jitter: Optional[random.Random] = None,
    ):
        self.max_attempts = max(1, max_attempts)
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.retry_after_cap_s = retry_after_cap_s
        self.timeouts_s = dict(DEFAULT_VERB_TIMEOUTS_S)
        if timeouts_s:
            self.timeouts_s.update(timeouts_s)
        self._jitter = jitter or random.Random()

    def timeout_for(self, verb: str) -> float:
        return self.timeouts_s.get(verb, 30.0)

    def backoff_s(self, attempt: int) -> float:
        """Capped exponential with jitter: attempt 1 -> ~base, doubling to
        the cap. Jitter de-synchronizes a fleet of controllers retrying the
        same outage (client-go's DefaultBackoff shape)."""
        base = capped_backoff_s(self.backoff_base_s, self.backoff_cap_s, attempt)
        return base * (0.5 + self._jitter.random())

    def retry_after_s(self, payload: dict) -> Optional[float]:
        """The server-directed delay of a 429, from Status
        details.retryAfterSeconds (where the apiserver mirrors the
        Retry-After header). None when absent — a 429 WITHOUT it is a
        semantic rejection (the eviction subresource's PDB verdict), which
        must surface immediately, not spin in the envelope."""
        details = payload.get("details") if isinstance(payload, dict) else None
        value = (details or {}).get("retryAfterSeconds")
        if value is None:
            return None
        try:
            return min(float(value), self.retry_after_cap_s)
        except (TypeError, ValueError):
            return None


class KubeClient:
    """Typed-path helpers over a Transport. Raises ApiError for non-2xx
    verdicts and TransportError for network faults that outlived the retry
    budget."""

    # Watch reconnect backoff: base doubles per consecutive failed
    # connection (no event received), capped; reset by any delivered event.
    WATCH_BACKOFF_BASE_S = 0.2
    WATCH_BACKOFF_CAP_S = 5.0

    def __init__(
        self,
        transport: Transport,
        qps: float = 200.0,
        burst: int = 300,
        clock: Optional[Clock] = None,
        retry: Optional[RetryPolicy] = None,
        critical_reserve: Optional[int] = None,
    ):
        self.transport = transport
        self.clock = clock or SYSTEM_CLOCK
        if critical_reserve is None:
            critical_reserve = int(burst * CRITICAL_RESERVE_FRACTION)
        self.limiter = RateLimiter(
            qps, burst, self.clock, critical_reserve=critical_reserve
        )
        self.retry = retry or RetryPolicy()

    def _call(self, verb, path, query="", body=None) -> dict:
        status, payload = self._request_enveloped(verb, path, query, body)
        if status >= 300:
            raise ApiError(status, str(payload.get("message", payload)))
        return payload

    def _request_enveloped(
        self, verb: str, path: str, query: str, body: Optional[dict]
    ) -> Tuple[int, dict]:
        """THE retry envelope — the only transport.request caller in the
        tree (vet: transport-discipline). Loops attempts under the rate
        limiter; each failed attempt costs a backoff sleep through the
        Clock. See the module docstring for the per-verb idempotency
        rationale that makes uniform retry safe."""
        method = "GET" if verb == "LIST" else verb
        label = verb.lower()
        lane = current_lane()
        timeout_s = self.retry.timeout_for(verb)
        attempt = 0
        while True:
            attempt += 1
            waited = self.limiter.wait(critical=lane == "critical")
            KUBE_API_LANE_WAIT.observe(waited, lane)
            began = self.clock.monotonic()
            try:
                status, payload = self.transport.request(
                    method, path, query, body, timeout_s=timeout_s
                )
            except TransportError as error:
                KUBE_API_REQUEST_DURATION.observe(
                    self.clock.monotonic() - began, label
                )
                if not error.retryable or attempt >= self.retry.max_attempts:
                    raise
                KUBE_API_RETRY_TOTAL.inc(label, error.reason)
                self._flight_record_retry(label, error.reason, attempt)
                self.clock.sleep(self.retry.backoff_s(attempt))
                continue
            KUBE_API_REQUEST_DURATION.observe(self.clock.monotonic() - began, label)
            delay = self._status_retry_delay(status, payload, attempt)
            if delay is None:
                return status, payload
            reason = "throttled" if status == 429 else "server-error"
            KUBE_API_RETRY_TOTAL.inc(label, reason)
            self._flight_record_retry(label, reason, attempt)
            self.clock.sleep(delay)

    @staticmethod
    def _flight_record_retry(verb: str, reason: str, attempt: int) -> None:
        """Every envelope retry lands in the flight recorder: a breach dump
        must show whether the budget went to a misbehaving apiserver."""
        from karpenter_tpu_torch.utils.obs import RECORDER

        RECORDER.record("retry", verb=verb, reason=reason, attempt=attempt)

    def _status_retry_delay(
        self, status: int, payload: dict, attempt: int
    ) -> Optional[float]:
        """Backoff before retrying `status`, or None to surface it now."""
        if attempt >= self.retry.max_attempts:
            return None
        if status == 429:
            # Honor Retry-After; a 429 without one is a semantic verdict
            # (PDB eviction rejection), not a throttle — never retried here.
            return self.retry.retry_after_s(payload)
        if status in RETRYABLE_STATUSES:
            return self.retry.backoff_s(attempt)
        return None

    # --- generic resource verbs -------------------------------------------

    def get(self, path: str) -> dict:
        return self._call("GET", path)

    def list(self, path: str) -> list:
        return self._call("LIST", path).get("items", [])

    def list_with_rv(self, path: str) -> Tuple[list, str]:
        """LIST returning (items, collection resourceVersion). The collection
        rv is what the first watch must resume from — resuming from '' (or
        from an item rv) loses events in the list-to-watch window."""
        payload = self._call("LIST", path)
        rv = (payload.get("metadata") or {}).get("resourceVersion", "")
        return payload.get("items", []), rv

    def create(self, path: str, obj: dict) -> dict:
        return self._call("POST", path, body=obj)

    def update(self, path: str, obj: dict) -> dict:
        return self._call("PUT", path, body=obj)

    def patch(self, path: str, patch: dict) -> dict:
        return self._call("PATCH", path, body=patch)

    def delete(self, path: str, uid: Optional[str] = None) -> dict:
        """DELETE, optionally UID-preconditioned (DeleteOptions.preconditions):
        the server answers 409 when the live object is a different incarnation
        than the one the caller observed."""
        body = {"preconditions": {"uid": uid}} if uid else None
        return self._call("DELETE", path, body=body)

    def try_get(self, path: str) -> Optional[dict]:
        try:
            return self.get(path)
        except ApiError as error:
            if error.status == 404:
                return None
            raise

    # --- watch -------------------------------------------------------------

    def _watch_backoff_s(self, failures: int) -> float:
        return capped_backoff_s(
            self.WATCH_BACKOFF_BASE_S, self.WATCH_BACKOFF_CAP_S, failures
        )

    def _consume_stream(self, path, query, on_event, stop, progress):
        """One watch connection: deliver events until the stream ends.
        Returns (expired, stopped). `progress` ({"rv", "delivered"}) is
        mutated in place so a mid-stream tear keeps the resume point and
        backoff credit of the events already applied."""
        expired = False
        for event in self.transport.stream(path, query):
            if stop.is_set():
                return False, True
            progress["delivered"] = True
            event_type = event.get("type", "")
            obj = event.get("object") or {}
            if event_type == "ERROR":
                # k8s signals watch errors in-band as a Status object.
                expired = _status_code(obj) == 410
                break
            new_rv = (obj.get("metadata") or {}).get("resourceVersion")
            if new_rv:
                progress["rv"] = new_rv
            if event_type != "BOOKMARK":
                # Bookmarks only advance rv (shrinking the 410 window on
                # idle kinds); everything else is delivered.
                on_event(event_type, obj)
        return expired, False

    def watch(
        self,
        path: str,
        on_event: Callable[[str, dict], None],
        stop: threading.Event,
        resource_version: str = "",
        relist: Optional[Callable[[], str]] = None,
    ) -> None:
        """Consume watch events ({type, object} lines) until stop is set —
        the reflector loop of a client-go informer:

        - reconnect from the last seen resourceVersion on stream drops,
          with capped exponential backoff per consecutive dead connection
          (a torn socket and a persistently erroring server must not be
          hot-looped; any delivered event resets the backoff);
        - on 410 Gone (an in-stream ERROR Status event or an HTTP 410 on
          reconnect — what the apiserver sends once etcd compaction has
          discarded the resumption point), call `relist` to rebuild state
          from a fresh LIST and resume from the collection rv it returns.
          Without a relist callback the watch restarts from 'now' ('' rv),
          accepting the gap rather than hot-looping on 410 forever.
        """
        rv = resource_version
        failures = 0
        while not stop.is_set():
            query = "watch=true&allowWatchBookmarks=true" + (
                f"&resourceVersion={rv}" if rv else ""
            )
            expired = False
            progress = {"rv": rv, "delivered": False}
            try:
                expired, stopped = self._consume_stream(
                    path, query, on_event, stop, progress
                )
                if stopped:
                    return
            except ApiError as error:
                expired = error.status == 410
            except TransportError as error:
                # Socket-layer tear (reset, idle deadline, refused reconnect)
                # — retryable by definition, but distinctly counted so a
                # flapping network shows up in the watch retry series.
                KUBE_API_RETRY_TOTAL.inc("watch", error.reason)
            except Exception:  # noqa: BLE001 — watch drop: back off, re-watch
                KUBE_API_RETRY_TOTAL.inc("watch", "stream-error")
            rv = progress["rv"]
            if progress["delivered"]:
                failures = 0
            if expired:
                if relist is not None:
                    try:
                        rv = relist()
                        failures = 0
                        continue
                    except Exception:  # noqa: BLE001 — apiserver flake: retry
                        failures += 1
                        if stop.wait(timeout=self._watch_backoff_s(failures)):
                            return
                else:
                    rv = ""
            else:
                # Non-410 stream end (incl. a non-410 ERROR Status): back off
                # before reconnecting from the last rv.
                failures += 1
                if stop.wait(timeout=self._watch_backoff_s(failures)):
                    return
