"""Admission webhook entry point.

Ref: cmd/webhook/main.go:44-96 — the reference runs knative admission
webhooks for CRD defaulting, CRD validation, and logging-config validation.
Here the same behaviors are served over the Kubernetes AdmissionReview v1
protocol (so a real apiserver can call them) with a plain-JSON fallback:

  POST /default   — AdmissionReview in → AdmissionReview out with a base64
                    JSONPatch applying CRD defaulting (a mutating webhook);
                    plain provisioner JSON in → defaulted JSON out.
  POST /validate  — AdmissionReview in → AdmissionReview out with
                    allowed=true/false + status message (validating webhook);
                    plain JSON in → 200 or 422 with reasons.
  POST /config    — {"level": "..."} live log-level reload
                    (ref: the config-logging ConfigMap validation webhook)

TLS (the apiserver only calls HTTPS webhook endpoints), either:
  * --tls-self-signed [--tls-dns-names a,b,c] — self-provision a serving
    cert at startup, rotate it in-process before expiry, and inject the
    caBundle into the webhook configurations through the apiserver
    (ref: cmd/webhook/main.go:44-62 — knative's certificate controller;
    the chart's default, no operator secret needed), or
  * --tls-cert-file/--tls-key-file — operator-supplied certs mounted from
    a secret (e.g. cert-manager; chart webhook.tlsSecretName).

Run: python -m karpenter_tpu.cmd.webhook --cluster-name my-cluster
"""

from __future__ import annotations

import base64
import http.server
import json
import socket
import ssl
import sys
import threading
from typing import List, Optional

from karpenter_tpu_torch.api import validation
from karpenter_tpu_torch.api.serialization import provisioner_from_dict, provisioner_to_dict
from karpenter_tpu_torch.cloudprovider import registry
from karpenter_tpu_torch.utils import logging as klog
from karpenter_tpu_torch.utils import options as options_pkg


def admission_response(uid: str, allowed: bool, message: str = "", patch=None):
    """Build an AdmissionReview v1 response envelope."""
    response = {"uid": uid, "allowed": allowed}
    if message:
        response["status"] = {"code": 200 if allowed else 422, "message": message}
    if patch:
        response["patchType"] = "JSONPatch"
        response["patch"] = base64.b64encode(json.dumps(patch).encode()).decode()
    return {
        "apiVersion": "admission.k8s.io/v1",
        "kind": "AdmissionReview",
        "response": response,
    }


def defaulting_patch(obj: dict) -> Optional[List[dict]]:
    """JSONPatch ops applying CRD defaulting to the admitted object.

    Defaulting only touches spec, so the patch is a single op carrying the
    defaulted spec. RFC 6902 'add' REPLACES an existing member, so the op is
    valid whether or not the original request carried a spec at all. The
    diff is taken against the object's own normalized round-trip, so pure
    serialization churn (quantity parsing etc.) produces no patch."""
    provisioner = provisioner_from_dict(obj)
    base = provisioner_to_dict(provisioner)  # snapshot before mutation
    validation.default_provisioner(provisioner)
    defaulted = provisioner_to_dict(provisioner)
    if defaulted.get("spec") == base.get("spec"):
        return None
    return [{"op": "add", "path": "/spec", "value": defaulted["spec"]}]


class WebhookHandler(http.server.BaseHTTPRequestHandler):
    def _read_json(self):
        length = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(length) or b"{}")

    def _respond(self, code: int, payload) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _handle_admission_review(self, data) -> None:
        """AdmissionReview v1 (the protocol a real apiserver speaks).
        Admission outcomes ride inside a 200 envelope; only a malformed
        envelope is an HTTP error."""
        request = data.get("request") or {}
        uid = request.get("uid", "")
        obj = request.get("object")
        if not isinstance(obj, dict):
            self._respond(400, {"error": "AdmissionReview without request.object"})
            return
        if self.path == "/default":
            try:
                self._respond(
                    200, admission_response(uid, True, patch=defaulting_patch(obj))
                )
            except Exception as error:  # noqa: BLE001
                self._respond(200, admission_response(uid, False, str(error)))
        elif self.path == "/validate":
            try:
                provisioner = provisioner_from_dict(obj)
                validation.validate_provisioner(provisioner)
                self._respond(200, admission_response(uid, True))
            except Exception as error:  # noqa: BLE001 — invalid spec or parse
                self._respond(200, admission_response(uid, False, str(error)))
        else:
            self._respond(404, {"error": "not found"})

    def do_POST(self):  # noqa: N802
        try:
            data = self._read_json()
        except (ValueError, json.JSONDecodeError) as error:
            self._respond(400, {"error": f"invalid JSON: {error}"})
            return
        if isinstance(data, dict) and data.get("kind") == "AdmissionReview":
            self._handle_admission_review(data)
            return
        if self.path == "/default":
            try:
                provisioner = provisioner_from_dict(data)
                validation.default_provisioner(provisioner)
                self._respond(200, provisioner_to_dict(provisioner))
            except Exception as error:  # noqa: BLE001
                self._respond(400, {"error": str(error)})
        elif self.path == "/validate":
            try:
                provisioner = provisioner_from_dict(data)
                validation.validate_provisioner(provisioner)
                self._respond(200, {"allowed": True})
            except validation.ValidationError as error:
                self._respond(422, {"allowed": False, "reason": str(error)})
            except Exception as error:  # noqa: BLE001
                self._respond(400, {"error": str(error)})
        elif self.path == "/config":
            level = data.get("level") if isinstance(data, dict) else None
            if not isinstance(level, str) or level.lower() not in (
                "debug",
                "info",
                "warning",
                "error",
            ):
                self._respond(422, {"allowed": False, "reason": f"bad level {level!r}"})
                return
            klog.set_level(level)
            self._respond(200, {"allowed": True})
        else:
            self._respond(404, {"error": "not found"})

    def log_message(self, *args):
        pass


class _TLSHTTPServer(http.server.ThreadingHTTPServer):
    """HTTPS server that performs the TLS handshake in the PER-CONNECTION
    thread, with a timeout. Wrapping the listening socket instead would run
    handshakes inside the single accept loop — one idle TCP connection (port
    scanner, TCP health check) would wedge every admission call behind it."""

    HANDSHAKE_TIMEOUT_SECONDS = 10.0

    def __init__(self, addr, handler, context: ssl.SSLContext):
        super().__init__(addr, handler)
        self._tls_context = context

    def get_request(self):
        sock, addr = super().get_request()
        # Defer the handshake: it runs in finish_request, on this
        # connection's own thread.
        return (
            self._tls_context.wrap_socket(
                sock, server_side=True, do_handshake_on_connect=False
            ),
            addr,
        )

    def finish_request(self, request, client_address):
        request.settimeout(self.HANDSHAKE_TIMEOUT_SECONDS)
        request.do_handshake()
        request.settimeout(None)
        super().finish_request(request, client_address)

    def handle_error(self, request, client_address):
        # Handshake failures (scanners, health checks, truncated conns) are
        # expected noise — one quiet line. Anything else escaping request
        # handling is a real admission-path bug and must be loud.
        error = sys.exc_info()[1]
        if isinstance(error, (ssl.SSLError, socket.timeout, TimeoutError,
                              ConnectionResetError, BrokenPipeError)):
            klog.named("webhook").debug(
                "connection error from %s: %s", client_address, error
            )
        else:
            klog.named("webhook").exception(
                "unhandled error serving %s", client_address
            )


def _extract_flag(argv: list, name: str) -> Optional[str]:
    """Pop --name=value / --name value / bare --name from argv. Returns the
    value, "" for a bare flag (Go-style boolean), None when absent — a
    following argument that is itself a flag is never consumed as a value."""
    for i, arg in enumerate(list(argv)):
        if arg.startswith(f"--{name}="):
            argv.pop(i)
            return arg.split("=", 1)[1]
        if arg == f"--{name}":
            if i + 1 < len(argv) and not argv[i + 1].startswith("--"):
                value = argv[i + 1]
                del argv[i : i + 2]
                return value
            argv.pop(i)
            return ""
    return None


def _cluster_kube_client(options):
    """A KubeClient for the configured apiserver backend, or None for the
    in-memory store (shared selection: HttpTransport.for_store)."""
    from karpenter_tpu_torch.kubeapi import KubeClient
    from karpenter_tpu_torch.kubeapi.client import HttpTransport

    transport = HttpTransport.for_store(options.cluster_store)
    return None if transport is None else KubeClient(transport)


def main(
    argv=None,
    port: int = 8443,
    block: bool = True,
    address: str = "",
    tls_cert_file: Optional[str] = None,
    tls_key_file: Optional[str] = None,
    tls_self_signed: bool = False,
    tls_dns_names: Optional[List[str]] = None,
):
    # These flags belong to this binary, not the shared options envelope
    # (the chart passes them; options.parse would reject unknown flags).
    if argv:
        argv = list(argv)
        port_arg = _extract_flag(argv, "port")
        if port_arg:
            port = int(port_arg)
        tls_cert_file = _extract_flag(argv, "tls-cert-file") or tls_cert_file
        tls_key_file = _extract_flag(argv, "tls-key-file") or tls_key_file
        self_signed_arg = _extract_flag(argv, "tls-self-signed")
        if self_signed_arg is not None:
            # Bare --tls-self-signed means true, Go-flag style.
            tls_self_signed = self_signed_arg.lower() in ("true", "1", "yes", "")
        dns_arg = _extract_flag(argv, "tls-dns-names")
        if dns_arg:
            tls_dns_names = [d.strip() for d in dns_arg.split(",") if d.strip()]
    options = options_pkg.parse(argv)
    klog.setup(options.log_level)
    registry.new_cloud_provider(options.cloud_provider)  # installs hooks
    scheme = "http"
    cert_manager = None
    if not (tls_cert_file and tls_key_file) and tls_self_signed:
        # No operator-supplied secret: self-provision the serving cert,
        # rotate it in-process before expiry, and inject the caBundle into
        # the webhook configurations — the knative reference's certificate
        # controller behavior (ref: cmd/webhook/main.go:44-62).
        from karpenter_tpu_torch.utils.certs import CertManager, inject_ca_bundle

        names = tls_dns_names or [
            "karpenter-tpu-webhook",
            "karpenter-tpu-webhook.karpenter.svc",
            "karpenter-tpu-webhook.karpenter.svc.cluster.local",
        ]
        cert_manager = CertManager(common_name=names[0], dns_names=names)
        tls_cert_file, tls_key_file = cert_manager.ensure()
        client = _cluster_kube_client(options)
        if client is not None:
            def _inject(ca_b64: str, client=client):
                inject_ca_bundle(client, ca_b64)

            cert_manager.on_rotate = _inject
            try:
                _inject(cert_manager.ca_bundle_b64())
            except Exception:  # noqa: BLE001 — registration may come later
                klog.named("webhook").exception("initial caBundle injection failed")
    if tls_cert_file and tls_key_file:
        # The apiserver only calls HTTPS webhook endpoints. Certs are either
        # operator-mounted (chart webhook.tlsSecretName) or self-provisioned
        # above; self-provisioned contexts hot-reload on rotation.
        context = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        context.load_cert_chain(tls_cert_file, tls_key_file)
        server = _TLSHTTPServer((address, port), WebhookHandler, context)
        scheme = "https"
        if cert_manager is not None:
            cert_manager.register_context(context)
            cert_manager.start_rotation_thread()
            server.cert_manager = cert_manager
    else:
        server = http.server.ThreadingHTTPServer((address, port), WebhookHandler)
    threading.Thread(
        target=server.serve_forever, name="webhook-serve", daemon=True
    ).start()
    klog.named("webhook").info("webhook serving %s on :%d", scheme, port)
    if block:
        try:
            threading.Event().wait()
        except KeyboardInterrupt:
            pass
        server.shutdown()
    return server


if __name__ == "__main__":
    main(sys.argv[1:])
