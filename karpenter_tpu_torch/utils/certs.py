"""Webhook serving-certificate self-provisioning and rotation.

Ref: cmd/webhook/main.go:44-62 — the reference's knative sharedmain runs a
certificate controller that generates the webhook's serving cert, rotates it
before expiry, and injects the CA bundle into the webhook configurations.
This module is that controller re-built for this runtime: generate a
self-signed serving cert when the operator supplies none, serve it from an
SSLContext that hot-reloads on rotation (no listener restart), and write the
caBundle into the Mutating/ValidatingWebhookConfiguration objects through
the apiserver client.
"""

from __future__ import annotations

import base64
import datetime
import os
import tempfile
import threading
from typing import Callable, List, Optional, Sequence, Tuple

from karpenter_tpu_torch.utils import logging as klog

log = klog.named("webhook.certs")

# Rotate when less than this fraction of the cert lifetime remains (knative
# rotates at 90% of lifetime; 20% remaining ≈ the same renewal cadence with
# margin for a webhook that only checks hourly).
ROTATE_REMAINING_FRACTION = 0.2

MUTATING_WEBHOOK_NAME = "defaulting.webhook.karpenter.tpu"
VALIDATING_WEBHOOK_NAME = "validation.webhook.karpenter.tpu"


def generate_self_signed(
    common_name: str,
    dns_names: Sequence[str] = (),
    lifetime: datetime.timedelta = datetime.timedelta(days=90),
    now: Optional[datetime.datetime] = None,
) -> Tuple[bytes, bytes]:
    """(cert_pem, key_pem): a self-signed EC-P256 serving certificate with
    the given SANs. The cert doubles as its own CA bundle (self-signed),
    exactly like knative's generated secret."""
    import ipaddress

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    now = now or datetime.datetime.now(datetime.timezone.utc)
    key = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, common_name)])
    sans: List[x509.GeneralName] = []
    for dns in dns_names or (common_name,):
        try:
            sans.append(x509.IPAddress(ipaddress.ip_address(dns)))
        except ValueError:
            sans.append(x509.DNSName(dns))
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + lifetime)
        .add_extension(x509.SubjectAlternativeName(sans), critical=False)
        .add_extension(
            x509.BasicConstraints(ca=True, path_length=None), critical=True
        )
        .sign(key, hashes.SHA256())
    )
    cert_pem = cert.public_bytes(serialization.Encoding.PEM)
    key_pem = key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption(),
    )
    return cert_pem, key_pem


class CertManager:
    """Owns the webhook's serving cert files: generates when absent, rotates
    before expiry, hot-reloads any registered SSLContext, and notifies a
    callback with the fresh base64 caBundle (for re-injection)."""

    def __init__(
        self,
        common_name: str,
        dns_names: Sequence[str] = (),
        lifetime: datetime.timedelta = datetime.timedelta(days=90),
        cert_dir: Optional[str] = None,
        clock: Callable[[], datetime.datetime] = None,
    ):
        self.common_name = common_name
        self.dns_names = tuple(dns_names) or (common_name,)
        self.lifetime = lifetime
        self.cert_dir = cert_dir or tempfile.mkdtemp(prefix="karpenter-webhook-")
        self.cert_path = os.path.join(self.cert_dir, "tls.crt")
        self.key_path = os.path.join(self.cert_dir, "tls.key")
        self._clock = clock or (
            lambda: datetime.datetime.now(datetime.timezone.utc)
        )
        self._not_after: Optional[datetime.datetime] = None
        self._not_before: Optional[datetime.datetime] = None
        self._lock = threading.Lock()
        self._contexts: List = []  # SSLContexts to hot-reload on rotation
        self.on_rotate: Optional[Callable[[str], None]] = None
        self._stop = threading.Event()

    # --- provisioning -------------------------------------------------------

    def ensure(self) -> Tuple[str, str]:
        """Generate the serving cert if missing or due; returns file paths."""
        with self._lock:
            if self._not_after is None or self._due_locked():
                self._generate_locked()
            return self.cert_path, self.key_path

    def ca_bundle_b64(self) -> str:
        with open(self.cert_path, "rb") as handle:
            return base64.b64encode(handle.read()).decode()

    def _generate_locked(self) -> None:
        now = self._clock()
        cert_pem, key_pem = generate_self_signed(
            self.common_name, self.dns_names, self.lifetime, now=now
        )
        # Write key with owner-only permissions before the cert appears.
        descriptor = os.open(
            self.key_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600
        )
        with os.fdopen(descriptor, "wb") as handle:
            handle.write(key_pem)
        with open(self.cert_path, "wb") as handle:
            handle.write(cert_pem)
        self._not_before = now
        self._not_after = now + self.lifetime
        log.info(
            "provisioned self-signed serving cert for %s (SAN %s), expires %s",
            self.common_name, ",".join(self.dns_names), self._not_after,
        )

    # --- rotation -----------------------------------------------------------

    def _due_locked(self) -> bool:
        if self._not_after is None:
            return True
        remaining = (self._not_after - self._clock()).total_seconds()
        return remaining < self.lifetime.total_seconds() * ROTATE_REMAINING_FRACTION

    def due_for_rotation(self) -> bool:
        with self._lock:
            return self._due_locked()

    def register_context(self, context) -> None:
        """SSLContexts registered here are re-loaded with the new chain on
        every rotation — new handshakes pick up the fresh cert, no listener
        restart."""
        with self._lock:
            self._contexts.append(context)

    def rotate_if_due(self) -> bool:
        with self._lock:
            if not self._due_locked():
                return False
            self._generate_locked()
            for context in self._contexts:
                context.load_cert_chain(self.cert_path, self.key_path)
        self._notify()
        return True

    def _notify(self) -> None:
        if self.on_rotate:
            try:
                self.on_rotate(self.ca_bundle_b64())
            except Exception:  # noqa: BLE001 — reconciled on the next tick
                log.exception("caBundle injection failed; will retry")

    def start_rotation_thread(self, interval_s: float = 60.0) -> threading.Thread:
        """Reconcile loop: rotate when due, and RE-INJECT the bundle every
        tick regardless (inject_ca_bundle no-ops when current). Injection
        must not wait for the next rotation: the chart's webhook
        configurations may be applied after the pod starts (Helm kind
        ordering), and a failed post-rotation injection would otherwise
        leave admission broken for the rest of the cert's lifetime."""

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    if self.rotate_if_due():
                        log.info("rotated webhook serving cert")
                    else:
                        self._notify()
                except Exception:  # noqa: BLE001 — keep the loop alive
                    log.exception("cert rotation check failed")

        thread = threading.Thread(target=loop, daemon=True, name="cert-rotation")
        thread.start()
        return thread

    def stop(self) -> None:
        self._stop.set()


def inject_ca_bundle(
    client,
    ca_bundle_b64: str,
    mutating: Sequence[str] = (MUTATING_WEBHOOK_NAME,),
    validating: Sequence[str] = (VALIDATING_WEBHOOK_NAME,),
) -> int:
    """Write the CA bundle into every webhook entry of the named
    webhook-configurations via the apiserver (read-modify-write — a merge
    patch would clobber sibling fields of the webhooks list). Returns the
    number of configurations updated; missing configurations are skipped
    (the chart may register them later). Ref: knative's certificate
    controller updating clientConfig.caBundle."""
    updated = 0
    plans = [
        ("/apis/admissionregistration.k8s.io/v1/mutatingwebhookconfigurations",
         mutating),
        ("/apis/admissionregistration.k8s.io/v1/validatingwebhookconfigurations",
         validating),
    ]
    for base_path, names in plans:
        for name in names:
            obj = client.try_get(f"{base_path}/{name}")
            if obj is None:
                log.info("webhook configuration %s not found; skipping", name)
                continue
            changed = False
            for webhook in obj.get("webhooks", []):
                config = webhook.setdefault("clientConfig", {})
                if config.get("caBundle") != ca_bundle_b64:
                    config["caBundle"] = ca_bundle_b64
                    changed = True
            if changed:
                client.update(f"{base_path}/{name}", obj)
                updated += 1
    return updated
