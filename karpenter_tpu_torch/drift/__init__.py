"""Drift: canonical Provisioner spec hashing + drift kinds.

Production Karpenter stamps a hash of the provisioner spec onto every node it
creates (`karpenter.sh/provisioner-hash`) and treats a mismatch between the
stamped hash and the live spec as *drift* — the node was built from an older
generation of the spec and should be replaced in a budgeted rolling wave
(controllers/drift.py). This module owns the hash canon.

Design rules (docs/design/drift.md):

- The hash covers the STORED (user-declared) constraint envelope only:
  labels, taints, requirements, and the vendor provider config. It is what
  the operator edits, and what a node's shape was derived from.
- Lifecycle knobs — TTLs, limits, weight — are EXCLUDED: flipping
  `ttlSecondsUntilExpired` or a resource limit must not roll the fleet.
- The effective (fleet-refreshed) spec the provisioning worker solves
  against is NEVER hashed: catalog refreshes and ICE blackouts mutate it
  continuously, and hashing it would turn every market wobble into fleet
  drift. (`provisioning.spec_hash` — a Python `hash()` over the effective
  spec — exists for worker hot-swap and stays separate on purpose.)
- The hash is order-insensitive and process-stable: canonical JSON
  (sorted keys, sorted collections) under sha256, so two specs that differ
  only in declaration order — or a restarted controller re-hashing the same
  spec — agree bit-for-bit. Python's `hash()` is salted per process and
  must never leak into a stamped annotation.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict

from karpenter_tpu_torch.api.provisioner import Provisioner, ProvisionerSpec

# Drift kinds — the value stamped into DRIFT_ACTION_ANNOTATION. "spec" =
# stamped hash no longer matches the live spec; "provider" = the cloud says
# the instance's template/AMI/offering moved; "expired" = the node outlived
# ttlSecondsUntilExpired (expiration rides the same rolling wave).
DRIFT_KIND_SPEC = "spec"
DRIFT_KIND_PROVIDER = "provider"
DRIFT_KIND_EXPIRED = "expired"
DRIFT_KINDS = (DRIFT_KIND_SPEC, DRIFT_KIND_PROVIDER, DRIFT_KIND_EXPIRED)

# Short, annotation-friendly prefix of the sha256. 16 hex chars = 64 bits;
# collisions across the handful of spec generations a fleet ever sees are
# not a real risk, and operators read these by eye in `kubectl describe`.
HASH_LENGTH = 16


def _canonical_envelope(spec: ProvisionerSpec) -> Dict[str, Any]:
    """The hashed payload, as plain JSON-able data with every collection in
    canonical order. Key names are part of the canon — renaming one rolls
    every fleet on upgrade, so don't."""
    constraints = spec.constraints
    return {
        "labels": sorted(constraints.labels.items()),
        "taints": sorted(
            (t.key, t.value, t.effect) for t in constraints.taints
        ),
        # canonical_key() is already sorted + complement-aware: two
        # Requirements built in different order (or with duplicate merges)
        # agree here.
        "requirements": constraints.requirements.canonical_key(),
        "provider": constraints.provider,
    }


def spec_hash(provisioner_or_spec) -> str:
    """Canonical, order-insensitive, cross-process-stable hash of the
    Provisioner constraint envelope. Accepts a Provisioner or a
    ProvisionerSpec."""
    spec = (
        provisioner_or_spec.spec
        if isinstance(provisioner_or_spec, Provisioner)
        else provisioner_or_spec
    )
    payload = json.dumps(
        _canonical_envelope(spec),
        sort_keys=True,
        separators=(",", ":"),
        default=str,  # backstop for exotic provider values; str() is stable
    )
    return hashlib.sha256(payload.encode()).hexdigest()[:HASH_LENGTH]
