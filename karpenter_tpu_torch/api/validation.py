"""Provisioner validation and defaulting.

Ref: pkg/apis/provisioning/v1alpha5/provisioner_validation.go:30-158 and
provisioner_defaults.go. The reference runs these in admission webhooks; we run
them at Provisioner apply time in the provisioning controller. Cloud providers
install extra behavior through the pluggable DEFAULT_HOOK / VALIDATE_HOOK
(ref: register.go:66-68), set by cloudprovider.registry at startup.
"""

from __future__ import annotations

import re
from typing import Callable, List, Optional

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.provisioner import Provisioner
from karpenter_tpu_torch.api.requirements import SUPPORTED_OPERATORS
from karpenter_tpu_torch.api.taints import (
    EFFECT_NO_EXECUTE,
    EFFECT_NO_SCHEDULE,
    EFFECT_PREFER_NO_SCHEDULE,
)


class ValidationError(Exception):
    pass


# Pluggable cloud-provider hooks (ref: v1alpha5/register.go DefaultHook/ValidateHook).
DEFAULT_HOOK: Optional[Callable[[Provisioner], None]] = None
VALIDATE_HOOK: Optional[Callable[[Provisioner], None]] = None

_QUALIFIED_NAME_RE = re.compile(r"^[A-Za-z0-9]([-A-Za-z0-9_.]*[A-Za-z0-9])?$")
_LABEL_VALUE_RE = re.compile(r"^([A-Za-z0-9]([-A-Za-z0-9_.]*[A-Za-z0-9])?)?$")
_DNS_LABEL_RE = re.compile(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$")
_VALID_EFFECTS = {EFFECT_NO_SCHEDULE, EFFECT_PREFER_NO_SCHEDULE, EFFECT_NO_EXECUTE}


def _label_key_domain(key: str) -> str:
    return key.rsplit("/", 1)[0] if "/" in key else ""


def _validate_label_key(key: str, errors: List[str], where: str) -> None:
    name = key.rsplit("/", 1)[-1]
    if not name or not _QUALIFIED_NAME_RE.match(name) or len(name) > 63:
        errors.append(f"{where}: invalid label key {key!r}")
    # The optional prefix must be a DNS subdomain (kube IsQualifiedName).
    domain = _label_key_domain(key)
    if domain and (
        len(domain) > 253
        or not all(_DNS_LABEL_RE.match(part) for part in domain.split("."))
    ):
        errors.append(f"{where}: invalid label key domain {domain!r}")


def default_provisioner(provisioner: Provisioner) -> None:
    if DEFAULT_HOOK is not None:
        DEFAULT_HOOK(provisioner)


def _validate_weight(weight, errors: List[str]) -> None:
    # Weight: real Karpenter bounds .spec.weight to [0, 100] (0 = unset).
    if not isinstance(weight, int) or isinstance(weight, bool):
        errors.append(f"weight must be an integer, got {weight!r}")
    elif not 0 <= weight <= 100:
        errors.append(f"weight must be in [0, 100], got {weight}")


def validate_provisioner(provisioner: Provisioner) -> None:
    """Raise ValidationError listing every problem found."""
    errors: List[str] = []
    if not provisioner.name or len(provisioner.name) > 63:
        errors.append("metadata.name must be 1-63 characters")
    spec = provisioner.spec

    for ttl_name, ttl in (
        ("ttlSecondsAfterEmpty", spec.ttl_seconds_after_empty),
        ("ttlSecondsUntilExpired", spec.ttl_seconds_until_expired),
    ):
        if ttl is not None and ttl < 0:
            errors.append(f"{ttl_name} must be non-negative, got {ttl}")

    _validate_weight(spec.weight, errors)

    # Labels: restricted domains may not be set directly (ref: validation.go
    # restricted-label check); values must be legal.
    for key, value in spec.constraints.labels.items():
        _validate_label_key(key, errors, "labels")
        if not _LABEL_VALUE_RE.match(value) or len(value) > 63:
            errors.append(f"labels: invalid value {value!r} for key {key!r}")
        domain = _label_key_domain(key)
        if key not in wellknown.RESTRICTED_LABEL_EXCEPTIONS and any(
            domain == d or domain.endswith("." + d)
            for d in wellknown.RESTRICTED_LABEL_DOMAINS
        ):
            errors.append(f"labels: domain {domain!r} is restricted (key {key!r})")

    for taint in spec.constraints.taints:
        _validate_label_key(taint.key, errors, "taints")
        if taint.effect not in _VALID_EFFECTS:
            errors.append(f"taints: invalid effect {taint.effect!r}")

    # Requirements: only In/NotIn over well-known keys
    # (ref: provisioner_validation.go:120-158).
    for requirement in spec.constraints.requirements:
        if requirement.key not in wellknown.WELL_KNOWN_LABELS:
            errors.append(
                f"requirements: key {requirement.key!r} is not in the well-known set"
            )
        if requirement.operator not in SUPPORTED_OPERATORS:
            errors.append(
                f"requirements: operator {requirement.operator!r} not supported "
                f"(only {list(SUPPORTED_OPERATORS)})"
            )

    if spec.limits is not None:
        for key, quantity in spec.limits.resources.items():
            if quantity < 0:
                errors.append(f"limits: {key} must be non-negative")

    if errors:
        raise ValidationError("; ".join(errors))

    if VALIDATE_HOOK is not None:
        VALIDATE_HOOK(provisioner)
