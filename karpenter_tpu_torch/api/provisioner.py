"""Provisioner — the root configuration object of the framework.

Ref: pkg/apis/provisioning/v1alpha5/provisioner.go, constraints.go, limits.go,
provisioner_status.go. A Provisioner declares the constraint envelope
(labels, taints, requirements, vendor provider config), lifecycle TTLs, and
resource limits; the provisioning controller runs one batching loop per
Provisioner.
"""

from __future__ import annotations

import copy
import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional

from karpenter_tpu_torch.api.pods import PodSpec
from karpenter_tpu_torch.api.requirements import SUPPORTED_OPERATORS, Requirements
from karpenter_tpu_torch.api.resources import ResourceList, parse_resource_list
from karpenter_tpu_torch.api.taints import Taint, taints_tolerate_pod

_uid_counter = itertools.count(1)


class PodIncompatibleError(Exception):
    """Pod cannot be satisfied by this provisioner's constraints."""


@dataclass
class Limits:
    """Caps total resources provisioned (ref: limits.go:29-41)."""

    resources: ResourceList = field(default_factory=dict)

    def __post_init__(self):
        if self.resources:
            self.resources = parse_resource_list(self.resources)

    def exceeded_by(self, usage: Mapping[str, float]) -> Optional[str]:
        """Return a human reason if usage exceeds any limit, else None."""
        for key, limit in self.resources.items():
            used = usage.get(key, 0.0)
            if used >= limit:
                return f"{key} resource usage of {used:g} exceeds limit of {limit:g}"
        return None


@dataclass
class Constraints:
    """The constraint envelope applied to every node a provisioner creates
    (ref: constraints.go:25-72)."""

    labels: Dict[str, str] = field(default_factory=dict)
    taints: List[Taint] = field(default_factory=list)
    requirements: Requirements = field(default_factory=Requirements)
    # Opaque vendor extension (ref: Provider *runtime.RawExtension). Decoded by
    # the active cloud provider.
    provider: Optional[Dict[str, Any]] = None

    def effective_requirements(self) -> Requirements:
        """Requirements plus labels lifted into In-requirements
        (ref: controller.go:97-101 adds LabelRequirements before solving)."""
        return self.requirements.merge(Requirements.from_labels(self.labels))

    def validate_pod(self, pod: PodSpec) -> None:
        """Raise PodIncompatibleError unless the pod tolerates our taints and
        its scheduling requirements intersect ours (ref: constraints.go:43-63).

        Pods using operators outside In/NotIn are rejected here as
        incompatible rather than crashing the evaluator — the reference
        filters them earlier at selection (selection/controller.go:130-141),
        and the selection controller does too; this is the backstop.
        """
        if not taints_tolerate_pod(self.taints, pod.tolerations):
            raise PodIncompatibleError(
                f"pod {pod.namespace}/{pod.name} does not tolerate provisioner taints"
            )
        theirs = pod.scheduling_requirements()
        for requirement in theirs:
            if requirement.operator not in SUPPORTED_OPERATORS:
                raise PodIncompatibleError(
                    f"pod {pod.namespace}/{pod.name} uses unsupported operator "
                    f"{requirement.operator!r}"
                )
        ours = self.effective_requirements()
        if not ours.compatible_with(theirs):
            raise PodIncompatibleError(
                f"pod {pod.namespace}/{pod.name} requirements incompatible with provisioner"
            )

    def tighten(self, pod: PodSpec) -> "Constraints":
        """Constraints ∧ pod requirements, consolidated to well-known keys
        (ref: constraints.go Tighten:65-72). The result is the per-schedule
        constraint set handed to the solver."""
        tightened = (
            self.effective_requirements()
            .merge(pod.scheduling_requirements())
            .consolidate()
            .well_known()
        )
        return Constraints(
            labels=dict(self.labels),
            taints=list(self.taints),
            requirements=tightened,
            provider=copy.deepcopy(self.provider),
        )


@dataclass
class ProvisionerSpec:
    constraints: Constraints = field(default_factory=Constraints)
    ttl_seconds_after_empty: Optional[float] = None
    ttl_seconds_until_expired: Optional[float] = None
    limits: Optional[Limits] = None
    # Selection priority among provisioners that both match a pod: higher
    # weight wins, name breaks ties (real-Karpenter `.spec.weight`). Excluded
    # from the drift hash — re-weighting must not roll a fleet.
    weight: int = 0


@dataclass
class ProvisionerStatus:
    """Ref: provisioner_status.go:22-50."""

    last_scale_time: Optional[float] = None
    resources: ResourceList = field(default_factory=dict)
    conditions: Dict[str, bool] = field(default_factory=dict)


@dataclass
class Provisioner:
    name: str
    spec: ProvisionerSpec = field(default_factory=ProvisionerSpec)
    status: ProvisionerStatus = field(default_factory=ProvisionerStatus)
    uid: str = ""
    deletion_timestamp: Optional[float] = None

    def __post_init__(self):
        if not self.uid:
            self.uid = f"provisioner-uid-{next(_uid_counter)}"
