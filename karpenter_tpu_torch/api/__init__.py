"""Typed spec model for provisioning (ref: pkg/apis/provisioning/v1alpha5)."""

from karpenter_tpu_torch.api.resources import (
    Quantity,
    parse_quantity,
    ResourceList,
    add_resources,
    subtract_resources,
    fits_within,
)
from karpenter_tpu_torch.api.requirements import Requirement, Requirements, IN, NOT_IN
from karpenter_tpu_torch.api.taints import Taint, Toleration, taints_tolerate_pod, taints_for_pod
from karpenter_tpu_torch.api.pods import PodSpec, TopologySpreadConstraint
from karpenter_tpu_torch.api.provisioner import (
    Provisioner,
    ProvisionerSpec,
    ProvisionerStatus,
    Constraints,
    Limits,
)
from karpenter_tpu_torch.api import wellknown

__all__ = [
    "Quantity",
    "parse_quantity",
    "ResourceList",
    "add_resources",
    "subtract_resources",
    "fits_within",
    "Requirement",
    "Requirements",
    "IN",
    "NOT_IN",
    "Taint",
    "Toleration",
    "taints_tolerate_pod",
    "taints_for_pod",
    "PodSpec",
    "TopologySpreadConstraint",
    "Provisioner",
    "ProvisionerSpec",
    "ProvisionerStatus",
    "Constraints",
    "Limits",
    "wellknown",
]
