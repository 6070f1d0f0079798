"""EC2 vendor extension: the opaque `Constraints.provider` blob.

Ref: pkg/cloudprovider/aws/apis/v1alpha1/ — the reference nests a vendor CRD
(`AWS{InstanceProfile, LaunchTemplate, SubnetSelector,
SecurityGroupSelector, Tags}`) inside the Provisioner as raw JSON
(provider.go:31-79), defaults it from the cluster name
(provider_defaults.go:29-52), validates it (provider_validation.go), and
merges cluster-discovery tags onto every created resource (tags.go).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.provisioner import Constraints, Provisioner
from karpenter_tpu_torch.api.requirements import Requirement

# Tag key set on all cluster-owned resources (ref: tags.go ClusterTagKeyFormat).
CLUSTER_TAG_KEY_FORMAT = "kubernetes.io/cluster/{}"
# Tag key marking resources this framework owns (ref: tags.go KarpenterTagKeyFormat).
FRAMEWORK_TAG_KEY_FORMAT = "karpenter.tpu/cluster/{}"


class VendorValidationError(Exception):
    """Invalid provider blob (ref: provider_validation.go FieldErrors)."""


@dataclass
class Ec2Provider:
    """Typed view of the vendor blob (ref: provider.go:33-52)."""

    instance_profile: str = ""
    launch_template: Optional[str] = None
    subnet_selector: Optional[Dict[str, str]] = None
    security_group_selector: Optional[Dict[str, str]] = None
    tags: Dict[str, str] = field(default_factory=dict)

    @staticmethod
    def deserialize(constraints: Constraints) -> "Ec2Provider":
        """Ref: provider.go Deserialize:54-67 — the blob must exist (the
        defaulting hook installs it)."""
        if constraints.provider is None:
            raise VendorValidationError(
                "spec.provider is not defined; is the defaulting hook installed?"
            )
        blob: Mapping[str, Any] = constraints.provider
        unknown = set(blob) - {
            "instanceProfile",
            "launchTemplate",
            "subnetSelector",
            "securityGroupSelector",
            "tags",
        }
        if unknown:
            raise VendorValidationError(f"unknown provider fields: {sorted(unknown)}")
        return Ec2Provider(
            instance_profile=blob.get("instanceProfile", ""),
            launch_template=blob.get("launchTemplate"),
            subnet_selector=dict(blob["subnetSelector"])
            if blob.get("subnetSelector") is not None
            else None,
            security_group_selector=dict(blob["securityGroupSelector"])
            if blob.get("securityGroupSelector") is not None
            else None,
            tags=dict(blob.get("tags") or {}),
        )

    def serialize(self) -> Dict[str, Any]:
        blob: Dict[str, Any] = {"instanceProfile": self.instance_profile}
        if self.launch_template is not None:
            blob["launchTemplate"] = self.launch_template
        if self.subnet_selector is not None:
            blob["subnetSelector"] = dict(self.subnet_selector)
        if self.security_group_selector is not None:
            blob["securityGroupSelector"] = dict(self.security_group_selector)
        if self.tags:
            blob["tags"] = dict(self.tags)
        return blob

    def validate(self) -> None:
        """Ref: provider_validation.go:24-83."""
        errors = []
        if not self.instance_profile:
            errors.append("provider.instanceProfile is required")
        for name, selector in (
            ("subnetSelector", self.subnet_selector),
            ("securityGroupSelector", self.security_group_selector),
        ):
            if selector is None:
                errors.append(f"provider.{name} is required")
                continue
            for key, value in selector.items():
                if key == "" or value == "":
                    errors.append(f"provider.{name}[{key!r}] must be non-empty")
        for key in self.tags:
            if key == "":
                errors.append("provider.tags: empty tag keys are not supported")
        if errors:
            raise VendorValidationError("; ".join(errors))


def default_provider_blob(provisioner: Provisioner, cluster_name: str) -> None:
    """The vendor defaulting hook (ref: provider_defaults.go Default:18-23):
    arch defaults to amd64, capacity type to on-demand, and subnet/SG
    selectors to the cluster discovery tag."""
    constraints = provisioner.spec.constraints
    blob = dict(constraints.provider or {})
    discovery = {CLUSTER_TAG_KEY_FORMAT.format(cluster_name): "*"}
    blob.setdefault("subnetSelector", discovery)
    blob.setdefault("securityGroupSelector", dict(discovery))
    constraints.provider = blob

    existing_keys = set(constraints.requirements.keys()) | set(constraints.labels)
    if wellknown.ARCH_LABEL not in existing_keys:
        constraints.requirements = constraints.requirements.add(
            Requirement.in_(wellknown.ARCH_LABEL, ["amd64"])
        )
    if wellknown.CAPACITY_TYPE_LABEL not in existing_keys:
        constraints.requirements = constraints.requirements.add(
            Requirement.in_(
                wellknown.CAPACITY_TYPE_LABEL, [wellknown.CAPACITY_TYPE_ON_DEMAND]
            )
        )


def merge_tags(
    cluster_name: str, provisioner_name: str, custom_tags: Mapping[str, str]
) -> Dict[str, str]:
    """Managed tags, overridable by user tags (ref: tags.go MergeTags:27-40)."""
    merged = {
        "Name": f"{wellknown.GROUP}/cluster/{cluster_name}/provisioner/{provisioner_name}",
        CLUSTER_TAG_KEY_FORMAT.format(cluster_name): "owned",
        FRAMEWORK_TAG_KEY_FORMAT.format(cluster_name): "owned",
    }
    merged.update(custom_tags)
    return merged
