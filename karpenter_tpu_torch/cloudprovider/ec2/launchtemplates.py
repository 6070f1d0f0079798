"""Machine-image discovery and deterministic launch templates.

Ref: pkg/cloudprovider/aws/{ami.go,launchtemplate.go} — the AMI provider
resolves the recommended image for (k8s version, architecture, accelerator)
via a parameter-store query; the launch-template provider derives a
deterministic template name from a content hash of everything that affects
boot (cluster, user-data, instance profile, SGs, AMI, tags), discovers or
creates it under a lock, and generates hash-stable bootstrap user-data with
sorted kubelet label/taint args.
"""

from __future__ import annotations

import base64
import hashlib
import json
import threading
from typing import Dict, List, Mapping, Optional, Sequence

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.provisioner import Constraints
from karpenter_tpu_torch.api.taints import Taint
from karpenter_tpu_torch.cloudprovider import ARCH_ARM64, InstanceType
from karpenter_tpu_torch.cloudprovider.ec2.api import (
    SETUP_CACHE_TTL,
    Ec2Api,
    LaunchTemplate,
    is_not_found,
)
from karpenter_tpu_torch.cloudprovider.ec2.network import SecurityGroupProvider
from karpenter_tpu_torch.cloudprovider.ec2.vendor import Ec2Provider, merge_tags
from karpenter_tpu_torch.utils.cache import TtlCache
from karpenter_tpu_torch.utils.clock import Clock, SYSTEM_CLOCK

LAUNCH_TEMPLATE_NAME_FORMAT = "KarpenterTPU-{cluster}-{hash}"


class AmiProvider:
    """Ref: aws/ami.go AMIProvider:25-110. Groups instance types by the image
    query they need (accelerator image for GPU/neuron types, arm64 image for
    ARM), then resolves each query through the parameter store, cached."""

    def __init__(
        self,
        api: Ec2Api,
        kube_version: str = "1.21",
        clock: Optional[Clock] = None,
    ):
        self.api = api
        self.kube_version = kube_version
        self._cache = TtlCache(SETUP_CACHE_TTL, clock or SYSTEM_CLOCK)
        self._lock = threading.Lock()

    def get(
        self, instance_types: Sequence[InstanceType]
    ) -> Dict[str, List[InstanceType]]:
        """ami id -> instance types bootable from it (ref: ami.go Get:35-57)."""
        by_query: Dict[str, List[InstanceType]] = {}
        for instance_type in instance_types:
            by_query.setdefault(self._query_for(instance_type), []).append(
                instance_type
            )
        by_ami: Dict[str, List[InstanceType]] = {}
        for query, types in by_query.items():
            by_ami.setdefault(self._resolve(query), []).extend(types)
        return by_ami

    def _query_for(self, instance_type: InstanceType) -> str:
        """Ref: ami.go getSSMQuery:75-83."""
        suffix = ""
        if instance_type.get(wellknown.RESOURCE_NVIDIA_GPU) or instance_type.get(
            wellknown.RESOURCE_AWS_NEURON
        ):
            suffix = "-gpu"
        elif instance_type.architecture == ARCH_ARM64:
            suffix = "-arm64"
        return (
            f"/aws/service/eks/optimized-ami/{self.kube_version}"
            f"/amazon-linux-2{suffix}/recommended/image_id"
        )

    def _resolve(self, query: str) -> str:
        with self._lock:
            cached = self._cache.get(query)
            if cached is not None:
                return cached
            ami = self.api.get_ami_parameter(query)
            self._cache.set(query, ami)
            return ami


def _needs_legacy_runtime(instance_types: Sequence[InstanceType]) -> bool:
    """GPU/neuron types can't use containerd directly in the reference's AMI
    (ref: launchtemplate.go needsDocker:163-171)."""
    return any(
        t.get(wellknown.RESOURCE_NVIDIA_GPU) or t.get(wellknown.RESOURCE_AWS_NEURON)
        for t in instance_types
    )


def _sorted_taint_args(taints: Sequence[Taint]) -> str:
    ordered = sorted(taints, key=lambda t: (t.key, t.value, t.effect))
    return ",".join(f"{t.key}={t.value}:{t.effect}" for t in ordered)


def build_user_data(
    cluster_name: str,
    cluster_endpoint: str,
    constraints: Constraints,
    instance_types: Sequence[InstanceType],
    additional_labels: Mapping[str, str],
    ca_bundle: Optional[str] = None,
) -> str:
    """Bootstrap script, byte-stable for equivalent inputs so the launch
    template hash is stable (ref: launchtemplate.go getUserData:225-285 —
    labels and taints are emitted in sorted order for exactly this reason)."""
    lines = [
        "#!/bin/bash -xe",
        "exec > >(tee /var/log/user-data.log|logger -t user-data -s 2>/dev/console) 2>&1",
    ]
    bootstrap = f"/etc/eks/bootstrap.sh '{cluster_name}'"
    if not _needs_legacy_runtime(instance_types):
        bootstrap += " --container-runtime containerd"
    bootstrap += f" \\\n    --apiserver-endpoint '{cluster_endpoint}'"
    if ca_bundle:
        bootstrap += f" \\\n    --b64-cluster-ca '{ca_bundle}'"
    labels = {**additional_labels, **constraints.labels}
    kubelet_args = []
    if labels:
        pairs = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
        kubelet_args.append(f"--node-labels={pairs}")
    if constraints.taints:
        kubelet_args.append(
            f"--register-with-taints={_sorted_taint_args(constraints.taints)}"
        )
    if kubelet_args:
        bootstrap += f" \\\n    --kubelet-extra-args '{' '.join(kubelet_args)}'"
    lines.append(bootstrap)
    return base64.b64encode("\n".join(lines).encode()).decode()


class LaunchTemplateProvider:
    """Ref: aws/launchtemplate.go LaunchTemplateProvider:47-157."""

    def __init__(
        self,
        api: Ec2Api,
        ami_provider: AmiProvider,
        security_group_provider: SecurityGroupProvider,
        cluster_name: str,
        cluster_endpoint: str = "",
        ca_bundle: Optional[str] = None,
        clock: Optional[Clock] = None,
    ):
        self.api = api
        self.ami_provider = ami_provider
        self.security_group_provider = security_group_provider
        self.cluster_name = cluster_name
        self.cluster_endpoint = cluster_endpoint
        self.ca_bundle = ca_bundle
        self._cache = TtlCache(SETUP_CACHE_TTL, clock or SYSTEM_CLOCK)
        self._lock = threading.Lock()

    def get(
        self,
        constraints: Constraints,
        provider: Ec2Provider,
        instance_types: Sequence[InstanceType],
        additional_labels: Mapping[str, str],
    ) -> Dict[str, List[InstanceType]]:
        """launch template name -> instance types it can boot
        (ref: launchtemplate.go Get:85-125). A user-specified template
        bypasses generation entirely."""
        if provider.launch_template is not None:
            return {provider.launch_template: list(instance_types)}
        security_group_ids = self.security_group_provider.get(provider)
        result: Dict[str, List[InstanceType]] = {}
        for ami_id, types in self.ami_provider.get(instance_types).items():
            user_data = build_user_data(
                self.cluster_name,
                self.cluster_endpoint,
                constraints,
                types,
                additional_labels,
                self.ca_bundle,
            )
            template = self._ensure(
                LaunchTemplate(
                    name=self._template_name(
                        ami_id, user_data, security_group_ids, provider
                    ),
                    image_id=ami_id,
                    instance_profile=provider.instance_profile,
                    security_group_ids=tuple(security_group_ids),
                    user_data=user_data,
                    tags=merge_tags(self.cluster_name, "", provider.tags),
                )
            )
            result[template.name] = types
        return result

    def _template_name(
        self,
        ami_id: str,
        user_data: str,
        security_group_ids: Sequence[str],
        provider: Ec2Provider,
    ) -> str:
        """Deterministic content-hash name (ref: launchtemplate.go
        launchTemplateName:64-83 — same inputs must produce the same
        template so templates are reused, not multiplied)."""
        payload = json.dumps(
            {
                "cluster": self.cluster_name,
                "userData": user_data,
                "instanceProfile": provider.instance_profile,
                "securityGroups": sorted(security_group_ids),
                "ami": ami_id,
                "tags": dict(sorted(provider.tags.items())),
            },
            sort_keys=True,
        )
        digest = hashlib.sha256(payload.encode()).hexdigest()[:16]
        return LAUNCH_TEMPLATE_NAME_FORMAT.format(
            cluster=self.cluster_name, hash=digest
        )

    def _ensure(self, desired: LaunchTemplate) -> LaunchTemplate:
        """Cache → describe → create (ref: ensureLaunchTemplate:127-157)."""
        with self._lock:
            cached = self._cache.get(desired.name)
            if cached is not None:
                return cached
            try:
                template = self.api.describe_launch_template(desired.name)
            except Exception as error:  # noqa: BLE001 — coded errors only
                if not is_not_found(error):
                    raise
                template = self.api.create_launch_template(desired)
            self._cache.set(desired.name, template)
            return template
