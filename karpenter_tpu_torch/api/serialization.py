"""JSON (de)serialization for the API types — the CRD wire format.

Ref: the reference's types are kube CRDs serialized by apimachinery
(zz_generated.deepcopy.go et al). We keep the same field names as the
v1alpha5 YAML so existing Provisioner manifests translate directly.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from karpenter_tpu_torch.api.pods import PodSpec, PreferredTerm, TopologySpreadConstraint
from karpenter_tpu_torch.api.provisioner import (
    Constraints,
    Limits,
    Provisioner,
    ProvisionerSpec,
    ProvisionerStatus,
)
from karpenter_tpu_torch.api.requirements import Requirement, Requirements
from karpenter_tpu_torch.api.taints import Taint, Toleration


def requirement_to_dict(requirement: Requirement) -> Dict[str, Any]:
    return {
        "key": requirement.key,
        "operator": requirement.operator,
        "values": list(requirement.values),
    }


def requirement_from_dict(data: Dict[str, Any]) -> Requirement:
    return Requirement(
        key=data["key"],
        operator=data["operator"],
        values=tuple(data.get("values", ())),
    )


def taint_to_dict(taint: Taint) -> Dict[str, Any]:
    return {"key": taint.key, "value": taint.value, "effect": taint.effect}


def taint_from_dict(data: Dict[str, Any]) -> Taint:
    return Taint(
        key=data["key"],
        value=data.get("value", ""),
        effect=data.get("effect", "NoSchedule"),
    )


def provisioner_to_dict(provisioner: Provisioner) -> Dict[str, Any]:
    spec = provisioner.spec
    constraints = spec.constraints
    out: Dict[str, Any] = {
        "apiVersion": "karpenter.tpu/v1alpha1",
        "kind": "Provisioner",
        "metadata": {"name": provisioner.name, "uid": provisioner.uid},
        "spec": {
            "labels": dict(constraints.labels),
            "taints": [taint_to_dict(t) for t in constraints.taints],
            "requirements": [
                requirement_to_dict(r) for r in constraints.requirements
            ],
        },
        "status": {
            "resources": dict(provisioner.status.resources),
            "lastScaleTime": provisioner.status.last_scale_time,
            "conditions": [
                {"type": kind, "status": "True" if value else "False"}
                for kind, value in sorted(provisioner.status.conditions.items())
            ],
        },
    }
    if constraints.provider is not None:
        out["spec"]["provider"] = constraints.provider
    if spec.ttl_seconds_after_empty is not None:
        out["spec"]["ttlSecondsAfterEmpty"] = spec.ttl_seconds_after_empty
    if spec.ttl_seconds_until_expired is not None:
        out["spec"]["ttlSecondsUntilExpired"] = spec.ttl_seconds_until_expired
    if spec.limits is not None:
        out["spec"]["limits"] = {"resources": dict(spec.limits.resources)}
    if spec.weight:
        out["spec"]["weight"] = spec.weight
    return out


def provisioner_from_dict(data: Dict[str, Any]) -> Provisioner:
    metadata = data.get("metadata", {})
    spec_data = data.get("spec", {})
    limits_data = spec_data.get("limits")
    spec = ProvisionerSpec(
        constraints=Constraints(
            labels=dict(spec_data.get("labels", {})),
            taints=[taint_from_dict(t) for t in spec_data.get("taints", [])],
            requirements=Requirements(
                requirement_from_dict(r) for r in spec_data.get("requirements", [])
            ),
            provider=spec_data.get("provider"),
        ),
        ttl_seconds_after_empty=spec_data.get("ttlSecondsAfterEmpty"),
        ttl_seconds_until_expired=spec_data.get("ttlSecondsUntilExpired"),
        limits=Limits(resources=dict(limits_data.get("resources", {})))
        if limits_data
        else None,
        weight=int(spec_data.get("weight", 0)),
    )
    provisioner = Provisioner(name=metadata.get("name", ""), spec=spec)
    if metadata.get("uid"):
        provisioner.uid = metadata["uid"]
    status = data.get("status", {})
    provisioner.status = ProvisionerStatus(
        last_scale_time=status.get("lastScaleTime"),
        conditions={
            c.get("type", ""): c.get("status") == "True"
            for c in status.get("conditions", [])
            if c.get("type")
        },
        resources=dict(status.get("resources", {})),
    )
    return provisioner


def pod_to_dict(pod: PodSpec) -> Dict[str, Any]:
    return {
        "metadata": {
            "name": pod.name,
            "namespace": pod.namespace,
            "uid": pod.uid,
            "labels": dict(pod.labels),
            "annotations": dict(pod.annotations),
            "creationTimestamp": pod.created_at,
        },
        "spec": {
            "requests": dict(pod.requests),
            "nodeSelector": dict(pod.node_selector),
            "requiredTerms": [
                [requirement_to_dict(r) for r in term] for term in pod.required_terms
            ],
            # matchFields terms round-trip so selection can REJECT pods using
            # them (ref: selection/controller.go validate:108-159) — dropping
            # them here would silently accept what the reference refuses.
            "matchFieldsTerms": [dict(t) for t in pod.match_fields_terms],
            "podAffinityTerms": [dict(t) for t in pod.pod_affinity_terms],
            "podAntiAffinityTerms": [dict(t) for t in pod.pod_anti_affinity_terms],
            "preferredTerms": [
                {
                    "weight": term.weight,
                    "requirements": [requirement_to_dict(r) for r in term.requirements],
                }
                for term in pod.preferred_terms
            ],
            "tolerations": [
                {
                    "key": t.key,
                    "operator": t.operator,
                    "value": t.value,
                    "effect": t.effect,
                }
                for t in pod.tolerations
            ],
            "topologySpreadConstraints": [
                {
                    "maxSkew": c.max_skew,
                    "topologyKey": c.topology_key,
                    "whenUnsatisfiable": c.when_unsatisfiable,
                    "matchLabels": dict(c.match_labels),
                }
                for c in pod.topology_spread
            ],
            "priorityClassName": pod.priority_class_name,
            "ownerKind": pod.owner_kind,
        },
        "status": {
            "phase": pod.phase,
            "nodeName": pod.node_name,
            "unschedulable": pod.unschedulable,
            "deletionTimestamp": pod.deletion_timestamp,
        },
    }


def pod_from_dict(data: Dict[str, Any]) -> PodSpec:
    metadata = data.get("metadata", {})
    spec = data.get("spec", {})
    status = data.get("status", {})
    pod = PodSpec(
        name=metadata.get("name", ""),
        namespace=metadata.get("namespace", "default"),
        labels=dict(metadata.get("labels", {})),
        annotations=dict(metadata.get("annotations", {})),
        requests=dict(spec.get("requests", {})),
        node_selector=dict(spec.get("nodeSelector", {})),
        required_terms=[
            [requirement_from_dict(r) for r in term]
            for term in spec.get("requiredTerms", [])
        ],
        match_fields_terms=[dict(t) for t in spec.get("matchFieldsTerms", [])],
        pod_affinity_terms=[dict(t) for t in spec.get("podAffinityTerms", [])],
        pod_anti_affinity_terms=[
            dict(t) for t in spec.get("podAntiAffinityTerms", [])
        ],
        preferred_terms=[
            PreferredTerm(
                weight=term["weight"],
                requirements=[
                    requirement_from_dict(r) for r in term.get("requirements", [])
                ],
            )
            for term in spec.get("preferredTerms", [])
        ],
        tolerations=[
            Toleration(
                key=t.get("key", ""),
                operator=t.get("operator", "Equal"),
                value=t.get("value", ""),
                effect=t.get("effect", ""),
            )
            for t in spec.get("tolerations", [])
        ],
        topology_spread=[
            TopologySpreadConstraint(
                max_skew=c["maxSkew"],
                topology_key=c["topologyKey"],
                when_unsatisfiable=c.get("whenUnsatisfiable", "DoNotSchedule"),
                match_labels=dict(c.get("matchLabels", {})),
            )
            for c in spec.get("topologySpreadConstraints", [])
        ],
        priority_class_name=spec.get("priorityClassName", ""),
        owner_kind=spec.get("ownerKind"),
        phase=status.get("phase", "Pending"),
        node_name=status.get("nodeName"),
        unschedulable=status.get("unschedulable", False),
        deletion_timestamp=status.get("deletionTimestamp"),
        created_at=metadata.get("creationTimestamp"),
    )
    if metadata.get("uid"):
        pod.uid = metadata["uid"]
    return pod
