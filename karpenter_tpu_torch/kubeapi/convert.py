"""Kubernetes API object ↔ framework dataclass converters.

Ref: the reference operates directly on client-go typed objects; our
controllers operate on the trimmed dataclasses in api/pods.py and
cloudprovider.NodeSpec. These converters are the boundary: kube Pod/Node/
DaemonSet/Lease JSON (what an apiserver serves) to and from those
dataclasses, with the same semantics the reference reads —
requests folded per pkg/utils/resources (max(init) ⌄ sum(containers)),
unschedulable from the PodScheduled condition, node identity labels from the
well-known keys.
"""

from __future__ import annotations

import datetime
from typing import Dict, List, Optional

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.pods import PodSpec, PreferredTerm, TopologySpreadConstraint
from karpenter_tpu_torch.api.provisioner import Provisioner
from karpenter_tpu_torch.api.requirements import Requirement
from karpenter_tpu_torch.api.resources import ResourceList, parse_resource_list
from karpenter_tpu_torch.api.serialization import provisioner_from_dict, provisioner_to_dict
from karpenter_tpu_torch.api.taints import Taint, Toleration
from karpenter_tpu_torch.cloudprovider import NodeSpec

GROUP = "karpenter.tpu"
VERSION = "v1alpha1"

# kube well-known node labels (the apiserver-side spellings).
NODE_INSTANCE_TYPE_LABEL = "node.kubernetes.io/instance-type"


# --- time ------------------------------------------------------------------


def rfc3339(epoch: Optional[float]) -> Optional[str]:
    if epoch is None:
        return None
    return (
        datetime.datetime.fromtimestamp(epoch, tz=datetime.timezone.utc)
        .isoformat()
        .replace("+00:00", "Z")
    )


def from_rfc3339(text: Optional[str]) -> Optional[float]:
    if not text:
        return None
    return datetime.datetime.fromisoformat(text.replace("Z", "+00:00")).timestamp()


# --- quantities ------------------------------------------------------------


def quantity_str(resource: str, value: float) -> str:
    """Render a parsed quantity back into kube syntax: millicores for cpu,
    Mi for memory-sized byte counts, plain integers otherwise."""
    if resource == "cpu":
        millis = round(value * 1000)
        if millis % 1000 == 0:
            return str(millis // 1000)
        return f"{millis}m"
    if value >= 1024**2 and value % (1024**2) == 0:
        return f"{int(value // 1024**2)}Mi"
    if value == int(value):
        return str(int(value))
    return repr(value)


def resource_list_to_kube(resources: ResourceList) -> Dict[str, str]:
    # NodeSpec.capacity may carry raw quantity strings (callers pass them
    # through unparsed); normalize before rendering.
    return {
        key: quantity_str(key, parse_resource_list({key: value})[key])
        for key, value in resources.items()
    }


# --- requirements / affinity ----------------------------------------------


def _expr_to_requirement(expr: dict) -> Requirement:
    return Requirement(
        key=expr.get("key", ""),
        operator=expr.get("operator", "In"),
        values=tuple(expr.get("values", ())),
    )


def _requirement_to_expr(requirement: Requirement) -> dict:
    return {
        "key": requirement.key,
        "operator": requirement.operator,
        "values": list(requirement.values),
    }


# --- pods ------------------------------------------------------------------


def pod_requests(spec: dict) -> ResourceList:
    """Effective pod requests (ref: pkg/utils/resources RequestsForPods —
    per resource, max(any single init container, sum of app containers))."""
    totals: Dict[str, float] = {}
    for container in spec.get("containers", []) or []:
        requests = parse_resource_list(
            (container.get("resources") or {}).get("requests") or {}
        )
        for key, value in requests.items():
            totals[key] = totals.get(key, 0.0) + value
    for container in spec.get("initContainers", []) or []:
        requests = parse_resource_list(
            (container.get("resources") or {}).get("requests") or {}
        )
        for key, value in requests.items():
            totals[key] = max(totals.get(key, 0.0), value)
    return totals


def _node_affinity_from_kube(spec: dict):
    """(required_terms, match_fields_terms, preferred_terms) from the kube
    nodeAffinity stanza."""
    affinity = (spec.get("affinity") or {}).get("nodeAffinity") or {}
    required = affinity.get("requiredDuringSchedulingIgnoredDuringExecution") or {}
    required_terms: List[List[Requirement]] = []
    match_fields_terms: List[dict] = []
    for term in required.get("nodeSelectorTerms", []) or []:
        exprs = term.get("matchExpressions") or []
        if exprs:
            required_terms.append([_expr_to_requirement(e) for e in exprs])
        for field_expr in term.get("matchFields") or []:
            match_fields_terms.append(dict(field_expr))
    return required_terms, match_fields_terms, _preferred_terms_from_kube(affinity)


def _preferred_terms_from_kube(affinity: dict) -> List[PreferredTerm]:
    return [
        PreferredTerm(
            weight=int(item.get("weight", 1)),
            requirements=[
                _expr_to_requirement(e)
                for e in (item.get("preference") or {}).get("matchExpressions") or []
            ],
        )
        for item in affinity.get("preferredDuringSchedulingIgnoredDuringExecution")
        or []
    ]


def _pod_affinity_from_kube(spec: dict):
    """(pod_affinity_terms, pod_anti_affinity_terms) — raw kube term dicts,
    the scheduler consumes them directly."""
    pod_aff = (spec.get("affinity") or {}).get("podAffinity") or {}
    pod_anti = (spec.get("affinity") or {}).get("podAntiAffinity") or {}
    return (
        list(pod_aff.get("requiredDuringSchedulingIgnoredDuringExecution") or []),
        list(pod_anti.get("requiredDuringSchedulingIgnoredDuringExecution") or []),
    )


def _tolerations_from_kube(spec: dict) -> List[Toleration]:
    return [
        Toleration(
            key=t.get("key", ""),
            operator=t.get("operator", "Equal"),
            value=t.get("value", ""),
            effect=t.get("effect", ""),
        )
        for t in spec.get("tolerations", []) or []
    ]


def _topology_spread_from_kube(spec: dict) -> List[TopologySpreadConstraint]:
    return [
        TopologySpreadConstraint(
            max_skew=int(c.get("maxSkew", 1)),
            topology_key=c.get("topologyKey", ""),
            when_unsatisfiable=c.get("whenUnsatisfiable", "DoNotSchedule"),
            match_labels=dict(
                (c.get("labelSelector") or {}).get("matchLabels") or {}
            ),
        )
        for c in spec.get("topologySpreadConstraints", []) or []
    ]


def _unschedulable_from_kube(status: dict) -> bool:
    """The PodScheduled=False/Unschedulable condition the reference keys
    provisioning on."""
    for condition in status.get("conditions", []) or []:
        if (
            condition.get("type") == "PodScheduled"
            and condition.get("status") == "False"
            and condition.get("reason") == "Unschedulable"
        ):
            return True
    return False


def _owner_kind_from_kube(metadata: dict) -> Optional[str]:
    """The controlling owner's kind; first owner's kind as fallback."""
    owner_kind = None
    for owner in metadata.get("ownerReferences", []) or []:
        if owner.get("controller"):
            return owner.get("kind")
        owner_kind = owner_kind or owner.get("kind")
    return owner_kind


def pod_from_kube(obj: dict) -> PodSpec:
    metadata = obj.get("metadata") or {}
    spec = obj.get("spec") or {}
    status = obj.get("status") or {}
    required_terms, match_fields_terms, preferred_terms = _node_affinity_from_kube(spec)
    pod_affinity_terms, pod_anti_affinity_terms = _pod_affinity_from_kube(spec)

    pod = PodSpec(
        name=metadata.get("name", ""),
        namespace=metadata.get("namespace", "default"),
        labels=dict(metadata.get("labels") or {}),
        annotations=dict(metadata.get("annotations") or {}),
        requests=pod_requests(spec),
        node_selector=dict(spec.get("nodeSelector") or {}),
        required_terms=required_terms,
        match_fields_terms=match_fields_terms,
        preferred_terms=preferred_terms,
        tolerations=_tolerations_from_kube(spec),
        topology_spread=_topology_spread_from_kube(spec),
        pod_affinity_terms=pod_affinity_terms,
        pod_anti_affinity_terms=pod_anti_affinity_terms,
        owner_kind=_owner_kind_from_kube(metadata),
        priority_class_name=spec.get("priorityClassName", ""),
        phase=status.get("phase", "Pending"),
        node_name=spec.get("nodeName") or None,
        unschedulable=_unschedulable_from_kube(status),
        deletion_timestamp=from_rfc3339(metadata.get("deletionTimestamp")),
        created_at=from_rfc3339(metadata.get("creationTimestamp")),
    )
    if metadata.get("uid"):
        pod.uid = metadata["uid"]
    return pod


def _pod_metadata_to_kube(pod: PodSpec) -> dict:
    metadata: dict = {
        "name": pod.name,
        "namespace": pod.namespace,
        "uid": pod.uid,
        "labels": dict(pod.labels),
        "annotations": dict(pod.annotations),
    }
    if pod.owner_kind:
        metadata["ownerReferences"] = [
            {
                "apiVersion": "apps/v1",
                "kind": pod.owner_kind,
                "name": f"{pod.name}-owner",
                "controller": True,
            }
        ]
    if pod.deletion_timestamp is not None:
        metadata["deletionTimestamp"] = rfc3339(pod.deletion_timestamp)
    if pod.created_at is not None:
        metadata["creationTimestamp"] = rfc3339(pod.created_at)
    return metadata


def pod_to_kube(pod: PodSpec) -> dict:
    """PodSpec → kube Pod JSON (one synthetic container carrying the folded
    requests — enough for tests and tooling to seed an apiserver; production
    pods arrive from the apiserver, not from this direction)."""
    requests = {
        k: quantity_str(k, v)
        for k, v in pod.requests.items()
        if k != wellknown.RESOURCE_PODS
    }
    affinity: dict = {}
    node_affinity: dict = {}
    if pod.required_terms or pod.match_fields_terms:
        terms = [
            {"matchExpressions": [_requirement_to_expr(r) for r in term]}
            for term in pod.required_terms
        ]
        if pod.match_fields_terms:
            terms.append({"matchFields": [dict(t) for t in pod.match_fields_terms]})
        node_affinity["requiredDuringSchedulingIgnoredDuringExecution"] = {
            "nodeSelectorTerms": terms
        }
    if pod.preferred_terms:
        node_affinity["preferredDuringSchedulingIgnoredDuringExecution"] = [
            {
                "weight": term.weight,
                "preference": {
                    "matchExpressions": [
                        _requirement_to_expr(r) for r in term.requirements
                    ]
                },
            }
            for term in pod.preferred_terms
        ]
    if node_affinity:
        affinity["nodeAffinity"] = node_affinity
    if pod.pod_affinity_terms:
        affinity["podAffinity"] = {
            "requiredDuringSchedulingIgnoredDuringExecution": [
                dict(t) for t in pod.pod_affinity_terms
            ]
        }
    if pod.pod_anti_affinity_terms:
        affinity["podAntiAffinity"] = {
            "requiredDuringSchedulingIgnoredDuringExecution": [
                dict(t) for t in pod.pod_anti_affinity_terms
            ]
        }

    spec: dict = {
        "containers": [{"name": "main", "resources": {"requests": requests}}],
    }
    if pod.node_selector:
        spec["nodeSelector"] = dict(pod.node_selector)
    if affinity:
        spec["affinity"] = affinity
    if pod.tolerations:
        spec["tolerations"] = [
            {
                "key": t.key,
                "operator": t.operator,
                "value": t.value,
                "effect": t.effect,
            }
            for t in pod.tolerations
        ]
    if pod.topology_spread:
        spec["topologySpreadConstraints"] = [
            {
                "maxSkew": c.max_skew,
                "topologyKey": c.topology_key,
                "whenUnsatisfiable": c.when_unsatisfiable,
                "labelSelector": {"matchLabels": dict(c.match_labels)},
            }
            for c in pod.topology_spread
        ]
    if pod.priority_class_name:
        spec["priorityClassName"] = pod.priority_class_name
    if pod.node_name:
        spec["nodeName"] = pod.node_name

    metadata = _pod_metadata_to_kube(pod)

    status: dict = {"phase": pod.phase}
    if pod.unschedulable:
        status["conditions"] = [
            {
                "type": "PodScheduled",
                "status": "False",
                "reason": "Unschedulable",
            }
        ]
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": metadata,
        "spec": spec,
        "status": status,
    }


# --- nodes -----------------------------------------------------------------


def node_from_kube(obj: dict) -> NodeSpec:
    metadata = obj.get("metadata") or {}
    spec = obj.get("spec") or {}
    status = obj.get("status") or {}
    labels = dict(metadata.get("labels") or {})

    ready = False
    status_reported_at: Optional[float] = None
    for condition in status.get("conditions", []) or []:
        if condition.get("type") == "Ready":
            ready = condition.get("status") == "True"
            status_reported_at = from_rfc3339(
                condition.get("lastHeartbeatTime")
            ) or from_rfc3339(condition.get("lastTransitionTime"))

    return NodeSpec(
        name=metadata.get("name", ""),
        labels=labels,
        annotations=dict(metadata.get("annotations") or {}),
        taints=[
            Taint(
                key=t.get("key", ""),
                value=t.get("value", ""),
                effect=t.get("effect", "NoSchedule"),
            )
            for t in spec.get("taints", []) or []
        ],
        capacity=parse_resource_list(status.get("allocatable") or status.get("capacity") or {}),
        instance_type=labels.get(NODE_INSTANCE_TYPE_LABEL)
        or labels.get(wellknown.INSTANCE_TYPE_LABEL, ""),
        zone=labels.get(wellknown.ZONE_LABEL, ""),
        capacity_type=labels.get(wellknown.CAPACITY_TYPE_LABEL, ""),
        provider_id=spec.get("providerID", ""),
        ready=ready,
        unschedulable=bool(spec.get("unschedulable", False)),
        finalizers=list(metadata.get("finalizers") or []),
        created_at=from_rfc3339(metadata.get("creationTimestamp")) or 0.0,
        deletion_timestamp=from_rfc3339(metadata.get("deletionTimestamp")),
        status_reported_at=status_reported_at,
    )


def node_to_kube(node: NodeSpec) -> dict:
    labels = dict(node.labels)
    if node.instance_type:
        labels.setdefault(NODE_INSTANCE_TYPE_LABEL, node.instance_type)
        labels.setdefault(wellknown.INSTANCE_TYPE_LABEL, node.instance_type)
    if node.zone:
        labels.setdefault(wellknown.ZONE_LABEL, node.zone)
    if node.capacity_type:
        labels.setdefault(wellknown.CAPACITY_TYPE_LABEL, node.capacity_type)

    metadata: dict = {
        "name": node.name,
        "labels": labels,
        "annotations": dict(node.annotations),
        "finalizers": list(node.finalizers),
    }
    if node.created_at:
        metadata["creationTimestamp"] = rfc3339(node.created_at)
    if node.deletion_timestamp is not None:
        metadata["deletionTimestamp"] = rfc3339(node.deletion_timestamp)

    spec: dict = {}
    if node.taints:
        spec["taints"] = [
            {"key": t.key, "value": t.value, "effect": t.effect} for t in node.taints
        ]
    if node.unschedulable:
        spec["unschedulable"] = True
    if node.provider_id:
        spec["providerID"] = node.provider_id

    status: dict = {}
    if node.capacity:
        status["capacity"] = resource_list_to_kube(node.capacity)
        status["allocatable"] = resource_list_to_kube(node.capacity)
    conditions = [
        {
            "type": "Ready",
            "status": "True" if node.ready else "False",
        }
    ]
    if node.status_reported_at is not None:
        conditions[0]["lastHeartbeatTime"] = rfc3339(node.status_reported_at)
    status["conditions"] = conditions

    return {
        "apiVersion": "v1",
        "kind": "Node",
        "metadata": metadata,
        "spec": spec,
        "status": status,
    }


# --- provisioners (CRD) ----------------------------------------------------


def provisioner_from_kube(obj: dict) -> Provisioner:
    """The CRD schema matches api/serialization.py field-for-field (see
    deploy/crds) — only the envelope differs."""
    provisioner = provisioner_from_dict(obj)
    metadata = obj.get("metadata") or {}
    provisioner.deletion_timestamp = from_rfc3339(metadata.get("deletionTimestamp"))
    return provisioner


def provisioner_to_kube(provisioner: Provisioner) -> dict:
    obj = provisioner_to_dict(provisioner)
    obj["apiVersion"] = f"{GROUP}/{VERSION}"
    obj["kind"] = "Provisioner"
    if provisioner.deletion_timestamp is not None:
        obj.setdefault("metadata", {})["deletionTimestamp"] = rfc3339(
            provisioner.deletion_timestamp
        )
    return obj


# --- daemonsets ------------------------------------------------------------


def daemonset_template_from_kube(obj: dict) -> PodSpec:
    """DaemonSet → its pod template as a PodSpec (the scheduler only needs
    the template's requests/constraints for overhead reservation,
    ref: binpacking/packer.go getDaemons:144-158)."""
    metadata = obj.get("metadata") or {}
    template = ((obj.get("spec") or {}).get("template")) or {}
    pod = pod_from_kube(
        {
            "metadata": {
                "name": f"{metadata.get('name', 'daemonset')}-template",
                "namespace": metadata.get("namespace", "default"),
                **(template.get("metadata") or {}),
            },
            "spec": template.get("spec") or {},
        }
    )
    pod.owner_kind = "DaemonSet"
    return pod


# --- leases (coordination.k8s.io/v1) ---------------------------------------


def lease_to_kube(
    name: str,
    holder: str,
    duration_s: float,
    acquired_at: float,
    transitions: int = 1,
) -> dict:
    return {
        "apiVersion": "coordination.k8s.io/v1",
        "kind": "Lease",
        "metadata": {"name": name, "namespace": "kube-system"},
        "spec": {
            "holderIdentity": holder,
            "leaseDurationSeconds": int(duration_s),
            "renewTime": rfc3339(acquired_at),
            # The real coordination.k8s.io field: bumped only on holder
            # change. This IS the fencing token (utils/fence.py) — a stale
            # leader's generation can never equal its successor's.
            "leaseTransitions": int(transitions),
        },
    }


def lease_from_kube(obj: dict) -> Optional[tuple]:
    """(holder, renew_epoch, duration_s, transitions) or None for a vacant
    lease."""
    spec = obj.get("spec") or {}
    holder = spec.get("holderIdentity")
    if not holder:
        return None
    renew = from_rfc3339(spec.get("renewTime")) or 0.0
    return (
        holder,
        renew,
        float(spec.get("leaseDurationSeconds", 15)),
        int(spec.get("leaseTransitions", 1)),
    )
