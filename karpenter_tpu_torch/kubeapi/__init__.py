"""Kubernetes apiserver backend for the cluster store.

Ref: pkg/controllers/manager.go:33-66 + cmd/controller/main.go:61-99 — the
reference's controllers reconcile a live apiserver through controller-runtime
(informer cache for reads, direct client writes, watch-driven requeues).
This package is that architecture for the TPU rebuild: `ApiServerCluster`
mirrors watched objects into the in-memory `Cluster` (the informer cache),
writes through to the apiserver REST API, and pumps watch streams so the
runtime's reconcile loops fire on live cluster changes. The in-memory store
stays the envtest analogue for tests; production selects the backend with
--kube-api-server (cmd/controller.py).
"""

from karpenter_tpu_torch.kubeapi.client import (
    ApiError,
    KubeClient,
    RetryPolicy,
    Transport,
    TransportError,
    critical_lane,
)
from karpenter_tpu_torch.kubeapi.cluster import ApiServerCluster

__all__ = [
    "ApiError",
    "ApiServerCluster",
    "KubeClient",
    "RetryPolicy",
    "Transport",
    "TransportError",
    "critical_lane",
]
