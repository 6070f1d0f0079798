"""Orphaned-pod garbage collection.

Ref: the reference leans on kube-controller-manager's podgc
(`gcOrphaned`) to delete pods bound to nodes that no longer exist — a bind
can land on a node concurrently being drained+deleted (the provisioner's
bind fan-out racing the termination controller), and nothing else ever
revisits such a pod: its node key no longer reconciles and the pod itself
is not unschedulable. Since this framework replaces the surrounding
cluster, it must carry the reaper itself.

Deletion requires TWO consecutive sightings of the same orphan (one sweep
interval apart): a single observation can be a transient watch-ordering
window where the pod's binding event arrived before the node's ADDED event.
"""

from __future__ import annotations

from typing import Set, Tuple

from karpenter_tpu_torch.controllers.cluster import Cluster
from karpenter_tpu_torch.utils import logging as klog
from karpenter_tpu_torch.utils.metrics import REGISTRY

log = klog.named("podgc")

SWEEP_SECONDS = 10.0

PODGC_DELETED_TOTAL = REGISTRY.counter(
    "podgc_deleted_total", "Orphaned pods reaped (bound to a vanished node)"
)
PODGC_SUSPECTS = REGISTRY.gauge(
    "podgc_suspect_count", "Orphan candidates awaiting a second sighting"
)


class PodGcController:
    """Periodic sweep (Manager drives it like the metrics poll): delete
    bound, non-terminating pods whose node vanished."""

    def __init__(self, cluster: Cluster):
        self.cluster = cluster
        # Keyed by (namespace, name, uid): a name reused by a NEW pod
        # incarnation must restart the two-sighting clock — matching a new
        # pod against an old incarnation's suspicion would delete a live
        # pod on its first sighting (kube-controller-manager's gcOrphaned
        # likewise operates on UIDs).
        self._suspects: Set[Tuple[str, str, str]] = set()

    def reconcile(self, _key=None) -> float:
        node_names = {node.name for node in self.cluster.list_nodes()}
        orphans: Set[Tuple[str, str, str]] = set()
        for pod in self.cluster.list_pods():
            # Terminating pods are orphans too: with the node gone there is
            # no kubelet left to complete the eviction, so the pod would
            # stay terminating forever (kube's gcOrphaned force-deletes the
            # same way). The two-sighting rule still applies.
            if pod.node_name is not None and pod.node_name not in node_names:
                orphans.add((pod.namespace, pod.name, getattr(pod, "uid", "") or ""))
        deleted: Set[Tuple[str, str, str]] = set()
        for key in orphans & self._suspects:  # second consecutive sighting
            namespace, name, uid = key
            try:
                # UID-preconditioned: a same-name pod re-created (and bound to
                # a live node) between this sweep's listing and the delete must
                # survive — kube-controller-manager's gcOrphaned does the same.
                removed = self.cluster.delete_pod(namespace, name, uid=uid or None)
                deleted.add(key)  # observed incarnation is gone either way
                if removed:
                    PODGC_DELETED_TOTAL.inc()
                    log.info(
                        "deleted orphaned pod %s/%s (node gone)", namespace, name
                    )
            except Exception:  # noqa: BLE001 — transient failure or raced
                # deletion: STAY a suspect so the very next sweep retries.
                log.debug("orphan %s/%s delete failed; retrying", namespace, name)
        self._suspects = orphans - deleted
        PODGC_SUSPECTS.set(len(self._suspects))
        return SWEEP_SECONDS
