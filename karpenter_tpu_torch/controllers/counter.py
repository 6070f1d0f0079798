"""Counter: aggregate per-Provisioner node capacity into status.resources,
which Limits.exceeded_by consumes (ref: pkg/controllers/counter/controller.go).
"""

from __future__ import annotations

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.resources import add_resources
from karpenter_tpu_torch.controllers.cluster import Cluster


class CounterController:
    def __init__(self, cluster: Cluster):
        self.cluster = cluster

    def reconcile(self, provisioner_name: str) -> None:
        provisioner = self.cluster.try_get_provisioner(provisioner_name)
        if provisioner is None:
            return
        nodes = self.cluster.list_nodes(
            predicate=lambda n: n.labels.get(wellknown.PROVISIONER_NAME_LABEL)
            == provisioner_name
            and n.deletion_timestamp is None
        )
        resources = add_resources(*[node.capacity for node in nodes])
        # Write-through only on change: a status write emits a watch event
        # which re-enqueues this reconcile — unconditional writes would spin.
        if resources != provisioner.status.resources:
            provisioner.status.resources = resources
            self.cluster.update_provisioner_status(provisioner)
