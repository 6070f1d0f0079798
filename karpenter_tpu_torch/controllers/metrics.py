"""Metrics controller: periodic gauges for capacity and pod phases.

Ref: pkg/controllers/metrics/{controller,nodes,pods}.go — polls every 10s per
Provisioner and publishes node counts by {provisioner}×{zone|arch|instance
-type} plus pod-phase counts.
"""

from __future__ import annotations

from collections import Counter

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.controllers.cluster import Cluster
from karpenter_tpu_torch.utils.metrics import REGISTRY

POLL_SECONDS = 10.0  # ref: metrics/controller.go:69

NODE_COUNT_BY_ZONE = REGISTRY.gauge(
    "nodes_by_zone", "Node count per provisioner and zone", ["provisioner", "zone"]
)
NODE_COUNT_BY_ARCH = REGISTRY.gauge(
    "nodes_by_arch", "Node count per provisioner and architecture", ["provisioner", "arch"]
)
NODE_COUNT_BY_INSTANCE_TYPE = REGISTRY.gauge(
    "nodes_by_instance_type",
    "Node count per provisioner and instance type",
    ["provisioner", "instance_type"],
)
POD_COUNT_BY_PHASE = REGISTRY.gauge(
    "pods_by_phase", "Pod count per provisioner and phase", ["provisioner", "phase"]
)

# Ready-vs-total split (ref: metrics/nodes.go:33-96 — capacity_node_count by
# provisioner plus ready_node_* splits by zone/arch/instance-type/OS).
NODE_COUNT = REGISTRY.gauge(
    "capacity_node_count", "Total node count by provisioner", ["provisioner"]
)
READY_NODE_COUNT = REGISTRY.gauge(
    "capacity_ready_node_count",
    "Count of ready nodes by provisioner and zone",
    ["provisioner", "zone"],
)
READY_NODE_COUNT_BY_ARCH = REGISTRY.gauge(
    "capacity_ready_node_arch_count",
    "Count of ready nodes by architecture, provisioner, and zone",
    ["arch", "provisioner", "zone"],
)
READY_NODE_COUNT_BY_INSTANCE_TYPE = REGISTRY.gauge(
    "capacity_ready_node_instancetype_count",
    "Count of ready nodes by instance type, provisioner, and zone",
    ["instance_type", "provisioner", "zone"],
)
READY_NODE_COUNT_BY_OS = REGISTRY.gauge(
    "capacity_ready_node_os_count",
    "Count of ready nodes by operating system, provisioner, and zone",
    ["os", "provisioner", "zone"],
)


class MetricsController:
    def __init__(self, cluster: Cluster):
        self.cluster = cluster

    def reconcile(self, provisioner_name: str) -> float:
        # Clear this provisioner's series first so vanished zones/types/phases
        # don't keep reporting their last value forever. The provisioner label
        # is first on the by-provisioner gauges, second on the ready splits
        # whose leading label is the breakdown dimension (matching the
        # reference's label order, nodes.go:55-96).
        for gauge in (
            NODE_COUNT_BY_ZONE,
            NODE_COUNT_BY_ARCH,
            NODE_COUNT_BY_INSTANCE_TYPE,
            POD_COUNT_BY_PHASE,
            NODE_COUNT,
            READY_NODE_COUNT,
        ):
            gauge.remove_where(lambda key: key and key[0] == provisioner_name)
        for gauge in (
            READY_NODE_COUNT_BY_ARCH,
            READY_NODE_COUNT_BY_INSTANCE_TYPE,
            READY_NODE_COUNT_BY_OS,
        ):
            gauge.remove_where(
                lambda key: len(key) > 1 and key[1] == provisioner_name
            )
        nodes = self.cluster.list_nodes(
            predicate=lambda n: n.labels.get(wellknown.PROVISIONER_NAME_LABEL)
            == provisioner_name
        )
        by_zone: Counter = Counter(n.zone for n in nodes if n.zone)
        by_arch: Counter = Counter(
            n.labels.get(wellknown.ARCH_LABEL, "") for n in nodes
        )
        by_type: Counter = Counter(n.instance_type for n in nodes if n.instance_type)
        for zone, count in by_zone.items():
            NODE_COUNT_BY_ZONE.set(count, provisioner_name, zone)
        for arch, count in by_arch.items():
            if arch:
                NODE_COUNT_BY_ARCH.set(count, provisioner_name, arch)
        for instance_type, count in by_type.items():
            NODE_COUNT_BY_INSTANCE_TYPE.set(count, provisioner_name, instance_type)

        # Ready-vs-total split (ref: nodes.go publishNodeCounts).
        NODE_COUNT.set(len(nodes), provisioner_name)
        ready = [n for n in nodes if n.ready]
        ready_by_zone: Counter = Counter(n.zone for n in ready if n.zone)
        for zone, count in ready_by_zone.items():
            READY_NODE_COUNT.set(count, provisioner_name, zone)
        ready_arch: Counter = Counter(
            (n.labels.get(wellknown.ARCH_LABEL, ""), n.zone) for n in ready if n.zone
        )
        for (arch, zone), count in ready_arch.items():
            if arch:
                READY_NODE_COUNT_BY_ARCH.set(count, arch, provisioner_name, zone)
        ready_type: Counter = Counter(
            (n.instance_type, n.zone) for n in ready if n.zone and n.instance_type
        )
        for (instance_type, zone), count in ready_type.items():
            READY_NODE_COUNT_BY_INSTANCE_TYPE.set(
                count, instance_type, provisioner_name, zone
            )
        ready_os: Counter = Counter(
            (n.labels.get(wellknown.OS_LABEL, ""), n.zone) for n in ready if n.zone
        )
        for (os_name, zone), count in ready_os.items():
            if os_name:
                READY_NODE_COUNT_BY_OS.set(count, os_name, provisioner_name, zone)

        node_names = {n.name for n in nodes}
        phases: Counter = Counter(
            p.phase for p in self.cluster.list_pods() if p.node_name in node_names
        )
        for phase, count in phases.items():
            POD_COUNT_BY_PHASE.set(count, provisioner_name, phase)
        return POLL_SECONDS
