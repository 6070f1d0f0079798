"""Leaked-capacity garbage collection.

A controller that dies between `create_fleet` returning and node
registration leaves a PAID instance with no Node object pointing at it —
nothing else in the pipeline ever revisits such an instance: it is not a
Node (no lifecycle reconcile), its pods were never bound (selection retries
them onto NEW capacity), and the provider keeps billing. The reference
ecosystem handles this with a cloud-side garbage collector reconciling
provider instances against cluster Nodes by the ownership tag; this
controller carries that reaper for every `CloudProvider` that can enumerate
owned capacity (`list_instances`).

Semantics (the podgc pattern, hardened for money):

- **Launch grace TTL**: an instance younger than `grace_seconds` is never a
  candidate — the launch→register window is seconds, but a slow bootstrap
  (AMI pull, kubelet join) must not get its capacity shot out from under it.
  When the provider can't report `launched_at` (0.0 = unknown), the grace
  clock runs from the first GC sighting instead.
- **Two consecutive sightings**: a single observation can be a transient
  ordering window (DescribeInstances returning before the Node watch event
  lands, or a Node flapping through a re-register). Termination requires
  the same orphan on two sweeps in a row.
- **Terminate-or-retry**: a failed terminate keeps the instance a suspect,
  so the very next sweep retries; success counts `instancegc_terminated_total`
  — the alert signal that the control plane is leaking launches.
"""

from __future__ import annotations

from typing import Dict

from karpenter_tpu_torch.cloudprovider import CloudProvider
from karpenter_tpu_torch.controllers.cluster import Cluster
from karpenter_tpu_torch.utils import logging as klog
from karpenter_tpu_torch.utils.metrics import REGISTRY

log = klog.named("instancegc")

SWEEP_SECONDS = 30.0
# Launch→register grace: generous against slow node bootstraps, tiny against
# the forever-leak it bounds (a v4-8 slice leaked overnight costs more than
# this window ever can).
LAUNCH_GRACE_SECONDS = 300.0

INSTANCEGC_TERMINATED_TOTAL = REGISTRY.counter(
    "instancegc_terminated_total",
    "Leaked instances terminated (owned capacity never matched by a Node)",
)
INSTANCEGC_SUSPECTS = REGISTRY.gauge(
    "instancegc_suspect_count",
    "Node-less owned instances awaiting a second sighting or grace expiry",
)


class InstanceGcController:
    """Periodic sweep (Manager drives it like podgc): terminate owned
    provider instances that no cluster Node accounts for."""

    def __init__(
        self,
        cluster: Cluster,
        cloud: CloudProvider,
        grace_seconds: float = LAUNCH_GRACE_SECONDS,
    ):
        self.cluster = cluster
        self.cloud = cloud
        self.grace_seconds = grace_seconds
        # provider_id -> time of FIRST consecutive sighting; doubles as the
        # grace anchor for instances with unknown launched_at.
        self._suspects: Dict[str, float] = {}

    def reconcile(self, _key=None) -> float:
        now = self.cluster.clock.now()
        node_ids = {
            node.provider_id
            for node in self.cluster.list_nodes()
            if node.provider_id
        }
        orphans = {}
        for instance in self.cloud.list_instances():
            if instance.provider_id in node_ids:
                continue
            if (
                instance.launched_at
                and now - instance.launched_at < self.grace_seconds
            ):
                # Within the launch grace TTL: a normal launch still
                # registering. Not even a suspect yet — the sighting clock
                # starts once the instance is old enough to be suspicious.
                continue
            orphans[instance.provider_id] = instance
        next_suspects: Dict[str, float] = {}
        for provider_id, instance in orphans.items():
            first_seen = self._suspects.get(provider_id)
            if first_seen is None:
                next_suspects[provider_id] = now  # first sighting: wait one sweep
                continue
            if not instance.launched_at and now - first_seen < self.grace_seconds:
                # Unknown launch time: run the grace window from the first
                # sighting so a provider with no launchTime still gets the
                # register window before its capacity is reaped.
                next_suspects[provider_id] = first_seen
                continue
            try:
                # Fenced like every other provider mutation: a deposed
                # leader must not reap capacity the successor may have just
                # registered (utils/fence.py).
                self.cluster.fence.check("cloud.terminate")
                self.cloud.terminate_instance(instance)
            except Exception:  # noqa: BLE001 — transient provider failure:
                # STAY a suspect so the very next sweep retries.
                log.exception(
                    "failed to terminate leaked instance %s; retrying",
                    instance.instance_id,
                )
                next_suspects[provider_id] = first_seen
                continue
            INSTANCEGC_TERMINATED_TOTAL.inc()
            log.warning(
                "terminated leaked instance %s (%s in %s, launched %s, "
                "no Node after %.0fs grace)",
                instance.instance_id,
                instance.instance_type,
                instance.zone,
                instance.launched_at or "unknown",
                self.grace_seconds,
            )
        self._suspects = next_suspects
        INSTANCEGC_SUSPECTS.set(len(self._suspects))
        return SWEEP_SECONDS
