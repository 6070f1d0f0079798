"""Cloud-provider abstraction.

Ref: pkg/cloudprovider/types.go:29-75 — CloudProvider, InstanceType and
Offering. We extend Offering with a price so the solver can optimize projected
$/hr (the reference delegates price choice to EC2 Fleet's lowest-price
allocation strategy; surfacing it lets the TPU solver make the cost tradeoff
jointly with packing).
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Callable, Dict, FrozenSet, Iterable, List, Optional, Sequence

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.pods import PodSpec
from karpenter_tpu_torch.api.provisioner import Constraints, Provisioner
from karpenter_tpu_torch.api.resources import ResourceList, parse_resource_list

ARCH_AMD64 = "amd64"
ARCH_ARM64 = "arm64"
OS_LINUX = "linux"


@dataclass(frozen=True)
class Offering:
    """One purchasable (zone, capacity-type) combination for an instance type.

    `consolidatable` is the provider's hint that capacity bought from this
    pool may be voluntarily deprovisioned by the consolidation controller —
    False marks commitments (reserved capacity, capacity blocks) where
    shedding the node saves nothing because the bill keeps running."""

    zone: str
    capacity_type: str = wellknown.CAPACITY_TYPE_ON_DEMAND
    price: float = 0.0  # $/hr; 0.0 = unknown
    consolidatable: bool = True


@dataclass
class InstanceType:
    """Ref: cloudprovider.InstanceType interface (types.go:44-63)."""

    name: str
    capacity: ResourceList
    overhead: ResourceList = field(default_factory=dict)
    architecture: str = ARCH_AMD64
    operating_systems: FrozenSet[str] = frozenset({OS_LINUX})
    offerings: List[Offering] = field(default_factory=list)

    def __post_init__(self):
        self.capacity = parse_resource_list(self.capacity)
        self.overhead = parse_resource_list(self.overhead)

    def zones(self) -> FrozenSet[str]:
        return frozenset(offering.zone for offering in self.offerings)

    def capacity_types(self) -> FrozenSet[str]:
        return frozenset(offering.capacity_type for offering in self.offerings)

    def get(self, resource: str) -> float:
        return self.capacity.get(resource, 0.0)

    def min_price(
        self,
        zones: Optional[Iterable[str]] = None,
        capacity_types: Optional[Iterable[str]] = None,
    ) -> float:
        """Cheapest offering price within the allowed zones/capacity types."""
        zones = None if zones is None else set(zones)
        capacity_types = None if capacity_types is None else set(capacity_types)
        prices = [
            o.price
            for o in self.offerings
            if (zones is None or o.zone in zones)
            and (capacity_types is None or o.capacity_type in capacity_types)
        ]
        return min(prices) if prices else float("inf")


# --- Interruption events ----------------------------------------------------
#
# Ref: the reference ecosystem's AWS interruption controller consumes the
# EventBridge streams for EC2 spot-interruption-warning, rebalance-
# recommendation, and instance-state-change through an SQS queue. We surface
# the same three kinds through a provider-neutral poll/ack pair so the
# interruption controller can react inside the reclaim window.

INTERRUPTION_SPOT = "spot-interruption"  # hard: capacity dies at the deadline
INTERRUPTION_REBALANCE = "rebalance-recommendation"  # soft: elevated risk only
INTERRUPTION_STOPPING = "instance-stopping"  # hard: provider is stopping it

# Kinds that carry (or imply) a reclaim deadline; the drain escalates as it
# approaches. Soft kinds drain politely and never override PDBs.
HARD_INTERRUPTION_KINDS = frozenset({INTERRUPTION_SPOT, INTERRUPTION_STOPPING})

# EC2 gives two minutes of warning before a spot reclaim; events that name no
# explicit deadline get this window from their observation time.
DEFAULT_INTERRUPTION_DEADLINE_SECONDS = 120.0


@dataclass(frozen=True)
class InterruptionEvent:
    """One provider notice that an instance is about to lose its capacity.

    `instance_id` is the provider-side join key (events rarely carry the
    zone, so `provider_id` is best-effort — the controller matches either).
    `deadline` is epoch seconds in the provider's clock domain; None = soft
    (no hard reclaim time). `event_id` is the at-least-once ack token
    (`ack_interruption`): the SQS receipt handle for EC2, the fake's queue
    key for tests — an event stays re-deliverable until acked, so a
    controller that dies between observing and recording it sees it again."""

    kind: str
    instance_id: str
    provider_id: str = ""
    deadline: Optional[float] = None
    event_id: str = ""
    detail: str = ""

    def is_hard(self) -> bool:
        return self.kind in HARD_INTERRUPTION_KINDS


@dataclass(frozen=True)
class CloudInstance:
    """A provider-side instance carrying this cluster's ownership tag, as
    returned by `CloudProvider.list_instances`. This is the GC controller's
    view of "what we are paying for": `provider_id` is the join key against
    Nodes, `launched_at` (0.0 = unknown) is observability for leak triage."""

    instance_id: str
    provider_id: str
    instance_type: str = ""
    zone: str = ""
    capacity_type: str = ""
    state: str = "running"
    launched_at: float = 0.0


@dataclass
class NodeSpec:
    """A launched (or to-be-launched) node as the control plane sees it."""

    name: str
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    taints: List = field(default_factory=list)
    capacity: ResourceList = field(default_factory=dict)
    instance_type: str = ""
    zone: str = ""
    capacity_type: str = ""
    provider_id: str = ""
    ready: bool = False
    unschedulable: bool = False
    finalizers: List[str] = field(default_factory=list)
    created_at: float = 0.0
    deletion_timestamp: Optional[float] = None
    # Last time the kubelet reported status; None = never joined.
    status_reported_at: Optional[float] = None


class CloudProviderError(Exception):
    pass


class InsufficientCapacityError(CloudProviderError):
    """The provider could not fulfill an offering (ref: aws/errors.go
    InsufficientInstanceCapacity). Carries the failed offering so callers can
    blackout-cache it."""

    def __init__(self, instance_type: str, zone: str, capacity_type: str):
        super().__init__(
            f"insufficient capacity for {instance_type} ({capacity_type}) in {zone}"
        )
        self.instance_type = instance_type
        self.zone = zone
        self.capacity_type = capacity_type


class CloudProvider(abc.ABC):
    """Ref: pkg/cloudprovider/types.go:29-42. `create` is synchronous per node
    packing here (the reference's async channel-per-node is replaced by the
    controller's own worker pool)."""

    @abc.abstractmethod
    def create(
        self,
        constraints: Constraints,
        instance_types: Sequence[InstanceType],
        quantity: int,
        callback: Callable[[NodeSpec], None],
        pool_options: Optional[Sequence] = None,
        launch_id: Optional[str] = None,
    ) -> List[Exception]:
        """Launch `quantity` nodes satisfying constraints, choosing among the
        offered instance_types; invoke callback per launched node. Returns
        per-node errors (empty = full success).

        `pool_options` (ops.ffd.PoolOption rows, cheapest first) pins the
        launch request to specific price-ranked (type, zone) pools — the
        cost-aware plan's override rows. None = derive rows from
        instance_types x offerings (reference semantics,
        ref: instance.go getOverrides:173-207).

        `launch_id` is the caller's stable identity for this logical launch
        (the provisioning worker derives it from the batch content). A
        provider that supports idempotent launches MUST treat a repeated
        launch_id as the same purchase: re-deliver the instances the first
        attempt bought (adoption) instead of buying again, and derive any
        wire-level idempotency token (EC2 ClientToken) from it so a retried
        or crash-re-issued call is a server-side no-op. None = every call is
        a fresh purchase (legacy behavior)."""

    @abc.abstractmethod
    def delete(self, node: NodeSpec) -> None:
        ...

    def list_instances(self) -> List[CloudInstance]:
        """Every live instance carrying this cluster's ownership tag,
        whether or not a Node exists for it — the ground truth the leaked-
        capacity GC (controllers/instancegc.py) reconciles Nodes against.
        Providers that cannot enumerate owned capacity return [] (the GC is
        then inert for them)."""
        return []

    def terminate_instance(self, instance: CloudInstance) -> None:
        """Terminate a (possibly Node-less) instance by provider identity.
        Not-found must be success: the GC races normal termination."""
        raise NotImplementedError(
            f"{type(self).__name__} cannot terminate untracked instances"
        )

    def poll_interruptions(self) -> List[InterruptionEvent]:
        """Pending interruption notices for this cluster's capacity,
        at-least-once: an event stays re-deliverable until `ack_interruption`
        confirms it was durably recorded (the SQS visibility model). Providers
        without an interruption feed return [] (the controller is then inert
        for them)."""
        return []

    def ack_interruption(self, event: InterruptionEvent) -> None:
        """Confirm an event was recorded (annotated onto its Node); the
        provider stops re-delivering it. Unknown/already-acked events are
        success — acks race re-deliveries."""

    def blackout_offering(
        self, instance_type: str, zone: str, capacity_type: str
    ) -> None:
        """Temporarily exclude one (type, zone, capacity-type) pool from
        `get_instance_types` — the interruption controller calls this for a
        reclaimed pool so replacement capacity re-solves AWAY from it (the
        same cache the ICE blackout feeds). Default: no-op."""

    def poll_market_events(self, after_seq: int = 0) -> List:
        """Spot-market ticks (karpenter_tpu.market.feed.MarketTick) with
        seq > after_seq, strictly seq-ordered and REPLAYABLE from 0: a
        restarted controller re-folds the whole history to reconstruct its
        PriceBook (state AND generation) — there is no ack protocol; the
        feed is the durable cursorless history, the way
        DescribeSpotPriceHistory is on EC2. Providers without a market feed
        return [] (the market controller is then inert for them)."""
        return []

    def attach_market(self, book) -> None:
        """Give the provider the controller's PriceBook so ADVERTISED spot
        offering prices track the live market (get_instance_types applies
        the book's per-pool discount; ICE-closed pools drop their spot
        offerings). Default: no-op — static catalogs stay static."""

    def instance_drifted(self, node: NodeSpec) -> Optional[str]:
        """Provider-side drift verdict for one live node: a short human
        reason string when the cloud says the instance no longer matches
        what the provisioner would launch today (launch-template/AMI
        generation moved, offering no longer advertised), else None. The
        drift sweep treats any non-None return as drift kind "provider".
        Must be read-only and cheap enough to call per node per sweep.
        Providers without drift detection return None (the drift controller
        is then spec-hash-only for them)."""
        return None

    @abc.abstractmethod
    def get_instance_types(self, constraints: Optional[Constraints] = None) -> List[InstanceType]:
        ...

    def default(self, provisioner: Provisioner) -> None:
        """Vendor defaulting hook (ref: types.go Default)."""

    def validate(self, provisioner: Provisioner) -> None:
        """Vendor validation hook (ref: types.go Validate)."""
