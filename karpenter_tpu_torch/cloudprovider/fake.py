"""Fake cloud provider: instant nodes, canned catalogs, fault injection.

Ref: pkg/cloudprovider/fake/cloudprovider.go (instant fake nodes honoring
requested zone/capacity-type; canned instance-type catalog) and
pkg/cloudprovider/aws/fake/ec2api.go (InsufficientCapacityPools to exercise
ICE blackout fallback). Used by tests and by the runtime when no real cloud
is configured.
"""

from __future__ import annotations

import copy
import itertools
import threading
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.provisioner import Constraints, Provisioner
from karpenter_tpu_torch.cloudprovider import (
    DEFAULT_INTERRUPTION_DEADLINE_SECONDS,
    INTERRUPTION_SPOT,
    CloudInstance,
    CloudProvider,
    InstanceType,
    InsufficientCapacityError,
    InterruptionEvent,
    NodeSpec,
    Offering,
)
from karpenter_tpu_torch.utils.clock import SYSTEM_CLOCK
from karpenter_tpu_torch.utils.crashpoints import crashpoint

ZONES = ("test-zone-1", "test-zone-2", "test-zone-3")

_node_counter = itertools.count(1)

# ICE blackout TTL (ref: aws/instancetypes.go:37 — 45s).
UNAVAILABLE_OFFERING_TTL = 45.0


def _offerings(price: float, zones=ZONES) -> List[Offering]:
    return [
        Offering(zone=zone, capacity_type=ct, price=price * (0.6 if ct == "spot" else 1.0))
        for zone in zones
        for ct in (wellknown.CAPACITY_TYPE_ON_DEMAND, wellknown.CAPACITY_TYPE_SPOT)
    ]


def default_instance_types() -> List[InstanceType]:
    """Canned catalog mirroring the reference's fake fixtures
    (ref: fake/cloudprovider.go:36-116): default, small, gpu, arm."""
    return [
        InstanceType(
            name="default-instance-type",
            capacity={"cpu": 16, "memory": "64Gi", "pods": 110},
            offerings=_offerings(0.8),
        ),
        InstanceType(
            name="small-instance-type",
            capacity={"cpu": 2, "memory": "4Gi", "pods": 110},
            offerings=_offerings(0.1),
        ),
        InstanceType(
            name="nvidia-gpu-instance-type",
            capacity={
                "cpu": 16,
                "memory": "64Gi",
                "pods": 110,
                wellknown.RESOURCE_NVIDIA_GPU: 2,
            },
            offerings=_offerings(2.4),
        ),
        InstanceType(
            name="amd-gpu-instance-type",
            capacity={
                "cpu": 16,
                "memory": "64Gi",
                "pods": 110,
                wellknown.RESOURCE_AMD_GPU: 2,
            },
            offerings=_offerings(2.0),
        ),
        InstanceType(
            name="tpu-instance-type",
            capacity={
                "cpu": 96,
                "memory": "192Gi",
                "pods": 110,
                wellknown.RESOURCE_GOOGLE_TPU: 4,
            },
            offerings=_offerings(4.8),
        ),
        InstanceType(
            name="arm-instance-type",
            capacity={"cpu": 16, "memory": "64Gi", "pods": 110},
            architecture="arm64",
            offerings=_offerings(0.7),
        ),
        InstanceType(
            name="pod-eni-instance-type",
            capacity={
                "cpu": 4,
                "memory": "16Gi",
                "pods": 110,
                wellknown.RESOURCE_AWS_POD_ENI: 38,
            },
            offerings=_offerings(0.3),
        ),
    ]


def consolidation_instance_types() -> List[InstanceType]:
    """Utilization fixtures for the consolidation sweep: a size ladder with
    an unambiguous cheaper-replacement structure (big-instance-type strictly
    dominates mid and small on capacity while costing proportionally more,
    so a drained-down big node always has a strictly cheaper feasible
    replacement), plus a reserved pool whose offerings are marked
    consolidatable=False — capacity bought there must never be nominated."""
    return [
        InstanceType(
            name="small-consolidation-type",
            capacity={"cpu": 4, "memory": "16Gi", "pods": 110},
            offerings=_offerings(0.2),
        ),
        InstanceType(
            name="mid-consolidation-type",
            capacity={"cpu": 8, "memory": "32Gi", "pods": 110},
            offerings=_offerings(0.4),
        ),
        InstanceType(
            name="big-consolidation-type",
            capacity={"cpu": 16, "memory": "64Gi", "pods": 110},
            offerings=_offerings(0.8),
        ),
        InstanceType(
            name="reserved-consolidation-type",
            capacity={"cpu": 16, "memory": "64Gi", "pods": 110},
            offerings=[
                Offering(
                    zone=zone,
                    capacity_type=wellknown.CAPACITY_TYPE_ON_DEMAND,
                    price=0.5,
                    consolidatable=False,
                )
                for zone in ZONES
            ],
        ),
    ]


def instance_type_ladder(n: int) -> List[InstanceType]:
    """Linear size ladder for benchmarks (ref: fake/instancetype.go:69-80)."""
    return [
        InstanceType(
            name=f"fake-ladder-{i + 1}",
            capacity={"cpu": 2 * (i + 1), "memory": f"{4 * (i + 1)}Gi", "pods": 110},
            offerings=_offerings(0.05 * (i + 1)),
        )
        for i in range(n)
    ]


class FakeCloudProvider(CloudProvider):
    """Instant node launches honoring the tightened constraints; records all
    launch calls; injectable insufficient-capacity pools."""

    def __init__(
        self,
        instance_types: Optional[List[InstanceType]] = None,
        clock=None,
    ):
        self._instance_types = (
            list(instance_types) if instance_types is not None else default_instance_types()
        )
        self.clock = clock or SYSTEM_CLOCK
        self.create_calls: List[Tuple[Constraints, List[str], int]] = []
        self.deleted_nodes: List[str] = []
        # Crash-consistency surfaces: every live instance this cloud is
        # "billing" for (provider_id -> CloudInstance), the NodeSpecs each
        # launch_id bought (replayed on a re-issued launch so a restarted
        # controller ADOPTS instead of re-buying), and a per-call log of
        # (launch_id, quantity, adopted, launched) — the ClientToken
        # analogue the crash battletest asserts determinism on.
        self.instances: Dict[str, CloudInstance] = {}  # vet: guarded-by(self._lock)
        self.terminated_instances: List[str] = []
        self._launches: Dict[str, List[NodeSpec]] = {}  # vet: guarded-by(self._lock)
        self.launch_log: List[Dict] = []
        # (instance_type, zone, capacity_type) triples that fail with ICE
        # (ref: aws/fake/ec2api.go InsufficientCapacityPools:54).
        self.insufficient_capacity_pools: Set[Tuple[str, str, str]] = set()
        # Offering blackout cache (ref: aws/instancetypes.go:174-183).
        self._unavailable: Dict[Tuple[str, str, str], float] = {}  # vet: guarded-by(self._lock)
        # Injectable interruption feed: event_id -> event, delivered by
        # poll_interruptions until acked (the SQS at-least-once model), so
        # crash tests can kill the controller between observing and
        # recording an event and still see it re-delivered.
        self._interruptions: Dict[str, InterruptionEvent] = {}  # vet: guarded-by(self._lock)
        self._event_ids = itertools.count(1)
        self.acked_interruptions: List[str] = []
        # Injectable provider-side drift set: provider_id -> reason, served
        # by instance_drifted until cleared — drift storms are scriptable
        # the same way interruption storms are.
        self._drifted: Dict[str, str] = {}  # vet: guarded-by(self._lock)
        # Live market wiring (karpenter_tpu/market): the feed generates the
        # tick stream poll_market_events serves; the attached PriceBook (the
        # controller's fold of that stream) reprices ADVERTISED spot
        # offerings and drops ICE-closed pools, so every catalog consumer
        # sees the market the controller folded. Plain slots (GIL-atomic
        # swaps, read-only use): attach happens at harness/Manager boot.
        self._market_feed = None
        self._market_book = None
        self._lock = threading.Lock()

    # --- helpers ------------------------------------------------------------

    def _now(self) -> float:
        return self.clock.now()

    def set_instance_types(self, instance_types: List[InstanceType]) -> None:
        self._instance_types = list(instance_types)

    def cache_unavailable(self, instance_type: str, zone: str, capacity_type: str):
        with self._lock:
            self._unavailable[(instance_type, zone, capacity_type)] = (
                self._now() + UNAVAILABLE_OFFERING_TTL
            )

    def blackout_offering(
        self, instance_type: str, zone: str, capacity_type: str
    ) -> None:
        """Interruption-driven pool exclusion rides the same blackout cache
        as ICE feedback: the pool vanishes from get_instance_types for the
        TTL, so replacement capacity re-solves away from it."""
        self.cache_unavailable(instance_type, zone, capacity_type)

    # --- market feed --------------------------------------------------------

    def attach_market_feed(self, feed) -> None:
        """Wire a karpenter_tpu.market.feed.MarketFeed as this cloud's tick
        source; poll_market_events advances it on the provider clock. An
        un-stepped feed is re-anchored to that clock here — a feed built
        with the default epoch anchor would otherwise owe one step per
        elapsed second since 0 at the first poll (FakeClock starts at
        1e6)."""
        feed.rebase(self._now())
        self._market_feed = feed

    def attach_market(self, book) -> None:
        self._market_book = book

    def poll_market_events(self, after_seq: int = 0) -> List:
        feed = self._market_feed
        if feed is None:
            return []
        feed.advance(self._now())
        return feed.ticks_after(after_seq)

    def _market_offering(self, name: str, offering: Offering, od_price):
        """One offering under the attached book, priced by the SHARED rule
        (market.pricebook.advertised_price — the EC2 catalog path calls the
        same function, so the backends cannot drift): spot prices track the
        folded market (od * discount), ICE-closed pools drop their spot
        offering, anything unpriced keeps the catalog price."""
        from karpenter_tpu_torch.market.pricebook import advertised_price

        price = advertised_price(
            self._market_book,
            (name, offering.zone),
            offering.capacity_type,
            offering.price,
            od_price,
        )
        if price is None:
            return None
        if price == offering.price:
            return offering
        return Offering(
            zone=offering.zone,
            capacity_type=offering.capacity_type,
            price=price,
            consolidatable=offering.consolidatable,
        )

    def _priced_offerings(self, it: InstanceType) -> List[Offering]:
        """The type's available offerings under blackouts + the live market."""
        od_by_zone = {
            o.zone: o.price
            for o in it.offerings
            if o.capacity_type == wellknown.CAPACITY_TYPE_ON_DEMAND
        }
        out = []
        for o in it.offerings:
            if not self._offering_available(it.name, o):
                continue
            priced = self._market_offering(it.name, o, od_by_zone.get(o.zone))
            if priced is not None:
                out.append(priced)
        return out

    # --- interruption feed --------------------------------------------------

    def inject_interruption(
        self,
        node: NodeSpec,
        kind: str = INTERRUPTION_SPOT,
        deadline_in: Optional[float] = DEFAULT_INTERRUPTION_DEADLINE_SECONDS,
    ) -> InterruptionEvent:
        """Test hook: enqueue an interruption notice for `node`'s instance.
        `deadline_in` is seconds from now (None = soft, no deadline)."""
        with self._lock:
            event_id = f"fake-event-{next(self._event_ids)}"
            event = InterruptionEvent(
                kind=kind,
                instance_id=node.provider_id.rsplit("/", 1)[-1],
                provider_id=node.provider_id,
                deadline=(
                    self._now() + deadline_in if deadline_in is not None else None
                ),
                event_id=event_id,
            )
            self._interruptions[event_id] = event
            return event

    def poll_interruptions(self) -> List[InterruptionEvent]:
        with self._lock:
            return list(self._interruptions.values())

    def ack_interruption(self, event: InterruptionEvent) -> None:
        with self._lock:
            if self._interruptions.pop(event.event_id, None) is not None:
                self.acked_interruptions.append(event.event_id)

    # --- drift feed ---------------------------------------------------------

    def inject_drift(self, node: NodeSpec, reason: str = "template-moved") -> None:
        """Test hook: mark `node`'s instance as provider-drifted. The drift
        sweep sees it on its next pass via instance_drifted."""
        with self._lock:
            self._drifted[node.provider_id] = reason

    def clear_drift(self, node: NodeSpec) -> None:
        with self._lock:
            self._drifted.pop(node.provider_id, None)

    def instance_drifted(self, node: NodeSpec) -> Optional[str]:
        with self._lock:
            return self._drifted.get(node.provider_id)

    def _offering_available(self, name: str, offering: Offering) -> bool:
        key = (name, offering.zone, offering.capacity_type)
        with self._lock:
            expiry = self._unavailable.get(key)
            if expiry is None:
                return True
            if self._now() >= expiry:
                del self._unavailable[key]
                return True
            return False

    # --- CloudProvider ------------------------------------------------------

    def get_instance_types(self, constraints: Optional[Constraints] = None) -> List[InstanceType]:
        """Catalog with blacked-out offerings filtered (ref: instancetypes.go
        Get:61-104 subtracts the unavailable-offerings cache)."""
        out = []
        for it in self._instance_types:
            offerings = self._priced_offerings(it)
            if not offerings:
                continue
            out.append(
                InstanceType(
                    name=it.name,
                    capacity=dict(it.capacity),
                    overhead=dict(it.overhead),
                    architecture=it.architecture,
                    operating_systems=it.operating_systems,
                    offerings=offerings,
                )
            )
        return out

    def _adopt_prior_launch(
        self, launch_id: Optional[str], quantity: int
    ) -> List[NodeSpec]:
        """Idempotent re-issue (a restarted controller replaying the same
        batch): instances the first attempt already bought are ADOPTED —
        re-delivered through the callback with their original NodeSpec —
        and only the shortfall is purchased. Instances terminated since
        (e.g. GC'd) are dropped from the replay and re-bought."""
        if launch_id is None:
            return []
        with self._lock:
            prior = self._launches.get(launch_id, [])
            # Deep copies: the registration path mutates the NodeSpec it
            # receives, and the stored record must stay pristine (like a
            # fresh DescribeInstances conversion would be).
            return [
                copy.deepcopy(node) for node in prior
                if node.provider_id in self.instances
            ][:quantity]

    @staticmethod
    def _rank_candidates(
        instance_types, pool_options, allowed_zones, allowed_capacity
    ) -> List[Tuple]:
        """(sort_key, instance_type, offering) rows honoring constraints —
        pinned price-ranked pools in priority order when given, else
        lowest-price-first across offered types (the fleet-API behavior the
        reference delegates to EC2)."""
        candidates: List[Tuple] = []
        if pool_options:
            for rank, pool in enumerate(pool_options):
                if not allowed_zones.contains(pool.zone):
                    continue
                for offering in pool.instance_type.offerings:
                    if offering.zone != pool.zone:
                        continue
                    if not allowed_capacity.contains(offering.capacity_type):
                        continue
                    candidates.append((rank, pool.instance_type, offering))
        else:
            for it in instance_types:
                for offering in it.offerings:
                    if not allowed_zones.contains(offering.zone):
                        continue
                    if not allowed_capacity.contains(offering.capacity_type):
                        continue
                    candidates.append((offering.price, it, offering))
        candidates.sort(key=lambda c: c[0])
        return candidates

    def _buy(self, it: InstanceType, offering: Offering, launch_id) -> NodeSpec:
        """Commit one purchase: mint the instance + NodeSpec and record both.
        The purchase is committed HERE — before any callback runs — exactly
        like CreateFleet returning instance ids: a crash between this point
        and node registration leaks the instance until the GC reaps it or a
        restart adopts it."""
        sequence = next(_node_counter)
        instance_id = f"fi-{sequence:08d}"
        # Unique per instance (like aws:///zone/id), so the leaked-
        # capacity GC can join instances against Nodes.
        provider_id = f"fake:///{offering.zone}/{instance_id}"
        node = NodeSpec(
            name=f"fake-node-{sequence}",
            labels={
                wellknown.INSTANCE_TYPE_LABEL: it.name,
                wellknown.ZONE_LABEL: offering.zone,
                wellknown.CAPACITY_TYPE_LABEL: offering.capacity_type,
                wellknown.ARCH_LABEL: it.architecture,
                wellknown.OS_LABEL: sorted(it.operating_systems)[0],
            },
            capacity=dict(it.capacity),
            instance_type=it.name,
            zone=offering.zone,
            capacity_type=offering.capacity_type,
            provider_id=provider_id,
        )
        with self._lock:
            self.instances[provider_id] = CloudInstance(
                instance_id=instance_id,
                provider_id=provider_id,
                instance_type=it.name,
                zone=offering.zone,
                capacity_type=offering.capacity_type,
                launched_at=self._now(),
            )
            if launch_id is not None:
                self._launches.setdefault(launch_id, []).append(
                    copy.deepcopy(node)
                )
        return node

    def create(
        self,
        constraints: Constraints,
        instance_types: Sequence[InstanceType],
        quantity: int,
        callback: Callable[[NodeSpec], None],
        pool_options: Optional[Sequence] = None,
        launch_id: Optional[str] = None,
    ) -> List[Exception]:
        self.create_calls.append(
            (constraints, [it.name for it in instance_types], quantity)
        )
        adopted = self._adopt_prior_launch(launch_id, quantity)
        errors: List[Exception] = []
        launched_nodes: List[NodeSpec] = []
        requirements = constraints.effective_requirements()
        allowed_zones = requirements.allowed(wellknown.ZONE_LABEL)
        allowed_capacity = requirements.allowed(wellknown.CAPACITY_TYPE_LABEL)
        # Loop-invariant: candidates depend only on the call's inputs (ICE
        # feedback is checked per pool below, against the live set).
        candidates = self._rank_candidates(
            instance_types, pool_options, allowed_zones, allowed_capacity
        )
        for _ in range(quantity - len(adopted)):
            launched = False
            last_error: Optional[Exception] = None
            for _, it, offering in candidates:
                pool = (it.name, offering.zone, offering.capacity_type)
                if pool in self.insufficient_capacity_pools:
                    last_error = InsufficientCapacityError(*pool)
                    self.cache_unavailable(*pool)
                    continue
                launched_nodes.append(self._buy(it, offering, launch_id))
                launched = True
                break
            if not launched:
                errors.append(
                    last_error
                    or RuntimeError("no offering satisfies constraints")
                )
        self.launch_log.append(
            {
                "launch_id": launch_id,
                "quantity": quantity,
                "adopted": [n.provider_id for n in adopted],
                "launched": [n.provider_id for n in launched_nodes],
            }
        )
        # The capacity is bought; the node objects don't exist yet. This is
        # the canonical leak window.
        crashpoint("cloud.after-create-fleet")
        for node in adopted + launched_nodes:
            callback(node)
        return errors

    def delete(self, node: NodeSpec) -> None:
        self.deleted_nodes.append(node.name)
        with self._lock:
            self.instances.pop(node.provider_id, None)

    def list_instances(self) -> List[CloudInstance]:
        with self._lock:
            return list(self.instances.values())

    def terminate_instance(self, instance: CloudInstance) -> None:
        with self._lock:
            removed = self.instances.pop(instance.provider_id, None)
            if removed is not None:
                self.terminated_instances.append(instance.instance_id)

    def default(self, provisioner: Provisioner) -> None:
        """Default capacity-type to on-demand if unconstrained
        (vendor-defaulting parity with aws/apis/v1alpha1/provider_defaults.go)."""
        requirements = provisioner.spec.constraints.requirements
        if requirements.capacity_types() is None:
            from karpenter_tpu_torch.api.requirements import Requirement

            provisioner.spec.constraints.requirements = requirements.add(
                Requirement.in_(
                    wellknown.CAPACITY_TYPE_LABEL,
                    [wellknown.CAPACITY_TYPE_ON_DEMAND, wellknown.CAPACITY_TYPE_SPOT],
                )
            )
