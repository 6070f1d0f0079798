"""EC2-backed cloud provider: the full discovery→template→fleet stack.

Ref: pkg/cloudprovider/aws/cloudprovider.go — the facade wiring
instance-type / subnet / security-group / launch-template / instance
providers behind the generic CloudProvider interface, with the fleet call
throttled at 2 qps / 100 burst (cloudprovider.go:40-56) and the vendor
`provider` blob deserialized per call (:118,137).

By default the stack runs against the in-memory FakeEc2 backend — the whole
provider logic (capacity-type choice, ICE blackouts, launch-template
hashing, override pricing) is real; only the wire calls are simulated. A
production deployment implements `Ec2Api` over the AWS SDK and passes it in.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import datetime
import json
import threading

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.provisioner import Constraints, Provisioner
from karpenter_tpu_torch.cloudprovider import (
    DEFAULT_INTERRUPTION_DEADLINE_SECONDS,
    INTERRUPTION_REBALANCE,
    INTERRUPTION_SPOT,
    INTERRUPTION_STOPPING,
    CloudInstance,
    CloudProvider,
    CloudProviderError,
    InstanceType,
    InterruptionEvent,
    NodeSpec,
)
from karpenter_tpu_torch.cloudprovider.ec2.api import Ec2Api
from karpenter_tpu_torch.cloudprovider.ec2.fake import FakeEc2
from karpenter_tpu_torch.cloudprovider.ec2.instances import (
    InstanceProvider,
    parse_instance_id,
)
from karpenter_tpu_torch.cloudprovider.ec2.instancetypes import InstanceTypeProvider
from karpenter_tpu_torch.cloudprovider.ec2.launchtemplates import (
    AmiProvider,
    LaunchTemplateProvider,
)
from karpenter_tpu_torch.cloudprovider.ec2.network import (
    SecurityGroupProvider,
    SubnetProvider,
)
from karpenter_tpu_torch.cloudprovider.ec2.vendor import (
    Ec2Provider,
    default_provider_blob,
)
from karpenter_tpu_torch.utils.clock import Clock, SYSTEM_CLOCK
from karpenter_tpu_torch.utils.workqueue import RateLimiter

# Fleet-call throttle (ref: aws/cloudprovider.go:41-46).
FLEET_QPS = 2.0
FLEET_BURST = 100

# EventBridge detail-type -> interruption kind (ref: the reference ecosystem's
# interruption controller consumes exactly these rule streams via SQS).
_DETAIL_TYPE_KINDS = {
    "EC2 Spot Instance Interruption Warning": INTERRUPTION_SPOT,
    "EC2 Instance Rebalance Recommendation": INTERRUPTION_REBALANCE,
    "EC2 Instance State-change Notification": INTERRUPTION_STOPPING,
}
# State-change notifications that actually mean "capacity going away".
_STOPPING_STATES = frozenset({"stopping", "shutting-down"})


def _parse_event_time(value: str) -> float:
    """EventBridge ISO-8601 `time` -> epoch seconds; 0.0 when unparseable
    (the caller falls back to its own observation time)."""
    if not value:
        return 0.0
    try:
        return datetime.datetime.fromisoformat(
            value.replace("Z", "+00:00")
        ).timestamp()
    except ValueError:
        return 0.0


class Ec2CloudProvider(CloudProvider):
    """Ref: aws/cloudprovider.go CloudProvider:38-168."""

    def __init__(
        self,
        api: Optional[Ec2Api] = None,
        cluster_name: str = "test-cluster",
        cluster_endpoint: str = "https://cluster.test",
        kube_version: str = "1.21",
        ca_bundle: Optional[str] = None,
        clock: Optional[Clock] = None,
    ):
        self.clock = clock or SYSTEM_CLOCK
        self.cluster_name = cluster_name
        self.api: Ec2Api = api if api is not None else FakeEc2(cluster_name=cluster_name)
        self.subnets = SubnetProvider(self.api, self.clock)
        self.security_groups = SecurityGroupProvider(
            self.api, cluster_name, self.clock
        )
        self.instance_types = InstanceTypeProvider(
            self.api, self.subnets, self.clock
        )
        self.amis = AmiProvider(self.api, kube_version, self.clock)
        self.launch_templates = LaunchTemplateProvider(
            self.api,
            self.amis,
            self.security_groups,
            cluster_name,
            cluster_endpoint,
            ca_bundle,
            self.clock,
        )
        self.instances = InstanceProvider(
            self.api,
            self.instance_types,
            self.subnets,
            self.launch_templates,
            cluster_name,
            self.clock,
        )
        self._fleet_limiter = RateLimiter(FLEET_QPS, FLEET_BURST, self.clock)
        # Market tick numbering (poll_market_events): DescribeSpotPriceHistory
        # is a SLIDING window, so a row's rank in any one poll is not a
        # stable identity — old rows age out and renumber everything after
        # them. Seqs are therefore assigned from this process-local counter
        # as rows first cross each POOL's sort-key cursor (per-pool, so a
        # late-published row for a quiet pool is not shadowed by a busier
        # pool's newer cursor), and emitted ticks are retained (bounded —
        # see _compact_market_history_locked) so a re-fold from seq 0
        # replays the sequence. A restarted process starts both a fresh
        # numbering and a fresh PriceBook, so the two can never disagree.
        self._market_lock = threading.Lock()
        self._market_seq = 0  # vet: guarded-by(self._market_lock)
        self._market_cursors: dict = {}  # vet: guarded-by(self._market_lock)
        self._market_history: List = []  # vet: guarded-by(self._market_lock)
        # The controller's folded PriceBook (attach_market), read by the
        # sustained-ICE drift check. Plain slot (GIL-atomic swap, read-only
        # use): attach happens once at Manager boot.
        self._market_book = None

    # --- CloudProvider interface ------------------------------------------

    def create(
        self,
        constraints: Constraints,
        instance_types: Sequence[InstanceType],
        quantity: int,
        callback: Callable[[NodeSpec], None],
        pool_options: Optional[Sequence] = None,
        launch_id: Optional[str] = None,
    ) -> List[Exception]:
        """Ref: aws/cloudprovider.go Create:111-133 — one throttled fleet
        launch per packing; each launched node flows through the callback.
        `launch_id` propagates to deterministic CreateFleet ClientTokens
        (restart-safe launches; see instances._launch)."""
        errors: List[Exception] = []
        try:
            provider = Ec2Provider.deserialize(constraints)
            self._throttle()
            nodes = self.instances.create(
                constraints, provider, instance_types, quantity,
                pool_options=pool_options, launch_id=launch_id,
            )
        except Exception as error:  # noqa: BLE001 — reported, not raised
            return [error] * quantity
        for node in nodes:
            callback(node)
        shortfall = quantity - len(nodes)
        if shortfall > 0:
            errors.extend(
                [RuntimeError("fleet under-fulfilled the request")] * shortfall
            )
        return errors

    def delete(self, node: NodeSpec) -> None:
        self.instances.terminate(node)

    def list_instances(self) -> List[CloudInstance]:
        """Everything tagged as ours and not already terminating — the
        leaked-capacity GC's ground truth (DescribeInstances by the
        framework ownership tag that merge_tags stamps on every launch)."""
        from karpenter_tpu_torch.cloudprovider.ec2.instances import PROVIDER_ID_FORMAT
        from karpenter_tpu_torch.cloudprovider.ec2.vendor import FRAMEWORK_TAG_KEY_FORMAT

        filters = {FRAMEWORK_TAG_KEY_FORMAT.format(self.cluster_name): "owned"}
        out: List[CloudInstance] = []
        for instance in self.api.describe_instances_by_tag(filters):
            if instance.state in ("terminated", "shutting-down"):
                continue
            out.append(
                CloudInstance(
                    instance_id=instance.instance_id,
                    provider_id=PROVIDER_ID_FORMAT.format(
                        zone=instance.zone, instance_id=instance.instance_id
                    ),
                    instance_type=instance.instance_type,
                    zone=instance.zone,
                    capacity_type="spot" if instance.spot else "on-demand",
                    state=instance.state,
                    launched_at=instance.launched_at,
                )
            )
        return out

    def terminate_instance(self, instance: CloudInstance) -> None:
        self.instances.terminate_by_id(instance.instance_id)

    def poll_interruptions(self) -> List[InterruptionEvent]:
        """Drain one poll of the EventBridge-fed queue into typed events.
        Messages that map to an event are left on the queue (at-least-once —
        the controller acks after durably recording the interruption);
        messages that map to nothing (state changes we don't act on, foreign
        sources) are deleted here so noise can't clog the queue."""
        events: List[InterruptionEvent] = []
        for message in self.api.receive_queue_messages():
            event = self._to_interruption(message)
            if event is None:
                self.api.delete_queue_message(message.receipt_handle)
                continue
            events.append(event)
        return events

    def _to_interruption(self, message) -> Optional[InterruptionEvent]:
        # Anything can land on an SQS queue. EVERY malformed shape — invalid
        # JSON, a non-object body, a non-dict detail, a numeric time — must
        # map to None (and therefore deletion) rather than raise: an
        # exception here would abort the whole poll before the message is
        # deleted, and the poison re-delivery would starve every real
        # reclaim warning behind it forever.
        try:
            body = json.loads(message.body)
            kind = _DETAIL_TYPE_KINDS.get(body.get("detail-type", ""))
            detail = body.get("detail") or {}
            instance_id = detail.get("instance-id")
            state = detail.get("state")
            observed = _parse_event_time(body.get("time", ""))
        except (ValueError, AttributeError, TypeError):
            return None
        if kind is None or not instance_id or not isinstance(instance_id, str):
            return None
        if kind == INTERRUPTION_STOPPING and state not in _STOPPING_STATES:
            return None
        deadline = None
        if kind != INTERRUPTION_REBALANCE:
            deadline = (
                observed or self.clock.now()
            ) + DEFAULT_INTERRUPTION_DEADLINE_SECONDS
        return InterruptionEvent(
            kind=kind,
            instance_id=instance_id,
            deadline=deadline,
            event_id=message.receipt_handle,
            detail=body.get("detail-type", ""),
        )

    def ack_interruption(self, event: InterruptionEvent) -> None:
        self.api.delete_queue_message(event.event_id)

    def attach_market(self, book) -> None:
        """Advertised spot offering prices track the controller's folded
        market (instancetypes applies the book's discounts at get); the
        book is also retained for the sustained-ICE drift verdict."""
        self.instance_types.attach_market(book)
        self._market_book = book

    # Sustained-ICE drift window, in FEED time: a spot pool must stay
    # ICE-closed this long before its nodes count as provider-drifted —
    # far past the 45s blackout TTL, so ordinary capacity wobble (the ICE
    # open/close churn every storm produces) never rolls a fleet.
    DRIFT_ICE_SUSTAINED_S = 600.0

    def instance_drifted(self, node: NodeSpec) -> Optional[str]:
        """Provider-side drift verdicts, cheapest check first:
        (1) the node's instance type dropped out of the RAW catalog (the
        undiscounted DescribeInstanceTypes view — the blackout/market-
        filtered catalog would flip on every transient ICE);
        (2) its spot pool has been ICE-closed past DRIFT_ICE_SUSTAINED_S of
        feed time in the folded PriceBook;
        (3) the live instance's AMI no longer matches what a launch today
        would resolve — one DescribeInstances over the shared retry
        envelope, compared against the AmiProvider's current resolution
        (content-hashed launch-template names make AMI divergence the same
        fact as template-version divergence).
        Read-only; an API failure returns None (no verdict — drift is
        voluntary, so the conservative answer is "not drifted")."""
        try:
            infos = self.instance_types._get_infos()
        except Exception:  # noqa: BLE001 — coded API errors only
            return None
        if node.instance_type and node.instance_type not in infos:
            return f"instance type {node.instance_type} no longer advertised"
        verdict = self._ice_closed_verdict(node)
        if verdict is not None:
            return verdict
        return self._ami_drift_verdict(node)

    def _ami_drift_verdict(self, node: NodeSpec) -> Optional[str]:
        if not node.provider_id:
            return None
        try:
            instance_id = parse_instance_id(node.provider_id)
            described = self.instances._describe_with_retry([instance_id])
        except CloudProviderError:
            return None
        live = [i for i in described if i.instance_id == instance_id]
        if not live or not live[0].image_id:
            return None  # gone/unknown: the GC's problem, not drift's
        catalog_type = next(
            (
                t
                for t in self.get_instance_types()
                if t.name == node.instance_type
            ),
            None,
        )
        if catalog_type is None:
            return None  # no offerings right now: transient, not drift
        try:
            current_amis = self.amis.get([catalog_type])
        except Exception:  # noqa: BLE001 — SSM faults are not a verdict
            return None
        if live[0].image_id not in current_amis:
            return (
                f"ami {live[0].image_id} superseded by "
                f"{'/'.join(sorted(current_amis))}"
            )
        return None

    def _ice_closed_verdict(self, node: NodeSpec) -> Optional[str]:
        book = self._market_book
        if book is None or node.capacity_type != wellknown.CAPACITY_TYPE_SPOT:
            return None
        closed_at = book.closed_since((node.instance_type, node.zone))
        newest = book.last_tick_at()
        if closed_at is None or newest is None:
            return None
        closed_for = newest - closed_at
        if closed_for < self.DRIFT_ICE_SUSTAINED_S:
            return None
        return (
            f"spot pool ({node.instance_type}, {node.zone}) ICE-closed "
            f"for {closed_for:.0f}s"
        )

    # Retained-tick budget: past this the oldest half of the history
    # collapses to its newest tick per pool (exactly the snapshot a
    # from-0 re-fold needs) so a weeks-long controller doesn't hoard
    # every price change ever seen.
    MARKET_HISTORY_MAX = 50_000
    # Safe market-sweep cadence when --market-poll-interval is left at
    # auto: every poll is a paginated DescribeSpotPriceHistory, so 1 Hz
    # (the in-memory fake's cadence) would burn ~86k calls/day against
    # the API throttle shared with fleet/catalog calls.
    MARKET_POLL_DEFAULT_S = 15.0

    def poll_market_events(self, after_seq: int = 0) -> List:
        """DescribeSpotPriceHistory rows as a strictly-ordered, replayable
        tick stream. Rows sort on (timestamp, type, zone, price) — a total
        deterministic order — and each row is assigned a seq from a
        process-local counter the first time it crosses its POOL's sort-key
        cursor, then retained: seqs stay stable when the API's sliding
        window drops old rows, a late-published row for one pool is never
        shadowed by another pool's newer rows (eventual consistency), and a
        re-fold from seq 0 replays the in-process sequence (see __init__).
        A row at or below its own pool's cursor is stale information by
        construction (the book only folds forward) and is dropped.
        Discounts derive from the offering catalog's on-demand prices;
        rows for unknown pools are skipped (no anchor = no discount)."""
        from karpenter_tpu_torch.market.feed import TICK_PRICE, MarketTick

        rows = sorted(
            self.api.describe_spot_price_history(),
            key=lambda r: (r.timestamp, r.instance_type, r.zone, r.price),
        )
        od_prices = self.instance_types.on_demand_prices()
        with self._market_lock:
            for row in rows:
                pool = (row.instance_type, row.zone)
                key = (row.timestamp, row.price)
                cursor = self._market_cursors.get(pool)
                if cursor is not None and key <= cursor:
                    continue
                self._market_cursors[pool] = key
                od = od_prices.get(pool, 0.0)
                if od <= 0:
                    continue
                self._market_seq += 1
                discount = row.price / od
                self._market_history.append(
                    MarketTick(
                        seq=self._market_seq,
                        kind=TICK_PRICE,
                        instance_type=row.instance_type,
                        zone=row.zone,
                        discount=discount,
                        # EC2 never reveals pool depth, but the forecast's
                        # trend leg is computed from depth deltas — so proxy
                        # it as 1/discount (spot price climbing toward
                        # on-demand = the pool draining), the same inverse
                        # price/depth coupling the simulated walk produces.
                        # A sustained price climb then raises hazard BEFORE
                        # any interruption lands, on the real backend too.
                        depth=1.0 / discount,
                        at=row.timestamp,
                    )
                )
            if len(self._market_history) > self.MARKET_HISTORY_MAX:
                self._compact_market_history_locked()
            # Ordered by seq but not necessarily dense after compaction.
            return [t for t in self._market_history if t.seq > after_seq]

    def _compact_market_history_locked(self) -> None:
        """Bound the replay history: the oldest half collapses to its
        newest tick per pool — the snapshot a from-0 re-fold needs to
        anchor quiet pools — and pools superseded in the kept tail drop
        out entirely. Seqs are preserved (the fold keys on them), so the
        stream stays strictly ordered, just no longer dense."""
        half = len(self._market_history) // 2
        prefix, tail = (
            self._market_history[:half],
            self._market_history[half:],
        )
        newest_by_pool = {tick.pool: tick for tick in prefix}
        tail_pools = {tick.pool for tick in tail}
        snapshot = sorted(
            (
                tick
                for pool, tick in newest_by_pool.items()
                if pool not in tail_pools
            ),
            key=lambda tick: tick.seq,
        )
        self._market_history = snapshot + tail

    def blackout_offering(
        self, instance_type: str, zone: str, capacity_type: str
    ) -> None:
        """Interruption-driven exclusion rides the ICE blackout cache, so a
        reclaimed pool vanishes from get_instance_types for the TTL and the
        replacement re-solve picks other pools."""
        self.instance_types.cache_unavailable(instance_type, zone, capacity_type)

    def get_instance_types(
        self, constraints: Optional[Constraints] = None
    ) -> List[InstanceType]:
        if constraints is not None and constraints.provider is not None:
            provider = Ec2Provider.deserialize(constraints)
        else:
            provider = self._discovery_provider()
        return self.instance_types.get(provider)

    def default(self, provisioner: Provisioner) -> None:
        default_provider_blob(provisioner, self.cluster_name)

    def validate(self, provisioner: Provisioner) -> None:
        Ec2Provider.deserialize(provisioner.spec.constraints).validate()

    # --- helpers -----------------------------------------------------------

    def _discovery_provider(self) -> Ec2Provider:
        from karpenter_tpu_torch.cloudprovider.ec2.vendor import CLUSTER_TAG_KEY_FORMAT

        discovery = {CLUSTER_TAG_KEY_FORMAT.format(self.cluster_name): "*"}
        return Ec2Provider(
            instance_profile="discovery",
            subnet_selector=discovery,
            security_group_selector=dict(discovery),
        )

    def _throttle(self) -> None:
        while not self._fleet_limiter.try_acquire():
            self.clock.sleep(max(self._fleet_limiter.wait_time(), 0.001))
