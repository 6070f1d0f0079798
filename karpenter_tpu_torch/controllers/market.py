"""Market sweep: fold provider price/ICE ticks and re-solve on reprice.

The reference requeues every provisioner on a 5-minute timer purely to pick
up instance-type/pricing drift (SURVEY.md §2.2, provisioning/controller.go
:80). This controller is the dynamic analogue: it polls the provider's
market feed (``CloudProvider.poll_market_events`` — DescribeSpotPriceHistory
-shaped on EC2, a seeded replayable walk on the fake), folds ticks into the
generation-tagged PriceBook, and when a pool's price drifts past
``--reprice-threshold`` it requeues provisioning and consolidation NOW —
debounced per pool, so a price storm costs at most one re-solve per pool per
``--reprice-debounce`` window and a sub-threshold storm costs none.

Chaos legs:

- ``market.feed`` faultpoint (stale | reorder | blackout): the feed's
  partial-failure modes. Reordered batches are absorbed by the seq-sorted
  fold; stale polls hold back the newest ticks (they redeliver next sweep);
  a blackout skips the poll entirely and shows up as
  ``market_feed_staleness_seconds`` climbing.
- ``market.mid-tick`` crashpoint between folded ticks: a controller killed
  mid-fold restarts, re-polls from seq 0, and reconstructs the identical
  book state AND generation (the fold is an idempotent pure function of the
  tick sequence — tests/test_market_feed.py, on both store backends).

Every generation bump lands in the flight recorder as a ``reprice`` event
(pool, old/new discount, generation, affected controllers), and launches
stamp the generation they were priced under (controllers/provisioning.py) —
a breach dump names the market state each purchase was made against.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.cloudprovider import CloudProvider
from karpenter_tpu_torch.controllers.cluster import Cluster
from karpenter_tpu_torch.market.pricebook import PriceBook, Reprice
from karpenter_tpu_torch.utils import faultpoints
from karpenter_tpu_torch.utils import logging as klog
from karpenter_tpu_torch.utils.crashpoints import crashpoint
from karpenter_tpu_torch.utils.metrics import REGISTRY
from karpenter_tpu_torch.utils.obs import RECORDER

SWEEP_SECONDS = 1.0
DEFAULT_DEBOUNCE_SECONDS = 5.0
OD_CACHE_TTL_SECONDS = 60.0

MARKET_PRICE_DOLLARS = REGISTRY.gauge(
    "market_price_dollars",
    "Advertised spot $/hr per pool as the controller's PriceBook folds the "
    "feed (pool_kind = instance-type/zone)",
    ["pool_kind"],
)
MARKET_REPRICE_TOTAL = REGISTRY.counter(
    "market_reprice_total",
    "PriceBook generation bumps by reason (price-delta | ice); each one "
    "invalidates the compiled-envelope and fleet caches and requeues the "
    "cost controllers (debounced per pool)",
    ["reason"],
)
MARKET_FEED_STALENESS = REGISTRY.gauge(
    "market_feed_staleness_seconds",
    "Feed-time age of the newest applied market tick — a climbing value "
    "means the feed is blacked out or the provider stopped publishing",
)
FORECAST_RISK_SCORE = REGISTRY.gauge(
    "forecast_risk_score",
    "Quantized interruption-risk forecast per pool (depth-decline trend + "
    "recent interruptions; the per-[T] packing penalty derives from this)",
    ["pool_kind"],
)


def _pool_kind(instance_type: str, zone: str) -> str:
    return f"{instance_type}/{zone}"


class MarketController:
    """Periodic sweep (Manager drives it like interruption/consolidation):
    poll the feed, fold ticks, publish market metrics, requeue cost
    decisions on debounced reprices."""

    def __init__(
        self,
        cluster: Cluster,
        cloud: CloudProvider,
        book: PriceBook,
        debounce_seconds: float = DEFAULT_DEBOUNCE_SECONDS,
        sweep_seconds: float = SWEEP_SECONDS,
    ):
        self.cluster = cluster
        self.cloud = cloud
        self.book = book
        self.debounce_seconds = debounce_seconds
        # Poll cadence: 1s suits the fake's in-memory feed; EC2 deployments
        # should pace this to the API (--market-poll-interval, default 15s
        # there) — every sweep is a paginated DescribeSpotPriceHistory.
        self.sweep_seconds = sweep_seconds
        self.log = klog.named("market")
        # Set by the runtime (Manager._reprice_requeue): enqueues every
        # provisioner plus a consolidation sweep. None in unit harnesses.
        self.requeue = None
        # Reprices awaiting their debounce window, and when each pool last
        # triggered a requeue. Only the single market sweep key touches
        # these (concurrency=1, key collapse-deduped), so no lock.
        self._pending: Dict[tuple, str] = {}
        self._last_requeue: Dict[tuple, float] = {}
        self._od_cache: Optional[Dict[tuple, float]] = None
        self._od_cache_at = float("-inf")
        self._od_no_anchor: set = set()

    # --- sweep --------------------------------------------------------------

    def reconcile(self, _key=None) -> float:
        ticks = self._poll()
        reprices = self._fold(ticks)
        self._publish(ticks, reprices)
        self._requeue_due(reprices)
        return self.sweep_seconds

    def _poll(self) -> List:
        fault = faultpoints.draw("market.feed")
        if fault is not None and fault.kind == "blackout":
            # The feed went dark: nothing delivered this sweep; staleness
            # climbs until the blackout lifts (nothing to retry — the next
            # poll re-reads the full history past the cursor).
            MARKET_FEED_STALENESS.set(self.book.staleness_s())
            return []
        ticks = list(self.cloud.poll_market_events(self.book.last_seq))
        if fault is not None and fault.kind == "stale":
            # The provider served a stale snapshot: the newest half of the
            # batch is missing. Those ticks redeliver next sweep (the
            # cursor only advances past what was folded).
            ticks = ticks[: len(ticks) // 2]
        elif fault is not None and fault.kind == "reorder":
            ticks = list(reversed(ticks))
        return ticks

    def _fold(self, ticks: List) -> List[Reprice]:
        reprices: List[Reprice] = []
        # The fold is seq-ordered regardless of delivery order (the reorder
        # fault above, a racy provider): sorting restores the canonical
        # sequence, and the book's seq high-water mark makes replays no-ops.
        for tick in sorted(ticks, key=lambda t: t.seq):
            reprice = self.book.apply(tick)
            if reprice is not None:
                reprices.append(reprice)
                MARKET_REPRICE_TOTAL.inc(reprice.reason)
                RECORDER.record(
                    "reprice",
                    pool=_pool_kind(*reprice.pool),
                    reason=reprice.reason,
                    old_discount=reprice.old_discount,
                    new_discount=reprice.new_discount,
                    generation=reprice.generation,
                    affected="provisioning,consolidation",
                )
            # A kill between folded ticks: the restart re-polls from seq 0
            # and re-folds to the identical state + generation.
            crashpoint("market.mid-tick")
        return reprices

    def _publish(self, ticks: List, reprices: List[Reprice]) -> None:
        MARKET_FEED_STALENESS.set(self.book.staleness_s())
        # Risk publishes for EVERY book pool, every sweep, through the
        # REQUANTIZING read: the dominant hazard input (note_interruption,
        # from the interruption controller) moves risk on pools that may
        # never tick again, and its decay must reach both this gauge AND
        # the fleet-cache fingerprint (risk_generation bumps on any quantum
        # crossing) — the runbook tells operators to judge launches by this
        # gauge, so it must track what the packer actually pays.
        for pool, risk in self.book.requantized_risks().items():
            FORECAST_RISK_SCORE.set(risk, _pool_kind(*pool))
        if not ticks:
            return
        touched = {tick.pool for tick in ticks}
        od_prices = self._od_prices(touched)
        for pool in touched:
            if self.book.is_closed(pool):
                # The pool advertises NO spot offering while ICE-closed —
                # a retained gauge row would show a live, purchasable-
                # looking price for an unbuyable pool. Drop the series;
                # the reopen tick republishes it.
                kind = _pool_kind(*pool)
                MARKET_PRICE_DOLLARS.remove_where(
                    lambda values: values == (kind,)
                )
                continue
            discount = self.book.spot_discount(pool)
            od = od_prices.get(pool)
            if discount is not None and od is not None:
                MARKET_PRICE_DOLLARS.set(od * discount, _pool_kind(*pool))

    def _od_prices(self, needed: set) -> Dict[tuple, float]:
        """On-demand anchor map for the price gauge, cached: rebuilding the
        full provider catalog (get_instance_types routes every spot offering
        through the repricing rule) every ticking sweep just to read static
        anchors would make the gauge the most expensive part of the sweep.
        Refreshes when a genuinely NEW pool is missing (new type/zone) or
        the cache passes its TTL (anchors move only on catalog changes);
        pools known to have no on-demand anchor — spot-only zones are a
        supported shape — are remembered so they cannot re-trigger the
        rebuild on every ticking sweep."""
        now = self.cluster.clock.now()
        if (
            self._od_cache is None
            or now - self._od_cache_at >= OD_CACHE_TTL_SECONDS
            or any(
                pool not in self._od_cache and pool not in self._od_no_anchor
                for pool in needed
            )
        ):
            out: Dict[tuple, float] = {}
            for it in self.cloud.get_instance_types():
                for offering in it.offerings:
                    if offering.capacity_type == wellknown.CAPACITY_TYPE_ON_DEMAND:
                        out[(it.name, offering.zone)] = offering.price
            self._od_cache = out
            self._od_cache_at = now
            self._od_no_anchor = {p for p in needed if p not in out}
        return self._od_cache

    def _requeue_due(self, reprices: List[Reprice]) -> None:
        """Per-pool debounce: a repricing pool requeues the cost controllers
        at most once per window; bumps inside the window coalesce into the
        pending set (the eventual requeue reads the latest book anyway).
        Sub-threshold storms never reach here at all — no reprice, no
        requeue, the sweep cadence is untouched."""
        for reprice in reprices:
            self._pending[reprice.pool] = reprice.reason
        if not self._pending:
            return
        now = self.cluster.clock.now()
        due = [
            pool
            for pool in self._pending
            if now - self._last_requeue.get(pool, float("-inf"))
            >= self.debounce_seconds
        ]
        if not due:
            return
        for pool in due:
            self._last_requeue[pool] = now
            del self._pending[pool]
        self.log.info(
            "market repriced %d pool(s) (generation %d): requeueing "
            "provisioning + consolidation",
            len(due),
            self.book.generation,
        )
        if self.requeue is not None:
            self.requeue()
