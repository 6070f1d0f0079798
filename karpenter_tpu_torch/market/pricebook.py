"""The controller-side fold of the market tick stream.

A ``PriceBook`` is a generation-tagged view of the current spot market: the
latest per-pool discount/depth, which pools are ICE-closed, and the hazard
state the interruption forecast reads (depth trend + recently observed
interruptions). It is rebuilt from scratch on every controller restart by
replaying the provider's tick history from seq 0 — applying is a pure,
idempotent fold (a tick at or below ``last_seq`` is a no-op), so a restart
reconstructs the exact pre-crash state AND generation.

Generation protocol (docs/design/market.md):

- ``generation`` bumps when a pool's discount drifts at least
  ``reprice_threshold`` (relative) away from its anchor — the discount at
  the last bump — or on any ICE open/close. Many sub-threshold ticks that
  cumulatively cross the threshold DO reprice; a storm of tiny jitters does
  not. Consumers key caches on the generation:
  * provisioning stamps it into the compiled-envelope cache key
    (``stamp_epoch``), so a reprice invalidates the compiled envelopes;
  * ``DeviceClusterState.encode_fleet`` keys its fleet cache on
    ``active_fingerprint()``, and the rebuilt fleet's changed price bytes
    miss the content-keyed device-resident cache — the offering arrays
    re-upload exactly when the market moved.
- ``risk_generation`` bumps when the forecast-relevant state changes
  materially (an observed interruption, or a pool's QUANTIZED risk score
  moving) — quantization keeps ordinary depth noise from churning the fleet
  cache every tick.

One book is process-global-active at a time (``set_active_book``): the
penalty hooks in ``ops.encode.build_fleet`` / ``models.solver`` read it
lazily so the whole solver stack — device kernels and numpy mirrors alike —
prices against the same market without threading a handle through every
layer. Tests reset it via the autouse fixture in tests/conftest.py.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Set, Tuple

from karpenter_tpu_torch.cloudprovider.market import SpotMarket
from karpenter_tpu_torch.market.feed import (
    TICK_ICE_CLOSE,
    TICK_ICE_OPEN,
    TICK_PRICE,
    MarketTick,
    Pool,
)
from karpenter_tpu_torch.utils.clock import Clock, SYSTEM_CLOCK

DEFAULT_REPRICE_THRESHOLD = 0.1  # relative discount drift that forces a re-solve

REASON_PRICE = "price-delta"
REASON_ICE = "ice"

# Hazard model: risk = 1 - exp(-(decline + interruptions)) with the depth
# decline trend EWMA'd per pool and observed interruptions decaying on a
# half-life. Quantized to RISK_QUANTUM steps for cache stability.
TREND_EWMA = 0.3
TREND_WEIGHT = 6.0
INTERRUPTION_WEIGHT = 0.8
INTERRUPTION_HALF_LIFE_S = 300.0
RISK_QUANTUM = 1.0 / 32.0


@dataclass(frozen=True)
class Reprice:
    """One generation bump, as the controller's flight record sees it."""

    pool: Pool
    reason: str  # REASON_PRICE | REASON_ICE
    old_discount: float
    new_discount: float
    generation: int


class PriceBook:
    def __init__(
        self,
        clock: Optional[Clock] = None,
        reprice_threshold: float = DEFAULT_REPRICE_THRESHOLD,
    ):
        self.clock = clock or SYSTEM_CLOCK
        self.reprice_threshold = float(reprice_threshold)
        self._lock = threading.Lock()
        self._generation = 0  # vet: guarded-by(self._lock)
        self._risk_generation = 0  # vet: guarded-by(self._lock)
        self._last_seq = 0  # vet: guarded-by(self._lock)
        self._discount: Dict[Pool, float] = {}  # vet: guarded-by(self._lock)
        self._depth: Dict[Pool, float] = {}  # vet: guarded-by(self._lock)
        self._anchor: Dict[Pool, float] = {}  # vet: guarded-by(self._lock)
        self._closed: Set[Pool] = set()  # vet: guarded-by(self._lock)
        # pool -> feed time (tick.at) the CURRENT closure began. Stamped from
        # the tick, not the wall clock, so a restart's replay reconstructs
        # the identical closure age — the drift sweep's sustained-ICE window
        # (closed_since) stays deterministic across crashes.
        self._closed_at: Dict[Pool, float] = {}  # vet: guarded-by(self._lock)
        self._trend: Dict[Pool, float] = {}  # vet: guarded-by(self._lock)
        self._risk_q: Dict[Pool, float] = {}  # vet: guarded-by(self._lock)
        # pool -> (decayed count, clock stamp of last decay)
        self._interruptions: Dict[Pool, Tuple[float, float]] = {}  # vet: guarded-by(self._lock)
        self._last_tick_at: Optional[float] = None  # vet: guarded-by(self._lock)

    # --- fold ---------------------------------------------------------------

    def apply(self, tick: MarketTick) -> Optional[Reprice]:
        """Fold one tick; returns the Reprice when the generation bumped.
        Idempotent on seq: replays (at-least-once delivery, restart re-folds)
        are no-ops past the high-water mark."""
        with self._lock:
            if tick.seq <= self._last_seq:
                return None
            self._last_seq = tick.seq
            self._last_tick_at = tick.at
            if tick.kind in (TICK_ICE_CLOSE, TICK_ICE_OPEN):
                return self._apply_ice_locked(tick)
            if tick.kind != TICK_PRICE:
                return None
            return self._apply_price_locked(tick)

    def _apply_ice_locked(self, tick: MarketTick) -> Reprice:
        if tick.kind == TICK_ICE_CLOSE:
            self._closed.add(tick.pool)
            # setdefault: a repeated close while already closed must not
            # reset the closure age (the sustained-ICE drift window would
            # never elapse under a re-asserting feed).
            self._closed_at.setdefault(tick.pool, tick.at)
        else:
            self._closed.discard(tick.pool)
            self._closed_at.pop(tick.pool, None)
        self._generation += 1
        discount = self._discount.get(tick.pool, tick.discount)
        return Reprice(
            pool=tick.pool,
            reason=REASON_ICE,
            old_discount=discount,
            new_discount=discount,
            generation=self._generation,
        )

    def _apply_price_locked(self, tick: MarketTick) -> Optional[Reprice]:
        pool = tick.pool
        previous_depth = self._depth.get(pool)
        self._discount[pool] = tick.discount
        self._depth[pool] = tick.depth
        if previous_depth is not None and previous_depth > 0:
            delta = (tick.depth - previous_depth) / previous_depth
            trend = (1.0 - TREND_EWMA) * self._trend.get(pool, 0.0)
            self._trend[pool] = trend + TREND_EWMA * delta
            self._requantize_risk_locked(pool)
        anchor = self._anchor.get(pool)
        if anchor is None:
            # First sighting: anchor silently — the initial market snapshot
            # is not a reprice, or boot would storm one bump per pool.
            self._anchor[pool] = tick.discount
            return None
        if abs(tick.discount - anchor) < self.reprice_threshold * anchor:
            return None
        self._anchor[pool] = tick.discount
        self._generation += 1
        return Reprice(
            pool=pool,
            reason=REASON_PRICE,
            old_discount=anchor,
            new_discount=tick.discount,
            generation=self._generation,
        )

    # --- hazard -------------------------------------------------------------

    def note_interruption(self, pool: Pool) -> None:
        """An interruption landed on this pool (the interruption controller
        calls this at ingest): raise its hazard with a decaying count."""
        pool = tuple(pool)
        now = self.clock.now()
        with self._lock:
            self._interruptions[pool] = (
                self._decayed_locked(pool, now) + 1.0,
                now,
            )
            self._risk_generation += 1
            self._requantize_risk_locked(pool)

    def _decayed_locked(self, pool: Pool, now: float) -> float:
        entry = self._interruptions.get(pool)
        if entry is None:
            return 0.0
        count, stamp = entry
        return count * 0.5 ** ((now - stamp) / INTERRUPTION_HALF_LIFE_S)

    def pool_risk(self, pool: Pool) -> float:
        """Interruption hazard in [0, 1): depth-decline trend + recent
        observed interruptions. 0 for pools with no adverse signal."""
        pool = tuple(pool)
        now = self.clock.now()
        with self._lock:
            return self._risk_locked(pool, now)

    def _risk_locked(self, pool: Pool, now: float) -> float:
        decline = max(0.0, -self._trend.get(pool, 0.0))
        pressure = (
            TREND_WEIGHT * decline
            + INTERRUPTION_WEIGHT * self._decayed_locked(pool, now)
        )
        if pressure <= 0.0:
            return 0.0
        risk = 1.0 - math.exp(-pressure)
        # Quantize so the fleet-cache fingerprint only churns on material
        # moves, and so penalty columns are stable across jitter.
        return math.floor(risk / RISK_QUANTUM) * RISK_QUANTUM

    def _requantize_risk_locked(self, pool: Pool) -> None:
        quantized = self._risk_locked(pool, self.clock.now())
        if self._risk_q.get(pool, 0.0) != quantized:
            self._risk_q[pool] = quantized
            self._risk_generation += 1

    def has_risk(self) -> bool:
        """Cheap gate for the penalty hooks: False = every pool's risk is 0
        and the hooks skip entirely (bit-identical to no book at all)."""
        with self._lock:
            return any(q > 0.0 for q in self._risk_q.values())

    def risk_snapshot(self) -> Dict[Pool, float]:
        """Read-only quantized risk for every pool with any hazard state,
        under ONE lock acquisition and ONE clock read — the hot solve
        path's view (forecast.type_risks / risk_matrix loop over T x Z
        pools; per-pool pool_risk() calls would take the lock and the
        clock once per pool, contending with the market sweep's folds).
        Pools absent from the snapshot have risk 0, matching pool_risk."""
        now = self.clock.now()
        with self._lock:
            pools = (
                set(self._trend)
                | set(self._risk_q)
                | set(self._interruptions)
            )
            return {pool: self._risk_locked(pool, now) for pool in pools}

    def requantized_risks(self) -> Dict[Pool, float]:
        """Current quantized risk for every known pool, REQUANTIZING as
        time decays the interruption hazard: a pool that stops ticking
        would otherwise keep its last event-driven quantum forever —
        pool_risk() would read 0 while the fleet-cache fingerprint (and so
        the penalty the packer actually pays) stayed pinned at the old
        value. The market sweep calls this every cycle and publishes the
        result, so any quantum crossing (up OR down) bumps
        risk_generation and the caches track decay even for pools that
        never tick again."""
        now = self.clock.now()
        with self._lock:
            pools = (
                set(self._discount)
                | set(self._trend)
                | set(self._risk_q)
                | set(self._interruptions)
            )
            out: Dict[Pool, float] = {}
            for pool in pools:
                quantized = self._risk_locked(pool, now)
                if self._risk_q.get(pool, 0.0) != quantized:
                    self._risk_q[pool] = quantized
                    self._risk_generation += 1
                out[pool] = quantized
            return out

    # --- views --------------------------------------------------------------

    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation

    @property
    def risk_generation(self) -> int:
        with self._lock:
            return self._risk_generation

    @property
    def last_seq(self) -> int:
        with self._lock:
            return self._last_seq

    def fingerprint(self) -> Tuple[int, int]:
        with self._lock:
            return (self._generation, self._risk_generation)

    def spot_discount(self, pool: Pool) -> Optional[float]:
        with self._lock:
            return self._discount.get(tuple(pool))

    def is_closed(self, pool: Pool) -> bool:
        with self._lock:
            return tuple(pool) in self._closed

    def closed_since(self, pool: Pool) -> Optional[float]:
        """Feed time (tick.at) the pool's CURRENT ICE closure began; None if
        open. The drift sweep compares this against the feed's latest tick
        time to decide "ICE-closed past a sustained window" — transient
        blackouts (ordinary 45s ICE TTL churn) must not drift a fleet."""
        with self._lock:
            return self._closed_at.get(tuple(pool))

    def last_tick_at(self) -> Optional[float]:
        """Feed time of the newest applied tick (None until the first) — the
        clock domain closed_since lives in."""
        with self._lock:
            return self._last_tick_at

    def pools(self):
        with self._lock:
            return list(self._discount)

    def staleness_s(self, now: Optional[float] = None) -> float:
        """Feed-time age of the newest applied tick — the blackout signal
        (market_feed_staleness_seconds). 0 until the first tick lands."""
        with self._lock:
            if self._last_tick_at is None:
                return 0.0
            now = self.clock.now() if now is None else now
            return max(0.0, now - self._last_tick_at)

    def market(self) -> SpotMarket:
        """The current market as cloudprovider.market.SpotMarket — what
        ``simulate_plan_cost`` prices plans against (the capstone's
        post-spike oracle)."""
        with self._lock:
            return SpotMarket(
                discount=dict(self._discount), depth=dict(self._depth)
            )


# --- process-active book ------------------------------------------------------
#
# One book per controller process (Manager sets it at boot; a restarted
# Manager replaces it). GIL-atomic module slot, read lazily by the penalty
# hooks and the cache-key stampers so no solver-layer signature changes.

_active_book: Optional[PriceBook] = None


def set_active_book(book: Optional[PriceBook]) -> None:
    global _active_book
    _active_book = book


def active_book() -> Optional[PriceBook]:
    return _active_book


def active_fingerprint() -> Optional[Tuple[int, int]]:
    book = _active_book
    return None if book is None else book.fingerprint()


def active_generation() -> Optional[int]:
    book = _active_book
    return None if book is None else book.generation


def advertised_price(
    book: Optional["PriceBook"],
    pool: Pool,
    capacity_type: str,
    catalog_price: float,
    od_price: Optional[float] = None,
) -> Optional[float]:
    """THE advertised-repricing rule, shared by every provider's catalog
    path so the fake and EC2 backends cannot drift: no book / non-spot
    offering → the catalog price; an ICE-closed pool → None (the offering
    vanishes); a folded discount with an on-demand anchor → od × discount;
    no folded discount yet, or no anchor (a spot-only zone) → the catalog
    price untouched — a discount must never compound onto an
    already-discounted spot price."""
    from karpenter_tpu_torch.api import wellknown

    if book is None or capacity_type != wellknown.CAPACITY_TYPE_SPOT:
        return catalog_price
    pool = tuple(pool)
    if book.is_closed(pool):
        return None
    discount = book.spot_discount(pool)
    if discount is None or od_price is None or od_price <= 0:
        return catalog_price
    return od_price * discount


def stamp_epoch(tag):
    """Combine a DeviceClusterState.compile_tag() with the market generation
    so a reprice invalidates the compiled-envelope cache: the cache keys
    on this value opaquely, and any generation bump changes it. None tags
    stay None (no caching)."""
    if tag is None:
        return None
    generation = active_generation()
    if generation is None:
        return tag
    return (tag, generation)


__all__ = [
    "PriceBook",
    "Reprice",
    "REASON_ICE",
    "REASON_PRICE",
    "advertised_price",
    "active_book",
    "active_fingerprint",
    "active_generation",
    "set_active_book",
    "stamp_epoch",
]
