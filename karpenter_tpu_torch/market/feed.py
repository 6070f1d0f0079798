"""A seeded, replayable spot-market tick stream.

The reference requeues provisioners every 5 minutes purely to pick up
instance-type/pricing drift (SURVEY.md §2.2) — the market is an input that
*changes*. This module is the fake/simulated source of that change: a
regime-switching random walk over each pool's spot discount and capacity
depth, plus ICE (insufficient-capacity) open/close churn, emitted as a
strictly-ordered tick sequence.

Determinism contract (the crash battletest leans on every clause):

- The walk is driven by ONE ``random.Random(seed)``; the tick sequence is a
  pure function of (pools, seed, tunables, number of steps taken). Two feeds
  built alike and advanced to the same step count emit byte-identical ticks
  (``MarketTick.encode``).
- Every emitted tick is retained in order; ``ticks_after(seq)`` replays any
  suffix. A restarted controller re-folds from seq 0 and reconstructs the
  exact PriceBook state and generation the dead one had — no ack protocol,
  no controller-side durable cursor (the feed IS the durable history, the
  way DescribeSpotPriceHistory is on EC2).
- Scripted shoves (``force_spike``, ``force_ice``) take effect at the next
  step and are recorded as ordinary ticks, so a replay that includes them is
  still just ``ticks_after(0)``.

Steps are paced by the provider's clock: ``advance(now)`` emits the ticks
for every elapsed ``tick_interval_s`` since construction. The fake provider
calls it at each ``poll_market_events``; tests call it directly.
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Pool = Tuple[str, str]  # (instance_type_name, zone)

TICK_PRICE = "price"
TICK_ICE_CLOSE = "ice-close"
TICK_ICE_OPEN = "ice-open"

# Market regimes: calm drifts, volatile swings, spike ratchets the discount
# up (spot price toward on-demand — the market losing depth).
REGIME_CALM = 0
REGIME_VOLATILE = 1
REGIME_SPIKE = 2

# Per-step regime transition probabilities (row = current regime). Spikes
# are rare and short; volatility is the common excited state.
_TRANSITIONS = {
    REGIME_CALM: ((REGIME_VOLATILE, 0.05), (REGIME_SPIKE, 0.01)),
    REGIME_VOLATILE: ((REGIME_CALM, 0.15), (REGIME_SPIKE, 0.03)),
    REGIME_SPIKE: ((REGIME_VOLATILE, 0.35),),
}
# Multiplicative walk sigma per regime (log-ish steps, clamped).
_SIGMA = {REGIME_CALM: 0.01, REGIME_VOLATILE: 0.05, REGIME_SPIKE: 0.0}
# Spike regime: discount ratchets up by this factor per step while depth
# decays — the "pool is being bought out from under you" shape the forecast
# exists to catch BEFORE the interruptions land.
_SPIKE_DISCOUNT_STEP = 1.25
_SPIKE_DEPTH_STEP = 0.6

MIN_DISCOUNT = 0.2
MAX_DISCOUNT = 0.98
MIN_DEPTH = 0.05
MAX_DEPTH = 4.0


@dataclass(frozen=True)
class MarketTick:
    """One market event. ``seq`` is the feed-global strict order; ``at`` is
    the feed-clock timestamp the event happened at. ``price`` kinds carry
    the pool's new discount (spot/on-demand ratio) and depth; ICE kinds
    toggle the pool's spot availability."""

    seq: int
    kind: str  # TICK_PRICE | TICK_ICE_CLOSE | TICK_ICE_OPEN
    instance_type: str
    zone: str
    discount: float = 1.0
    depth: float = 1.0
    at: float = 0.0

    @property
    def pool(self) -> Pool:
        return (self.instance_type, self.zone)

    def encode(self) -> str:
        """Canonical wire form — the determinism tests compare these, so
        two 'identical' tick sequences must agree to the last bit."""
        return "|".join(
            (
                str(self.seq),
                self.kind,
                self.instance_type,
                self.zone,
                repr(self.discount),
                repr(self.depth),
                repr(self.at),
            )
        )


class MarketFeed:
    """Regime-switching walk over a fixed pool set. Thread-safe: the
    provider polls from sweep threads while tests shove spikes in."""

    def __init__(
        self,
        pools: Sequence[Pool],
        seed: int = 0,
        tick_interval_s: float = 1.0,
        start_at: float = 0.0,
        initial_discount: float = 0.55,
        ice_close_rate: float = 0.0,
        ice_reopen_rate: float = 0.25,
    ):
        self.pools = [tuple(pool) for pool in pools]
        self.tick_interval_s = float(tick_interval_s)
        self.ice_close_rate = float(ice_close_rate)
        self.ice_reopen_rate = float(ice_reopen_rate)
        self._rng = random.Random(seed)  # vet: guarded-by(self._lock)
        self._lock = threading.Lock()
        self._anchor = float(start_at)  # vet: guarded-by(self._lock)
        self._steps = 0  # vet: guarded-by(self._lock)
        self._seq = 0  # vet: guarded-by(self._lock)
        self._history: List[MarketTick] = []  # vet: guarded-by(self._lock)
        self._discount: Dict[Pool, float] = {}  # vet: guarded-by(self._lock)
        self._depth: Dict[Pool, float] = {}  # vet: guarded-by(self._lock)
        self._regime: Dict[Pool, int] = {}  # vet: guarded-by(self._lock)
        self._closed: Dict[Pool, bool] = {}  # vet: guarded-by(self._lock)
        self._forced_spike: Dict[Pool, float] = {}  # vet: guarded-by(self._lock)
        self._forced_ice: Dict[Pool, str] = {}  # vet: guarded-by(self._lock)
        with self._lock:
            for pool in self.pools:
                # Seeded initial state, then one snapshot tick per pool so a
                # fold from seq 0 sees the whole market before any step.
                self._discount[pool] = _clamp(
                    initial_discount * (0.9 + 0.2 * self._rng.random()),
                    MIN_DISCOUNT,
                    MAX_DISCOUNT,
                )
                self._depth[pool] = _clamp(
                    0.5 + self._rng.random(), MIN_DEPTH, MAX_DEPTH
                )
                self._regime[pool] = REGIME_CALM
                self._closed[pool] = False
                self._emit_price_locked(pool, self._anchor)

    def rebase(self, start_at: float) -> None:
        """Re-anchor an UN-STEPPED feed's clock — the attach-time guard
        against the epoch-anchor footgun: a feed built with the default
        start_at=0.0 and polled against a provider clock sitting at, say,
        1e6 would owe a million steps at the first poll. The provider
        calls this at attach; once any step has run it is a no-op (the
        walk's history is immutable). The initial per-pool snapshot ticks
        restamp to the new anchor so feed staleness starts at zero."""
        from dataclasses import replace

        with self._lock:
            if self._steps:
                return
            self._anchor = float(start_at)
            self._history = [
                replace(tick, at=self._anchor) for tick in self._history
            ]

    # --- scripted shoves (take effect at the next step, as ticks) ----------

    def force_spike(self, pools: Iterable[Pool], factor: float) -> None:
        """Script a price spike: at the next step each pool's discount jumps
        by ``factor`` (clamped) and its regime goes SPIKE. Recorded as
        ordinary price ticks, so replay determinism is untouched."""
        with self._lock:
            for pool in pools:
                self._forced_spike[tuple(pool)] = float(factor)

    def force_ice(self, pools: Iterable[Pool], close: bool = True) -> None:
        """Script ICE churn: close (or reopen) pools at the next step."""
        kind = TICK_ICE_CLOSE if close else TICK_ICE_OPEN
        with self._lock:
            for pool in pools:
                self._forced_ice[tuple(pool)] = kind

    # --- stream -------------------------------------------------------------

    def advance(self, now: float) -> int:
        """Emit ticks for every tick_interval_s elapsed since construction;
        returns how many steps ran."""
        with self._lock:
            due = int(max(0.0, now - self._anchor) / self.tick_interval_s)
            ran = 0
            while self._steps < due:
                self._steps += 1
                self._step_locked(
                    self._anchor + self._steps * self.tick_interval_s
                )
                ran += 1
            return ran

    def ticks_after(self, seq: int) -> List[MarketTick]:
        with self._lock:
            if seq <= 0:
                return list(self._history)
            # seqs are dense and 1-based: history[k] has seq k+1.
            return list(self._history[seq:])

    @property
    def last_seq(self) -> int:
        with self._lock:
            return self._seq

    def encode_history(self) -> List[str]:
        with self._lock:
            return [tick.encode() for tick in self._history]

    # --- the walk -----------------------------------------------------------

    def _step_locked(self, at: float) -> None:
        for pool in self.pools:
            self._step_pool_locked(pool, at)

    def _step_pool_locked(self, pool: Pool, at: float) -> None:
        forced_ice = self._forced_ice.pop(pool, None)
        if forced_ice is not None:
            self._emit_ice_locked(pool, forced_ice, at)
        elif self._closed[pool]:
            if self._rng.random() < self.ice_reopen_rate:
                self._emit_ice_locked(pool, TICK_ICE_OPEN, at)
        elif self.ice_close_rate and self._rng.random() < self.ice_close_rate:
            self._emit_ice_locked(pool, TICK_ICE_CLOSE, at)

        forced = self._forced_spike.pop(pool, None)
        if forced is not None:
            self._regime[pool] = REGIME_SPIKE
            self._discount[pool] = _clamp(
                self._discount[pool] * forced, MIN_DISCOUNT, MAX_DISCOUNT
            )
            self._depth[pool] = _clamp(
                self._depth[pool] * _SPIKE_DEPTH_STEP, MIN_DEPTH, MAX_DEPTH
            )
            self._emit_price_locked(pool, at)
            return
        regime = self._next_regime_locked(self._regime[pool])
        self._regime[pool] = regime
        if regime == REGIME_SPIKE:
            self._discount[pool] = _clamp(
                self._discount[pool] * _SPIKE_DISCOUNT_STEP,
                MIN_DISCOUNT,
                MAX_DISCOUNT,
            )
            self._depth[pool] = _clamp(
                self._depth[pool] * _SPIKE_DEPTH_STEP, MIN_DEPTH, MAX_DEPTH
            )
        else:
            sigma = _SIGMA[regime]
            self._discount[pool] = _clamp(
                self._discount[pool]
                * (1.0 + sigma * (2.0 * self._rng.random() - 1.0)),
                MIN_DISCOUNT,
                MAX_DISCOUNT,
            )
            # Depth moves loosely AGAINST price (a draining pool gets
            # pricier), plus its own noise.
            self._depth[pool] = _clamp(
                self._depth[pool]
                * (1.0 + 2.0 * sigma * (2.0 * self._rng.random() - 1.0)),
                MIN_DEPTH,
                MAX_DEPTH,
            )
        self._emit_price_locked(pool, at)

    def _next_regime_locked(self, regime: int) -> int:
        roll = self._rng.random()
        acc = 0.0
        for target, probability in _TRANSITIONS[regime]:
            acc += probability
            if roll < acc:
                return target
        return regime

    # --- emit ---------------------------------------------------------------

    def _emit_price_locked(self, pool: Pool, at: float) -> None:
        self._seq += 1
        self._history.append(
            MarketTick(
                seq=self._seq,
                kind=TICK_PRICE,
                instance_type=pool[0],
                zone=pool[1],
                discount=self._discount[pool],
                depth=self._depth[pool],
                at=at,
            )
        )

    def _emit_ice_locked(self, pool: Pool, kind: str, at: float) -> None:
        self._closed[pool] = kind == TICK_ICE_CLOSE
        self._seq += 1
        self._history.append(
            MarketTick(
                seq=self._seq,
                kind=kind,
                instance_type=pool[0],
                zone=pool[1],
                discount=self._discount[pool],
                depth=self._depth[pool],
                at=at,
            )
        )


def _clamp(value: float, lo: float, hi: float) -> float:
    return max(lo, min(hi, value))


def catalog_pools(
    instance_types, capacity_type: str = "spot"
) -> List[Pool]:
    """Every (type, zone) pool a catalog offers at ``capacity_type`` — the
    usual feed universe for a provider's catalog."""
    pools: List[Pool] = []
    seen = set()
    for it in instance_types:
        for offering in it.offerings:
            if offering.capacity_type != capacity_type:
                continue
            pool = (it.name, offering.zone)
            if pool not in seen:
                seen.add(pool)
                pools.append(pool)
    return pools


__all__ = [
    "MarketFeed",
    "MarketTick",
    "TICK_PRICE",
    "TICK_ICE_CLOSE",
    "TICK_ICE_OPEN",
    "catalog_pools",
]
