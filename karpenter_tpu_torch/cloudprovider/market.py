"""Spot-market model + EC2 Fleet allocation-strategy simulator.

The reference delegates the final (instance-type, zone, capacity-type) pool
choice to EC2 CreateFleet (ref: pkg/cloudprovider/aws/instance.go:116-133):

  * on-demand -> `lowest-price`: the cheapest offered pool wins.
  * spot      -> `capacity-optimized-prioritized`: EC2 picks the pool with the
    deepest spare capacity, honoring the caller-supplied priority order only
    "on a best-effort basis". The reference sets priority = the option's index
    in its ascending-size window (instance.go:173-207) — price-blind.

So a packing plan's realized $/hr depends on the allocation strategy and on
the spot market's (price, depth) state per pool — not just on the cheapest
offered price. This module models both so that plans from *any* solver are
priced by identical, reproducible fleet semantics:

  * `SpotMarket`: per-(type, zone) spot discount and capacity depth with
    configurable family/zone structure and price<->depth anti-correlation
    (deep pools trend cheap, with idiosyncratic noise — the real spot market's
    loose coupling).
  * `allocate`: one fleet launch decision under either strategy.
  * `simulate_plan_cost`: total realized $/hr for a PackResult.

Nothing here is used to *train* the solver against hidden state: solvers see
only offering prices; the market's depth state is revealed only through the
allocation simulator, exactly as EC2 reveals it only through fulfilment.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from karpenter_tpu_torch.api import wellknown

Pool = Tuple[str, str]  # (instance_type_name, zone)

# EC2 honors spot priorities "on a best-effort basis" while optimizing for
# capacity: model that as "any pool within DEPTH_SLACK of the deepest offered
# pool is capacity-equivalent; the highest-priority pool among those wins".
DEPTH_SLACK = 0.25


@dataclass
class SpotMarket:
    """Per-pool spot price fraction (of on-demand) and capacity depth."""

    discount: Dict[Pool, float] = field(default_factory=dict)  # spot/od price ratio
    depth: Dict[Pool, float] = field(default_factory=dict)  # relative spare capacity

    def spot_price(self, pool: Pool, on_demand_price: float) -> float:
        return on_demand_price * self.discount.get(pool, 1.0)

    def pool_depth(self, pool: Pool) -> float:
        return self.depth.get(pool, 1.0)


def generate_market(
    type_names: Sequence[str],
    zones: Sequence[str],
    seed: int = 0,
    *,
    price_depth_correlation: float = 0.4,
    family_sigma: float = 0.25,
    zone_sigma: float = 0.2,
    noise_sigma: float = 0.12,
    min_discount: float = 0.25,
    max_discount: float = 0.95,
) -> SpotMarket:
    """A structured spot market: depth factors by family and zone (capacity is
    bought per family per AZ), pool-level noise, and discounts that trend
    inversely with depth (deep pool => cheap) but only loosely
    (`price_depth_correlation` in [0, 1]; 0 = independent)."""
    rng = np.random.default_rng(seed)
    families = sorted({name.split(".")[0] for name in type_names})
    family_depth = {f: float(rng.lognormal(0.0, family_sigma)) for f in families}
    zone_depth = {z: float(rng.lognormal(0.0, zone_sigma)) for z in zones}

    market = SpotMarket()
    depths = {}
    for name in type_names:
        family = name.split(".")[0]
        for zone in zones:
            pool = (name, zone)
            depths[pool] = (
                family_depth[family]
                * zone_depth[zone]
                * float(rng.lognormal(0.0, noise_sigma))
            )
    values = np.array(list(depths.values()))
    lo, hi = values.min(), values.max()
    span = max(hi - lo, 1e-9)
    for pool, depth in depths.items():
        normalized = (depth - lo) / span  # [0, 1]
        market.depth[pool] = float(depth)
        # Cheapness rises with depth by `price_depth_correlation`; the rest is
        # idiosyncratic.
        base = 1.0 - price_depth_correlation * normalized
        noise = float(rng.uniform(-1.0, 1.0)) * (1.0 - price_depth_correlation) * 0.35
        discount = np.clip(
            min_discount + (max_discount - min_discount) * (base + noise - 0.35),
            min_discount,
            max_discount,
        )
        market.discount[pool] = float(discount)
    return market


@dataclass
class PoolOffer:
    """One CreateFleet override row (ref: instance.go:173-207)."""

    instance_type: str
    zone: str
    price: float  # $/hr for this pool at the launch's capacity type
    priority: int  # lower = preferred (spot best-effort only)


def allocate(
    offers: Sequence[PoolOffer],
    capacity_type: str,
    market: Optional[SpotMarket] = None,
    excluded: Iterable[Pool] = (),
    depth_slack: float = DEPTH_SLACK,
) -> Optional[PoolOffer]:
    """One node's pool under the reference's fleet strategies
    (instance.go:129-132): lowest-price for on-demand;
    capacity-optimized-prioritized for spot. depth_slack parameterizes how
    "best-effort" EC2's priority honoring is (0 = pure capacity-optimized,
    ignore priorities entirely unless depths tie; 1 = pure priority order) —
    the bench sweeps it to show the cost win isn't an artifact of one
    assumed value."""
    excluded = set(excluded)
    usable = [o for o in offers if (o.instance_type, o.zone) not in excluded]
    if not usable:
        return None
    if capacity_type != wellknown.CAPACITY_TYPE_SPOT or market is None:
        return min(usable, key=lambda o: (o.price, o.priority))
    deepest = max(market.pool_depth((o.instance_type, o.zone)) for o in usable)
    equivalent = [
        o
        for o in usable
        if market.pool_depth((o.instance_type, o.zone)) >= deepest * (1.0 - depth_slack)
    ]
    return min(equivalent, key=lambda o: o.priority)


def plan_offers(
    packing,
    zones: Sequence[str],
    capacity_type: str,
    market: Optional[SpotMarket],
) -> List[PoolOffer]:
    """Override rows for one Packing: option order IS the priority order
    (the reference's ascending-size window / this framework's price ranking),
    crossed with the allowed zones (instance.go:173-207). A packing that pins
    pool-level rows (`pool_options`) supplies them directly — per-pool
    priorities instead of per-type."""
    if getattr(packing, "pool_options", None):
        offers = []
        for pool in packing.pool_options:
            if zones and pool.zone not in zones:
                continue
            price = pool.price
            if capacity_type == wellknown.CAPACITY_TYPE_SPOT and market is not None:
                price = market.spot_price(
                    (pool.instance_type.name, pool.zone),
                    _on_demand_price(pool.instance_type, pool.zone),
                )
            offers.append(
                PoolOffer(
                    instance_type=pool.instance_type.name,
                    zone=pool.zone,
                    price=price,
                    priority=pool.priority,
                )
            )
        return offers
    offers: List[PoolOffer] = []
    for index, instance_type in enumerate(packing.instance_type_options):
        for offering in instance_type.offerings:
            if offering.capacity_type != capacity_type:
                continue
            if zones and offering.zone not in zones:
                continue
            price = offering.price
            if capacity_type == wellknown.CAPACITY_TYPE_SPOT and market is not None:
                price = market.spot_price(
                    (instance_type.name, offering.zone),
                    _on_demand_price(instance_type, offering.zone),
                )
            offers.append(
                PoolOffer(
                    instance_type=instance_type.name,
                    zone=offering.zone,
                    price=price,
                    priority=index,
                )
            )
    return offers


def _on_demand_price(instance_type, zone: str) -> float:
    for offering in instance_type.offerings:
        if (
            offering.zone == zone
            and offering.capacity_type == wellknown.CAPACITY_TYPE_ON_DEMAND
        ):
            return offering.price
    return instance_type.min_price(
        capacity_types=[wellknown.CAPACITY_TYPE_ON_DEMAND]
    )


def capacity_type_for(constraints, instance_types) -> str:
    """Spot iff allowed by constraints and offered by any candidate type
    (ref: instance.go getCapacityType:281-292)."""
    allowed = constraints.effective_requirements().allowed(
        wellknown.CAPACITY_TYPE_LABEL
    )
    if allowed.contains(wellknown.CAPACITY_TYPE_SPOT):
        for instance_type in instance_types:
            if wellknown.CAPACITY_TYPE_SPOT in instance_type.capacity_types():
                return wellknown.CAPACITY_TYPE_SPOT
    return wellknown.CAPACITY_TYPE_ON_DEMAND


def simulate_plan_cost(
    result,
    constraints,
    market: Optional[SpotMarket] = None,
    zones: Sequence[str] = (),
    depth_slack: float = DEPTH_SLACK,
    excluded: Iterable[Pool] = (),
) -> float:
    """Total realized $/hr of a PackResult when every node is bought through
    the reference's fleet strategies against one shared market state.
    `excluded` pools (ICE'd / blacked-out mid-storm) are unpurchasable for
    the allocation AND the infeasible fallback below."""
    allowed_zones = constraints.effective_requirements().allowed(wellknown.ZONE_LABEL)
    zone_filter = [z for z in zones if allowed_zones.contains(z)] if zones else []
    excluded = set(excluded)
    total = 0.0
    for packing in result.packings:
        capacity_type = capacity_type_for(constraints, packing.instance_type_options)
        offers = plan_offers(packing, zone_filter, capacity_type, market)
        chosen = allocate(
            offers, capacity_type, market, excluded=excluded,
            depth_slack=depth_slack,
        )
        if chosen is None:
            # No purchasable pool: price at the best advertised offering that
            # is still purchasable, so an infeasible plan costs rather than
            # silently zeroes. Excluded pools don't advertise — a packing
            # whose every pool is blacked out prices at inf (pricing it at
            # the best ADVERTISED offering silently under-reported storm-
            # time cost).
            chosen_price = min(
                (
                    offering.price
                    for it in packing.instance_type_options
                    for offering in it.offerings
                    if (it.name, offering.zone) not in excluded
                ),
                default=float("inf"),
            )
            total += packing.node_quantity * chosen_price
            continue
        total += packing.node_quantity * chosen.price
    return total
