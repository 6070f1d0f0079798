"""Interruption-risk forecast, lowered as a per-[T] price penalty column.

The PriceBook tracks per-pool hazard (depth-decline trend + recently
observed interruptions — ``PriceBook.pool_risk``); this module turns it into
the [T] float32 penalty column the packing stack consumes:

    penalty[t] = prices[t] * risk[t] * RISK_PRICE_WEIGHT
    effective_prices = float32(prices + penalty)

The column is computed HOST-SIDE (numpy, float32) and added to the price
vector *before* dispatch, so the fused device kernel and every numpy host
mirror (greedy/native/mix) consume the same bits — forecast-aware packing
cannot open a kernel/host parity gap by construction. ``penalize_prices_torch``
is the torch mirror of the same arithmetic (K10 on the card); tests assert it
bit-identical to the numpy path (the acceptance gate's parity clause).

Applied in two places:

- ``ops.encode.build_fleet`` penalizes the [T] cheapest-offering prices
  (spot fleets only) — provisioning solves AND consolidation's replacement
  scoring (``_replacement_fleet`` routes through build_fleet) both pack away
  from pools trending toward interruption *before* they interrupt.
- ``models.solver._pool_price_matrix`` penalizes the [T, Z] pool ranking so
  pinned launch rows (CreateFleet overrides) avoid risky pools too.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from karpenter_tpu_torch.market.pricebook import PriceBook

# How much of a pool's price one unit of risk adds: 1.0 means a pool at
# quantized risk 0.5 competes as if it cost 1.5x its advertised price — the
# implied cost of the restart churn an interruption causes.
RISK_PRICE_WEIGHT = 1.0


def type_risks(
    type_names: Sequence[str],
    zones_per_type: Sequence[Sequence[str]],
    book: PriceBook,
) -> np.ndarray:
    """[T] float32 hazard per type: the worst (max) risk across the type's
    allowed zones — conservative, so one draining zone is enough to steer
    packing toward a calmer type. One risk_snapshot() (single lock/clock
    round trip) serves the whole T x Z loop."""
    snapshot = book.risk_snapshot()
    risks = np.zeros(len(type_names), dtype=np.float32)
    for index, (name, zones) in enumerate(zip(type_names, zones_per_type)):
        worst = 0.0
        for zone in zones:
            worst = max(worst, snapshot.get((name, zone), 0.0))
        risks[index] = worst
    return risks


def penalty_column(prices: np.ndarray, risks: np.ndarray) -> np.ndarray:
    """[T] float32 penalty — the column lowered into the kernel dispatch."""
    return (
        prices.astype(np.float32)
        * risks.astype(np.float32)
        * np.float32(RISK_PRICE_WEIGHT)
    )


def penalize_prices(prices: np.ndarray, risks: np.ndarray) -> np.ndarray:
    """float32 effective prices = prices + penalty (the numpy path — what
    build_fleet publishes and every solver consumes)."""
    return (
        prices.astype(np.float32) + penalty_column(prices, risks)
    ).astype(np.float32)


def penalize_prices_torch(prices, risks):
    """The torch mirror of penalize_prices (the reference's
    penalize_prices_jnp) — same dtypes, same operation order. A CUDA tensor
    runs K10 (csrc/forecast.cu), anything else the kernel's plain version on
    the CPU. Tests and chip_smoke hold it BIT-IDENTICAL to
    penalize_prices(...); the production path feeds the numpy column to
    both kernel and mirror, so this is a tripwire for the arithmetic ever
    diverging, not a second implementation to maintain."""
    from karpenter_tpu_torch.ops import forecast_kernel

    if not isinstance(prices, torch.Tensor):
        prices = torch.as_tensor(np.asarray(prices, dtype=np.float32))
    prices32 = prices.to(torch.float32).contiguous()
    risks32 = torch.as_tensor(risks, dtype=torch.float32, device=prices32.device).contiguous()
    return forecast_kernel.penalize_prices(prices32, risks32, RISK_PRICE_WEIGHT)


def risk_matrix(
    type_names: Sequence[str],
    zones: Sequence[str],
    book: PriceBook,
) -> np.ndarray:
    """[T, Z] float64 per-pool risk for the launch pool-ranking matrix —
    one risk_snapshot() serves the whole grid (see type_risks)."""
    snapshot = book.risk_snapshot()
    out = np.zeros((len(type_names), len(zones)), dtype=np.float64)
    for ti, name in enumerate(type_names):
        for zi, zone in enumerate(zones):
            out[ti, zi] = snapshot.get((name, zone), 0.0)
    return out


def fleet_zone_lists(kept, allowed_zones) -> List[List[str]]:
    """Per-kept-type allowed zone lists for type_risks — shared by the
    build_fleet hook so both fast and slow kept paths derive identically."""
    return [
        sorted(z for z in item[0].zones() if allowed_zones.contains(z))
        for item in kept
    ]


__all__ = [
    "RISK_PRICE_WEIGHT",
    "fleet_zone_lists",
    "penalize_prices",
    "penalize_prices_torch",
    "penalty_column",
    "risk_matrix",
    "type_risks",
]
