"""Live market dynamics: the spot market as a STREAMED input.

`cloudprovider/market.py` models what the market IS (per-pool discount/depth
state and the fleet-allocation semantics that price a plan against it); this
package models how that state MOVES and how the control plane reacts:

- ``feed``      — a seeded, replayable tick stream (regime-switching walk
                  over discount/depth per pool, plus ICE open/close churn)
                  delivered through ``CloudProvider.poll_market_events``.
- ``pricebook`` — the controller-side fold of that stream: a generation-
                  tagged view of the current market that every cost decision
                  (provisioning, consolidation, launch pool ranking) reads,
                  plus the per-pool interruption-hazard state the forecast
                  derives from depth trend + observed interruptions.
- ``forecast``  — the interruption-risk estimator lowered as a per-[T]
                  penalty column into the fused kernel dispatch and the
                  consolidation scoring (bit-identical numpy mirror).

The sweep that drives it lives in ``controllers/market.py``; see
docs/design/market.md for the feed model, the generation/invalidation
protocol, and the storm composition (`make market-smoke`).

Everything here is jax-free (numpy only): the penalty column is computed
host-side and ADDED to the [T] price vector both the device kernel and the
numpy host mirrors consume, so forecast-aware packing cannot introduce a
kernel/host parity gap by construction.
"""

from __future__ import annotations

_EXPORTS = {
    "MarketFeed": "karpenter_tpu_torch.market.feed",
    "MarketTick": "karpenter_tpu_torch.market.feed",
    "PriceBook": "karpenter_tpu_torch.market.pricebook",
    "Reprice": "karpenter_tpu_torch.market.pricebook",
    "active_book": "karpenter_tpu_torch.market.pricebook",
    "set_active_book": "karpenter_tpu_torch.market.pricebook",
}


def __getattr__(name):  # PEP 562 — submodules import lazily
    module_name = _EXPORTS.get(name)
    if module_name is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(module_name), name)
