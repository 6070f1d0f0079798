"""Process-level GC tuning for the controller binaries.

CPython's default gen-0 collection threshold (700 container allocations)
makes the cyclic collector run thousands of times during a pod storm —
every watch event, reconcile, and solve allocates dicts — and each run also
fires jax's registered GC callback. Raising the thresholds the way
long-running Python services do (the analogue of the GOGC headroom the Go
reference gets by default) removes ~25% of storm-drain wall clock
(bench.py bench_pod_storm) with bounded extra footprint: nearly all of this
workload's garbage is acyclic and freed by refcount regardless; the cyclic
collector only needs to catch rare reference cycles.

Applied at boot by cmd/controller.py and the solver sidecar, and by the
storm benchmark (which stands in for the controller binary).
"""

from __future__ import annotations

import gc

# gen0: collections per container-allocation delta; gen1/gen2 stay at the
# CPython defaults so full collections still happen on a bounded cadence —
# gen0 frequency is the whole storm win, and multiplying the older
# generations too would make surviving cycles effectively immortal in a
# long-running service.
GEN0_THRESHOLD = 100_000
GEN1_THRESHOLD = 10
GEN2_THRESHOLD = 10


def tune_gc() -> None:
    """Raise collector thresholds for long-running controller processes."""
    gc.collect()
    gc.set_threshold(GEN0_THRESHOLD, GEN1_THRESHOLD, GEN2_THRESHOLD)
