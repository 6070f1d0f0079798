"""The one capped-exponential-backoff formula, plus the shared jitter.

Three delay ladders share the exponential shape — the kube retry envelope
(RetryPolicy.backoff_s, which layers jitter on top), the watch reconnect
backoff (KubeClient._watch_backoff_s), and the reconcile-loop error requeue
(ReconcileLoop._error_backoff_s) — so the formula lives once; a policy
change (e.g. extending jitter to the other ladders) edits one place.

`jittered_s` is the periodic-wait analogue: fixed cadences that several
replicas share (the leader-election renew and campaign polls) must not fire
in lockstep or every replica CASes the lease in the same instant — the
thundering herd the lease is supposed to serialize. Spreading each wait
uniformly over ±fraction decorrelates the replicas while keeping the mean
cadence.
"""

from __future__ import annotations

import random
from typing import Optional


def capped_backoff_s(base_s: float, cap_s: float, attempt: int) -> float:
    """min(cap, base * 2^(attempt-1)) — attempt is 1-based; values below 1
    clamp to the base."""
    return min(cap_s, base_s * (2 ** max(0, attempt - 1)))


def jittered_s(
    base_s: float, fraction: float = 0.2, rng: Optional[random.Random] = None
) -> float:
    """base spread uniformly over [base*(1-fraction), base*(1+fraction)].

    Pass an injected ``rng`` for deterministic tests; the module default is
    unseeded on purpose — decorrelation is the point.
    """
    roll = (rng or _rng).random()
    return base_s * (1.0 - fraction + 2.0 * fraction * roll)


_rng = random.Random()
