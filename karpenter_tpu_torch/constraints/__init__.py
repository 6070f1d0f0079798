"""Constraint compiler subsystem: scheduling constraints as kernel tensors.

Lowers pod affinity/anti-affinity, topology-spread constraints (arbitrary
node-label keys), and the preference-relaxation ladder into device-resident
[L, G, T] masks/penalties, solved for every relaxation level in ONE kernel
dispatch with the strictest feasible level selected on device
(docs/design/constraint-compiler.md).

Layering:
    ladder.py    — the relaxation ladder as explicit levels
    compiler.py  — constraints -> [L, G, T] tensors (+ epoch-tagged cache)
    mirror.py    — bit-identical numpy twin of the kernel for host solvers
    solve.py     — dispatch + domain-pinned decode (the solve boundary)

Exports resolve lazily (PEP 562): compiler.py/solve.py pull in the jax
kernel stack, and the jax-free submodules (ladder, terms) must stay
importable without it — controllers/scheduling.py imports them at module
scope, and this __init__ runs on any submodule import.
"""

from __future__ import annotations

import os

_EXPORTS = {
    "CompiledConstraints": "compiler",
    "CompilerCache": "compiler",
    "compile_constraints": "compiler",
    "shared_cache": "compiler",
    "MAX_LEVELS": "ladder",
    "RelaxationLadder": "ladder",
    "build_ladder": "ladder",
    "ConstraintDecision": "solve",
    "decode_constrained": "solve",
    "solve_constrained": "solve",
}

__all__ = sorted(_EXPORTS) + ["greedy_topology_enabled"]


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{module}"), name)


def greedy_topology_enabled() -> bool:
    """True when KARPENTER_GREEDY_TOPOLOGY forces the legacy host-side
    Topology.inject pre-pass (kept for parity testing) instead of the
    compiled [L, G, T] path."""
    return os.environ.get("KARPENTER_GREEDY_TOPOLOGY", "").lower() in (
        "1",
        "true",
        "on",
    )
