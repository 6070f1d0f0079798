"""The preference-relaxation ladder as data.

Ref: selection/preferences.go:64-106 — the reference relaxes a stuck pod one
step per retry (drop the heaviest preferred term, then drop leading required
OR-terms, never the last one) and re-runs the whole schedule at each step.
Here the SAME step sequence is materialized up front as an explicit list of
levels, so the constraint compiler can lower every level into one [L, G, T]
tensor and the pack kernel can solve them all in a single dispatch
(ops/pack_kernel.pack_kernel_levels), picking the strictest feasible level on
device instead of walking the ladder one 1-second requeue at a time.

Level 0 is the pod's full preference state; each subsequent level is exactly
one Preferences.Relax step further. The per-level *requirement view* mirrors
PodSpec.scheduling_requirements (node selector + heaviest remaining preferred
term + first remaining required OR-term) so level 0 of the ladder is
bit-identical to what the legacy one-shot path solved.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from karpenter_tpu_torch.api.pods import PodSpec, PreferredTerm
from karpenter_tpu_torch.api.requirements import Requirement, Requirements

# Static cap on ladder depth: the L axis is a compiled tensor dimension, so a
# pathological pod with dozens of terms must not mint a fresh kernel bucket.
# The final state (everything droppable dropped) is always included, so
# capping only skips intermediate steps of absurd ladders.
MAX_LEVELS = 8


@dataclass(frozen=True)
class LadderState:
    """One relaxation level: the preferred/required terms still standing."""

    preferred: Tuple[PreferredTerm, ...]
    required: Tuple[Tuple[Requirement, ...], ...]

    def requirements(self, pod: PodSpec) -> Requirements:
        """The level's requirement view — scheduling_requirements() evaluated
        at this relaxation state (one definition, so the compiler and the
        scheduler's per-level validation cannot drift)."""
        requirements: List[Requirement] = [
            Requirement.in_(key, [value])
            for key, value in sorted(pod.node_selector.items())
        ]
        if self.preferred:
            heaviest = max(self.preferred, key=lambda term: term.weight)
            requirements.extend(heaviest.requirements)
        if self.required:
            requirements.extend(self.required[0])
        return Requirements(requirements)


@dataclass(frozen=True)
class RelaxationLadder:
    """All relaxation levels of one pod signature, strictest first."""

    states: Tuple[LadderState, ...]

    @property
    def num_levels(self) -> int:
        return len(self.states)

    def describe(self, level: int) -> str:
        if level >= self.num_levels:
            return "infeasible"
        state = self.states[min(level, self.num_levels - 1)]
        return (
            f"level {level}: {len(state.preferred)} preferred, "
            f"{len(state.required)} required terms"
        )

    def fingerprint(self) -> Tuple:
        """Hashable identity — part of the compiled-schedule signature."""
        return tuple(
            (
                tuple(
                    (t.weight, tuple((r.key, r.operator, r.values) for r in t.requirements))
                    for t in state.preferred
                ),
                tuple(
                    tuple((r.key, r.operator, r.values) for r in term)
                    for term in state.required
                ),
            )
            for state in self.states
        )


def build_ladder(pod: PodSpec, max_levels: int = MAX_LEVELS) -> RelaxationLadder:
    """Materialize the full Preferences.Relax step sequence for one pod.

    The step rule is a literal transcription of selection/preferences.go
    (and our former Preferences.advance): drop the heaviest preferred term
    while any remain, then drop leading required OR-terms down to the last
    one, which is never dropped."""
    preferred: List[PreferredTerm] = list(pod.preferred_terms)
    required: List[List[Requirement]] = [list(term) for term in pod.required_terms]
    states: List[LadderState] = [
        LadderState(tuple(preferred), tuple(tuple(t) for t in required))
    ]
    while True:
        if preferred:
            heaviest = max(preferred, key=lambda term: term.weight)
            preferred = [term for term in preferred if term is not heaviest]
        elif len(required) > 1:
            required = required[1:]
        else:
            break
        states.append(
            LadderState(tuple(preferred), tuple(tuple(t) for t in required))
        )
    if len(states) > max_levels:
        # Keep the strictest (max_levels - 1) states plus the fully-relaxed
        # terminal state — the two ends are what correctness depends on.
        states = states[: max_levels - 1] + [states[-1]]
    return RelaxationLadder(states=tuple(states))
