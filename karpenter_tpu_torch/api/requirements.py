"""Node-selector requirement set algebra.

Ref: pkg/apis/provisioning/v1alpha5/requirements.go — the reference decorates
[]NodeSelectorRequirement with a per-key set evaluator: the allowed values for
a key are the intersection of all In sets minus every NotIn value; a key with
no In requirement is unconstrained (complement set). Only the In / NotIn
operators are supported anywhere in the provisioning path
(ref: selection/controller.go:130-141 rejects the rest).

We represent each key's allowed values as a KeySet — either a finite set
(`complement=False`) or "everything except" (`complement=True`) — which makes
intersection/compatibility exact without enumerating a universe.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import FrozenSet, Iterable, List, Mapping, Optional, Tuple

from karpenter_tpu_torch.api import wellknown

IN = "In"
NOT_IN = "NotIn"
SUPPORTED_OPERATORS = (IN, NOT_IN)


@dataclass(frozen=True)
class Requirement:
    """One node-selector term: key op [values]."""

    key: str
    operator: str
    values: Tuple[str, ...]

    def __post_init__(self):
        object.__setattr__(self, "values", tuple(self.values))

    @staticmethod
    def in_(key: str, values: Iterable[str]) -> "Requirement":
        return Requirement(key=key, operator=IN, values=tuple(values))

    @staticmethod
    def not_in(key: str, values: Iterable[str]) -> "Requirement":
        return Requirement(key=key, operator=NOT_IN, values=tuple(values))


@dataclass(frozen=True)
class KeySet:
    """Allowed values for one key: a finite set, or a complement set."""

    values: FrozenSet[str]
    complement: bool = False  # True => allowed = (universe - values)

    @staticmethod
    def any() -> "KeySet":
        return KeySet(values=frozenset(), complement=True)

    @staticmethod
    def of(values: Iterable[str]) -> "KeySet":
        return KeySet(values=frozenset(values), complement=False)

    def contains(self, value: str) -> bool:
        return (value not in self.values) if self.complement else (value in self.values)

    def intersect(self, other: "KeySet") -> "KeySet":
        if self.complement and other.complement:
            return KeySet(values=self.values | other.values, complement=True)
        if self.complement:
            return KeySet(values=other.values - self.values, complement=False)
        if other.complement:
            return KeySet(values=self.values - other.values, complement=False)
        return KeySet(values=self.values & other.values, complement=False)

    def is_empty(self) -> bool:
        return not self.complement and not self.values

    def is_any(self) -> bool:
        return self.complement and not self.values

    def finite_values(self) -> Optional[FrozenSet[str]]:
        """The allowed values if finite, else None (complement sets are infinite)."""
        return None if self.complement else self.values


class Requirements:
    """An ordered collection of Requirements with set-algebra evaluation."""

    def __init__(self, requirements: Iterable[Requirement] = ()):  # noqa: D401
        self._requirements: List[Requirement] = list(requirements)

    # --- construction ------------------------------------------------------

    @staticmethod
    def from_labels(labels: Mapping[str, str]) -> "Requirements":
        """Each label k=v becomes `k In [v]` (ref: requirements.go LabelRequirements)."""
        return Requirements(
            Requirement.in_(key, [value]) for key, value in sorted(labels.items())
        )

    def add(self, *requirements: Requirement) -> "Requirements":
        """Return a new Requirements with extra terms appended."""
        return Requirements([*self._requirements, *requirements])

    def merge(self, other: "Requirements") -> "Requirements":
        return Requirements([*self._requirements, *other._requirements])

    # --- evaluation --------------------------------------------------------

    def keys(self) -> List[str]:
        seen, out = set(), []
        for requirement in self._requirements:
            if requirement.key not in seen:
                seen.add(requirement.key)
                out.append(requirement.key)
        return out

    def allowed(self, key: str) -> KeySet:
        """Allowed values for key: ∩(In sets) minus ∪(NotIn values)."""
        result = KeySet.any()
        for requirement in self._requirements:
            if requirement.key != key:
                continue
            if requirement.operator == IN:
                result = result.intersect(KeySet.of(requirement.values))
            elif requirement.operator == NOT_IN:
                result = result.intersect(
                    KeySet(values=frozenset(requirement.values), complement=True)
                )
            else:
                raise ValueError(
                    f"unsupported operator {requirement.operator!r} for key {requirement.key!r}"
                )
        return result

    def consolidate(self) -> "Requirements":
        """One canonical requirement per key (ref: requirements.go Consolidate).

        Keys whose allowed set is finite collapse to a single In; complement
        sets collapse to a single NotIn. Empty finite sets are preserved as an
        In with no values (the unsatisfiable requirement), matching the
        reference's behavior of surfacing conflicts rather than dropping them.
        """
        out: List[Requirement] = []
        for key in self.keys():
            keyset = self.allowed(key)
            if keyset.complement:
                if keyset.values:
                    out.append(Requirement.not_in(key, sorted(keyset.values)))
                # is_any(): unconstrained — no requirement emitted.
            else:
                out.append(Requirement.in_(key, sorted(keyset.values)))
        return Requirements(out)

    def compatible_with(self, other: "Requirements") -> bool:
        """True iff for every key constrained by both, the intersection is nonempty."""
        for key in set(self.keys()) | set(other.keys()):
            if self.allowed(key).intersect(other.allowed(key)).is_empty():
                return False
        return True

    def satisfied_by_labels(self, labels: Mapping[str, str]) -> bool:
        """True iff a node with these labels satisfies every constrained key.

        A key constrained to a finite set requires the label to be present and
        allowed; a complement (NotIn-only) key tolerates an absent label.
        """
        for key in self.keys():
            keyset = self.allowed(key)
            if keyset.is_any():
                continue
            value = labels.get(key)
            if value is None:
                if not keyset.complement:
                    return False
                continue
            if not keyset.contains(value):
                return False
        return True

    # --- well-known accessors (ref: requirements.go:27-45) ------------------

    def _finite(self, key: str) -> Optional[FrozenSet[str]]:
        return self.allowed(key).finite_values()

    def zones(self) -> Optional[FrozenSet[str]]:
        return self._finite(wellknown.ZONE_LABEL)

    def instance_types(self) -> Optional[FrozenSet[str]]:
        return self._finite(wellknown.INSTANCE_TYPE_LABEL)

    def architectures(self) -> Optional[FrozenSet[str]]:
        return self._finite(wellknown.ARCH_LABEL)

    def operating_systems(self) -> Optional[FrozenSet[str]]:
        return self._finite(wellknown.OS_LABEL)

    def capacity_types(self) -> Optional[FrozenSet[str]]:
        return self._finite(wellknown.CAPACITY_TYPE_LABEL)

    def well_known(self) -> "Requirements":
        """Only requirements on well-known keys (ref: requirements.go WellKnown)."""
        return Requirements(
            r for r in self._requirements if r.key in wellknown.WELL_KNOWN_LABELS
        )

    # --- plumbing ----------------------------------------------------------

    def __iter__(self):
        return iter(self._requirements)

    def __len__(self):
        return len(self._requirements)

    def __eq__(self, other):
        if not isinstance(other, Requirements):
            return NotImplemented
        return self._requirements == other._requirements

    def __repr__(self):
        terms = ", ".join(
            f"{r.key} {r.operator} {list(r.values)}" for r in self._requirements
        )
        return f"Requirements({terms})"

    def canonical_key(self) -> Tuple:
        """Hashable canonical form — used for isomorphic-constraint grouping
        (ref: scheduling/scheduler.go:88-126 hashes constraints)."""
        parts = []
        for key in sorted(self.keys()):
            keyset = self.allowed(key)
            parts.append((key, keyset.complement, tuple(sorted(keyset.values))))
        return tuple(parts)
