"""Taints and tolerations.

Ref: pkg/apis/provisioning/v1alpha5/taints.go — provisioner taints must be
tolerated by every pod scheduled to its nodes, and pods with Equal-operator
tolerations imprint matching taints onto the nodes provisioned for them so
dedicated-node workflows work without pre-declaring taints.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

EFFECT_NO_SCHEDULE = "NoSchedule"
EFFECT_PREFER_NO_SCHEDULE = "PreferNoSchedule"
EFFECT_NO_EXECUTE = "NoExecute"

OP_EXISTS = "Exists"
OP_EQUAL = "Equal"


@dataclass(frozen=True)
class Taint:
    key: str
    value: str = ""
    effect: str = EFFECT_NO_SCHEDULE


@dataclass(frozen=True)
class Toleration:
    key: str = ""
    operator: str = OP_EQUAL
    value: str = ""
    effect: str = ""  # "" tolerates all effects

    def tolerates(self, taint: Taint) -> bool:
        if self.effect and self.effect != taint.effect:
            return False
        if not self.key:
            # Empty key with Exists tolerates everything.
            return self.operator == OP_EXISTS
        if self.key != taint.key:
            return False
        if self.operator == OP_EXISTS:
            return True
        return self.value == taint.value


def taints_tolerate_pod(taints: Sequence[Taint], tolerations: Sequence[Toleration]) -> bool:
    """True iff every NoSchedule/NoExecute taint is tolerated by some toleration
    (PreferNoSchedule is advisory and never blocks; matches kube semantics and
    ref: taints.go Tolerates)."""
    for taint in taints:
        if taint.effect == EFFECT_PREFER_NO_SCHEDULE:
            continue
        if not any(toleration.tolerates(taint) for toleration in tolerations):
            return False
    return True


def taints_for_pod(
    existing: Sequence[Taint], tolerations: Sequence[Toleration]
) -> List[Taint]:
    """Existing taints plus taints imprinted from the pod's Equal tolerations
    (ref: taints.go WithPod — only fully-specified Equal tolerations generate
    taints, and only if no taint with that key/effect already exists)."""
    out = list(existing)
    for toleration in tolerations:
        if toleration.operator != OP_EQUAL or not toleration.key or not toleration.effect:
            continue
        if any(t.key == toleration.key and t.effect == toleration.effect for t in out):
            continue
        out.append(
            Taint(key=toleration.key, value=toleration.value, effect=toleration.effect)
        )
    return out
