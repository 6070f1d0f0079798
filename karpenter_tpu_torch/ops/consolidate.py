"""Batched consolidation counterfactuals — the deprovisioning solve.

The port of karpenter_tpu/ops/consolidate.py. The provisioning kernels answer
"what capacity should be BOUGHT for these pending pods"; this module answers
the inverse question the consolidation controller asks about capacity already
RUNNING: for every candidate node, what happens to the cluster if the node
were gone?

Two counterfactual actions are scored for all candidates in ONE batched
dispatch per sweep:

- **delete** — the candidate's pods are first-fit-decreasing packed into the
  free headroom of the remaining nodes ([C, N, R] fill, victim row masked
  out per candidate). Feasible iff every pod places; savings = the node's
  whole offering price.
- **replace** — the candidate's pods move onto ONE fresh node of a cheaper
  type. For a single receiving node, multi-dimensional feasibility is exact
  additivity: total demand <= usable capacity (score_kernel's
  `feasibility_mask` with the [C, R] demand standing in for the group axis).
  Savings = node price minus the cheapest feasible type's price.

The counterfactual itself is K7 (ops/consolidate_kernel.solve_counterfactuals:
csrc/consolidate.cu on the card, its plain PyTorch version on the CPU).

A sweep makes one host->device copy (every padded operand packed into one
pinned buffer, but the catalog's arrays once they are resident on the card)
and one device->host copy (`_fetch` of the eager buffer: the
[C] verdict columns, the device argmax and the winner's [G, N] row). The full
[C, G, N] plan tensor stays on the card behind lazy accessors.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from karpenter_tpu_torch.device import DeviceLike, resolve_device
from karpenter_tpu_torch.ops.consolidate_kernel import (
    MIN_SAVINGS_DOLLARS,
    requested_axes,
    solve_counterfactuals,
    split_eager,
)
from karpenter_tpu_torch.ops.pack_kernel import bucket_size, device_resident, pad_to

ACTION_NONE = 0
ACTION_DELETE = 1
ACTION_REPLACE = 2

@dataclass
class ConsolidationProblem:
    """Dense inputs for one batched counterfactual solve.

    pod_vectors/pod_counts are the candidates' replaceable pods grouped by
    identical request vector (ops.encode.group_pods order: FFD-sorted desc),
    zero-padded to a common group axis. headroom is the free USABLE capacity
    of every live receiver node; bin_mask[c, j] says node j may receive
    candidate c's pods (False on the victim's own row and on ineligible
    receivers). type_capacity/type_prices densify the replacement fleet
    (build_fleet output: usable capacity, cheapest allowed offering price);
    type_valid[c, t] carries per-candidate masking (accelerator anti-waste).
    """

    pod_vectors: np.ndarray  # [C, G, R] float32
    pod_counts: np.ndarray  # [C, G] int32
    headroom: np.ndarray  # [N, R] float32
    bin_mask: np.ndarray  # [C, N] bool
    node_prices: np.ndarray  # [C] float64 — candidate's current offering $/hr
    type_capacity: np.ndarray  # [T, R] float32
    type_prices: np.ndarray  # [T] float32
    type_valid: np.ndarray  # [C, T] bool

    @property
    def num_candidates(self) -> int:
        return int(self.pod_vectors.shape[0])


@dataclass
class ConsolidationVerdicts:
    """Per-candidate scores, one row per ConsolidationProblem candidate.

    The [C, G, N] delete-plan tensor stays DEVICE-RESIDENT: the eager fetch
    carries only the [C] scalar columns plus the argmax winner's [G, N] row
    (prefetched on device — the only plan the common one-action sweep ever
    decodes). take_row lazily fetches other candidates' rows on demand;
    the delete_take property fetches the whole tensor (tests, tooling)."""

    delete_ok: np.ndarray  # [C] bool — every pod placed into headroom
    replace_type: np.ndarray  # [C] int32 — cheapest feasible type (by index)
    replace_price: np.ndarray  # [C] float — inf when no feasible type
    savings: np.ndarray  # [C] float — $/hr shed by the best action (-inf none)
    action: np.ndarray  # [C] int8 — ACTION_NONE | ACTION_DELETE | ACTION_REPLACE
    _takes: object = None  # [Cp, Gp, Np] int32 device tensor (padded)
    _shape: Tuple[int, int, int] = (0, 0, 0)  # real (C, G, N)
    _rows: Dict[int, np.ndarray] = field(default_factory=dict)
    _takes_host: Optional[np.ndarray] = None

    def best(self) -> int:
        """Index of the best cost-positive candidate, or -1."""
        if self.savings.size == 0:
            return -1
        index = int(np.argmax(self.savings))
        if self.action[index] == ACTION_NONE:
            return -1
        return index

    def take_row(self, candidate: int) -> np.ndarray:
        """One candidate's [G, N] delete plan. The device-argmax winner's
        row arrived with the eager fetch; any other row is a tiny staged
        device-side slice fetch, paid only when a sweep actually executes
        more than the best action."""
        row = self._rows.get(candidate)
        if row is None:
            _, num_groups, num_bins = self._shape
            row = np.asarray(  # vet: host-array(_fetch returns numpy)
                _fetch(self._takes[candidate])
            )[:num_groups, :num_bins]
            self._rows[candidate] = row
        return row

    @property
    def delete_take(self) -> np.ndarray:
        """The full [C, G, N] plan tensor, fetched on first use — test and
        tooling convenience, NOT the sweep hot path."""
        if self._takes_host is None:
            num_candidates, num_groups, num_bins = self._shape
            self._takes_host = np.asarray(  # vet: host-array(_fetch returns numpy)
                _fetch(self._takes)
            )[:num_candidates, :num_groups, :num_bins]
        return self._takes_host


def _fetch(tensor: torch.Tensor) -> np.ndarray:
    """THE single device->host copy of this module: the eager buffer, lazy
    plan rows and the full-tensor test convenience all route through here."""
    return tensor.cpu().numpy()


# Eager fetch payload (bytes) of the most recent solve_candidates call. Plain
# module state, written by the (single-threaded per sweep) solve path.
LAST_FETCH_BYTES = 0


def _padded(problem: ConsolidationProblem) -> Tuple:
    """Bucket-pad every axis to powers of two, as the reference does, so the
    kernel sees a small ladder of shapes. Padded candidates carry zero
    counts, padded bins a False mask, padded types a False validity column.
    The type-catalog arrays (capacity, prices: RESIDENT below) ride the
    device_resident cache at upload: back-to-back sweeps, and the provision
    solve they follow, reuse the same content without a fresh transfer."""
    c_pad = bucket_size(max(problem.num_candidates, 1))
    g_pad = bucket_size(max(int(problem.pod_vectors.shape[1]), 1))
    n_pad = bucket_size(max(int(problem.headroom.shape[0]), 1))
    t_pad = bucket_size(max(int(problem.type_capacity.shape[0]), 1))
    cand_valid = np.zeros(c_pad, dtype=bool)
    cand_valid[: problem.num_candidates] = True
    return (
        pad_to(pad_to(problem.pod_vectors.astype(np.float32), c_pad), g_pad, axis=1),
        pad_to(pad_to(problem.pod_counts.astype(np.int32), c_pad), g_pad, axis=1),
        pad_to(problem.headroom.astype(np.float32), n_pad),
        pad_to(pad_to(problem.bin_mask.astype(bool), c_pad), n_pad, axis=1),
        pad_to(problem.type_capacity.astype(np.float32), t_pad),
        pad_to(problem.type_prices.astype(np.float32), t_pad),
        pad_to(pad_to(problem.type_valid.astype(bool), c_pad), t_pad, axis=1),
        pad_to(problem.node_prices.astype(np.float32), c_pad),
        cand_valid,
    )


# Which of _padded's arrays are the catalog's, kept resident on the device.
_RESIDENT = (False, False, False, False, True, True, False, False, False)


def solve_candidates(problem: ConsolidationProblem, device: DeviceLike = None) -> ConsolidationVerdicts:
    """Score every candidate's delete and replace counterfactuals in one
    batched dispatch + one SMALL device->host fetch — the [C] scalar
    columns plus the on-device-argmax winner's [G, N] plan row; the full
    [C, G, N] plan tensor stays device-resident behind lazy accessors.
    Action selection is re-derived host-side in float64 (authoritative;
    delete preferred on ties — it sheds the whole node instead of trading
    it). Runs on the card unless `device` is "cpu"."""
    global LAST_FETCH_BYTES
    num_candidates = problem.num_candidates
    num_groups = int(problem.pod_vectors.shape[1])
    num_bins = int(problem.headroom.shape[0])
    padded = _padded(problem)
    takes_dev, eager = solve_counterfactuals(
        *device_resident(padded, _RESIDENT, resolve_device(device)),
        axes=requested_axes(padded[0]),
    )
    LAST_FETCH_BYTES = eager.numel() * eager.element_size()
    c_pad, g_pad = padded[1].shape
    n_pad = padded[2].shape[0]
    delete_ok, replace_type, replace_price, device_best, best_take = split_eager(
        _fetch(eager), c_pad, g_pad, n_pad
    )
    if device_best < 0:
        raise RuntimeError("solve_counterfactuals: the room was sized for fewer axes than a candidate requests")
    delete_ok = delete_ok[:num_candidates]
    replace_type = replace_type[:num_candidates]
    replace_price = np.asarray(  # vet: host-array(_fetch returns numpy)
        replace_price, dtype=np.float64
    )[:num_candidates]

    node_prices = problem.node_prices.astype(np.float64)
    savings_delete = np.where(delete_ok, node_prices, -np.inf)
    replace_margin = node_prices - replace_price
    savings_replace = np.where(
        np.isfinite(replace_price) & (replace_margin > MIN_SAVINGS_DOLLARS),
        replace_margin,
        -np.inf,
    )
    action = np.full(num_candidates, ACTION_NONE, dtype=np.int8)
    action[savings_replace > MIN_SAVINGS_DOLLARS] = ACTION_REPLACE
    # Delete wins ties: shedding a node beats trading it at equal savings.
    action[
        (savings_delete > MIN_SAVINGS_DOLLARS) & (savings_delete >= savings_replace)
    ] = ACTION_DELETE
    savings = np.where(
        action == ACTION_DELETE,
        savings_delete,
        np.where(action == ACTION_REPLACE, savings_replace, -np.inf),
    )
    verdicts = ConsolidationVerdicts(
        delete_ok=delete_ok,
        replace_type=replace_type,
        replace_price=replace_price,
        savings=savings,
        action=action,
        _takes=takes_dev,
        _shape=(num_candidates, num_groups, num_bins),
    )
    # Seed the row cache with the device winner's prefetched plan. The host
    # float64 scoring is authoritative: if it disagrees with the device's
    # float32 argmax (a tie at the precision boundary), take_row simply
    # fetches the right row lazily instead.
    if int(device_best) < num_candidates:
        verdicts._rows[int(device_best)] = best_take[:num_groups, :num_bins]
    return verdicts


def delete_assignment(
    verdicts: ConsolidationVerdicts, candidate: int, members: List[List]
) -> List[Tuple[object, int]]:
    """Decode one candidate's delete plan into (pod, bin index) pairs.
    `members` is the candidate's PodGroups.members (group-major, the order
    the counts were encoded in); pods are consumed group-cursor style like
    models.solver._decode_rounds."""
    plan: List[Tuple[object, int]] = []
    take = verdicts.take_row(candidate)
    for g, group_members in enumerate(members):
        cursor = 0
        for j in np.nonzero(take[g] > 0)[0]:
            n = int(take[g, j])
            for pod in group_members[cursor : cursor + n]:
                plan.append((pod, int(j)))
            cursor += n
    return plan
