"""Host-side numpy mirror of the [L, G, T] constrained pack dispatch.

A literal transcription of ops/pack_kernel._fill_one_node_constrained /
_pack_one_level / pack_kernel_levels in numpy, with identical dtypes
(float32 ratios, the same _EPS floor) and identical first-index tie-breaks,
so the two paths produce bit-identical rounds. Host solvers (GreedySolver /
NativeSolver — the default in the test harness and the sub-break-even
dispatch tier) run constrained schedules through this mirror with no device
round trip; tests/test_constraints.py property-tests mirror == kernel on
random instances, which is what lets the two be used interchangeably.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np

from karpenter_tpu_torch.ops.pack_kernel import max_rounds

_EPS = np.float32(1e-4)


class HostLevelPack(NamedTuple):
    """Mirror of ops/pack_kernel.LevelPack with host-native round lists."""

    rounds: List[Tuple[int, np.ndarray, int]]  # chosen level's (t, fill, repl)
    unschedulable: np.ndarray  # [G] int32 — chosen level's
    chosen_level: int
    group_level: np.ndarray  # [G] int32
    level_unsched: np.ndarray  # [L, G] int32
    overflow: bool


def _fill_one_node_host(capacity, vectors, counts, allow, conflict, node_cap):
    num_groups = vectors.shape[0]
    eligible = (counts > 0) & allow
    if not eligible.any():
        return np.zeros(num_groups, np.int32)
    first_eligible = int(np.argmax(eligible))
    remaining = capacity.astype(np.float32).copy()
    placed = np.zeros(num_groups, bool)
    packed = np.zeros(num_groups, np.int32)
    for g in range(num_groups):
        vec = vectors[g]
        cnt = int(counts[g])
        positive = vec > 0
        if positive.any():
            ratio = np.full(vec.shape, np.inf, np.float32)
            ratio[positive] = remaining[positive] / vec[positive]
            n_fit = int(np.floor(np.float32(ratio.min()) + _EPS))
        else:
            n_fit = np.iinfo(np.int32).max
        n_fit = max(n_fit, 0)
        conflicted = bool((placed & conflict[g]).any())
        allowed = bool(eligible[g]) and not conflicted
        n = min(cnt, n_fit, int(node_cap[g])) if allowed else 0
        if g == first_eligible and eligible[g] and not conflicted and n == 0:
            return np.zeros(num_groups, np.int32)  # abort: largest fits nowhere
        remaining -= np.float32(n) * vec
        if n > 0:
            placed[g] = True
        packed[g] = n
    return packed


def _pack_one_level_host(
    vectors, counts, capacity, valid_types, prices, allow, penalty,
    conflict, node_cap, mode: str,
):
    num_groups, num_types = vectors.shape[0], capacity.shape[0]
    mr = max_rounds(num_groups)
    fits = (vectors[:, None, :] <= capacity[None, :, :] + 1e-6).all(axis=-1)
    usable = allow & fits & valid_types[None, :]
    packable = usable.any(axis=1)
    unschedulable = np.where(packable, 0, counts).astype(np.int32)
    counts = np.where(packable, counts, 0).astype(np.int32)

    largest_valid = num_types - 1 - int(np.argmax(valid_types[::-1]))
    ref_cap = np.maximum(capacity[largest_valid], np.float32(1.0))
    group_weight = (vectors / ref_cap).max(axis=1)

    rounds: List[Tuple[int, np.ndarray, int]] = []
    packed_rounds = 0  # counts past mr too — overflow parity with the kernel
    iters = 0
    while counts.sum() > 0 and iters < mr + num_groups:
        iters += 1
        fills = np.stack(
            [
                _fill_one_node_host(
                    capacity[t], vectors, counts, usable[:, t], conflict, node_cap
                )
                if valid_types[t]
                else np.zeros(num_groups, np.int32)
                for t in range(num_types)
            ]
        )  # [T, G]
        sums = fills.sum(axis=1)
        packs_any = (sums > 0) & valid_types
        if mode == "ffd":
            bound = int(sums.max()) if num_types else 0
            achieves = (sums == bound) & valid_types & (bound > 0)
            t_sel = int(np.argmax(achieves))
            have_pack = bound > 0
        elif mode == "cost":
            weighted = fills.astype(np.float32) @ group_weight
            pen = (fills.astype(np.float32) * penalty.T).sum(axis=1)
            score = np.where(
                packs_any,
                (prices + pen) / np.maximum(weighted, np.float32(1e-9)),
                np.inf,
            )
            t_sel = int(np.argmin(score))
            have_pack = bool(packs_any.any())
        else:
            raise ValueError(f"unknown mode {mode!r}")
        if not have_pack:
            first_active = int(np.argmax(counts > 0))
            unschedulable[first_active] += counts[first_active]
            counts[first_active] = 0
            continue
        fill = fills[t_sel]
        safe = counts // np.maximum(fill, 1)
        repl_per_group = np.where(fill > 0, safe, np.iinfo(np.int32).max)
        repl = max(int(repl_per_group.min()), 1)
        counts = counts - repl * fill
        packed_rounds += 1
        if len(rounds) < mr:
            rounds.append((t_sel, fill.astype(np.int32), repl))
    # Overflow exactly as the kernel flags it: residual demand OR more
    # packed rounds than the static budget (the kernel's OOB scatter drops
    # the excess round; a silently-truncated plan must never decode as
    # complete, and the level-selection totals must agree bit-for-bit).
    return rounds, unschedulable, bool(counts.sum() > 0 or packed_rounds > mr)


def pack_levels_host(
    vectors,  # [G, R] f32
    level_counts,  # [L, G] i32
    capacity,  # [T, R] f32
    valid_types,  # [T] bool
    prices,  # [T] f32
    level_allow,  # [L, G, T] bool
    level_penalty,  # [L, G, T] f32
    conflict,  # [G, G] bool
    node_cap,  # [G] i32
    mode: str = "cost",
) -> HostLevelPack:
    """Host twin of pack_kernel_levels: identical level solve + strictest-
    feasible selection, returning the chosen level's rounds directly."""
    vectors = np.asarray(vectors, np.float32)
    capacity = np.asarray(capacity, np.float32)
    prices = np.asarray(prices, np.float32)
    num_levels, num_groups = level_counts.shape
    per_level = [
        _pack_one_level_host(
            vectors,
            level_counts[l],
            capacity,
            np.asarray(valid_types, bool),
            prices,
            np.asarray(level_allow[l], bool),
            np.asarray(level_penalty[l], np.float32),
            np.asarray(conflict, bool),
            np.asarray(node_cap, np.int32),
            mode,
        )
        for l in range(num_levels)
    ]
    level_unsched = np.stack([u for _, u, _ in per_level])  # [L, G]
    overflow = np.array([o for _, _, o in per_level], bool)
    # Miss count = unschedulable + assignment shortfall vs the fullest
    # level (see pack_kernel_levels — identical selection metric).
    assigned = level_counts.sum(axis=1)
    shortfall = assigned.max() - assigned
    totals = (
        level_unsched.sum(axis=1) + shortfall + overflow.astype(np.int64) * (2**30)
    )
    chosen = int(np.argmin(totals))
    feasible = (level_unsched == 0) & ~overflow[:, None]
    group_level = np.where(
        feasible.any(axis=0), np.argmax(feasible, axis=0), num_levels
    ).astype(np.int32)
    rounds, unschedulable, _ = per_level[chosen]
    return HostLevelPack(
        rounds=rounds,
        unschedulable=unschedulable,
        chosen_level=chosen,
        group_level=group_level,
        level_unsched=level_unsched,
        overflow=bool(overflow[chosen]),
    )
