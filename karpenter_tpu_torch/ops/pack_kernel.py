"""K2, the batched bin-packing round loop, and the plan compaction around it.

The port of karpenter_tpu/ops/pack_kernel.py. The reference reformulates the
sequential FFD loop (ref: pkg/controllers/provisioning/binpacking/
packer.go:82-189) as static-shape tensor rounds:

  * pods are pre-collapsed into G groups of identical request vectors
    (ops.encode.group_pods); G is small (tens) even for 50k-pod batches.
  * one *round* fills a candidate node of every instance type at once — a
    sequential scan over groups for each of the T types.
  * the chosen node fill is **replicated** k = min_{g: p_g>0} floor(c_g / p_g)
    times in one step, which is exact for greedy FFD.
  * rounds run until every pod is placed or set aside, into preallocated
    [MR] output buffers.

Two selection modes:
  * mode="ffd": the largest type sets the max-pods bound, the smallest type
    achieving it wins; quirk=True reproduces the reference's fits()
    early-exit quirk (packable.go:147-157).
  * mode="cost": each round picks the type minimizing $/(weighted work).

The round loop is data-dependent, so on the card it is one hand-written
kernel (csrc/pack_rounds.cu) that runs the whole loop with no host sync, both
modes in one launch (`pack_kernel_pair`), one type per thread as
`pack_launch_plan` lays it out, and quirk=True (the Go-parity solver's
mode) is a compile-time variant of the same kernel. `_pack_kernel_ref` is its
plain PyTorch version, which tests the loop condition on the host every
round. A CPU tensor goes to the plain version, a CUDA tensor to the kernel.

The fused solve's tail rides the same launch (`pack_pair_payload`): the
kernel's epilogue writes feasible_any, the LP's counts, the dense spill and
K4, the plan compaction (csrc/compact_rounds.cuh), whose plain version is
`_compact_plan_ref` (`compact_plan` on the CPU). No kernel of the solve runs
after it but the LP's.

K6, `pack_kernel_levels`, is the constrained solve's [L, G', T] dispatch:
the same round loop under per-level allow masks, penalties, conflicts and
per-node caps for every relaxation level at once, then the strictest level
with the fewest misses (csrc/pack_levels.cu; `_pack_levels_ref` is its plain
version, vectorised over levels and types with a loop over groups).

All shapes are padded: G -> groups (counts 0), T -> types (valid mask).
"""

from __future__ import annotations

import ctypes
import math
import threading
from collections import OrderedDict
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from karpenter_tpu_torch.convert import upload_packed
from karpenter_tpu_torch.ops.cuda_build import CudaLibrary, check_launch, launch_stream

_EPS = 1e-4
_INT32_MAX = 2**31 - 1
# n_fit is clamped before its int32 conversion (the reference's conversion
# saturates an all-zero vector's +inf); any bound above every real count
# gives the same min(count, n_fit).
_FIT_CLAMP = float(2**30)
MAX_DIMS = 8  # remaining-capacity registers per thread in the kernel
_MODES = ("ffd", "cost")

LIBRARY = CudaLibrary(
    "pack_rounds.cu",
    {
        "ktt_pack_rounds_words": (ctypes.c_int, [ctypes.c_int]),
        "ktt_pack_rounds_payload_words": (ctypes.c_int, [ctypes.c_int]),
        "ktt_pack_rounds_shared_bytes": (ctypes.c_longlong, [ctypes.c_int] * 5),
        "ktt_pack_rounds_table_words": (ctypes.c_longlong, [ctypes.c_int] * 3),
        "ktt_pack_rounds": (
            ctypes.c_int,
            [ctypes.c_void_p] * 6
            + [ctypes.c_int] * 8
            + [ctypes.c_void_p] * 7,
        ),
    },
)
LEVELS_LIBRARY = CudaLibrary(
    "pack_levels.cu",
    {
        "ktt_pack_levels_words": (ctypes.c_int, [ctypes.c_int]),
        "ktt_pack_levels_shared_bytes": (ctypes.c_longlong, [ctypes.c_int] * 5),
        "ktt_pack_levels_table_words": (ctypes.c_longlong, [ctypes.c_int] * 3),
        "ktt_pack_levels_fill_words": (ctypes.c_longlong, [ctypes.c_int] * 2),
        "ktt_pack_levels": (
            ctypes.c_int,
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p] * 6,
        ),
    },
)
COMPACT_SHARD_LIBRARY = CudaLibrary(
    "compact_shard.cu",
    {
        "ktt_compact_sharded_payload": (
            ctypes.c_int,
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2,
        ),
        "ktt_compact_shards": (
            ctypes.c_int,
            [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3,
        ),
    },
)
# Shared memory a block may use on sm_90 (227 KB), threads a block may
# have, and the types a thread may keep in registers (more are streamed
# from global memory every round).
SHARED_LIMIT = 232_448
MAX_THREADS = 1024
_TYPES_PER_THREAD = (1, 2, 4)
# csrc/pack_rounds.cu's Control words at the front of shared memory.
_CONTROL_BYTES = 32


class PackLaunchPlan(NamedTuple):
    """How K2 lays one mode's round loop over a block."""

    threads: int  # a multiple of 32
    types_per_thread: int  # thread i owns types i + k * threads, k < this
    shared_bytes: int  # dynamic shared memory per block
    fills_in_shared: bool  # else [modes, G, T] int32 of global scratch
    tables_in_shared: bool  # else [modes, table words] int32 of global scratch

    def owner(self, t: int) -> int:
        """The thread that owns type t."""
        return t % self.threads


def pack_table_words(groups: int, types: int, dims: int) -> int:
    """Words of one block's tables (csrc/pack_rounds.cu table_words): [G, R]
    vectors, [G] weights, axis masks and counts, and the [T] sums."""
    return groups * dims + 3 * groups + types


def _shared_storage(tables: int, fills: int) -> Tuple[int, bool, bool]:
    """(shared bytes, fills in shared, tables in shared) of a block of K2 or
    K6: the tables in shared memory when they fit beside the control words,
    the [G, T] fills when they fit beside both; the rest in global scratch."""
    tables_in_shared = _CONTROL_BYTES + tables <= SHARED_LIMIT
    fills_in_shared = tables_in_shared and _CONTROL_BYTES + tables + fills <= SHARED_LIMIT
    shared = (_CONTROL_BYTES + (tables if tables_in_shared else 0)
              + (fills if fills_in_shared else 0))
    return shared, fills_in_shared, tables_in_shared


def pack_launch_plan(groups: int, types: int, dims: int) -> PackLaunchPlan:
    """K2's launch plan, from the sizes alone: one type per thread while T
    fits one block (1,024 threads), else 2 or 4 kept in registers, past
    T 4,096 ceil(T / 1,024) streamed; the [G, T] fills in shared memory when
    the block's tables and fills fit SHARED_LIMIT, else in global scratch,
    and the tables too in global scratch when they alone do not fit. Every
    size gets a plan."""
    per_thread = next(
        (k for k in _TYPES_PER_THREAD if -(-types // k) <= MAX_THREADS), -(-types // MAX_THREADS)
    )
    threads = (-(-types // per_thread) + 31) & ~31
    storage = _shared_storage(4 * pack_table_words(groups, types, dims), 4 * groups * types)
    return PackLaunchPlan(threads, per_thread, *storage)


class PackRounds(NamedTuple):
    """Kernel output: up to MR rounds of (type, per-group fill, replication),
    every field int32 as in the reference's dense layout."""

    round_type: torch.Tensor  # [MR] int32 — chosen instance-type index
    round_fill: torch.Tensor  # [MR, G] int32 — pods of each group per node
    round_repl: torch.Tensor  # [MR] int32 — identical nodes this round
    num_rounds: torch.Tensor  # [] int32
    unschedulable: torch.Tensor  # [G] int32 — pods set aside per group
    overflow: torch.Tensor  # [] int32 — round budget exhausted (never expected)


def max_rounds(num_groups: int) -> int:
    # Every two rounds exhaust at least one group (replication drops the
    # binding group below its fill), so 2G+8 is a safe static budget.
    return 2 * num_groups + 8


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """jnp.argmax over a bool vector: the first True index, 0 if none."""
    return torch.argmax(mask.to(torch.int32))


def _fill_one_node(capacity, total, vectors, counts, *, quirk: bool):
    """Greedy-fill one node of every type at once. Returns [T, G] int32 packed
    counts per group.

    Mirrors packable.go:113-132 as the reference's _fill_one_node does:
    groups scanned largest→smallest; a first active group that can't place
    one pod aborts the whole fill; with quirk=True, a failed placement stops
    the scan early once remaining capacity falls to/below the smallest active
    pod on any tracked dimension."""
    num_groups = vectors.shape[0]
    num_types = capacity.shape[0]
    active = counts > 0
    any_active = bool(active.any())
    first_active = int(_first_true(active))
    last_active = num_groups - 1 - int(_first_true(active.flip(0)))
    smallest = vectors[last_active]
    device = capacity.device

    remaining = capacity
    stopped = torch.zeros(num_types, dtype=torch.bool, device=device)
    abort = torch.zeros(num_types, dtype=torch.bool, device=device)
    packed = torch.zeros((num_types, num_groups), dtype=torch.int32, device=device)
    # A group without pods places none and changes nothing: only the groups
    # with pods are scanned.
    for g in torch.nonzero(active).flatten().tolist():
        vec = vectors[g]
        cnt = counts[g]
        positive = vec > 0
        ratio = torch.where(
            positive, remaining / torch.where(positive, vec, 1.0), torch.inf
        )
        n_fit = torch.floor(ratio.amin(dim=1) + _EPS)
        n_fit = torch.clamp(n_fit, 0.0, _FIT_CLAMP).to(torch.int32)
        allowed = (cnt > 0) & ~stopped & ~abort
        n = torch.where(allowed, torch.minimum(cnt, n_fit), 0).to(torch.int32)
        if g == first_active:
            abort = abort | ((cnt > 0) & (n == 0))
        # Two rounded fp32 operations, never a fused multiply-add.
        remaining = remaining - n.to(vectors.dtype)[:, None] * vec
        failed = allowed & (n < cnt)
        if quirk:
            essentially_full = ((total > 0) & (remaining <= smallest + _EPS)).any(dim=1)
            stopped = stopped | (failed & essentially_full)
        packed[:, g] = n
    if not any_active:
        return torch.zeros_like(packed)
    return torch.where(abort[:, None], 0, packed)


def _pack_kernel_ref(
    vectors, counts, capacity, total, valid_types, prices, *,
    quirk: bool = False, mode: str = "ffd",
) -> PackRounds:
    """Plain version of the round loop, on any device: the same arithmetic as
    the kernel, with the loop condition tested on the host each round."""
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}")
    num_groups = vectors.shape[0]
    num_types = capacity.shape[0]
    mr = max_rounds(num_groups)
    device = vectors.device

    largest_valid = num_types - 1 - int(_first_true(valid_types.flip(0)))
    ref_cap = torch.clamp(capacity[largest_valid], min=1.0)
    group_weight = (vectors / ref_cap).amax(dim=1)  # [G]

    counts = counts.to(torch.int32).clone()
    round_type = torch.zeros(mr, dtype=torch.int32, device=device)
    round_fill = torch.zeros((mr, num_groups), dtype=torch.int32, device=device)
    round_repl = torch.zeros(mr, dtype=torch.int32, device=device)
    unschedulable = torch.zeros(num_groups, dtype=torch.int32, device=device)
    num_rounds = 0
    iters = 0
    while int(counts.sum()) > 0 and iters < mr + num_groups:
        fills = _fill_one_node(capacity, total, vectors, counts, quirk=quirk)
        fills = torch.where(valid_types[:, None], fills, 0)
        sums = fills.sum(dim=1)
        packs_any = (sums > 0) & valid_types

        if mode == "ffd":
            bound = sums[largest_valid]
            achieves = (sums == bound) & valid_types & (bound > 0)
            t_sel = int(_first_true(achieves))  # first (smallest) achieving type
            have_pack = bool(bound > 0)
        else:
            weighted = _weighted_sums(fills.to(torch.float32), group_weight)
            score = torch.where(
                packs_any, prices / torch.clamp(weighted, min=1e-9), torch.inf
            )
            t_sel = int(torch.argmin(score))
            have_pack = bool(packs_any.any())

        fill = fills[t_sel]  # [G]
        if quirk:
            # A partially-packed group only replicates while its count stays
            # strictly above its fill (see the reference for the derivation).
            safe = torch.where(
                fill == counts,
                1,
                torch.clamp(
                    torch.div(counts - 1, torch.clamp(fill, min=1), rounding_mode="floor"),
                    min=1,
                ),
            )
        else:
            safe = torch.div(counts, torch.clamp(fill, min=1), rounding_mode="floor")
        repl_per_group = torch.where(fill > 0, safe, _INT32_MAX)
        repl = max(int(repl_per_group.min()), 1)

        if have_pack:
            # An out-of-range write is dropped, as the reference's scatter
            # drops it; overflow reports the lost round.
            if num_rounds < mr:
                round_type[num_rounds] = t_sel
                round_fill[num_rounds] = fill
                round_repl[num_rounds] = repl
            counts = counts - repl * fill
            num_rounds += 1
        else:
            # Retire the first group with pods remaining (ref:
            # packer.go:120-124; identical pods fail identically).
            first_active = int(_first_true(counts > 0))
            unschedulable[first_active] += counts[first_active]
            counts[first_active] = 0
        iters += 1

    overflow = int(counts.sum()) > 0 or num_rounds > mr
    return PackRounds(
        round_type=round_type,
        round_fill=round_fill,
        round_repl=round_repl,
        num_rounds=torch.tensor(min(num_rounds, mr), dtype=torch.int32, device=device),
        unschedulable=unschedulable,
        overflow=torch.tensor(int(overflow), dtype=torch.int32, device=device),
    )


def _check_args(vectors, counts, capacity, total, valid_types, prices) -> None:
    tensors = (vectors, counts, capacity, total, valid_types, prices)
    dtypes = (torch.float32, torch.int32, torch.float32, torch.float32, torch.bool, torch.float32)
    for name, tensor, dtype in zip(
        ("vectors", "counts", "capacity", "total", "valid_types", "prices"), tensors, dtypes
    ):
        if tensor.dtype != dtype:
            raise TypeError(f"pack_kernel: {name} must be {dtype}, got {tensor.dtype}")
        if tensor.device != vectors.device:
            raise ValueError("pack_kernel: every argument must lie on one device")
    num_groups, dims = vectors.shape
    num_types = capacity.shape[0]
    if (
        counts.shape != (num_groups,)
        or capacity.shape != (num_types, dims)
        or total.shape != (num_types, dims)
        or valid_types.shape != (num_types,)
        or prices.shape != (num_types,)
    ):
        raise ValueError("pack_kernel: inconsistent shapes")


def _launch(vectors, counts, capacity, total, valid_types, prices, first_mode: int,
            num_modes: int, quirk: bool = False, *, epilogue: bool = False,
            payload: bool = False):
    """One launch of the round-loop kernel: block b runs mode first_mode + b,
    with the fits() early exit when quirk. Returns (out, feasible_any,
    solvable, payload): out is [num_modes * words] int32 in the reference's
    dense layout; with the epilogue (both modes) G words more, feasible_any
    as int32, and the [G] feasible_any and solvable, else None; the
    compacted payload when asked for, else None."""
    num_groups, dims = vectors.shape
    num_types = capacity.shape[0]
    if num_groups == 0 or num_types == 0 or dims == 0:
        raise ValueError("pack_kernel kernel takes G, T, R >= 1")
    if dims > MAX_DIMS:
        raise ValueError(f"pack_kernel kernel takes at most {MAX_DIMS} axes")
    tensors = (vectors, counts, capacity, total, valid_types, prices)
    if not all(tensor.is_contiguous() for tensor in tensors):
        raise ValueError("pack_kernel kernel takes contiguous tensors")
    plan = pack_launch_plan(num_groups, num_types, dims)
    lib = LIBRARY.load()
    words = lib.ktt_pack_rounds_words(num_groups)
    device = vectors.device
    out = torch.empty(num_modes * words + (num_groups if epilogue else 0), dtype=torch.int32,
                      device=device)
    feasible = solvable = compacted = None
    if epilogue:
        feasible = torch.empty(num_groups, dtype=torch.bool, device=device)
        solvable = torch.empty(num_groups, dtype=torch.int32, device=device)
        if payload:
            compacted = torch.empty(compact_words(num_groups), dtype=torch.int32, device=device)
    scratch = tables = None
    if not plan.fills_in_shared:
        scratch = torch.empty(
            (num_modes, num_groups, num_types), dtype=torch.int32, device=vectors.device
        )
    if not plan.tables_in_shared:
        tables = torch.empty(
            (num_modes, pack_table_words(num_groups, num_types, dims)),
            dtype=torch.int32, device=vectors.device,
        )
    optional = (scratch, tables, feasible, solvable, compacted)
    outputs = [out] + [t for t in optional if t is not None]
    with launch_stream("pack_kernel", tensors + tuple(outputs)) as stream:
        status = lib.ktt_pack_rounds(
            *(tensor.data_ptr() for tensor in tensors),
            num_groups, num_types, dims, first_mode, num_modes,
            plan.threads, plan.types_per_thread, int(quirk), out.data_ptr(),
            *(0 if t is None else t.data_ptr() for t in optional), stream,
        )
    check_launch(status, "pack_kernel")
    pack_kernel.launches += 1
    if quirk:
        pack_kernel.quirk_launches += 1
    if epilogue:
        pack_pair_payload.launches += 1
    return out, feasible, solvable, compacted


def rounds_from_words(words: torch.Tensor, num_groups: int) -> PackRounds:
    """Views of one mode's [words] int32 output as PackRounds."""
    mr = max_rounds(num_groups)
    cursor = 0

    def take(n):
        nonlocal cursor
        out = words[cursor : cursor + n]
        cursor += n
        return out

    return PackRounds(
        round_type=take(mr),
        round_fill=take(mr * num_groups).view(mr, num_groups),
        round_repl=take(mr),
        num_rounds=take(1).view(()),
        unschedulable=take(num_groups),
        overflow=take(1).view(()),
    )


def pack_kernel(
    vectors,  # [G, R] f32 — group request vectors, FFD-sorted desc
    counts,  # [G] i32 — pods per group
    capacity,  # [T, R] f32 — usable capacity per type (asc-sorted fleet)
    total,  # [T, R] f32 — raw capacity per type (for the quirk check)
    valid_types,  # [T] bool — padding mask
    prices,  # [T] f32 — $/hr per type (cost mode)
    *,
    quirk: bool = False,
    mode: str = "ffd",
) -> PackRounds:
    """One mode's rounds: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    _check_args(vectors, counts, capacity, total, valid_types, prices)
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if vectors.device.type == "cpu":
        return _pack_kernel_ref(
            vectors, counts, capacity, total, valid_types, prices, quirk=quirk, mode=mode
        )
    if vectors.device.type != "cuda":
        raise ValueError(f"pack_kernel: unsupported device {vectors.device}")
    out = _launch(
        vectors, counts, capacity, total, valid_types, prices, _MODES.index(mode), 1, quirk
    )[0]
    return rounds_from_words(out, vectors.shape[0])


pack_kernel.launches = 0
pack_kernel.quirk_launches = 0  # of them, the quirk's (K2q)


def pack_kernel_pair(
    vectors, counts, capacity, total, valid_types, prices
) -> Tuple[PackRounds, PackRounds]:
    """(ffd rounds, cost rounds) with quirk=False — on the card one launch of
    two blocks, one per mode."""
    _check_args(vectors, counts, capacity, total, valid_types, prices)
    if vectors.device.type == "cpu":
        return tuple(
            _pack_kernel_ref(
                vectors, counts, capacity, total, valid_types, prices, quirk=False, mode=mode
            )
            for mode in _MODES
        )
    if vectors.device.type != "cuda":
        raise ValueError(f"pack_kernel: unsupported device {vectors.device}")
    out = _launch(vectors, counts, capacity, total, valid_types, prices, 0, 2)[0]
    return _pair_from_words(out, vectors.shape[0])


def _pair_from_words(out: torch.Tensor, num_groups: int) -> Tuple[PackRounds, PackRounds]:
    """Views of both modes' rounds at the front of a pair launch's output."""
    words = rounds_words(num_groups)
    return (rounds_from_words(out[:words], num_groups),
            rounds_from_words(out[words : 2 * words], num_groups))


class PairPayload(NamedTuple):
    """Everything the fused solve takes from K2's pair launch."""

    rounds_ffd: PackRounds
    rounds_cost: PackRounds
    feasible_any: torch.Tensor  # [G] bool — some valid type fits one pod of g
    solvable: torch.Tensor  # [G] int32 — counts where feasible_any, else 0 (the LP's)
    dense: torch.Tensor  # [2 * rounds_words(G) + G] int32 — the dense spill
    payload: Optional[torch.Tensor]  # [compact_words(G)] int32 — K4's payload, or None


def _rounds_ints(rounds: PackRounds) -> List[torch.Tensor]:
    """One PackRounds' int32 words in the dense spill's order."""
    return [
        rounds.round_type.reshape(-1),
        rounds.round_fill.reshape(-1),
        rounds.round_repl.reshape(-1),
        rounds.num_rounds.reshape(1),
        rounds.unschedulable.reshape(-1),
        rounds.overflow.to(torch.int32).reshape(1),
    ]


def _pack_pair_payload_ref(vectors, counts, capacity, total, valid_types, prices,
                           payload: bool) -> PairPayload:
    """Plain version of pack_pair_payload, on any device: both modes'
    rounds, then the reference's tail of the fused solve, one operation at
    a time."""
    from karpenter_tpu_torch.ops.score_kernel import feasibility_mask

    rounds = tuple(
        _pack_kernel_ref(vectors, counts, capacity, total, valid_types, prices, quirk=False, mode=mode)
        for mode in _MODES
    )
    feasible_any = feasibility_mask(vectors, capacity, valid_types).any(dim=1)
    solvable = torch.where(feasible_any, counts, 0)
    dense = torch.cat(
        _rounds_ints(rounds[0]) + _rounds_ints(rounds[1]) + [feasible_any.to(torch.int32).reshape(-1)]
    )
    compacted = _compact_plan_ref(*rounds, feasible_any) if payload else None
    return PairPayload(*rounds, feasible_any, solvable, dense, compacted)


def pack_pair_payload(vectors, counts, capacity, total, valid_types, prices, *,
                      payload: bool = True) -> PairPayload:
    """Both modes' rounds (quirk=False) and the fused solve's tail:
    feasible_any, the LP's solvable counts, the dense spill and, unless
    payload=False, K4's compacted payload. On the card ONE launch of K2 with
    its epilogue (the rounds are views into the dense spill); it counts on
    pack_kernel.launches and on pack_pair_payload.launches. The plain
    version for CPU tensors."""
    _check_args(vectors, counts, capacity, total, valid_types, prices)
    if vectors.device.type == "cpu":
        return _pack_pair_payload_ref(vectors, counts, capacity, total, valid_types, prices, payload)
    if vectors.device.type != "cuda":
        raise ValueError(f"pack_pair_payload: unsupported device {vectors.device}")
    dense, feasible_any, solvable, compacted = _launch(
        vectors, counts, capacity, total, valid_types, prices, 0, 2, epilogue=True, payload=payload
    )
    return PairPayload(*_pair_from_words(dense, vectors.shape[0]), feasible_any, solvable, dense,
                       compacted)


# K2 launches with the epilogue (each is one of pack_kernel.launches too).
pack_pair_payload.launches = 0


# --- K6: the constrained multi-level pack, the [L, G', T] dispatch -----------
#
# The constraint compiler (constraints/compiler.py) lowers pod affinity and
# anti-affinity, topology spread and the preference-relaxation ladder into
# per-level tensors; this dispatch solves every relaxation level at once and
# picks the strictest feasible level on the device. Per level l:
#   * allow[l, g, t]   — sub-group g may be packed onto type t at this level
#                        (fit is re-checked here);
#   * penalty[l, g, t] — additive spread pressure in the cost-mode score;
#   * counts[l, g]     — pods per sub-group at this level;
#   * conflict[g, h]   — g and h may not share a node;
#   * node_cap[g]      — at most this many pods of g a node.

NODE_CAP_NONE = 2**30  # int32-safe "no per-node cap" sentinel
MAX_LEVELS = 8  # constraints.ladder.MAX_LEVELS: K6 runs one cluster a level
# XLA's reduce-window size on the CPU: the reference sums pen past 32 groups
# in windows of 32.
_SUM_WINDOW = 32
# XLA's vectorised dot on the CPU: 8 lanes by 4 accumulators, 32 groups a
# step, except over 8 rows or fewer (see _weighted_sums).
_DOT_LANES = 8
_DOT_STEP = 32
_NARROW_ROWS = 8
_UNROLLED_GROUPS = 256


class LevelPack(NamedTuple):
    """Output of the [L, G, T] constrained dispatch: the chosen level's
    rounds plus the level-selection evidence."""

    rounds: PackRounds  # the chosen level's rounds (fields as PackRounds)
    chosen_level: torch.Tensor  # [] int32 — strictest feasible level index
    group_level: torch.Tensor  # [G] int32 — first feasible level per group (L if none)
    level_unsched: torch.Tensor  # [L, G] int32 — unschedulable per level


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c with one rounding, as a fused multiply-add gives it.

    The product of two float32 values is exact in float64; the sum is taken
    in float64 and rounded to odd (an inexact sum whose last bit is even
    moves one float64 step toward the exact value), which makes the final
    rounding to float32 the correct one."""
    product = a.double() * b.double()
    addend = c.double()
    total = product + addend
    back = total - product
    error = (product - (total - back)) + (addend - back)
    even = (total.view(torch.int64) & 1) == 0
    toward = torch.where(error > 0, torch.inf, -torch.inf).to(torch.float64)
    total = torch.where((error != 0) & even, torch.nextafter(total, toward), total)
    return total.float()


def _penalty_sums(fills: torch.Tensor, penalty: torch.Tensor) -> torch.Tensor:
    """pen = sum_g fill * penalty over the last axis, in the order the
    reference's XLA program on the CPU takes it: up to 32 groups a chain of
    fused multiply-adds over ascending g; past 32 the rounded products in
    windows of 32 consecutive groups, the window sums again in windows of 32
    while more than 32 remain, then in order. A group that packs nothing
    anywhere adds exact zeros and is skipped."""
    num_groups = fills.shape[-1]
    zero = torch.zeros(fills.shape[:-1], dtype=torch.float32, device=fills.device)
    live = torch.nonzero(fills.reshape(-1, num_groups).any(dim=0)).flatten().tolist()
    if num_groups <= _SUM_WINDOW:
        total = zero
        for g in live:
            total = _fma32(fills[..., g], penalty[..., g], total)
        return total
    level = {g: fills[..., g] * penalty[..., g] for g in live}
    size = num_groups
    while size > _SUM_WINDOW:
        windows = {}
        for position in sorted(level):
            window = position // _SUM_WINDOW
            windows[window] = windows.get(window, zero) + level[position]
        level = windows
        size = -(-size // _SUM_WINDOW)
    total = zero
    for position in sorted(level):
        total = total + level[position]
    return total


def _dot_plan(rows: int, num_groups: int) -> Tuple[int, int, bool]:
    """(accumulators, steps, unrolled) of XLA's vectorised dot on the CPU
    over `rows` rows of `num_groups` groups (see _weighted_sums). A step is
    8 lanes by `accumulators` chunks of 8 groups; the groups past the last
    step are a chain of fused multiply-adds."""
    if num_groups < 2 * _DOT_STEP:
        return 4, 0, True
    if rows > _NARROW_ROWS:
        steps = num_groups // _DOT_STEP
        return 4, steps, steps < 4
    if rows == 1:
        return 4, num_groups // _DOT_STEP, num_groups <= _UNROLLED_GROUPS
    # 2..8 rows read the fills with a stride: the vectorised loop keeps its
    # last step for a scalar epilogue.
    accumulators = 2 if num_groups <= 2 * _DOT_STEP else 4
    steps = num_groups // (_DOT_LANES * accumulators) - 1
    return accumulators, steps, num_groups <= _UNROLLED_GROUPS


def _weighted_sums(fills: torch.Tensor, group_weight: torch.Tensor) -> torch.Tensor:
    """weighted = fills @ group_weight over the last axis, in the order the
    reference's XLA program on the CPU takes it. XLA emits the dot as a
    loop whose sum it marks reassociable, and LLVM vectorises that loop
    over the groups, 8 lanes by A accumulators (chunks of 8 groups), every
    multiply-add fused. `_dot_plan` gives A, the number of whole steps and
    whether LLVM unrolled them, from the rows (types, or levels x types)
    and the groups:
      * under 64 groups: one chain of fused multiply-adds over ascending g;
      * unrolled (9 rows or more: 64 groups; 8 rows or fewer: up to 256):
        each lane one chain over the chunks: accumulator 0's over the steps
        in order, then each later accumulator's over the steps 1, 0, 2,
        3, ...; then the lanes summed pairwise;
      * a loop (past those): per lane, accumulator u chains the chunks of
        its steps in order; the A chains are added, then the 8 lanes summed
        pairwise ((l0 + l4) + (l2 + l6)) + ((l1 + l5) + (l3 + l7));
      * groups past the last whole step: a chain of fused multiply-adds. One
        row reads the fills in order and uses every step. From 2 to 8 rows
        it reads them with a stride and keeps the last step for the chain,
        with 2 accumulators at 64 groups and 4 past it.
    Read from XLA's LLVM IR and object code, and held to the reference on
    the padded group counts the port dispatches (powers of two from 8) at
    1, 2, 4 and 8 rows and at 16 and 64; other counts follow the same rules
    untested. A chunk that packs nothing adds exact zeros and is skipped."""
    num_groups = fills.shape[-1]
    lead = fills.shape[:-1]
    rows = math.prod(lead)
    accumulators, steps, unrolled = _dot_plan(rows, num_groups)
    step = _DOT_LANES * accumulators
    total = torch.zeros(lead, dtype=torch.float32, device=fills.device)
    if steps:
        body = fills[..., : steps * step].reshape(*lead, steps, accumulators, _DOT_LANES)
        weight = group_weight[: steps * step].reshape(steps, accumulators, _DOT_LANES)
        live = body.reshape(-1, steps, accumulators, _DOT_LANES).any(dim=(0, 3)).tolist()
        zero = torch.zeros((*lead, _DOT_LANES), dtype=torch.float32, device=fills.device)

        def chain(acc, chunks):
            for i, u in chunks:
                if live[i][u]:
                    acc = _fma32(body[..., i, u, :], weight[i, u].expand_as(acc), acc)
            return acc

        if unrolled:
            later = [1, 0, *range(2, steps)] if steps >= 2 else [0]
            order = [(i, 0) for i in range(steps)]
            order += [(i, u) for u in range(1, accumulators) for i in later]
            lanes = chain(zero, order)
        else:
            lanes = chain(zero, [(i, 0) for i in range(steps)])
            for u in range(1, accumulators):
                lanes = chain(zero, [(i, u) for i in range(steps)]) + lanes
        half = lanes[..., :4] + lanes[..., 4:]
        quarter = half[..., :2] + half[..., 2:]
        total = quarter[..., 0] + quarter[..., 1]
    start = steps * step
    rest = fills[..., start:].reshape(-1, num_groups - start) if num_groups > start else fills[..., :0]
    for g in (torch.nonzero(rest.any(dim=0)).flatten() + start).tolist():
        total = _fma32(fills[..., g], group_weight[g].expand_as(total), total)
    return total


def _fill_one_node_constrained(capacity, vectors, counts, usable, conflict, node_cap):
    """Greedy-fill one node of every (level, type) at once under the masks.
    counts [L, G] int32, usable [L, G, T] bool; returns [L, T, G] int32.

    The largest-first scan of _fill_one_node (quirk-free), plus: groups that
    are not usable are skipped without aborting the fill; a group that
    conflicts with one already placed on this node is skipped; node caps
    bound the fill. The fill aborts only when the first eligible group
    (counts > 0, usable) places no pod."""
    num_levels, num_groups = counts.shape
    num_types, dims = capacity.shape
    device = capacity.device
    eligible = (counts[:, :, None] > 0) & usable  # [L, G, T]
    any_eligible = eligible.any(dim=1)  # [L, T]
    first_eligible = torch.argmax(eligible.to(torch.int32), dim=1)  # [L, T]
    remaining = capacity.expand(num_levels, num_types, dims)
    placed = torch.zeros((num_levels, num_types, num_groups), dtype=torch.bool, device=device)
    abort = torch.zeros((num_levels, num_types), dtype=torch.bool, device=device)
    packed = torch.zeros((num_levels, num_types, num_groups), dtype=torch.int32, device=device)
    # A group that no level can place changes nothing: only the groups some
    # level has pods of are scanned.
    for g in torch.nonzero((counts > 0).any(dim=0)).flatten().tolist():
        vec = vectors[g]
        positive = vec > 0
        ratio = torch.where(positive, remaining / torch.where(positive, vec, 1.0), torch.inf)
        n_fit = torch.floor(ratio.amin(dim=-1) + _EPS)
        n_fit = torch.clamp(n_fit, 0.0, _FIT_CLAMP).to(torch.int32)
        conflicted = (placed & conflict[g]).any(dim=-1)
        allowed = eligible[:, g, :] & ~conflicted & ~abort
        n = torch.minimum(torch.minimum(counts[:, g, None], n_fit), node_cap[g])
        n = torch.where(allowed, n, 0).to(torch.int32)
        abort = abort | ((first_eligible == g) & eligible[:, g, :] & ~conflicted & (n == 0))
        # Two rounded fp32 operations, never a fused multiply-add.
        remaining = remaining - n.to(vectors.dtype)[..., None] * vec
        placed[..., g] = n > 0
        packed[..., g] = n
    return torch.where((abort | ~any_eligible)[..., None], 0, packed)


def _pack_levels_ref(
    vectors, level_counts, capacity, valid_types, prices, level_allow, level_penalty,
    conflict, node_cap, *, mode: str,
) -> LevelPack:
    """Plain version of K6, on any device: every level's round loop run in
    step (a level whose loop has ended stands still, as under the
    reference's vmap of a while_loop), the loop condition tested on the
    host, then the level selection."""
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}")
    num_levels, num_groups = level_counts.shape
    num_types = capacity.shape[0]
    mr = max_rounds(num_groups)
    device = vectors.device

    fits = (vectors[:, None, :] <= capacity[None, :, :] + 1e-6).all(dim=-1)  # [G, T]
    usable = level_allow & fits[None] & valid_types[None, None, :]  # [L, G, T]
    packable = usable.any(dim=2)  # [L, G]
    # Groups no type admits at a level retire at once; else the loop would
    # spin on them until the iteration guard flags a phantom overflow.
    unschedulable = torch.where(packable, 0, level_counts).to(torch.int32)
    counts = torch.where(packable, level_counts, 0).to(torch.int32)

    largest_valid = num_types - 1 - int(_first_true(valid_types.flip(0)))
    ref_cap = torch.clamp(capacity[largest_valid], min=1.0)
    group_weight = (vectors / ref_cap).amax(dim=1)  # [G]
    penalty = level_penalty.transpose(1, 2)  # [L, T, G]

    round_type = torch.zeros((num_levels, mr), dtype=torch.int32, device=device)
    round_fill = torch.zeros((num_levels, mr, num_groups), dtype=torch.int32, device=device)
    round_repl = torch.zeros((num_levels, mr), dtype=torch.int32, device=device)
    num_rounds = [0] * num_levels
    iters = [0] * num_levels
    while True:
        live = [
            int(counts[l].sum()) > 0 and iters[l] < mr + num_groups for l in range(num_levels)
        ]
        if not any(live):
            break
        fills = _fill_one_node_constrained(capacity, vectors, counts, usable, conflict, node_cap)
        fills = torch.where(valid_types[None, :, None], fills, 0)  # [L, T, G]
        sums = fills.sum(dim=2)
        packs_any = (sums > 0) & valid_types
        if mode == "ffd":
            bound = sums.amax(dim=1)  # [L]
            achieves = (sums == bound[:, None]) & valid_types & (bound[:, None] > 0)
            t_sel = torch.argmax(achieves.to(torch.int32), dim=1)
            have_pack = bound > 0
        else:
            as_float = fills.to(torch.float32)
            weighted = _weighted_sums(as_float, group_weight)
            pen = _penalty_sums(as_float, penalty)
            score = torch.where(
                packs_any, (prices + pen) / torch.clamp(weighted, min=1e-9), torch.inf
            )
            t_sel = torch.argmin(score, dim=1)
            have_pack = packs_any.any(dim=1)
        for l in range(num_levels):
            if not live[l]:
                continue
            level_counts_l = counts[l]
            if bool(have_pack[l]):
                fill = fills[l, int(t_sel[l])]
                safe = torch.div(level_counts_l, torch.clamp(fill, min=1), rounding_mode="floor")
                repl = max(int(torch.where(fill > 0, safe, _INT32_MAX).min()), 1)
                # An out-of-range write is dropped, as the reference's
                # scatter drops it; overflow reports the lost round.
                if num_rounds[l] < mr:
                    round_type[l, num_rounds[l]] = t_sel[l]
                    round_fill[l, num_rounds[l]] = fill
                    round_repl[l, num_rounds[l]] = repl
                counts[l] = level_counts_l - repl * fill
                num_rounds[l] += 1
            else:
                first_active = int(_first_true(level_counts_l > 0))
                unschedulable[l, first_active] += level_counts_l[first_active]
                counts[l, first_active] = 0
            iters[l] += 1

    overflow = torch.tensor(
        [int(counts[l].sum()) > 0 or num_rounds[l] > mr for l in range(num_levels)],
        dtype=torch.bool, device=device,
    )
    # A level's misses: its unschedulable pods, its shortfall against the
    # fullest level, and 2^30 on overflow (int32, as the reference sums).
    assigned = level_counts.sum(dim=1, dtype=torch.int32)
    shortfall = assigned.max() - assigned
    totals = (unschedulable.sum(dim=1, dtype=torch.int32) + shortfall
              + overflow.to(torch.int32) * (2**30))
    chosen = int(torch.argmin(totals))  # the first minimum: the strictest
    feasible = (unschedulable == 0) & ~overflow[:, None]  # [L, G]
    group_level = torch.where(
        feasible.any(dim=0), torch.argmax(feasible.to(torch.int32), dim=0), num_levels
    ).to(torch.int32)
    rounds = PackRounds(
        round_type=round_type[chosen],
        round_fill=round_fill[chosen],
        round_repl=round_repl[chosen],
        num_rounds=torch.tensor(min(num_rounds[chosen], mr), dtype=torch.int32, device=device),
        unschedulable=unschedulable[chosen],
        overflow=overflow[chosen].to(torch.int32),
    )
    return LevelPack(
        rounds=rounds,
        chosen_level=torch.tensor(chosen, dtype=torch.int32, device=device),
        group_level=group_level,
        level_unsched=unschedulable,
    )


def _check_level_args(
    vectors, level_counts, capacity, total, valid_types, prices, level_allow,
    level_penalty, conflict, node_cap,
) -> None:
    named = (
        ("vectors", vectors, torch.float32), ("level_counts", level_counts, torch.int32),
        ("capacity", capacity, torch.float32), ("total", total, torch.float32),
        ("valid_types", valid_types, torch.bool), ("prices", prices, torch.float32),
        ("level_allow", level_allow, torch.bool), ("level_penalty", level_penalty, torch.float32),
        ("conflict", conflict, torch.bool), ("node_cap", node_cap, torch.int32),
    )
    for name, tensor, dtype in named:
        if tensor.dtype != dtype:
            raise TypeError(f"pack_kernel_levels: {name} must be {dtype}, got {tensor.dtype}")
        if tensor.device != vectors.device:
            raise ValueError("pack_kernel_levels: every argument must lie on one device")
    if vectors.dim() != 2 or level_counts.dim() != 2:
        raise ValueError("pack_kernel_levels takes vectors [G, R] and level_counts [L, G]")
    num_groups, dims = vectors.shape
    num_levels = level_counts.shape[0]
    num_types = capacity.shape[0]
    if (
        level_counts.shape != (num_levels, num_groups)
        or capacity.shape != (num_types, dims)
        or total.shape != (num_types, dims)
        or valid_types.shape != (num_types,)
        or prices.shape != (num_types,)
        or level_allow.shape != (num_levels, num_groups, num_types)
        or level_penalty.shape != (num_levels, num_groups, num_types)
        or conflict.shape != (num_groups, num_groups)
        or node_cap.shape != (num_groups,)
    ):
        raise ValueError("pack_kernel_levels: inconsistent shapes")


class LevelsLaunchPlan(NamedTuple):
    """How K6 lays one level's round loop over a thread-block cluster."""

    cluster: int  # blocks a level, 1..LEVELS_MAX_CLUSTER
    lanes: int  # threads a type, each a share of its axes (1, 2, 4 or 8)
    types_per_block: int  # block b owns types [b * TB, (b + 1) * TB)
    threads: int  # a multiple of 32, at most 512; slot i (threads / lanes) owns types i + k * slots
    shared_bytes: int  # dynamic shared memory per block
    fills_in_shared: bool  # else [L * cluster, 2, G, TB] int32 of global scratch
    tables_in_shared: bool  # else [L * cluster, table words] int32 of global scratch
    placed_in_registers: bool  # else [L * cluster, W, threads] uint32 of global scratch

    def owner(self, t: int) -> int:
        """The cluster rank that owns type t."""
        return t // self.types_per_block


# csrc/pack_levels.cu's Control words (with the cluster's exchanged keys).
_LEVELS_CONTROL_BYTES = 416
LEVELS_MAX_CLUSTER = 16
LEVELS_MAX_THREADS = 512  # 128 registers a thread: the scan spills at 64
# Types a block of a level's cluster should own: the cluster grows (in
# powers of two) until each block owns at most this many.
_LEVEL_TYPES_PER_BLOCK = 64


def levels_table_words(groups: int, types_per_block: int, dims: int) -> int:
    """Words of one block's tables (csrc/pack_levels.cu table_words): [G, R]
    vectors, five [G] tables, the [G, W] conflict rows, its types' [W, TB]
    usable words and [G, TB] penalties, the [W] words of the groups with
    pods left."""
    bit_words = -(-groups // 32)
    return (groups * dims + 5 * groups + groups * bit_words + bit_words * types_per_block
            + groups * types_per_block + bit_words)


def levels_fill_words(groups: int, types_per_block: int) -> int:
    """Words of one block's fills: [2, G, TB], one half a round by parity."""
    return 2 * groups * types_per_block


def levels_plan_for(groups: int, types: int, dims: int, cluster: int, lanes: int) -> LevelsLaunchPlan:
    """K6's plan at a given cluster size and lanes a type: TB = ceil(T /
    cluster) types a block, as many type slots as TB (at most 512 / lanes
    threads' worth); the tables in shared memory when they fit SHARED_LIMIT
    beside the control words, the fills when they fit beside both; the
    placed bits in registers up to G 256."""
    if not 1 <= cluster <= LEVELS_MAX_CLUSTER or lanes not in (1, 2, 4, 8):
        raise ValueError(f"pack_kernel_levels: no plan at cluster {cluster}, {lanes} lanes")
    types_per_block = -(-types // cluster)
    threads = (min(types_per_block, LEVELS_MAX_THREADS // lanes) * lanes + 31) & ~31
    tables = 4 * levels_table_words(groups, types_per_block, dims)
    fills = 4 * levels_fill_words(groups, types_per_block)
    tables_in_shared = _LEVELS_CONTROL_BYTES + tables <= SHARED_LIMIT
    fills_in_shared = tables_in_shared and _LEVELS_CONTROL_BYTES + tables + fills <= SHARED_LIMIT
    shared = (_LEVELS_CONTROL_BYTES + (tables if tables_in_shared else 0)
              + (fills if fills_in_shared else 0))
    return LevelsLaunchPlan(cluster, lanes, types_per_block, threads, shared, fills_in_shared,
                            tables_in_shared, groups <= 256)


def levels_launch_plan(groups: int, types: int, dims: int) -> LevelsLaunchPlan:
    """K6's launch plan, from the sizes alone: the smallest power-of-two
    cluster whose blocks own at most 64 types (at most 16 blocks); a type
    spread over one lane an axis (the axes rounded up to a power of two, at
    most 8), halved while a block's types would need more than 512
    threads."""
    cluster = 1
    while cluster < LEVELS_MAX_CLUSTER and cluster * _LEVEL_TYPES_PER_BLOCK < types:
        cluster *= 2
    types_per_block = -(-types // cluster)
    lanes = 1
    while lanes < min(dims, MAX_DIMS) and types_per_block * lanes * 2 <= LEVELS_MAX_THREADS:
        lanes *= 2
    return levels_plan_for(groups, types, dims, cluster, lanes)


def level_pack_words(groups: int, levels: int) -> int:
    """Words of K6's output: the chosen level's rounds in the dense layout,
    the chosen level, group_level [G] and level_unsched [L, G]."""
    return rounds_words(groups) + 1 + groups + levels * groups


def rounds_words(groups: int) -> int:
    """Words of one PackRounds in the dense layout (rounds_from_words)."""
    return max_rounds(groups) * (groups + 2) + groups + 2


def level_pack_from_words(words: torch.Tensor, groups: int, levels: int) -> LevelPack:
    """Views of K6's [level_pack_words] int32 output as a LevelPack."""
    head = rounds_words(groups)
    return LevelPack(
        rounds=rounds_from_words(words[:head], groups),
        chosen_level=words[head].view(()),
        group_level=words[head + 1 : head + 1 + groups],
        level_unsched=words[head + 1 + groups :].view(levels, groups),
    )


def _launch_levels(vectors, level_counts, capacity, valid_types, prices, level_allow,
                   level_penalty, conflict, node_cap, mode: str,
                   plan: Optional[LevelsLaunchPlan] = None) -> torch.Tensor:
    """One call of K6 (the level kernel, then the selection kernel), with
    levels_launch_plan's plan; `plan` overrides it only where the card
    tests hold K6 at every cluster size. Returns its [level_pack_words]
    int32 output."""
    num_levels, num_groups = level_counts.shape
    num_types, dims = capacity.shape
    if num_groups == 0 or num_types == 0 or dims == 0 or num_levels == 0:
        raise ValueError("pack_kernel_levels kernel takes G, T, R, L >= 1")
    if dims > MAX_DIMS or num_levels > MAX_LEVELS:
        raise ValueError(
            f"pack_kernel_levels kernel takes at most {MAX_DIMS} axes and {MAX_LEVELS} levels")
    tensors = (vectors, level_counts, capacity, valid_types, prices, level_allow,
               level_penalty, conflict, node_cap)
    if not all(tensor.is_contiguous() for tensor in tensors):
        raise ValueError("pack_kernel_levels kernel takes contiguous tensors")
    plan = plan or levels_launch_plan(num_groups, num_types, dims)
    if plan.shared_bytes > SHARED_LIMIT:
        raise ValueError(f"pack_kernel_levels: the plan asks for {plan.shared_bytes} bytes of shared memory")
    lib = LEVELS_LIBRARY.load()
    device = vectors.device
    blocks = num_levels * plan.cluster
    bit_words = -(-num_groups // 32)
    level_words = lib.ktt_pack_levels_words(num_groups)
    level_out = torch.empty((num_levels, level_words), dtype=torch.int32, device=device)
    fills = tables = placed = None
    if not plan.fills_in_shared:
        fills = torch.empty((blocks, levels_fill_words(num_groups, plan.types_per_block)),
                            dtype=torch.int32, device=device)
    if not plan.tables_in_shared:
        tables = torch.empty(
            (blocks, levels_table_words(num_groups, plan.types_per_block, dims)),
            dtype=torch.int32, device=device,
        )
    if not plan.placed_in_registers:
        placed = torch.empty((blocks, bit_words, plan.threads), dtype=torch.int32, device=device)
    words = level_pack_words(num_groups, num_levels)
    out = torch.empty(words, dtype=torch.int32, device=device)
    select_blocks = max(1, min(132, -(-words // 1024)))
    outputs = [level_out, out] + [t for t in (fills, tables, placed) if t is not None]
    with launch_stream("pack_kernel_levels", tensors + tuple(outputs)) as stream:
        status = lib.ktt_pack_levels(
            *(tensor.data_ptr() for tensor in tensors),
            num_groups, num_types, dims, num_levels, _MODES.index(mode), plan.cluster,
            plan.lanes, plan.threads, select_blocks, level_out.data_ptr(),
            0 if fills is None else fills.data_ptr(),
            0 if tables is None else tables.data_ptr(),
            0 if placed is None else placed.data_ptr(), out.data_ptr(), stream,
        )
    check_launch(status, "pack_kernel_levels")
    pack_kernel_levels.launches += 1
    return out


def pack_kernel_levels(
    vectors,  # [G, R] f32 — sub-group request vectors, FFD-sorted desc
    level_counts,  # [L, G] i32 — per-level pods per sub-group
    capacity,  # [T, R] f32
    total,  # [T, R] f32 (layout parity with pack_kernel; the constrained fill does not read it)
    valid_types,  # [T] bool
    prices,  # [T] f32
    level_allow,  # [L, G, T] bool
    level_penalty,  # [L, G, T] f32
    conflict,  # [G, G] bool
    node_cap,  # [G] i32 (NODE_CAP_NONE = uncapped)
    *,
    mode: str = "cost",
) -> LevelPack:
    """The [L, G, T] dispatch: solve every relaxation level, pick the
    strictest feasible one. K6 (csrc/pack_levels.cu) for CUDA tensors, the
    plain version for CPU tensors."""
    _check_level_args(vectors, level_counts, capacity, total, valid_types, prices,
                      level_allow, level_penalty, conflict, node_cap)
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if vectors.device.type == "cpu":
        return _pack_levels_ref(
            vectors, level_counts, capacity, valid_types, prices, level_allow,
            level_penalty, conflict, node_cap, mode=mode,
        )
    if vectors.device.type != "cuda":
        raise ValueError(f"pack_kernel_levels: unsupported device {vectors.device}")
    out = _launch_levels(vectors, level_counts, capacity, valid_types, prices, level_allow,
                         level_penalty, conflict, node_cap, mode)
    return level_pack_from_words(out, vectors.shape[0], level_counts.shape[0])


pack_kernel_levels.launches = 0


def level_pack_to_host(pack: LevelPack) -> LevelPack:
    """A LevelPack as numpy arrays, brought to the host in one copy (one
    concatenation on the device, then one device->host transfer)."""
    fields = [*pack.rounds, pack.chosen_level, pack.group_level, pack.level_unsched]
    flat = torch.cat([field.reshape(-1).to(torch.int32) for field in fields]).cpu().numpy()
    out = []
    cursor = 0
    for field in fields:
        out.append(flat[cursor : cursor + field.numel()].reshape(tuple(field.shape)))
        cursor += field.numel()
    return LevelPack(
        rounds=PackRounds(*out[:6]), chosen_level=out[6], group_level=out[7], level_unsched=out[8]
    )


def pad_to(array: np.ndarray, size: int, axis: int = 0, value=0) -> np.ndarray:
    pad = size - array.shape[axis]
    if pad <= 0:
        return array
    widths = [(0, 0)] * array.ndim
    widths[axis] = (0, pad)
    return np.pad(array, widths, constant_values=value)


def bucket_size(n: int, minimum: int = 8) -> int:
    """Next power of two >= n — shape bucketing, so the kernels see a small
    ladder of shapes."""
    size = minimum
    while size < n:
        size *= 2
    return size


# --- on-device plan compaction ----------------------------------------------
#
# The dense PackRounds state is mostly padding: round_fill is [MR, G] but a
# real plan touches a handful of (round, group) cells. The compaction runs ON
# DEVICE, in the epilogue of K2's pair launch (pack_pair_payload), and
# squeezes each candidate plan into
# per-round (type, repl) rows plus a prefix-sum-compacted COO list of the
# nonzero fill entries, so the eager device->host fetch is a few KB. Decode
# (decompact_plan) rebuilds the exact dense arrays.


def entry_budget(num_groups: int) -> int:
    """Static COO entry budget per candidate plan: 4 entries per round. A
    plan that overflows the budget sets the payload's nnz past it and the
    caller falls back to fetching the dense spill."""
    return 4 * max_rounds(num_groups)


def compact_words(num_groups: int) -> int:
    """int32 word count of compact_plan's payload for a padded group axis."""
    mr = max_rounds(num_groups)
    budget = entry_budget(num_groups)
    per_candidate = mr + mr + 1 + num_groups + 1 + 1 + 2 * budget
    return 2 * per_candidate + num_groups


def _compact_rounds(rounds: PackRounds):
    """Device-side compaction of one PackRounds: fixed-size int32 segments
    [round_type, round_repl, num_rounds, unschedulable, overflow, nnz,
    entry_idx, entry_fill]. entry_idx holds flat r*G+g indices of nonzero
    round_fill cells, front-compacted by prefix sum (_compact_entry_block
    over the whole [MR, G] matrix)."""
    num_groups = rounds.round_fill.shape[1]
    return _rounds_header(rounds) + [_compact_entry_block(rounds.round_fill, entry_budget(num_groups))]


def _rounds_header(rounds: PackRounds) -> list:
    """The replicated segments of one PackRounds' payload: round_type,
    round_repl, num_rounds, unschedulable, overflow, as int32."""
    return [
        rounds.round_type.to(torch.int32),
        rounds.round_repl.to(torch.int32),
        rounds.num_rounds.reshape(1).to(torch.int32),
        rounds.unschedulable.to(torch.int32),
        rounds.overflow.to(torch.int32).reshape(1),
    ]


def _compact_plan_ref(rounds_ffd: PackRounds, rounds_cost: PackRounds, feasible_any):
    """Plain version of K4, on any device: both candidate plans plus the
    feasibility vector as ONE flat int32 tensor."""
    return torch.cat(
        _compact_rounds(rounds_ffd)
        + _compact_rounds(rounds_cost)
        + [feasible_any.to(torch.int32)]
    )


def _check_payload_args(kernel: str, rounds_ffd: PackRounds, rounds_cost: PackRounds,
                        feasible_any) -> None:
    """Raise unless both PackRounds are int32 of the shapes padded G gives
    them and every argument is contiguous, as K9b's payload kernel reads
    them."""
    if feasible_any.dtype != torch.bool or feasible_any.dim() != 1:
        raise TypeError(f"{kernel} kernel takes feasible_any as a [G] bool tensor")
    num_groups = feasible_any.shape[0]
    mr = max_rounds(num_groups)
    shapes = ((mr,), (mr, num_groups), (mr,), (), (num_groups,), ())
    for rounds in (rounds_ffd, rounds_cost):
        for name, tensor, shape in zip(PackRounds._fields, rounds, shapes):
            if tensor.dtype != torch.int32 or tuple(tensor.shape) != shape:
                raise ValueError(f"{kernel} kernel takes {name} as int32 {shape}")
    if not all(tensor.is_contiguous() for tensor in [*rounds_ffd, *rounds_cost, feasible_any]):
        raise ValueError(f"{kernel} kernel takes contiguous tensors")


def compact_plan(rounds_ffd: PackRounds, rounds_cost: PackRounds, feasible_any):
    """Both candidate plans plus the feasibility vector as ONE flat int32
    tensor — the eager device->host payload of a fused cost solve — from
    CPU tensors (the plain version). On the card K4 runs inside K2's pair
    launch: pack_pair_payload writes this payload, and a tensor on any
    other device raises."""
    fields = [*rounds_ffd, *rounds_cost]
    device = feasible_any.device
    if any(tensor.device != device for tensor in fields):
        raise ValueError("compact_plan: every argument must lie on one device")
    if device.type != "cpu":
        raise ValueError(
            f"compact_plan takes CPU tensors, not {device}: on the card the payload comes "
            "from K2's pair launch, pack_pair_payload"
        )
    return _compact_plan_ref(rounds_ffd, rounds_cost, feasible_any)


def decompact_plan(
    words: np.ndarray, num_groups: int
) -> Tuple[PackRounds, PackRounds, np.ndarray, bool]:
    """Host-side inverse of compact_plan: (rounds_ffd, rounds_cost,
    feasible_any, ok) as numpy, with the dense [MR, G] fill matrices rebuilt
    bit-identically. ok=False when either plan overflowed the COO entry
    budget — the caller must fetch the dense spill instead."""
    mr = max_rounds(num_groups)
    budget = entry_budget(num_groups)
    cursor = 0

    def take(n):
        nonlocal cursor
        out = words[cursor : cursor + n]
        cursor += n
        return out

    plans = []
    ok = True
    for _ in range(2):
        round_type = take(mr)
        round_repl = take(mr)
        num_rounds = take(1)[0]
        unschedulable = take(num_groups)
        overflow = bool(take(1)[0])
        nnz = int(take(1)[0])
        entry_idx = take(budget)
        entry_fill = take(budget)
        if nnz > budget:
            ok = False
            plans.append(None)
            continue
        fill = np.zeros((mr * num_groups,), np.int32)
        fill[entry_idx[:nnz]] = entry_fill[:nnz]
        plans.append(
            PackRounds(
                round_type=round_type,
                round_fill=fill.reshape(mr, num_groups),
                round_repl=round_repl,
                num_rounds=num_rounds,
                unschedulable=unschedulable,
                overflow=overflow,
            )
        )
    feasible_any = take(num_groups).astype(bool)
    return plans[0], plans[1], feasible_any, ok


# --- shard-local plan compaction (K9b) ---------------------------------------
#
# On a mesh, each shard compacts its own contiguous block of G / W groups of
# both modes' [MR, G] fill matrices with a block-local entry budget, and only
# the compacted segments travel to the mesh's first shard, where they join
# the replicated headers in one payload. Decode (decompact_plan_sharded)
# scatters each shard's entries at its block offset, so the rebuilt dense
# arrays are bit-identical to the single-device layout's.


def shard_entry_budget(num_groups: int, shards: int) -> int:
    """Per-shard COO entry budget: the single-device budget formula applied
    to the shard's own group block, so the entries-per-group headroom (~8)
    is the same at every shard count. A shard whose block draws more than
    its budget signals overflow via nnz and the caller falls back to the
    dense spill — correctness never depends on the budget."""
    return entry_budget(num_groups // shards)


def compact_words_sharded(num_groups: int, shards: int) -> int:
    """int32 word count of compact_plan_sharded's payload (shards=1 is
    exactly the single-device compact_words layout)."""
    if shards <= 1:
        return compact_words(num_groups)
    mr = max_rounds(num_groups)
    budget = shard_entry_budget(num_groups, shards)
    per_candidate = mr + mr + 1 + num_groups + 1 + shards * (1 + 2 * budget)
    return 2 * per_candidate + num_groups


def _compact_entry_block(fill_block: torch.Tensor, budget: int) -> torch.Tensor:
    """The prefix-sum COO compaction of one [MR, G'] fill block into [nnz,
    entry_idx[budget], entry_fill[budget]] — the shared core of K4's and
    K9b's plain versions (indices block-local; entries past the budget go
    to one extra slot, which is sliced off, as the reference's scatter
    drops them)."""
    device = fill_block.device
    flat = fill_block.reshape(-1)
    mask = flat != 0
    nnz = mask.sum(dtype=torch.int32)
    position = torch.cumsum(mask, dim=0) - 1
    dest = torch.where(mask, position, budget).clamp_(max=budget)
    entry_idx = torch.zeros(budget + 1, dtype=torch.int32, device=device)
    entry_idx.scatter_(0, dest, torch.arange(flat.shape[0], dtype=torch.int32, device=device))
    entry_fill = torch.zeros(budget + 1, dtype=torch.int32, device=device)
    entry_fill.scatter_(0, dest, flat.to(torch.int32))
    return torch.cat([nnz.reshape(1), entry_idx[:budget], entry_fill[:budget]])


def _compact_shard_ref(fill_ffd: torch.Tensor, fill_cost: torch.Tensor, shard: int,
                       shards: int) -> torch.Tensor:
    """Plain version of K9b, on any device: both modes' segments of one
    shard's column block."""
    num_groups = fill_ffd.shape[1]
    width = num_groups // shards
    budget = shard_entry_budget(num_groups, shards)
    columns = slice(shard * width, (shard + 1) * width)
    return torch.stack([
        _compact_entry_block(fill[:, columns].contiguous(), budget) for fill in (fill_ffd, fill_cost)
    ])


def _compact_shards_ref(fill_ffd: torch.Tensor, fill_cost: torch.Tensor, shard_ids,
                        shards: int) -> torch.Tensor:
    """Plain version of compact_shards: one _compact_shard_ref a shard."""
    return torch.stack([_compact_shard_ref(fill_ffd, fill_cost, shard, shards) for shard in shard_ids])


def _assemble_sharded(rounds_ffd: PackRounds, rounds_cost: PackRounds, feasible_any,
                      segments: torch.Tensor) -> torch.Tensor:
    """compact_plan_sharded's flat payload from every shard's segments
    ([W, 2, 1 + 2 * budget], in the mesh's flat order) and the replicated
    headers, on the segments' device."""
    return torch.cat(
        _rounds_header(rounds_ffd) + [segments[:, 0].reshape(-1)]
        + _rounds_header(rounds_cost) + [segments[:, 1].reshape(-1)]
        + [feasible_any.to(torch.int32)]
    )


def _compact_sharded_payload_ref(rounds_ffd: PackRounds, rounds_cost: PackRounds, feasible_any,
                                 shards: int) -> torch.Tensor:
    """Plain version of compact_sharded_payload, on any device."""
    segments = _compact_shards_ref(rounds_ffd.round_fill, rounds_cost.round_fill, range(shards), shards)
    return _assemble_sharded(rounds_ffd, rounds_cost, feasible_any, segments)


def _check_fills(fill_ffd: torch.Tensor, fill_cost: torch.Tensor, shards: int) -> None:
    if fill_ffd.shape != fill_cost.shape or fill_ffd.dim() != 2:
        raise ValueError("K9b takes two [MR, G] fill matrices")
    mr, num_groups = fill_ffd.shape
    if mr != max_rounds(num_groups) or shards < 1 or num_groups % shards:
        raise ValueError(f"K9b: [{mr}, {num_groups}] fills do not split {shards} ways")
    if fill_ffd.dtype != torch.int32 or fill_cost.dtype != torch.int32:
        raise TypeError("K9b takes int32 fills")
    if fill_cost.device != fill_ffd.device:
        raise ValueError("K9b: every argument must lie on one device")


# Shards one launch of the per-card route takes (csrc/compact_shard.cu's
# kMaxListed); a card holding more takes a launch for each such run.
MAX_LISTED_SHARDS = 32


def compact_shards(fill_ffd: torch.Tensor, fill_cost: torch.Tensor, shard_ids, shards: int) -> torch.Tensor:
    """K9b's per-card route: the segments of both modes' [MR, G] fills for
    the shards `shard_ids` (flat indices of a `shards`-shard mesh, the
    shards one card holds), [len(shard_ids), 2, 1 + 2 *
    shard_entry_budget(G, shards)] int32. The CUDA kernel (one launch for up
    to MAX_LISTED_SHARDS shards) for CUDA tensors, the plain version for CPU
    tensors."""
    shard_ids = [int(shard) for shard in shard_ids]
    _check_fills(fill_ffd, fill_cost, shards)
    if not shard_ids or not all(0 <= shard < shards for shard in shard_ids):
        raise ValueError(f"compact_shards: shards {shard_ids} are not shards of {shards}")
    device = fill_ffd.device
    if device.type == "cpu":
        return _compact_shards_ref(fill_ffd, fill_cost, shard_ids, shards)
    if device.type != "cuda":
        raise ValueError(f"compact_shards: unsupported device {device}")
    if not (fill_ffd.is_contiguous() and fill_cost.is_contiguous()):
        raise ValueError("compact_shards kernel takes contiguous tensors")
    num_groups = fill_ffd.shape[1]
    budget = shard_entry_budget(num_groups, shards)
    lib = COMPACT_SHARD_LIBRARY.load()
    out = torch.empty((len(shard_ids), 2, 1 + 2 * budget), dtype=torch.int32, device=device)
    for start in range(0, len(shard_ids), MAX_LISTED_SHARDS):
        listed = shard_ids[start : start + MAX_LISTED_SHARDS]
        with launch_stream("compact_shards", (fill_ffd, fill_cost, out)) as stream:
            status = lib.ktt_compact_shards(
                fill_ffd.data_ptr(), fill_cost.data_ptr(), num_groups, shards, budget, len(listed),
                (ctypes.c_int * len(listed))(*listed), out.narrow(0, start, len(listed)).data_ptr(), stream,
            )
        check_launch(status, "compact_shards")
        compact_shard.launches += 1
    return out


def compact_shard(fill_ffd: torch.Tensor, fill_cost: torch.Tensor, shard: int, shards: int) -> torch.Tensor:
    """K9b for one shard: shard `shard` of `shards`' segments of both modes'
    [MR, G] fills, [2, 1 + 2 * shard_entry_budget(G, shards)] int32
    (compact_shards of that one shard). `compact_shard.launches` counts
    every K9b launch: compact_shards' and compact_sharded_payload's."""
    return compact_shards(fill_ffd, fill_cost, [shard], shards)[0]


compact_shard.launches = 0


def compact_sharded_payload(rounds_ffd: PackRounds, rounds_cost: PackRounds, feasible_any,
                            shards: int) -> torch.Tensor:
    """K9b's one-card route: compact_plan_sharded's whole flat payload for a
    mesh of `shards` shards that all lie on the arguments' device. The CUDA
    kernel (ONE launch: headers, every shard's segments, feasible_any) for
    CUDA tensors, the plain version for CPU tensors."""
    fields = [*rounds_ffd, *rounds_cost]
    device = feasible_any.device
    if any(tensor.device != device for tensor in fields):
        raise ValueError("compact_sharded_payload: every argument must lie on one device")
    _check_fills(rounds_ffd.round_fill, rounds_cost.round_fill, shards)
    if device.type == "cpu":
        return _compact_sharded_payload_ref(rounds_ffd, rounds_cost, feasible_any, shards)
    if device.type != "cuda":
        raise ValueError(f"compact_sharded_payload: unsupported device {device}")
    _check_payload_args("compact_sharded_payload", rounds_ffd, rounds_cost, feasible_any)
    num_groups = feasible_any.shape[0]
    lib = COMPACT_SHARD_LIBRARY.load()
    out = torch.empty(compact_words_sharded(num_groups, shards), dtype=torch.int32, device=device)
    pointers = (ctypes.c_void_p * len(fields))(*(tensor.data_ptr() for tensor in fields))
    with launch_stream("compact_sharded_payload", fields + [feasible_any, out]) as stream:
        status = lib.ktt_compact_sharded_payload(
            pointers, feasible_any.data_ptr(), num_groups, shards,
            shard_entry_budget(num_groups, shards), out.data_ptr(), stream,
        )
    check_launch(status, "compact_sharded_payload")
    compact_shard.launches += 1
    return out


def _card_shards(mesh, per_card: Optional[int]) -> List[Tuple[torch.device, List[int]]]:
    """The per-card route's launches: (device, flat shard indices) for each
    device of the mesh in order, its shards in flat order; with `per_card`,
    each device's shards split into runs of that many, as if each run lay
    on a card of its own."""
    cards = []
    for device in mesh.devices:
        ids = [index for index, shard in enumerate(mesh.flat) if shard.device == device]
        step = per_card or len(ids)
        cards += [(device, ids[start : start + step]) for start in range(0, len(ids), step)]
    return cards


def compact_plan_sharded(rounds_ffd: PackRounds, rounds_cost: PackRounds, feasible_any, *,
                         mesh, replicas=None, per_card: Optional[int] = None):
    """compact_plan's mesh twin: both candidate plans plus the feasibility
    vector as one flat int32 tensor on the mesh's first shard, with the COO
    entry lists compacted shard-locally (K9b). On a mesh whose shards all
    lie on one device, one call of compact_sharded_payload writes the whole
    payload. Across devices, one call of compact_shards a device covers the
    shards it holds, reading that device's copy of the (ffd, cost) fill
    matrices (`replicas` maps each device other than the first to it;
    without it, the fills are copied there); the segments are gathered to
    the first shard and joined to the replicated headers there. `per_card`
    forces that route on any mesh, each device's shards split into runs of
    `per_card`, one call each. A mesh of one shard takes compact_plan, on
    the CPU only (on the card the sharded solve takes that payload from K2's
    pair launch). The arguments lie on the first shard's
    device. G must be a multiple of mesh.size
    (models/solver.pad_kernel_args handles it via g_mult)."""
    from karpenter_tpu_torch.parallel import collectives

    if mesh.size <= 1:
        return compact_plan(rounds_ffd, rounds_cost, feasible_any)
    if per_card is None and len(mesh.devices) == 1:
        return compact_sharded_payload(rounds_ffd, rounds_cost, feasible_any, mesh.size)
    fills = dict(replicas or {})
    parts, order = [], []
    for device, ids in _card_shards(mesh, per_card):
        if device not in fills:
            fills[device] = (rounds_ffd.round_fill.to(device), rounds_cost.round_fill.to(device))
        parts.append(compact_shards(*fills[device], ids, mesh.size))
        order += ids
    parts = collectives.gather_to_first(mesh, parts)
    if order == sorted(order):
        segments = torch.cat(parts)
    else:  # back to the mesh's flat order
        by_shard = dict(zip(order, (segment for part in parts for segment in part)))
        segments = torch.stack([by_shard[index] for index in range(mesh.size)])
    return _assemble_sharded(rounds_ffd, rounds_cost, feasible_any, segments)


def decompact_plan_sharded(
    words: np.ndarray, num_groups: int, shards: int
) -> Tuple[PackRounds, PackRounds, np.ndarray, bool]:
    """Host-side inverse of compact_plan_sharded: scatter each shard's
    block-local entries at its block offset. shards=1 delegates to the
    single-device decoder (identical layout). ok=False when any shard of
    either plan overflowed its entry budget — the caller must fetch the
    dense spill instead."""
    if shards <= 1:
        return decompact_plan(words, num_groups)
    mr = max_rounds(num_groups)
    budget = shard_entry_budget(num_groups, shards)
    group_block = num_groups // shards
    cursor = 0

    def take(n):
        nonlocal cursor
        out = words[cursor : cursor + n]
        cursor += n
        return out

    plans = []
    ok = True
    for _ in range(2):
        round_type = take(mr)
        round_repl = take(mr)
        num_rounds = take(1)[0]
        unschedulable = take(num_groups)
        overflow = bool(take(1)[0])
        fill = np.zeros((mr * num_groups,), np.int32)
        plan_ok = True
        for shard in range(shards):
            nnz = int(take(1)[0])
            entry_idx = take(budget)
            entry_fill = take(budget)
            if nnz > budget:
                plan_ok = False
                continue
            rows = entry_idx[:nnz] // group_block
            cols = shard * group_block + entry_idx[:nnz] % group_block
            fill[rows * num_groups + cols] = entry_fill[:nnz]
        if not plan_ok:
            ok = False
            plans.append(None)
            continue
        plans.append(
            PackRounds(
                round_type=round_type,
                round_fill=fill.reshape(mr, num_groups),
                round_repl=round_repl,
                num_rounds=num_rounds,
                unschedulable=unschedulable,
                overflow=overflow,
            )
        )
    feasible_any = take(num_groups).astype(bool)
    return plans[0], plans[1], feasible_any, ok


# --- device-resident encode reuse --------------------------------------------

# Content-keyed cache of device tensors for padded encode arrays (fleet
# capacity/total/valid/prices, consolidation type arrays): back-to-back
# sweeps in one reconcile turn (provision -> consolidate) re-derive the same
# encoded state, and without the cache every dispatch pays a fresh
# host->device transfer for it. Keyed by device and content, not object
# identity, so a rebuilt-but-identical fleet still hits. No kernel writes
# into its inputs, so a cached tensor is never modified.
_DEVICE_RESIDENT: "OrderedDict[Tuple, torch.Tensor]" = OrderedDict()
_DEVICE_RESIDENT_MAX = 64
_device_resident_lock = threading.Lock()


def _resident_key(array: np.ndarray, device: torch.device) -> Tuple:
    return (str(device), array.shape, array.dtype.str, array.tobytes())


def device_resident(arrays: Sequence, resident: Sequence[bool], device) -> Tuple[torch.Tensor, ...]:
    """`arrays` on `device`: a tensor already there passes through; a numpy
    array flagged `resident` comes from the content-keyed cache when it
    holds it; every other array goes into ONE packed upload
    (convert.upload_packed), and the resident ones among them are cached."""
    device = torch.device(device)
    out: list = [None] * len(arrays)
    keys = {}
    missing = []
    for i, (array, keep) in enumerate(zip(arrays, resident)):
        if isinstance(array, torch.Tensor):
            if array.device != device:
                raise ValueError(f"a tensor on {array.device} handed to a dispatch on {device}")
            out[i] = array
            continue
        if keep:
            key = _resident_key(np.ascontiguousarray(array), device)
            with _device_resident_lock:
                cached = _DEVICE_RESIDENT.get(key)
                if cached is not None:
                    _DEVICE_RESIDENT.move_to_end(key)
            if cached is not None:
                out[i] = cached
                continue
            keys[i] = key
        missing.append(i)
    if missing:
        if keys:
            device_resident.uploads += 1
        # The transfer runs outside the lock; a racing double upload is
        # harmless (last writer wins).
        for i, tensor in zip(missing, upload_packed([arrays[i] for i in missing], device)):
            out[i] = tensor
            if i in keys:
                # On the CPU the tensor shares the caller's numpy memory.
                held = tensor.clone() if device.type == "cpu" else tensor
                with _device_resident_lock:
                    while len(_DEVICE_RESIDENT) >= _DEVICE_RESIDENT_MAX:
                        _DEVICE_RESIDENT.popitem(last=False)
                    _DEVICE_RESIDENT[keys[i]] = held
                out[i] = held
    return tuple(out)


# Calls that uploaded at least one array flagged resident (a fleet or
# catalog re-upload: a cache miss). A run reads it to show that the fleet
# re-uploads exactly when prices moved.
device_resident.uploads = 0


def reset_device_resident() -> None:
    """Test hook: drop every cached device tensor."""
    with _device_resident_lock:
        _DEVICE_RESIDENT.clear()
