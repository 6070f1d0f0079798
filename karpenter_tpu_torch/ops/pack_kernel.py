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
`pack_launch_plan` lays it out. `_pack_kernel_ref` is its plain
PyTorch version, which tests the loop condition on the host every round. A
CPU tensor goes to the plain version, a CUDA tensor to the kernel; quirk=True
exists only in the plain version (the cost solve never uses it), and asking
the kernel for it raises. The plan compaction after it is K4
(csrc/compact.cu, `compact_plan`): one launch writes the whole payload, and
`_compact_plan_ref` is its plain version.

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
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from karpenter_tpu_torch.convert import upload_packed
from karpenter_tpu_torch.ops.cuda_build import CudaLibrary, check_launch

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
        "ktt_pack_rounds_shared_bytes": (ctypes.c_longlong, [ctypes.c_int] * 5),
        "ktt_pack_rounds_table_words": (ctypes.c_longlong, [ctypes.c_int] * 3),
        "ktt_pack_rounds": (
            ctypes.c_int,
            [ctypes.c_void_p] * 5
            + [ctypes.c_int] * 7
            + [ctypes.c_void_p] * 4,
        ),
    },
)
LEVELS_LIBRARY = CudaLibrary(
    "pack_levels.cu",
    {
        "ktt_pack_levels_words": (ctypes.c_int, [ctypes.c_int]),
        "ktt_pack_levels_shared_bytes": (ctypes.c_longlong, [ctypes.c_int] * 5),
        "ktt_pack_levels_table_words": (ctypes.c_longlong, [ctypes.c_int] * 3),
        "ktt_pack_levels": (
            ctypes.c_int,
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 7,
        ),
    },
)
COMPACT_LIBRARY = CudaLibrary(
    "compact.cu",
    {
        "ktt_compact_words": (ctypes.c_int, [ctypes.c_int]),
        "ktt_compact_plan": (
            ctypes.c_int,
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
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


def _launch(vectors, counts, capacity, valid_types, prices, first_mode: int, num_modes: int):
    """One launch of the round-loop kernel: block b runs mode first_mode + b.
    Returns [num_modes, words] int32 in the reference's dense layout."""
    num_groups, dims = vectors.shape
    num_types = capacity.shape[0]
    if num_groups == 0 or num_types == 0 or dims == 0:
        raise ValueError("pack_kernel kernel takes G, T, R >= 1")
    if dims > MAX_DIMS:
        raise ValueError(f"pack_kernel kernel takes at most {MAX_DIMS} axes")
    tensors = (vectors, counts, capacity, valid_types, prices)
    if not all(tensor.is_contiguous() for tensor in tensors):
        raise ValueError("pack_kernel kernel takes contiguous tensors")
    plan = pack_launch_plan(num_groups, num_types, dims)
    lib = LIBRARY.load()
    words = lib.ktt_pack_rounds_words(num_groups)
    out = torch.empty((num_modes, words), dtype=torch.int32, device=vectors.device)
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
    with torch.cuda.device(vectors.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.ktt_pack_rounds(
            *(tensor.data_ptr() for tensor in tensors),
            num_groups, num_types, dims, first_mode, num_modes,
            plan.threads, plan.types_per_thread, out.data_ptr(),
            0 if scratch is None else scratch.data_ptr(),
            0 if tables is None else tables.data_ptr(), stream,
        )
    check_launch(status, "pack_kernel")
    pack_kernel.launches += 1
    return out


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
    if quirk:
        raise ValueError("pack_kernel: quirk=True has no CUDA kernel; the cost solve never uses it")
    out = _launch(vectors, counts, capacity, valid_types, prices, _MODES.index(mode), 1)
    return rounds_from_words(out[0], vectors.shape[0])


pack_kernel.launches = 0


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
    out = _launch(vectors, counts, capacity, valid_types, prices, 0, 2)
    num_groups = vectors.shape[0]
    return rounds_from_words(out[0], num_groups), rounds_from_words(out[1], num_groups)


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
MAX_LEVELS = 8  # constraints.ladder.MAX_LEVELS: K6 runs one block a level
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
    """How K6 lays one level's round loop over a block."""

    threads: int  # a multiple of 32; thread i owns types i + k * threads
    shared_bytes: int  # dynamic shared memory per block
    fills_in_shared: bool  # else [L, G, T] int32 of global scratch
    tables_in_shared: bool  # else [L, table words] int32 of global scratch
    placed_in_registers: bool  # else [L, W, threads] uint32 of global scratch


def levels_table_words(groups: int, types: int, dims: int) -> int:
    """Words of one block's tables (csrc/pack_levels.cu table_words): [G, R]
    vectors, five [G] tables, the [G, W] conflict rows and the [T] sums."""
    return groups * dims + 5 * groups + groups * (-(-groups // 32)) + types


def levels_launch_plan(groups: int, types: int, dims: int) -> LevelsLaunchPlan:
    """K6's launch plan, from the sizes alone: one type per thread up to
    1,024 threads, more a thread past that; the [G, T] fills in shared
    memory when the tables and fills fit SHARED_LIMIT, the tables alone
    when they do, else both in global scratch; the node's placed bits in
    registers up to G 256."""
    threads = min(MAX_THREADS, (types + 31) & ~31)
    storage = _shared_storage(4 * levels_table_words(groups, types, dims), 4 * groups * types)
    return LevelsLaunchPlan(threads, *storage, groups <= 256)


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
                   level_penalty, conflict, node_cap, mode: str) -> torch.Tensor:
    """One call of K6 (the level kernel, then the selection kernel).
    Returns its [level_pack_words] int32 output."""
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
    plan = levels_launch_plan(num_groups, num_types, dims)
    lib = LEVELS_LIBRARY.load()
    device = vectors.device
    bit_words = -(-num_groups // 32)
    level_words = lib.ktt_pack_levels_words(num_groups)
    level_out = torch.empty((num_levels, level_words), dtype=torch.int32, device=device)
    usable = torch.empty((num_levels, bit_words, num_types), dtype=torch.int32, device=device)
    fills = tables = placed = None
    if not plan.fills_in_shared:
        fills = torch.empty((num_levels, num_groups, num_types), dtype=torch.int32, device=device)
    if not plan.tables_in_shared:
        tables = torch.empty(
            (num_levels, levels_table_words(num_groups, num_types, dims)),
            dtype=torch.int32, device=device,
        )
    if not plan.placed_in_registers:
        placed = torch.empty((num_levels, bit_words, plan.threads), dtype=torch.int32, device=device)
    words = level_pack_words(num_groups, num_levels)
    out = torch.empty(words, dtype=torch.int32, device=device)
    select_blocks = max(1, min(132, -(-words // 1024)))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.ktt_pack_levels(
            *(tensor.data_ptr() for tensor in tensors),
            num_groups, num_types, dims, num_levels, _MODES.index(mode), plan.threads,
            select_blocks, level_out.data_ptr(),
            0 if fills is None else fills.data_ptr(),
            0 if tables is None else tables.data_ptr(), usable.data_ptr(),
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
# DEVICE at the tail of the fused solve and squeezes each candidate plan into
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
    round_fill cells, front-compacted by prefix sum. The reference's
    scatter drops indices past the entry budget (mode="drop"); here they all
    go to one extra slot past the budget, which is sliced off."""
    num_groups = rounds.round_fill.shape[1]
    budget = entry_budget(num_groups)
    device = rounds.round_fill.device
    flat = rounds.round_fill.reshape(-1)
    mask = flat != 0
    nnz = mask.sum(dtype=torch.int32)
    position = torch.cumsum(mask, dim=0) - 1
    dest = torch.where(mask, position, budget).clamp_(max=budget)
    entry_idx = torch.zeros(budget + 1, dtype=torch.int32, device=device)
    entry_idx.scatter_(
        0, dest, torch.arange(flat.shape[0], dtype=torch.int32, device=device)
    )
    entry_fill = torch.zeros(budget + 1, dtype=torch.int32, device=device)
    entry_fill.scatter_(0, dest, flat.to(torch.int32))
    return [
        rounds.round_type.to(torch.int32),
        rounds.round_repl.to(torch.int32),
        rounds.num_rounds.reshape(1).to(torch.int32),
        rounds.unschedulable.to(torch.int32),
        rounds.overflow.to(torch.int32).reshape(1),
        nnz.reshape(1),
        entry_idx[:budget],
        entry_fill[:budget],
    ]


def _compact_plan_ref(rounds_ffd: PackRounds, rounds_cost: PackRounds, feasible_any):
    """Plain version of K4, on any device: both candidate plans plus the
    feasibility vector as ONE flat int32 tensor."""
    return torch.cat(
        _compact_rounds(rounds_ffd)
        + _compact_rounds(rounds_cost)
        + [feasible_any.to(torch.int32)]
    )


def compact_plan(rounds_ffd: PackRounds, rounds_cost: PackRounds, feasible_any):
    """Both candidate plans plus the feasibility vector as ONE flat int32
    tensor — the eager device->host payload of a fused cost solve. K4
    (csrc/compact.cu, one launch) for CUDA tensors, the plain version for
    CPU tensors."""
    fields = [*rounds_ffd, *rounds_cost]
    device = feasible_any.device
    if any(tensor.device != device for tensor in fields):
        raise ValueError("compact_plan: every argument must lie on one device")
    if device.type == "cpu":
        return _compact_plan_ref(rounds_ffd, rounds_cost, feasible_any)
    if device.type != "cuda":
        raise ValueError(f"compact_plan: unsupported device {device}")
    if feasible_any.dtype != torch.bool or feasible_any.dim() != 1:
        raise TypeError("compact_plan kernel takes feasible_any as a [G] bool tensor")
    num_groups = feasible_any.shape[0]
    mr = max_rounds(num_groups)
    shapes = ((mr,), (mr, num_groups), (mr,), (), (num_groups,), ())
    for rounds in (rounds_ffd, rounds_cost):
        for name, tensor, shape in zip(PackRounds._fields, rounds, shapes):
            if tensor.dtype != torch.int32 or tuple(tensor.shape) != shape:
                raise ValueError(f"compact_plan kernel takes {name} as int32 {shape}")
    if not all(tensor.is_contiguous() for tensor in fields + [feasible_any]):
        raise ValueError("compact_plan kernel takes contiguous tensors")
    lib = COMPACT_LIBRARY.load()
    out = torch.empty(compact_words(num_groups), dtype=torch.int32, device=device)
    pointers = (ctypes.c_void_p * len(fields))(*(tensor.data_ptr() for tensor in fields))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.ktt_compact_plan(
            pointers, feasible_any.data_ptr(), num_groups, out.data_ptr(), stream
        )
    check_launch(status, "compact_plan")
    compact_plan.launches += 1
    return out


compact_plan.launches = 0


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


def reset_device_resident() -> None:
    """Test hook: drop every cached device tensor."""
    with _device_resident_lock:
        _DEVICE_RESIDENT.clear()
