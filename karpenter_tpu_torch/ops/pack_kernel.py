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

All shapes are padded: G -> groups (counts 0), T -> types (valid mask).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from karpenter_tpu_torch.ops.cuda_build import CudaLibrary, check_launch

_EPS = 1e-4
_INT32_MAX = 2**31 - 1
# n_fit is clamped before its int32 conversion (the reference's conversion
# saturates an all-zero vector's +inf); any bound above every real count
# gives the same min(count, n_fit).
_FIT_CLAMP = float(2**30)
MAX_DIMS = 8  # remaining-capacity registers per thread in the kernel
MAX_GROUPS = 1024  # shared-memory bound of the kernel's group tables
_MODES = ("ffd", "cost")

LIBRARY = CudaLibrary(
    "pack_rounds.cu",
    {
        "ktt_pack_rounds_words": (ctypes.c_int, [ctypes.c_int]),
        "ktt_pack_rounds_shared_bytes": (
            ctypes.c_longlong,
            [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int],
        ),
        "ktt_pack_rounds": (
            ctypes.c_int,
            [ctypes.c_void_p] * 5
            + [ctypes.c_int] * 7
            + [ctypes.c_void_p] * 3,
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
# have, and the types a thread may own.
SHARED_LIMIT = 232_448
MAX_THREADS = 1024
_TYPES_PER_THREAD = (1, 2, 4)
MAX_TYPES = MAX_THREADS * _TYPES_PER_THREAD[-1]
# csrc/pack_rounds.cu's Control words at the front of shared memory.
_CONTROL_BYTES = 32


class PackLaunchPlan(NamedTuple):
    """How K2 lays one mode's round loop over a block."""

    threads: int  # a multiple of 32
    types_per_thread: int  # thread i owns types i + k * threads, k < this
    shared_bytes: int  # dynamic shared memory per block
    fills_in_shared: bool  # else [modes, G, T] int32 of global scratch

    def owner(self, t: int) -> int:
        """The thread that owns type t."""
        return t % self.threads


def pack_launch_plan(groups: int, types: int, dims: int) -> PackLaunchPlan:
    """K2's launch plan, from the sizes alone: one type per thread while T
    fits one block (1,024 threads), else 2 or 4; the [G, T] fills in shared
    memory when the block's tables and fills fit SHARED_LIMIT, else in
    global scratch."""
    if types > MAX_TYPES:
        raise ValueError(f"pack_kernel kernel takes at most {MAX_TYPES} types")
    per_thread = next(k for k in _TYPES_PER_THREAD if -(-types // k) <= MAX_THREADS)
    threads = (-(-types // per_thread) + 31) & ~31
    tables = _CONTROL_BYTES + 4 * (groups * dims + groups) + 4 * (2 * groups + types)
    in_shared = tables + 4 * groups * types <= SHARED_LIMIT
    shared = tables + (4 * groups * types if in_shared else 0)
    return PackLaunchPlan(threads, per_thread, shared, in_shared)


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
    for g in range(num_groups):
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
            # fills @ group_weight as a sequential fp32 sum over ascending g,
            # the order the kernel takes it in.
            weighted = torch.zeros(num_types, dtype=torch.float32, device=device)
            for g in range(num_groups):
                weighted = weighted + fills[:, g].to(torch.float32) * group_weight[g]
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
    if dims > MAX_DIMS or num_groups > MAX_GROUPS:
        raise ValueError(
            f"pack_kernel kernel takes at most {MAX_DIMS} axes and {MAX_GROUPS} groups"
        )
    tensors = (vectors, counts, capacity, valid_types, prices)
    if not all(tensor.is_contiguous() for tensor in tensors):
        raise ValueError("pack_kernel kernel takes contiguous tensors")
    plan = pack_launch_plan(num_groups, num_types, dims)
    lib = LIBRARY.load()
    words = lib.ktt_pack_rounds_words(num_groups)
    out = torch.empty((num_modes, words), dtype=torch.int32, device=vectors.device)
    scratch = None
    if not plan.fills_in_shared:
        scratch = torch.empty(
            (num_modes, num_groups, num_types), dtype=torch.int32, device=vectors.device
        )
    with torch.cuda.device(vectors.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.ktt_pack_rounds(
            *(tensor.data_ptr() for tensor in tensors),
            num_groups, num_types, dims, first_mode, num_modes,
            plan.threads, plan.types_per_thread,
            out.data_ptr(), 0 if scratch is None else scratch.data_ptr(), stream,
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
