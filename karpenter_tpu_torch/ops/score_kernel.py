"""Batched scoring + LP-relaxation solver, in plain PyTorch on the device.

The port of karpenter_tpu/ops/score_kernel.py. The cost-optimal packing
problem: choose per-type node counts n_t and pod assignments minimizing
sum_t n_t * price_t. Its continuous relaxation:

    x[g,t]  >= 0   pods of group g assigned to type t  (sum_t x = c_g)
    n_t     ~  max_r (sum_g x[g,t] * v[g,r]) / K[t,r]  (fractional nodes)
    minimize sum_t price_t * n_t

parameterized as x = c * softmax(logits) over feasible types and optimized
with Adam. Integerization (largest-remainder) and per-type greedy fills turn
the relaxed plan into real nodes on the host; the caller compares the result
against the other candidates and keeps the cheapest.

The gradient of `lp_objective` is written out in closed form
(`lp_gradient`); the optimizer is Adam in optax's order of operations
(torch.optim.Adam orders them differently), so the port follows the
reference's trajectory as closely as fp32 allows.

K3: on the card the whole relaxation, every Adam step and the hard-max
result, is one launch of a hand-written kernel (csrc/lp_relax.cu) over a
thread-block cluster behind `lp_relax`, laid out by `lp_launch_plan`;
`lp_relax_body` is its plain PyTorch version. `lp_relax` routes
by where its tensors lie: a CPU tensor goes to the plain version, a CUDA
tensor to the kernel. There is no fallback between them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from karpenter_tpu_torch.device import DeviceLike, resolve_device
from karpenter_tpu_torch.ops.cuda_build import CudaLibrary, check_launch, launch_stream

# optax.adam defaults, with the reference's learning rate.
_LEARNING_RATE = 0.25
_B1 = 0.9
_B2 = 0.999
_ADAM_EPS = 1e-8
_SHARPNESS = 20.0
MAX_DIMS = 8  # per-type registers in the kernel's column pass

LIBRARY = CudaLibrary(
    "lp_relax.cu",
    {
        "ktt_lp_relax_shared_bytes": (ctypes.c_longlong, [ctypes.c_int] * 8),
        "ktt_lp_relax_state_bytes": (ctypes.c_longlong, [ctypes.c_int] * 5),
        "ktt_lp_relax_table_bytes": (ctypes.c_longlong, [ctypes.c_int] * 6),
        "ktt_lp_relax": (
            ctypes.c_int,
            [ctypes.c_void_p] * 6
            + [ctypes.c_int] * 7
            + [ctypes.c_void_p] * 6,
        ),
    },
)
# Shared memory a block may use on sm_90 (227 KB), and the largest cluster
# (16 needs the non-portable attribute; 8 is the portable limit).
SHARED_LIMIT = 232_448
MAX_CLUSTER = 16
# Types a block of the cluster should own, and the threads a block may
# have: the cluster grows with T so that each block owns at most this many
# types, and the group lanes grow until the block has this many threads
# (at the main path's G 16 x T 512: 16 blocks of 512 threads, one cell
# each).
_TYPES_PER_BLOCK = 32
_THREADS = 512


class LPLaunchPlan(NamedTuple):
    """How K3 spreads one LP over a thread-block cluster."""

    cluster: int  # blocks in the cluster, 2..MAX_CLUSTER
    types_per_block: int  # block b owns types [b * TB, (b + 1) * TB)
    threads: int  # per block, a multiple of 32
    group_lanes: int  # Q: adjacent lanes of one type, each owning G / Q groups
    shared_bytes: int  # dynamic shared memory per block
    state_bytes: int  # one block's slice of the state
    state_in_shared: bool  # else cluster * state_bytes of global scratch
    # The group tables in shared memory, else table_bytes of global scratch
    # (the state is then in global scratch too).
    tables_in_shared: bool
    table_bytes: int

    @property
    def scratch_bytes(self) -> int:
        return 0 if self.state_in_shared else self.cluster * self.state_bytes

    def owner(self, t: int) -> int:
        """The cluster rank that owns type t."""
        return t // self.types_per_block


_MAX_DIMS_WORDS = MAX_DIMS + 1  # the requested axes and their count


def _round16(size: int) -> int:
    return (size + 15) & ~15


def _lp_layout(groups: int, dims: int, types_per_block: int, threads: int, group_lanes: int,
               cluster: int, tables_in_shared: bool = True):
    """(shared table bytes, state bytes) of one block: csrc/lp_relax.cu
    make_layout. Without the group tables in shared memory, the shared
    tables are only the per-type ones and the objective row."""
    warps = threads // 32
    per_type = types_per_block * dims + types_per_block + _MAX_DIMS_WORDS + types_per_block * MAX_DIMS
    words = per_type + cluster
    if tables_in_shared:
        words += groups * dims + groups + 2 * warps * groups + 3 * groups + 3 * cluster * groups
    type_slots = threads // group_lanes
    cells = (-(-types_per_block // type_slots)) * (-(-groups // group_lanes)) * threads
    return _round16(4 * words), _round16(cells * (5 * 4 + 1))


def lp_global_table_bytes(groups: int, dims: int, threads: int, cluster: int) -> int:
    """Global scratch of the group tables (csrc/lp_relax.cu
    global_table_bytes): per block the vectors, counts, the two [warps, G]
    reductions and three rows; one [cluster, G] and one [cluster, G, 2]
    exchange table for the cluster."""
    per_block = groups * dims + groups + 2 * (threads // 32) * groups + 3 * groups
    return 4 * cluster * (per_block + 3 * groups)


def lp_plan_for_cluster(groups: int, types: int, dims: int, cluster: int,
                        threads: int = _THREADS) -> LPLaunchPlan:
    """The plan at a given cluster size: Q doubles (up to 32 and up to G)
    while the block's types times Q stay within `threads`, and the block has
    at most `threads` threads; the state lives in shared memory when the
    block's tables and slice fit in SHARED_LIMIT. The tables alone may not
    fit (shared_bytes past SHARED_LIMIT): such a plan cannot launch."""
    if not 2 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"lp_relax: cluster of {cluster} blocks is outside 2..{MAX_CLUSTER}")
    types_per_block = -(-types // cluster)
    group_lanes = 1
    while group_lanes < 32 and group_lanes < groups and types_per_block * group_lanes * 2 <= threads:
        group_lanes *= 2
    block = min(threads, max(32, -(-types_per_block * group_lanes // 32) * 32))
    table, state = _lp_layout(groups, dims, types_per_block, block, group_lanes, cluster)
    in_shared = table + state <= SHARED_LIMIT
    shared = table + (state if in_shared else 0)
    return LPLaunchPlan(cluster, types_per_block, block, group_lanes, shared, state, in_shared, True, 0)


def _lp_plan_with_global_tables(groups: int, types: int, dims: int, cluster: int) -> LPLaunchPlan:
    """The plan at a cluster size with the group tables and the state in
    global scratch, _THREADS threads a block: only the per-type tables and
    the objective row stay in shared memory."""
    plan = lp_plan_for_cluster(groups, types, dims, cluster)
    table, _ = _lp_layout(groups, dims, plan.types_per_block, plan.threads, plan.group_lanes,
                          cluster, tables_in_shared=False)
    return plan._replace(
        shared_bytes=table, state_in_shared=False, tables_in_shared=False,
        table_bytes=lp_global_table_bytes(groups, dims, plan.threads, cluster),
    )


def lp_launch_plan(groups: int, types: int, dims: int) -> LPLaunchPlan:
    """K3's launch plan, from the sizes alone. The cluster is the smallest
    power of two (at least 2) whose blocks own at most _TYPES_PER_BLOCK
    types, doubled while the state does not fit the blocks' shared memory;
    the state goes to global scratch only when it does not fit at
    MAX_CLUSTER. Past that (hundreds of groups), the cluster halves and then
    the block's threads halve while the tables, which grow with both, do
    not fit either; where no plan holds the tables (thousands of groups),
    they go to global scratch with the state, at the preferred cluster and
    _THREADS threads. Every G and T gets a plan."""
    preferred = 2
    while preferred < MAX_CLUSTER and preferred * _TYPES_PER_BLOCK < types:
        preferred *= 2
    threads = _THREADS
    while True:
        plan = lp_plan_for_cluster(groups, types, dims, preferred, threads)
        while not plan.state_in_shared and plan.cluster < MAX_CLUSTER:
            plan = lp_plan_for_cluster(groups, types, dims, plan.cluster * 2, threads)
        while plan.shared_bytes > SHARED_LIMIT and plan.cluster > 2:
            plan = lp_plan_for_cluster(groups, types, dims, plan.cluster // 2, threads)
        if plan.shared_bytes <= SHARED_LIMIT:
            return plan
        if threads == 32:
            return _lp_plan_with_global_tables(groups, types, dims, preferred)
        threads //= 2


class LPResult(NamedTuple):
    assignment: torch.Tensor  # [G, T] float — relaxed pod counts
    fractional_nodes: torch.Tensor  # [T] float
    objective: torch.Tensor  # [] float — relaxed $/hr (lower bound-ish)


def feasibility_mask(vectors, capacity, valid_types) -> torch.Tensor:
    """[G, T] bool — can one pod of group g fit an empty node of type t."""
    fits = (vectors[:, None, :] <= capacity[None, :, :] + 1e-6).all(dim=-1)
    return fits & valid_types[None, :]


def lp_objective(
    logits: torch.Tensor,  # [G, T]
    vectors: torch.Tensor,  # [G, R]
    counts: torch.Tensor,  # [G] float
    capacity: torch.Tensor,  # [T, R]
    prices: torch.Tensor,  # [T]
    feasible: torch.Tensor,  # [G, T] bool
    sharpness: float = 20.0,
) -> torch.Tensor:
    # -1e9, not -inf: a row with no feasible type (count 0 after the caller
    # strips unschedulable groups) must softmax to finite garbage that the
    # count-multiply zeroes, not NaN-poison the whole objective.
    masked = torch.where(feasible, logits, -1e9)
    x = counts[:, None] * torch.softmax(masked, dim=1)  # [G, T]
    x = torch.where(feasible, x, 0.0)
    demand = torch.einsum("gt,gr->tr", x, vectors)  # [T, R]
    frac = demand / torch.clamp(capacity, min=1e-3)  # [T, R]
    # Smooth max over resource dims keeps gradients flowing to every binding
    # dimension; a hard max alone starves the non-binding ones.
    nodes = torch.logsumexp(frac * sharpness, dim=1) / sharpness  # [T]
    return torch.sum(prices * nodes)


def lp_gradient(
    logits: torch.Tensor,  # [G, T]
    vectors: torch.Tensor,  # [G, R]
    counts: torch.Tensor,  # [G] float
    capacity: torch.Tensor,  # [T, R]
    prices: torch.Tensor,  # [T]
    feasible: torch.Tensor,  # [G, T] bool
    sharpness: float = _SHARPNESS,
) -> torch.Tensor:
    """d lp_objective / d logits, in closed form (no autograd).

    Every mask is a select, never a multiply by 0/1: on infeasible and
    padded cells the intermediate terms may be inf or NaN (price * w / K on
    a type priced +inf), and the select drops them as the reference's
    jnp.where does."""
    share = torch.softmax(torch.where(feasible, logits, -1e9), dim=1)  # S [G, T]
    x = torch.where(feasible, counts[:, None] * share, 0.0)
    clamped = torch.clamp(capacity, min=1e-3)
    demand = torch.einsum("gt,gr->tr", x, vectors)  # D [T, R]
    # d nodes[t] / d frac[t, r]: the softmax over r of the smooth max.
    weight = torch.softmax(demand / clamped * sharpness, dim=1)  # w [T, R]
    d_demand = prices[:, None] * weight / clamped
    d_x = torch.einsum("tr,gr->gt", d_demand, vectors)
    d_share = torch.where(feasible, counts[:, None] * d_x, 0.0)
    dot = (share * d_share).sum(dim=1, keepdim=True)
    return torch.where(feasible, share * (d_share - dot), 0.0)


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay**count in float32, as optax computes it."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


def bias_corrections(steps: int) -> np.ndarray:
    """[steps, 2] float32: Adam's (1 - b1**k, 1 - b2**k) for k = 1..steps,
    the constants both the plain version and the kernel divide by."""
    return np.array(
        [[_bias_correction(_B1, k), _bias_correction(_B2, k)] for k in range(1, steps + 1)],
        dtype=np.float32,
    ).reshape(steps, 2)


def lp_relax_body(
    vectors,  # [G, R] f32
    counts,  # [G] i32/f32
    capacity,  # [T, R] f32
    valid_types,  # [T] bool
    prices,  # [T] f32
    steps: int = 300,
) -> LPResult:
    """The LP relaxation: `steps` Adam steps from a price-density start.
    The plain version of K3, on any device."""
    counts_f = counts.to(torch.float32)
    feasible = feasibility_mask(vectors, capacity, valid_types)
    # Initialize biased toward price-efficient types: -price per unit of the
    # type's bottleneck capacity.
    density = prices / torch.clamp(capacity.amax(dim=1), min=1.0)
    logits = (
        (-torch.log(density + 1e-9)).expand(feasible.shape).to(torch.float32).clone()
    )
    mu = torch.zeros_like(logits)
    nu = torch.zeros_like(logits)
    for bias_1, bias_2 in bias_corrections(steps).tolist():
        grad = lp_gradient(logits, vectors, counts_f, capacity, prices, feasible)
        # optax.scale_by_adam, then scale_by_learning_rate and apply_updates,
        # one rounded operation at a time.
        mu = (1 - _B1) * grad + _B1 * mu
        nu = (1 - _B2) * (grad * grad) + _B2 * nu
        mu_hat = mu / bias_1
        nu_hat = nu / bias_2
        update = -_LEARNING_RATE * (mu_hat / (torch.sqrt(nu_hat) + _ADAM_EPS))
        logits = logits + update

    masked = torch.where(feasible, logits, -1e9)
    x = counts_f[:, None] * torch.softmax(masked, dim=1)
    x = torch.where(feasible, x, 0.0)
    demand = torch.einsum("gt,gr->tr", x, vectors)
    nodes = (demand / torch.clamp(capacity, min=1e-3)).amax(dim=1)
    return LPResult(
        assignment=x,
        fractional_nodes=nodes,
        objective=torch.sum(prices * nodes),
    )


# The dtypes of lp_relax's arguments: vectors, counts, capacity, valid_types, prices.
_ARG_DTYPES = (torch.float32, torch.int32, torch.float32, torch.bool, torch.float32)


def _check_args(vectors, counts, capacity, valid_types, prices, steps) -> None:
    tensors = (vectors, counts, capacity, valid_types, prices)
    for name, tensor, dtype in zip(
        ("vectors", "counts", "capacity", "valid_types", "prices"), tensors, _ARG_DTYPES
    ):
        if tensor.dtype != dtype:
            raise TypeError(f"lp_relax: {name} must be {dtype}, got {tensor.dtype}")
        if tensor.device != vectors.device:
            raise ValueError("lp_relax: every argument must lie on one device")
    if vectors.dim() != 2 or capacity.dim() != 2:
        raise ValueError("lp_relax takes vectors [G, R] and capacity [T, R]")
    num_groups, dims = vectors.shape
    num_types = capacity.shape[0]
    if (
        counts.shape != (num_groups,)
        or capacity.shape != (num_types, dims)
        or valid_types.shape != (num_types,)
        or prices.shape != (num_types,)
    ):
        raise ValueError("lp_relax: inconsistent shapes")
    if isinstance(steps, bool) or not isinstance(steps, int) or steps < 0:
        raise ValueError(f"lp_relax: steps must be a non-negative int, got {steps!r}")


@functools.lru_cache(maxsize=16)
def _bias_table(steps: int, device: torch.device) -> torch.Tensor:
    """bias_corrections(steps) on the card, copied once per (steps, device)
    from pinned memory without a host sync."""
    table = torch.from_numpy(bias_corrections(max(steps, 1))).pin_memory()
    return table.to(device, non_blocking=True)


def lp_relax(
    vectors,  # [G, R] f32
    counts,  # [G] i32
    capacity,  # [T, R] f32
    valid_types,  # [T] bool
    prices,  # [T] f32
    steps: int = 300,
) -> LPResult:
    """The LP relaxation: the CUDA kernel (all `steps` Adam steps in one
    launch of one thread-block cluster) for CUDA tensors, the plain version
    for CPU tensors."""
    _check_args(vectors, counts, capacity, valid_types, prices, steps)
    if vectors.device.type == "cpu":
        return lp_relax_body(vectors, counts, capacity, valid_types, prices, steps=steps)
    if vectors.device.type != "cuda":
        raise ValueError(f"lp_relax: unsupported device {vectors.device}")
    num_groups, dims = vectors.shape
    if num_groups == 0 or capacity.shape[0] == 0 or dims == 0 or dims > MAX_DIMS:
        raise ValueError(f"lp_relax kernel takes G, T >= 1 and 1..{MAX_DIMS} axes")
    plan = lp_launch_plan(num_groups, capacity.shape[0], dims)
    return _launch(vectors, counts, capacity, valid_types, prices, steps, plan)


def _launch(vectors, counts, capacity, valid_types, prices, steps: int, plan: LPLaunchPlan) -> LPResult:
    """One launch of K3 with the given plan."""
    if plan.shared_bytes > SHARED_LIMIT:
        raise ValueError(f"lp_relax: the plan asks for {plan.shared_bytes} bytes of shared memory")
    tensors = (vectors, counts, capacity, valid_types, prices)
    if not all(tensor.is_contiguous() for tensor in tensors):
        raise ValueError("lp_relax kernel takes contiguous tensors")
    num_groups, dims = vectors.shape
    num_types = capacity.shape[0]
    lib = LIBRARY.load()
    device = vectors.device
    bias = _bias_table(steps, device)
    assignment = torch.empty((num_groups, num_types), dtype=torch.float32, device=device)
    nodes = torch.empty(num_types, dtype=torch.float32, device=device)
    objective = torch.empty((), dtype=torch.float32, device=device)
    scratch = tables = None
    if not plan.state_in_shared:
        scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8, device=device)
    if not plan.tables_in_shared:
        tables = torch.empty(plan.table_bytes // 4, dtype=torch.float32, device=device)
    outputs = [bias, assignment, nodes, objective] + [t for t in (scratch, tables) if t is not None]
    with launch_stream("lp_relax", tensors + tuple(outputs)) as stream:
        status = lib.ktt_lp_relax(
            *(tensor.data_ptr() for tensor in tensors), bias.data_ptr(),
            num_groups, num_types, dims, steps, plan.cluster, plan.threads, plan.group_lanes,
            assignment.data_ptr(), nodes.data_ptr(), objective.data_ptr(),
            0 if scratch is None else scratch.data_ptr(),
            0 if tables is None else tables.data_ptr(), stream,
        )
    check_launch(status, "lp_relax")
    lp_relax.launches += 1
    return LPResult(assignment=assignment, fractional_nodes=nodes, objective=objective)


lp_relax.launches = 0


def lp_relax_solve(
    vectors,  # [G, R] f32
    counts,  # [G] i32
    capacity,  # [T, R] f32
    valid_types,  # [T] bool
    prices,  # [T] f32
    steps: int = 300,
    device: DeviceLike = None,
) -> LPResult:
    """The LP relaxation on bare arrays (numpy or tensors), K3's own entry:
    the arguments go to `device` in lp_relax's dtypes, then one launch of K3
    on the card, or its plain version with device="cpu". None means the
    card, and raises without one."""
    device = resolve_device(device)
    args = [
        torch.as_tensor(array, dtype=dtype, device=device).contiguous()
        for array, dtype in zip((vectors, counts, capacity, valid_types, prices), _ARG_DTYPES)
    ]
    return lp_relax(*args, steps=steps)


def round_assignment(assignment: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Largest-remainder rounding of [G, T] relaxed assignment so each group's
    row sums exactly to counts[g]. Returns int64 [G, T]."""
    assignment = np.asarray(assignment, dtype=np.float64)
    counts = np.asarray(counts, dtype=np.int64)
    out = np.floor(assignment).astype(np.int64)
    for g in range(assignment.shape[0]):
        deficit = int(counts[g] - out[g].sum())
        if deficit <= 0:
            # Over-assignment can only come from float error; trim greedily
            # from the smallest fractional cells.
            while out[g].sum() > counts[g]:
                candidates = np.nonzero(out[g] > 0)[0]
                out[g, candidates[np.argmin(assignment[g, candidates])]] -= 1
            continue
        remainders = assignment[g] - np.floor(assignment[g])
        order = np.argsort(-remainders)
        for t in order[:deficit]:
            out[g, t] += 1
    return out
