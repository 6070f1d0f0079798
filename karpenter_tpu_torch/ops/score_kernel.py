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
result, is one launch of a hand-written kernel (csrc/lp_relax.cu) behind
`lp_relax`; `lp_relax_body` is its plain PyTorch version. `lp_relax` routes
by where its tensors lie: a CPU tensor goes to the plain version, a CUDA
tensor to the kernel. There is no fallback between them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from karpenter_tpu_torch.ops.cuda_build import CudaLibrary, check_launch

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
        "ktt_lp_relax_workspace_bytes": (
            ctypes.c_longlong, [ctypes.c_int, ctypes.c_int, ctypes.c_int],
        ),
        "ktt_lp_relax": (
            ctypes.c_int,
            [ctypes.c_void_p] * 6
            + [ctypes.c_int] * 4
            + [ctypes.c_void_p] * 5,
        ),
    },
)
# The state stays in shared memory up to this many bytes (the card allows
# 227 KB per block); past it, in a global scratch buffer.
_SHARED_STATE_LIMIT = 200 * 1024


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


def _check_args(vectors, counts, capacity, valid_types, prices, steps) -> None:
    tensors = (vectors, counts, capacity, valid_types, prices)
    dtypes = (torch.float32, torch.int32, torch.float32, torch.bool, torch.float32)
    for name, tensor, dtype in zip(
        ("vectors", "counts", "capacity", "valid_types", "prices"), tensors, dtypes
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
    launch) for CUDA tensors, the plain version for CPU tensors."""
    _check_args(vectors, counts, capacity, valid_types, prices, steps)
    if vectors.device.type == "cpu":
        return lp_relax_body(vectors, counts, capacity, valid_types, prices, steps=steps)
    if vectors.device.type != "cuda":
        raise ValueError(f"lp_relax: unsupported device {vectors.device}")
    num_groups, dims = vectors.shape
    num_types = capacity.shape[0]
    if num_groups == 0 or num_types == 0 or dims == 0 or dims > MAX_DIMS:
        raise ValueError(f"lp_relax kernel takes G, T >= 1 and 1..{MAX_DIMS} axes")
    tensors = (vectors, counts, capacity, valid_types, prices)
    if not all(tensor.is_contiguous() for tensor in tensors):
        raise ValueError("lp_relax kernel takes contiguous tensors")
    lib = LIBRARY.load()
    device = vectors.device
    bias = _bias_table(steps, device)
    assignment = torch.empty((num_groups, num_types), dtype=torch.float32, device=device)
    nodes = torch.empty(num_types, dtype=torch.float32, device=device)
    objective = torch.empty((), dtype=torch.float32, device=device)
    workspace = lib.ktt_lp_relax_workspace_bytes(num_groups, num_types, dims)
    scratch = None
    if workspace > _SHARED_STATE_LIMIT:
        scratch = torch.empty(workspace, dtype=torch.uint8, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.ktt_lp_relax(
            *(tensor.data_ptr() for tensor in tensors), bias.data_ptr(),
            num_groups, num_types, dims, steps,
            assignment.data_ptr(), nodes.data_ptr(), objective.data_ptr(),
            0 if scratch is None else scratch.data_ptr(), stream,
        )
    check_launch(status, "lp_relax")
    lp_relax.launches += 1
    return LPResult(assignment=assignment, fractional_nodes=nodes, objective=objective)


lp_relax.launches = 0


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
