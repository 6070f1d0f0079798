"""K9a: one shard's part of a step of the sharded LP relaxation.

The reference runs the LP relaxation (`lp_relax_body`,
karpenter_tpu/ops/score_kernel.py:77-135) over a device mesh by handing its
[G, T] tensors to GSPMD (`_sharded_fused_kernel`,
karpenter_tpu/models/solver.py:500-558; `sharded_lp_solve`,
karpenter_tpu/parallel/sharded_solver.py:136-178). The port splits one Adam
step at its cross-shard reductions into three phases on a shard's
[G/g, T/t] block, each one launch of csrc/lp_shard.cu:

  * `shard_softmax`: Adam on the block (from the last step's S, dS and row
    dot), then e = exp(where(F, L, -1e9) - ref) and the block's row max and
    row sum of e (reduced over the types axis);
  * `shard_demand`: S = e / total and the block's partial demand
    D = x^T v with x = where(F, c * S, 0) (reduced over the groups axis);
  * `shard_row_dot`: the smooth max's gradient dD per type, dS and the
    block's row dot sum_t S * dS (reduced over the types axis).

parallel/sharded_solver.py runs them over a mesh with the reductions of
parallel/collectives.py between. Each wrapper routes by where its tensors
lie: a CPU tensor goes to the plain version (`_softmax_ref`,
`_demand_ref`, `_row_dot_ref`), a CUDA tensor to the kernel; both update
the state in place. There is no fallback between them.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from karpenter_tpu_torch.ops.cuda_build import CudaLibrary, check_launch, launch_stream
from karpenter_tpu_torch.ops.score_kernel import (
    MAX_DIMS,
    _ADAM_EPS,
    _B1,
    _B2,
    _LEARNING_RATE,
    _SHARPNESS,
)

LIBRARY = CudaLibrary(
    "lp_shard.cu",
    {
        "ktt_lp_shard_softmax": (
            ctypes.c_int,
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3,
        ),
        "ktt_lp_shard_demand": (
            ctypes.c_int,
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3,
        ),
        "ktt_lp_shard_row_dot": (
            ctypes.c_int,
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2,
        ),
    },
)
_MASKED = -1e9
_CAPACITY_FLOOR = 1e-3


def _softmax_ref(logits, mu, nu, share, d_share, feasible, row_dot, ref, bias):
    """Plain version of the softmax phase, in place."""
    if bias is not None:
        grad = torch.where(feasible, share * (d_share - row_dot[:, None]), 0.0)
        # optax.scale_by_adam, then scale_by_learning_rate and apply_updates,
        # one rounded operation at a time (as ops/score_kernel.lp_relax_body).
        mu.copy_((1 - _B1) * grad + _B1 * mu)
        nu.copy_((1 - _B2) * (grad * grad) + _B2 * nu)
        mu_hat = mu / bias[0]
        nu_hat = nu / bias[1]
        logits.add_(-_LEARNING_RATE * (mu_hat / (torch.sqrt(nu_hat) + _ADAM_EPS)))
    masked = torch.where(feasible, logits, _MASKED)
    row_max = masked.amax(dim=1)
    if ref is None:
        return row_max, None
    share.copy_(torch.exp(masked - ref[:, None]))
    return row_max, share.sum(dim=1)


def _demand_ref(share, feasible, counts, vectors, row_total, assignment):
    """Plain version of the demand phase, in place."""
    share.div_(row_total[:, None])
    x = torch.where(feasible, counts[:, None] * share, 0.0)
    if assignment is not None:
        assignment.copy_(x)
    return torch.einsum("gt,gr->tr", x, vectors)


def _row_dot_ref(share, d_share, feasible, counts, vectors, capacity, prices, demand):
    """Plain version of the row-dot phase, in place."""
    clamped = torch.clamp(capacity, min=_CAPACITY_FLOOR)
    weight = torch.softmax(demand / clamped * _SHARPNESS, dim=1)
    d_demand = prices[:, None] * weight / clamped
    d_x = torch.einsum("tr,gr->gt", d_demand, vectors)
    d_share.copy_(torch.where(feasible, counts[:, None] * d_x, 0.0))
    return (share * d_share).sum(dim=1)


def _check_block(name: str, cells, rows, types_side=()) -> torch.device:
    """The shapes, dtypes and contiguity a phase takes; returns the device."""
    groups, types = cells[0].shape
    for tensor in cells:
        if tensor.shape != (groups, types):
            raise ValueError(f"{name}: every block must be [{groups}, {types}]")
    for tensor in rows:
        if tensor.shape[0] != groups:
            raise ValueError(f"{name}: a row table is not [{groups}, ...]")
    for tensor in types_side:
        if tensor.shape[0] != types:
            raise ValueError(f"{name}: a type table is not [{types}, ...]")
    tensors = (*cells, *rows, *types_side)
    for tensor in tensors:
        if tensor.dtype != (torch.bool if tensor is cells[-1] else torch.float32):
            raise TypeError(f"{name}: float32 blocks and tables and a bool mask, got {tensor.dtype}")
    device = cells[0].device
    if any(tensor.device != device for tensor in tensors):
        raise ValueError(f"{name}: every argument must lie on one device")
    if device.type == "cuda" and not all(tensor.is_contiguous() for tensor in tensors):
        raise ValueError(f"{name} kernel takes contiguous tensors")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")
    return device


def shard_softmax(
    logits: torch.Tensor,  # [G', T'] f32, updated in place
    mu: torch.Tensor,  # [G', T'] f32, updated in place
    nu: torch.Tensor,  # [G', T'] f32, updated in place
    share: torch.Tensor,  # [G', T'] f32: S in, e out
    d_share: torch.Tensor,  # [G', T'] f32: dS
    feasible: torch.Tensor,  # [G', T'] bool
    row_dot: Optional[torch.Tensor],  # [G'] f32, the last step's; None with bias None
    ref: Optional[torch.Tensor],  # [G'] f32, or None for the row max alone
    bias: Optional[torch.Tensor],  # [2] f32 (1 - b1**k, 1 - b2**k), or None: no Adam
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The softmax phase: (row max [G'], row sum of e [G'] or None)."""
    rows = [t for t in (row_dot, ref) if t is not None]
    device = _check_block(
        "shard_softmax", (logits, mu, nu, share, d_share, feasible), rows,
    )
    if bias is not None and (row_dot is None or bias.shape != (2,) or bias.device != device):
        raise ValueError("shard_softmax: Adam takes the last row dot and a [2] bias on the device")
    if device.type == "cpu":
        return _softmax_ref(logits, mu, nu, share, d_share, feasible, row_dot, ref, bias)
    groups, types = logits.shape
    lib = LIBRARY.load()
    out_max = torch.empty(groups, dtype=torch.float32, device=device)
    out_sum = None if ref is None else torch.empty(groups, dtype=torch.float32, device=device)
    operands = [logits, mu, nu, share, d_share, feasible, out_max] + rows + [
        t for t in (bias, out_sum) if t is not None
    ]

    def pointer(tensor):
        return 0 if tensor is None else tensor.data_ptr()

    with launch_stream("shard_softmax", operands) as stream:
        status = lib.ktt_lp_shard_softmax(
            logits.data_ptr(), mu.data_ptr(), nu.data_ptr(), share.data_ptr(),
            d_share.data_ptr(), feasible.data_ptr(), pointer(row_dot), pointer(ref),
            pointer(bias), groups, types, out_max.data_ptr(), pointer(out_sum), stream,
        )
    check_launch(status, "shard_softmax")
    shard_softmax.launches += 1
    return out_max, out_sum


shard_softmax.launches = 0


def shard_demand(
    share: torch.Tensor,  # [G', T'] f32: e in, S out
    feasible: torch.Tensor,  # [G', T'] bool
    counts: torch.Tensor,  # [G'] f32
    vectors: torch.Tensor,  # [G', R] f32
    row_total: torch.Tensor,  # [G'] f32
    assignment: Optional[torch.Tensor] = None,  # [G', T'] f32 out (x), or None
) -> torch.Tensor:
    """The demand phase: the block's partial D [T', R]."""
    cells = (share,) + (() if assignment is None else (assignment,)) + (feasible,)
    device = _check_block("shard_demand", cells, (counts, vectors, row_total))
    dims = vectors.shape[1]
    if device.type == "cpu":
        return _demand_ref(share, feasible, counts, vectors, row_total, assignment)
    if not 1 <= dims <= MAX_DIMS:
        raise ValueError(f"shard_demand kernel takes 1..{MAX_DIMS} axes")
    groups, types = share.shape
    lib = LIBRARY.load()
    demand = torch.empty((types, dims), dtype=torch.float32, device=device)
    operands = list(cells) + [counts, vectors, row_total, demand]
    with launch_stream("shard_demand", operands) as stream:
        status = lib.ktt_lp_shard_demand(
            share.data_ptr(), feasible.data_ptr(), counts.data_ptr(), vectors.data_ptr(),
            row_total.data_ptr(), groups, types, dims, demand.data_ptr(),
            0 if assignment is None else assignment.data_ptr(), stream,
        )
    check_launch(status, "shard_demand")
    shard_demand.launches += 1
    return demand


shard_demand.launches = 0


def shard_row_dot(
    share: torch.Tensor,  # [G', T'] f32: S
    d_share: torch.Tensor,  # [G', T'] f32: dS out
    feasible: torch.Tensor,  # [G', T'] bool
    counts: torch.Tensor,  # [G'] f32
    vectors: torch.Tensor,  # [G', R] f32
    capacity: torch.Tensor,  # [T', R] f32
    prices: torch.Tensor,  # [T'] f32
    demand: torch.Tensor,  # [T', R] f32, the reduced D
) -> torch.Tensor:
    """The row-dot phase: the block's partial row dot [G']."""
    device = _check_block(
        "shard_row_dot", (share, d_share, feasible), (counts, vectors), (capacity, prices, demand),
    )
    dims = vectors.shape[1]
    if capacity.shape[1] != dims or demand.shape[1] != dims:
        raise ValueError("shard_row_dot: vectors, capacity and demand take one axis count")
    if device.type == "cpu":
        return _row_dot_ref(share, d_share, feasible, counts, vectors, capacity, prices, demand)
    if not 1 <= dims <= MAX_DIMS:
        raise ValueError(f"shard_row_dot kernel takes 1..{MAX_DIMS} axes")
    groups, types = share.shape
    lib = LIBRARY.load()
    out_dot = torch.empty(groups, dtype=torch.float32, device=device)
    operands = [share, d_share, feasible, counts, vectors, capacity, prices, demand, out_dot]
    with launch_stream("shard_row_dot", operands) as stream:
        status = lib.ktt_lp_shard_row_dot(
            share.data_ptr(), d_share.data_ptr(), feasible.data_ptr(), counts.data_ptr(),
            vectors.data_ptr(), capacity.data_ptr(), prices.data_ptr(), demand.data_ptr(),
            groups, types, dims, out_dot.data_ptr(), stream,
        )
    check_launch(status, "shard_row_dot")
    shard_row_dot.launches += 1
    return out_dot


shard_row_dot.launches = 0


def launches() -> int:
    """K9a's launches so far, over its three phases."""
    return shard_softmax.launches + shard_demand.launches + shard_row_dot.launches


def reset_launches() -> None:
    shard_softmax.launches = shard_demand.launches = shard_row_dot.launches = 0
