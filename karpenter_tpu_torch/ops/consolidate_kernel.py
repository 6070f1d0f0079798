"""K7, consolidation's batched counterfactual solve: the port of the
reference's `_counterfactual_body` (karpenter_tpu/ops/consolidate.py, an XLA
program: a lax.scan over the pod groups, the replace leg's feasibility, the
savings and an argmax).

On the card it is csrc/consolidate.cu: one block per candidate runs the
group scan, the replace leg and the savings, and a second small launch takes
the argmax over candidates and copies the winner's [G, N] plan row into the
eager buffer that the host fetches. `_counterfactual_ref` is its plain
PyTorch version, a line-for-line transcription of the reference. A CPU tensor
goes to the plain version, a CUDA tensor to the kernel; there is no fallback.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from karpenter_tpu_torch.ops.cuda_build import CudaLibrary, check_launch
from karpenter_tpu_torch.ops.score_kernel import feasibility_mask

# Savings below this ($/hr) are noise, not a reason to disrupt a node.
MIN_SAVINGS_DOLLARS = 1e-6
MAX_DIMS = 8  # resource axes the kernel tracks per bin
# A candidate's room stays in shared memory up to this many bytes per block
# (the card allows 227 KB); past it, in a global scratch buffer.
_SHARED_ROOM_LIMIT = 200 * 1024
# Partial sums of whole numbers are exact in float32 below 2**24.
_EXACT_SUM = float(2**24)

LIBRARY = CudaLibrary(
    "consolidate.cu",
    {
        "ktt_consolidate_threads": (ctypes.c_int, [ctypes.c_int]),
        "ktt_consolidate_room_words": (ctypes.c_longlong, [ctypes.c_int, ctypes.c_int]),
        "ktt_consolidate": (
            ctypes.c_int,
            [ctypes.c_void_p] * 9
            + [ctypes.c_int] * 6
            + [ctypes.c_longlong]
            + [ctypes.c_void_p] * 5,
        ),
    },
)


def _fold_cumsum(fit: torch.Tensor) -> torch.Tensor:
    """jnp.cumsum(fit, axis=1) as the reference computes it on the CPU: a
    sequential float32 fold along the bins. fit holds whole numbers >= 0, so
    a row whose total stays below 2**24 has exact partial sums in any order
    (taken here in float64); a longer row is folded bin by bin in float32."""
    inclusive = torch.cumsum(fit.to(torch.float64), dim=1)
    out = inclusive.to(torch.float32)
    wide = inclusive[:, -1] >= _EXACT_SUM
    if bool(wide.any()):
        rows = fit[wide]
        acc = torch.zeros(rows.shape[0], dtype=torch.float32, device=fit.device)
        folded = []
        for n in range(rows.shape[1]):
            acc = acc + rows[:, n]
            folded.append(acc)
        out[wide] = torch.stack(folded, dim=1)
    return out


def _counterfactual_ref(
    pod_vectors, pod_counts, headroom, bin_mask, type_capacity, type_prices,
    type_valid, node_prices, cand_valid,
):
    """Plain version of K7, on any device: the reference's
    `_counterfactual_body` line for line. Delete leg: batched first-fit-
    decreasing fill of the [C, N, R] masked headroom (groups arrive
    FFD-sorted; per group the cumulative-sum cutoff distributes the count
    across bins in row order). Replace leg: feasibility_mask over the [C, R]
    total demand. Tail: the float32 savings and the device argmax that picks
    the winner's [G, N] row."""
    counts = pod_counts.to(torch.float32)
    room = torch.where(bin_mask[:, :, None], headroom[None, :, :], 0.0)
    takes = []
    for g in range(pod_vectors.shape[1]):
        vec = pod_vectors[:, g, :]  # [C, R]
        cnt = counts[:, g]  # [C]
        positive = vec > 0
        ratio = torch.where(
            positive[:, None, :],
            room / torch.clamp(vec[:, None, :], min=1e-9),
            torch.inf,
        )  # [C, N, R]
        fit = torch.floor(ratio.amin(dim=2) + 1e-6)  # [C, N]
        # A group with an all-zero vector (padded rows) fits anywhere.
        fit = torch.where(torch.isinf(fit), cnt[:, None], fit)
        fit = torch.clamp(fit, min=0.0)
        before = _fold_cumsum(fit) - fit
        take = torch.minimum(torch.clamp(cnt[:, None] - before, min=0.0), fit)  # [C, N]
        # Two rounded fp32 operations, never a fused multiply-add.
        room = room - take[:, :, None] * vec[:, None, :]
        takes.append(take)
    takes = torch.stack(takes, dim=1)  # [C, G, N]
    placed = takes.sum(dim=2)  # [C, G]
    delete_ok = (placed >= counts - 0.5).all(dim=1)

    # Total demand, summed over the groups in ascending order.
    demand = torch.zeros_like(pod_vectors[:, 0, :])
    for g in range(pod_vectors.shape[1]):
        demand = demand + pod_vectors[:, g, :] * counts[:, g, None]  # [C, R]
    fits = feasibility_mask(
        demand, type_capacity,
        torch.ones(type_capacity.shape[0], dtype=torch.bool, device=demand.device),
    )  # [C, T]
    fits = fits & type_valid
    priced = torch.where(fits, type_prices[None, :], torch.inf)
    replace_price = priced.amin(dim=1)
    replace_type = torch.argmin(priced, dim=1)  # first index of the minimum

    minimum = torch.tensor(MIN_SAVINGS_DOLLARS, dtype=torch.float32, device=demand.device)
    savings_delete = torch.where(delete_ok & cand_valid, node_prices, -torch.inf)
    margin = node_prices - replace_price
    savings_replace = torch.where(
        torch.isfinite(replace_price) & (margin > minimum) & cand_valid,
        margin,
        -torch.inf,
    )
    best = torch.argmax(torch.maximum(savings_delete, savings_replace))
    best_take = takes[best]  # [G, N]
    return (
        takes.to(torch.int32),
        delete_ok,
        replace_type.to(torch.int32),
        replace_price,
        best.to(torch.int32),
        best_take.to(torch.int32),
    )


def eager_words(num_candidates: int, num_groups: int, num_bins: int) -> int:
    """int32 words of the eager buffer for padded (C, G, N): delete_ok,
    replace_type and replace_price's bits ([C] each), best, the winner's
    [G, N] row."""
    return 3 * num_candidates + 1 + num_groups * num_bins


def _eager_from_outputs(delete_ok, replace_type, replace_price, best, best_take):
    """The plain version's outputs in the kernel's eager-buffer layout."""
    return torch.cat([
        delete_ok.to(torch.int32),
        replace_type,
        replace_price.view(torch.int32),
        best.reshape(1),
        best_take.reshape(-1),
    ])


def split_eager(words: np.ndarray, num_candidates: int, num_groups: int, num_bins: int):
    """Host view of an eager buffer for padded (C, G, N): (delete_ok,
    replace_type, replace_price, best, best_take) in the reference's dtypes."""
    c = num_candidates
    return (
        words[:c].astype(bool),
        words[c : 2 * c],
        words[2 * c : 3 * c].view(np.float32),
        words[3 * c],
        words[3 * c + 1 :].reshape(num_groups, num_bins),
    )


_OPERANDS = (
    ("pod_vectors", torch.float32, 3),
    ("pod_counts", torch.int32, 2),
    ("headroom", torch.float32, 2),
    ("bin_mask", torch.bool, 2),
    ("type_capacity", torch.float32, 2),
    ("type_prices", torch.float32, 1),
    ("type_valid", torch.bool, 2),
    ("node_prices", torch.float32, 1),
    ("cand_valid", torch.bool, 1),
)


def requested_axes(pod_vectors: np.ndarray) -> int:
    """The most axes on which one candidate's groups request a positive
    amount, from the host's [C, G, R] pod_vectors: the kernel's room holds
    only these axes, so the wrapper sizes it from this count."""
    if pod_vectors.size == 0:
        return 0
    return int((pod_vectors > 0).any(axis=1).sum(axis=1).max())


def _check_args(operands) -> None:
    device = operands[0].device
    for (name, dtype, ndim), tensor in zip(_OPERANDS, operands):
        if tensor.dtype != dtype:
            raise TypeError(f"solve_counterfactuals: {name} must be {dtype}, got {tensor.dtype}")
        if tensor.dim() != ndim:
            raise ValueError(f"solve_counterfactuals: {name} must have {ndim} dimensions")
        if tensor.device != device:
            raise ValueError("solve_counterfactuals: every argument must lie on one device")
    pod_vectors, pod_counts, headroom, bin_mask, type_capacity, type_prices, type_valid, node_prices, cand_valid = operands
    num_candidates, num_groups, dims = pod_vectors.shape
    num_bins = headroom.shape[0]
    num_types = type_capacity.shape[0]
    if (
        pod_counts.shape != (num_candidates, num_groups)
        or headroom.shape != (num_bins, dims)
        or bin_mask.shape != (num_candidates, num_bins)
        or type_capacity.shape != (num_types, dims)
        or type_prices.shape != (num_types,)
        or type_valid.shape != (num_candidates, num_types)
        or node_prices.shape != (num_candidates,)
        or cand_valid.shape != (num_candidates,)
    ):
        raise ValueError("solve_counterfactuals: inconsistent shapes")


def solve_counterfactuals(
    pod_vectors,  # [C, G, R] f32
    pod_counts,  # [C, G] i32
    headroom,  # [N, R] f32
    bin_mask,  # [C, N] bool
    type_capacity,  # [T, R] f32
    type_prices,  # [T] f32
    type_valid,  # [C, T] bool
    node_prices,  # [C] f32
    cand_valid,  # [C] bool
    axes=None,  # requested_axes(pod_vectors) from the host; None for all R
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7: (takes [C, G, N] int32, eager [eager_words(C, G, N)] int32). The
    CUDA kernel for CUDA tensors, the plain version for CPU tensors. The
    kernel sizes each candidate's room for `axes` axes; a candidate that
    requests more leaves best = -1 in the eager buffer."""
    operands = (
        pod_vectors, pod_counts, headroom, bin_mask, type_capacity, type_prices,
        type_valid, node_prices, cand_valid,
    )
    _check_args(operands)
    dims = pod_vectors.shape[2]
    axes = dims if axes is None else axes
    if not 0 <= axes <= dims:
        raise ValueError(f"solve_counterfactuals: axes must be in 0..{dims}, got {axes}")
    device = pod_vectors.device
    if device.type == "cpu":
        takes, *columns = _counterfactual_ref(*operands)
        return takes, _eager_from_outputs(*columns)
    if device.type != "cuda":
        raise ValueError(f"solve_counterfactuals: unsupported device {device}")
    num_candidates, num_groups, dims = pod_vectors.shape
    num_bins = headroom.shape[0]
    num_types = type_capacity.shape[0]
    if min(num_candidates, num_groups, dims, num_bins, num_types) == 0 or dims > MAX_DIMS:
        raise ValueError(f"solve_counterfactuals kernel takes 1..{MAX_DIMS} axes and C, G, N, T >= 1")
    if not all(tensor.is_contiguous() for tensor in operands):
        raise ValueError("solve_counterfactuals kernel takes contiguous tensors")
    lib = LIBRARY.load()
    takes = torch.empty((num_candidates, num_groups, num_bins), dtype=torch.int32, device=device)
    eager = torch.empty(eager_words(num_candidates, num_groups, num_bins), dtype=torch.int32, device=device)
    savings = torch.empty(num_candidates, dtype=torch.float32, device=device)
    # The room takes threads x room_words floats per candidate at the most;
    # it stays in shared memory when that fits.
    threads = lib.ktt_consolidate_threads(num_bins)
    room_bytes = 4 * threads * lib.ktt_consolidate_room_words(num_bins, axes)
    shared = min(room_bytes, _SHARED_ROOM_LIMIT)
    scratch = None
    if room_bytes > _SHARED_ROOM_LIMIT:
        scratch = torch.empty(num_candidates * room_bytes // 4, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.ktt_consolidate(
            *(tensor.data_ptr() for tensor in operands),
            num_candidates, num_groups, dims, num_bins, num_types, axes, shared,
            takes.data_ptr(), eager.data_ptr(), savings.data_ptr(),
            0 if scratch is None else scratch.data_ptr(), stream,
        )
    check_launch(status, "solve_counterfactuals")
    solve_counterfactuals.launches += 1
    return takes, eager


solve_counterfactuals.launches = 0


