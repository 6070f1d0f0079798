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

The gradient comes from autograd on `lp_objective`; the optimizer is Adam
written out in optax's order of operations (torch.optim.Adam orders them
differently), so the port follows the reference's trajectory as closely as
fp32 allows.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# optax.adam defaults, with the reference's learning rate.
_LEARNING_RATE = 0.25
_B1 = 0.9
_B2 = 0.999
_ADAM_EPS = 1e-8


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


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay**count in float32, as optax computes it."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


def lp_relax_body(
    vectors,  # [G, R] f32
    counts,  # [G] i32/f32
    capacity,  # [T, R] f32
    valid_types,  # [T] bool
    prices,  # [T] f32
    steps: int = 300,
) -> LPResult:
    """The LP relaxation: `steps` Adam steps from a price-density start."""
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
    for step in range(1, steps + 1):
        logits.requires_grad_(True)
        objective = lp_objective(logits, vectors, counts_f, capacity, prices, feasible)
        (grad,) = torch.autograd.grad(objective, logits)
        logits = logits.detach()
        with torch.no_grad():
            # optax.scale_by_adam, then scale_by_learning_rate and
            # apply_updates, one rounded operation at a time.
            mu = (1 - _B1) * grad + _B1 * mu
            nu = (1 - _B2) * (grad * grad) + _B2 * nu
            mu_hat = mu / _bias_correction(_B1, step)
            nu_hat = nu / _bias_correction(_B2, step)
            update = -_LEARNING_RATE * (mu_hat / (torch.sqrt(nu_hat) + _ADAM_EPS))
            logits = logits + update

    with torch.no_grad():
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
