"""Peaks of the card and the work the solve's kernels need, counted from the
problem's real sizes (groups that hold pods, instance types kept), never from
the padded shapes a kernel happens to launch at.

Peaks: NVIDIA's data sheet for the H100 SXM, dense rates: 67 TFLOP/s in
float32 outside the tensor cores, 3.35 TB/s of HBM. `lp_operations` is a copy
of chip_smoke.py's.
"""

from __future__ import annotations

from typing import Sequence

FP32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
LP_STEPS = 300  # CostSolver's default, which the window runs
F32 = I32 = 4


def lp_operations(groups: int, types: int, dims: int, steps: int = LP_STEPS) -> int:
    """fp32 operations of the LP relaxation, counting exp, log, square root
    and division as one each. Per step and cell (g, t): the masked softmax
    (select, max, subtract, exp, add, divide: 6), x = c * S (1), its share of
    D (2 per axis), dx and dS (2 per axis, 1), the row dot (2), the softmax
    backward (2) and Adam (16); per type and axis: f, the scaled smooth max,
    w and dD (9). The start takes about 4 per type plus 2 per axis and cell
    for the mask; the result a softmax, x and D again plus the max and the
    objective."""
    cells = groups * types
    per_step = cells * (6 + 1 + 2 * dims + 2 * dims + 1 + 2 + 2 + 16) + types * dims * 9
    start = types * (dims + 4) + cells * (2 * dims + 6)
    result = cells * (6 + 1 + 2 * dims) + types * (2 * dims + 2)
    return steps * per_step + start + result


def lp_bytes(groups: int, types: int, dims: int) -> int:
    """Each input read once (vectors, counts, capacity, valid, prices) and
    each output written once (the [G, T] assignment, the objective)."""
    return groups * dims * F32 + groups * I32 + types * (dims * F32 + 1 + F32) + groups * types * F32 + F32


def pack_operations(cells: int, types: int, rounds: int, groups: int, dims: int, cost_mode: bool) -> int:
    """Operations of one pack mode (K2's round loop), given `cells`, the sum
    over its rounds of the groups still holding pods. Per type and such
    group: a division and a select per axis, the minimum over the axes
    (3 per axis), the floor, the epsilon, the clamp and the cast (4), the
    allowed test (3), the min with the count and its select (2), the
    remaining capacity (2 per axis), the failed test (2), the fill's sum (1);
    the cost mode weighs it too (2). Per round and type the choice of type
    (2); per round and group the counts' update (2)."""
    per_cell = 5 * dims + 12 + (2 if cost_mode else 0)
    return types * cells * per_cell + rounds * (2 * types + 2 * groups)


def pack_bytes(groups: int, types: int, dims: int, rounds: Sequence[int]) -> int:
    """The inputs read once (vectors, counts, capacity, total, valid,
    prices) and each mode's rounds written once (type, fill, replication)
    with its unschedulable counts."""
    inputs = groups * (dims * F32 + I32) + types * (2 * dims * F32 + 1 + F32)
    return inputs + sum(r * (groups + 2) * I32 + groups * I32 for r in rounds)


def bound_seconds(operations: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(operations / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
