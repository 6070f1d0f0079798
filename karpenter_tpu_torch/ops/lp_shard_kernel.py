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

parallel/sharded_solver.py runs them over a mesh that spans cards, with
the reductions of parallel/collectives.py between. Each wrapper routes by
where its tensors lie: a CPU tensor goes to the plain version
(`_softmax_ref`, `_demand_ref`, `_row_dot_ref`), a CUDA tensor to the
kernel; both update the state in place. There is no fallback between them.

A mesh whose shards all lie on one card takes `shard_lp` instead: the
whole LP (the first row max, every Adam step, the final pass) as one
cooperative launch of csrc/lp_shard.cu's persistent kernel, its blocks each
owning a tile of one shard's block, laid out by `lp_shard_launch_plan`. It
takes CUDA tensors only: its plain version is the per-phase route through
the plain versions above, which a mesh on the CPU takes
(parallel/sharded_solver._route).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from karpenter_tpu_torch.ops.cuda_build import CudaLibrary, check_launch, launch_stream
from karpenter_tpu_torch.ops.score_kernel import (
    MAX_DIMS,
    SHARED_LIMIT,
    _ADAM_EPS,
    _B1,
    _B2,
    _LEARNING_RATE,
    _SHARPNESS,
    _round16,
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
        "ktt_lp_shard_persistent_shared_bytes": (ctypes.c_longlong, [ctypes.c_int] * 4),
        "ktt_lp_shard_persistent": (
            ctypes.c_int,
            [ctypes.c_void_p] * 17 + [ctypes.c_int] * 11 + [ctypes.c_void_p],
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


# --- the persistent route: the whole LP in one launch -----------------------

H100_SMS = 132  # streaming multiprocessors of an H100: the plan's default off the card
PERSIST_THREADS = 256
_WARPS = PERSIST_THREADS // 32
# Cells a tile aims at (four a thread), and the widest tile before a
# shard's columns are cut: at most one block an SM, so the grid is few
# enough blocks that a grid-wide barrier stays cheap.
_TILE_CELLS = 1024
_MAX_TILE_COLS = 256
_MIN_TILE_COLS = 32


class LPShardPlan(NamedTuple):
    """How the persistent K9a kernel spreads an LP over a grid of blocks:
    each shard's [rows, cols] block is cut into row_tiles x col_tiles
    tiles of tile_rows x tile_cols cells (the last ones ragged), a block
    each, for the whole LP."""

    shards: int
    rows: int  # one shard's block: G / mesh rows
    cols: int  # T / mesh columns
    dims: int
    row_tiles: int
    col_tiles: int
    tile_rows: int
    tile_cols: int
    threads: int
    shared_bytes: int  # dynamic shared memory per block
    state_bytes: int  # one block's state (logits, mu, nu, S, dS, mask)
    state_in_shared: bool  # else S and dS in global scratch, the rest in place

    @property
    def blocks(self) -> int:
        return self.shards * self.row_tiles * self.col_tiles

    @property
    def scratch_bytes(self) -> int:
        """Global scratch for S and dS when the state is not in shared memory."""
        return 0 if self.state_in_shared else 2 * 4 * self.shards * self.rows * self.cols

    def owner(self, shard: int, row: int, col: int) -> int:
        """The block that owns cell (row, col) of shard `shard`'s block."""
        tiles = self.row_tiles * self.col_tiles
        return shard * tiles + (row // self.tile_rows) * self.col_tiles + col // self.tile_cols


def lp_shard_layout(tile_rows: int, tile_cols: int, dims: int) -> Tuple[int, int]:
    """(table bytes, state bytes) of one block (csrc/lp_shard.cu
    persist_layout): the tile rows' vectors and four rows, the tile
    columns' capacity, prices and dD; then logits, mu, nu, S and dS as
    float32 and the mask as bytes."""
    rows = _round16(4 * tile_rows * dims) + 4 * _round16(4 * tile_rows)
    cols = 2 * _round16(4 * tile_cols * dims) + _round16(4 * tile_cols)
    cells = tile_rows * tile_cols
    return rows + cols, 5 * _round16(4 * cells) + _round16(cells)


def lp_shard_launch_plan(shards: int, rows: int, cols: int, dims: int,
                         sms: int = H100_SMS, blocks_per_sm: int = 1) -> LPShardPlan:
    """The persistent K9a kernel's plan, from the sizes alone: a shard's
    [rows, cols] block, the mesh's shard count and the blocks the card keeps
    resident (sms x blocks_per_sm; a cooperative launch needs every block
    resident at once). A shard takes ceil(cells / 1,024) tiles, at most its
    share of the resident blocks: columns cut to at most 256 a tile, then
    rows while a tile keeps a row a warp, then columns again down to 32. The
    state lives in shared memory when the block's tables and state fit
    SHARED_LIMIT, else S and dS go to global scratch. Raises when the card
    cannot hold one block a shard or the tables alone."""
    if min(shards, rows, cols) < 1 or not 1 <= dims <= MAX_DIMS:
        raise ValueError(f"lp_shard: no plan for {shards} shards of [{rows}, {cols}] x {dims}")
    resident = sms * blocks_per_sm
    if shards > resident:
        raise ValueError(f"lp_shard: {shards} shards need more than the {resident} resident blocks")
    budget = resident // shards
    wanted = min(max(1, -(-rows * cols // _TILE_CELLS)), budget)
    col_tiles = min(-(-cols // _MAX_TILE_COLS), budget)
    row_tiles = max(1, min(max(1, rows // _WARPS), wanted // col_tiles))
    col_tiles = max(col_tiles, min(-(-cols // _MIN_TILE_COLS), wanted // row_tiles))
    tile_rows = -(-rows // row_tiles)
    tile_cols = -(-cols // col_tiles)
    table, state = lp_shard_layout(tile_rows, tile_cols, dims)
    if table > SHARED_LIMIT:
        raise ValueError(f"lp_shard: a [{tile_rows}, {tile_cols}] tile's tables need {table} bytes")
    in_shared = table + state <= SHARED_LIMIT
    return LPShardPlan(
        shards=shards, rows=rows, cols=cols, dims=dims,
        row_tiles=-(-rows // tile_rows), col_tiles=-(-cols // tile_cols),
        tile_rows=tile_rows, tile_cols=tile_cols, threads=PERSIST_THREADS,
        shared_bytes=table + (state if in_shared else 0), state_bytes=state,
        state_in_shared=in_shared,
    )


def _check_stacked(vectors, counts, capacity, prices, feasible, logits, mu, nu, bias, steps,
                   mesh_shape) -> torch.device:
    mesh_rows, mesh_cols = mesh_shape
    shards = mesh_rows * mesh_cols
    if feasible.dim() != 3 or feasible.shape[0] != shards:
        raise ValueError(f"shard_lp: feasible must be [{shards}, G', T'] for a {mesh_shape} mesh")
    _, rows, cols = feasible.shape
    dims = vectors.shape[-1]
    shapes = (
        (vectors, (mesh_rows, rows, dims), torch.float32),
        (counts, (mesh_rows, rows), torch.float32),
        (capacity, (mesh_cols, cols, dims), torch.float32),
        (prices, (mesh_cols, cols), torch.float32),
        (feasible, (shards, rows, cols), torch.bool),
        (logits, (shards, rows, cols), torch.float32),
        (mu, (shards, rows, cols), torch.float32),
        (nu, (shards, rows, cols), torch.float32),
    )
    for tensor, shape, dtype in shapes:
        if tuple(tensor.shape) != shape:
            raise ValueError(f"shard_lp: a table is {tuple(tensor.shape)}, not {shape}")
        if tensor.dtype != dtype:
            raise TypeError(f"shard_lp: {dtype} expected, got {tensor.dtype}")
    if isinstance(steps, bool) or not isinstance(steps, int) or steps < 0:
        raise ValueError(f"shard_lp: steps must be a non-negative int, got {steps!r}")
    if bias.dim() != 2 or bias.shape[1] != 2 or bias.shape[0] < steps or bias.dtype != torch.float32:
        raise ValueError(f"shard_lp: bias must be [>= {steps}, 2] float32")
    device = logits.device
    tensors = [t for t, _, _ in shapes] + [bias]
    if any(tensor.device != device for tensor in tensors):
        raise ValueError("shard_lp: every argument must lie on one device")
    if device.type != "cuda":
        raise ValueError(f"shard_lp kernel takes CUDA tensors, not {device} ones: a mesh off the "
                         "card takes the per-phase route")
    if not all(tensor.is_contiguous() for tensor in tensors):
        raise ValueError("shard_lp kernel takes contiguous tensors")
    return device


def shard_lp(
    vectors: torch.Tensor,  # [g, G', R] f32: the group tables, by mesh row
    counts: torch.Tensor,  # [g, G'] f32
    capacity: torch.Tensor,  # [t, T', R] f32: the type tables, by mesh column
    prices: torch.Tensor,  # [t, T'] f32
    feasible: torch.Tensor,  # [S, G', T'] bool: the shards' blocks, flat mesh order
    logits: torch.Tensor,  # [S, G', T'] f32, updated in place
    mu: torch.Tensor,  # [S, G', T'] f32, updated in place
    nu: torch.Tensor,  # [S, G', T'] f32, updated in place
    bias: torch.Tensor,  # [>= steps, 2] f32: (1 - b1**k, 1 - b2**k) from the state's next step
    steps: int,
    mesh_shape: Tuple[int, int],  # (g, t)
    final: bool = True,
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """The sharded LP over a mesh whose shards lie on one device: from the
    state, the exact first row max, `steps` Adam steps and, with `final`,
    the pass that writes the relaxed assignment. Returns (assignment
    [S, G', T'] or None, D [t, T', R]: the final pass's demand, or without
    it the last step's, of the state before its update). One launch of
    the kernel, for CUDA tensors only; the plan takes the card's SM count."""
    device = _check_stacked(vectors, counts, capacity, prices, feasible, logits, mu, nu, bias,
                            steps, mesh_shape)
    if not final and steps < 1:
        raise ValueError("shard_lp: without the final pass it takes at least one step")
    mesh_rows, mesh_cols = mesh_shape
    shards, rows, cols = feasible.shape
    dims = vectors.shape[-1]
    plan = lp_shard_launch_plan(shards, rows, cols, dims,
                                torch.cuda.get_device_properties(device).multi_processor_count)
    lib = LIBRARY.load()
    groups, types = mesh_rows * rows, mesh_cols * cols
    # Row max, row sum and row dot partials [G, t * col tiles]; demand
    # partials [g * row tiles, R, T].
    ex_rows = [torch.empty((groups, mesh_cols * plan.col_tiles), dtype=torch.float32, device=device)
               for _ in range(3)]
    ex_demand = torch.empty((mesh_rows * plan.row_tiles, dims, types), dtype=torch.float32,
                            device=device)
    demand = torch.empty((mesh_cols, cols, dims), dtype=torch.float32, device=device)
    assignment = torch.empty_like(logits) if final else None
    scratch = [None, None] if plan.state_in_shared else [torch.empty_like(logits) for _ in range(2)]
    operands = [vectors, counts, capacity, prices, feasible, logits, mu, nu, bias, *ex_rows,
                ex_demand, demand] + [t for t in (assignment, *scratch) if t is not None]

    def pointer(tensor):
        return 0 if tensor is None else tensor.data_ptr()

    with launch_stream("shard_lp", operands) as stream:
        status = lib.ktt_lp_shard_persistent(
            vectors.data_ptr(), counts.data_ptr(), capacity.data_ptr(), prices.data_ptr(),
            feasible.data_ptr(), logits.data_ptr(), mu.data_ptr(), nu.data_ptr(),
            pointer(scratch[0]), pointer(scratch[1]), bias.data_ptr(),
            *(ex.data_ptr() for ex in ex_rows), ex_demand.data_ptr(), pointer(assignment),
            demand.data_ptr(), mesh_rows, mesh_cols, rows, cols, dims, steps, plan.row_tiles,
            plan.col_tiles, plan.tile_rows, plan.tile_cols, int(final), stream,
        )
    check_launch(status, "shard_lp")
    shard_lp.launches += 1
    return assignment, demand


shard_lp.launches = 0


def launches() -> int:
    """K9a's launches so far: the persistent kernel's and the three
    phases'."""
    return shard_lp.launches + shard_softmax.launches + shard_demand.launches + shard_row_dot.launches


def reset_launches() -> None:
    shard_lp.launches = shard_softmax.launches = shard_demand.launches = shard_row_dot.launches = 0
