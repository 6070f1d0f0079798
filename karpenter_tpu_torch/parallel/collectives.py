"""The cross-shard reductions of the sharded solve.

The counterpart of the collectives GSPMD inserts into the reference's
sharded programs (karpenter_tpu/parallel/sharded_solver.py): the sum and
the max over the groups axis or the types axis of a mesh, and the gather of
per-shard segments.

A grid is a list of rows, one list of tensors per mesh row (`grid[i][j]` is
shard (i, j)'s tensor, on that shard's device; None where another process
holds the shard). Every reduction combines a line's parts one by one in
ascending shard order, on the device of the first part: the parts are
copied there, combined, and the result copied back to each shard's device.
N shards therefore give the same bits on one card as on N cards, and in one
process as across several; only the copies (transport) differ.

Across processes no collective sums anything: a reduction whose lines hold
shards of several processes first gathers every shard's part to every
process (spmd.transport, one broadcast a rank of its parts, in rank
order), and each process then combines its lines locally in the same fixed
order. A backend's all_reduce would sum in an order of its own choosing.
A reduction whose every line lies in one process (the types axis of a mesh
whose rows are its processes') moves nothing between them.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from karpenter_tpu_torch.parallel.mesh import Mesh

Grid = List[List[Optional[torch.Tensor]]]

# Cross-process exchanges made (gather_parts calls that moved parts between
# processes) and the broadcasts they took.
EXCHANGES = {"exchanges": 0, "broadcasts": 0}


def _reduce(parts: Sequence[torch.Tensor], combine: Callable) -> torch.Tensor:
    total = parts[0]
    for part in parts[1:]:
        total = combine(total, part.to(total.device))
    return total


def gather_parts(mesh: Mesh, parts: Dict[int, torch.Tensor]) -> Dict[int, torch.Tensor]:
    """Every shard's part on this process, from this process's `parts`
    ({flat index: tensor}, every part of one shape and dtype): on a mesh of
    one process, `parts` itself; across processes, each rank in turn
    broadcasts its parts stacked, and the parts of the others arrive on
    this process's first device."""
    if not mesh.spans_processes:
        return dict(parts)
    from karpenter_tpu_torch.parallel.spmd import transport

    like = next(iter(parts.values()))
    device = mesh.devices[0]
    out = dict(parts)
    for rank in mesh.ranks:
        indices = mesh.indices_of(rank)
        if rank == mesh.rank:
            transport(torch.stack([parts[index].to(device) for index in indices]), rank)
            continue
        received = transport(torch.empty((len(indices),) + tuple(like.shape), dtype=like.dtype,
                                         device=device), rank)
        for position, index in enumerate(indices):
            out[index] = received[position]
    EXCHANGES["exchanges"] += 1
    EXCHANGES["broadcasts"] += len(mesh.ranks)
    return out


def _lines_cross(mesh: Mesh, lines: List[List[Tuple[int, int]]]) -> bool:
    return any(len({mesh.shard(r, c).rank for r, c in line}) > 1 for line in lines)


def _over_lines(mesh: Mesh, grid: Grid, lines: List[List[Tuple[int, int]]], combine: Callable) -> Grid:
    columns = mesh.shape[1]
    if _lines_cross(mesh, lines):
        local = {r * columns + c: grid[r][c] for r in range(mesh.shape[0]) for c in range(columns)
                 if mesh.is_local(r * columns + c)}
        every = gather_parts(mesh, local)
        parts = lambda r, c: every[r * columns + c]  # noqa: E731
    else:
        parts = lambda r, c: grid[r][c]  # noqa: E731
    out: Grid = [[None] * columns for _ in range(mesh.shape[0])]
    for line in lines:
        mine = [(r, c) for r, c in line if mesh.is_local(r * columns + c)]
        if not mine:
            continue
        total = _reduce([parts(r, c) for r, c in line], combine)
        for r, c in mine:
            out[r][c] = total.to(mesh.shard(r, c).device)
    return out


def _rows(mesh: Mesh) -> List[List[Tuple[int, int]]]:
    return [[(r, c) for c in range(mesh.shape[1])] for r in range(mesh.shape[0])]


def _columns(mesh: Mesh) -> List[List[Tuple[int, int]]]:
    return [[(r, c) for r in range(mesh.shape[0])] for c in range(mesh.shape[1])]


def sum_over_types(mesh: Mesh, grid: Grid) -> Grid:
    """Each row's parts summed in column order, on every shard of the row."""
    return _over_lines(mesh, grid, _rows(mesh), torch.add)


def max_over_types(mesh: Mesh, grid: Grid) -> Grid:
    """Each row's elementwise maximum, on every shard of the row."""
    return _over_lines(mesh, grid, _rows(mesh), torch.maximum)


def sum_over_groups(mesh: Mesh, grid: Grid) -> Grid:
    """Each column's parts summed in row order, on every shard of the
    column."""
    return _over_lines(mesh, grid, _columns(mesh), torch.add)


def first_local(mesh: Mesh, grid: Grid) -> torch.Tensor:
    """The entry of this process's first shard."""
    index = next(i for i in range(mesh.size) if mesh.is_local(i))
    return grid[index // mesh.shape[1]][index % mesh.shape[1]]


def gather_to_first(mesh: Mesh, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Per-shard tensors (in the mesh's flat order) on the first shard's
    device, in the same order."""
    first = mesh.flat[0].device
    return [part.to(first) for part in parts]


def replicate(mesh: Mesh, grid: Grid) -> Grid:
    """Every shard's block on this process (remote blocks on its first
    device): the grid itself on a mesh of one process."""
    if not mesh.spans_processes:
        return grid
    columns = mesh.shape[1]
    every = gather_parts(mesh, {r * columns + c: grid[r][c] for r in range(mesh.shape[0])
                                for c in range(columns) if mesh.is_local(r * columns + c)})
    return [[every[r * columns + c] for c in range(columns)] for r in range(mesh.shape[0])]


def assemble(mesh: Mesh, grid: Grid) -> torch.Tensor:
    """The [G, T] tensor whose (i, j) block is grid[i][j], on this
    process's first device; every block must be present (replicate)."""
    first = mesh.devices[0]
    rows = [torch.cat([part.to(first) for part in row], dim=1) for row in grid]
    return torch.cat(rows, dim=0)
