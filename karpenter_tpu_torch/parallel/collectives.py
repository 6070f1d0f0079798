"""The cross-shard reductions of the sharded solve.

The counterpart of the collectives GSPMD inserts into the reference's
sharded programs (karpenter_tpu/parallel/sharded_solver.py): the sum and
the max over the groups axis or the types axis of a mesh, and the gather of
per-shard segments to the mesh's first shard.

A grid is a list of rows, one list of tensors per mesh row (`grid[i][j]` is
shard (i, j)'s tensor, on that shard's device). Every reduction runs in a
fixed shard order on the device of the first shard it reduces over: the
parts are copied there, combined one by one in ascending shard order, and
the result copied back to each shard's device. N shards therefore give the
same bits on one card as on N cards; only the copies between distinct cards
(transport) differ, and on one card there are none.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch

from karpenter_tpu_torch.parallel.mesh import Mesh

Grid = List[List[torch.Tensor]]


def _reduce(parts: Sequence[torch.Tensor], combine: Callable) -> torch.Tensor:
    total = parts[0]
    for part in parts[1:]:
        total = combine(total, part.to(total.device))
    return total


def _over_types(mesh: Mesh, grid: Grid, combine: Callable) -> Grid:
    out = []
    for row in range(mesh.shape[0]):
        total = _reduce(grid[row], combine)
        out.append([total.to(mesh.shard(row, col).device) for col in range(mesh.shape[1])])
    return out


def _over_groups(mesh: Mesh, grid: Grid, combine: Callable) -> Grid:
    totals = [
        _reduce([grid[row][col] for row in range(mesh.shape[0])], combine)
        for col in range(mesh.shape[1])
    ]
    return [
        [totals[col].to(mesh.shard(row, col).device) for col in range(mesh.shape[1])]
        for row in range(mesh.shape[0])
    ]


def sum_over_types(mesh: Mesh, grid: Grid) -> Grid:
    """Each row's parts summed in column order, on every shard of the row."""
    return _over_types(mesh, grid, torch.add)


def max_over_types(mesh: Mesh, grid: Grid) -> Grid:
    """Each row's elementwise maximum, on every shard of the row."""
    return _over_types(mesh, grid, torch.maximum)


def sum_over_groups(mesh: Mesh, grid: Grid) -> Grid:
    """Each column's parts summed in row order, on every shard of the
    column."""
    return _over_groups(mesh, grid, torch.add)


def gather_to_first(mesh: Mesh, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Per-shard tensors (in the mesh's flat order) on the first shard's
    device, in the same order."""
    first = mesh.flat[0].device
    return [part.to(first) for part in parts]


def assemble(mesh: Mesh, grid: Grid) -> torch.Tensor:
    """The [G, T] tensor whose (i, j) block is grid[i][j], on the first
    shard's device."""
    first = mesh.flat[0].device
    rows = [torch.cat([part.to(first) for part in row], dim=1) for row in grid]
    return torch.cat(rows, dim=0)
