"""Mesh construction and block layouts for the sharded solve.

The port of karpenter_tpu/parallel/mesh.py. A mesh is a [groups, types]
grid of shards; each shard has an id, the torch.device its blocks live on
and the rank of the process that holds it. Every process of a group sees
the same global grid, in one fixed shard order, and runs kernels for its
own shards only (parallel/multihost.py, parallel/spmd.py).

Axes:
  "groups": pod groups — shard (i, j) owns the i-th contiguous block of
      the pod-group dimension; per-type sums reduce across it.
  "types": instance types — and the j-th block of the type dimension; the
      softmax's row reductions reduce across it.

`mesh_devices()` is the port's `jax.devices()`: one shard per visible CUDA
card, its id the card's ordinal. The reference's tests and chip drive run on
a virtual device set (8 CPU devices in one process); the port's declare one
with `virtual_devices(device, count)`, N shards of one device, ids 0..N-1,
for the length of a `with` block: the tests over the CPU, chip_smoke over
the one card. Production declares nothing. In a process group of P
processes, each holding n shards, the global set is P * n shards, rank r's
with ids r * n .. r * n + n - 1, as jax.devices() lists a multi-host slice.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch

GROUPS_AXIS = "groups"
TYPES_AXIS = "types"


class Shard(NamedTuple):
    """One position of the mesh: an id (the card's ordinal, or the index in
    a virtual set; global across a process group), the device its blocks
    live on in the process that holds it, and that process's rank."""

    id: int
    device: torch.device
    rank: int = 0


def _factor(n: int) -> Tuple[int, int]:
    """Split n into (groups, types) factors, as square as possible with the
    types axis at least as large (type counts dominate group counts)."""
    best = (1, n)
    a = 1
    while a * a <= n:
        if n % a == 0:
            best = (a, n // a)
        a += 1
    return best


class Mesh:
    """A [groups, types] grid of shards, row-major: shard (i, j) is
    flat[i * types + j]. Every shard lies on a device of one type. `rank` is
    this process's: its shards are the local ones; a mesh over several
    processes holds at least one shard of each of them."""

    axis_names = (GROUPS_AXIS, TYPES_AXIS)

    def __init__(self, shards: Sequence[Shard], shape: Tuple[int, int], rank: Optional[int] = None):
        shards = list(shards)
        if shape[0] * shape[1] != len(shards) or not shards:
            raise ValueError(f"a {shape} mesh cannot hold {len(shards)} shards")
        kinds = {shard.device.type for shard in shards}
        if len(kinds) != 1:
            raise ValueError(f"a mesh lies on one device type, got {sorted(kinds)}")
        if rank is None:
            from karpenter_tpu_torch.parallel.multihost import process_index

            rank = process_index()
        self.flat: List[Shard] = shards
        self.shape = (int(shape[0]), int(shape[1]))
        self.rank = int(rank)
        if not any(shard.rank == self.rank for shard in shards):
            raise ValueError(f"a mesh of process {self.rank} holds none of its shards")

    @property
    def size(self) -> int:
        return len(self.flat)

    @property
    def device_type(self) -> str:
        return self.flat[0].device.type

    @property
    def ranks(self) -> List[int]:
        """The processes holding the mesh's shards, ascending."""
        return sorted({shard.rank for shard in self.flat})

    @property
    def spans_processes(self) -> bool:
        return len(self.ranks) > 1

    def is_local(self, index: int) -> bool:
        """Whether the shard at flat position `index` is this process's."""
        return self.flat[index].rank == self.rank

    def indices_of(self, rank: int) -> List[int]:
        """The flat positions of `rank`'s shards, ascending."""
        return [index for index, shard in enumerate(self.flat) if shard.rank == rank]

    @property
    def devices(self) -> List[torch.device]:
        """The distinct devices under this process's shards, in order of
        first use."""
        seen: List[torch.device] = []
        for shard in self.flat:
            if shard.rank == self.rank and shard.device not in seen:
                seen.append(shard.device)
        return seen

    def ids(self) -> List[int]:
        return [shard.id for shard in self.flat]

    def shard(self, row: int, column: int) -> Shard:
        return self.flat[row * self.shape[1] + column]

    def __repr__(self) -> str:
        return f"Mesh({self.shape[0]}x{self.shape[1]}, ids={self.ids()}, devices={self.devices})"


# The declared virtual set: (device, count), or None for the real cards.
_VIRTUAL: Optional[Tuple[torch.device, int]] = None


@contextlib.contextmanager
def virtual_devices(device, count: int) -> Iterator[List[Shard]]:
    """Within the block, `mesh_devices()` of `device`'s type is `count`
    shards of `device` (ids 0..count-1): the counterpart of the reference's
    --xla_force_host_platform_device_count. Restores the previous set on
    exit."""
    global _VIRTUAL
    if count < 1:
        raise ValueError(f"a virtual device set needs at least one shard, got {count}")
    previous = _VIRTUAL
    _VIRTUAL = (torch.device(device), int(count))
    try:
        yield mesh_devices(torch.device(device).type)
    finally:
        _VIRTUAL = previous


def _local_devices(kind: str) -> List[torch.device]:
    """This process's shards' devices: the declared virtual set when it is
    of `kind`; else one per visible card for "cuda" and one CPU for "cpu"."""
    if _VIRTUAL is not None and _VIRTUAL[0].type == kind:
        device, count = _VIRTUAL
        return [device] * count
    if kind == "cuda":
        if not torch.cuda.is_available():
            return []
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if kind == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"unsupported device type {kind!r}")


def mesh_devices(kind: str = "cuda") -> List[Shard]:
    """Every shard a mesh of `kind` ("cuda" or "cpu") may use: this
    process's (_local_devices, ids 0..n-1) alone, or in a process group of
    P processes the global set, rank r's n shards with ids r * n .. r * n +
    n - 1 (every process holds n). A remote shard's device is the one the
    same position has here; only its holder touches it."""
    from karpenter_tpu_torch.parallel.multihost import process_count

    local = _local_devices(kind)
    processes = process_count()
    return [
        Shard(rank * len(local) + index, device, rank)
        for rank in range(processes)
        for index, device in enumerate(local)
    ]


def make_mesh(shards: Optional[Sequence[Shard]] = None, kind: str = "cuda") -> Mesh:
    """The solver mesh over the HEALTHY shards of `kind`: ids quarantined by
    MeshHealth (utils/backend_health.report_chip_wedged — the "1 of N cards
    wedged" verdict) are left out, so the mesh shrinks and the next solve
    spans only the survivors. An explicit `shards` list bypasses the filter
    (tests and chip_smoke build meshes over exact shard sets)."""
    if shards is None:
        from karpenter_tpu_torch.utils import backend_health

        wedged = backend_health.wedged_chips()
        shards = [shard for shard in mesh_devices(kind) if shard.id not in wedged]
        if not shards:
            # Every shard quarantined: the caller's gate (solve_mesh) should
            # have routed away already; fail loudly rather than build an
            # empty mesh.
            raise RuntimeError(
                f"no healthy devices left (wedged: {sorted(wedged)})"
            )
    shards = list(shards)
    from karpenter_tpu_torch.parallel.multihost import process_count

    missing = sorted(set(range(process_count())) - {shard.rank for shard in shards})
    if missing:
        # Every process runs its own shards' kernels: one that holds none
        # would have no part in the solve's collectives.
        raise RuntimeError(f"a mesh across processes holds no shard of ranks {missing}")
    return Mesh(shards, _factor(len(shards)))


def local_mesh(mesh: Mesh) -> Mesh:
    """The mesh of this process's shards alone: `mesh` itself when it lies
    in one process."""
    if not mesh.spans_processes:
        return mesh
    local = [shard for shard in mesh.flat if shard.rank == mesh.rank]
    return Mesh(local, _factor(len(local)), rank=mesh.rank)


def pad_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def block(size: int, parts: int, index: int) -> slice:
    """The index-th of `parts` equal contiguous blocks of range(size) — the
    port's counterpart of solver_shardings: `size` must divide evenly."""
    if size % parts:
        raise ValueError(f"{size} does not split into {parts} equal blocks")
    width = size // parts
    return slice(index * width, (index + 1) * width)
