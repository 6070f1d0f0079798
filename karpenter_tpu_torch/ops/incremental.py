"""K8, the masked scatter and gather of the incremental cluster encode.

The port of karpenter_tpu/ops/incremental.py. The device-resident cluster
tensors (models/cluster_state.py) are slot arrays: a row per pod group or
node, holes where slots were freed. Between sweeps the host accumulates
which slots changed; a flush applies all of a sweep's churn to every slot
array in one masked scatter (`scatter_flush`), O(delta) scattered rows
beside one copy of each array, never a re-encode of the cluster. The
per-sweep sorted view is one gather of its arrays over a host-computed
permutation (`gather_view`).

Shape discipline: delta sizes and permutation lengths are bucketed to
powers of two (ops.pack_kernel.bucket_size); padding indices point one
past the array, so the scatter drops them and the gather reads zeros, and
padded lanes are inert.

Generations: the scatter is functional, as the reference's is. It writes
into a copy of `dst` and returns the copy; the slot arrays are long-lived
generations that a lagging consumer may still hold, and the epoch protocol
detects staleness by reading the old generation.

`scatter_flush` (the reference's scatter_rows and scatter_vals over a
flush's arrays) and `gather_view` (its gather_rows over a view's arrays),
and their one-array forms `scatter` and `gather`, route by where their
tensors lie: a CPU tensor goes to the plain version, a CUDA tensor to the
hand-written kernel (csrc/incremental.cu, one launch a call), with no
fallback between them.
Torch's own index ops raise on the out-of-range sentinel (on the card as a
device-side assert that poisons the context), so the plain versions mask
with `idx < n` and the kernels drop the sentinel themselves.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from karpenter_tpu_torch.ops.cuda_build import CudaLibrary, check_launch, launch_stream
from karpenter_tpu_torch.ops.pack_kernel import bucket_size, pad_to

LIBRARY = CudaLibrary(
    "incremental.cu",
    {
        "ktt_scatter_flush": (ctypes.c_int, [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]),
        "ktt_gather_view": (
            ctypes.c_int,
            [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
        ),
    },
)

# Element types the kernels move, by their size in bytes.
_ELEMENT_BYTES = {torch.float32: 4, torch.int32: 4, torch.bool: 1}
# Arrays one launch takes (csrc/incremental.cu's kMaxArrays).
MAX_ARRAYS = 8
_ALIGN = 16  # bytes between the arrays of one output buffer


def _scatter_ref(dst: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Plain version: dst.at[idx].set(rows, mode="drop") into a copy."""
    out = dst.clone()
    keep = (idx >= 0) & (idx < dst.shape[0])
    out[idx[keep].long()] = rows[keep]
    return out


def _gather_ref(src: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Plain version: take(src, perm, mode="fill", fill_value=0)."""
    out = torch.zeros((perm.shape[0], *src.shape[1:]), dtype=src.dtype, device=src.device)
    keep = (perm >= 0) & (perm < src.shape[0])
    out[keep] = src[perm[keep].long()]
    return out


def _scatter_flush_ref(updates) -> Tuple[torch.Tensor, ...]:
    """Plain version of scatter_flush: one _scatter_ref an array."""
    return tuple(_scatter_ref(dst, idx, rows) for dst, idx, rows in updates)


def _gather_view_ref(sources, perm: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Plain version of gather_view: one _gather_ref a source."""
    return tuple(_gather_ref(src, perm) for src in sources)


def _width(tensor: torch.Tensor) -> int:
    width = 1
    for size in tensor.shape[1:]:
        width *= int(size)
    return width


def _check(name: str, array: torch.Tensor, index: torch.Tensor) -> None:
    if array.dtype not in _ELEMENT_BYTES:
        raise TypeError(f"{name} takes float32, int32 or bool arrays, got {array.dtype}")
    if index.dtype != torch.int32 or index.dim() != 1:
        raise TypeError(f"{name} takes a 1-D int32 index vector")
    if array.device != index.device:
        raise ValueError(f"{name}: the array and the index must lie on one device")
    if array.dim() < 1:
        raise ValueError(f"{name} takes arrays of rows")


def _route(name: str, tensors: Sequence[torch.Tensor], count: int) -> str:
    """"cpu" (the plain version) or "cuda" (the kernel) for one batched
    call's tensors, which must all lie on one device; raises otherwise."""
    devices = {tensor.device for tensor in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: every tensor must lie on one device")
    (device,) = devices
    if device.type == "cpu":
        return "cpu"
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    if count > MAX_ARRAYS:
        raise ValueError(f"{name} kernel takes at most {MAX_ARRAYS} arrays a launch, got {count}")
    if not all(tensor.is_contiguous() for tensor in tensors):
        raise ValueError(f"{name} kernel takes contiguous tensors")
    return "cuda"


def _outputs(shapes, device) -> List[torch.Tensor]:
    """Uninitialised contiguous (shape, dtype) arrays as views of ONE
    allocation on `device`, each at a 16-byte aligned offset (as
    convert.upload_packed lays out its buffer); one strided view each, so a
    flush's host time does not grow with slicing ops."""
    offsets, total = [], 0
    for shape, dtype in shapes:
        offsets.append(total)
        total += -(-math.prod(shape) * _ELEMENT_BYTES[dtype] // _ALIGN) * _ALIGN
    buffer = torch.empty(total, dtype=torch.uint8, device=device)
    typed = {}
    outs = []
    for (shape, dtype), offset in zip(shapes, offsets):
        if dtype not in typed:
            typed[dtype] = buffer.view(dtype)
        strides = [1] * len(shape)
        for axis in range(len(shape) - 2, -1, -1):
            strides[axis] = strides[axis + 1] * shape[axis + 1]
        outs.append(typed[dtype].as_strided(shape, strides, offset // _ELEMENT_BYTES[dtype]))
    return outs


def scatter_flush(updates) -> Tuple[torch.Tensor, ...]:
    """A flush: for each (dst, idx, rows) of `updates`, dst with rows[i]
    written at row idx[i], as a new generation (dst is left as it was);
    indices outside [0, dst.shape[0]) are dropped. idx is padded by
    pad_indices and rows is [len(idx), ...] of dst's dtype and row shape
    (padded rows are dropped). Every array lies on one device, each with its
    own dtype (float32, int32 or bool) and width. The CUDA kernel
    (csrc/incremental.cu: one launch for every array, the copies of the old
    rows included; the new generations are views of one allocation) for
    CUDA tensors, the plain version for CPU tensors."""
    updates = [tuple(update) for update in updates]
    for dst, idx, rows in updates:
        _check("scatter_flush", dst, idx)
        if rows.dtype != dst.dtype or tuple(rows.shape) != (idx.shape[0], *dst.shape[1:]):
            raise ValueError(
                f"scatter_flush: rows {tuple(rows.shape)} {rows.dtype} do not match "
                f"{len(idx)} rows of {tuple(dst.shape[1:])} {dst.dtype}"
            )
    if not updates:
        return ()
    tensors = [tensor for update in updates for tensor in update]
    if _route("scatter_flush", tensors, len(updates)) == "cpu":
        return _scatter_flush_ref(updates)
    device = updates[0][0].device
    outs = _outputs([(tuple(dst.shape), dst.dtype) for dst, _, _ in updates], device)
    table = []
    for out, (dst, idx, rows) in zip(outs, updates):
        if out.numel():
            table += [out.data_ptr(), dst.data_ptr(), idx.data_ptr(), rows.data_ptr(),
                      int(dst.shape[0]), _width(dst), int(idx.shape[0]), _ELEMENT_BYTES[dst.dtype]]
    if not table:
        return tuple(outs)
    lib = LIBRARY.load()
    with launch_stream("scatter_flush", tensors + outs) as stream:
        status = lib.ktt_scatter_flush(len(table) // 8, (ctypes.c_longlong * len(table))(*table), stream)
    check_launch(status, "scatter_flush")
    scatter.launches += 1
    return tuple(outs)


def gather_view(sources, perm: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """A sorted view: src[perm] for each source, as new arrays; indices
    outside [0, src.shape[0]) (the pad_indices sentinel) read zeros. The
    sources may differ in dtype and width and share the one permutation on
    their device. The CUDA kernel (one launch for every source) for CUDA
    tensors, the plain version for CPU tensors."""
    sources = list(sources)
    for src in sources:
        _check("gather_view", src, perm)
    if not sources:
        return ()
    if _route("gather_view", sources + [perm], len(sources)) == "cpu":
        return _gather_view_ref(sources, perm)
    outs = _outputs([((perm.shape[0], *src.shape[1:]), src.dtype) for src in sources], perm.device)
    table = []
    for out, src in zip(outs, sources):
        if out.numel():
            table += [out.data_ptr(), src.data_ptr(), int(src.shape[0]), _width(src), _ELEMENT_BYTES[src.dtype]]
    if not table:
        return tuple(outs)
    lib = LIBRARY.load()
    with launch_stream("gather_view", sources + [perm] + outs) as stream:
        status = lib.ktt_gather_view(
            len(table) // 5, (ctypes.c_longlong * len(table))(*table), perm.data_ptr(),
            int(perm.shape[0]), stream,
        )
    check_launch(status, "gather_view")
    gather.launches += 1
    return tuple(outs)


def scatter(dst: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """dst with rows[i] written at row idx[i], into a copy of dst (a new
    generation), O(len(idx)) scattered rows; indices outside [0,
    dst.shape[0]) are dropped. A flush of one array: scatter_flush's kernel
    for CUDA tensors, its plain version (_scatter_ref) for CPU tensors.
    `scatter.launches` counts the launches of every scatter_flush."""
    return scatter_flush([(dst, idx, rows)])[0]


scatter.launches = 0


def gather(src: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """src[perm] as a new array, the sorted-view gather; indices outside
    [0, src.shape[0]) (the pad_indices sentinel) read zeros. A view of one
    source: gather_view's kernel for CUDA tensors, its plain version
    (_gather_ref) for CPU tensors. `gather.launches` counts the launches of
    every gather_view."""
    return gather_view([src], perm)[0]


gather.launches = 0


def pad_indices(idx: np.ndarray, sentinel: int, minimum: int = 8) -> np.ndarray:
    """Bucket-pad an int32 index vector with an out-of-range sentinel, so a
    flush's shapes come from a small ladder."""
    idx = np.asarray(idx, dtype=np.int32)  # vet: host-array(callers pass host-built delta indices)
    return pad_to(idx, bucket_size(len(idx), minimum=minimum), value=sentinel)

