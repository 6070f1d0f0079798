"""K8, the masked scatter and gather of the incremental cluster encode.

The port of karpenter_tpu/ops/incremental.py. The device-resident cluster
tensors (models/cluster_state.py) are slot arrays: a row per pod group or
node, holes where slots were freed. Between sweeps the host accumulates
which slots changed; a flush applies all of a sweep's churn with one
masked scatter per array, O(delta) device work, never O(cluster).
Compaction and the per-sweep sorted view are gathers over a host-computed
permutation.

Shape discipline: delta sizes and permutation lengths are bucketed to
powers of two (ops.pack_kernel.bucket_size); padding indices point one
past the array, so the scatter drops them and the gather reads zeros, and
padded lanes are inert.

Generations: the scatter is functional, as the reference's is. It writes
into a copy of `dst` and returns the copy; the slot arrays are long-lived
generations that a lagging consumer may still hold, and the epoch protocol
detects staleness by reading the old generation.

`scatter` (the reference's scatter_rows and scatter_vals) and `gather` (its
gather_rows) route by where their tensors lie: a CPU tensor goes to the
plain version, a CUDA tensor to the hand-written kernel
(csrc/incremental.cu), with no fallback between them.
Torch's own index ops raise on the out-of-range sentinel (on the card as a
device-side assert that poisons the context), so the plain versions mask
with `idx < n` and the kernels drop the sentinel themselves.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from karpenter_tpu_torch.ops.cuda_build import CudaLibrary, check_launch
from karpenter_tpu_torch.ops.pack_kernel import bucket_size, pad_to

LIBRARY = CudaLibrary(
    "incremental.cu",
    {
        "ktt_scatter_rows": (
            ctypes.c_int,
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
        ),
        "ktt_gather_rows": (
            ctypes.c_int,
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
        ),
    },
)

# Element types the kernels move, by their size in bytes.
_ELEMENT_BYTES = {torch.float32: 4, torch.int32: 4, torch.bool: 1}


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


def _stream(device: torch.device) -> int:
    with torch.cuda.device(device):
        return torch.cuda.current_stream().cuda_stream


def scatter(dst: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """dst with rows[i] written at row idx[i], into a copy of dst (a new
    generation), O(len(idx)); indices outside [0, dst.shape[0]) are
    dropped. idx is padded by pad_indices and rows is [len(idx), ...] of
    dst's dtype and row shape (padded rows are dropped)."""
    _check("scatter", dst, idx)
    if rows.dtype != dst.dtype or tuple(rows.shape) != (idx.shape[0], *dst.shape[1:]):
        raise ValueError(
            f"scatter: rows {tuple(rows.shape)} {rows.dtype} do not match "
            f"{len(idx)} rows of {tuple(dst.shape[1:])} {dst.dtype}"
        )
    if rows.device != dst.device:
        raise ValueError("scatter: rows must lie on the array's device")
    if dst.device.type == "cpu":
        return _scatter_ref(dst, idx, rows)
    if dst.device.type != "cuda":
        raise ValueError(f"scatter: unsupported device {dst.device}")
    if not (dst.is_contiguous() and idx.is_contiguous() and rows.is_contiguous()):
        raise ValueError("scatter kernel takes contiguous tensors")
    out = dst.clone()
    if idx.shape[0] == 0 or _width(dst) == 0:
        return out
    lib = LIBRARY.load()
    status = lib.ktt_scatter_rows(
        out.data_ptr(), idx.data_ptr(), rows.data_ptr(), int(idx.shape[0]), _width(dst),
        int(dst.shape[0]), _ELEMENT_BYTES[dst.dtype], _stream(dst.device),
    )
    check_launch(status, "scatter")
    scatter.launches += 1
    return out


scatter.launches = 0


def gather(src: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """src[perm] as a new array, the sorted-view gather; indices outside
    [0, src.shape[0]) (the pad_indices sentinel) read zeros."""
    _check("gather", src, perm)
    if src.device.type == "cpu":
        return _gather_ref(src, perm)
    if src.device.type != "cuda":
        raise ValueError(f"gather: unsupported device {src.device}")
    if not (src.is_contiguous() and perm.is_contiguous()):
        raise ValueError("gather kernel takes contiguous tensors")
    out = torch.empty((perm.shape[0], *src.shape[1:]), dtype=src.dtype, device=src.device)
    if out.numel() == 0:
        return out
    lib = LIBRARY.load()
    status = lib.ktt_gather_rows(
        out.data_ptr(), src.data_ptr(), perm.data_ptr(), int(perm.shape[0]), _width(src),
        int(src.shape[0]), _ELEMENT_BYTES[src.dtype], _stream(src.device),
    )
    check_launch(status, "gather")
    gather.launches += 1
    return out


gather.launches = 0


def pad_indices(idx: np.ndarray, sentinel: int, minimum: int = 8) -> np.ndarray:
    """Bucket-pad an int32 index vector with an out-of-range sentinel, so a
    flush's shapes come from a small ladder."""
    idx = np.asarray(idx, dtype=np.int32)  # vet: host-array(callers pass host-built delta indices)
    return pad_to(idx, bucket_size(len(idx), minimum=minimum), value=sentinel)

