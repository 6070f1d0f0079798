"""K1, capacity-dominance pricing: the port of the reference's one Pallas
kernel (karpenter_tpu/ops/pallas_kernels.py).

effective[t] = min over t' of prices[t'] where t' dominates t on every
resource axis: capacity[t', r] >= capacity[t, r] - 1e-6 for all r. Invalid
(padded) rows carry price +inf. The hand-written kernel lives in
csrc/dominance.cu; `_dominance_prices_ref` is its plain PyTorch version.

`dominance_prices` routes by where its tensors lie: a CPU tensor goes to the
plain version, a CUDA tensor to the kernel. There is no fallback between
them: a kernel that does not build or launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from karpenter_tpu_torch.ops.cuda_build import CudaLibrary, check_launch, launch_stream

_EPS = 1e-6
MAX_DIMS = 8  # register thresholds per thread in the kernel

LIBRARY = CudaLibrary(
    "dominance.cu",
    {
        "ktt_dominance_prices": (
            ctypes.c_int,
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
        ),
    },
)


def _dominance_prices_ref(capacity: torch.Tensor, prices: torch.Tensor) -> torch.Tensor:
    """Plain formulation — the CPU path, and what the kernel is held against.

    capacity: [T, R] usable capacity; prices: [T] with invalid rows +inf.
    Returns [T] effective prices (min price over dominating types)."""
    dominates = (capacity[None, :, :] >= capacity[:, None, :] - _EPS).all(dim=2)
    return torch.where(dominates, prices[None, :], torch.inf).amin(dim=1)


def _check_args(capacity: torch.Tensor, prices: torch.Tensor) -> None:
    if capacity.dtype != torch.float32 or prices.dtype != torch.float32:
        raise TypeError("dominance_prices takes float32 capacity and prices")
    if capacity.dim() != 2 or prices.dim() != 1 or prices.shape[0] != capacity.shape[0]:
        raise ValueError(
            f"dominance_prices takes capacity [T, R] and prices [T], got "
            f"{tuple(capacity.shape)} and {tuple(prices.shape)}"
        )
    if capacity.device != prices.device:
        raise ValueError("capacity and prices must lie on one device")


def dominance_prices(capacity: torch.Tensor, prices: torch.Tensor) -> torch.Tensor:
    """Effective (dominance-minimum) prices: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    _check_args(capacity, prices)
    if capacity.device.type == "cpu":
        return _dominance_prices_ref(capacity, prices)
    if capacity.device.type != "cuda":
        raise ValueError(f"dominance_prices: unsupported device {capacity.device}")
    num_types, dims = capacity.shape
    if num_types == 0 or dims == 0 or dims > MAX_DIMS:
        raise ValueError(f"dominance_prices kernel takes 1..{MAX_DIMS} axes and T >= 1")
    if not (capacity.is_contiguous() and prices.is_contiguous()):
        raise ValueError("dominance_prices kernel takes contiguous tensors")
    lib = LIBRARY.load()
    out = torch.empty(num_types, dtype=torch.float32, device=capacity.device)
    with launch_stream("dominance_prices", (capacity, prices, out)) as stream:
        status = lib.ktt_dominance_prices(
            capacity.data_ptr(), prices.data_ptr(), out.data_ptr(),
            num_types, dims, stream,
        )
    check_launch(status, "dominance_prices")
    dominance_prices.launches += 1
    return out


dominance_prices.launches = 0
