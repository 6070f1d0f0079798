"""K1, capacity-dominance pricing: the port of the reference's one Pallas
kernel (karpenter_tpu/ops/pallas_kernels.py).

effective[t] = min over t' of prices[t'] where t' dominates t on every
resource axis: capacity[t', r] >= capacity[t, r] - 1e-6 for all r. Invalid
(padded) rows carry price +inf. The hand-written kernel lives in
csrc/dominance.cu (one warp a row, laid out by `dominance_launch_plan`);
`_dominance_prices_ref` is its plain PyTorch version.

`dominance_prices` routes by where its tensors lie: a CPU tensor goes to the
plain version, a CUDA tensor to the kernel. There is no fallback between
them: a kernel that does not build or launch raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from karpenter_tpu_torch.ops.cuda_build import CudaLibrary, check_launch, launch_stream

_EPS = 1e-6
MAX_DIMS = 8  # register thresholds per lane in the kernel
H100_SMS = 132  # streaming multiprocessors of an H100: the plan's default off the card
MAX_ROWS = 32  # warps a block, one row a warp

LIBRARY = CudaLibrary(
    "dominance.cu",
    {
        "ktt_dominance_prices": (
            ctypes.c_int,
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
        ),
    },
)


class DominancePlan(NamedTuple):
    """How K1 spreads the rows t over the card: one warp a row, `rows` rows
    a block, so row t lies in block t // rows, warp t % rows."""

    rows: int  # rows (warps) a block
    threads_per_row: int  # lanes that stride over the rows t'
    blocks: int

    @property
    def threads(self) -> int:
        return self.rows * self.threads_per_row

    def owner(self, t: int):
        """(block, warp) of row t."""
        return divmod(t, self.rows)


def dominance_launch_plan(types: int, dims: int, sms: int = H100_SMS) -> DominancePlan:
    """K1's plan, from the sizes alone: one warp a row, the rows a block the
    smallest power of two that keeps the blocks within the card's SMs (at
    most 32): 4 rows, 128 blocks at T 512. Raises on a size the kernel does
    not take."""
    if types < 1 or not 1 <= dims <= MAX_DIMS or sms < 1:
        raise ValueError(f"dominance_prices: no plan for T {types}, {dims} axes, {sms} SMs")
    rows = 1
    while rows < MAX_ROWS and rows * sms < types:
        rows *= 2
    return DominancePlan(rows=rows, threads_per_row=32, blocks=-(-types // rows))


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The card's streaming multiprocessors, read once a process."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


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
    plan = dominance_launch_plan(num_types, dims, sm_count(capacity.device.index))
    lib = LIBRARY.load()
    out = torch.empty(num_types, dtype=torch.float32, device=capacity.device)
    with launch_stream("dominance_prices", (capacity, prices, out)) as stream:
        status = lib.ktt_dominance_prices(
            capacity.data_ptr(), prices.data_ptr(), out.data_ptr(),
            num_types, dims, plan.rows, stream,
        )
    check_launch(status, "dominance_prices")
    dominance_prices.launches += 1
    return out


dominance_prices.launches = 0
