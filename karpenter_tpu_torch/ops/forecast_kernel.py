"""K10, the interruption-forecast price penalty: the port of the reference's
`market/forecast.penalize_prices_jnp`.

effective[t] = float32(prices[t] + (prices[t] * risks[t]) * weight), each
product and the sum rounded on its own, in the order of the numpy column
`market/forecast.penalize_prices` that build_fleet publishes. The
hand-written kernel lives in csrc/forecast.cu; `_penalize_prices_ref` is its
plain PyTorch version.

As in the reference, the solve consumes the numpy column (so the device
kernels and every numpy host mirror read the same bits); this kernel is the
tripwire that the device arithmetic gives those bits too.

`penalize_prices` routes by where its tensors lie: a CPU tensor goes to the
plain version, a CUDA tensor to the kernel, with no fallback between them.
"""

from __future__ import annotations

import ctypes

import torch

from karpenter_tpu_torch.ops.cuda_build import CudaLibrary, check_launch

LIBRARY = CudaLibrary(
    "forecast.cu",
    {
        "ktt_penalize_prices": (
            ctypes.c_int,
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_void_p],
        ),
    },
)


def _penalize_prices_ref(prices: torch.Tensor, risks: torch.Tensor, weight: float) -> torch.Tensor:
    """Plain formulation — the CPU path, and what the kernel is held against:
    three float32 operations, each rounded, in numpy's order (a Python
    float scalar takes the tensor's float32, as np.float32(weight) does)."""
    return prices + (prices * risks) * weight


def _check_args(prices: torch.Tensor, risks: torch.Tensor) -> None:
    if prices.dtype != torch.float32 or risks.dtype != torch.float32:
        raise TypeError("penalize_prices takes float32 prices and risks")
    if prices.dim() != 1 or risks.shape != prices.shape:
        raise ValueError(
            f"penalize_prices takes prices [T] and risks [T], got "
            f"{tuple(prices.shape)} and {tuple(risks.shape)}"
        )
    if prices.device != risks.device:
        raise ValueError("prices and risks must lie on one device")


def penalize_prices(prices: torch.Tensor, risks: torch.Tensor, weight: float) -> torch.Tensor:
    """Penalised prices: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    _check_args(prices, risks)
    if prices.device.type == "cpu":
        return _penalize_prices_ref(prices, risks, weight)
    if prices.device.type != "cuda":
        raise ValueError(f"penalize_prices: unsupported device {prices.device}")
    num_types = prices.shape[0]
    if num_types == 0:
        return torch.empty_like(prices)
    if not (prices.is_contiguous() and risks.is_contiguous()):
        raise ValueError("penalize_prices kernel takes contiguous tensors")
    lib = LIBRARY.load()
    out = torch.empty_like(prices)
    with torch.cuda.device(prices.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.ktt_penalize_prices(
            prices.data_ptr(), risks.data_ptr(), float(weight), out.data_ptr(),
            num_types, stream,
        )
    check_launch(status, "penalize_prices")
    penalize_prices.launches += 1
    return out


penalize_prices.launches = 0
