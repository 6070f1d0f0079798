"""The one device verdict of the port.

Entry points run on the card unless the caller asks for the CPU: a device of
None resolves to CUDA, and the CUDA route requires a Hopper card (compute
capability 9.0, the sm_90a target the kernels are built for). Without one it
raises; it never drops to the CPU on its own. Only an explicit "cpu" selects
the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

from typing import Union

import torch

REQUIRED_CAPABILITY = (9, 0)

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """Map a caller's device request to the device the solve runs on.

    None and "cuda" mean the current CUDA device; "cuda:N" names one. Raises
    RuntimeError when CUDA is unavailable or the card is not sm_90."""
    resolved = torch.device("cuda" if device is None else device)
    if resolved.type == "cpu":
        return resolved
    if resolved.type != "cuda":
        raise ValueError(f"unsupported device {resolved}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on an NVIDIA Hopper card; pass "
            "device='cpu' to run the plain PyTorch versions instead"
        )
    if resolved.index is None:
        resolved = torch.device("cuda", torch.cuda.current_device())
    capability = torch.cuda.get_device_capability(resolved)
    if capability != REQUIRED_CAPABILITY:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(resolved)} has compute capability "
            f"{capability}; the kernels are built for sm_90a ({REQUIRED_CAPABILITY})"
        )
    return resolved

