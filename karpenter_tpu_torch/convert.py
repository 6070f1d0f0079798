"""The state carried between the reference and the port.

This system has no weights: its state is the encoded problem. The reference's
`models/solver.pad_kernel_args` (and the port's) turn one schedule into six
padded numpy arrays; `fused_args_from_numpy` places them on a torch device
with the dtypes the fused solve takes, and `fused_outputs_to_numpy` brings the
fused solve's four outputs back as numpy, so a test compares like with like.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def fused_args_from_numpy(
    vectors: np.ndarray,
    counts: np.ndarray,
    capacity: np.ndarray,
    total: np.ndarray,
    valid: np.ndarray,
    prices: np.ndarray,
    device,
) -> Tuple[torch.Tensor, ...]:
    """(vectors f32 [G, R], counts i32 [G], capacity f32 [T, R], total f32
    [T, R], valid bool [T], prices f32 [T]) on `device`."""
    arrays = (
        (vectors, np.float32),
        (counts, np.int32),
        (capacity, np.float32),
        (total, np.float32),
        (valid, np.bool_),
        (prices, np.float32),
    )
    device = torch.device(device)
    tensors = (torch.from_numpy(np.ascontiguousarray(array, dtype=dtype)) for array, dtype in arrays)
    if device.type == "cuda":
        # From pinned memory the copies queue on the current stream and the
        # host goes on: no sync before the fused solve is enqueued.
        return tuple(tensor.pin_memory().to(device, non_blocking=True) for tensor in tensors)
    return tuple(tensor.to(device) for tensor in tensors)


def fused_outputs_to_numpy(
    compact: torch.Tensor,
    objective: torch.Tensor,
    dense: torch.Tensor,
    lp: torch.Tensor,
) -> Tuple[np.ndarray, ...]:
    """The fused solve's (compact payload, LP objective, dense spill, flat LP
    assignment) as numpy, in the reference's dtypes (int32, float32, int32,
    float32)."""
    return tuple(
        tensor.detach().cpu().numpy() for tensor in (compact, objective, dense, lp)
    )
