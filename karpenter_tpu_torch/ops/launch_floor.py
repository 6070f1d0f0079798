"""The card's launch floor: one launch of an empty kernel (csrc/launch_floor.cu).

No solve runs it. chip_smoke times it beside the port's smallest kernels: its
device time and the CUDA events around `empty_launch` are what any one launch
through the port's wrappers costs at the least. It has no plain version, as
it computes nothing; on a CPU tensor it raises.
"""

from __future__ import annotations

import ctypes

import torch

from karpenter_tpu_torch.ops.cuda_build import CudaLibrary, check_launch, launch_stream

LIBRARY = CudaLibrary("launch_floor.cu", {"ktt_empty_launch": (ctypes.c_int, [ctypes.c_void_p])})


def empty_launch(anchor: torch.Tensor) -> None:
    """Launch the empty kernel on the current stream of `anchor`'s device,
    through launch_stream as every kernel wrapper does."""
    if anchor.device.type != "cuda":
        raise ValueError(f"empty_launch: the launch floor is a card's; got {anchor.device}")
    lib = LIBRARY.load()
    with launch_stream("empty_launch", (anchor,)) as stream:
        status = lib.ktt_empty_launch(stream)
    check_launch(status, "empty_launch")
    empty_launch.launches += 1


empty_launch.launches = 0
