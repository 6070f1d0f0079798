"""Build the port's CUDA sources with nvcc and bind them through ctypes.

Each kernel source under `karpenter_tpu_torch/csrc/` is compiled on its own
into a shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), named by a hash of the source and the flags, in the package's
git-ignored `build/` directory. A library is built at its first use, or ahead
of time for all sources at once by `build_all`, which starts one nvcc per
source together and waits for all of them.

There is no fallback: a missing nvcc or a failed build raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

import torch

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PACKAGE_DIR / "csrc"
BUILD_DIR = _PACKAGE_DIR / "build"

# sm_90a (Hopper); fp32 stays IEEE: no fast math, no multiply-add contraction.
# -Xptxas -v reports registers and shared memory per kernel on stderr.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
_BUILD_TIMEOUT_S = 600


def _nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


class CudaLibrary:
    """One csrc/*.cu source, its built library, and its C functions'
    signatures: {name: (restype, [argtypes])}."""

    def __init__(self, source: str, signatures: Dict[str, tuple]):
        self.source = CSRC_DIR / source
        self._signatures = signatures
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()
        self.build_log = ""

    def library_path(self) -> Path:
        # The headers under csrc/ count too: a source may include any of them.
        headers = b"".join(path.read_bytes() for path in sorted(CSRC_DIR.glob("*.cuh")))
        digest = hashlib.sha256(self.source.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.source.stem}-{digest.hexdigest()[:16]}.so"

    def start_build(self) -> Optional["_Build"]:
        """Start nvcc for this source unless its library exists already."""
        target = self.library_path()
        if target.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        partial = target.with_suffix(f".{os.getpid()}.tmp")
        process = subprocess.Popen(
            [_nvcc_path(), *NVCC_FLAGS, "-o", str(partial), str(self.source)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        return _Build(self, process, partial, target)

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                build = self.start_build()
                if build is not None:
                    build.finish()
                lib = ctypes.CDLL(str(self.library_path()))
                for name, (restype, argtypes) in self._signatures.items():
                    function = getattr(lib, name)
                    function.restype = restype
                    function.argtypes = argtypes
                self._lib = lib
            return self._lib


class _Build:
    def __init__(self, library: CudaLibrary, process, partial: Path, target: Path):
        self.library = library
        self.process = process
        self.partial = partial
        self.target = target

    def finish(self) -> None:
        try:
            output, _ = self.process.communicate(timeout=_BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            self.process.kill()
            self.process.communicate()
            self.partial.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc timed out building {self.library.source.name}")
        self.library.build_log = output
        if self.process.returncode != 0 or not self.partial.exists():
            self.partial.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed building {self.library.source.name}:\n{output}"
            )
        # Rename into place: a concurrent loader never sees a partial file.
        os.replace(self.partial, self.target)


def build_all(libraries: Sequence[CudaLibrary]) -> float:
    """Build every library that is not built yet, one nvcc per source, all
    started together. Returns the wall seconds the builds took."""
    start = time.perf_counter()
    builds: List[_Build] = []
    try:
        for library in libraries:
            build = library.start_build()
            if build is not None:
                builds.append(build)
    finally:
        errors = []
        for build in builds:
            try:
                build.finish()
            except RuntimeError as error:
                errors.append(str(error))
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - start


def port_libraries() -> List[CudaLibrary]:
    """Every kernel source of the port, one library each: K1, K2 (with K4
    in its epilogue), K3, K7, K6, K8, K10, K9a and K9b."""
    from karpenter_tpu_torch.ops import (
        consolidate_kernel,
        cuda_kernels,
        forecast_kernel,
        incremental,
        lp_shard_kernel,
        pack_kernel,
        score_kernel,
    )

    return [
        cuda_kernels.LIBRARY, pack_kernel.LIBRARY, score_kernel.LIBRARY,
        consolidate_kernel.LIBRARY, pack_kernel.LEVELS_LIBRARY,
        incremental.LIBRARY, forecast_kernel.LIBRARY, lp_shard_kernel.LIBRARY,
        pack_kernel.COMPACT_SHARD_LIBRARY,
    ]


@contextlib.contextmanager
def launch_stream(kernel: str, tensors: Sequence[torch.Tensor]) -> Iterator[int]:
    """Make the one device every operand of `kernel` lies on current, and
    yield the raw handle of that device's current stream: a launch inside
    the block runs in the operands' context and queues behind the work that
    produced them, whichever device is current outside it. Raises when the
    operands span devices."""
    devices = {tensor.device for tensor in tensors}
    if len(devices) != 1:
        raise ValueError(f"{kernel}: operands span devices {sorted(str(d) for d in devices)}")
    device = devices.pop()
    with torch.cuda.device(device):
        yield torch.cuda.current_stream(device).cuda_stream


def check_launch(status: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {status}")
