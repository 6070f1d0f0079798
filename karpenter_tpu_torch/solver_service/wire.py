"""Tensor codecs and method constants for the solver wire protocol.

gRPC service stubs are hand-wired (grpc_tools isn't vendored; protoc only
generates the messages), so the method paths and (de)serializers live here
and both ends import them — the contract is in exactly one place.
"""

from __future__ import annotations

import numpy as np

from karpenter_tpu_torch.solver_service import solver_pb2 as pb

SERVICE = "karpenter.solver.v1.Solver"
SOLVE_METHOD = f"/{SERVICE}/Solve"
SOLVE_STREAM_METHOD = f"/{SERVICE}/SolveStream"
HEALTH_METHOD = f"/{SERVICE}/Health"

_DTYPES = {
    "f32": np.float32,
    "f64": np.float64,
    "i32": np.int32,
    "i64": np.int64,
    "bool": np.bool_,
}
_DTYPE_NAMES = {np.dtype(v): k for k, v in _DTYPES.items()}


def encode_tensor(array: np.ndarray) -> pb.Tensor:
    array = np.ascontiguousarray(array)
    name = _DTYPE_NAMES.get(array.dtype)
    if name is None:
        raise ValueError(f"unsupported wire dtype {array.dtype}")
    return pb.Tensor(shape=list(array.shape), dtype=name, data=array.tobytes())


def decode_tensor(message: pb.Tensor) -> np.ndarray:
    dtype = _DTYPES.get(message.dtype)
    if dtype is None:
        raise ValueError(f"unsupported wire dtype {message.dtype!r}")
    array = np.frombuffer(message.data, dtype=dtype)
    return array.reshape(tuple(message.shape)).copy()
