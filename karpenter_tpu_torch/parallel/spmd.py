"""SPMD work distribution for the multi-process sharded solve.

The port of karpenter_tpu/parallel/spmd.py. A solve over a mesh that spans
processes (parallel/multihost.py) must be run by EVERY process of the
group, or the first collective deadlocks. Only rank 0 takes solves (it runs
the controller, or the sidecar), so each solve is replicated to the group
through this module:

  rank 0   SpmdDispatcher.lead_dispatch(): broadcast a fixed-shape header
           [op, G, T, lp_steps, trace_lo, trace_hi], then the mesh's shard
           mask, then the padded operands, then run the sharded fused
           solve — the same call every follower makes.
  rank >0  follower_loop(): block on the next header broadcast, rebuild the
           mesh from the shard mask and the operand shapes from the header,
           receive the operands, run the SAME solve over its own shards,
           and wait for the next header. An OP_STOP header ends the loop
           (lead_stop() on a clean shutdown; a dead lead surfaces as a
           collective error, which also ends it).

The shard-mask leg keeps a DEGRADED mesh coherent across the group: when
MeshHealth quarantines a wedged card on the lead, the mask names the
surviving shards and every follower solves over the identical shrunk mesh.
A one-sided shrink would desynchronize the collective order.

Every leg, and every cross-process reduction inside the solve
(parallel/collectives.py), rides `transport`: one torch.distributed
broadcast from a source rank, over the group's backend (gloo or NCCL).
gloo takes CUDA tensors only for some collectives, so on gloo a tensor on
the card is staged through pinned host memory; that is transport, and the
kernels still run on the card. Solves are serialized under the
dispatcher's lock on rank 0, held until the card finishes, because every
process must issue its collectives in the same order.

A transport that cannot carry the group's collectives (an op the backend
does not implement, a device type it does not take, two NCCL ranks on one
card) raises SpmdUnsupportedError at the first broadcast, instead of
leaving a half-formed group to hang.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from karpenter_tpu_torch.utils import logging as klog
from karpenter_tpu_torch.utils.tracing import (
    TRACER,
    trace_id_to_words,
    words_to_trace_id,
)

log = klog.named("parallel.spmd")

OP_STOP = 0
OP_SOLVE = 1

# Header layout: [op, g_pad, t_pad, lp_steps, trace_lo, trace_hi]. The two
# trace words carry the provisioning batch's trace id (tracing.new_trace_id,
# split into 31-bit halves for the int32 transport) so follower-side spans
# land under the SAME trace as the lead's. (0, 0) means "no trace current".
HEADER_WORDS = 6

# The backend-capability signatures: what torch.distributed raises when a
# backend cannot carry a collective at all (c10d's "Backend gloo does not
# support allgather", gloo's unsupported device types, NCCL's refusal of
# two ranks on one card), as opposed to a peer that died.
COLLECTIVES_UNSUPPORTED_SIGNATURES = (
    "does not support",
    "unsupported device type",
    "duplicate gpu detected",
)

# The padded operands' dtypes, in kernel order: vectors, counts, capacity,
# total, valid (a bool mask, which rides as uint8), prices.
_OPERAND_DTYPES = (np.float32, np.int32, np.float32, np.float32, np.uint8, np.float32)

# Every broadcast `transport` made in this process, and the seconds spent in
# them, staging included (a solve's share is the difference around it).
TRANSPORT = {"broadcasts": 0, "seconds": 0.0}


class SpmdUnsupportedError(RuntimeError):
    """The transport cannot carry the group's collectives (see
    COLLECTIVES_UNSUPPORTED_SIGNATURES) — raised instead of deadlocking the
    group."""


def collectives_unsupported(error: BaseException) -> bool:
    text = str(error).lower()
    return any(signature in text for signature in COLLECTIVES_UNSUPPORTED_SIGNATURES)


def transport(tensor: torch.Tensor, src: int) -> torch.Tensor:
    """One broadcast of `tensor` from rank `src` to every process of the
    group: `src` passes its value, the others a buffer of the same shape and
    dtype. Returns the value on the buffer's device. On gloo a CUDA tensor
    rides through pinned host memory, on NCCL a host tensor through the
    current card."""
    import torch.distributed as dist

    start = time.perf_counter()
    backend = dist.get_backend()
    if tensor.device.type == "cuda" and backend == "gloo":
        staged = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
        staged.copy_(tensor)
    elif tensor.device.type == "cpu" and backend == "nccl":
        staged = tensor.to(torch.device("cuda", torch.cuda.current_device()))
    else:
        staged = tensor.contiguous()
    try:
        dist.broadcast(staged, src=src)
    except Exception as error:  # noqa: BLE001 — classify, then re-raise
        if collectives_unsupported(error):
            raise SpmdUnsupportedError(
                "multi-process dispatch needs cross-process collectives, which "
                f"the {backend} transport cannot carry here: {error}"
            ) from error
        raise
    out = tensor if staged is tensor else staged.to(tensor.device)
    TRANSPORT["broadcasts"] += 1
    TRANSPORT["seconds"] += time.perf_counter() - start
    return out


def _broadcast(value: np.ndarray) -> np.ndarray:
    """Rank 0's `value` on every process (the others pass a buffer of its
    shape and dtype)."""
    return transport(torch.from_numpy(np.ascontiguousarray(value)), 0).numpy()


def is_multiprocess() -> bool:
    from karpenter_tpu_torch.parallel.multihost import process_count

    return process_count() > 1


def _host(array, dtype) -> np.ndarray:
    if isinstance(array, torch.Tensor):
        array = array.cpu().numpy()
    return np.ascontiguousarray(np.asarray(array).astype(dtype, copy=False))


def _broadcast_operands(padded):
    """Broadcast the six padded kernel operands as ONE collective: their
    bytes in one uint8 buffer (the follower knows every shape from the
    header). Returns numpy arrays, the bool mask as bool."""
    arrays = [_host(array, dtype) for array, dtype in zip(padded, _OPERAND_DTYPES)]
    packed = _broadcast(np.concatenate([array.reshape(-1).view(np.uint8) for array in arrays]))
    out, cursor = [], 0
    for array, dtype in zip(arrays, _OPERAND_DTYPES):
        size = array.size * np.dtype(dtype).itemsize
        out.append(packed[cursor : cursor + size].view(dtype).reshape(array.shape))
        cursor += size
    vectors, counts, capacity, total, valid, prices = out
    return vectors, counts, capacity, total, valid.astype(bool), prices


def _device_mask(mesh) -> np.ndarray:
    """[global shard count] uint8 membership mask of the mesh's shard ids —
    the fixed-shape leg that replicates a (possibly shrunk) mesh to the
    followers."""
    from karpenter_tpu_torch.parallel.mesh import mesh_devices

    mask = np.zeros(len(mesh_devices(mesh.device_type)), np.uint8)
    for shard_id in mesh.ids():
        mask[int(shard_id)] = 1
    return mask


def _mesh_from_mask(mask: np.ndarray, kind: str = "cuda"):
    from karpenter_tpu_torch.parallel.mesh import make_mesh, mesh_devices

    by_id = {shard.id: shard for shard in mesh_devices(kind)}
    return make_mesh([by_id[int(i)] for i in np.nonzero(mask)[0]])


def _synchronize(mesh) -> None:
    """Wait until the card has finished a solve over `mesh`: the current
    stream of each of this process's devices, where the solve ran."""
    for device in mesh.devices:
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()


class SpmdDispatcher:
    """Rank 0's dispatch serializer. Collectives must be issued in the same
    order on every process, so every lead-side broadcast round — dispatch
    and stop alike — runs under one lock, held through device completion
    (the follower finishes ITS solve before the next header, so a second
    lead dispatch racing ahead would desynchronize the collective order)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stopped = False  # guarded by self._lock: no dispatch after stop
        self._dispatched = 0  # guarded by self._lock: solves replicated so far

    def lead_dispatch(self, kernel, padded, lp_steps: int, mesh=None):
        """Rank 0: replicate one solve to every process, then run it:
        kernel(*operands, lp_steps=lp_steps) on the broadcast operands.
        Returns the kernel's outputs, ALREADY complete on the card (unlike
        the one-process path's asynchronous dispatch): multi-process solves
        serialize, and a batch's one shared fetch becomes a round trip a
        solve."""
        g_pad = int(padded[0].shape[0])
        t_pad = int(padded[2].shape[0])
        trace_lo, trace_hi = trace_id_to_words(TRACER.current_trace())
        with self._lock:
            if self._stopped:
                raise RuntimeError("SPMD dispatcher already stopped")
            if mesh is None:
                raise ValueError("a multi-process dispatch names its mesh")
            _broadcast(
                np.array(
                    [OP_SOLVE, g_pad, t_pad, lp_steps, trace_lo, trace_hi],
                    np.int32,
                )
            )
            _broadcast(_device_mask(mesh))
            operands = _broadcast_operands(padded)
            out = kernel(*operands, lp_steps=lp_steps)
            self._dispatched += 1
            # Hold the lock until the card completes: see the class docstring.
            _synchronize(mesh)
        return out

    def lead_stop(self) -> None:
        """Rank 0, clean shutdown: release every follower from its header
        wait. Idempotent — a second stop must not issue a second collective
        no follower is waiting for."""
        if not is_multiprocess():
            return
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            _broadcast(np.zeros(HEADER_WORDS, np.int32))


DISPATCHER = SpmdDispatcher()


def lead_dispatch(kernel, padded, lp_steps: int, mesh=None):
    return DISPATCHER.lead_dispatch(kernel, padded, lp_steps, mesh=mesh)


def lead_stop() -> None:
    DISPATCHER.lead_stop()


def follower_step(dims: int, device=None):
    """One follower protocol round: header, shard mask, operands, solve.
    Returns the solve's outputs (complete on the card), or None on OP_STOP.
    `device` names the type of the mesh's devices (None: the card). Split
    from follower_loop so the loopback tests can drive the REAL follower
    code through an injected transport on a one-process mesh."""
    from karpenter_tpu_torch.device import resolve_device
    from karpenter_tpu_torch.models.solver import _sharded_fused_solve
    from karpenter_tpu_torch.parallel.mesh import mesh_devices

    header = _broadcast(np.zeros(HEADER_WORDS, np.int32))
    op, g_pad, t_pad, lp_steps, trace_lo, trace_hi = (int(x) for x in header)
    if op == OP_STOP:
        return None
    kind = resolve_device(device).type
    mask = _broadcast(np.zeros(len(mesh_devices(kind)), np.uint8))
    padded = (
        np.zeros((g_pad, dims), np.float32),
        np.zeros(g_pad, np.int32),
        np.zeros((t_pad, dims), np.float32),
        np.zeros((t_pad, dims), np.float32),
        np.zeros(t_pad, bool),
        np.zeros(t_pad, np.float32),
    )
    operands = _broadcast_operands(padded)
    mesh = _mesh_from_mask(mask, kind)
    # The follower's span carries the lead's batch trace id (header words),
    # so its lane stitches into the same cross-process timeline.
    with TRACER.trace(words_to_trace_id(trace_lo, trace_hi)), TRACER.span(
        "spmd.follower.step", g_pad=g_pad, t_pad=t_pad
    ):
        out = _sharded_fused_solve(operands, mesh, lp_steps, mesh.devices[0])
        _synchronize(mesh)
    return out


def follower_loop(device=None) -> int:
    """Ranks > 0: mirror every lead dispatch until OP_STOP. Returns the
    solves run."""
    from karpenter_tpu_torch.api import wellknown
    from karpenter_tpu_torch.parallel.multihost import process_count, process_index

    log.info("SPMD follower %d/%d up", process_index(), process_count())
    solves = 0
    while follower_step(wellknown.NUM_RESOURCE_DIMS, device) is not None:
        solves += 1
    log.info("SPMD follower %d stopping after %d solves", process_index(), solves)
    return solves
