"""Multi-process bootstrap: the torch.distributed process group.

The port of karpenter_tpu/parallel/multihost.py. A sharded solve may span
processes (one per host, or several sharing a host's cards): every process
joins one torch.distributed process group, and `parallel.mesh.mesh_devices`
then lists the GLOBAL shard set, each process's own shards (its cards, or a
declared virtual set) in rank order, so `make_mesh()` and the sharded solve
(models/solver.py) span processes. Rank 0 leads every solve through
parallel/spmd.py; the other ranks run its follower loop.

Environment contract (the same three variables as the reference):
  KARPENTER_COORDINATOR        host:port of process 0 (absent = one process)
  KARPENTER_NUM_PROCESSES      total process count
  KARPENTER_PROCESS_ID         this process's rank, 0-based
With none of these set, the process runs alone. Every process of a group
holds the same number of shards.

The transport is chosen explicitly (`backend_for`): gloo on the CPU and for
processes that share one card (NCCL puts one rank on a card), NCCL between
distinct cards. A process group that fails to form raises: a process that
went on alone would deadlock the others at their first collective.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Optional

from karpenter_tpu_torch.utils import logging as klog

log = klog.named("parallel.multihost")

# Seconds a process waits for the whole group to form, and for any one
# collective, before the group raises.
DEFAULT_TIMEOUT_S = 300.0


@dataclass(frozen=True)
class DistributedConfig:
    coordinator: str
    num_processes: int
    process_id: int

    @staticmethod
    def from_env(environ=None) -> Optional["DistributedConfig"]:
        """None when multi-host is not configured (the common single-host
        case). Raises ValueError on a partial/inconsistent configuration —
        silently falling back to single-host would deadlock the other
        processes of the slice at their first collective."""
        environ = os.environ if environ is None else environ
        coordinator = environ.get("KARPENTER_COORDINATOR", "")
        num_processes = environ.get("KARPENTER_NUM_PROCESSES", "")
        process_id = environ.get("KARPENTER_PROCESS_ID", "")
        if not coordinator and not num_processes and not process_id:
            return None
        if not (coordinator and num_processes and process_id != ""):
            raise ValueError(
                "partial multi-host config: KARPENTER_COORDINATOR, "
                "KARPENTER_NUM_PROCESSES and KARPENTER_PROCESS_ID must all "
                f"be set (got coordinator={coordinator!r}, "
                f"num_processes={num_processes!r}, process_id={process_id!r})"
            )
        config = DistributedConfig(
            coordinator=coordinator,
            num_processes=int(num_processes),
            process_id=int(process_id),
        )
        if config.num_processes < 1:
            raise ValueError(f"num_processes must be >= 1, got {config.num_processes}")
        if not 0 <= config.process_id < config.num_processes:
            raise ValueError(
                f"process_id {config.process_id} out of range for "
                f"{config.num_processes} processes"
            )
        return config


def backend_for(device_type: str, shared_card: bool = False) -> str:
    """The process group's transport: gloo for CPU shards and for processes
    that share one card, NCCL between distinct cards."""
    if device_type == "cpu" or shared_card:
        return "gloo"
    if device_type == "cuda":
        return "nccl"
    raise ValueError(f"no transport for device type {device_type!r}")


def init_distributed(environ=None, backend: Optional[str] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group the environment describes. Returns True when a
    multi-process group is up (mesh_devices() now lists every process's
    shards), False for the single-process case. `backend` names the
    transport (backend_for); None takes backend_for of the card when one
    is visible, else of the CPU. Idempotent per process. A group that does
    not form within `timeout_s` raises."""
    import torch
    import torch.distributed as dist

    config = DistributedConfig.from_env(environ)
    if config is None:
        return False
    if dist.is_initialized():
        return True
    if backend is None:
        backend = backend_for("cuda" if torch.cuda.is_available() else "cpu")
    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://{config.coordinator}",
        world_size=config.num_processes,
        rank=config.process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    log.info(
        "multi-process group up over %s: process %d/%d",
        backend, dist.get_rank(), dist.get_world_size(),
    )
    return True


def shutdown_distributed() -> None:
    """Leave the process group: every process calls it once it is done with
    collectives (the followers after the lead's stop, the lead after
    lead_stop). A barrier first, so that no process tears the group down
    under another that is still in it; a process that exits with the group
    up can abort in the transport's threads."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def process_count() -> int:
    """The processes of the group (1 without one): the port's
    jax.process_count()."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    """This process's rank (0 without a group): the port's
    jax.process_index()."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0

