"""Runtime: the controller-manager process shell, trimmed to the provisioning
pass under a live spot market.

The port of karpenter_tpu/runtime.py's `make_solver` and `Manager.__init__`:
the Manager builds, in the reference's order, the incremental encoder
(`DeviceClusterState`), the pod-latency tracker and flight recorder, the
provisioning and selection controllers, and the market: one `PriceBook`
made the process's active book, attached to the cloud provider so its
advertised spot prices track it, and folded by the `MarketController`,
whose debounced reprices requeue the provisioners.

The device is explicit: `Manager(cluster, cloud, options, device=None)` runs
its solver and encoder on the CUDA card and raises without one;
`device="cpu"` runs the kernels' plain versions.

Left out, against the reference: the threaded `start` / `_batch_loop` /
reconcile loops, `/healthz` and `/readyz` (readiness gates on the solver's
warmup), leader election and `cmd/controller.py`, which come with the
warmup slice; and the termination, node, counter, metrics, podgc,
instancegc, interruption, health, consolidation and drift controllers with
the disruption ledger. A caller drives the controllers' `reconcile` and the
workers' `provision` itself, as the reference's tests do.
"""

from __future__ import annotations

from karpenter_tpu_torch.controllers.cluster import Cluster
from karpenter_tpu_torch.controllers.market import MarketController
from karpenter_tpu_torch.controllers.provisioning import ProvisioningController
from karpenter_tpu_torch.controllers.selection import SelectionController
from karpenter_tpu_torch.device import DeviceLike
from karpenter_tpu_torch.models.cluster_state import DeviceClusterState
from karpenter_tpu_torch.models.solver import (
    CostSolver,
    GreedySolver,
    NativeSolver,
    TPUSolver,
)
from karpenter_tpu_torch.market.pricebook import PriceBook, set_active_book
from karpenter_tpu_torch.utils import logging as klog
from karpenter_tpu_torch.utils.obs import OBS, RECORDER
from karpenter_tpu_torch.utils.options import Options


def make_solver(name: str, endpoint: str = "", device: DeviceLike = None):
    """The solver a Manager runs, by its --solver name. `device` places the
    device-backed solvers (ffd, cost): None is the card."""
    if name == "remote":
        raise ValueError(
            "solver 'remote' (the solver sidecar, solver_service/) is not ported"
        )
    if name == "greedy":
        return GreedySolver()
    if name == "native":
        # Front-load the build here, at startup, rather than inside the first
        # reconcile; degrade loudly if no toolchain.
        from karpenter_tpu_torch.ops import native

        if not native.available():
            klog.named("runtime").warning(
                "solver=native requested but the native library is "
                "unavailable (no C++ toolchain?); falling back to greedy"
            )
            return GreedySolver()
        return NativeSolver()
    if name == "ffd":
        return TPUSolver(mode="ffd", device=device)
    if name == "cost":
        return CostSolver(device=device)
    raise ValueError(f"unknown solver {name!r}")


class Manager:
    """The reference's Manager wiring for provisioning under a live market."""

    def __init__(self, cluster: Cluster, cloud, options: Options, device: DeviceLike = None):
        self.cluster = cluster
        self.cloud = cloud
        self.options = options
        self.log = klog.named("manager")
        self.solver = make_solver(options.solver, options.solver_endpoint, device)
        # The incremental encoder rides the store's verb-level watch feed and
        # keeps the pending pods' group tensors on the device, O(churn).
        self.cluster_state = DeviceClusterState(
            cluster,
            compaction_threshold=options.encode_compaction_threshold,
            device=device,
        )
        # The pod-latency tracker rides the same watch feed; it shares the
        # store's clock so phase deltas are honest under fake clocks.
        OBS.configure(
            clock=cluster.clock,
            slo_pending_p99=options.slo_pending_p99,
            slo_ttfl=options.slo_ttfl,
        )
        RECORDER.configure(clock=cluster.clock)
        OBS.attach(cluster)
        self.provisioning = ProvisioningController(
            cluster, cloud, self.solver, cluster_state=self.cluster_state,
            queue_max_pods=options.provision_queue_max_pods,
        )
        self.selection = SelectionController(cluster, self.provisioning)
        # ONE PriceBook per controller process: set_active_book makes it the
        # book the solver-layer penalty and cache hooks read, attach_market
        # makes the provider's advertised spot prices track it, and the
        # market sweep requeues the provisioners on debounced reprices.
        self.price_book = PriceBook(
            clock=cluster.clock,
            reprice_threshold=options.reprice_threshold,
        )
        set_active_book(self.price_book)
        cloud.attach_market(self.price_book)
        self.market = MarketController(
            cluster,
            cloud,
            self.price_book,
            debounce_seconds=options.reprice_debounce,
            sweep_seconds=options.market_poll_interval
            or getattr(cloud, "MARKET_POLL_DEFAULT_S", 1.0),
        )
        self.market.requeue = self._reprice_requeue
        self.reprice_requeues = 0

    def _reprice_requeue(self) -> None:
        """The market sweep's requeue hook: a debounced reprice reconciles
        every provisioner NOW (the reference enqueues them, with a
        consolidation and a drift sweep, on its reconcile loops)."""
        self.reprice_requeues += 1
        for provisioner in self.cluster.list_provisioners():
            self.provisioning.reconcile(provisioner.name)
