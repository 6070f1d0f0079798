"""Controller entry point.

The port of karpenter_tpu/cmd/controller.py (ref: cmd/controller/main.go:61-99)
— parse options, build logging, acquire leadership, construct the cloud
provider (installing its API hooks), register the controllers, serve metrics
+ health. The solver, encoder and consolidation solve run on the CUDA card
(`main(..., device="cpu")` runs the kernels' plain versions). The cluster
store is `--cluster-store`: "memory" (the default), an apiserver over HTTP
(`http://host:port` or `https://...`), or "incluster" (the pod's service
account), each through `kubeapi.ApiServerCluster`; `--cloud-provider ec2`
launches through `cloudprovider/ec2` (its `FakeEc2` unless an AWS API is
wired in).

Run: python -m karpenter_tpu_torch.cmd.controller --cluster-name my-cluster
"""

from __future__ import annotations

import os
import signal
import sys
import threading

from karpenter_tpu_torch.cloudprovider import registry
from karpenter_tpu_torch.controllers.cluster import Cluster
from karpenter_tpu_torch.device import DeviceLike
from karpenter_tpu_torch.runtime import LeaderElector, LeaderLock, Manager, serve_http
from karpenter_tpu_torch.utils.gctune import tune_gc
from karpenter_tpu_torch.utils import logging as klog
from karpenter_tpu_torch.utils import options as options_pkg


def build_cluster(options) -> Cluster:
    """Select the cluster-store backend (ref: cmd/controller/main.go:61-99 —
    the reference always reconciles a live apiserver; --cluster-store wires
    the same here, with the in-memory store for standalone/dev runs)."""
    from karpenter_tpu_torch.kubeapi import ApiServerCluster, KubeClient, RetryPolicy
    from karpenter_tpu_torch.kubeapi.client import HttpTransport

    transport = HttpTransport.for_store(options.cluster_store)
    if transport is None:
        return Cluster()
    transport.watch_idle_s = options.kube_watch_idle_timeout
    client = KubeClient(
        transport,
        qps=options.kube_client_qps,
        burst=options.kube_client_burst,
        retry=RetryPolicy(
            max_attempts=options.kube_retry_max_attempts,
            backoff_base_s=options.kube_retry_backoff_base,
            backoff_cap_s=options.kube_retry_backoff_cap,
        ),
    )
    return ApiServerCluster(client).start()


def main(
    argv=None, cluster: Cluster = None, block: bool = True, device: DeviceLike = None
) -> Manager:
    tune_gc()  # long-running service: GOGC-style collector headroom
    options = options_pkg.parse(argv)
    log = klog.setup(options.log_level)
    log.info(
        "starting karpenter-tpu controller for cluster %s (store=%s)",
        options.cluster_name,
        options.cluster_store,
    )

    cluster = cluster if cluster is not None else build_cluster(options)
    cloud = registry.new_cloud_provider(options.cloud_provider)
    # Manager is constructed (but not started) before the campaign so the
    # lease-loss callback has something concrete to stop — no window where a
    # loss arrives with nothing wired.
    manager = Manager(cluster, cloud, options, device=device)
    stop = threading.Event()

    def on_lost_lease():
        # Reference behavior: a deposed leader must stop reconciling and get
        # replaced (cmd/controller/main.go exits on lost lease). Stopping the
        # manager flips /healthz to 503 so the liveness probe restarts the
        # pod; in block mode the process also exits.
        log.error("leadership lost; stopping controller")
        manager.stop()
        stop.set()

    identity = f"{os.uname().nodename}-{os.getpid()}"
    # Two layers of mutual exclusion: the host-level file lock guards
    # multiple processes on one machine; the store-level lease guards
    # replicas ONLY when they share a cluster store. With the default
    # in-memory store each replica holds its own private lease, so there is
    # no cross-replica exclusion — the chart pins replicas to 1 for exactly
    # this reason (values.yaml). An apiserver-backed store makes the lease a
    # real coordination.k8s.io Lease and lifts that restriction.
    file_lock = LeaderLock()
    elector = LeaderElector(cluster, identity, on_lost=on_lost_lease)
    # A caller that does not block (block=False) releases the lease itself.
    manager.elector = elector
    # Probe + metrics servers come up BEFORE the campaign: a campaigning
    # standby must answer /healthz 200 and /readyz 503 "standby", or the
    # liveness probe kills every replica that isn't currently leader and
    # there is never a warm standby to fail over to.
    serve_http(manager, options.metrics_port)
    # Separate probe port, matching the reference's split (manager.go:52-57)
    # and the chart's liveness/readiness wiring.
    serve_http(manager, options.health_probe_port)
    if options.leader_election:
        log.info("campaigning for leadership as %s", identity)
        # Warm standby while waiting: watch pump + informer cache +
        # DeviceClusterState sync are already live (cluster built above);
        # this pre-pays the solver compile debt so takeover has bounded
        # time-to-first-launch.
        manager.start_standby()
        file_lock.acquire(blocking=True)
        campaign_began = cluster.clock.now()
        elector.acquire(blocking=True)
        lease = cluster.get_lease(LeaderElector.LEASE_NAME)
        log.info(
            "leadership acquired after %.1fs; holder %s generation %s",
            cluster.clock.now() - campaign_began,
            lease and lease[0],
            elector.generation,
        )

    manager.start()
    log.info(
        "controller ready: metrics on :%d, health on :%d, solver=%s, cloud=%s",
        options.metrics_port,
        options.health_probe_port,
        options.solver,
        options.cloud_provider,
    )

    if block:
        signal.signal(signal.SIGTERM, lambda *_: stop.set())
        signal.signal(signal.SIGINT, lambda *_: stop.set())

        def on_sighup(*_):
            # Live reload of the RELOADABLE subset (log level, SLO targets):
            # re-parse the original argv, which re-reads env fallbacks too.
            try:
                fresh = options_pkg.parse(argv)
            except Exception:  # noqa: BLE001 — a bad env edit must not kill us
                log.exception("SIGHUP reload failed; keeping current options")
                return
            manager.reload_options(options_pkg.apply_reload(options, fresh))

        signal.signal(signal.SIGHUP, on_sighup)
        # A Manager that stops itself (a warmup that failed on the card)
        # ends the process too.
        while not stop.wait(timeout=1.0) and manager.healthy():
            pass
        manager.stop()
        elector.release()
        file_lock.release()
        if manager.warmup_error is not None:
            raise RuntimeError("the solver warmup failed on the card") from manager.warmup_error
    return manager


if __name__ == "__main__":
    main(sys.argv[1:])
