"""Static configuration: flags + environment defaults.

Ref: pkg/utils/options/options.go:27-69 and pkg/utils/env/env.go — the
reference parses flags with env-var fallbacks, validates at boot, and injects
the result through context. We parse argv/env into an Options dataclass that
the runtime threads through explicitly.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass, field
from typing import List, Optional


class OptionsError(Exception):
    pass


def _env(name: str, default: str) -> str:
    return os.environ.get(name, default)


@dataclass
class Options:
    cluster_name: str = ""
    cluster_endpoint: str = ""
    metrics_port: int = 8080  # ref: main.go:83 / chart deployment.yaml:37-41
    health_probe_port: int = 8081  # ref: manager.go:52-57
    kube_client_qps: float = 200.0  # ref: options.go:33
    kube_client_burst: int = 300  # ref: options.go:34
    # Kube API retry envelope (kubeapi/client.py RetryPolicy; see
    # docs/design/chaos.md for the policy table and docs/operations.md for
    # when to tune these): attempt budget per request, then the capped
    # exponential backoff between attempts. Raise the cap when riding out
    # long apiserver brownouts; lower attempts to fail fast into the
    # reconcile loops' own backoff.
    kube_retry_max_attempts: int = 5
    kube_retry_backoff_base: float = 0.1
    kube_retry_backoff_cap: float = 5.0
    # Watch read-deadline: a watch stream quiet for this long is torn and
    # reconnected (an apiserver that stops sending bytes must not hang the
    # pump forever). Keep well above the server's bookmark cadence.
    kube_watch_idle_timeout: float = 300.0
    solver: str = "cost"  # cost | ffd | greedy | native | remote
    solver_endpoint: str = ""  # remote: host:port of the solver sidecar
    cloud_provider: str = "fake"
    leader_election: bool = True
    log_level: str = "info"
    # Cluster-store backend (ref: manager.go:33-66 — the reference always
    # talks to a live apiserver; we also keep the in-memory store for tests
    # and standalone runs):
    #   memory     — in-process store (the envtest analogue)
    #   incluster  — apiserver via the mounted serviceaccount
    #   <URL>      — apiserver at an explicit base URL (kubeconfig-less dev;
    #                token from KUBE_TOKEN, CA from KUBE_CA_FILE)
    cluster_store: str = "memory"
    # Selection reconcile threads. The reference runs selection at
    # MaxConcurrentReconciles=10,000 (selection/controller.go:166) because
    # each reconcile blocks on network I/O; here reconciles read the
    # informer cache (CPU-bound under the GIL), and the pod-storm benchmark
    # (bench.py bench_pod_storm: 10k pods through the running Manager) shows
    # ~1.8s drain at 8 threads and within ~20% of that at 128 (chunked
    # dispatch + wake coalescing keep the pool flat; overflow backlog
    # lives in the worker) — so the envelope is the cheapest setting that
    # keeps up: 8.
    selection_concurrency: int = 8
    # Fraction of an interruption's reclaim window spent draining politely
    # (PDB-respecting, do-not-evict honored) before the drain overrides both
    # rather than losing pods to the reclaim (controllers/interruption.py).
    interruption_escalate_fraction: float = 0.5
    # Disruption budget for the consolidation sweep: at most this many nodes
    # voluntarily disrupted per sweep (in-flight victims count against it);
    # 0 disables consolidation entirely (controllers/consolidation.py).
    consolidation_max_disruption: int = 1
    # Seconds of quiet after any interruption/termination activity before
    # consolidation acts again — the voluntary path yields to reclamation.
    consolidation_cooldown: float = 60.0
    # Fleet-wide voluntary-disruption budget (controllers/eligibility.py
    # DisruptionLedger): at most this many voluntary disruptions —
    # consolidation + drift/expiration + emptiness deletes together — may
    # be in flight at once; 0 disables ALL voluntary disruption. Per-reason
    # caps (consolidation-max-disruption, drift-max-disruption) nest inside.
    disruption_budget: int = 10
    # Whether the drift sweep runs at all (spec-hash, provider-side, and
    # expiration detection; controllers/drift.py).
    drift_enabled: bool = True
    # Per-sweep cap on NEW drift/expiration victims (the drift reason's
    # slice of the shared budget); 0 pauses drift replacement while leaving
    # detection (drift_nodes gauge) running.
    drift_max_disruption: int = 2
    # Pod-latency SLO targets (utils/obs.py SloEvaluator): rolling-window
    # p99 ceilings for end-to-end pending time and time-to-first-launch.
    # Exceeding a target counts slo_breaches_total{slo} and triggers a
    # flight-recorder dump (KARPENTER_FLIGHT_DIR). 0 disables the objective
    # — the gauges still publish. See docs/design/observability.md.
    slo_pending_p99: float = 0.0
    slo_ttfl: float = 0.0
    # Live market dynamics (karpenter_tpu/market): relative spot-discount
    # drift (vs the pool's anchor at its last reprice) that bumps the
    # PriceBook generation — invalidating the compiled-envelope and fleet
    # caches and requeueing provisioning + consolidation. Smaller = more
    # responsive to drift, more re-solves. See docs/design/market.md and
    # the operations.md "price storm" runbook.
    reprice_threshold: float = 0.1
    # Per-pool floor between reprice-triggered requeues (seconds): bumps
    # inside the window coalesce, so a price storm costs at most one
    # re-solve per pool per window and cannot melt the sweep loops.
    reprice_debounce: float = 5.0
    # Market feed poll cadence (seconds). 0 (the default) = auto: the
    # provider's own MARKET_POLL_DEFAULT_S — 1s for the in-memory fake,
    # 15s on EC2 where each sweep is a paginated DescribeSpotPriceHistory
    # (the reference's drift requeue runs at 5 MINUTES). Set explicitly to
    # override either.
    market_poll_interval: float = 0.0
    # Tombstone-density trigger for the incremental encoder's masked
    # compaction (models/cluster_state.py): when freed-but-unreused slot
    # rows exceed this fraction of the high-water mark, live rows are
    # packed to the front and the device arrays re-uploaded (epoch bump).
    # Lower = tighter arrays, more re-uploads; 1.0 effectively disables
    # compaction. See docs/operations.md.
    encode_compaction_threshold: float = 0.5
    # Node-health ladder (controllers/health.py; docs/design/
    # node-lifecycle.md and the operations.md "unhealthy node" runbook):
    # heartbeat age past which a JOINED node counts unreachable — kube's
    # node-monitor-grace-period analogue. The escalation ladder engages
    # after STALE_OBSERVATIONS consecutive unhealthy sweeps.
    node_unreachable_timeout: float = 60.0
    # How long a node may exist without its kubelet EVER reporting before
    # the Liveness guard deletes it (controllers/node.py; replaces the old
    # LIVENESS_TIMEOUT_SECONDS constant as the wired value). Must cover the
    # instancegc launch grace: deleting a never-joined node earlier than
    # the GC's bootstrap window races a legitimately slow bootstrap.
    node_liveness_timeout: float = 900.0
    # Polite-drain budget for a confirmed-unhealthy node; past it the drain
    # escalates over PDBs and do-not-evict (counted on
    # drain_stalled_total{reason="unreachable"}) rather than leaving pods
    # on an unreachable node.
    drain_stuck_timeout: float = 120.0
    # Admission cap per provisioner worker (batch window + overflow
    # backlog). Past it, adds are REFUSED back onto selection's backoff
    # requeue (counted on provision_backpressure_total{reason="queue-full"})
    # instead of growing the overflow without bound — the overload story's
    # bounded-admission layer (docs/design/overload.md and the
    # operations.md "saturation" runbook).
    provision_queue_max_pods: int = 50_000

    def _kube_retry_errors(self) -> List[str]:
        """Retry-envelope flag validation (kubeapi/client.py RetryPolicy)."""
        errors: List[str] = []
        if self.kube_retry_max_attempts < 1:
            errors.append(
                f"kube-retry-max-attempts must be >= 1, got {self.kube_retry_max_attempts}"
            )
        if self.kube_retry_backoff_base <= 0:
            errors.append(
                f"kube-retry-backoff-base must be > 0, got {self.kube_retry_backoff_base}"
            )
        if self.kube_retry_backoff_cap < self.kube_retry_backoff_base:
            errors.append(
                "kube-retry-backoff-cap must be >= kube-retry-backoff-base, got "
                f"{self.kube_retry_backoff_cap}"
            )
        if self.kube_watch_idle_timeout <= 0:
            errors.append(
                f"kube-watch-idle-timeout must be > 0, got {self.kube_watch_idle_timeout}"
            )
        return errors

    def validate(self) -> None:
        errors: List[str] = self._kube_retry_errors()
        if not self.cluster_name:
            errors.append("CLUSTER_NAME is required")
        if self.metrics_port == self.health_probe_port:
            errors.append("metrics and health ports must differ")
        if self.solver not in ("cost", "ffd", "greedy", "native", "remote"):
            errors.append(f"unknown solver {self.solver!r}")
        if self.solver == "remote" and not self.solver_endpoint:
            errors.append("solver=remote requires --solver-endpoint")
        if self.selection_concurrency < 1:
            errors.append(
                f"selection-concurrency must be >= 1, got {self.selection_concurrency}"
            )
        if not 0.0 < self.interruption_escalate_fraction <= 1.0:
            errors.append(
                "interruption-escalate-fraction must be in (0, 1], got "
                f"{self.interruption_escalate_fraction}"
            )
        errors.extend(self._scalar_errors())
        if self.cluster_store != "memory" and self.cluster_store != "incluster" and not self.cluster_store.startswith(
            ("http://", "https://")
        ):
            errors.append(
                f"cluster-store must be memory | incluster | URL, got {self.cluster_store!r}"
            )
        if errors:
            raise OptionsError("; ".join(errors))

    def _scalar_errors(self) -> List[str]:
        errors: List[str] = []
        # Non-negative scalars where 0 means "disabled": one data-driven
        # check so each new knob costs a row, not a branch.
        for flag, value in (
            ("slo-pending-p99", self.slo_pending_p99),
            ("slo-ttfl", self.slo_ttfl),
            ("consolidation-max-disruption", self.consolidation_max_disruption),
            ("consolidation-cooldown", self.consolidation_cooldown),
            ("disruption-budget", self.disruption_budget),
            ("drift-max-disruption", self.drift_max_disruption),
            ("reprice-debounce", self.reprice_debounce),
        ):
            if value < 0:
                errors.append(f"{flag} must be >= 0 (0 disables), got {value}")
        for flag, cap in (
            ("consolidation-max-disruption", self.consolidation_max_disruption),
            ("drift-max-disruption", self.drift_max_disruption),
        ):
            if cap > self.disruption_budget:
                errors.append(
                    f"{flag} must be <= disruption-budget "
                    f"({self.disruption_budget}) — a per-reason cap above the "
                    f"global budget can never be spent, got {cap}"
                )
        if self.reprice_threshold <= 0:
            errors.append(
                f"reprice-threshold must be > 0, got {self.reprice_threshold}"
            )
        if self.market_poll_interval < 0:
            errors.append(
                "market-poll-interval must be >= 0 (0 = provider default), "
                f"got {self.market_poll_interval}"
            )
        if not 0.0 < self.encode_compaction_threshold <= 1.0:
            errors.append(
                "encode-compaction-threshold must be in (0, 1], got "
                f"{self.encode_compaction_threshold}"
            )
        errors.extend(self._node_health_errors())
        from karpenter_tpu_torch.controllers.provisioning import MAX_PODS_PER_BATCH

        if self.provision_queue_max_pods < MAX_PODS_PER_BATCH:
            errors.append(
                "provision-queue-max-pods must be >= one batch window "
                f"({MAX_PODS_PER_BATCH}) — a cap below it would refuse pods "
                "a single batch could absorb, got "
                f"{self.provision_queue_max_pods}"
            )
        return errors

    def _node_health_errors(self) -> List[str]:
        """Node-health timeout validation, including the ordering contract
        with the leaked-capacity GC (controllers/instancegc.py)."""
        from karpenter_tpu_torch.controllers.instancegc import LAUNCH_GRACE_SECONDS

        errors: List[str] = []
        for flag, value in (
            ("node-unreachable-timeout", self.node_unreachable_timeout),
            ("node-liveness-timeout", self.node_liveness_timeout),
            ("drain-stuck-timeout", self.drain_stuck_timeout),
        ):
            if value <= 0:
                errors.append(f"{flag} must be > 0, got {value}")
        if 0 < self.node_liveness_timeout < LAUNCH_GRACE_SECONDS:
            errors.append(
                "node-liveness-timeout must be >= the instancegc launch "
                f"grace ({LAUNCH_GRACE_SECONDS:.0f}s) — deleting a "
                "never-joined node inside the bootstrap window races the "
                f"leak GC, got {self.node_liveness_timeout}"
            )
        if (
            self.node_unreachable_timeout > 0
            and self.node_liveness_timeout > 0
            and self.node_unreachable_timeout >= self.node_liveness_timeout
        ):
            errors.append(
                "node-unreachable-timeout must be < node-liveness-timeout "
                "(gone-dark detection is the fast path), got "
                f"{self.node_unreachable_timeout} >= {self.node_liveness_timeout}"
            )
        return errors


def parse(argv: Optional[List[str]] = None) -> Options:
    parser = argparse.ArgumentParser(prog="karpenter-tpu")
    parser.add_argument("--cluster-name", default=_env("CLUSTER_NAME", ""))
    parser.add_argument("--cluster-endpoint", default=_env("CLUSTER_ENDPOINT", ""))
    parser.add_argument("--metrics-port", type=int, default=int(_env("METRICS_PORT", "8080")))
    parser.add_argument(
        "--health-probe-port", type=int, default=int(_env("HEALTH_PROBE_PORT", "8081"))
    )
    parser.add_argument(
        "--kube-client-qps", type=float, default=float(_env("KUBE_CLIENT_QPS", "200"))
    )
    parser.add_argument(
        "--kube-client-burst", type=int, default=int(_env("KUBE_CLIENT_BURST", "300"))
    )
    parser.add_argument(
        "--kube-retry-max-attempts", type=int,
        default=int(_env("KUBE_RETRY_MAX_ATTEMPTS", "5")),
    )
    parser.add_argument(
        "--kube-retry-backoff-base", type=float,
        default=float(_env("KUBE_RETRY_BACKOFF_BASE", "0.1")),
    )
    parser.add_argument(
        "--kube-retry-backoff-cap", type=float,
        default=float(_env("KUBE_RETRY_BACKOFF_CAP", "5.0")),
    )
    parser.add_argument(
        "--kube-watch-idle-timeout", type=float,
        default=float(_env("KUBE_WATCH_IDLE_TIMEOUT", "300")),
    )
    parser.add_argument("--solver", default=_env("KARPENTER_SOLVER", "cost"))
    parser.add_argument(
        "--solver-endpoint", default=_env("KARPENTER_SOLVER_ENDPOINT", "")
    )
    parser.add_argument("--cloud-provider", default=_env("CLOUD_PROVIDER", "fake"))
    parser.add_argument(
        "--no-leader-election", action="store_true",
        default=_env("LEADER_ELECTION", "true").lower() == "false",
    )
    parser.add_argument("--log-level", default=_env("LOG_LEVEL", "info"))
    parser.add_argument(
        "--cluster-store", default=_env("CLUSTER_STORE", "memory")
    )
    parser.add_argument(
        "--selection-concurrency", type=int,
        default=int(_env("SELECTION_CONCURRENCY", "8")),
    )
    parser.add_argument(
        "--interruption-escalate-fraction", type=float,
        default=float(_env("INTERRUPTION_ESCALATE_FRACTION", "0.5")),
    )
    parser.add_argument(
        "--consolidation-max-disruption", type=int,
        default=int(_env("CONSOLIDATION_MAX_DISRUPTION", "1")),
    )
    parser.add_argument(
        "--consolidation-cooldown", type=float,
        default=float(_env("CONSOLIDATION_COOLDOWN", "60")),
    )
    parser.add_argument(
        "--disruption-budget", type=int,
        default=int(_env("DISRUPTION_BUDGET", "10")),
    )
    parser.add_argument(
        "--no-drift", action="store_true",
        default=_env("DRIFT_ENABLED", "true").lower() == "false",
    )
    parser.add_argument(
        "--drift-max-disruption", type=int,
        default=int(_env("DRIFT_MAX_DISRUPTION", "2")),
    )
    parser.add_argument(
        "--encode-compaction-threshold", type=float,
        default=float(_env("ENCODE_COMPACTION_THRESHOLD", "0.5")),
    )
    parser.add_argument(
        "--reprice-threshold", type=float,
        default=float(_env("REPRICE_THRESHOLD", "0.1")),
    )
    parser.add_argument(
        "--reprice-debounce", type=float,
        default=float(_env("REPRICE_DEBOUNCE", "5")),
    )
    parser.add_argument(
        "--market-poll-interval", type=float,
        default=float(_env("MARKET_POLL_INTERVAL", "0")),
    )
    parser.add_argument(
        "--slo-pending-p99", type=float,
        default=float(_env("SLO_PENDING_P99", "0")),
    )
    parser.add_argument(
        "--slo-ttfl", type=float,
        default=float(_env("SLO_TTFL", "0")),
    )
    parser.add_argument(
        "--node-unreachable-timeout", type=float,
        default=float(_env("NODE_UNREACHABLE_TIMEOUT", "60")),
    )
    parser.add_argument(
        "--node-liveness-timeout", type=float,
        default=float(_env("NODE_LIVENESS_TIMEOUT", "900")),
    )
    parser.add_argument(
        "--drain-stuck-timeout", type=float,
        default=float(_env("DRAIN_STUCK_TIMEOUT", "120")),
    )
    parser.add_argument(
        "--provision-queue-max-pods", type=int,
        default=int(_env("PROVISION_QUEUE_MAX_PODS", "50000")),
    )
    args = parser.parse_args(argv)
    options = Options(
        cluster_name=args.cluster_name,
        cluster_endpoint=args.cluster_endpoint,
        metrics_port=args.metrics_port,
        health_probe_port=args.health_probe_port,
        kube_client_qps=args.kube_client_qps,
        kube_client_burst=args.kube_client_burst,
        kube_retry_max_attempts=args.kube_retry_max_attempts,
        kube_retry_backoff_base=args.kube_retry_backoff_base,
        kube_retry_backoff_cap=args.kube_retry_backoff_cap,
        kube_watch_idle_timeout=args.kube_watch_idle_timeout,
        solver=args.solver,
        solver_endpoint=args.solver_endpoint,
        cloud_provider=args.cloud_provider,
        leader_election=not args.no_leader_election,
        log_level=args.log_level,
        cluster_store=args.cluster_store,
        selection_concurrency=args.selection_concurrency,
        interruption_escalate_fraction=args.interruption_escalate_fraction,
        consolidation_max_disruption=args.consolidation_max_disruption,
        consolidation_cooldown=args.consolidation_cooldown,
        disruption_budget=args.disruption_budget,
        drift_enabled=not args.no_drift,
        drift_max_disruption=args.drift_max_disruption,
        encode_compaction_threshold=args.encode_compaction_threshold,
        slo_pending_p99=args.slo_pending_p99,
        slo_ttfl=args.slo_ttfl,
        reprice_threshold=args.reprice_threshold,
        reprice_debounce=args.reprice_debounce,
        market_poll_interval=args.market_poll_interval,
        node_unreachable_timeout=args.node_unreachable_timeout,
        node_liveness_timeout=args.node_liveness_timeout,
        drain_stuck_timeout=args.drain_stuck_timeout,
        provision_queue_max_pods=args.provision_queue_max_pods,
    )
    options.validate()
    return options


# The subset of Options safe to change on a LIVE process: fields that are
# read at use time rather than baked into constructed objects. Everything
# else (ports, store backend, solver, concurrency envelopes) is wired into
# threads and sockets at boot and only a restart can change it. SIGHUP and
# POST /debug/loglevel both route through apply_reload so the two paths
# can't drift (cmd/controller.py, runtime._HTTPHandler).
RELOADABLE = ("log_level", "slo_pending_p99", "slo_ttfl")


def apply_reload(live: Options, fresh: Options) -> dict:
    """Copy the RELOADABLE fields of `fresh` (a re-parse of the original
    argv, which re-reads env fallbacks too) onto the live Options; returns
    {field: new_value} for what actually changed — the input
    Manager.reload_options applies."""
    changed = {}
    for name in RELOADABLE:
        new = getattr(fresh, name)
        if getattr(live, name) != new:
            setattr(live, name, new)
            changed[name] = new
    return changed
