#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (karpenter_tpu_torch) on one NVIDIA Hopper card.

    python3 chip_smoke.py

Phases, one line each, then a `kernels` JSON line, the card's name and power
limit, and as the last line {"ok": true, "device": {...}}:

  1. card     the card, its power limit, torch and CUDA versions
  2. build    nvcc for every kernel source, all started together (timed)
  3. kernels  each kernel against its plain PyTorch version on the card: K1
              dominance pricing on edge cases (T 513, T 4,096, all invalid
              among them) and at [512, 8] and K2
              the pack round loop in both modes on random problems and on
              the 50k-pod x 400-type encoded problem, bit for bit; K4 the
              plan compaction, in the pair launch's epilogue with
              feasible_any, the LP's counts and the dense spill, on every
              one of those problems and on dense problems past the entry
              budget (G 16 and 64), word for word to the plain composition,
              the rounds bit for bit to the launch without it; K3 the LP relaxation on
              non-degenerate LPs padded to shapes that reach every launch
              plan (clusters of 2, 4, 8 and 16 blocks, a T the blocks do
              not divide, G 1 to 128, T 16 to 2048, the state in shared
              memory and in global scratch) and at the main path's shape on
              every cluster size, objective within rtol 1e-4 and assignment
              within 1e-3 pods, and on the 50k problem, objective within
              rtol 1e-4; two launches of K2 and of K3 on the same inputs
              give the same bits; K8 the incremental encode's scatter and
              gather on float32 rows, int32 and bool values (a delta, a
              1-element delta, sentinel-only index vectors, an empty
              permutation), bit for bit, the scatter's input untouched, one
              array a call and batched (scatter_flush: up to eight arrays a
              flush, one launch; gather_view: three sources over one
              permutation, one launch); K2q
              (K2 with the reference's fits() quirk) on the reference's
              four parity shapes (the 1.5-pod then 0.5-pod exact-fit case
              among them), random problems over the launch plans, the main
              path's problem and padded G 2,048 and 8,192 (the fills, then
              the tables, in global scratch), bit for bit
 3b. go_parity  TPUSolver(mode="ffd", quirk=True) on the card against
              GreedySolver node for node (canonical nodes, unschedulable
              pods, instance options) on the main path's 50,000 pods (the
              greedy side computed in `chip_smoke.py --greedy-signature`, a
              process of its own started after the build) and on the
              reference's four parity shapes; K2q launched once a solve, no
              host FFD fallback
  4. solve    the main path: 50,000 pending pods over 400 instance types
              through CostSolver(device="cuda").solve with the host gate off
              (KARPENTER_HOST_SOLVE=0); every pod placed exactly once, each
              of K1, K2 (the pair with its epilogue, K4 inside) and K3
              launched exactly once; warm p50/p99 of solve_encoded over 10
              runs
  5. cpu      the same encoded problem through the plain versions on the CPU:
              identical rounds and feasibility, $/hr within 1e-4 relative, LP
              objective within 1e-3 relative; the card's dispatch runs under
              torch.cuda.set_sync_debug_mode("error") (no host sync) and
              returns before the card is done
  6. batch    solve_encoded_many over 8 schedules (one fetch for the batch)
  7. incremental  the steady-state churn scenario of bench.py
              (bench_encode_incremental) over the port's Cluster and a
              DeviceClusterState on the card: 50,000 pods bound over 500
              nodes in 16 shapes, 1% churn a sweep, 12 sweeps; flush plus
              sorted view p50/p99, the full rebuild, K8's launches, the
              largest delta, rebuilds and compactions; every fourth
              sweep and at the end the view bit-identical to group_pods over
              the store, node_used equal to a pod walk, the device arrays
              equal to the host mirrors
     fast_path  the main path's 50,000 pending pods tracked by a
              DeviceClusterState: encode_schedule ->
              CostSolver.solve_many_pipelined on the pre-encoded pair; the
              plan identical to the snapshot path's, $/hr within 1e-4 of the
              CPU run, K1-K4 run once each (K4 in K2's launch), no pod tensor uploaded and
              a warm solve uploading nothing (convert.upload_packed's
              counters), encode and dispatch under
              set_sync_debug_mode("error"), K8 launched once for the view;
              again after 1% churn (K8 once for the flush, once for the
              view); warm p50 of the fast and the snapshot
              path, the encode skipped, and the time to the first result of
              an 8-schedule pipelined solve against the batch
     oom_ladder  on that 8-schedule batch: an injected out-of-memory fault
              at one and two split depths, a KARPENTER_HBM_BYTES pre-split
              and a fault in the middle of the pipeline give the unarmed
              plans bit for bit, counted by solver_batch_split_total; the
              floor is never reached
  8. consolidate  the consolidation path: one sweep of
              ops/consolidate.solve_candidates over a 5,000-node cluster
              (64 candidates, padded C 64, G 16, N 8192, T 512) built by the
              controller's rules; K7 launched once per sweep (one kernel
              record: a cluster of blocks a candidate, the last cluster
              taking the argmax) and bit-identical to its plain version there
              and on small problems (fits past 2**24, N 8,192 with 3 and 8
              axes, N 4,101 and 4,100); every
              verdict equal to the CPU run; the winner's delete plan places
              each of its pods once within every receiver's headroom; a room
              sized for too few axes flagged; cold first sweep, warm p50 over
              10 sweeps, the fetch's bytes. `chip_smoke.py --phase
              consolidate` runs it alone, with K7's times
  9. constrained  the constrained provisioning path: the main path's 50,000
              pods, each under one zonal topology spread (max_skew 1,
              DoNotSchedule) and two preferred node-affinity terms (a zone
              the catalog does not offer, weight 10; amd64, weight 1),
              through Scheduler(cluster).solve and
              constraints.solve.solve_constrained with CostSolver() on the
              card (padded G' 64, T 512, L 4); K6 launched once a solve;
              level 1 chosen; every pod placed once or reported
              unschedulable; the three zones' skew at most 1; $/hr equal to
              the CPU run within 1e-4; K6 equal to its plain version on the
              card in both modes and to the numpy mirror; the first solve,
              warm p50 and max over 10 solves, each layer of one solve
 10. large_shapes  CostSolver on the card over 12,000 pods in 1,100
              distinct shapes (padded G 2,048, T 512): every pod placed
              once, K2's rounds equal to the plain version's (the same
              dispatch on the CPU), K3's objective within rtol 1e-4 of its
              plain version; K2 at G 2,048 x T 512 and G 16 x T 8,192, K3
              at G 2,048 x T 512, G 16 x T 8,192 and G 2,048 x T 2,048 (its
              tables in global scratch) against their plain versions
 10b. provision_storm  the provisioning controllers under a live spot
              market, through the port's Manager (runtime.Manager) on the
              card: a seeded MarketFeed over the catalog's 1,200 spot pools
              attached to the FakeCloudProvider and folded by the market
              sweep, the six cheapest spot pools given an observed
              interruption, a spot-only provisioner, then the main path's 50,000
              pods (in a seeded random order) applied and reconciled by
              selection, drained by worker passes in 2,000-pod windows with
              the host gate off (KARPENTER_HOST_SOLVE=0), the market
              repricing (a spike on eight pools, one feed step) before pass
              13. Every pod bound exactly once in 25 passes, K1-K4 run
              once a pass, the fleet arrays uploaded once after the reprice
              and never while the market is calm; build_fleet's [T] prices
              bit-identical to forecast.penalize_prices and to K10 (csrc/
              forecast.cu, run beside every column a pass publishes), the
              risked types' prices and their pools' [T, Z] entries above the
              calm prices and every other entry unchanged, a calm book the
              bits of no book; total $/hr equal to the same storm on the CPU
              within 1e-4; then make_solver("ffd") (K2 in one mode, once a
              pass) on the card and the CPU with the same nodes, and no
              solve sent to the host FFD. Pass p50 and
              max, the first and last bind, pods bound a second, the market
              sweep, which passes took the incremental encode's fast path
 10c. controller  the controller process, in `chip_smoke.py --phase
              controller` (a fresh process, so its boot warmup pays the first
              launches; started after the build, it runs beside phases
              3-10b, its control loops on one host core): cmd/controller.main with the cost solver, leader
              election on the in-memory lease, the storm's fake cloud
              registered as a provider factory (--cloud-provider
              chip-smoke-storm), the metrics and probe ports on free loopback
              ports, KARPENTER_HOST_SOLVE unset (the card's default: no
              host route); /healthz 200 at once, /readyz
              503 until the warmup ends and 200 after, no rung failed, the
              calibrated break-even printed; then through the threaded loops
              alone: the first 2,000-pod window (its pass the first solve
              after ready, within 2x of the warm p50), the rest of a
              25,000-pod storm (CONTROLLER_PODS: half the by-hand storm, so
              the process no longer holds up the script) with a spike on
              eight pools, every pod bound once, K1, the K2 pair with its
              epilogue and K3 once a device solve, no host solve; the nodes'
              kubelets join and heartbeat every 10 s
              (--node-unreachable-timeout 40); the node-lifecycle sweeps: a
              spot interruption on 8 seeded nodes, one other seeded node's
              kubelet gone dark, an orphaned pod and a leaked instance, all
              at once, until the victims are drained and deleted, the dark
              node escalated by the health sweep, every displaced pod bound
              again once by replacement solves on the card (K1, the K2 pair
              and K3 once each, no host solve), the orphan reaped by podgc
              and the leak terminated by instancegc (the
              `controller_lifecycle` line); 40% of the pods are deleted,
              the consolidation loop launches K7, deletes or replaces nodes, termination
              drains them, every evicted pod is bound again and the fleet's
              $/hr falls; /metrics parses, /debug/stacks has profile
              samples; after the stop /healthz answers 503
 10d. sharded  (beside the controller process, before its result is read)
              the sharded solve (the reference's single-host mesh path) on
              virtual meshes of the one card, 4 shards (2x2) and 8 (2x4),
              as the reference's tests and dryrun_multichip run it on 8
              virtual CPU devices: CostSolver over the main path's 50,000
              pods x 400 types with solve_mesh() selecting the mesh (K1 and
              the K2 pair once with its epilogue but no payload, K9a's
              persistent kernel once for the whole LP, K9b once for the
              whole payload, no K3), every pod
              placed once,
              both decoded candidates and feasible_any bit-identical to the
              single-device solve, $/hr within 1.02x and 5% of it, warm p50
              and max over 10 solves beside the single-device p50; K9a
              (csrc/lp_shard.cu) against its plain version over the mesh on
              the main path (objective), on non-degenerate LPs (LP
              tolerances), two launches alike, its per-phase kernels (the
              route of a mesh that spans cards) phase by phase and, forced
              on the 2x4 mesh, over the whole LP (three kernels a shard a
              step, shards x (3 x 300 + 3) launches, objective and pods
              against the plain versions) on the main path and at the
              many-shapes width (padded G 2,048 x T 512, 2x4: one launch,
              objective and pods) beside K3 there; K9b
              (csrc/compact_shard.cu, one launch a solve) against its plain
              version word for word, against its per-card route forced on
              the card (the shards in runs of three, a launch each) and
              against the host decode, a shard past its budget included;
              the constrained cell's levels over 8 shards equal to the
              single-device dispatch; the shrink leg: one shard id
              wedged, the mesh 1x7 (G and T padded to multiples of 7), one
              K9a launch and one K9b launch, K9a against its plain version there, the decoded
              candidates and feasible_any bit-identical to the single-device
              solve's on the real groups, the LP finite, pods conserved; an
              injected dispatch failure
              quarantined by the chip probe (a fake probe naming shards
              0-6) and retried once on the shrunk mesh. It prints
              solve_mesh() on the machine and torch.cuda.device_count(), and
              with more than one card also solves over the real cards.
              `chip_smoke.py --phase sharded` runs it alone.
 10e. multiprocess  the multi-process lead/follower dispatch
              (parallel/spmd.py): two processes (`chip_smoke.py --phase
              multiprocess-rank`) join one gloo group and share the card,
              two shards each (a 2x2 mesh, a row a process); rank 0 runs
              CostSolver.solve_encoded on the main path's 50,000 pods x 400
              types, rank 1 its follower loop; each rank launches K1 and the
              K2 pair once a solve, K9a's per-phase kernels on its two
              shards (2 x 903), K9b once, no K3; the decodes and $/hr equal
              the one-process 2x2 mesh's (persistent K9a), the decodes, the
              LP and the plan the one-process 2x2 mesh's through K9a's
              per-phase route bit for bit; the solve p50, each rank's
              device ms by kernel, the collectives a solve; either rank
              failing fails the phase
 10f. apiserver  the controller on a live apiserver with the EC2 provider,
              in `chip_smoke.py --phase apiserver` (started with the
              controller phase): that process is the store, serving
              tests/fake_apiserver.py's FakeApiServer over HTTP on a
              loopback port (its import pointed at the port's kubeapi), with
              the kubelets' status patches; a child (`--phase
              apiserver-controller`) runs cmd/controller.main on the card
              with `--cluster-store http://127.0.0.1:<port>`, leader election
              on the apiserver's Lease and `Ec2CloudProvider` over
              `FakeEc2` with the main path's 400 types as EC2 records in its
              three zones (a registered provider factory). /readyz 503, then
              200; a Provisioner and 5,000 pending pods of the main path's
              shape mix through HTTP POSTs; every pod bound exactly once
              through the Binding subresource (counted by the apiserver);
              every node's provider id one live FakeEc2 instance, each from
              a recorded create_fleet call; K1, the K2 pair (K4) and K3 once
              a device solve, no host solve after ready. Then 40% of the
              pods deleted through the API and consolidation for at most 60
              s: every sweep one K7 launch, every removed node terminated
              through FakeEc2.terminate_instances, every displaced pod
              bound again once, the $/hr lower. The solve p50, the time
              from the last POST to the last bind, the controller's HTTP
              requests and watch events by kind, each kernel's launches
 10g. sidecar  the solver sidecar (solver_service) through its entry
              point, `python -m karpenter_tpu_torch.solver_service.server`,
              in two child processes (SidecarChild; no other child of this
              script is live then, and the line says so): Health and
              grpc.health.v1 polled from "warming" and NOT_SERVING to "ok"
              and SERVING (the ready time), platform "gpu" and one device;
              the main path's 50,000 pods x 400 types encoded once, 10 warm
              unary RemoteSolver.solve_encoded calls, then 10 in-process
              CostSolver solves of the same inputs: the same packings,
              unschedulable set and $/hr within 1e-6, every answer
              "tpu-cost" without fallback; the client's wall p50 and max,
              the sidecar's solve_ms, the request and response bytes, the
              in-process p50 beside them; the 8 schedules of the fast path
              over SolveStream (solve_encoded_pipelined) equal to the
              in-process pipelined solve, the times to the first and last
              result; RemoteSolver(mode="ffd", quirk=True) on the Go-parity
              cases and the main path equal to TPUSolver(quirk=True) in
              process, every answer "tpu-ffd"; the second sidecar, with
              KARPENTER_JAX_PROFILE_DIR set, traces 2 cost solves, each
              launching K1, K2's pair and K3 once and no standalone
              compaction (read from its own torch.profiler traces);
              `chip_smoke.py --phase sidecar-controller` runs
              cmd/controller.main with `--solver remote` against the first
              sidecar, 10,000 pods of the storm's mix (five 2,000-pod
              windows, the in-memory store, the storm's cloud): every pod
              bound once, the sidecar's Health.solves up by the schedules
              sent, solver_rpc_duration_seconds with outcome ok only, no
              blackout and no fallback; SIGTERM ends each sidecar with exit
              0 within 10 s. `chip_smoke.py --phase sidecar` runs it (and
              the webhook phase) alone
 10h. webhook  `python -m karpenter_tpu_torch.cmd.webhook --tls-self-signed`
              (host code): its certificate fetched with
              ssl.get_server_certificate, then over HTTPS verified against
              it the reference's TestAdmissionReview checks with the main
              path's provisioner (allowed; a bad one rejected in the
              envelope; a JSONPatch defaulting the capacity type, none for
              a defaulted spec; a malformed envelope answered 400)
 11. timing   each kernel's device time per call (torch.profiler: the
              kernels' own time, `ms`) and its time between CUDA events
              around the wrapper (host enqueue included, `event_ms`), its
              plain version's time (CUDA events) and its bound at the path's
              shapes; K3's time per Adam step and at every cluster size,
              K2's time per round of each mode; K6 at the constrained
              path's shapes (K1 at T 4,096 too; K7 at the real sweep and at
              the controller's last sweep, with its cluster size and kernel
              records a sweep); K8 on one steady-state sweep's flush and
              sorted view (one launch each; device ms over every record of
              the call, copies included); K10 on the storm fleet's [T]
              column, beside
              torch.addcmul (event time, and device time called in turns
              with K10 in one profile); K2q at the main path's shape; K2 and K3 at
              padded G 2,048; the card's launch floor (an empty kernel, csrc/
              launch_floor.cu, through the same ctypes and launch_stream
              path)
 12. layers   one warm solve layer by layer (each bracketed by device syncs),
              and torch.profiler's device time against the solve's wall time
 13. storm_profile  the card storm run again to its pass 2, which runs under
              torch.profiler: its device time against its wall time. Last,
              because a profiler session over a storm pass (its bind and
              overlap threads) makes later sessions drop a kernel record
 14. consolidate  `chip_smoke.py --phase consolidate` in a fresh process:
              the consolidate phase again, K7's times and its kernel
              records in one sweep (checked to be one), which the kernels
              line carries
 15. fused    `chip_smoke.py --phase fused` in a fresh process: the fused
              solve's device records a call by name (one K2 launch, no
              compaction launch), and K2's pair with its epilogue and
              without it, in turns in one profile, whose difference is K4's
              share (the kernels line's K4 entry)

The kernels phase also holds K10, the forecast penalty, bit for bit to the
numpy column and to its plain version (the reference's magnitudes at 257
and 4,096 types, one type, zero risk, the catalog's spot prices), and K6,
the constrained [L, G', T] dispatch, bit for bit to its plain version on 22
seeded cases (both modes; conflicts, node
caps, penalties, padded levels, T 300 ragged, T 1,500, G' up to 2,048 with
its tables in global scratch).

Each phase's line carries its own seconds and the seconds since the start;
the line before the kernels line the total.

Any failed check raises and the script exits non-zero. Without a CUDA card,
or without the rest of the repository beside it, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import contextlib
import functools
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

# Published H100 SXM peaks: HBM bytes per second, fp32 (non-tensor) ops/s.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
ZONES = ("z-1a", "z-1b", "z-1c")
NODE_CAP_NONE = 2**30  # ops/pack_kernel.NODE_CAP_NONE: no per-node cap
NUM_PODS = 50_000
NUM_TYPES = 400


def check(condition: bool, message: str) -> None:
    if not condition:
        raise RuntimeError(f"check failed: {message}")


_START = time.perf_counter()
_LAST_PHASE = [_START]


def phase(name: str, **fields) -> None:
    """One phase's line, with its own seconds (since the line before) and
    the seconds since the script started."""
    now = time.perf_counter()
    text = " ".join(f"{key}={value}" for key, value in fields.items())
    print(f"phase {name}: ok {text} phase_s={now - _LAST_PHASE[0]:.1f} at_s={now - _START:.1f}", flush=True)
    _LAST_PHASE[0] = now


def kube_reserved_cpu_millis(vcpus: int) -> int:
    """Kube-reserved CPU of a node (the reference catalog's Bottlerocket
    formula): 6% of the first core, 1% of the second, 0.5% of cores 3-4,
    0.25% of the rest, plus 100m system-reserved."""
    millis = vcpus * 1000
    reserved = 100.0
    for start, end, percentage in (
        (0, 1000, 0.06), (1000, 2000, 0.01), (2000, 4000, 0.005), (4000, 1 << 31, 0.0025),
    ):
        if millis >= start:
            reserved += (min(millis, end) - start) * percentage
    return int(reserved)


def pod_shapes(seed: int = 0):
    """The 16 pod shapes of the north-star workload: (cpu millicores, MiB)."""
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(1, 17)) * 250, int(rng.integers(1, 33)) * 256) for _ in range(16)]


def zipf_weights(count: int = 16) -> np.ndarray:
    weights = 1.0 / np.arange(1, count + 1)
    return weights / weights.sum()


def make_catalog(num_types: int = NUM_TYPES, seed: int = 0, package=None):
    """400 types from 4 families x 10 sizes with on-demand prices linear in
    size, 3 zones, on-demand and spot offerings; spot prices come from a
    seeded generator. `package` supplies InstanceType and Offering (the
    port's by default)."""
    if package is None:
        package = port_package()
    families = [("c", 2.0, 0.17), ("m", 4.0, 0.192), ("r", 8.0, 0.252), ("x", 16.0, 0.333)]
    sizes = [1, 2, 3, 4, 6, 8, 12, 16, 24, 32]
    spot_rng = np.random.default_rng(seed + 1)
    catalog = []
    for idx in range(num_types):
        family, mem_per_cpu, base = families[idx % len(families)]
        size = sizes[(idx // len(families)) % len(sizes)]
        generation = idx // (len(families) * len(sizes))
        cpu = 2 * size
        on_demand = base * size * (1.0 + 0.03 * generation)
        max_pods = min(110, 8 + 15 * size)
        offerings = []
        for zone in ZONES:
            offerings.append(package.Offering(zone=zone, capacity_type="on-demand", price=on_demand))
            spot = on_demand * float(spot_rng.uniform(0.25, 0.75))
            offerings.append(package.Offering(zone=zone, capacity_type="spot", price=spot))
        catalog.append(
            package.InstanceType(
                name=f"{family}{generation}.{size}x",
                capacity={"cpu": cpu, "memory": f"{int(cpu * mem_per_cpu)}Gi", "pods": max_pods},
                overhead={
                    "cpu": f"{kube_reserved_cpu_millis(cpu)}m",
                    "memory": f"{11 * max_pods + 255 + 100 + 100}Mi",
                },
                offerings=offerings,
            )
        )
    return catalog


def make_workload(num_pods: int = NUM_PODS, num_types: int = NUM_TYPES, seed: int = 0):
    """The repository's north-star workload (the shapes of bench.make_workload):
    the 16 pod shapes, Zipf-weighted, over make_catalog's 400 types."""
    from karpenter_tpu_torch.api.pods import PodSpec

    shapes = pod_shapes(seed)
    shape_counts = (zipf_weights(len(shapes)) * num_pods).astype(int)
    shape_counts[0] += num_pods - shape_counts.sum()
    pods = [
        PodSpec(
            name=f"pod-{cpu}m-{mem}Mi-{i}",
            requests={"cpu": f"{cpu}m", "memory": f"{mem}Mi"},
            unschedulable=True,
        )
        for (cpu, mem), count in zip(shapes, shape_counts)
        for i in range(count)
    ]
    return pods, make_catalog(num_types, seed)


def port_package():
    """The port's classes and functions that the problem builders use; a test
    passes the reference package's in the same shape."""
    from types import SimpleNamespace

    from karpenter_tpu_torch.api import wellknown
    from karpenter_tpu_torch.api.pods import PodSpec, PreferredTerm, TopologySpreadConstraint
    from karpenter_tpu_torch.api.provisioner import Constraints
    from karpenter_tpu_torch.api.requirements import Requirement
    from karpenter_tpu_torch.cloudprovider import InstanceType, Offering
    from karpenter_tpu_torch.ops import consolidate, encode

    return SimpleNamespace(
        PodSpec=PodSpec, Constraints=Constraints, InstanceType=InstanceType, Offering=Offering,
        group_pods=encode.group_pods, build_fleet=encode.build_fleet,
        resource_vector=encode.resource_vector, accel_indexes=encode._ACCEL_INDEXES,
        consolidate=consolidate, TopologySpreadConstraint=TopologySpreadConstraint,
        PreferredTerm=PreferredTerm, Requirement=Requirement, wellknown=wellknown,
    )


# --- the constrained path: spread and preferences ---------------------------

SPREAD_LABELS = {"app": "web"}
MISSING_ZONE = "z-9z"  # a zone the catalog does not offer


def constrained_pods(num_pods: int = NUM_PODS, seed: int = 0, package=None):
    """The main path's pods in its 16 Zipf shapes, each with one zonal
    topology spread (max_skew 1, DoNotSchedule: the Kubernetes docs'
    Deployment example, kubernetes.io/docs/concepts/scheduling-eviction/
    topology-spread-constraints) and two preferred node-affinity terms:
    weight 10 for a zone the catalog does not offer, weight 1 for the amd64
    architecture every type has. The ladder's level 0 keeps both terms and
    can place nothing; level 1 drops the impossible one; level 2 drops
    both."""
    if package is None:
        package = port_package()
    wellknown = package.wellknown
    shapes = pod_shapes(seed)
    shape_counts = (zipf_weights(len(shapes)) * num_pods).astype(int)
    shape_counts[0] += num_pods - shape_counts.sum()
    spread = package.TopologySpreadConstraint(
        max_skew=1, topology_key=wellknown.ZONE_LABEL, match_labels=dict(SPREAD_LABELS))
    preferred = [
        package.PreferredTerm(weight=10, requirements=[
            package.Requirement.in_(wellknown.ZONE_LABEL, [MISSING_ZONE])]),
        package.PreferredTerm(weight=1, requirements=[
            package.Requirement.in_(wellknown.ARCH_LABEL, ["amd64"])]),
    ]
    return [
        package.PodSpec(
            name=f"web-{cpu}m-{mem}Mi-{i}", uid=f"web-{cpu}m-{mem}Mi-{i}",
            requests={"cpu": f"{cpu}m", "memory": f"{mem}Mi"}, unschedulable=True,
            labels=dict(SPREAD_LABELS), topology_spread=[spread], preferred_terms=list(preferred),
        )
        for (cpu, mem), count in zip(shapes, shape_counts)
        for i in range(count)
    ]


def zone_skew(result) -> tuple:
    """(pods per zone, skew) over the plan's packings, each pinned to one
    zone by its launch pools."""
    per_zone = {}
    for packing in result.packings:
        zones = {option.zone for option in packing.pool_options}
        if len(zones) != 1:
            raise RuntimeError(f"check failed: a packing is not pinned to one zone: {sorted(zones)}")
        (zone,) = zones
        per_zone[zone] = per_zone.get(zone, 0) + sum(len(node) for node in packing.pods_per_node)
    counts = [per_zone.get(zone, 0) for zone in ZONES]
    return per_zone, max(counts) - min(counts)


def placed_once_or_unschedulable(result, pods) -> bool:
    """Every pod is in the plan once or reported unschedulable, none both."""
    seen = [pod.uid for packing in result.packings for node in packing.pods_per_node for pod in node]
    seen += [pod.uid for pod in result.unschedulable]
    return len(seen) == len(pods) and set(seen) == {pod.uid for pod in pods}


def k6_problem(seed: int, num_groups: int, num_types: int, num_levels: int, real_groups=None):
    """A seeded [L, G', T] problem as pack_kernel_levels' ten numpy operands:
    pod-sized vectors in FFD order (the first `real_groups` real, the rest
    padding), nested allow masks that relax level by level with padded
    levels repeating the last real one, spread-penalty multiples and random
    penalties, zone-like domain conflicts plus random anti-affinity pairs,
    per-node caps, a ragged set of valid types."""
    rng = np.random.default_rng(seed)
    real = min(num_groups, real_groups or num_groups)
    vectors = np.zeros((num_groups, 8), np.float32)
    vectors[:real, 0] = np.sort(rng.integers(1, 17, real))[::-1] * 250
    vectors[:real, 1] = rng.integers(1, 33, real) * 256
    vectors[:real, 2] = 1
    if seed % 2:
        vectors[0, 0] = 70_000  # larger than any type: unschedulable at every level
    real_types = int(rng.integers(max(1, num_types // 2), num_types + 1))
    cpu = np.sort(rng.integers(1, 65, real_types)) * 1000
    capacity = np.zeros((num_types, 8), np.float32)
    capacity[:real_types, 0] = cpu - 100
    capacity[:real_types, 1] = cpu * rng.choice([2, 4, 8], real_types) - 600
    capacity[:real_types, 2] = 110
    valid = np.zeros(num_types, bool)
    valid[:real_types] = True
    prices = np.full(num_types, np.inf, np.float32)
    prices[:real_types] = cpu / 1000 * rng.uniform(0.03, 0.05, real_types)
    real_levels = int(rng.integers(1, num_levels + 1))
    level_counts = np.zeros((num_levels, num_groups), np.int32)
    allow = np.zeros((num_levels, num_groups, num_types), bool)
    base = rng.integers(1, 40, real)
    mask = rng.random((real, num_types)) < 0.3
    # Level 0 admits no type for a tenth of the groups (they retire as
    # unschedulable); each later real level admits more.
    mask[rng.random(real) < 0.1] = False
    for level in range(num_levels):
        if level < real_levels:
            if level > 0:
                mask = mask | (rng.random((real, num_types)) < 0.3)
            kept = base.copy()
            kept[rng.random(real) < 0.1 * (real_levels - 1 - level)] = 0
        level_counts[level, :real] = kept
        allow[level, :real] = mask
    penalty = np.zeros((num_levels, num_groups, num_types), np.float32)
    penalty[:, :real] = (0.005 * rng.integers(0, 4, (num_levels, real, num_types))).astype(np.float32)
    noisy = rng.random((num_levels, real, num_types)) < 0.2
    penalty[:, :real][noisy] = rng.uniform(0, 0.05, int(noisy.sum())).astype(np.float32)
    penalty[real_levels:] = penalty[real_levels - 1]
    domain = np.where(rng.random(real) < 0.6, rng.integers(0, 3, real), -1)
    conflict = np.zeros((num_groups, num_groups), bool)
    pinned = domain >= 0
    conflict[:real, :real] = pinned[:, None] & pinned[None, :] & (domain[:, None] != domain[None, :])
    pairs = rng.random((real, real)) < 0.02
    conflict[:real, :real] |= pairs | pairs.T
    np.fill_diagonal(conflict, False)
    node_cap = np.full(num_groups, NODE_CAP_NONE, np.int32)
    capped = rng.random(real) < 0.25
    node_cap[:real][capped] = rng.integers(1, 4, int(capped.sum()))
    return (vectors, level_counts, capacity, capacity.copy(), valid, prices, allow, penalty,
            conflict, node_cap)


# (G', T, L, real groups): a single level; the small and the main shapes;
# T 300 leaves part of a block's last warp without a type; L 8 every level
# a cluster; G' 512 and 2,048 keep the placed bits, and 2,048 the tables and
# fills, in global scratch; T 1,500 takes 4 lanes a type. The plan picks
# clusters of 1 (T 8, 64), 2 (T 128), 4 (T 256), 8 (T 300, 512) and 16
# blocks (T 1,024, 1,500).
K6_SHAPES = ((8, 8, 1, None), (16, 64, 4, None), (16, 300, 4, None), (64, 512, 4, None),
             (64, 512, 8, None), (128, 256, 2, 80), (256, 512, 4, 60), (512, 256, 2, 50),
             (2048, 512, 2, 50), (32, 1024, 4, None), (16, 1500, 2, None), (32, 128, 3, None))


def tied_weight_pack_problem(seed: int, groups: int, num_types: int = 16):
    """Two types of equal price, one with room for cpu only and one for
    memory only, over groups of one weight apiece: after a tiny first group
    both take, the cpu groups go to one type and the memory groups to the
    other, with the same (weight, count) pairs in another order. The exact
    weighted of both types is equal, so which one the first cost round
    takes is decided by the order and rounding of fills @ group_weight
    alone. The third type, the last valid one, sets the weights at a power
    of two per axis and costs too much to be taken. XLA vectorises the dot
    over the types as rows, one way from 9 rows on and another over 8 or
    fewer (`ops/pack_kernel._weighted_sums`)."""
    rng = np.random.default_rng(seed)
    half = (groups - 1) // 2
    weights = rng.uniform(0.001, 0.01, half).astype(np.float32)
    pods = rng.choice([3, 5, 7, 9, 11, 13], half).astype(np.int32)
    order = rng.permutation(half)
    vectors = np.zeros((groups, 3), np.float32)
    counts = np.zeros(groups, np.int32)
    vectors[0], counts[0] = (1e-3, 1e-3, 0), 2
    vectors[1 : 2 * half : 2, 0], counts[1 : 2 * half : 2] = weights * 1024, pods
    vectors[2 : 2 * half + 1 : 2, 1], counts[2 : 2 * half + 1 : 2] = weights[order] * 4096, pods[order]
    capacity = np.zeros((num_types, 3), np.float32)
    capacity[:3] = ((1e6, 0.5, 1), (0.5, 1e6, 1), (1024, 4096, 1))
    valid = np.zeros(num_types, bool)
    valid[:3] = True
    prices = np.zeros(num_types, np.float32)
    prices[:3] = (1, 1, 1e6)
    return vectors, counts, capacity, capacity.copy(), valid, prices


def tied_weight_levels_problem(seed: int, groups: int, levels: int, types: int = 16):
    """Two identical types that may take different halves of the groups
    (allow masks), each half the same (vector, count) pairs in another
    order: the exact weighted of both types is equal, so which one the
    first cost round takes is decided by the order and rounding of
    fills @ group_weight alone (equal prices, no penalty, one node holds
    every pod). XLA vectorises the dot over levels x types as rows, one way
    from 9 rows on and another over 8 or fewer
    (`ops/pack_kernel._weighted_sums`)."""
    rng = np.random.default_rng(seed)
    dims = 3
    half = groups // 2
    first, second = np.split(rng.permutation(groups), 2)
    sizes = rng.uniform(1, 10, half).astype(np.float32)
    pods = rng.choice([3, 5, 7, 9, 11, 13], half).astype(np.int32)
    order = rng.permutation(half)
    vectors = np.zeros((groups, dims), np.float32)
    counts = np.zeros(groups, np.int32)
    vectors[first, 0], counts[first] = sizes, pods
    vectors[second, 0], counts[second] = sizes[order], pods[order]
    capacity = np.zeros((types, dims), np.float32)
    capacity[:3] = 2.0**20
    valid = np.zeros(types, bool)
    valid[:3] = True
    prices = np.zeros(types, np.float32)
    prices[:3] = 1.0
    # Type 2, the last valid one, sets the weights and may take nothing.
    allow = np.zeros((levels, groups, types), bool)
    allow[:, first, 0] = True
    allow[:, second, 1] = True
    return (vectors, np.tile(counts, (levels, 1)), capacity, capacity.copy(), valid, prices, allow,
            np.zeros((levels, groups, types), np.float32), np.zeros((groups, groups), bool),
            np.full(groups, NODE_CAP_NONE, np.int32))


# Group counts of the tied-weight cases: one chain of fused multiply-adds
# below 64, the unrolled and the looped vectorised orders from 64 on.
TIED_GROUPS = (16, 64, 128, 256)
# Rows of the dot (types, or levels x types) over which XLA orders it
# another way: 8 or fewer.
NARROW_ROWS = (8, 4)


def tied_weight_cases():
    """(name, K2 problem or None, K6 operands or None) the kernels are held
    to their plain versions on where the order of `weighted` decides the
    round: three seeds a group count, K6 at one level and at four, and
    both over 8 and 4 rows (one level) from 64 groups on."""
    for groups in TIED_GROUPS:
        for seed in range(3):
            yield f"K2-G{groups}-s{seed}", tied_weight_pack_problem(seed, groups), None
            for levels in (1, 4):
                yield (f"K6-G{groups}-L{levels}-s{seed}", None,
                       tied_weight_levels_problem(seed, groups, levels))
            if groups < 64:
                continue
            for rows in NARROW_ROWS:
                yield (f"K2-G{groups}-T{rows}-s{seed}",
                       tied_weight_pack_problem(seed, groups, num_types=rows), None)
                yield (f"K6-G{groups}-L1-T{rows}-s{seed}", None,
                       tied_weight_levels_problem(seed, groups, 1, types=rows))


def k6_cases():
    """(name, operands, mode) K6 is held to its plain version on: every
    shape of K6_SHAPES in both modes."""
    for seed, (groups, types, levels, real) in enumerate(K6_SHAPES):
        operands = k6_problem(seed, groups, types, levels, real)
        for mode in ("ffd", "cost"):
            yield f"G{groups}-T{types}-L{levels}-{mode}", operands, mode


def many_shapes_pods(num_pods: int = 12_000, num_shapes: int = 1_100, seed: int = 5, package=None):
    """num_pods pending pods in num_shapes distinct (cpu, memory) shapes,
    cpu in 250m steps up to 4 cores and memory in 128Mi steps up to 16Gi,
    counts as even as the division allows."""
    if package is None:
        package = port_package()
    rng = np.random.default_rng(seed)
    cells = rng.choice(16 * 128, num_shapes, replace=False)
    shapes = [(int(c // 128 + 1) * 250, int(c % 128 + 1) * 128) for c in cells]
    counts = np.full(num_shapes, num_pods // num_shapes)
    counts[: num_pods % num_shapes] += 1
    return [
        package.PodSpec(name=f"pod-{cpu}m-{mem}Mi-{i}", requests={"cpu": f"{cpu}m", "memory": f"{mem}Mi"},
                        unschedulable=True)
        for (cpu, mem), count in zip(shapes, counts)
        for i in range(int(count))
    ]


def sparse_pack_problem(seed: int, num_groups: int, num_types: int, real_groups: int):
    """random_pack_problem's family with only the first real_groups groups
    holding pods (a few each), the rest padding: the launch plan of the
    padded size, at a cost the plain version can follow."""
    rng = np.random.default_rng(seed)
    real_groups = min(real_groups, num_groups)
    vectors, counts, capacity, total, valid, prices = random_pack_problem(rng, 16, num_types)
    vectors = np.zeros((num_groups, 8), np.float32)
    vectors[:real_groups, 0] = np.sort(rng.integers(1, 17, real_groups))[::-1] * 250
    vectors[:real_groups, 1] = rng.integers(1, 33, real_groups) * 256
    vectors[:real_groups, 2] = 1
    counts = np.zeros(num_groups, np.int32)
    counts[:real_groups] = rng.integers(1, 8, real_groups)
    return vectors, counts, capacity, total, valid, prices


# --- consolidation: a cluster of running nodes, by the controller's rules ---

CLUSTER_NODES = 5_000  # the large-cluster envelope Kubernetes documents
MAX_CANDIDATES = 64  # karpenter_tpu/controllers/consolidation.py:89
UNDERUTILIZED_FRACTION = 0.85  # karpenter_tpu/controllers/consolidation.py:86


def usable_capacity(catalog, package) -> np.ndarray:
    """[T, R] allocatable per type: capacity minus overhead, at least 0."""
    return np.stack([
        np.maximum(
            package.resource_vector(it.capacity).astype(np.float64)
            - package.resource_vector(it.overhead),
            0.0,
        )
        for it in catalog
    ])


def shape_vectors(shapes, package) -> np.ndarray:
    """[16, R] float64 request vectors of the pod shapes (the pods axis is 1)."""
    return np.stack([
        package.PodSpec(name="shape", requests={"cpu": f"{cpu}m", "memory": f"{mem}Mi"}).dense_vector[0]
        for cpu, mem in shapes
    ]).astype(np.float64)


def make_cluster(usable: np.ndarray, shape_vectors: np.ndarray, num_nodes: int = CLUSTER_NODES, seed: int = 11):
    """Running nodes as numbers: per node a catalog type (larger types more
    likely), a zone, a capacity type, whether its pods carry node-level
    scheduling requirements (one node in ten), and its pods per shape. Each
    node is filled with Zipf-drawn shapes while every axis stays within a
    seeded utilization of its allocatable capacity (the pods axis is
    max_pods). Only the node count is from a published envelope; the type
    weights, the utilization range [0.5, 0.98], the 30% spot and the 10%
    constrained share are this script's own choices, with no published
    trace behind them."""
    rng = np.random.default_rng(seed)
    num_types = usable.shape[0]
    weight = usable[:, 0] ** 2
    node_type = rng.choice(num_types, num_nodes, p=weight / weight.sum())
    zone = rng.integers(0, len(ZONES), num_nodes)
    spot = rng.random(num_nodes) < 0.3
    constrained = rng.random(num_nodes) < 0.1
    limit = rng.uniform(0.5, 0.98, num_nodes)[:, None] * usable[node_type]
    weights = zipf_weights(shape_vectors.shape[0])
    counts = np.zeros((num_nodes, shape_vectors.shape[0]), np.int64)
    used = np.zeros((num_nodes, shape_vectors.shape[1]))
    misses = np.zeros(num_nodes, np.int64)
    while (misses < 8).any():
        open_nodes = misses < 8
        shape = rng.choice(shape_vectors.shape[0], num_nodes, p=weights)
        grown = used + shape_vectors[shape]
        fits = open_nodes & (grown <= limit).all(axis=1)
        used[fits] = grown[fits]
        counts[fits, shape[fits]] += 1
        misses[fits] = 0
        misses[open_nodes & ~fits] += 1
    return {"node_type": node_type, "zone": zone, "spot": spot, "constrained": constrained, "counts": counts}


def consolidation_problem(cluster, catalog, shapes, package, max_candidates: int = MAX_CANDIDATES):
    """One consolidation sweep's ConsolidationProblem for `package`, built by
    the controller's rules (karpenter_tpu/controllers/consolidation.py):
    candidates are the least-utilized nodes below UNDERUTILIZED_FRACTION
    (utilization = the largest used/allocatable share over the tracked axes,
    :234-242, :364-371), their pods grouped by group_pods; receivers are every
    node with headroom = allocatable - used, tightest cpu first (:377-396),
    the victim masked out of its own row and a constrained candidate's row
    all False, so only its replace leg counts (:519-530); the replacement fleet is
    build_fleet over the catalog with the candidates' largest pods as
    pods_need (:398-428) and type_valid by the accelerator rule (:448-473).
    Returns (problem, each candidate's group members, receiver headroom in
    float64)."""
    vectors = shape_vectors(shapes, package)
    counts = cluster["counts"]
    num_nodes = counts.shape[0]
    names = [f"node-{i:05d}" for i in range(num_nodes)]
    usable = usable_capacity(catalog, package)[cluster["node_type"]]
    used = counts @ vectors
    tracked = usable > 0
    utilization = np.where(tracked, used / np.where(tracked, usable, 1.0), 0.0).max(axis=1)
    nominated = [i for i in range(num_nodes) if counts[i].sum() > 0 and utilization[i] < UNDERUTILIZED_FRACTION]
    candidates = sorted(nominated, key=lambda i: (utilization[i], names[i]))[:max_candidates]

    headroom = np.maximum(usable - used, 0.0)
    receivers = sorted(range(num_nodes), key=lambda i: (headroom[i, 0], names[i]))
    groups = []
    for i in candidates:
        pods = [
            package.PodSpec(name=f"{names[i]}-{k}-{j}", requests={"cpu": f"{cpu}m", "memory": f"{mem}Mi"},
                            node_name=names[i])
            for k, (cpu, mem) in enumerate(shapes)
            for j in range(int(counts[i, k]))
        ]
        groups.append(package.group_pods(pods))
    num_dims = vectors.shape[1]
    num_groups = max(max(g.num_groups for g in groups), 1)
    pod_vectors = np.zeros((len(candidates), num_groups, num_dims), np.float32)
    pod_counts = np.zeros((len(candidates), num_groups), np.int32)
    for c, g in enumerate(groups):
        pod_vectors[c, : g.num_groups] = g.vectors
        pod_counts[c, : g.num_groups] = g.counts
    receiver_index = np.array(receivers)
    bin_mask = receiver_index[None, :] != np.array(candidates)[:, None]
    bin_mask[cluster["constrained"][candidates]] = False
    pods_need = np.max([g.vectors.max(axis=0) for g in groups], axis=0)
    fleet = package.build_fleet(catalog, package.Constraints(), pods=[], daemons=[], pods_need=pods_need)
    demand = np.stack([g.vectors.T @ g.counts for g in groups])
    type_valid = np.ones((len(candidates), fleet.num_types), dtype=bool)
    for index in package.accel_indexes:
        type_valid &= ~((fleet.total[None, :, index] > 0) & (demand[:, None, index] <= 0))
    node_prices = np.array([
        next(
            o.price for o in catalog[cluster["node_type"][i]].offerings
            if o.zone == ZONES[cluster["zone"][i]]
            and o.capacity_type == ("spot" if cluster["spot"][i] else "on-demand")
        )
        for i in candidates
    ])
    problem = package.consolidate.ConsolidationProblem(
        pod_vectors=pod_vectors,
        pod_counts=pod_counts,
        headroom=headroom[receiver_index].astype(np.float32),
        bin_mask=bin_mask,
        node_prices=node_prices,
        type_capacity=fleet.capacity,
        type_prices=fleet.prices,
        type_valid=type_valid,
    )
    return problem, [g.members for g in groups], headroom[receiver_index]


def random_consolidation_problem(seed, num_candidates, num_groups, num_bins, num_types, dims: int = 8):
    """A seeded consolidation problem as numpy arrays (ConsolidationProblem's
    fields): zero-count and zero-vector groups, all-False bin_mask rows,
    candidates with no feasible type, tied prices and savings. The first
    `dims` axes carry requests; every axis past the pods axis is a count of 0
    or 1."""
    rng = np.random.default_rng(seed)
    vectors = np.zeros((num_candidates, num_groups, 8), np.float32)
    vectors[:, :, 0] = rng.integers(1, 17, (num_candidates, num_groups)) * 250
    vectors[:, :, 1] = rng.integers(1, 33, (num_candidates, num_groups)) * 256
    vectors[:, :, 2] = 1
    vectors[:, :, 3:dims] = rng.random((num_candidates, num_groups, max(dims - 3, 0))) < 0.1
    vectors[rng.random((num_candidates, num_groups)) < 0.15] = 0.0
    counts = rng.integers(0, 9, (num_candidates, num_groups)).astype(np.int32)
    counts[rng.random((num_candidates, num_groups)) < 0.15] = 0
    headroom = np.zeros((num_bins, 8), np.float32)
    headroom[:, 0] = rng.integers(0, 17, num_bins) * 1000
    headroom[:, 1] = rng.integers(0, 65, num_bins) * 1024
    headroom[:, 2] = rng.integers(0, 30, num_bins)
    headroom[:, 3:] = rng.integers(0, 2, (num_bins, 5))
    bin_mask = rng.random((num_candidates, num_bins)) < 0.8
    bin_mask[rng.random(num_candidates) < 0.2] = False
    capacity = np.zeros((num_types, 8), np.float32)
    capacity[:, 0] = rng.integers(1, 33, num_types) * 1000
    capacity[:, 1] = rng.integers(1, 129, num_types) * 1024
    capacity[:, 2] = 110
    capacity[:, 3:] = rng.integers(0, 2, (num_types, 5))
    prices = rng.choice([0.1, 0.2, 0.4, 0.8], num_types).astype(np.float32)
    type_valid = rng.random((num_candidates, num_types)) < 0.9
    type_valid[rng.random(num_candidates) < 0.15] = False  # no feasible type
    return dict(
        pod_vectors=vectors, pod_counts=counts, headroom=headroom, bin_mask=bin_mask,
        node_prices=rng.choice([0.3, 0.5, 1.0], num_candidates), type_capacity=capacity,
        type_prices=prices, type_valid=type_valid,
    )


def huge_fit_problem(num_bins: int = 3):
    """Bins whose fits pass 2**24 after small ones: the prefix sum must be
    the sequential float32 fold (fl(3 + 2**25) = 2**25 + 4)."""
    vectors = np.zeros((2, 1, 8), np.float32)
    vectors[:, 0, 0] = 1000.0
    headroom = np.zeros((num_bins, 8), np.float32)
    headroom[:, 0] = 5000.0
    headroom[0, 0] = 3000.0
    headroom[1::97, 0] = 2.0**25 * 1000.0
    return dict(
        pod_vectors=vectors, pod_counts=np.array([[10], [2]], np.int32), headroom=headroom,
        bin_mask=np.ones((2, num_bins), bool), node_prices=np.array([0.5, 0.6]),
        type_capacity=np.full((1, 8), 1e9, np.float32), type_prices=np.array([0.1], np.float32),
        type_valid=np.ones((2, 1), bool),
    )


def k7_problems():
    """(name, arrays) the card holds K7 to its plain version on, beside the
    real-size sweep: small seeded problems off their buckets, fits past 2**24
    (the kernel's sequential fold across the cluster), N = 8192 with 3 and
    with all 8 axes requested (the room in shared memory; in global scratch
    when a test forces one block a candidate), and N 4,101 and 4,100 (no
    int4 store, a short last thread)."""
    for seed, shape in enumerate([(1, 1, 1, 1), (3, 5, 9, 17), (13, 11, 70, 40), (17, 9, 1300, 20), (64, 16, 2000, 300)]):
        yield "C{}-G{}-N{}-T{}".format(*shape), random_consolidation_problem(seed, *shape)
    yield "fit-past-2^24-N3", huge_fit_problem(3)
    yield "fit-past-2^24-N3000", huge_fit_problem(3000)
    yield "N8192-3-axes", random_consolidation_problem(7, 8, 4, 8192, 64, dims=3)
    yield "N8192-8-axes", random_consolidation_problem(8, 8, 4, 8192, 64, dims=8)
    yield "N4101", random_consolidation_problem(21, 5, 6, 4101, 30)
    yield "N4100-5-axes", random_consolidation_problem(22, 5, 6, 4100, 30, dims=5)


def dominance_cases():
    """The edge cases K1 is held to: T = 1, a size ladder, random shapes with
    invalid (zero capacity, +inf price) rows and ties, T not a multiple of
    a block's rows, all-invalid problems, T 4,096."""
    rng = np.random.default_rng(3)
    yield np.zeros((1, 8), np.float32), np.array([1.5], np.float32)
    ladder = np.arange(1, 9, dtype=np.float32)[:, None] * np.ones((1, 8), np.float32)
    yield ladder, (0.1 * np.arange(1, 9)).astype(np.float32)
    for num_types in (2, 17, 39, 129, 300):
        capacity = rng.integers(0, 6, (num_types, 8)).astype(np.float32)
        prices = rng.choice([0.25, 0.5, 1.0], num_types).astype(np.float32)  # ties
        invalid = rng.random(num_types) < 0.2
        capacity[invalid] = 0.0
        yield capacity, np.where(invalid, np.inf, prices).astype(np.float32)
    yield np.zeros((5, 8), np.float32), np.full(5, np.inf, np.float32)
    # A block's rows ragged (T 513), 32 rows a block (T 4,096), all invalid.
    for num_types in (513, 4096):
        capacity = rng.integers(0, 9, (num_types, 8)).astype(np.float32)
        prices = rng.choice([0.125, 0.25, 0.5, 1.0, 2.0], num_types).astype(np.float32)
        invalid = rng.random(num_types) < 0.1
        capacity[invalid] = 0.0
        yield capacity, np.where(invalid, np.inf, prices).astype(np.float32)
    yield np.zeros((513, 8), np.float32), np.full(513, np.inf, np.float32)


# K3 against its plain version: the CPU parity test's tolerances
# (tests/test_torch_kernels.py): 300 float32 Adam steps whose sums are taken
# in other orders drift apart by rounding.
LP_OBJECTIVE_RTOL = 1e-4
LP_ASSIGNMENT_ATOL = 1e-3
# A sharded LP's assignment sums to the solvable pods within this relative
# gap (the CPU parity test's pods tolerance, tests/test_torch_parallel.py).
LP_PODS_RTOL = 1e-3
LP_SEEDS = (0, 1, 3, 4, 6, 7, 8, 9)


def lp_problem(seed: int):
    """The non-degenerate LP family of tests/test_torch_kernels.py (same
    draws, 8 groups x 16 types): every type has its own price per core."""
    rng = np.random.default_rng(seed)
    real_groups = int(rng.integers(2, 9))
    real_types = int(rng.integers(3, 17))
    vectors = np.zeros((8, 8), np.float32)
    vectors[:real_groups, 0] = np.sort(rng.integers(1, 17, real_groups))[::-1] * 250
    vectors[:real_groups, 1] = rng.integers(1, 33, real_groups) * 256
    vectors[:real_groups, 2] = 1
    counts = np.zeros(8, np.int32)
    counts[:real_groups] = rng.integers(1, 60, real_groups)
    cpu = np.sort(rng.integers(1, 17, real_types)) * 1000.0
    capacity = np.zeros((16, 8), np.float32)
    capacity[:real_types, 0] = cpu - 100
    capacity[:real_types, 1] = cpu * rng.choice([2.0, 4.0, 8.0], real_types) - 600
    capacity[:real_types, 2] = 110
    valid = np.zeros(16, bool)
    valid[:real_types] = True
    prices = np.full(16, np.inf, np.float32)
    prices[:real_types] = cpu / 1000 * rng.uniform(0.03, 0.06, real_types)
    return vectors, counts, capacity, valid, prices


def lp_inputs(seed: int, shape, device):
    """lp_problem(seed) padded to shape = (G, T) with zero-count groups and
    invalid types, as the bucket padding pads the main path, on the card:
    (vectors, solvable counts, capacity, valid, effective prices). A G
    under 8 keeps the first G groups."""
    import torch

    from karpenter_tpu_torch.ops import cuda_kernels, score_kernel

    vectors, counts, capacity, valid, prices = lp_problem(seed)
    num_groups, num_types = shape
    vectors = np.pad(vectors[:num_groups], ((0, max(num_groups - 8, 0)), (0, 0)))
    counts = np.pad(counts[:num_groups], (0, max(num_groups - 8, 0)))
    capacity = np.pad(capacity, ((0, num_types - 16), (0, 0)))
    valid = np.pad(valid, (0, num_types - 16))
    prices = np.pad(prices, (0, num_types - 16), constant_values=np.inf)
    vectors, counts, capacity, valid, prices = (
        torch.from_numpy(a).to(device) for a in (vectors, counts, capacity, valid, prices)
    )
    effective = cuda_kernels._dominance_prices_ref(capacity, torch.where(valid, prices, torch.inf))
    feasible_any = score_kernel.feasibility_mask(vectors, capacity, valid).any(dim=1)
    return vectors, torch.where(feasible_any, counts, 0), capacity, valid, effective


def lp_operations(groups: int, types: int, dims: int, steps: int) -> int:
    """fp32 operations of the LP relaxation, counting exp, log, square root
    and division as one each. Per step and cell (g, t): the masked softmax
    (select, max, subtract, exp, add, divide: 6), x = c * S (1), its share of
    D (2 per axis), dx and dS (2 per axis, 1), the row dot (2), the softmax
    backward (2) and Adam (16); per type and axis: f, the scaled smooth max,
    w and dD (9). The start takes about 4 per type plus 2 per axis and cell
    for the mask; the result a softmax, x and D again plus the max and the
    objective."""
    cells = groups * types
    per_step = cells * (6 + 1 + 2 * dims + 2 * dims + 1 + 2 + 2 + 16) + types * dims * 9
    start = types * (dims + 4) + cells * (2 * dims + 6)
    result = cells * (6 + 1 + 2 * dims) + types * (2 * dims + 2)
    return steps * per_step + start + result


@contextlib.contextmanager
def per_phase_k9a(plain: bool = False):
    """Within the block, the sharded LP takes K9a's per-phase route (the
    route of a mesh across cards: three phases a shard a step, the
    collectives between) whatever its mesh, through the phases' kernels or,
    with `plain`, their plain versions on whatever device its tensors lie."""
    from karpenter_tpu_torch.parallel import sharded_solver

    saved = sharded_solver._route
    run = functools.partial(sharded_solver._run_phases,
                            phases=sharded_solver._PLAIN_PHASES if plain else None)
    sharded_solver._route = lambda mesh: run
    try:
        yield
    finally:
        sharded_solver._route = saved


def plain_k9a():
    """Within the block, the sharded LP runs K9a's plain versions: the
    per-phase route through the phases' plain versions, the plain version
    of both routes."""
    return per_phase_k9a(plain=True)


@contextlib.contextmanager
def plain_k9b():
    """Within the block, the sharded compaction runs K9b's plain versions
    (the one-card payload's and the per-card route's)."""
    from karpenter_tpu_torch.ops import pack_kernel

    saved = pack_kernel.compact_sharded_payload, pack_kernel.compact_shards
    pack_kernel.compact_sharded_payload = pack_kernel._compact_sharded_payload_ref
    pack_kernel.compact_shards = pack_kernel._compact_shards_ref
    try:
        yield
    finally:
        pack_kernel.compact_sharded_payload, pack_kernel.compact_shards = saved


def k9a_phase_cases(shards: int, device, seed: int = 0):
    """One shard's block of the main path's [16, 512] LP on a mesh of
    `shards` (2x2: [8, 256], 2x4: [8, 128]), random state: for each of
    K9a's phases (the softmax with Adam, the softmax's first exact max, the
    demand with and without the assignment, the row dot) a tuple (wrapper
    name, kernel args, plain args, plain function name), the two arg lists
    separate copies (the phases update their state in place)."""
    import torch

    from karpenter_tpu_torch.parallel.mesh import _factor

    g, t = _factor(shards)
    groups, types, dims = 16 // g, 512 // t, 8
    rng = np.random.default_rng(seed)

    def f32(*shape, low=0.0, high=1.0):
        return torch.from_numpy(rng.uniform(low, high, shape).astype(np.float32)).to(device)

    feasible = torch.from_numpy(rng.random((groups, types)) < 0.7).to(device)
    logits = f32(groups, types, low=-3, high=3)
    masked = torch.where(feasible, logits, -1e9)
    ref = masked.amax(dim=1)
    share = torch.exp(masked - ref[:, None])
    vectors = torch.zeros((groups, dims), dtype=torch.float32, device=device)
    vectors[:, 0] = torch.from_numpy(rng.integers(1, 17, groups) * 250.0).float().to(device)
    vectors[:, 1] = torch.from_numpy(rng.integers(1, 33, groups) * 256.0).float().to(device)
    vectors[:, 2] = 1.0
    counts = torch.from_numpy(rng.integers(1, 4000, groups).astype(np.float32)).to(device)
    capacity = torch.zeros((types, dims), dtype=torch.float32, device=device)
    capacity[:, 0] = f32(types, low=1000, high=64000)
    capacity[:, 1] = f32(types, low=2000, high=256000)
    capacity[:, 2] = 110.0
    prices = f32(types, low=0.05, high=5.0)
    demand = f32(types, dims, low=0, high=5e5) * (capacity > 0)
    bias = torch.tensor([1 - 0.9**5, 1 - 0.999**5], dtype=torch.float32, device=device)

    def copies(*args):
        return [a.clone() if isinstance(a, torch.Tensor) else a for a in args], \
            [a.clone() if isinstance(a, torch.Tensor) else a for a in args]

    cases = []
    # Adam's moments are 0 on infeasible cells (their gradient always is).
    mu = torch.where(feasible, f32(groups, types, low=-0.1, high=0.1), 0.0)
    nu = torch.where(feasible, f32(groups, types, high=0.01), 0.0)
    state = (logits, mu, nu, share / share.sum(dim=1, keepdim=True),
             f32(groups, types, low=-1, high=1), feasible)
    for row_dot, reference, step_bias in ((f32(groups, low=-1, high=1), ref, bias), (None, None, None)):
        kernel_args, plain_args = copies(*state, row_dot, reference, step_bias)
        cases.append(("shard_softmax", kernel_args, plain_args, "_softmax_ref"))
    for assignment in (torch.empty((groups, types), device=device), None):
        kernel_args, plain_args = copies(share, feasible, counts, vectors, share.sum(dim=1), assignment)
        cases.append(("shard_demand", kernel_args, plain_args, "_demand_ref"))
    kernel_args, plain_args = copies(state[3], torch.zeros_like(share), feasible, counts, vectors,
                                     capacity, prices, demand)
    cases.append(("shard_row_dot", kernel_args, plain_args, "_row_dot_ref"))
    return cases


def phase_close(got, want, kernel_args, plain_args, rtol: float = 1e-4) -> bool:
    """A K9a phase's outputs and the state it updated in place agree with
    its plain version's: each float tensor within rtol of its scale (sums in
    other orders; expf against torch.exp)."""
    import torch

    pairs = list(zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)))
    pairs += [(a, b) for a, b in zip(kernel_args, plain_args) if isinstance(a, torch.Tensor)]
    for a, b in pairs:
        if a is None or b is None:
            if a is not b:
                return False
            continue
        if a.dtype == torch.bool:
            if not torch.equal(a, b):
                return False
            continue
        scale = max(float(b.abs().max()), 1e-30)
        if not float((a - b).abs().max()) <= rtol * scale:
            return False
    return True


def random_pack_problem(rng, num_groups: int, num_types: int):
    vectors = np.zeros((num_groups, 8), np.float32)
    real = int(rng.integers(1, num_groups + 1))
    vectors[:real, 0] = np.sort(rng.integers(1, 17, real))[::-1] * 250
    vectors[:real, 1] = rng.integers(1, 33, real) * 256
    vectors[:real, 2] = 1
    if rng.random() < 0.5:
        vectors[0, 0] = 70_000  # larger than any type: retired as unschedulable
    counts = np.zeros(num_groups, np.int32)
    counts[:real] = rng.integers(1, 3000, real)
    real_types = int(rng.integers(1, num_types + 1))
    capacity = np.zeros((num_types, 8), np.float32)
    cpu = np.sort(rng.integers(1, 65, real_types)) * 1000
    capacity[:real_types, 0] = cpu - 100
    capacity[:real_types, 1] = cpu * rng.choice([2, 4, 8], real_types) - 600
    capacity[:real_types, 2] = 110
    valid = np.zeros(num_types, bool)
    valid[:real_types] = True
    prices = np.full(num_types, np.inf, np.float32)
    prices[:real_types] = cpu / 1000 * rng.uniform(0.03, 0.05, real_types)
    return vectors, counts, capacity, capacity.copy(), valid, prices


def dense_pack_problem(seed: int, num_groups: int, num_types: int = 4):
    """A pack problem whose rounds are dense: each group requests one or two
    of the eight axes, so a node of any type holds pods of many groups at
    once, round after round. At G 16 and 64 the fills of some seeds hold
    more nonzero cells than the compaction's entry budget (4 x MR)."""
    rng = np.random.default_rng(seed)
    dims = 8
    vectors = np.zeros((num_groups, dims), np.float32)
    for g in range(num_groups):
        vectors[g, g % dims] = rng.integers(1, 4)
        vectors[g, (3 * g + 1) % dims] = rng.integers(0, 2)
    counts = rng.integers(50, 2000, num_groups).astype(np.int32)
    capacity = np.stack([rng.integers(20, 60, dims) * (t + 1) for t in range(num_types)]).astype(np.float32)
    prices = (capacity.sum(axis=1) * rng.uniform(0.9, 1.1, num_types)).astype(np.float32)
    return vectors, counts, capacity, capacity.copy(), np.ones(num_types, bool), prices


# (seed, G) of dense_pack_problem past the entry budget in at least one mode.
DENSE_PACK_CASES = ((27, 16), (0, 64))


def fused_against_plain(args, plain, bare, label: str) -> int:
    """K2's pair with its epilogue on `args` (one K2 launch, counted on
    pack_kernel.launches and pack_pair_payload.launches): its payload,
    feasible_any, solvable and dense spill word for word equal to the plain
    composition `plain`, its rounds bit for bit equal to the pair launched
    without the epilogue (`bare`). Returns the largest word difference."""
    import torch

    from karpenter_tpu_torch.ops import pack_kernel

    before = (pack_kernel.pack_kernel.launches, pack_kernel.pack_pair_payload.launches)
    got = pack_kernel.pack_pair_payload(*args)
    after = (pack_kernel.pack_kernel.launches, pack_kernel.pack_pair_payload.launches)
    check(after == (before[0] + 1, before[1] + 1),
          f"the fused pair took {after[0] - before[0]} K2 launches at {label}")
    synchronize(args[0].device)
    err = 0
    for name in ("feasible_any", "solvable", "dense", "payload"):
        a, b = getattr(got, name), getattr(plain, name)
        check(a.dtype == b.dtype and torch.equal(a, b),
              f"the fused pair's {name} differs from the plain version at {label}")
        err = max(err, int((a.long() - b.long()).abs().max()))
    for mode, rounds, alone in zip(("ffd", "cost"), got[:2], bare):
        check(rounds_equal(rounds, alone),
              f"the fused pair's {mode} rounds differ from the pair without its epilogue at {label}")
    return err


def dense_rounds(num_groups: int, seed: int, density: float, device):
    """PackRounds on `device` whose fills are nonzero with the given density:
    sparse plans inside the compaction's entry budget, dense ones past it."""
    import torch

    from karpenter_tpu_torch.ops.pack_kernel import PackRounds, max_rounds

    rng = np.random.default_rng(seed)
    mr = max_rounds(num_groups)
    fill = rng.integers(1, 5, (mr, num_groups)) * (rng.random((mr, num_groups)) < density)
    fields = (
        rng.integers(0, 16, mr), fill, rng.integers(1, 5, mr), rng.integers(0, mr),
        rng.integers(0, 3, num_groups), seed % 2,
    )
    return PackRounds(*(torch.tensor(np.asarray(f), dtype=torch.int32, device=device) for f in fields))


def rounds_equal(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def rounds_abs_err(a, b) -> float:
    return max(float((x.long() - y.long()).abs().max()) for x, y in zip(a, b))


def synchronize(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_cuda(fn, reps: int, warmup: int = 3) -> float:
    """Median milliseconds of fn() over reps, each bracketed by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return float(np.median(samples))


def layer_breakdown(groups, fleet, device, reps: int = 5) -> dict:
    """Median wall milliseconds of each layer of one warm solve, each layer
    bracketed by device synchronizations so its own launches and device work
    are inside its bracket (the solve itself syncs once, at the fetch)."""
    import torch

    from karpenter_tpu_torch.convert import fused_args_from_numpy
    from karpenter_tpu_torch.models import solver
    from karpenter_tpu_torch.ops import cuda_kernels, pack_kernel, score_kernel

    samples: dict = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        samples.setdefault(name, []).append((time.perf_counter() - start) * 1e3)
        return out

    for _ in range(reps):
        padded = timed("pad", lambda: solver.pad_kernel_args(
            groups.vectors, groups.counts, fleet.capacity, fleet.total, fleet.prices))
        vectors, counts, capacity, total, valid, prices = timed(
            "h2d", lambda: fused_args_from_numpy(*padded, device=device))
        effective = timed("k1_dominance", lambda: cuda_kernels.dominance_prices(
            capacity, torch.where(valid, prices, torch.inf)))
        # K2's pair with its epilogue: the rounds, feasible_any, the LP's
        # counts, the dense spill and the compacted payload (K4).
        pair = timed("k2_pack", lambda: pack_kernel.pack_pair_payload(
            vectors, counts, capacity, total, valid, effective))
        lp = timed("k3_lp", lambda: score_kernel.lp_relax(
            vectors, pair.solvable, capacity, valid, effective))
        handle = solver.FusedHandle(
            compact=pair.payload, objective=lp.objective.reshape(1), dense=pair.dense,
            lp=lp.assignment.reshape(-1), num_groups=padded[0].shape[0],
            num_types=padded[2].shape[0],
        )
        (plan,) = timed("fetch", lambda: solver.fetch_plans([handle]))
        zones, matrix = timed("pool_matrix", lambda: solver._pool_price_matrix(fleet))
        mix = timed("mix_candidate", lambda: solver.compute_mix_candidate(
            groups.vectors, groups.counts, fleet.capacity, matrix))
        dense = timed("scoring", lambda: solver.cost_solve_finish(
            plan, groups.vectors, groups.counts, fleet.capacity, fleet.total,
            fleet.prices, matrix, mix_plan=mix))
        timed("decode", lambda: solver.decode_dense_result(dense, groups, fleet, zones))
    return {name: float(np.median(values)) for name, values in samples.items()}


def profile_call(fn) -> dict:
    """torch.profiler over one call of `fn`: device time summed over every
    kernel and copy it ran (an upper bound on the time the card was busy:
    work on two streams at once counts twice), against the call's wall
    time, which includes the profiler's own cost."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    check(events and device_ms > 0, "the profiled call shows no device time")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
    return {
        "result": result,
        "wall_ms": wall_ms,
        "device_ms": device_ms,
        "busy_share": device_ms / wall_ms,
        "device_launches": sum(e.count for e in events),
        "top": [(e.key[:60], e.count, e.self_device_time_total / 1e3) for e in top],
    }


def all_pods_placed_once(result, pods) -> bool:
    placed = [pod.uid for packing in result.packings for node in packing.pods_per_node for pod in node]
    return (
        not result.unschedulable
        and len(placed) == len(pods)
        and set(placed) == {pod.uid for pod in pods}
    )


def k7_inputs(problem, device):
    """K7's padded operands on `device` and the count of requested axes its
    room is sized for, as ops/consolidate.solve_candidates makes them."""
    from karpenter_tpu_torch.convert import upload_packed
    from karpenter_tpu_torch.ops import consolidate, consolidate_kernel

    padded = consolidate._padded(problem)
    return upload_packed(padded, device), consolidate_kernel.requested_axes(padded[0])


def k7_needed_bytes(operands) -> int:
    """Bytes K7 must move on these operands: pod vectors and counts, the bin
    and type masks and node prices read once; headroom only on the bins some
    candidate may use and on the axes that candidate requests; capacity only
    of the types valid for some candidate, prices only of those that fit
    some candidate; the [C, G, N] plan and the eager buffer written once."""
    import torch

    from karpenter_tpu_torch.ops import consolidate_kernel
    from karpenter_tpu_torch.ops.score_kernel import feasibility_mask

    pod_vectors, pod_counts, headroom, bin_mask, capacity, prices, type_valid, node_prices, cand_valid = operands
    num_candidates, num_groups, dims = pod_vectors.shape
    num_bins = headroom.shape[0]
    requested = (pod_vectors > 0).any(dim=1)  # [C, R]
    headroom_cells = int((bin_mask[:, :, None] & requested[:, None, :]).any(dim=0).sum())
    counts = pod_counts.to(torch.float32)
    demand = torch.zeros_like(pod_vectors[:, 0, :])
    for g in range(num_groups):
        demand = demand + pod_vectors[:, g, :] * counts[:, g, None]
    fits = feasibility_mask(demand, capacity, torch.ones_like(type_valid[0])) & type_valid
    read = (
        pod_vectors.numel() * 4 + pod_counts.numel() * 4 + bin_mask.numel() + type_valid.numel()
        + node_prices.numel() * 4 + cand_valid.numel() + 4 * headroom_cells
        + 4 * dims * int(type_valid.any(dim=0).sum()) + 4 * int(fits.any(dim=0).sum())
    )
    written = 4 * (num_candidates * num_groups * num_bins
                   + consolidate_kernel.eager_words(num_candidates, num_groups, num_bins))
    return read + written


def k6_needed(operands, mode: str = "cost"):
    """(bytes, operations, rounds a level) K6 must spend on these operands:
    every input read once and the output written once; per distinct level
    and round, the scan of each group still holding pods over the types that
    may take it (a division, a minimum, a multiply and a subtract per axis
    the group requests, an add and a floor), counted from the level's own
    rounds (its plain version, one level at a time). A padded level repeats
    the last real one and adds no work of its own (its rounds are listed)."""
    import torch

    from karpenter_tpu_torch.ops import pack_kernel

    vectors, counts, capacity, total, valid, prices, allow, penalty, conflict, node_cap = operands
    num_levels, num_groups = counts.shape
    read = sum(t.numel() * t.element_size() for t in operands if t is not total)
    written = 4 * pack_kernel.level_pack_words(num_groups, num_levels)
    fits = (vectors[:, None, :] <= capacity[None, :, :] + 1e-6).all(dim=-1)
    usable = allow & fits[None] & valid[None, None, :]
    # Per group, its usable types times the scan's operations a type.
    scan = (usable.sum(dim=2) * (4 * (vectors > 0).sum(dim=1) + 2)[None, :]).long().cpu().numpy()
    distinct = []
    ops = 0
    rounds_of = []
    for level in range(num_levels):
        same = [other for other in distinct
                if torch.equal(counts[level], counts[other]) and torch.equal(allow[level], allow[other])
                and torch.equal(penalty[level], penalty[other])]
        if same:
            rounds_of.append(rounds_of[same[0]])
            continue
        distinct.append(level)
        one = [vectors, counts[level : level + 1], capacity, total, valid, prices,
               allow[level : level + 1], penalty[level : level + 1], conflict, node_cap]
        rounds = plain_levels(one, mode).rounds
        rounds_of.append(int(rounds.num_rounds))
        remaining = torch.where(usable[level].any(dim=1), counts[level], 0).long().cpu().numpy()
        fills = rounds.round_fill.long().cpu().numpy()
        repl = rounds.round_repl.long().cpu().numpy()
        for r in range(int(rounds.num_rounds)):
            ops += int(scan[level][remaining > 0].sum())
            remaining -= repl[r] * fills[r]
    return read + written, ops, rounds_of


def device_ms_per_call(fn, kernels, reps: int = 20) -> float:
    """torch.profiler's device time of the named kernels per call of `fn`:
    the kernels' own time on the card, without the host's enqueue.
    `kernels` is a list of names that `fn` launches once each, or a dict of
    each name's launches per call. The profiler now and then drops a kernel
    record of a window. A window that saw every launch gives the time as it
    is; else the window is measured again, up to three times, and then the
    one that saw most gives each name's mean time per recorded launch times
    its launches per call, provided no name lost more than
    max(2, 1%) of its records. More records than launches fail."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    per_call = kernels if isinstance(kernels, dict) else {name: 1 for name in kernels}
    fn()
    torch.cuda.synchronize()
    best = None
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        seen = {name: [0, 0.0] for name in per_call}
        for event in prof.key_averages():
            if event.device_type != torch.autograd.DeviceType.CUDA:
                continue
            for name in per_call:
                if name in event.key:
                    seen[name][0] += event.count
                    seen[name][1] += event.self_device_time_total
        short = {name: reps * per_call[name] - seen[name][0] for name in per_call}
        check(all(lost >= 0 for lost in short.values()),
              f"the profiler saw more launches of {list(per_call)} than {reps} calls make: {short}")
        if not any(short.values()):
            return sum(us for _, us in seen.values()) / 1e3 / reps
        print(f"  the profiler dropped records of {list(per_call)} (launches not seen: {short})")
        if best is None or sum(short.values()) < sum(best[1].values()):
            best = (seen, short)
    seen, short = best
    check(all(0 < seen[name][0] and short[name] <= max(2, reps * per_call[name] // 100) for name in per_call),
          f"the profiler dropped too many records of {list(per_call)}: launches not seen {short}")
    return sum(seen[name][1] / seen[name][0] * per_call[name] for name in per_call) / 1e3


def paired_device_ms(first, second, kernel: str, reps: int = 50) -> tuple:
    """torch.profiler's device time of `kernel` per call of `first` and of
    `second`, each launching it once, called in turns in one profile: the
    records, in the card's order on one stream, alternate between the two.
    A window that lost a record is measured again, up to three times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    first()
    second()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                first()
                second()
            torch.cuda.synchronize()
        records = sorted(
            (e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name),
            key=lambda e: e.time_range.start)
        if len(records) == 2 * reps:
            return tuple(sum(e.time_range.elapsed_us() for e in records[k::2]) / reps / 1e3 for k in (0, 1))
        print(f"  the profiler kept {len(records)} of {2 * reps} records of {kernel}; measuring again")
    check(False, f"the profiler dropped records of {kernel} in three windows")


def k10_against_library_device_ms(k10_call, library_call, reps: int = 200) -> tuple:
    """torch.profiler's device time per call of K10 and of the library call
    that computes the same column (torch.addcmul), the two called in turns
    in one profile: the records that are not K10's are the library's (it
    launches one kernel a call). Returns (K10 ms, library ms, the library
    kernel's name). A window that lost a record is measured again, up to
    three times; then, as device_ms_per_call does, the window that kept
    most gives each side's mean time per kept record, provided neither
    side lost more than max(2, 1%) of its records."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    k10_call()
    library_call()
    torch.cuda.synchronize()
    best = None
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                k10_call()
                library_call()
            torch.cuda.synchronize()
        records = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.name.startswith(("Memcpy", "Memset"))]
        ours = [e for e in records if "penalize_kernel" in e.name]
        theirs = [e for e in records if "penalize_kernel" not in e.name]
        check(len(ours) <= reps and len(theirs) <= reps,
              f"the profiler kept more records than {reps} calls make: {len(ours)} K10, {len(theirs)} library")
        if len(ours) == len(theirs) == reps:
            return (sum(e.time_range.elapsed_us() for e in ours) / reps / 1e3,
                    sum(e.time_range.elapsed_us() for e in theirs) / reps / 1e3, theirs[0].name[:120])
        print(f"  the profiler kept {len(ours)} K10 and {len(theirs)} library records of {reps}; measuring again")
        if best is None or len(ours) + len(theirs) > len(best[0]) + len(best[1]):
            best = (ours, theirs)
    ours, theirs = best
    allowed = max(2, reps // 100)
    check(ours and theirs and reps - len(ours) <= allowed and reps - len(theirs) <= allowed,
          f"the profiler dropped too many records of K10 or torch.addcmul: kept {len(ours)} and "
          f"{len(theirs)} of {reps}")
    return (sum(e.time_range.elapsed_us() for e in ours) / len(ours) / 1e3,
            sum(e.time_range.elapsed_us() for e in theirs) / len(theirs) / 1e3, theirs[0].name[:120])


def kernel_records(fn, copies: bool = False) -> dict:
    """{kernel name: records} torch.profiler shows for one call of `fn`
    (copies and fills left out unless `copies`, then under their own
    names): what a call launches on the card."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    records = {}
    for event in prof.events():
        if event.device_type != torch.autograd.DeviceType.CUDA or (
                not copies and event.name.startswith(("Memcpy", "Memset"))):
            continue
        match = re.search(r"(\w+_kernel)", event.name)
        name = match.group(1) if match else event.name
        records[name] = records.get(name, 0) + 1
    return records


def consolidate_phase(catalog, device) -> dict:
    """One consolidation sweep at the large-cluster envelope through the
    entry point the controller calls (ops/consolidate.solve_candidates on
    `device`), its checks against the CPU run and K7 against its plain
    version. Returns K7's operands at this size, its launches in the sweep
    and its largest difference from the plain version."""
    import torch

    from karpenter_tpu_torch.ops import consolidate, consolidate_kernel

    start = time.perf_counter()
    package = port_package()
    shapes = pod_shapes(0)
    cluster = make_cluster(usable_capacity(catalog, package), shape_vectors(shapes, package))
    problem, members, receiver_headroom = consolidation_problem(cluster, catalog, shapes, package)
    problem_ms = (time.perf_counter() - start) * 1e3
    consolidate_kernel.solve_counterfactuals.launches = 0
    synchronize(device)
    start = time.perf_counter()
    verdicts = consolidate.solve_candidates(problem, device=device)
    sweep_cold_ms = (time.perf_counter() - start) * 1e3
    sweep_launches = consolidate_kernel.solve_counterfactuals.launches
    sweep_fetch_bytes = consolidate.LAST_FETCH_BYTES
    check(sweep_launches == 1, f"the consolidation sweep launched K7 {sweep_launches} times")
    sweep_ms = []
    for _ in range(10):
        start = time.perf_counter()
        consolidate.solve_candidates(problem, device=device)
        sweep_ms.append((time.perf_counter() - start) * 1e3)
    cpu_verdicts = consolidate.solve_candidates(problem, device="cpu")
    for name in ("delete_ok", "replace_type", "replace_price", "savings", "action"):
        check(np.array_equal(getattr(verdicts, name), getattr(cpu_verdicts, name)),
              f"consolidation verdict {name} differs between the card and the CPU")
    best = verdicts.best()
    check(best >= 0 and verdicts.action[best] == consolidate.ACTION_DELETE,
          f"the sweep's winner {best} is not a delete")
    check(np.array_equal(verdicts.take_row(best), cpu_verdicts.take_row(best)),
          "the winner's plan row differs between the card and the CPU")
    takes_host = verdicts.delete_take
    check(np.array_equal(takes_host, cpu_verdicts.delete_take), "the [C, G, N] plan differs between the card and the CPU")
    # The winner's delete plan: each of its pods placed once, and no
    # receiver past its headroom (float64).
    plan = consolidate.delete_assignment(verdicts, best, members[best])
    winner_pods = [pod for group in members[best] for pod in group]
    check(sorted(id(pod) for pod, _ in plan) == sorted(id(pod) for pod in winner_pods),
          "the winner's delete plan does not place each of its pods exactly once")
    usage = np.zeros_like(receiver_headroom)
    for pod, j in plan:
        usage[j] += pod.dense_vector[0]
    check((usage <= receiver_headroom).all(), "the winner's delete plan overfills a receiver")
    # Every delete-feasible candidate's plan, from the whole plan tensor.
    for c in np.nonzero(verdicts.delete_ok)[0]:
        row = takes_host[c].astype(np.float64)
        check(np.array_equal(takes_host[c].sum(axis=1), problem.pod_counts[c]), f"candidate {c} misplaces pods")
        check(not takes_host[c][:, ~problem.bin_mask[c]].any(), f"candidate {c} uses a masked receiver")
        check((row.T @ problem.pod_vectors[c].astype(np.float64) <= receiver_headroom).all(),
              f"candidate {c}'s delete plan overfills a receiver")
    # K7 against its plain version: this problem and the small ones, each
    # with its room sized as solve_candidates sizes it.
    k7_operands, k7_axes = k7_inputs(problem, device)
    k7_cases = 0
    k7_err = 0.0
    for name, (operands, axes) in [("cluster", (k7_operands, k7_axes))] + [
        (name, k7_inputs(consolidate.ConsolidationProblem(**arrays), device))
        for name, arrays in k7_problems()
    ]:
        takes, eager = consolidate_kernel.solve_counterfactuals(*operands, axes=axes)
        want = consolidate_kernel._counterfactual_ref(*operands)
        want_eager = consolidate_kernel._eager_from_outputs(*want[1:])
        synchronize(device)
        check(torch.equal(takes, want[0]) and torch.equal(eager, want_eager),
              f"K7 differs from its plain version on {name}")
        k7_err = max(k7_err, float((takes.long() - want[0].long()).abs().max()))
        k7_cases += 1
    # A room sized for fewer axes than a candidate requests is flagged
    # (best = -1), never overrun.
    _, eager = consolidate_kernel.solve_counterfactuals(*k7_operands, axes=k7_axes - 1)
    check(int(eager[3 * k7_operands[0].shape[0]]) == -1, "K7 did not flag a room sized too small")
    c_pad, g_pad, _ = k7_operands[0].shape
    plan = consolidate_kernel.counterfactual_launch_plan(
        c_pad, g_pad, k7_operands[2].shape[0], k7_axes, torch.cuda.get_device_properties(device).multi_processor_count)
    phase(
        "consolidate", nodes=CLUSTER_NODES, pods=int(cluster["counts"].sum()),
        candidates=problem.num_candidates, shape=f"C={c_pad},G={g_pad},N={k7_operands[2].shape[0]},T={k7_operands[4].shape[0]}",
        deletes=int((verdicts.action == consolidate.ACTION_DELETE).sum()),
        replaces=int((verdicts.action == consolidate.ACTION_REPLACE).sum()),
        best=best, best_savings=f"{verdicts.savings[best]:.6f}", k7_cases=k7_cases, k7_max_abs_err=k7_err,
        problem_ms=f"{problem_ms:.3f}", cold_sweep_ms=f"{sweep_cold_ms:.3f}",
        p50_ms=f"{np.percentile(sweep_ms, 50):.3f}", launches_per_sweep=sweep_launches,
        fetch_bytes=sweep_fetch_bytes, requested_axes=k7_axes, cluster=plan.cluster, threads=plan.threads,
        room_in_shared=plan.room_in_shared,
    )
    return {"operands": k7_operands, "axes": k7_axes, "launches": sweep_launches, "max_abs_err": k7_err,
            "cluster": plan.cluster, "problem": problem, "p50_ms": float(np.percentile(sweep_ms, 50))}


def sweep_records(problem, device) -> int:
    """K7's kernel records in one consolidation sweep, checked to be one.
    In a long run, profiler sessions make later sessions of the process
    drop kernel records (none at all by the end of chip_smoke's timing), so
    the full run takes this in a fresh process: `--phase consolidate`."""
    from karpenter_tpu_torch.ops import consolidate

    records = kernel_records(lambda: consolidate.solve_candidates(problem, device=device))
    check(records == {"counterfactual_kernel": 1},
          f"a consolidation sweep made other kernel records than one of K7: {records}")
    return sum(records.values())


def level_packs_equal(a, b) -> bool:
    import torch

    return (
        rounds_equal(a.rounds, b.rounds) and torch.equal(a.chosen_level, b.chosen_level)
        and torch.equal(a.group_level, b.group_level) and torch.equal(a.level_unsched, b.level_unsched)
    )


def level_pack_abs_err(a, b) -> float:
    fields = (a.chosen_level, a.group_level, a.level_unsched)
    others = (b.chosen_level, b.group_level, b.level_unsched)
    return max([rounds_abs_err(a.rounds, b.rounds)]
               + [float((x.long() - y.long()).abs().max()) for x, y in zip(fields, others)])


def plain_levels(operands, mode):
    """K6's plain version on pack_kernel_levels' ten operands (it takes no
    `total`)."""
    from karpenter_tpu_torch.ops import pack_kernel

    vectors, counts, capacity, _, valid, prices, allow, penalty, conflict, node_cap = operands
    return pack_kernel._pack_levels_ref(
        vectors, counts, capacity, valid, prices, allow, penalty, conflict, node_cap, mode=mode)


def mirror_agrees(host, pack, num_sub: int, num_levels: int) -> bool:
    """The numpy mirror's HostLevelPack (on the unpadded operands) against a
    padded LevelPack: the chosen level, its rounds, unschedulable and
    overflow, every real level's unschedulable, each real group's first
    feasible level (none: num_levels)."""
    rounds = pack.rounds
    count = int(rounds.num_rounds)
    if host.chosen_level != int(pack.chosen_level) or len(host.rounds) != count:
        return False
    for r, (t, fill, repl) in enumerate(host.rounds):
        if (t != int(rounds.round_type[r]) or repl != int(rounds.round_repl[r])
                or not np.array_equal(fill, rounds.round_fill[r, :num_sub].cpu().numpy())):
            return False
    group_level = np.minimum(pack.group_level[:num_sub].cpu().numpy(), num_levels)
    return (
        np.array_equal(host.unschedulable, rounds.unschedulable[:num_sub].cpu().numpy())
        and host.overflow == bool(rounds.overflow)
        and np.array_equal(host.group_level, group_level)
        and np.array_equal(host.level_unsched, pack.level_unsched[:num_levels, :num_sub].cpu().numpy())
    )


def constrained_phase(catalog, device, num_pods: int = NUM_PODS, mirror_modes=("cost", "ffd")) -> dict:
    """The constrained provisioning solve through the entry points the
    provisioning controller calls: Scheduler(cluster).solve -> one schedule
    that needs the compiler -> constraints.solve.solve_constrained with
    CostSolver() (K6 on `device`). Checks the chosen level, every pod placed
    once or reported unschedulable, the zones' skew, $/hr against the CPU
    run, and K6 at this size against its plain version (both modes) and the
    numpy mirror; times the layers of one warm solve. Returns K6's padded
    operands, launches a solve and differences."""
    import torch

    from karpenter_tpu_torch.api.provisioner import Provisioner, ProvisionerSpec
    from karpenter_tpu_torch.constraints import compiler
    from karpenter_tpu_torch.constraints import solve as constrained
    from karpenter_tpu_torch.constraints.mirror import pack_levels_host
    from karpenter_tpu_torch.controllers.cluster import Cluster
    from karpenter_tpu_torch.controllers.scheduling import Scheduler
    from karpenter_tpu_torch.convert import upload_packed
    from karpenter_tpu_torch.models import solver
    from karpenter_tpu_torch.ops import pack_kernel
    from karpenter_tpu_torch.ops.encode import build_fleet, group_pods

    pods = constrained_pods(num_pods)
    cluster = Cluster()
    provisioner = Provisioner(name="default", spec=ProvisionerSpec())
    schedules = Scheduler(cluster).solve(provisioner, pods)
    check(len(schedules) == 1 and schedules[0].needs_compiler,
          f"the spread schedule did not reach the compiler: {len(schedules)} schedules")
    schedule = schedules[0]
    card_solver = solver.CostSolver(device=device)

    def solve():
        return constrained.solve_constrained(card_solver, schedule, catalog, [], cluster=cluster)

    pack_kernel.pack_kernel_levels.launches = 0
    synchronize(device)
    start = time.perf_counter()
    result, decision = solve()
    first_ms = (time.perf_counter() - start) * 1e3
    launches = pack_kernel.pack_kernel_levels.launches
    if torch.device(device).type == "cuda":
        check(launches == 1, f"the constrained solve launched K6 {launches} times")
    check(decision.chosen_level == 1, f"the constrained solve chose level {decision.chosen_level}, not 1")
    check(placed_once_or_unschedulable(result, pods),
          "the constrained solve did not place every pod once or report it unschedulable")
    per_zone, skew = zone_skew(result)
    check(skew <= 1, f"the zones' skew is {skew}: {per_zone}")
    card_cost = result.projected_cost()
    warm_ms = []
    for _ in range(10):
        start = time.perf_counter()
        solve()
        warm_ms.append((time.perf_counter() - start) * 1e3)
    cpu_result, cpu_decision = constrained.solve_constrained(
        solver.CostSolver(device="cpu"), schedule, catalog, [], cluster=cluster)
    cpu_cost = cpu_result.projected_cost()
    check(cpu_decision.chosen_level == decision.chosen_level, "the CPU run chose another level")
    cost_rel = abs(card_cost - cpu_cost) / cpu_cost
    check(cost_rel <= 1e-4, f"$/hr differs between the card ({card_cost}) and the CPU ({cpu_cost})")

    # One warm solve layer by layer, each bracketed by device syncs.
    layers = {}

    def timed(name, fn):
        synchronize(device)
        start = time.perf_counter()
        out = fn()
        synchronize(device)
        layers[name] = (time.perf_counter() - start) * 1e3
        return out

    groups = timed("encode", lambda: group_pods(list(schedule.pods)))
    fleet = build_fleet(catalog, schedule.constraints, schedule.pods, [],
                        pods_need=groups.vectors.max(axis=0))
    compiled = timed("compile", lambda: compiler.compile_constraints(
        schedule, groups, fleet, cluster, cache=compiler.CompilerCache()))
    padded = timed("pad", lambda: constrained.pad_levels(compiled, fleet))
    operands = timed("h2d", lambda: upload_packed(padded, device))
    pack = timed("k6", lambda: pack_kernel.pack_kernel_levels(*operands, mode="cost"))
    host = timed("fetch", lambda: pack_kernel.level_pack_to_host(pack))
    num_sub, num_levels = compiled.num_subgroups, compiled.num_levels
    rounds = [
        (int(host.rounds.round_type[r]), host.rounds.round_fill[r, :num_sub], int(host.rounds.round_repl[r]))
        for r in range(int(host.rounds.num_rounds))
    ]
    timed("decode", lambda: constrained.decode_constrained(
        rounds, host.rounds.unschedulable[:num_sub], compiled, int(host.chosen_level), fleet))
    g_pad, t_pad, l_pad = operands[0].shape[0], operands[2].shape[0], operands[1].shape[0]
    print(f"  constrained sizes: G'={num_sub} padded {g_pad}, T={fleet.num_types} padded {t_pad}, "
          f"L={num_levels} padded {l_pad}, mirror modes {','.join(mirror_modes)}")
    if num_pods == NUM_PODS:
        # 16 shapes x 4 spread domains (the three zones and the missing
        # zone the preference names), 400 types, 3 ladder levels.
        check((num_sub, g_pad, t_pad, l_pad) == (64, 64, 512, 4),
              f"the constrained sizes are G'={num_sub}/{g_pad}, T={t_pad}, L={l_pad}")

    # K6 at this size against its plain version in both modes, and the
    # mirror on the unpadded operands.
    k6_err = 0.0
    packs = {}
    for mode in ("ffd", "cost"):
        got = pack_kernel.pack_kernel_levels(*operands, mode=mode)
        want = plain_levels(operands, mode)
        synchronize(device)
        check(level_packs_equal(got, want), f"K6 {mode} differs from its plain version on the constrained path")
        k6_err = max(k6_err, level_pack_abs_err(got, want))
        packs[mode] = got
    for mode in mirror_modes:
        mirror = pack_levels_host(
            compiled.vectors, compiled.level_counts, fleet.capacity, np.ones(fleet.num_types, bool),
            fleet.prices, compiled.allow, compiled.penalty, compiled.conflict, compiled.node_cap,
            mode=mode)
        check(mirror_agrees(mirror, packs[mode], num_sub, num_levels),
              f"K6 {mode} differs from the numpy mirror on the constrained path")
    phase(
        "constrained", pods=len(pods), schedules=len(schedules), chosen_level=decision.chosen_level,
        description=repr(decision.description), nodes=result.node_count,
        unschedulable=len(result.unschedulable),
        per_zone=json.dumps(per_zone, sort_keys=True, separators=(",", ":")), skew=skew,
        cost_per_hr=f"{card_cost:.6f}", cpu_cost_per_hr=f"{cpu_cost:.6f}", cost_rel_diff=f"{cost_rel:.3e}",
        shape=f"G={g_pad},T={t_pad},L={l_pad}", k6_launches_per_solve=launches, k6_max_abs_err=k6_err,
        first_solve_ms=f"{first_ms:.3f}", p50_ms=f"{np.percentile(warm_ms, 50):.3f}",
        max_ms=f"{max(warm_ms):.3f}", **{f"{name}_ms": f"{ms:.3f}" for name, ms in layers.items()},
    )
    return {"operands": operands, "launches": launches, "max_abs_err": k6_err, "packs": packs}


def large_shapes_phase(catalog, device, num_pods: int = 12_000, num_shapes: int = 1_100) -> dict:
    """CostSolver on `device` over a schedule of many distinct shapes (padded
    G 2,048 at the defaults): every pod placed once; K2's ffd rounds equal
    the plain version's on the CPU (the cost rounds' check at this size is
    the sparse G 2,048 case of the launch-plan checks: the plain version
    takes minutes over 1,182 rounds of 1,100 groups), K3's objective within
    the LP tolerance of its plain version on the card. Returns the padded
    main-path operands."""
    import torch

    from karpenter_tpu_torch.api.provisioner import Constraints
    from karpenter_tpu_torch.convert import fused_args_from_numpy
    from karpenter_tpu_torch.models import solver
    from karpenter_tpu_torch.ops import cuda_kernels, pack_kernel, score_kernel
    from karpenter_tpu_torch.ops.encode import build_fleet, group_pods

    pods = many_shapes_pods(num_pods, num_shapes)
    start = time.perf_counter()
    result = solver.CostSolver(device=device).solve(pods, catalog, Constraints())
    solve_ms = (time.perf_counter() - start) * 1e3
    check(all_pods_placed_once(result, pods), "the many-shapes solve did not place every pod exactly once")
    groups = group_pods(pods)
    fleet = build_fleet(catalog, Constraints(), pods, pods_need=groups.vectors.max(axis=0))
    args = (groups.vectors, groups.counts, fleet.capacity, fleet.total, fleet.prices)
    card = solver.fetch_plan(solver.cost_solve_dispatch(*args, device=device))
    padded = solver.pad_kernel_args(*args)
    vectors, counts, capacity, total, valid, prices = fused_args_from_numpy(*padded, device=device)
    got = pack_kernel.pack_kernel(vectors, counts, capacity, total, valid, prices, mode="ffd")
    plain = pack_kernel._pack_kernel_ref(*fused_args_from_numpy(*padded, device="cpu"), mode="ffd")
    check(rounds_equal(tuple(x.cpu() for x in got), plain),
          "K2's ffd rounds differ from the plain version on the many-shapes schedule")
    effective = cuda_kernels._dominance_prices_ref(capacity, torch.where(valid, prices, torch.inf))
    solvable = torch.where(score_kernel.feasibility_mask(vectors, capacity, valid).any(dim=1), counts, 0)
    lp_args = (vectors, solvable, capacity, valid, effective)
    got = score_kernel.lp_relax(*lp_args, steps=300)
    want = score_kernel.lp_relax_body(*lp_args, steps=300)
    synchronize(device)
    lp_rel = abs(float(got.objective) - float(want.objective)) / abs(float(want.objective))
    check(lp_rel <= LP_OBJECTIVE_RTOL, f"K3 objective differs on the many-shapes schedule: {lp_rel:.3e}")
    k2_plan = pack_kernel.pack_launch_plan(vectors.shape[0], capacity.shape[0], vectors.shape[1])
    k3_plan = score_kernel.lp_launch_plan(vectors.shape[0], capacity.shape[0], vectors.shape[1])
    phase(
        "large_shapes", pods=len(pods), shapes=groups.num_groups,
        shape=f"G={vectors.shape[0]},T={capacity.shape[0]}", nodes=result.node_count,
        cost_per_hr=f"{result.projected_cost():.6f}", solve_ms=f"{solve_ms:.3f}",
        rounds_ffd=int(card.rounds_ffd.num_rounds), rounds_cost=int(card.rounds_cost.num_rounds),
        k3_objective_rel_err=f"{lp_rel:.3e}", k2_plan=f"{k2_plan}".replace(" ", ""),
        k3_plan=f"{k3_plan}".replace(" ", ""),
    )
    return {"args": (vectors, counts, capacity, total, valid, effective), "lp": lp_args}


# --- the sharded solve (K9a, K9b) on meshes of the card --------------------------

SHARD_MESHES = (4, 8)  # 2x2 and 2x4 virtual meshes of the one card
SHRUNK_PROBE = "".join(f"print('CHIP_OK {i}', flush=True)\n" for i in range(7))


def constrained_operands(catalog, num_pods: int = NUM_PODS):
    """The constrained cell's padded [L, G', T] operands as numpy
    (constraints.solve.pad_levels), built as constrained_phase builds them."""
    from karpenter_tpu_torch.api.provisioner import Provisioner, ProvisionerSpec
    from karpenter_tpu_torch.constraints import compiler
    from karpenter_tpu_torch.constraints import solve as constrained
    from karpenter_tpu_torch.controllers.cluster import Cluster
    from karpenter_tpu_torch.controllers.scheduling import Scheduler
    from karpenter_tpu_torch.ops.encode import build_fleet, group_pods

    pods = constrained_pods(num_pods)
    cluster = Cluster()
    (schedule,) = Scheduler(cluster).solve(Provisioner(name="default", spec=ProvisionerSpec()), pods)
    groups = group_pods(list(schedule.pods))
    fleet = build_fleet(catalog, schedule.constraints, schedule.pods, [], pods_need=groups.vectors.max(axis=0))
    compiled = compiler.compile_constraints(schedule, groups, fleet, cluster, cache=compiler.CompilerCache())
    return constrained.pad_levels(compiled, fleet)


def mesh_lp_problem(padded, mesh, device):
    """The sharded LP of one fused solve over `mesh`, as
    models/solver._sharded_fused_solve lays it out from its padded inputs:
    (the ShardedProblem, the (vectors, solvable counts, capacity, valid,
    effective prices) it came from)."""
    import torch

    from karpenter_tpu_torch.convert import fused_args_from_numpy
    from karpenter_tpu_torch.ops import cuda_kernels, score_kernel
    from karpenter_tpu_torch.parallel import sharded_solver

    vectors, counts, capacity, total, valid, prices = fused_args_from_numpy(*padded, device=device)
    effective = cuda_kernels._dominance_prices_ref(capacity, torch.where(valid, prices, torch.inf))
    solvable = torch.where(score_kernel.feasibility_mask(vectors, capacity, valid).any(dim=1), counts, 0)
    lp_args = (vectors, solvable, capacity, valid, effective)
    return sharded_solver.shard_lp_problem(mesh, {torch.device(device): lp_args}), lp_args


def k9a_against_plain(mesh, problem, steps: int = 300):
    """K9a's sharded LP and the same through its plain versions on the card:
    (objective relative difference, assignment max abs difference, kernel
    result, plain result). On a mesh of one card the LP is one launch of
    the persistent kernel, and a second launch must give the same bits."""
    import torch

    from karpenter_tpu_torch.ops import lp_shard_kernel
    from karpenter_tpu_torch.parallel import collectives, sharded_solver

    before = lp_shard_kernel.launches()
    got = sharded_solver.sharded_lp_blocks(mesh, problem, steps)
    if len(mesh.devices) == 1:
        check(lp_shard_kernel.launches() - before == 1,
              f"the LP over {mesh.size} shards of one card took {lp_shard_kernel.launches() - before} K9a launches")
        again = sharded_solver.sharded_lp_blocks(mesh, problem, steps)
        synchronize(mesh.flat[0].device)
        check(torch.equal(collectives.assemble(mesh, got.assignment), collectives.assemble(mesh, again.assignment))
              and torch.equal(got.objective, again.objective),
              f"two launches of K9a differ over {mesh.size} shards")
    with plain_k9a():
        want = sharded_solver.sharded_lp_blocks(mesh, problem, steps)
    synchronize(mesh.flat[0].device)
    obj = abs(float(got.objective) - float(want.objective)) / abs(float(want.objective))
    err = float((collectives.assemble(mesh, got.assignment) - collectives.assemble(mesh, want.assignment)).abs().max())
    return obj, err, got, want


def k9a_per_phase_against_plain(mesh, problem, want, counts, steps: int = 300):
    """K9a's per-phase route forced on `mesh` (one card), launched by its
    three phase kernels, against `want`, the plain versions' LP on the same
    problem: (objective relative difference, pods relative gap). Checks
    shards * (3 * steps + 3) phase launches and no persistent one."""
    from karpenter_tpu_torch.ops import lp_shard_kernel
    from karpenter_tpu_torch.parallel import sharded_solver

    lp_shard_kernel.reset_launches()
    with per_phase_k9a():
        got = sharded_solver.sharded_lp_blocks(mesh, problem, steps)
    synchronize(mesh.flat[0].device)
    launched = lp_shard_kernel.launches()
    check(lp_shard_kernel.shard_lp.launches == 0 and launched == mesh.size * (3 * steps + 3),
          f"K9a's per-phase route over {mesh.size} shards launched {launched}, "
          f"not {mesh.size * (3 * steps + 3)}")
    obj = abs(float(got.objective) - float(want.objective)) / abs(float(want.objective))
    return obj, lp_pods_rel(mesh, got, counts)


def k9a_phase_kernels(shards: int, steps: int = 300) -> dict:
    """The per-phase route's launches of each phase kernel an LP over
    `shards` shards: two softmaxes to start, three phases a step, the final
    demand."""
    return {"lp_shard_softmax_kernel": shards * (steps + 2), "lp_shard_demand_kernel": shards * (steps + 1),
            "lp_shard_row_dot_kernel": shards * steps}


def lp_pods_rel(mesh, lp, counts) -> float:
    """How far a sharded LP's assignment is from conserving the pods: the
    relative gap of its sum to the solvable pods."""
    from karpenter_tpu_torch.parallel import collectives

    total = float(counts.sum())
    return abs(float(collectives.assemble(mesh, lp.assignment).double().sum()) - total) / max(total, 1.0)


def k9b_cases(device):
    """(label, rounds_ffd, rounds_cost, feasible) K9b is held to its plain
    version and to the host decode on: sparse plans inside every shard's
    entry budget at G 16 and 64, and a dense one past it."""
    import torch

    rng = np.random.default_rng(12)
    for num_groups, density in ((16, 0.05), (64, 0.02), (16, 0.9)):
        ffd, cost = (dense_rounds(num_groups, seed, density, device) for seed in (3, 4))
        feasible = torch.from_numpy(rng.random(num_groups) < 0.8).to(device)
        yield f"G{num_groups}-d{density}", ffd, cost, feasible


def k9b_check(mesh, device) -> dict:
    """K9b over `mesh` (one card) on every case of k9b_cases: one launch
    for the whole payload, word for word equal to its plain version and to
    the per-card route forced on the card (the shards in runs of three, a
    launch each), decoded to the dense fills where every shard fits its
    budget, flagged for the dense spill where one does not."""
    import torch

    from karpenter_tpu_torch.ops import pack_kernel

    cases = overflowed = 0
    runs = -(-mesh.size // 3)
    for label, ffd, cost, feasible in k9b_cases(device):
        before = pack_kernel.compact_shard.launches
        got = pack_kernel.compact_plan_sharded(ffd, cost, feasible, mesh=mesh)
        check(pack_kernel.compact_shard.launches - before == 1,
              f"K9b took {pack_kernel.compact_shard.launches - before} launches over {mesh.size} shards of one card")
        per_card = pack_kernel.compact_plan_sharded(ffd, cost, feasible, mesh=mesh, per_card=3)
        check(pack_kernel.compact_shard.launches - before == 1 + runs,
              f"K9b's per-card route took {pack_kernel.compact_shard.launches - before - 1} launches, not {runs}")
        with plain_k9b():
            want = pack_kernel.compact_plan_sharded(ffd, cost, feasible, mesh=mesh)
        synchronize(device)
        check(torch.equal(got, want), f"K9b differs from its plain version on {label} over {mesh.size} shards")
        check(torch.equal(per_card, got),
              f"K9b's per-card route differs from its one-launch route on {label} over {mesh.size} shards")
        num_groups = feasible.shape[0]
        words = got.cpu().numpy()
        dec_ffd, dec_cost, dec_feasible, ok = pack_kernel.decompact_plan_sharded(words, num_groups, mesh.size)
        width = num_groups // mesh.size
        budget = pack_kernel.shard_entry_budget(num_groups, mesh.size)
        fits = all(int((r.round_fill[:, k * width : (k + 1) * width] != 0).sum()) <= budget
                   for r in (ffd, cost) for k in range(mesh.size))
        check(ok is fits, f"K9b's overflow flag is wrong on {label} over {mesh.size} shards")
        if ok:
            for decoded, original in ((dec_ffd, ffd), (dec_cost, cost)):
                for field in pack_kernel.PackRounds._fields:
                    check(np.array_equal(np.asarray(getattr(decoded, field)),
                                         getattr(original, field).cpu().numpy()),
                          f"the host decode of K9b's words differs on {label}: {field}")
            check(np.array_equal(dec_feasible, feasible.cpu().numpy()), f"feasible_any differs on {label}")
        overflowed += not ok
        cases += 1
    check(overflowed >= 1, "no K9b case overflowed its budget")
    return {"cases": cases, "overflowed": overflowed}


def sharded_device_ms(sharded, lp_steps: int = 300) -> None:
    """K9a's and K9b's own device time (torch.profiler) per sharded LP and
    per sharded compaction on each mesh of the sharded phase, into its
    result ("k9a_ms", "k9b_ms"): on a mesh of one card K9a is one launch of
    its persistent kernel an LP. Run after the other kernels' timings."""
    for entry in sharded["meshes"].values():
        shards = entry["shards"]
        entry["k9a_ms"] = device_ms_per_call(entry["k9a_call"], {"lp_shard_persistent_kernel": 1}, reps=10)
        entry["k9a_plan"] = lp_plan_of(entry["k9a_lp"], entry["mesh_shape"])
        entry["k9b_ms"] = device_ms_per_call(entry["k9b_call"], {"compact_sharded_kernel": 1}, reps=200)
        print(f"  K9a over {shards} shards: {entry['k9a_ms']:.4f} ms device a solve, "
              f"{entry['k9a_ms'] * 1e3 / lp_steps:.3f} us a step ({entry['k9a_plan'].blocks} blocks); "
              f"K9b {entry['k9b_ms']:.5f} ms a compaction")
    big = sharded["g2048"]
    big["k9a_ms"] = device_ms_per_call(big["k9a_call"], {"lp_shard_persistent_kernel": 1}, reps=3)
    print(f"  K9a at {big['shape']} over 8 shards: {big['k9a_ms']:.4f} ms device a solve "
          f"({big['blocks']} blocks)")
    # The per-phase route (the route across cards) forced on the 2x4 mesh.
    per_phase = sharded["per_phase"]
    per_phase["ms"] = device_ms_per_call(per_phase["call"], k9a_phase_kernels(8, lp_steps), reps=3)
    big["per_phase_ms"] = device_ms_per_call(big["per_phase_call"], k9a_phase_kernels(8, lp_steps), reps=1)
    print(f"  K9a's per-phase route over 8 shards: {per_phase['ms']:.4f} ms device a solve "
          f"({per_phase['launches']} launches); at {big['shape']}: {big['per_phase_ms']:.4f} ms")


def lp_plan_of(lp_shape, mesh_shape):
    """K9a's persistent plan for an LP of (G, T, R) over a mesh shape, on
    this card (its SM count), as `shard_lp` computes it."""
    import torch

    from karpenter_tpu_torch.ops import lp_shard_kernel

    groups, types, dims = lp_shape
    return lp_shard_kernel.lp_shard_launch_plan(
        mesh_shape[0] * mesh_shape[1], groups // mesh_shape[0], types // mesh_shape[1], dims,
        torch.cuda.get_device_properties(0).multi_processor_count)


def per_phase_lp(call):
    """`call` (a sharded LP) through K9a's per-phase kernels."""
    with per_phase_k9a():
        return call()


def plans_agree_on_real_groups(a, b, num_groups: int) -> bool:
    """Two FetchedPlans of one problem padded to other sizes (the 1x7 mesh
    pads G and T to multiples of 7): their rounds and feasibility over the
    real groups bit for bit, and no round filling a padding group. Padding
    groups hold no pods and padding types are invalid, so a round never
    takes them."""
    for name in ("rounds_ffd", "rounds_cost"):
        x, y = getattr(a, name), getattr(b, name)
        rounds = int(x.num_rounds)
        if rounds != int(y.num_rounds) or int(x.overflow) != int(y.overflow):
            return False
        fills = [np.asarray(r.round_fill)[:rounds] for r in (x, y)]
        if any(np.asarray(f[:, num_groups:]).any() for f in fills):
            return False
        if not (np.array_equal(np.asarray(x.round_type)[:rounds], np.asarray(y.round_type)[:rounds])
                and np.array_equal(np.asarray(x.round_repl)[:rounds], np.asarray(y.round_repl)[:rounds])
                and np.array_equal(fills[0][:, :num_groups], fills[1][:, :num_groups])
                and np.array_equal(np.asarray(x.unschedulable)[:num_groups],
                                   np.asarray(y.unschedulable)[:num_groups])):
            return False
    return np.array_equal(np.asarray(a.feasible_any)[:num_groups], np.asarray(b.feasible_any)[:num_groups])


def plans_equal(a, b) -> bool:
    """Two FetchedPlans' decoded candidates and feasibility, bit for bit."""
    return all(
        np.array_equal(np.asarray(x), np.asarray(y))
        for name in ("rounds_ffd", "rounds_cost")
        for x, y in zip(getattr(a, name), getattr(b, name))
    ) and np.array_equal(a.feasible_any, b.feasible_any)


def sharded_phase(device, pods, catalog, groups, fleet, levels_operands, large_lp) -> dict:
    """The sharded solve (the reference's single-host mesh path,
    karpenter_tpu/models/solver.py:500-640) on 2x2 and 2x4 virtual meshes of
    the card, following __graft_entry__.dryrun_multichip: CostSolver on the
    main path's 50,000 pods x 400 types through the mesh (K1 and the K2 pair
    once, K9a over every shard, K9b once, no K3 or K4), its decoded
    candidates and feasibility bit-identical to the single-device solve's,
    $/hr within 1.02x and 5% of it, warm p50 and max; K9a against its plain
    version (the main path, non-degenerate LPs, padded G 2,048 x T 512),
    K9b against its plain version and the host decode; the constrained
    cell's levels over the 8-shard mesh equal to the single-device
    dispatch; the shrink leg (a wedged shard, the 1x7 mesh, an injected
    dispatch failure quarantined by a probe and retried once). Returns the
    numbers the kernels line reports."""
    import torch

    from karpenter_tpu_torch.convert import fused_args_from_numpy, upload_packed
    from karpenter_tpu_torch.models import solver
    from karpenter_tpu_torch.ops import cuda_kernels, lp_shard_kernel, pack_kernel, score_kernel
    from karpenter_tpu_torch.parallel import mesh as mesh_mod
    from karpenter_tpu_torch.parallel.sharded_solver import (
        constrained_level_sharding,
        shard_lp_problem,
        sharded_lp_blocks,
    )
    from karpenter_tpu_torch.utils import backend_health

    device = torch.device(device)
    cards = torch.cuda.device_count()
    real_mesh = solver.solve_mesh(device)
    print(f"  solve_mesh() on this machine: {real_mesh}; torch.cuda.device_count() = {cards}")
    check(cards > 1 or real_mesh is None, "one card, yet solve_mesh() selected a mesh")
    lp_steps = 300
    cost_solver = solver.CostSolver(device=device)
    args = (groups.vectors, groups.counts, fleet.capacity, fleet.total, fleet.prices)
    single_plan = solver.fetch_plan(solver.cost_solve_dispatch(*args, device=device))
    single = cost_solver.solve_encoded(groups, fleet)
    single_cost = single.projected_cost()

    def warm_ms():
        samples = []
        for _ in range(10):
            start = time.perf_counter()
            cost_solver.solve_encoded(groups, fleet)
            samples.append((time.perf_counter() - start) * 1e3)
        return samples

    single_ms = warm_ms()
    out = {"meshes": {}}
    fields = {"single_p50_ms": f"{np.percentile(single_ms, 50):.3f}"}
    for shards in SHARD_MESHES:
        with mesh_mod.virtual_devices(device, shards):
            mesh = solver.solve_mesh(device)
            check(mesh is not None and mesh.size == shards and mesh.shape == mesh_mod._factor(shards),
                  f"solve_mesh() over {shards} virtual shards is {mesh}")
            label = f"{mesh.shape[0]}x{mesh.shape[1]}"
            counters = (cuda_kernels.dominance_prices, pack_kernel.pack_kernel, score_kernel.lp_relax,
                        pack_kernel.pack_pair_payload, pack_kernel.compact_shard)
            for counter in counters:
                counter.launches = 0
            lp_shard_kernel.reset_launches()
            result = cost_solver.solve_encoded(groups, fleet)
            launches = {
                "dominance_prices": cuda_kernels.dominance_prices.launches,
                "pack_kernel": pack_kernel.pack_kernel.launches,
                "lp_relax": score_kernel.lp_relax.launches,
                "pack_pair_payload": pack_kernel.pack_pair_payload.launches,
                "lp_shard": lp_shard_kernel.launches(),
                "compact_shard": pack_kernel.compact_shard.launches,
            }
            # One card: the K2 pair with its epilogue (no payload), the
            # whole LP one launch of K9a's persistent kernel, the whole
            # payload one launch of K9b.
            want = {"dominance_prices": 1, "pack_kernel": 1, "lp_relax": 0, "pack_pair_payload": 1,
                    "lp_shard": 1, "compact_shard": 1}
            check(launches == want, f"the {label} solve launched {launches}, not {want}")
            check(all_pods_placed_once(result, pods), f"the {label} solve did not place every pod once")
            cost = result.projected_cost()
            check(cost <= 1.02 * single_cost + 1e-6 and abs(cost - single_cost) / single_cost <= 0.05,
                  f"the {label} solve's $/hr {cost} against the single-device {single_cost}")
            handle = solver.cost_solve_dispatch(*args, device=device)
            plan = solver.fetch_plan(handle)
            check(handle.shards == shards, f"the {label} dispatch reports {handle.shards} shards")
            check(plans_equal(plan, single_plan),
                  f"the {label} solve's decoded candidates differ from the single-device solve's")
            sharded_ms = warm_ms()
            padded = solver.pad_kernel_args(*args, g_mult=mesh.size, t_mult=mesh.shape[1])
            problem, main_lp = mesh_lp_problem(padded, mesh, device)
            main_obj, _, main_result, main_plain = k9a_against_plain(mesh, problem, lp_steps)
            main_pods = lp_pods_rel(mesh, main_result, main_lp[1])
            check(main_obj <= LP_OBJECTIVE_RTOL and main_pods <= LP_PODS_RTOL,
                  f"K9a differs on the main path over {label}: objective {main_obj:.3e}, pods {main_pods:.3e}")
            errs = []
            for seed in LP_SEEDS[:2]:
                lp_args = lp_inputs(seed, (16, 512), device)
                obj, err, _, _ = k9a_against_plain(mesh, shard_lp_problem(mesh, {device: lp_args}), lp_steps)
                check(obj <= LP_OBJECTIVE_RTOL and err <= LP_ASSIGNMENT_ATOL,
                      f"K9a differs from its plain version on seed {seed} over {label}: "
                      f"objective {obj:.3e}, assignment {err:.3e}")
                errs.append(err)
            phases = 0
            for name, kernel_args, plain_args, plain_name in k9a_phase_cases(shards, device):
                got = getattr(lp_shard_kernel, name)(*kernel_args)
                want_phase = getattr(lp_shard_kernel, plain_name)(*plain_args)
                synchronize(device)
                check(phase_close(got, want_phase, kernel_args, plain_args),
                      f"K9a's {name} differs from its plain version over {label}")
                phases += 1
            k9b = k9b_check(mesh, device)
            # Timing: CUDA events around the sharded LP and the sharded
            # compaction here; their kernels' own device time (torch.profiler)
            # in the timing phase, after the other kernels' (sharded_device_ms).
            k9a_call = functools.partial(sharded_lp_blocks, mesh, problem, lp_steps)
            k9a_event_ms = time_cuda(k9a_call, reps=3, warmup=1)
            with plain_k9a():
                k9a_plain_ms = time_cuda(k9a_call, reps=3, warmup=1)
            main_args = fused_args_from_numpy(*padded, device=device)
            main_pair = pack_kernel.pack_pair_payload(*main_args[:5], main_lp[4], payload=False)
            k9b_call = functools.partial(pack_kernel.compact_plan_sharded, main_pair.rounds_ffd,
                                         main_pair.rounds_cost, main_pair.feasible_any, mesh=mesh)
            k9b_event_ms = time_cuda(k9b_call, reps=50)
            k9b_per_card_event_ms = time_cuda(functools.partial(k9b_call, per_card=3), reps=50)
            with plain_k9b():
                k9b_plain_ms = time_cuda(k9b_call, reps=20)
            out["meshes"][label] = {
                "shards": shards, "launches": launches, "k9a_event_ms": k9a_event_ms,
                "k9a_plain_ms": k9a_plain_ms, "k9a_err": max(errs),
                "k9b_event_ms": k9b_event_ms, "k9b_plain_ms": k9b_plain_ms, "k9b": k9b,
                "k9b_per_card_event_ms": k9b_per_card_event_ms,
                "k9a_call": k9a_call, "k9b_call": k9b_call, "mesh_shape": mesh.shape,
                "k9a_lp": (main_lp[0].shape[0], main_lp[2].shape[0], main_lp[0].shape[1]),
                "p50_ms": float(np.percentile(sharded_ms, 50)), "max_ms": max(sharded_ms),
            }
            fields.update({
                f"m{label}_k9a_main_pods_rel": f"{main_pods:.3e}",
                f"m{label}_p50_ms": f"{np.percentile(sharded_ms, 50):.3f}",
                f"m{label}_max_ms": f"{max(sharded_ms):.3f}",
                f"m{label}_cost_per_hr": f"{cost:.6f}",
                f"m{label}_k9a_event_ms": f"{k9a_event_ms:.4f}",
                f"m{label}_k9b_event_ms": f"{k9b_event_ms:.4f}",
                f"m{label}_k9b_per_card_event_ms": f"{k9b_per_card_event_ms:.4f}",
                f"m{label}_k9a_main_obj_rel": f"{main_obj:.3e}", f"m{label}_k9a_phases": phases,
            })
            if shards == 8:
                # K9a's per-phase route, the route of a mesh across cards,
                # forced on this one-card mesh: three kernels a shard a step
                # and the collectives between, against the plain versions.
                phase_obj, phase_pods = k9a_per_phase_against_plain(mesh, problem, main_plain, main_lp[1],
                                                                    lp_steps)
                check(phase_obj <= LP_OBJECTIVE_RTOL and phase_pods <= LP_PODS_RTOL,
                      f"K9a's per-phase route differs on the main path over {label}: "
                      f"objective {phase_obj:.3e}, pods {phase_pods:.3e}")
                phase_call = functools.partial(per_phase_lp, k9a_call)
                out["per_phase"] = {"launches": shards * (3 * lp_steps + 3), "call": phase_call,
                                    "event_ms": time_cuda(phase_call, reps=3, warmup=1),
                                    "objective_rel": phase_obj, "pods_rel": phase_pods}
                fields.update(k9a_per_phase_launches=shards * (3 * lp_steps + 3),
                              k9a_per_phase_obj_rel=f"{phase_obj:.3e}", k9a_per_phase_pods_rel=f"{phase_pods:.3e}",
                              k9a_per_phase_event_ms=f"{out['per_phase']['event_ms']:.4f}")
                # The many-shapes width on the 2x4 mesh, beside K3 there.
                vectors, _, capacity, _, _ = large_lp
                check(vectors.shape[0] % mesh.shape[0] == 0 and capacity.shape[0] % mesh.shape[1] == 0,
                      "the many-shapes LP does not split over the 2x4 mesh")
                big = shard_lp_problem(mesh, {device: large_lp})
                big_obj, _, big_lp, big_plain = k9a_against_plain(mesh, big, lp_steps)
                big_pods = lp_pods_rel(mesh, big_lp, large_lp[1])
                check(big_obj <= LP_OBJECTIVE_RTOL and big_pods <= LP_PODS_RTOL,
                      f"K9a differs at G 2,048 x T 512: objective {big_obj:.3e}, pods {big_pods:.3e}")
                big_call = functools.partial(sharded_lp_blocks, mesh, big, lp_steps)
                big_ms = time_cuda(big_call, reps=3, warmup=1)
                big_plan = lp_plan_of((vectors.shape[0], capacity.shape[0], vectors.shape[1]), mesh.shape)
                big_phase_obj, big_phase_pods = k9a_per_phase_against_plain(mesh, big, big_plain, large_lp[1],
                                                                            lp_steps)
                check(big_phase_obj <= LP_OBJECTIVE_RTOL and big_phase_pods <= LP_PODS_RTOL,
                      f"K9a's per-phase route differs at G 2,048 x T 512: objective {big_phase_obj:.3e}, "
                      f"pods {big_phase_pods:.3e}")
                big_phase_call = functools.partial(per_phase_lp, big_call)
                big_phase_ms = time_cuda(big_phase_call, reps=2, warmup=1)
                out["g2048"] = {"k9a_event_ms": big_ms, "objective_rel": big_obj, "pods_rel": big_pods,
                                "shape": f"G={vectors.shape[0]},T={capacity.shape[0]}",
                                "blocks": big_plan.blocks, "k9a_call": big_call,
                                "per_phase_event_ms": big_phase_ms, "per_phase_call": big_phase_call,
                                "lp": (vectors.shape[0], capacity.shape[0], vectors.shape[1])}
                fields.update(k9a_g2048_ms=f"{big_ms:.3f}", k9a_g2048_obj_rel=f"{big_obj:.3e}",
                              k9a_g2048_pods_rel=f"{big_pods:.3e}", k9a_g2048_blocks=big_plan.blocks,
                              k9a_g2048_per_phase_ms=f"{big_phase_ms:.3f}",
                              k9a_g2048_per_phase_obj_rel=f"{big_phase_obj:.3e}",
                              k9a_g2048_per_phase_pods_rel=f"{big_phase_pods:.3e}")
                # The constrained cell's levels over the 8 shards.
                dispatch, level_shards = constrained_level_sharding(mesh)
                pack_kernel.pack_kernel_levels.launches = 0
                levels_np = [a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
                             for a in levels_operands]
                sharded_levels = dispatch(levels_np, "cost")
                check(pack_kernel.pack_kernel_levels.launches == shards,
                      f"the level-sharded dispatch launched K6 {pack_kernel.pack_kernel_levels.launches} times")
                single_levels = pack_kernel.level_pack_to_host(pack_kernel.pack_kernel_levels(
                    *upload_packed(levels_np, device), mode="cost"))
                check(int(sharded_levels.chosen_level) == int(single_levels.chosen_level)
                      and np.array_equal(sharded_levels.group_level, single_levels.group_level)
                      and np.array_equal(sharded_levels.level_unsched, single_levels.level_unsched)
                      and all(np.array_equal(np.asarray(a), np.asarray(b))
                              for a, b in zip(sharded_levels.rounds, single_levels.rounds)),
                      "the constrained cell's levels over 8 shards differ from the single-device dispatch")
                fields.update(levels_shards=level_shards, levels_chosen=int(sharded_levels.chosen_level))
    # The shrink leg: a wedged shard, then an injected dispatch failure.
    with mesh_mod.virtual_devices(device, 8):
        backend_health.clear_wedged_chips()
        backend_health.report_chip_wedged(7, "chip_smoke: wedged")
        shrunk = solver.solve_mesh(device)
        check(shrunk.size == 7 and shrunk.shape == (1, 7) and 7 not in shrunk.ids(),
              f"the mesh did not shrink to 1x7: {shrunk}")
        lp_shard_kernel.reset_launches()
        pack_kernel.compact_shard.launches = 0
        handle = solver.cost_solve_dispatch(*args, device=device)
        plan = solver.fetch_plan(handle)
        check(lp_shard_kernel.launches() == 1 and pack_kernel.compact_shard.launches == 1,
              f"the solve on the shrunk mesh took {lp_shard_kernel.launches()} K9a launches and "
              f"{pack_kernel.compact_shard.launches} K9b launches")
        check(plans_agree_on_real_groups(plan, single_plan, groups.num_groups),
              "the 1x7 solve's decoded candidates differ from the single-device solve's")
        shrunk_obj, shrunk_err, _, _ = k9a_against_plain(
            shrunk, mesh_lp_problem(solver.pad_kernel_args(*args, g_mult=7, t_mult=7), shrunk, device)[0],
            lp_steps)
        check(shrunk_obj <= LP_OBJECTIVE_RTOL,
              f"K9a's objective differs from its plain version on the 1x7 mesh: {shrunk_obj:.3e}")
        assignment = plan.lp_assignment()
        solvable = np.where(plan.feasible_any[: groups.num_groups], groups.counts, 0).sum()
        check(handle.shards == 7 and handle.num_types % 7 == 0 and handle.num_groups % 7 == 0,
              f"the shrunk dispatch is {handle.shards} shards at G {handle.num_groups}, T {handle.num_types}")
        check(np.isfinite(plan.lp_objective) and np.isfinite(assignment).all()
              and abs(assignment.sum() - solvable) <= 1e-3 * solvable,
              "the LP on the shrunk mesh is not finite or does not conserve the pods")
        result = cost_solver.solve_encoded(groups, fleet)
        check(all_pods_placed_once(result, pods), "the solve on the shrunk mesh lost pods")
        shrunk_cost = result.projected_cost()
        backend_health.clear_wedged_chips()
        real = solver._sharded_fused_solve
        attempts = []

        def failing_once(padded, mesh, steps, on):
            attempts.append(mesh.size)
            if len(attempts) == 1:
                raise RuntimeError("chip_smoke: injected dispatch failure")
            return real(padded, mesh, steps, on)

        solver._sharded_fused_solve = failing_once
        os.environ["KARPENTER_CHIP_PROBE_CODE"] = SHRUNK_PROBE
        try:
            result = cost_solver.solve_encoded(groups, fleet)
        finally:
            solver._sharded_fused_solve = real
            os.environ.pop("KARPENTER_CHIP_PROBE_CODE", None)
        wedged = sorted(backend_health.wedged_chips())
        backend_health.clear_wedged_chips()
        check(attempts == [8, 7] and wedged == [7],
              f"the injected failure did not quarantine and retry once: attempts {attempts}, wedged {wedged}")
        check(all_pods_placed_once(result, pods), "the retried solve lost pods")
    fields.update(shrunk="1x7", shrunk_plans="bit-identical on the real groups",
                  shrunk_cost_per_hr=f"{shrunk_cost:.6f}", retry_attempts=json.dumps(attempts),
                  shrunk_k9a_obj_rel=f"{shrunk_obj:.3e}")
    if cards > 1:
        # Distinct cards: the real mesh, transport included.
        real_mesh = solver.solve_mesh(device)
        handle = solver.cost_solve_dispatch(*args, device=device)
        check(handle.shards == real_mesh.size and plans_equal(solver.fetch_plan(handle), single_plan),
              f"the solve over {cards} cards differs from the single-device solve")
        fields.update(cards_mesh=f"{real_mesh.shape[0]}x{real_mesh.shape[1]}")
    phase("sharded", pods=len(pods), types=len(catalog), single_cost_per_hr=f"{single_cost:.6f}",
          cards=cards, solve_mesh=repr(real_mesh), plans="bit-identical", **fields)
    return out


# --- the multi-process sharded solve ------------------------------------------

# Two processes share the one card over gloo (NCCL puts one rank on a card),
# two shards each: the 2x2 mesh of the sharded phase, a row a process.
MULTIPROCESS_RANKS = 2
MULTIPROCESS_SHARDS = 2
MULTIPROCESS_SOLVES = 5  # timed solves, after one warm solve; then one profiled
MULTIPROCESS_TIMEOUT_S = 420.0


def device_ms_by_kernel(prof) -> dict:
    """{kernel: [records, device ms]} of a torch.profiler session (copies
    and fills under their own names)."""
    import re

    import torch

    out = {}
    for event in prof.key_averages():
        if event.device_type != torch.autograd.DeviceType.CUDA or event.self_device_time_total <= 0:
            continue
        match = re.search(r"(\w+_kernel)", event.key)
        name = match.group(1) if match else event.key[:40]
        entry = out.setdefault(name, [0, 0.0])
        entry[0] += event.count
        entry[1] += event.self_device_time_total / 1e3
    return out


def multiprocess_rank(rank: int, port: int, out_dir: str) -> None:
    """`chip_smoke.py --phase multiprocess-rank RANK PORT DIR`: one process
    of the 2-process group on the card. Rank 0 leads the production solve
    (CostSolver.solve_encoded on the main path's 50,000 pods x 400 types,
    over the global 2x2 mesh: parallel/spmd.lead_dispatch), rank 1 follows
    it (parallel/spmd.follower_step): one warm solve, MULTIPROCESS_SOLVES
    timed, one under torch.profiler, then rank 0's decoded dispatch and
    lead_stop. Each rank checks its own launches a solve (K1 and the K2 pair
    once, K9a's per-phase kernels on its two shards, K9b once, no K3) and
    writes its numbers (rank 0 also its plan) to DIR."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from karpenter_tpu_torch.api import wellknown
    from karpenter_tpu_torch.api.provisioner import Constraints
    from karpenter_tpu_torch.models import solver
    from karpenter_tpu_torch.ops import cuda_build, cuda_kernels, lp_shard_kernel, pack_kernel, score_kernel
    from karpenter_tpu_torch.ops.encode import build_fleet, group_pods
    from karpenter_tpu_torch.parallel import collectives, multihost, spmd
    from karpenter_tpu_torch.parallel import mesh as mesh_mod

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cuda_build.build_all(cuda_build.port_libraries())
    os.environ["KARPENTER_HOST_SOLVE"] = "0"
    check(multihost.init_distributed(
        {"KARPENTER_COORDINATOR": f"127.0.0.1:{port}", "KARPENTER_NUM_PROCESSES": str(MULTIPROCESS_RANKS),
         "KARPENTER_PROCESS_ID": str(rank)},
        backend=multihost.backend_for("cuda", shared_card=True), timeout_s=MULTIPROCESS_TIMEOUT_S),
        "the process group did not form")
    counters = (cuda_kernels.dominance_prices, pack_kernel.pack_pair_payload, score_kernel.lp_relax,
                pack_kernel.compact_shard)

    def launches():
        out = {counter.__name__: counter.launches for counter in counters}
        out.update(lp_shard=lp_shard_kernel.launches(), lp_shard_persistent=lp_shard_kernel.shard_lp.launches)
        return out

    def measured(step):
        before = (launches(), dict(spmd.TRANSPORT), dict(collectives.EXCHANGES))
        start = time.perf_counter()
        step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - start) * 1e3
        return {"ms": ms, "launches": {k: v - before[0][k] for k, v in launches().items()},
                "broadcasts": spmd.TRANSPORT["broadcasts"] - before[1]["broadcasts"],
                "transport_ms": (spmd.TRANSPORT["seconds"] - before[1]["seconds"]) * 1e3,
                "exchanges": collectives.EXCHANGES["exchanges"] - before[2]["exchanges"]}

    result = {"rank": rank}
    with mesh_mod.virtual_devices(device, MULTIPROCESS_SHARDS):
        if rank == 0:
            pods, catalog = make_workload()
            groups = group_pods(pods)
            fleet = build_fleet(catalog, Constraints(), pods, pods_need=groups.vectors.max(axis=0))
            mesh = solver.solve_mesh(device)
            check(mesh is not None and mesh.shape == (2, 2) and mesh.spans_processes
                  and [shard.rank for shard in mesh.flat] == [0, 0, 1, 1],
                  f"rank 0's mesh is {mesh}, not 2x2 over two processes")
            cost_solver = solver.CostSolver(device=device)

            def step():
                result["plan"] = cost_solver.solve_encoded(groups, fleet)
        else:
            def step():
                check(spmd.follower_step(wellknown.NUM_RESOURCE_DIMS, device) is not None,
                      "the follower got a stop header before the last solve")

        step()
        samples = [measured(step) for _ in range(MULTIPROCESS_SOLVES)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        by_kernel = device_ms_by_kernel(prof)
        steps = 3 * 300 + 3
        for sample in samples:
            got = sample["launches"]
            want = {"dominance_prices": 1, "pack_pair_payload": 1, "lp_relax": 0, "compact_shard": 1,
                    "lp_shard": MULTIPROCESS_SHARDS * steps, "lp_shard_persistent": 0}
            check(got == want, f"rank {rank}'s solve launched {got}, not {want}")
        if rank == 0:
            plan = result.pop("plan")
            check(all_pods_placed_once(plan, pods), "the 2-process solve did not place every pod once")
            handle = solver.cost_solve_dispatch(groups.vectors, groups.counts, fleet.capacity, fleet.total,
                                                fleet.prices, device=device)
            fetched = solver.fetch_plan(handle)
            arrays = {f"{name}_{field}": np.asarray(getattr(getattr(fetched, name), field))
                      for name in ("rounds_ffd", "rounds_cost") for field in pack_kernel.PackRounds._fields}
            np.savez(os.path.join(out_dir, "plan.npz"), feasible_any=np.asarray(fetched.feasible_any),
                     lp_objective=np.float32(fetched.lp_objective), lp_assignment=fetched.lp_assignment(),
                     **arrays)
            result.update(cost=plan.projected_cost(), signature=repr(plan_signature(plan)),
                          shards=handle.shards)
            spmd.lead_stop()
        else:
            check(spmd.follower_step(wellknown.NUM_RESOURCE_DIMS, device) is not None,
                  "the follower missed the decoded dispatch")
            check(spmd.follower_step(wellknown.NUM_RESOURCE_DIMS, device) is None,
                  "the follower got no stop header")
    result["backend"] = str(torch.distributed.get_backend())
    multihost.shutdown_distributed()
    result.update(samples=samples, device_ms_by_kernel=by_kernel)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as handle_out:
        json.dump(result, handle_out)
    print(f"multiprocess rank {rank} done", flush=True)


def multiprocess_phase(device, pods, groups, fleet) -> dict:
    """The multi-process lead/follower dispatch on the card: two ranks
    (`--phase multiprocess-rank`) share the card over gloo, two shards
    each; rank 0 runs the production solve at the main path's shapes. Its
    decodes and $/hr must equal the one-process 2x2 mesh's (the sharded
    phase's, the persistent K9a route), and its decodes, LP and plan the
    one-process 2x2 mesh's through K9a's per-phase route bit for bit (the
    route a mesh across processes takes). Prints the solve p50, each rank's
    device ms by kernel, and the collectives a solve. Either rank failing
    fails the phase. Returns the numbers the kernels line reports."""
    import tempfile

    import torch

    from karpenter_tpu_torch.models import solver
    from karpenter_tpu_torch.ops import pack_kernel
    from karpenter_tpu_torch.parallel import mesh as mesh_mod

    args = (groups.vectors, groups.counts, fleet.capacity, fleet.total, fleet.prices)
    cost_solver = solver.CostSolver(device=device)
    alone = {}
    with mesh_mod.virtual_devices(device, MULTIPROCESS_RANKS * MULTIPROCESS_SHARDS):
        for route, context in (("persistent", contextlib.nullcontext), ("per_phase", per_phase_k9a)):
            with context():
                plan = cost_solver.solve_encoded(groups, fleet)
                fetched = solver.fetch_plan(solver.cost_solve_dispatch(*args, device=device))
                samples = []
                for _ in range(MULTIPROCESS_SOLVES):
                    start = time.perf_counter()
                    cost_solver.solve_encoded(groups, fleet)
                    samples.append((time.perf_counter() - start) * 1e3)
                alone[route] = {"plan": fetched, "cost": plan.projected_cost(),
                                "signature": repr(plan_signature(plan)), "p50_ms": float(np.percentile(samples, 50))}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-mp-") as out_dir:
        port = free_port()
        ranks = [run_child(["--phase", "multiprocess-rank", str(rank), str(port), out_dir], MULTIPROCESS_TIMEOUT_S)
                 for rank in range(MULTIPROCESS_RANKS)]
        outputs = []
        try:
            for rank, (process, timeout_s) in enumerate(ranks):
                try:
                    out, err = process.communicate(timeout=timeout_s)
                except subprocess.TimeoutExpired:
                    raise RuntimeError(f"check failed: multiprocess rank {rank} did not finish in {timeout_s:.0f} s")
                errors = "\n".join(line for line in err.splitlines() if "\tINFO\t" not in line)
                check(process.returncode == 0,
                      f"multiprocess rank {rank} failed (rc {process.returncode}):\n{out[-2000:]}\n{errors[-4000:]}")
                outputs.append(out)
        finally:
            for process, _ in ranks:
                if process.poll() is None:
                    process.kill()
                    process.communicate()
        records = []
        for rank in range(MULTIPROCESS_RANKS):
            with open(os.path.join(out_dir, f"rank{rank}.json")) as handle:
                records.append(json.load(handle))
        words = dict(np.load(os.path.join(out_dir, "plan.npz")))
    lead = records[0]
    check(lead["shards"] == 4, f"the 2-process dispatch reports {lead['shards']} shards")
    for route, want in alone.items():
        plan = want["plan"]
        for name in ("rounds_ffd", "rounds_cost"):
            for field in pack_kernel.PackRounds._fields:
                check(np.array_equal(words[f"{name}_{field}"], np.asarray(getattr(getattr(plan, name), field))),
                      f"the 2-process decode differs from the one-process 2x2 ({route}): {name} {field}")
        check(np.array_equal(words["feasible_any"], plan.feasible_any),
              f"the 2-process feasible_any differs from the one-process 2x2 ({route})")
        check(lead["cost"] == want["cost"],
              f"the 2-process $/hr {lead['cost']} differs from the one-process 2x2's {want['cost']} ({route})")
    per_phase = alone["per_phase"]
    check(float(words["lp_objective"]) == per_phase["plan"].lp_objective
          and np.array_equal(words["lp_assignment"], per_phase["plan"].lp_assignment())
          and lead["signature"] == per_phase["signature"],
          "the 2-process LP or plan differs from the one-process 2x2 per-phase route's")
    solve_ms = [sample["ms"] for sample in lead["samples"]]
    per_solve = {rank: {key: float(np.median([s[key] for s in record["samples"]]))
                        for key in ("broadcasts", "transport_ms", "exchanges", "ms")}
                 for rank, record in enumerate(records)}
    device_ms = {rank: {name: round(ms, 4) for name, (count, ms) in sorted(record["device_ms_by_kernel"].items())}
                 for rank, record in enumerate(records)}
    for rank in range(MULTIPROCESS_RANKS):
        print(f"  multiprocess rank {rank} device ms by kernel (one solve): {json.dumps(device_ms[rank])}")
    launches = records[0]["samples"][0]["launches"]
    phase("multiprocess", ranks=MULTIPROCESS_RANKS, shards_per_rank=MULTIPROCESS_SHARDS, mesh="2x2",
          backend=lead["backend"], pods=len(pods), solve_p50_ms=f"{np.percentile(solve_ms, 50):.3f}",
          solve_max_ms=f"{max(solve_ms):.3f}", cost_per_hr=f"{lead['cost']:.6f}",
          one_process_cost_per_hr=f"{alone['persistent']['cost']:.6f}",
          one_process_p50_ms=f"{alone['persistent']['p50_ms']:.3f}",
          one_process_per_phase_p50_ms=f"{alone['per_phase']['p50_ms']:.3f}",
          decodes="bit-identical (2x2 persistent and per-phase)", lp="bit-identical (2x2 per-phase)",
          **{f"rank{rank}_{key}": f"{value:.3f}" for rank, entry in per_solve.items() for key, value in entry.items()},
          launches=json.dumps(launches, separators=(",", ":")))
    return {"solve_p50_ms": float(np.percentile(solve_ms, 50)), "per_solve": per_solve,
            "one_process_p50_ms": {route: entry["p50_ms"] for route, entry in alone.items()},
            "device_ms_by_kernel": device_ms, "launches_per_rank": launches, "cost": lead["cost"]}


# --- K8, the incremental encode ----------------------------------------------

def k8_cases():
    """(name, op, array, index, rows) K8 is held to its plain version on, as
    numpy: the scatter and the gather over float32 rows, int32 and bool
    values; a delta, a 1-element delta, sentinel-only index vectors, every
    row, and an empty permutation."""
    from karpenter_tpu_torch.ops.incremental import pad_indices

    rng = np.random.default_rng(8)

    def array(kind, rows):
        if kind == "f32":
            return rng.uniform(-1e3, 1e3, (rows, 8)).astype(np.float32)
        if kind == "i32":
            return rng.integers(-(2**31), 2**31 - 1, rows, dtype=np.int64).astype(np.int32)
        return rng.random(rows) < 0.5

    for kind in ("f32", "i32", "bool"):
        for count in (13, 1, 0, 64):
            real = np.sort(rng.choice(64, count, replace=False)).astype(np.int32)
            idx = pad_indices(real, 64)
            yield f"scatter-{kind}-{count}", "scatter", array(kind, 64), idx, array(kind, len(idx))
        for count in (23, 1, 0, 40):
            live = rng.permutation(40)[:count].astype(np.int32)
            yield f"gather-{kind}-{count}", "gather", array(kind, 40), pad_indices(live, 40), None
        yield f"gather-{kind}-empty", "gather", array(kind, 40), np.zeros(0, np.int32), None
    # The main path's slot arrays: 512 node rows, a 256-row delta.
    real = np.sort(rng.choice(512, 250, replace=False)).astype(np.int32)
    idx = pad_indices(real, 512)
    yield "scatter-f32-nodes", "scatter", array("f32", 512), idx, array("f32", len(idx))


def same_bits(a, b) -> bool:
    """Equal shapes, dtypes and bits (float32 compared as int32 words)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def k8_check(device) -> dict:
    """Every case of k8_cases through K8 on the card and its plain version
    on the same tensors: bit for bit, the scatter's input untouched."""
    import torch

    from karpenter_tpu_torch.convert import upload_packed
    from karpenter_tpu_torch.ops import incremental

    cases = 0
    for name, op, array, index, rows in k8_cases():
        if op == "scatter":
            dst, idx, values = upload_packed([array, index, rows], device)
            kept = dst.clone()
            got = incremental.scatter(dst, idx, values)
            want = incremental._scatter_ref(dst, idx, values)
            torch.cuda.synchronize()
            check(same_bits(dst, kept), f"K8 wrote into its input on {name}")
        else:
            src, perm = upload_packed([array, index], device)
            got = incremental.gather(src, perm)
            want = incremental._gather_ref(src, perm)
            torch.cuda.synchronize()
        check(same_bits(got, want), f"K8 differs from its plain version on {name}")
        cases += 1
    return {"cases": cases}


def k8_batched_check(device) -> dict:
    """Every case of k8_cases through K8's batched entry points on the card
    and their plain versions on the same tensors, bit for bit: the
    scatters in flushes of up to MAX_ARRAYS arrays (each with its own
    delta; one launch a flush, the inputs untouched), and each gather's
    permutation over its source and one source of each other kind in one
    view (one launch, none for an empty permutation)."""
    import torch

    from karpenter_tpu_torch.convert import upload_packed
    from karpenter_tpu_torch.ops import incremental

    cases = list(k8_cases())
    scatters = [upload_packed([array, index, rows], device)
                for _, op, array, index, rows in cases if op == "scatter"]
    flushes = 0
    for start in range(0, len(scatters), incremental.MAX_ARRAYS):
        batch = scatters[start : start + incremental.MAX_ARRAYS]
        kept = [dst.clone() for dst, _, _ in batch]
        before = incremental.scatter.launches
        got = incremental.scatter_flush(batch)
        want = incremental._scatter_flush_ref(batch)
        torch.cuda.synchronize()
        check(incremental.scatter.launches == before + 1,
              f"a flush of {len(batch)} arrays took {incremental.scatter.launches - before} launches")
        check(all(same_bits(dst, old) for (dst, _, _), old in zip(batch, kept)), "scatter_flush wrote into its input")
        check(all(same_bits(a, b) for a, b in zip(got, want)), "scatter_flush differs from its plain version")
        flushes += 1
    gathers = [(name.split("-")[1], upload_packed([array, index], device))
               for name, op, array, index, _ in cases if op == "gather"]
    first_of = {}
    for kind, (src, _) in gathers:
        first_of.setdefault(kind, src)
    views = 0
    for kind, (src, perm) in gathers:
        sources = [src] + [other for other_kind, other in first_of.items() if other_kind != kind]
        before = incremental.gather.launches
        got = incremental.gather_view(sources, perm)
        want = incremental._gather_view_ref(sources, perm)
        torch.cuda.synchronize()
        check(incremental.gather.launches == before + (1 if perm.numel() else 0),
              f"a view of {len(sources)} sources took {incremental.gather.launches - before} launches")
        check(all(same_bits(a, b) for a, b in zip(got, want)), "gather_view differs from its plain version")
        views += 1
    return {"flushes": flushes, "views": views, "cases": len(cases)}


def plan_signature(result):
    """Everything a plan says, in order: bit-identical plans give equal
    values."""
    packings = [
        (
            tuple(it.name for it in p.instance_type_options),
            tuple((o.instance_type.name, o.zone, o.price) for o in p.pool_options or ()),
            p.node_quantity,
            tuple(tuple(pod.name for pod in node) for node in p.pods_per_node),
        )
        for p in result.packings
    ]
    return packings, [pod.name for pod in result.unschedulable]


def device_arrays_match_mirrors(state) -> bool:
    """The state's device arrays hold its host mirrors (node_used cast to
    float32, as the flush casts it)."""
    import torch

    _, dev = state.device_view()
    with state._lock:
        mirrors = {
            "group_vectors": state._group_vectors,
            "group_counts": state._group_counts,
            "node_capacity": state._node_capacity,
            "node_used": state._node_used.astype(np.float32),
            "node_live": state._node_live,
        }
    for name, mirror in mirrors.items():
        if not same_bits(dev[name].cpu(), torch.from_numpy(np.ascontiguousarray(mirror))):
            return False
    return True


def incremental_phase(device, num_pods: int = NUM_PODS, churn_fraction: float = 0.01,
                      sweeps: int = 12, parity_every: int = 4) -> dict:
    """The repository's steady-state churn scenario (bench.py
    bench_encode_incremental) over the port's Cluster and a
    DeviceClusterState on `device`: 50,000 pods bound over 500 nodes in 16
    shapes, then 1% churn a sweep (half bound pods deleted, half new pending
    pods, a quarter of them in a new shape). A sample is one flush plus the
    sorted view, synced. Every `parity_every` sweeps and at the end, the
    view must be bit-identical to group_pods over the store, node_used equal
    a pod walk, and the device arrays equal the host mirrors."""
    import torch

    from karpenter_tpu_torch.api.pods import PodSpec
    from karpenter_tpu_torch.cloudprovider import NodeSpec
    from karpenter_tpu_torch.controllers.cluster import Cluster
    from karpenter_tpu_torch.models.cluster_state import DeviceClusterState
    from karpenter_tpu_torch.ops import incremental
    from karpenter_tpu_torch.ops.encode import group_pods

    setup_start = time.perf_counter()
    rng = np.random.default_rng(11)
    cluster = Cluster()
    state = DeviceClusterState(cluster, device=device)
    shapes = [(int(rng.integers(1, 17)) * 250, int(rng.integers(1, 33)) * 256) for _ in range(16)]
    serial = 0

    def add_pod(shape):
        nonlocal serial
        cpu, mem = shape
        pod = PodSpec(name=f"enc-{serial}", requests={"cpu": f"{cpu}m", "memory": f"{mem}Mi"},
                      unschedulable=True)
        serial += 1
        cluster.apply_pod(pod)
        return pod

    pods_per_node = 100
    nodes = []
    for n in range(num_pods // pods_per_node):
        node = NodeSpec(name=f"enc-n{n}", capacity={"cpu": 512.0, "memory": 1 << 20})
        cluster.create_node(node)
        nodes.append(node)
    bound = []
    for i in range(num_pods):
        pod = add_pod(shapes[i % len(shapes)])
        cluster.bind_pod(pod, nodes[i // pods_per_node])
        bound.append(pod)
    setup_s = time.perf_counter() - setup_start

    # Warm pass: the first flush (a rebuild and a full upload) and one
    # untimed churn sweep, so the timed sweeps are the steady state.
    state.pending_groups()
    cluster.delete_pod(bound[0].namespace, bound[0].name)
    bound.pop(0)
    state.pending_groups()
    synchronize(device)

    # The full snapshot rebuild a restarted consumer pays.
    start = time.perf_counter()
    DeviceClusterState(cluster, subscribe=False, device=device).pending_groups()
    synchronize(device)
    encode_rebuild_ms = (time.perf_counter() - start) * 1e3

    def assert_parity():
        got = state.pending_groups()
        want = group_pods([p for p in cluster.list_pods() if p.is_provisionable()])
        check(np.array_equal(got.vectors, want.vectors) and np.array_equal(got.counts, want.counts),
              "the incremental encode diverged from group_pods over the store")
        check(same_bits(got.device_vectors[: got.num_groups].cpu(), torch.from_numpy(want.vectors))
              and same_bits(got.device_counts[: got.num_groups].cpu(), torch.from_numpy(want.counts))
              and not got.device_counts[got.num_groups :].any(),
              "the sorted device view differs from group_pods over the store")
        for probe in (nodes[0], nodes[len(nodes) // 2], nodes[-1]):
            walk = np.zeros(8, np.float64)
            for p in cluster.list_pods(node_name=probe.name):
                if not p.is_terminal():
                    walk += p.dense_vector[0].astype(np.float64)
            used = state.node_used(probe.name)
            check(used is not None and np.array_equal(used, walk), "node_used diverged from the pod walk")
        check(device_arrays_match_mirrors(state), "the device arrays differ from the host mirrors")

    churn = max(int(num_pods * churn_fraction), 2)
    samples = []
    arrivals = []
    deltas = []

    def churn_sweep(sweep):
        nonlocal arrivals
        for pod, node in arrivals:
            cluster.bind_pod(pod, node)
        arrivals = []
        for pod in bound[: churn // 2]:
            cluster.delete_pod(pod.namespace, pod.name)
        del bound[: churn // 2]
        fresh_shape = (250 * (17 + sweep), 256 * (3 + sweep % 5))
        for i in range(churn - churn // 2):
            pod = add_pod(fresh_shape if i % 4 == 0 else shapes[i % len(shapes)])
            arrivals.append((pod, nodes[(sweep * 31 + i) % len(nodes)]))
            bound.append(pod)

    incremental.scatter.launches = 0
    incremental.gather.launches = 0
    flushes = 0
    for sweep in range(sweeps):
        churn_sweep(sweep)
        with state._lock:
            deltas.append((len(state._group_dirty), len(state._node_dirty)))
        synchronize(device)
        start = time.perf_counter()
        state.pending_groups()
        synchronize(device)
        samples.append((time.perf_counter() - start) * 1e3)
        flushes += 1
        if (sweep + 1) % parity_every == 0:
            assert_parity()
            flushes += 1
    assert_parity()
    flushes += 1
    launches = {"scatter": incremental.scatter.launches, "gather": incremental.gather.launches}
    check(launches["scatter"] > 0 and launches["gather"] > 0,
          f"the churn sweeps did not launch both K8 kernels: {launches}")
    group_density, node_density = state.tombstone_density()
    phase(
        "incremental", pods=num_pods, nodes=len(nodes), churn_per_sweep=churn, sweeps=sweeps,
        setup_s=f"{setup_s:.1f}",
        encode_delta_ms=f"{np.percentile(samples, 50):.3f}",
        encode_delta_p99_ms=f"{np.percentile(samples, 99):.3f}",
        encode_rebuild_ms=f"{encode_rebuild_ms:.3f}",
        scatter_launches=launches["scatter"], gather_launches=launches["gather"], flushes=flushes,
        delta_rows="{}/{}".format(*np.max(deltas, axis=0)),
        rebuilds=state.rebuild_count, compactions=state.compaction_count,
        tombstone_density=f"{group_density:.4f}", parity_checks=sweeps // parity_every + 2,
    )
    return {"state": state, "launches": launches, "flushes": flushes, "deltas": deltas}


def k8_sweep_operands(state, deltas, device):
    """The K8 work of one steady-state sweep on `state`'s arrays: the
    (dst, idx, rows) of a flush with the largest delta the sweeps saw
    (group and node rows at their slots, five arrays) and the (src, perm)
    of the sorted view's two gathers (one permutation), with the bytes the
    sweep must move."""
    from karpenter_tpu_torch.convert import upload_packed
    from karpenter_tpu_torch.ops.incremental import pad_indices

    rng = np.random.default_rng(5)
    _, dev = state.device_view()
    group_rows, node_rows = (int(n) for n in np.max(deltas, axis=0))
    g_cap, n_cap = dev["group_vectors"].shape[0], dev["node_capacity"].shape[0]
    with state._lock:
        live_groups = np.nonzero(state._group_live)[0].astype(np.int32)
        live_nodes = np.nonzero(state._node_live)[0].astype(np.int32)
    g_idx = pad_indices(np.sort(rng.choice(live_groups, min(group_rows, len(live_groups)), replace=False)), g_cap)
    n_idx = pad_indices(np.sort(rng.choice(live_nodes, min(node_rows, len(live_nodes)), replace=False)), n_cap)
    perm = pad_indices(live_groups, g_cap)
    host = [
        g_idx, rng.uniform(0, 1e4, (len(g_idx), 8)).astype(np.float32),
        rng.integers(0, 1000, len(g_idx)).astype(np.int32),
        n_idx, rng.uniform(0, 1e4, (len(n_idx), 8)).astype(np.float32),
        rng.uniform(0, 1e4, (len(n_idx), 8)).astype(np.float32), np.ones(len(n_idx), bool), perm,
    ]
    g_idx_t, g_rows, g_counts, n_idx_t, n_cap_rows, n_used, n_live, perm_t = upload_packed(host, device)
    scatters = [
        (dev["group_vectors"], g_idx_t, g_rows), (dev["group_counts"], g_idx_t, g_counts),
        (dev["node_capacity"], n_idx_t, n_cap_rows), (dev["node_used"], n_idx_t, n_used),
        (dev["node_live"], n_idx_t, n_live),
    ]
    gathers = [(dev["group_vectors"], perm_t), (dev["group_counts"], perm_t)]
    # Bytes the kernels move: every index read, each in-range row read and
    # written by the scatter; the permutation read, each in-range row read
    # and every output row written by the gather.
    real_g, real_n, real_p = group_rows, node_rows, len(live_groups)
    moved = 0
    for (dst, idx, rows), real in zip(scatters, (real_g, real_g, real_n, real_n, real_n)):
        # The index and the real delta rows read, the old generation read
        # and the new one written whole (the scatter is functional).
        row_bytes = rows[0].numel() * rows.element_size()
        moved += 4 * idx.shape[0] + real * row_bytes + 2 * dst.numel() * dst.element_size()
    for src, index in gathers:
        row_bytes = src[0].numel() * src.element_size()
        moved += 4 * index.shape[0] + real_p * row_bytes + index.shape[0] * row_bytes
    return scatters, gathers, moved


def fast_path_phase(catalog, cost_solver, device, cpu_cost: float, num_pods: int = NUM_PODS) -> dict:
    """The provisioning pass's fast path: the main path's 50,000 pending
    pods tracked by a DeviceClusterState on the card; encode_schedule hands
    CostSolver.solve_many_pipelined a pre-encoded pair whose pod tensors are
    already on the card. Held to the snapshot path (solve_many over the
    same pods: the same plan) and to the port's CPU run of these pods
    (`cpu_cost`: $/hr within 1e-4); K1-K4 run once each (K4 in K2's launch); no
    pod tensor crosses host->device, and a warm solve uploads nothing
    (convert.upload_packed's counters); encode and
    dispatch pass under torch.cuda.set_sync_debug_mode("error"). Then 1%
    churn on the backlog and the same again, K8 launched."""
    import torch

    from karpenter_tpu_torch.api.provisioner import Constraints
    from karpenter_tpu_torch.controllers.cluster import Cluster
    from karpenter_tpu_torch.convert import upload_packed
    from karpenter_tpu_torch.models import solver
    from karpenter_tpu_torch.models.cluster_state import DeviceClusterState
    from karpenter_tpu_torch.ops import cuda_kernels, incremental, pack_kernel, score_kernel
    from karpenter_tpu_torch.ops.encode import build_fleet, group_pods

    pods, _ = make_workload(num_pods)
    start = time.perf_counter()
    cluster = Cluster()
    state = DeviceClusterState(cluster, device=device)
    for pod in pods:
        cluster.apply_pod(pod)
    setup_s = time.perf_counter() - start
    constraints = Constraints()
    kernels = {
        "dominance_prices": cuda_kernels.dominance_prices, "pack_kernel": pack_kernel.pack_kernel,
        "lp_relax": score_kernel.lp_relax, "pack_pair_payload": pack_kernel.pack_pair_payload,
    }

    def pending():
        return [p for p in cluster.list_pods() if p.is_provisionable()]

    def uploads():
        return upload_packed.copies, upload_packed.arrays, upload_packed.bytes

    def fast_solve(batch):
        """One fast-path solve: counts zeroed just before, read after;
        encode and dispatch under the sync check."""
        for fn in kernels.values():
            fn.launches = 0
        incremental.scatter.launches = incremental.gather.launches = 0
        synchronize(device)
        torch.cuda.set_sync_debug_mode("error")
        try:
            start = time.perf_counter()
            pair = state.encode_schedule(batch, catalog, constraints, [])
            encode_ms = (time.perf_counter() - start) * 1e3
            check(pair is not None and pair[0].device_vectors is not None,
                  "encode_schedule did not cover the backlog")
            before = uploads()
            stream = cost_solver.solve_many_pipelined([pair])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        (result,) = list(stream)
        after = uploads()
        launches = {name: fn.launches for name, fn in kernels.items()}
        check(all(count == 1 for count in launches.values()),
              f"the fast-path solve did not launch K1, the K2 pair with its epilogue and K3 exactly once each: {launches}")
        k8 = {"scatter": incremental.scatter.launches, "gather": incremental.gather.launches}
        return pair, result, encode_ms, tuple(b - a for a, b in zip(before, after)), launches, k8

    fleet_arrays = None
    rounds = []
    for label in ("backlog", "churned"):
        batch = pending()
        pack_kernel.reset_device_resident()
        pair, result, encode_fast_ms, cold_uploads, launches, k8 = fast_solve(batch)
        fleet_arrays = fleet_arrays or sum(
            -(-np.asarray(a).nbytes // 16) * 16
            for a in solver.pad_kernel_args(pair[0].vectors, pair[0].counts, pair[1].capacity,
                                            pair[1].total, pair[1].prices)[2:])
        # Cold (the fleet not resident): exactly the four fleet arrays went
        # up, so no pod tensor did.
        check(cold_uploads == (1, 4, fleet_arrays),
              f"the {label} fast-path solve uploaded {cold_uploads}, not the fleet's 4 arrays alone")
        check(k8["gather"] == 1, f"the {label} encode launched K8's gather {k8['gather']} times, not once")
        check(all_pods_placed_once(result, batch), f"the {label} fast path did not place every pod once")
        # Warm: the same pair again uploads nothing.
        before = uploads()
        (again,) = list(cost_solver.solve_many_pipelined([pair]))
        synchronize(device)
        warm_uploads = tuple(b - a for a, b in zip(before, uploads()))
        check(warm_uploads == (0, 0, 0), f"the warm {label} fast-path solve copied to the card: {warm_uploads}")
        check(plan_signature(again) == plan_signature(result), f"two {label} fast-path solves differ")
        (snapshot,) = cost_solver.solve_many([(batch, catalog, constraints, ())])
        check(plan_signature(result) == plan_signature(snapshot),
              f"the {label} fast path's plan differs from the snapshot path's")
        check(result.projected_cost() == snapshot.projected_cost(), "fast and snapshot $/hr differ")
        rounds.append({"label": label, "k8": k8, "encode_fast_ms": encode_fast_ms,
                       "cost": result.projected_cost(), "nodes": result.node_count})
        if label == "backlog":
            cpu_rel = abs(result.projected_cost() - cpu_cost) / cpu_cost
            check(cpu_rel <= 1e-4, f"fast-path $/hr differs between the card and the CPU by {cpu_rel:.3e}")
            # Warm p50s, 10 runs each: the fast path (encode + solve) and the
            # snapshot path (group_pods + build_fleet + solve).
            fast_ms, snap_ms, skipped_ms = [], [], []
            for _ in range(10):
                start = time.perf_counter()
                fast_pair = state.encode_schedule(batch, catalog, constraints, [])
                list(cost_solver.solve_many_pipelined([fast_pair]))
                fast_ms.append((time.perf_counter() - start) * 1e3)
                start = time.perf_counter()
                cost_solver.solve_many([(batch, catalog, constraints, ())])
                snap_ms.append((time.perf_counter() - start) * 1e3)
                start = time.perf_counter()
                snap_groups = group_pods(batch)
                build_fleet(catalog, constraints, batch, pods_need=snap_groups.vectors.max(axis=0))
                skipped_ms.append((time.perf_counter() - start) * 1e3)
            # 1% churn on the backlog, twice: half the churn deleted, half
            # new pending pods (a quarter of them in a new shape no larger
            # than the backlog's largest, so the fleet keeps its content).
            # The first churn grows the group slots past their bucket of 16
            # (a full upload, a new epoch); the second is the steady state,
            # a flush of K8 scatters.
            from karpenter_tpu_torch.api.pods import PodSpec

            churn = len(batch) // 100
            for step in range(2):
                for pod in batch[step * churn : step * churn + churn // 2]:
                    cluster.delete_pod(pod.namespace, pod.name)
                for i in range(churn - churn // 2):
                    cpu, mem = (1250, 1280) if i % 4 == 0 else pod_shapes(0)[i % 16]
                    cluster.apply_pod(PodSpec(name=f"churn-{step}-{i}", unschedulable=True,
                                              requests={"cpu": f"{cpu}m", "memory": f"{mem}Mi"}))
                if step == 0:
                    state.flush()
    check(rounds[1]["k8"] == {"scatter": 1, "gather": 1},
          f"the churned encode did not launch K8 once for its flush and once for its view: {rounds[1]['k8']}")

    # Time to the first result of an 8-schedule pipelined solve, against
    # the batch solve of the same schedules.
    batch = pending()
    encoded = solver.Solver._encode_problems([(batch[k::8], catalog, constraints, ()) for k in range(8)])
    cost_solver.solve_encoded_many(encoded)  # warm
    start = time.perf_counter()
    stream = cost_solver.solve_encoded_pipelined(encoded)
    piped = [next(stream)]
    first_ms = (time.perf_counter() - start) * 1e3
    piped += list(stream)
    piped_ms = (time.perf_counter() - start) * 1e3
    start = time.perf_counter()
    batched = cost_solver.solve_encoded_many(encoded)
    batch_ms = (time.perf_counter() - start) * 1e3
    check([plan_signature(r) for r in piped] == [plan_signature(r) for r in batched],
          "the pipelined and batched solves of 8 schedules differ")
    phase(
        "fast_path", pods=num_pods, types=len(catalog), setup_s=f"{setup_s:.1f}",
        nodes=rounds[0]["nodes"], cost_per_hr=f"{rounds[0]['cost']:.6f}", cpu_cost_rel_diff=f"{cpu_rel:.3e}",
        plan="identical to the snapshot path", pod_h2d="none", warm_fleet_uploads=0,
        encode_dispatch_sync_free="yes", launches=json.dumps(launches, separators=(",", ":")),
        fast_p50_ms=f"{np.percentile(fast_ms, 50):.3f}", snapshot_p50_ms=f"{np.percentile(snap_ms, 50):.3f}",
        encode_fast_ms=f"{rounds[0]['encode_fast_ms']:.3f}",
        encode_skipped_ms=f"{np.percentile(skipped_ms, 50):.3f}",
        churned_k8=json.dumps(rounds[1]["k8"], separators=(",", ":")),
        churned_encode_ms=f"{rounds[1]['encode_fast_ms']:.3f}", churned_cost_per_hr=f"{rounds[1]['cost']:.6f}",
        first_result_ms=f"{first_ms:.3f}", pipelined8_ms=f"{piped_ms:.3f}", batch8_ms=f"{batch_ms:.3f}",
    )
    return {"encoded": encoded, "plans": [plan_signature(r) for r in batched]}


def oom_ladder_phase(cost_solver, encoded, clean) -> None:
    """The device-memory ladder on the card, on the fast path's 8-schedule
    batch: an injected out-of-memory fault at one and two split depths, the
    KARPENTER_HBM_BYTES pre-split, and a fault in the middle of the
    pipeline each give the unarmed run's plans bit for bit, and the split
    counter counts them; the floor is never reached."""
    from karpenter_tpu_torch.models import solver
    from karpenter_tpu_torch.utils import faultpoints

    def split(reason):
        return solver.SOLVER_BATCH_SPLIT_TOTAL.get(reason)

    floor = split("floor")
    counted = {}
    for depth in (1, 2):
        before = split("oom")
        faultpoints.arm("solver.dispatch", "oom", count=depth)
        try:
            plans = [plan_signature(r) for r in cost_solver.solve_encoded_many(encoded)]
            fired = faultpoints.fired("solver.dispatch")
        finally:
            faultpoints.disarm_all()
        check(plans == clean, f"the bisect at depth {depth} changed the plans")
        check(fired == depth and split("oom") == before + depth,
              f"depth {depth}: {fired} faults fired, {split('oom') - before} bisects counted")
        counted[f"oom{depth}"] = split("oom") - before
    one = max(solver._estimate_solve_bytes(*item) for item in encoded)
    before = split("estimate")
    os.environ["KARPENTER_HBM_BYTES"] = str(2.5 * one / solver.HBM_SAFETY_FACTOR)
    try:
        chunks = len(solver._presplit_for_hbm(encoded, cost_solver.device))
        plans = [plan_signature(r) for r in cost_solver.solve_encoded_many(encoded)]
    finally:
        del os.environ["KARPENTER_HBM_BYTES"]
    check(chunks > 1 and plans == clean and split("estimate") == before + chunks - 1,
          f"the HBM pre-split gave {chunks} chunks, {split('estimate') - before} counted")
    counted["estimate"] = split("estimate") - before
    before = split("oom")
    stream = cost_solver.solve_encoded_pipelined(encoded)
    plans = [plan_signature(next(stream))]
    faultpoints.arm("solver.dispatch", "oom", count=1)
    try:
        plans += [plan_signature(r) for r in stream]
    finally:
        faultpoints.disarm_all()
    check(plans == clean and split("oom") == before + 1, "the mid-pipeline fault changed the plans")
    counted["mid_pipeline"] = split("oom") - before
    check(split("floor") == floor, "the ladder reached its floor")
    phase("oom_ladder", schedules=len(encoded), plans="bit-identical", floor=0,
          **{key: value for key, value in counted.items()})


# --- provision_storm: the provisioning controllers under a live spot market --

STORM_WINDOW = 2_000  # karpenter_tpu/controllers/provisioning.py:39 MAX_PODS_PER_BATCH
STORM_FEED_SEED = 13
STORM_FEED_STEPS = 5  # feed steps folded before the storm (one a second)
STORM_RISKY_POOLS = 6  # the cheapest spot pools given an observed interruption
STORM_SPIKE_POOLS = 8  # pools whose price spikes mid-storm
STORM_SPIKE_FACTOR = 1.6
STORM_REPRICE_PASS = 13  # the market reprices just before this pass (1-based)
STORM_PROFILE_PASS = 2  # the storm pass traced by torch.profiler, in a run of its own (a calm pass)


def spot_provisioner(provisioner_module, requirements_module, wellknown):
    """The storm's provisioner, from either package's modules: capacity type
    spot only (the reference's ProvisionerSpec requirement), so every node
    bought is a spot pool's, priced by the market and chosen by the
    risk-ranked [T, Z] pools."""
    requirement = requirements_module.Requirement.in_(
        wellknown.CAPACITY_TYPE_LABEL, [wellknown.CAPACITY_TYPE_SPOT])
    constraints = provisioner_module.Constraints(
        requirements=requirements_module.Requirements([requirement]))
    return provisioner_module.Provisioner(
        name="default", spec=provisioner_module.ProvisionerSpec(constraints=constraints))


def storm_workload(num_pods: int = NUM_PODS, num_types: int = NUM_TYPES, seed: int = 0):
    """The main path's pods and catalog, the pods in a seeded random order:
    a storm of many deployments arrives interleaved, so every batch window
    holds every shape (and so the same fleet)."""
    pods, catalog = make_workload(num_pods, num_types, seed)
    order = np.random.default_rng(seed + 17).permutation(len(pods))
    return [pods[i] for i in order], catalog


# The apiserver phase's deployment: the controller against an apiserver over
# HTTP with the EC2 provider (over its FakeEc2 API) in place of the fake
# cloud.
APISERVER_CLUSTER = "chip-smoke"
APISERVER_CLOUD = "chip-smoke-ec2"  # the factory the apiserver phase's controller registers
EC2_INSTANCE_PROFILE = "chip-smoke-nodes"


def ec2_instance_type_infos(api_module, num_types: int = NUM_TYPES, seed: int = 0, package=None):
    """make_catalog's types as EC2 DescribeInstanceTypes records (`api_module`
    is either package's cloudprovider/ec2/api.py): each type's vCPUs, memory
    and on-demand price, and one network interface of max_pods - 1
    addresses, so the ENI formula gives the catalog's max pods. The x
    family is named rx: the provider's opinionated filter keeps only the
    families Kubernetes runs on (m, c, r, a, t3, t4, p, inf, g). FakeEc2
    prices spot at its flat share of on-demand."""
    infos = []
    for instance_type in make_catalog(num_types, seed, package):
        name = instance_type.name if instance_type.name[0] in "cmr" else "r" + instance_type.name
        on_demand = min(o.price for o in instance_type.offerings if o.capacity_type == "on-demand")
        infos.append(api_module.InstanceTypeInfo(
            name=name, vcpus=int(instance_type.capacity["cpu"]),
            memory_mib=int(instance_type.capacity["memory"]) // 2**20,
            max_network_interfaces=1, ipv4_addresses_per_interface=int(instance_type.capacity["pods"]) - 1,
            price_on_demand=on_demand,
        ))
    return infos


def ec2_provisioner(provisioner_module, requirements_module, wellknown):
    """The storm's spot-only provisioner with the EC2 provider's blob (its
    instance profile; the provider's defaulting hook adds the subnet and
    security-group selectors)."""
    provisioner = spot_provisioner(provisioner_module, requirements_module, wellknown)
    provisioner.spec.constraints.provider = {"instanceProfile": EC2_INSTANCE_PROFILE}
    return provisioner


def k10_cases_list():
    """K10's cases: the reference's magnitudes (prices 0.01-64, risks in
    steps of 1/32) at 257 and 4,096 types, one type, zero risk, and the main
    path's catalog spot prices at full risk."""
    rng = np.random.default_rng(9)
    cases = []
    for size in (257, 4096, 1):
        prices = rng.uniform(0.01, 64.0, size=size).astype(np.float32)
        risks = (np.floor(rng.uniform(0.0, 1.0, size=size) * 32.0) / 32.0).astype(np.float32)
        cases.append((prices, risks))
    cases.append((cases[0][0], np.zeros(257, np.float32)))
    spot = np.array([o.price for it in make_catalog() for o in it.offerings if o.capacity_type == "spot"],
                    np.float32)
    cases.append((spot, np.full(spot.shape, 31.0 / 32.0, np.float32)))
    return cases


def same_bytes(a: np.ndarray, b: np.ndarray) -> bool:
    """Equal shapes, dtypes and bytes: numpy arrays bit for bit."""
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def cheapest_spot_pools(fleet, count: int, skip=()):
    """The `count` cheapest spot pools (type, zone) of the fleet's types, by
    advertised price, leaving out `skip`."""
    rows = sorted(
        (offering.price, it.name, offering.zone)
        for it in fleet.instance_types
        for offering in it.offerings
        if offering.capacity_type == "spot" and (it.name, offering.zone) not in skip
    )
    return [(name, zone) for _, name, zone in rows[:count]]


def storm_world(catalog, device, solver_name: str, feed_steps: int = STORM_FEED_STEPS):
    """A fake cluster and cloud with a seeded market feed over every spot pool
    of the catalog, a Manager on `device`, and the feed's first steps folded
    by the market sweep (timed)."""
    from types import SimpleNamespace

    from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider
    from karpenter_tpu_torch.controllers.cluster import Cluster
    from karpenter_tpu_torch.market.feed import MarketFeed, catalog_pools
    from karpenter_tpu_torch.runtime import Manager
    from karpenter_tpu_torch.utils.clock import FakeClock
    from karpenter_tpu_torch.utils.obs import OBS
    from karpenter_tpu_torch.utils.options import Options

    OBS.reset()
    clock = FakeClock()
    cluster = Cluster(clock=clock)
    cloud = FakeCloudProvider(instance_types=catalog, clock=clock)
    pools = catalog_pools(catalog)
    feed = MarketFeed(pools, seed=STORM_FEED_SEED)
    cloud.attach_market_feed(feed)
    manager = Manager(cluster, cloud, Options(cluster_name="storm", solver=solver_name), device=device)
    clock.advance(feed_steps * feed.tick_interval_s)
    start = time.perf_counter()
    manager.market.reconcile()
    sweep_ms = (time.perf_counter() - start) * 1e3
    return SimpleNamespace(clock=clock, cluster=cluster, cloud=cloud, feed=feed, pools=pools,
                           manager=manager, book=manager.price_book, sweep_ms=sweep_ms)


def storm_price_checks(world, pods, device) -> dict:
    """The market hooks at the storm's fleet, with the world's book active:
    build_fleet's [T] column equals forecast.penalize_prices of the calm
    column bit for bit, and K10's output too; the risked types' prices and
    their pools' [T, Z] entries rise, every other entry is unchanged bit for
    bit; a calm book (one snapshot tick a pool: no trend, no interruption)
    gives the bits of no book at all."""
    import torch

    from karpenter_tpu_torch.market import forecast
    from karpenter_tpu_torch.market.pricebook import PriceBook, set_active_book
    from karpenter_tpu_torch.models.solver import _pool_price_matrix, _pool_zones
    from karpenter_tpu_torch.ops import forecast_kernel
    from karpenter_tpu_torch.ops.encode import build_fleet, group_pods

    constraints = world.manager.provisioning.workers["default"].provisioner.spec.constraints
    advertised = world.cloud.get_instance_types(constraints)
    need = group_pods(pods).vectors.max(axis=0)

    def fleet_under(book):
        set_active_book(book)
        try:
            fleet = build_fleet(advertised, constraints, [], pods_need=need)
            return fleet, _pool_price_matrix(fleet)[1]
        finally:
            set_active_book(world.book)

    risky, risky_matrix = fleet_under(world.book)
    plain, plain_matrix = fleet_under(None)
    calm_book = PriceBook(clock=world.clock)
    for tick in world.feed.ticks_after(0)[: len(world.pools)]:
        calm_book.apply(tick)
    check(not calm_book.has_risk() and world.book.has_risk(), "the calm book carries risk, or the storm's none")
    calm, calm_matrix = fleet_under(calm_book)
    check(risky.capacity_type == "spot", f"the storm's fleet is {risky.capacity_type}, not spot")
    check(same_bytes(calm.prices, plain.prices) and same_bytes(calm_matrix, plain_matrix),
          "a calm book changed the fleet's prices")
    names = [it.name for it in risky.instance_types]
    check(names == [it.name for it in plain.instance_types], "the market hook changed the fleet's types")
    risks = forecast.type_risks(names, [[z for z in it.zones() if z in risky.allowed_zones]
                                        for it in risky.instance_types], world.book)
    published = forecast.penalize_prices(plain.prices, risks)
    check(same_bytes(published, risky.prices), "build_fleet's prices differ from forecast.penalize_prices")
    got = forecast.penalize_prices_torch(torch.from_numpy(plain.prices).to(device), risks)
    plain_k10 = forecast_kernel._penalize_prices_ref(
        torch.from_numpy(plain.prices).to(device), torch.from_numpy(risks).to(device),
        forecast.RISK_PRICE_WEIGHT)
    synchronize(device)
    check(same_bytes(got.cpu().numpy(), published), "K10 differs from the numpy column")
    check(same_bytes(plain_k10.cpu().numpy(), published), "K10's plain version differs from the numpy column")
    risked = risks > 0
    check(risked.any() and (risky.prices[risked] > plain.prices[risked]).all()
          and same_bytes(risky.prices[~risked], plain.prices[~risked]),
          "the risked types' prices did not rise alone")
    pool_risk = forecast.risk_matrix(names, _pool_zones(risky), world.book) > 0
    offered = np.isfinite(plain_matrix)
    check((pool_risk & offered).any()
          and (risky_matrix[pool_risk & offered] > plain_matrix[pool_risk & offered]).all()
          and same_bytes(risky_matrix[~pool_risk], plain_matrix[~pool_risk])
          and np.array_equal(np.isinf(risky_matrix), ~offered),
          "the risked pools' [T, Z] entries did not rise alone")
    return {"types": len(names), "risked_types": int(risked.sum()),
            "risked_pools": int((pool_risk & offered).sum()), "prices": plain.prices, "risks": risks,
            "max_abs_err": float(np.abs(got.cpu().numpy() - published).max())}


def run_storm(device, solver_name: str, *, num_pods: int = NUM_PODS, num_types: int = NUM_TYPES,
              reprice_pass=STORM_REPRICE_PASS, market_pools=None, tripwire: bool = True,
              profile_pass=None, stop_after=None) -> dict:
    """The storm through the port's Manager on `device`, on pods made anew
    (a bind writes into the stored pod): the market folded,
    the risky pools' interruptions noted, a provisioner applied, every pod
    applied and reconciled by selection (as tests/harness.Harness.provision
    does), then worker passes until the backlog drains, the market
    repricing just before pass `reprice_pass`. Each pass: its time, the
    fleet arrays it uploaded (device_resident's misses), whether the
    incremental encode's fast path took it, and the K10 tripwire on every
    [T] column build_fleet published in it. Pass `profile_pass` runs under
    torch.profiler (profile_call); the drain stops after pass `stop_after`."""
    import threading
    from collections import Counter

    import torch

    from karpenter_tpu_torch.api import provisioner as provisioner_module
    from karpenter_tpu_torch.api import requirements as requirements_module
    from karpenter_tpu_torch.api import wellknown
    from karpenter_tpu_torch.market import forecast
    from karpenter_tpu_torch.market.pricebook import set_active_book
    from karpenter_tpu_torch.ops import encode, forecast_kernel, pack_kernel

    k10_start = forecast_kernel.penalize_prices.launches
    pods, catalog = storm_workload(num_pods, num_types)
    world = storm_world(catalog, device, solver_name)
    manager, cluster, book = world.manager, world.cluster, world.book
    cluster.apply_provisioner(spot_provisioner(provisioner_module, requirements_module, wellknown))
    manager.provisioning.reconcile("default")
    constraints = manager.provisioning.workers["default"].provisioner.spec.constraints
    if market_pools is None:
        fleet = encode.build_fleet(world.cloud.get_instance_types(constraints), constraints, [],
                                   pods_need=encode.group_pods(pods).vectors.max(axis=0))
        risky_pools = cheapest_spot_pools(fleet, STORM_RISKY_POOLS)
        spike_pools = cheapest_spot_pools(fleet, STORM_SPIKE_POOLS, skip=set(risky_pools))
    else:
        risky_pools, spike_pools = market_pools
    for pool in risky_pools:
        book.note_interruption(pool)
    prices = storm_price_checks(world, pods, device) if tripwire else None

    binds = Counter()
    bind_times = []
    lock = threading.Lock()

    def on_delta(verb, kind, obj):
        if verb == "bind" and kind == "pod":
            stamp = time.perf_counter()
            with lock:
                binds[obj.uid] += 1
                bind_times.append(stamp)

    cluster.watch_deltas(on_delta)
    start = time.perf_counter()
    for pod in pods:
        cluster.apply_pod(pod)
        manager.selection.reconcile(pod.namespace, pod.name)
    select_s = time.perf_counter() - start

    fast_path = []
    original_encode = manager.cluster_state.encode_schedule

    def encode_schedule(*args, **kwargs):
        encoded = original_encode(*args, **kwargs)
        fast_path.append(encoded is not None)
        return encoded

    manager.cluster_state.encode_schedule = encode_schedule
    columns = []
    original_penalize = forecast.penalize_prices

    def penalize_prices(prices_col, risks):
        out = original_penalize(prices_col, risks)
        columns.append((prices_col.copy(), risks.copy(), out.copy()))
        return out

    forecast.penalize_prices = penalize_prices
    from karpenter_tpu_torch.controllers import provisioning

    stages = {"schedule": provisioning.SCHEDULING_DURATION, "solve": provisioning.SOLVE_DURATION,
              "bind": provisioning.BIND_DURATION}
    stage_start = {name: hist._sums.get((), 0.0) for name, hist in stages.items()}
    passes = []
    reprices = []
    nodes_seen = set()
    cost_per_hr = 0.0
    k10_err = 0.0
    profiled = None
    drain_start = time.perf_counter()
    try:
        while manager.provisioning.workers["default"].queue_depth() and len(passes) != stop_after:
            index = len(passes) + 1
            if index == reprice_pass:
                world.feed.force_spike(spike_pools, STORM_SPIKE_FACTOR)
                world.clock.advance(world.feed.tick_interval_s)
                generation = book.generation
                requeues = manager.reprice_requeues
                manager.market.reconcile()
                reprices.append((book.generation - generation, manager.reprice_requeues - requeues))
            del columns[:]
            uploads = pack_kernel.device_resident.uploads
            encodes = len(fast_path)
            if index == profile_pass:
                profiled = profile_call(manager.provisioning.workers["default"].provision)
                stats, pass_ms = profiled["result"], profiled["wall_ms"]
            else:
                t0 = time.perf_counter()
                stats = manager.provisioning.workers["default"].provision()
                synchronize(device)
                pass_ms = (time.perf_counter() - t0) * 1e3
            price_of = {(it.name, o.zone, o.capacity_type): o.price
                        for it in world.cloud.get_instance_types() for o in it.offerings}
            for node in cluster.list_nodes():
                if node.name not in nodes_seen:
                    nodes_seen.add(node.name)
                    cost_per_hr += price_of[(node.instance_type, node.zone, node.capacity_type)]
            if tripwire:
                for prices_col, risks, published in columns:
                    got = forecast.penalize_prices_torch(torch.from_numpy(prices_col).to(device), risks)
                    synchronize(device)
                    check(same_bytes(got.cpu().numpy(), published),
                          f"pass {index}: K10 differs from the column build_fleet published")
                    k10_err = max(k10_err, float(np.abs(got.cpu().numpy() - published).max()))
            passes.append({
                "ms": pass_ms, "scheduled": stats.scheduled_pods, "nodes": stats.launched_nodes,
                "unschedulable": stats.unschedulable_pods, "errors": len(stats.launch_errors),
                "fleet_uploads": pack_kernel.device_resident.uploads - uploads,
                "fast_path": any(fast_path[encodes:]), "columns": len(columns),
            })
    finally:
        forecast.penalize_prices = original_penalize
        manager.cluster_state.encode_schedule = original_encode
        set_active_book(None)
    drain_s = time.perf_counter() - drain_start
    stage_ms = {name: (hist._sums.get((), 0.0) - stage_start[name]) * 1e3 / max(len(passes), 1)
                for name, hist in stages.items()}
    pods_on = Counter(p.node_name for p in cluster.list_pods() if p.node_name)
    nodes = Counter(
        (n.instance_type, n.zone, n.capacity_type, pods_on[n.name]) for n in cluster.list_nodes()
    )
    return {
        "world": world, "pods": pods, "passes": passes, "reprices": reprices, "binds": binds,
        "first_bind_s": (min(bind_times) - drain_start) if bind_times else None,
        "last_bind_s": (max(bind_times) - drain_start) if bind_times else None,
        "drain_s": drain_s, "select_s": select_s, "stage_ms": stage_ms, "nodes": nodes, "cost_per_hr": cost_per_hr,
        "market_pools": (risky_pools, spike_pools), "prices": prices, "profiled": profiled,
        "k10_launches": forecast_kernel.penalize_prices.launches - k10_start, "k10_err": k10_err,
        "bound": sum(1 for p in cluster.list_pods() if p.node_name),
    }


def storm_checks(storm, label: str) -> None:
    """Every pod bound exactly once, in full windows, with no launch error."""
    pods = storm["pods"]
    check(len(storm["binds"]) == len(pods) and set(storm["binds"].values()) == {1}
          and set(storm["binds"]) == {p.uid for p in pods} and storm["bound"] == len(pods),
          f"{label}: not every pod was bound exactly once")
    expected_passes = -(-len(pods) // STORM_WINDOW)
    check(len(storm["passes"]) == expected_passes,
          f"{label}: {len(storm['passes'])} passes, not {expected_passes}")
    check(all(p["unschedulable"] == 0 and p["errors"] == 0 for p in storm["passes"]),
          f"{label}: a pass left pods unschedulable or failed a launch")
    check(all(node[2] == "spot" for node in storm["nodes"]), f"{label}: a node bought is not spot")
    check(sum(p["scheduled"] for p in storm["passes"]) == len(pods), f"{label}: scheduled counts do not add up")


def provision_storm_phase(device) -> dict:
    """The provisioning controllers under a live spot market, through the
    port's Manager on the card: 50,000 pending pods drained in 2,000-pod
    windows by CostSolver with the host gate off, then the same storm on the
    CPU, and make_solver("ffd") (K2 in one mode) on the card and the CPU."""
    from karpenter_tpu_torch.models import solver as solver_mod
    from karpenter_tpu_torch.ops import cuda_kernels, forecast_kernel, incremental, pack_kernel, score_kernel

    os.environ["KARPENTER_HOST_SOLVE"] = "0"
    counters = (cuda_kernels.dominance_prices, pack_kernel.pack_kernel, score_kernel.lp_relax,
                pack_kernel.pack_pair_payload, forecast_kernel.penalize_prices, incremental.scatter,
                incremental.gather)
    for counter in counters:
        counter.launches = 0
    pack_kernel.reset_device_resident()
    host_before = solver_mod.SOLVE_DISPATCH_TOTAL.get("host")
    card = run_storm(device, "cost")
    pods = card["pods"]
    launches = {counter.__name__: counter.launches for counter in counters}
    storm_checks(card, "card storm")
    num_passes = len(card["passes"])
    check(all(launches[name] == num_passes
              for name in ("dominance_prices", "pack_kernel", "lp_relax", "pack_pair_payload")),
          f"the storm's {num_passes} passes did not each launch K1, K2 (with K4) and K3 once: {launches}")
    check(solver_mod.SOLVE_DISPATCH_TOTAL.get("host") == host_before, "a storm pass solved on the host")
    check(launches["penalize_prices"] == card["k10_launches"] > 0, "the storm launched no K10 tripwire")
    # The Manager's encoder reaches the card only when a pass takes the fast
    # path: its first flush there is a full upload, then one K8 launch
    # gathers the sorted view. The scatters run on later flushes (the churn
    # cell).
    check(launches["gather"] >= sum(p["fast_path"] for p in card["passes"]) > 0,
          f"the fast-path passes did not gather their groups with K8 on the card: {launches}")
    check(all(p["columns"] >= 1 for p in card["passes"]), "a pass published no penalised column")
    uploads = [p["fleet_uploads"] for p in card["passes"]]
    calm = uploads[1 : STORM_REPRICE_PASS - 1] + uploads[STORM_REPRICE_PASS:]
    check(uploads[0] >= 1 and uploads[STORM_REPRICE_PASS - 1] == 1 and not any(calm),
          f"fleet uploads a pass {uploads}: not one after the reprice and none while calm")
    (gen_bump, requeues), = card["reprices"]
    check(gen_bump >= 1 and requeues >= 1, "the mid-storm spike did not reprice and requeue")
    pass_ms = [p["ms"] for p in card["passes"]]

    cpu = run_storm("cpu", "cost", market_pools=card["market_pools"])
    storm_checks(cpu, "CPU storm")
    rel = abs(card["cost_per_hr"] - cpu["cost_per_hr"]) / cpu["cost_per_hr"]
    check(rel <= 1e-4, f"the storm's $/hr differs between the card ({card['cost_per_hr']}) "
                       f"and the CPU ({cpu['cost_per_hr']})")

    for counter in counters:
        counter.launches = 0
    fallbacks = solver_mod.TPUSolver.host_fallbacks
    ffd_card = run_storm(device, "ffd", market_pools=card["market_pools"], tripwire=False)
    ffd_launches = {counter.__name__: counter.launches for counter in counters}
    storm_checks(ffd_card, "ffd storm")
    check(solver_mod.TPUSolver.host_fallbacks == fallbacks,
          "an ffd storm pass ran out of K2's rounds and solved on the host FFD")
    check(ffd_launches["pack_kernel"] == len(ffd_card["passes"])
          and ffd_launches["dominance_prices"] == ffd_launches["lp_relax"] == 0,
          f"the ffd storm did not run K2 alone, once a pass: {ffd_launches}")
    ffd_cpu = run_storm("cpu", "ffd", market_pools=card["market_pools"], tripwire=False)
    storm_checks(ffd_cpu, "CPU ffd storm")
    check(ffd_card["nodes"] == ffd_cpu["nodes"], "the ffd storm's nodes differ between the card and the CPU")
    phase(
        "provision_storm", pods=len(pods), types=NUM_TYPES, pools=len(card["world"].pools),
        window=STORM_WINDOW, passes=num_passes, host_solve_env=os.environ["KARPENTER_HOST_SOLVE"],
        device_passes=f"{launches['pack_kernel']}/{num_passes}",
        fast_path_passes=",".join(str(i + 1) for i, p in enumerate(card["passes"]) if p["fast_path"]) or "none",
        pass_p50_ms=f"{np.percentile(pass_ms, 50):.3f}", pass_max_ms=f"{max(pass_ms):.3f}",
        first_bind_s=f"{card['first_bind_s']:.3f}", last_bind_s=f"{card['last_bind_s']:.3f}",
        pods_per_s=f"{len(pods) / card['last_bind_s']:.1f}", select_s=f"{card['select_s']:.3f}",
        market_sweep_ms=f"{card['world'].sweep_ms:.3f}", ticks=card["world"].book.last_seq,
        fleet_uploads=",".join(map(str, uploads)), reprice_generations=gen_bump,
        risked_types=card["prices"]["risked_types"], risked_pools=card["prices"]["risked_pools"],
        nodes=sum(card["nodes"].values()), cost_per_hr=f"{card['cost_per_hr']:.6f}",
        cpu_cost_per_hr=f"{cpu['cost_per_hr']:.6f}", cost_rel_diff=f"{rel:.3e}",
        schedule_ms_per_pass=f"{card['stage_ms']['schedule']:.3f}",
        solve_ms_per_pass=f"{card['stage_ms']['solve']:.3f}",
        bind_ms_per_pass=f"{card['stage_ms']['bind']:.3f}",
        cpu_pass_p50_ms=f"{np.percentile([p['ms'] for p in cpu['passes']], 50):.3f}",
        ffd_nodes=sum(ffd_card["nodes"].values()), ffd_nodes_equal="yes",
        ffd_pass_p50_ms=f"{np.percentile([p['ms'] for p in ffd_card['passes']], 50):.3f}",
        k10_launches=card["k10_launches"], k2_single_launches=ffd_launches["pack_kernel"],
        k8_scatter_launches=launches["scatter"], k8_gather_launches=launches["gather"],
        ffd_host_fallbacks=solver_mod.TPUSolver.host_fallbacks - fallbacks,
        spot_nodes=f"{sum(c for k, c in card['nodes'].items() if k[2] == 'spot')}/{sum(card['nodes'].values())}",
    )
    return {"launches": launches, "k10_launches": card["k10_launches"], "k10_err": card["k10_err"],
            "prices": card["prices"], "k2_single_launches": ffd_launches["pack_kernel"],
            "market_pools": card["market_pools"], "pass_ms": pass_ms}


def storm_profile_phase(device, storm: dict) -> None:
    """The card storm again, with the same market, to its pass
    STORM_PROFILE_PASS, which runs under torch.profiler: its device time
    summed over kernels and copies against its wall time, the card's busy
    share of a storm pass."""
    profiled = run_storm(device, "cost", market_pools=storm["market_pools"], tripwire=False,
                         profile_pass=STORM_PROFILE_PASS, stop_after=STORM_PROFILE_PASS)
    busy = profiled["profiled"]
    check(len(profiled["passes"]) == STORM_PROFILE_PASS and busy is not None,
          f"the storm did not reach its pass {STORM_PROFILE_PASS} under the profiler")
    phase("storm_profile", pass_index=STORM_PROFILE_PASS, wall_ms=f"{busy['wall_ms']:.3f}",
          storm_pass_p50_ms=f"{np.percentile(storm['pass_ms'], 50):.3f}",
          device_ms=f"{busy['device_ms']:.3f}", busy_share=f"{busy['busy_share']:.4f}",
          device_launches=busy["device_launches"])
    for key, count, ms in busy["top"]:
        print(f"  device {ms:9.3f} ms  x{count:<6d} {key}")


# --- the Go-parity solver: TPUSolver(mode="ffd", quirk=True) and K2q --------

GO_PARITY_EXACT_FIT_NODES = 5  # tests/test_pack_kernel.py:60: the quirk's node count


def fixture_pods(count: int, cpu: str = "1", memory: str = "512Mi", prefix: str = "fixture"):
    """tests/fixtures.pods in the port's types: `count` pending pods of one
    shape."""
    from karpenter_tpu_torch.api.pods import PodSpec

    return [PodSpec(name=f"{prefix}-{i}", requests={"cpu": cpu, "memory": memory}, unschedulable=True)
            for i in range(count)]


def fixture_instance(name: str, cpu: float, mem_gib: float, price=None):
    """tests/fixtures.cpu_instance in the port's types: 110 pods, three test
    zones, on-demand at `price` (0.05 a core by default) and spot at 0.7 of
    it."""
    from karpenter_tpu_torch.cloudprovider import InstanceType, Offering

    price = cpu * 0.05 if price is None else price
    offerings = []
    for zone in ("test-zone-1", "test-zone-2", "test-zone-3"):
        offerings.append(Offering(zone=zone, capacity_type="on-demand", price=price))
        offerings.append(Offering(zone=zone, capacity_type="spot", price=price * 0.7))
    return InstanceType(name=name, capacity={"cpu": cpu, "memory": f"{mem_gib}Gi", "pods": 110},
                        architecture="amd64", offerings=offerings)


def fixture_ladder(count: int):
    """tests/fixtures.size_ladder: `count` types growing linearly in size
    and price."""
    return [fixture_instance(f"ladder-{i + 1}", 2 * (i + 1), 4 * (i + 1), 0.05 * (i + 1))
            for i in range(count)]


def go_parity_cases():
    """The reference's parity shapes (tests/test_pack_kernel.py:42-62):
    (name, pods, catalog). The last is the quirk's exact-fit case: a 1.5-pod
    pairs with a 0.5-pod on a 2-core node (karpenter_tpu/ops/
    pack_kernel.py:184-193)."""
    return [
        ("homogeneous", fixture_pods(100, prefix="homogeneous"), [fixture_instance("only", 16, 64)]),
        ("size_ladder", fixture_pods(50, prefix="ladder"), fixture_ladder(10)),
        ("mixed_shapes", fixture_pods(40, "1500m", "1Gi", "mixed-a") + fixture_pods(40, "500m", "3Gi", "mixed-b")
         + fixture_pods(7, "4", "8Gi", "mixed-c"), fixture_ladder(8)),
        ("exact_fit", fixture_pods(4, "1500m", prefix="exact-a") + fixture_pods(4, "500m", prefix="exact-b"),
         [fixture_instance("two", 2, 8)]),
    ]


def go_parity_signature(result):
    """What the reference's parity test compares (tests/test_pack_kernel.py:
    13-40), as JSON-ready lists: the canonical node list (each node's first
    instance option and its pods' sorted (cpu, memory)), the unschedulable
    pods' names, and each packing's instance options."""
    nodes = []
    for packing in result.packings:
        head = packing.instance_type_options[0].name
        for node_pods in packing.pods_per_node:
            nodes.append([head, sorted([p.requests["cpu"], p.requests["memory"]] for p in node_pods)])
    return {
        "nodes": sorted(nodes),
        "unschedulable": sorted(p.name for p in result.unschedulable),
        "options": sorted([it.name for it in p.instance_type_options] for p in result.packings),
    }


def greedy_signature(num_pods: int = NUM_PODS, num_types: int = NUM_TYPES) -> dict:
    """GreedySolver (the host FFD oracle) on the main path's workload. It
    takes about a minute at 50,000 pods, so chip_smoke runs it in a process
    of its own while the card works (`chip_smoke.py --greedy-signature`)."""
    from karpenter_tpu_torch.api.provisioner import Constraints
    from karpenter_tpu_torch.models.solver import GreedySolver

    pods, catalog = make_workload(num_pods, num_types)
    return go_parity_signature(GreedySolver().solve(pods, catalog, Constraints()))


def encoded_problem(pods, catalog):
    """The six padded dense inputs K2 takes for one schedule, as TPUSolver
    builds them (group_pods, build_fleet, pad_kernel_args)."""
    from karpenter_tpu_torch.api.provisioner import Constraints
    from karpenter_tpu_torch.models import solver
    from karpenter_tpu_torch.models.solver import _groups_need
    from karpenter_tpu_torch.ops.encode import build_fleet, group_pods

    groups = group_pods(list(pods))
    fleet = build_fleet(catalog, Constraints(), pods, (), pods_need=_groups_need(groups))
    return solver.pad_kernel_args(groups.vectors, groups.counts, fleet.capacity, fleet.total, fleet.prices)


def k2q_cases(main_problem):
    """K2q's cases, (label, six numpy inputs, modes): the reference's four
    parity shapes (the exact-fit 1.5-pod then 0.5-pod case among them),
    random problems over the launch plans (one and two types a thread, a
    ragged last warp, the fills in shared memory and in global scratch), the
    main path's encoded problem (G 16, T 512), padded G 2,048 (the fills in
    global scratch) and padded G 8,192 (the tables too), the last two in ffd
    mode alone."""
    cases = [(name, encoded_problem(pods, catalog), ("ffd", "cost")) for name, pods, catalog in go_parity_cases()]
    rng = np.random.default_rng(29)
    for g, t in ((8, 8), (16, 64), (16, 300), (32, 512), (64, 1024), (64, 2048)):
        for seed in range(2):
            cases.append((f"random G{g} T{t} #{seed}", random_pack_problem(rng, g, t), ("ffd", "cost")))
    cases.append(("main path", main_problem, ("ffd", "cost")))
    cases.append(("G 2048", sparse_pack_problem(3, 2048, 512, 200), ("ffd",)))
    cases.append(("G 8192", sparse_pack_problem(4, 8192, 64, 40), ("ffd",)))
    return cases


def go_parity_phase(device, greedy) -> dict:
    """TPUSolver(mode="ffd", quirk=True) on the card against GreedySolver,
    node for node, on the main path's workload (`greedy` is its signature,
    computed in a process of its own) and on the reference's four parity
    shapes; K2q launched once a solve and no solve sent to the host FFD."""
    from karpenter_tpu_torch.api.provisioner import Constraints
    from karpenter_tpu_torch.models.solver import GreedySolver, TPUSolver
    from karpenter_tpu_torch.ops import pack_kernel

    fallbacks = TPUSolver.host_fallbacks
    tpu = TPUSolver(mode="ffd", quirk=True, device=device)
    pods, catalog = make_workload()
    pack_kernel.pack_kernel.quirk_launches = 0
    synchronize(device)
    start = time.perf_counter()
    result = tpu.solve(pods, catalog, Constraints())
    solve_ms = (time.perf_counter() - start) * 1e3
    launches = pack_kernel.pack_kernel.quirk_launches
    check(launches == 1, f"the Go-parity solve launched K2q {launches} times, not once")
    check(go_parity_signature(result) == greedy,
          "TPUSolver(mode='ffd', quirk=True) differs from GreedySolver on the main path's 50,000 pods")
    shapes = []
    for name, case_pods, case_catalog in go_parity_cases():
        got = tpu.solve(case_pods, case_catalog, Constraints())
        want = GreedySolver().solve(case_pods, case_catalog, Constraints())
        check(go_parity_signature(got) == go_parity_signature(want),
              f"TPUSolver(mode='ffd', quirk=True) differs from GreedySolver on {name}")
        shapes.append(f"{name}:{got.node_count}")
        if name == "exact_fit":
            check(got.node_count == GO_PARITY_EXACT_FIT_NODES,
                  f"the exact-fit case took {got.node_count} nodes, not the quirk's {GO_PARITY_EXACT_FIT_NODES}")
    launches = pack_kernel.pack_kernel.quirk_launches
    check(launches == 1 + len(shapes), f"the Go-parity solves launched K2q {launches} times")
    check(TPUSolver.host_fallbacks == fallbacks, "a Go-parity solve ran out of K2's rounds and took the host FFD")
    phase("go_parity", pods=len(pods), types=len(catalog), nodes=result.node_count,
          unschedulable=len(result.unschedulable), solve_ms=f"{solve_ms:.3f}", shapes=",".join(shapes),
          k2q_launches=launches, host_fallbacks=TPUSolver.host_fallbacks - fallbacks, greedy="identical")
    return {"launches": launches, "solve_ms": solve_ms}


# --- the controller process: cmd/controller.main on the card ---------------

CONTROLLER_CLOUD = "chip-smoke-storm"  # the factory chip_smoke registers for the storm's cloud
# The controller process's storm: half the by-hand storm's 50,000 pods. Its
# threaded loops and the kubelets' O(nodes x pods) join set its time (a
# 50,000-pod storm bought 3,339-10,629 nodes and joined them in 69-383 s),
# and it runs beside phases 3-10d, so at full depth the script waited on it
# (about 650 s in all with the build, against 600 at half depth); the
# by-hand storm keeps the full 50,000.
CONTROLLER_PODS = 25_000
CONTROLLER_DELETE_FRACTION = 0.4  # of the bound pods, deleted before consolidation
CONTROLLER_DELETE_SEED = 23
CONTROLLER_MAX_DISRUPTION = 32  # consolidation actions in flight (and the fleet's budget)
# Consolidation runs this long; then the fleet's disruption budget goes to
# 0 (no new voluntary disruption, as --disruption-budget 0 would set it)
# and the in-flight actions finish. With 40% of 50,000 pods gone the sweeps
# find work for far longer than a run can watch.
CONTROLLER_WATCH_S = 30.0
# The market sweep's cadence: the EC2 provider's own default (karpenter_tpu/
# cloudprovider/ec2/__init__.py:360). The fake provider's 1 s folds the 1,200
# pools' ticks and, on a reprice, requeues provisioning, consolidation and
# drift every second, which at 50,000 pods starves the storm's passes of the
# interpreter.
CONTROLLER_MARKET_POLL_S = 15.0
# Selection's reconcile threads. Under the interpreter lock more threads buy
# nothing (the reference's note at karpenter_tpu/runtime.py:711-719): at
# 50,000 pods the default 8 convoy on the store's lock with the bind
# fan-out and the O(cluster) counter and metrics reconciles
# (run_controller("cpu") at full width, selection_concurrency 1 against 8:
# PERF.md).
CONTROLLER_SELECTION_CONCURRENCY = 1
# The node-lifecycle sweeps, once the storm's kubelets have joined: a spot
# interruption (EC2's two-minute notice) on a seeded handful of the storm's
# nodes, one kubelet whose heartbeat stops, one pod bound to a node that
# never existed (podgc's orphan) and one owned instance no node accounts for
# (instancegc's leak), all at once.
CONTROLLER_INTERRUPTED_NODES = 8
CONTROLLER_LIFECYCLE_SEED = 31
CONTROLLER_INTERRUPTION_DEADLINE_S = 120.0
# Every joined kubelet heartbeats this often; a node unheard for
# --node-unreachable-timeout is stale (kube's node-monitor-grace-period is
# 40 s), and the health sweep escalates it after 3 stale sightings 2 s apart.
CONTROLLER_HEARTBEAT_S = 10.0
CONTROLLER_UNREACHABLE_S = 40.0
CONTROLLER_LIFECYCLE_TIMEOUT_S = 180.0


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def http_get(url: str, timeout: float = 5.0):
    """(status, body) of one GET; (None, b"") when nothing listens."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout) as response:
            return response.status, response.read()
    except urllib.error.HTTPError as error:
        return error.code, error.read()
    except OSError:
        return None, b""


def parse_exposition(text: str) -> int:
    """Every non-comment line of a /metrics page is `name[{labels}] value`
    (the reference's tests/test_runtime.py _parse_exposition); the series
    count."""
    import re

    series = 0
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        match = re.fullmatch(
            r'([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(?:[a-zA-Z_][a-zA-Z0-9_]*='
            r'"(?:[^"\\\n]|\\.)*",?)*\})? ([0-9eE+.\-naif]+)',
            line,
        )
        check(match is not None, f"malformed exposition line: {line!r}")
        series += 1
    return series


def wait_for(condition, timeout_s: float, poll_s: float = 0.05) -> bool:
    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        if condition():
            return True
        time.sleep(poll_s)
    return bool(condition())


def fleet_cost(cluster, price_of) -> float:
    """$/hr of the live nodes at the prices in `price_of`."""
    return sum(price_of[(n.instance_type, n.zone, n.capacity_type)]
               for n in cluster.list_nodes() if n.deletion_timestamp is None)


class ControllerProbe:
    """What both controller phases record around the controller's loops, put
    in by `install` and taken out by `remove`: each provisioning pass the
    batch loop runs (its start, its wall time, its solve stage from the
    controller's own histogram, the pods it scheduled) and each consolidation
    sweep's counterfactual solve (its problem, its start, its time, the K7
    launches it made). `counts` reads the solve routes' and the kernels'
    counters and `since` their change from an earlier reading; `stages` the
    provisioning stages' histograms; `await_ready` checks the boot."""

    def __init__(self):
        self.passes, self.sweeps = [], []
        self.originals = None

    def install(self) -> None:
        from karpenter_tpu_torch.controllers import provisioning
        from karpenter_tpu_torch.ops import consolidate, consolidate_kernel

        provision, candidates = self.originals = (provisioning.ProvisionerWorker.provision,
                                                  consolidate.solve_candidates)

        def timed_provision(worker):
            solve_before = provisioning.SOLVE_DURATION._sums.get((), 0.0)
            start = time.perf_counter()
            stats = provision(worker)
            self.passes.append({"at": start, "ms": (time.perf_counter() - start) * 1e3,
                                "solve_ms": (provisioning.SOLVE_DURATION._sums.get((), 0.0) - solve_before) * 1e3,
                                "scheduled": stats.scheduled_pods})
            return stats

        def timed_candidates(problem, device=None):
            launched = consolidate_kernel.solve_counterfactuals.launches
            start = time.perf_counter()
            verdicts = candidates(problem, device=device)
            self.sweeps.append({"problem": problem, "at": start, "ms": (time.perf_counter() - start) * 1e3,
                                "k7": consolidate_kernel.solve_counterfactuals.launches - launched})
            return verdicts

        provisioning.ProvisionerWorker.provision = timed_provision
        consolidate.solve_candidates = timed_candidates

    def remove(self) -> None:
        from karpenter_tpu_torch.controllers import provisioning
        from karpenter_tpu_torch.ops import consolidate

        if self.originals is not None:
            provisioning.ProvisionerWorker.provision, consolidate.solve_candidates = self.originals
            self.originals = None

    @staticmethod
    def counts() -> dict:
        from karpenter_tpu_torch.models import solver as solver_mod

        return {"launches": kernel_launches(), "device": solver_mod.SOLVE_DISPATCH_TOTAL.get("device"),
                "host": solver_mod.SOLVE_DISPATCH_TOTAL.get("host")}

    @staticmethod
    def since(before: dict) -> dict:
        now = ControllerProbe.counts()
        return {"launches": {name: count - before["launches"][name] for name, count in now["launches"].items()},
                "device": now["device"] - before["device"], "host": now["host"] - before["host"]}

    @staticmethod
    def stages() -> dict:
        """Each provisioning stage's summed seconds and its count."""
        from karpenter_tpu_torch.controllers import provisioning

        return {name: (hist._sums.get((), 0.0), hist.count())
                for name, hist in (("schedule", provisioning.SCHEDULING_DURATION),
                                   ("solve", provisioning.SOLVE_DURATION),
                                   ("bind", provisioning.BIND_DURATION))}

    @staticmethod
    def await_ready(manager, timeout_s: float = 300.0) -> None:
        """The warmup ends without error; on the card the host solve route
        is closed."""
        check(wait_for(lambda: manager.ready.is_set() or manager.warmup_error is not None, timeout_s)
              and manager.warmup_error is None,
              f"the controller never became ready (warmup error: {manager.warmup_error!r})")
        check(manager.solver.device.type == "cpu" or not manager.solver.host_fallback_available(),
              "the host solve route is open on the card by default")


def run_controller(device, *, num_pods: int = NUM_PODS, num_types: int = NUM_TYPES,
                   delete_fraction: float = CONTROLLER_DELETE_FRACTION,
                   max_disruption: int = CONTROLLER_MAX_DISRUPTION, watch_s: float = CONTROLLER_WATCH_S,
                   market_poll_s: float = CONTROLLER_MARKET_POLL_S,
                   selection_concurrency: int = CONTROLLER_SELECTION_CONCURRENCY,
                   storm_timeout_s: float = 600.0, settle_timeout_s: float = 240.0) -> dict:
    """The controller process through its entry point: cmd/controller.main
    with the cost solver, leader election on the in-memory lease, the storm's
    fake cloud (registered as a provider factory, with a seeded market feed
    over every spot pool) and the metrics and probe ports on free loopback
    ports. Then, through the threaded loops alone: the storm (the spot-only
    provisioner, `num_pods` pods applied, a spike on eight pools once half
    are bound), the nodes' kubelets joining, a seeded `delete_fraction` of
    the pods deleted, consolidation and termination until the cluster
    settles (consolidation runs `watch_s` seconds, then the disruption budget
    is set to 0 and the in-flight actions finish), the HTTP endpoints, and
    the stop. `device` None is the card. It prints a line after the boot,
    the storm and consolidation.
    Returns the measurements; the checks that need no card are made here."""
    import threading
    from collections import Counter

    from karpenter_tpu_torch.api import provisioner as provisioner_module
    from karpenter_tpu_torch.api import requirements as requirements_module
    from karpenter_tpu_torch.api import wellknown
    from karpenter_tpu_torch.cloudprovider import registry
    from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider
    from karpenter_tpu_torch.cmd import controller
    from karpenter_tpu_torch.controllers import consolidation as consolidation_mod
    from karpenter_tpu_torch.controllers.cluster import Cluster
    from karpenter_tpu_torch.market.feed import MarketFeed, catalog_pools
    from karpenter_tpu_torch.market.pricebook import set_active_book
    from karpenter_tpu_torch.models import solver as solver_mod
    from karpenter_tpu_torch.models import warmup
    from karpenter_tpu_torch.ops import encode
    from karpenter_tpu_torch import runtime as port_runtime
    from karpenter_tpu_torch.runtime import RECONCILE_TOTAL

    pods, catalog = storm_workload(num_pods, num_types)
    world = {}

    def storm_cloud():
        cloud = FakeCloudProvider(instance_types=catalog)
        feed = MarketFeed(catalog_pools(catalog), seed=STORM_FEED_SEED)
        cloud.attach_market_feed(feed)
        world.update(cloud=cloud, feed=feed)
        return cloud

    registry.register_factory(CONTROLLER_CLOUD, storm_cloud)
    metrics_port, probe_port = free_port(), free_port()
    while probe_port == metrics_port:
        probe_port = free_port()
    probe = f"http://127.0.0.1:{probe_port}"
    metrics = f"http://127.0.0.1:{metrics_port}"
    argv = [
        "--cluster-name", "chip-smoke", "--solver", "cost", "--cloud-provider", CONTROLLER_CLOUD,
        "--metrics-port", str(metrics_port), "--health-probe-port", str(probe_port),
        "--consolidation-cooldown", "1", "--consolidation-max-disruption", str(max_disruption),
        "--disruption-budget", str(max_disruption), "--market-poll-interval", str(market_poll_s),
        "--selection-concurrency", str(selection_concurrency),
        "--node-unreachable-timeout", str(CONTROLLER_UNREACHABLE_S),
    ]

    probe_loops = ControllerProbe()
    passes, sweeps = probe_loops.passes, probe_loops.sweeps
    readyz = []
    polling = threading.Event()
    polling.set()
    dark = set()  # the nodes whose kubelet stopped heartbeating

    def poll_readyz():
        while polling.is_set():
            status, _ = http_get(probe + "/readyz", timeout=2.0)
            if status is not None:
                readyz.append((time.perf_counter(), status))
                if status == 200:
                    return
            time.sleep(0.02)

    probe_loops.install()
    poller = threading.Thread(target=poll_readyz, name="readyz-poll", daemon=True)
    kubelets = threading.Event()
    manager = None
    try:
        poller.start()
        boot = time.perf_counter()
        manager = controller.main(argv, cluster=Cluster(), block=False, device=device)
        main_s = time.perf_counter() - boot
        healthz, _ = http_get(probe + "/healthz")
        check(healthz == 200, f"/healthz answered {healthz} right after boot, not 200")
        # Alone (--phase controller) the warmup builds every kernel (~90 s).
        ControllerProbe.await_ready(manager)
        poller.join(timeout=10.0)
        polling.clear()
        statuses = [status for _, status in readyz]
        check(statuses and statuses[-1] == 200 and 503 in statuses and set(statuses) <= {503, 200},
              f"/readyz did not answer 503 before the warmup ended and 200 after: {sorted(set(statuses))}")
        ready_s = readyz[-1][0] - boot
        check(warmup.WARMUP_RUNG_FAILURES.get() == 0,
              f"{warmup.WARMUP_RUNG_FAILURES.get():.0f} warmup rungs failed")
        calibration = solver_mod.break_even()
        check(calibration is not None, "the boot warmup did not calibrate the break-even")
        phase("controller_boot", main_s=f"{main_s:.3f}", ready_s=f"{ready_s:.3f}",
              warmup_s=f"{manager.warmup_s:.3f}", readyz_polls=len(statuses),
              fetch_floor_ms=f"{calibration.fetch_floor_ms:.4f}",
              host_ms_per_pod=f"{calibration.host_ms_per_pod:.6f}",
              device_compute_ms=f"{solver_mod.BREAK_EVEN_GAUGE.get('device_compute_ms'):.3f}",
              max_pods=calibration.max_pods, max_pods_batched=calibration.max_pods_batched)
        cluster, book = manager.cluster, manager.price_book
        cloud, feed = world["cloud"], world["feed"]
        check(manager.cloud is cloud, "main did not build the registered cloud")

        # The storm, through the loops alone.
        storm_before = ControllerProbe.counts()
        cluster.apply_provisioner(spot_provisioner(provisioner_module, requirements_module, wellknown))
        check(wait_for(lambda: manager.provisioning.worker("default") is not None, 30.0),
              "the provisioning loop never reconciled the provisioner")
        constraints = manager.provisioning.worker("default").provisioner.spec.constraints
        fleet = encode.build_fleet(cloud.get_instance_types(constraints), constraints, [],
                                   pods_need=encode.group_pods(pods).vectors.max(axis=0))
        risky_pools = cheapest_spot_pools(fleet, STORM_RISKY_POOLS)
        spike_pools = cheapest_spot_pools(fleet, STORM_SPIKE_POOLS, skip=set(risky_pools))
        for pool in risky_pools:
            book.note_interruption(pool)
        binds = Counter()
        bind_times = {}
        reschedules = Counter()
        lock = threading.Lock()

        def on_delta(verb, kind, obj):
            if kind != "pod" or verb not in ("bind", "reschedule"):
                return
            stamp = time.perf_counter()
            with lock:
                if verb == "bind":
                    binds[obj.uid] += 1
                    bind_times.setdefault(obj.uid, []).append(stamp)
                else:
                    reschedules[obj.uid] += 1

        cluster.watch_deltas(on_delta)
        # The first window arrives alone: its pass is the first solve after
        # /readyz (the reference's test_first_solve_after_ready_is_steady_
        # state); the rest of the storm follows it.
        storm_start = time.perf_counter()
        for pod in pods[:STORM_WINDOW]:
            cluster.apply_pod(pod)
        check(wait_for(lambda: len(binds) >= min(STORM_WINDOW, len(pods)), storm_timeout_s),
              "the first window was not bound")
        window_s = time.perf_counter() - storm_start
        for pod in pods[STORM_WINDOW:]:
            cluster.apply_pod(pod)
        applied_s = time.perf_counter() - storm_start
        check(wait_for(lambda: len(binds) >= len(pods) // 2, storm_timeout_s),
              f"the storm bound {len(binds)} of {len(pods)} pods")
        half_s = time.perf_counter() - storm_start
        generation = book.generation
        requeues = manager.reprice_requeues
        feed.force_spike(spike_pools, STORM_SPIKE_FACTOR)

        def scheduled():
            return sum(p["scheduled"] for p in passes if p["at"] >= storm_start)

        check(wait_for(lambda: len(binds) >= len(pods) and scheduled() >= len(pods), storm_timeout_s),
              f"the storm bound {len(binds)} of {len(pods)} pods, its passes scheduled {scheduled()}, "
              f"failed passes {dict((k, v) for k, v in port_runtime.SWEEP_FAILURES_TOTAL._values.items())}")
        check(wait_for(lambda: book.generation > generation and manager.reprice_requeues > requeues, 30.0),
              "the market loop did not fold the spike into a reprice")
        storm_end = time.perf_counter()
        uids = {p.uid for p in pods}
        check(set(binds) == uids and set(binds.values()) == {1} and not reschedules,
              "the storm did not bind every pod exactly once")
        storm_passes = [p for p in passes if storm_start <= p["at"] < storm_end and p["scheduled"]]
        storm_counts = ControllerProbe.since(storm_before)
        storm_launches, device_solves, host_solves = (storm_counts[key] for key in ("launches", "device", "host"))
        check(host_solves == 0, f"{host_solves:.0f} solves took the host path after the controller was ready")
        check(sum(p["scheduled"] for p in storm_passes) == len(pods),
              f"the storm's passes scheduled {sum(p['scheduled'] for p in storm_passes)} of {len(pods)} pods")
        check(len(storm_passes) >= 2, "the storm took fewer than two passes")
        warm_solve = float(np.percentile([p["solve_ms"] for p in storm_passes[1:]], 50))
        first_solve = storm_passes[0]["solve_ms"]
        check(first_solve <= 2.0 * warm_solve,
              f"the first solve after /readyz took {first_solve:.1f} ms against a warm p50 of {warm_solve:.1f} ms")
        first_bind = min(t[0] for t in bind_times.values()) - storm_start
        last_bind = max(t[0] for t in bind_times.values()) - storm_start
        phase("controller_storm", pods=len(pods), passes=len(storm_passes), window_s=f"{window_s:.3f}",
              applied_s=f"{applied_s:.3f}", half_bound_s=f"{half_s:.3f}", first_bind_s=f"{first_bind:.3f}",
              last_bind_s=f"{last_bind:.3f}", first_solve_ms=f"{first_solve:.3f}",
              warm_solve_p50_ms=f"{warm_solve:.3f}", device_solves=int(device_solves),
              launches=json.dumps(storm_launches, separators=(",", ":")))

        # The kubelets join: every node reports ready (the node loop strips
        # the not-ready taint). A joined kubelet then heartbeats every
        # CONTROLLER_HEARTBEAT_S from a thread of its own, so that a join
        # wave slowed by the node loop's O(pods) ready edges (thousands of
        # nodes) never starves the heartbeats of the nodes already joined;
        # the kubelets gone dark stop.
        heard = {}

        def join():
            while kubelets.is_set():
                for node in cluster.list_nodes():
                    if not node.ready and node.deletion_timestamp is None and node.name not in dark:
                        cluster.heartbeat_node(node.name, ready=True)
                        heard[node.name] = time.perf_counter()
                time.sleep(0.2)

        def heartbeat():
            while kubelets.is_set():
                now = time.perf_counter()
                for name, last in list(heard.items()):
                    if name in dark or now - last < CONTROLLER_HEARTBEAT_S:
                        continue
                    if cluster.heartbeat_node(name, ready=True) is None:
                        heard.pop(name, None)
                    else:
                        heard[name] = now
                time.sleep(0.2)

        kubelets.set()
        threading.Thread(target=join, name="kubelets", daemon=True).start()
        threading.Thread(target=heartbeat, name="kubelet-heartbeats", daemon=True).start()

        def not_joined():
            return [n for n in cluster.list_nodes()
                    if not n.ready or any(t.key == wellknown.NOT_READY_TAINT_KEY for t in n.taints)]

        # At 50,000 pods the node loop strips the taints slowly (each
        # node-ready edge lists every pod to stamp its bound ones): some
        # 7,400 nodes take minutes, and a slow poll keeps this walk off the
        # store's lock.
        check(wait_for(lambda: not not_joined(), 480.0, poll_s=0.5),
              f"{len(not_joined())} of {len(cluster.list_nodes())} nodes never became ready "
              f"({sum(not n.ready for n in not_joined())} of them not reported ready)")
        joined_s = time.perf_counter() - storm_end
        # The fleet's prices, read before the interruptions black their
        # pools out of the catalog.
        price_of = {(it.name, o.zone, o.capacity_type): o.price
                    for it in cloud.get_instance_types() for o in it.offerings}
        lifecycle = lifecycle_sweeps(manager, cloud, binds, reschedules, lock, dark)

        # Consolidation: a seeded share of the pods goes away.
        nodes_before = len(cluster.list_nodes())
        cost_before = fleet_cost(cluster, price_of)
        rng = np.random.default_rng(CONTROLLER_DELETE_SEED)
        doomed = set(rng.choice(len(pods), int(delete_fraction * len(pods)), replace=False).tolist())
        remaining = [pod for i, pod in enumerate(pods) if i not in doomed]
        remaining_uids = {pod.uid for pod in remaining}
        sweeps_before = sum(RECONCILE_TOTAL.get("consolidation", r) for r in ("success", "requeue", "error"))
        actions_before = {kind: consolidation_mod.CONSOLIDATION_ACTIONS_TOTAL.get(kind, "executed")
                          for kind in ("delete", "replace")}
        consolidation_before = ControllerProbe.counts()
        consolidation_start = time.perf_counter()
        for i in sorted(doomed):
            cluster.delete_pod(pods[i].namespace, pods[i].name)
        manager.loops["consolidation"].enqueue("sweep")
        claim_keys = (wellknown.CONSOLIDATION_ACTION_ANNOTATION, wellknown.DRIFT_ACTION_ANNOTATION)

        def executed():
            return sum(consolidation_mod.CONSOLIDATION_ACTIONS_TOTAL.get(kind, "executed") - actions_before[kind]
                       for kind in actions_before)

        check(wait_for(lambda: executed() > 0, settle_timeout_s),
              "the consolidation loop executed no action")
        time.sleep(max(0.0, watch_s - (time.perf_counter() - consolidation_start)))
        manager.disruption_ledger.budget = 0
        stopped_at = time.perf_counter()

        def settled():
            live = {n.name for n in cluster.list_nodes()
                    if n.deletion_timestamp is None and not any(k in n.annotations for k in claim_keys)}
            if len(live) != len(cluster.list_nodes()):
                return False
            with lock:
                # Every move of a remaining pod is followed by its bind.
                if any(binds[uid] != 1 + reschedules[uid] for uid in remaining_uids):
                    return False
            return all(getattr(cluster.try_get_pod(p.namespace, p.name), "node_name", None) in live
                       for p in remaining)

        def unsettled():
            nodes = cluster.list_nodes()
            live = {n.name for n in nodes if n.deletion_timestamp is None}
            stored = [cluster.try_get_pod(p.namespace, p.name) for p in remaining]
            with lock:
                bound_twice = sum(1 for uid in remaining_uids if binds[uid] > 1 + reschedules[uid])
                unbound_moves = sum(1 for uid in remaining_uids if binds[uid] < 1 + reschedules[uid])
            return {
                "claimed": sum(1 for n in nodes if any(k in n.annotations for k in claim_keys)),
                "deleting": len(nodes) - len(live),
                "gone": sum(1 for pod in stored if pod is None),
                "terminating": sum(1 for pod in stored if pod is not None and pod.deletion_timestamp is not None),
                "pending": sum(1 for pod in stored if pod is not None and pod.node_name is None),
                "on_dead_nodes": sum(1 for pod in stored
                                     if pod is not None and pod.node_name and pod.node_name not in live),
                "moves_not_rebound": unbound_moves,
                "bound_without_a_move": bound_twice,
            }

        check(wait_for(settled, settle_timeout_s, poll_s=0.2),
              f"consolidation did not settle after the budget went to 0: {executed():.0f} actions executed, "
              f"{unsettled()}")
        settle_s = time.perf_counter() - stopped_at
        consolidation_launches = ControllerProbe.since(consolidation_before)["launches"]
        live_nodes = {n.name for n in cluster.list_nodes()}
        check(all(getattr(cluster.try_get_pod(p.namespace, p.name), "node_name", None) in live_nodes
                  for p in remaining)
              and len(cluster.list_pods()) == len(remaining),
              "not every remaining pod is bound to a live node exactly once")
        with lock:
            moved = {uid: count for uid, count in reschedules.items() if uid in remaining_uids}
            rebind_times = [t for uid in moved for t in bind_times[uid] if t >= consolidation_start]
            check(all(binds[uid] == 1 + reschedules[uid] for uid in remaining_uids),
                  "a pod was bound again without being evicted first")
        cost_after = fleet_cost(cluster, price_of)
        check(cost_after < cost_before, f"consolidation did not lower the fleet's $/hr: {cost_before} -> {cost_after}")
        swept = [sweep for sweep in sweeps if sweep["at"] >= consolidation_start]
        check(swept, "no consolidation sweep solved its counterfactuals")
        actions = {kind: consolidation_mod.CONSOLIDATION_ACTIONS_TOTAL.get(kind, "executed") - actions_before[kind]
                   for kind in actions_before}
        phase("controller_consolidation", joined_s=f"{joined_s:.3f}", deleted=len(doomed), actions=json.dumps(actions),
              solve_candidates=len(swept), evicted=len(moved), settle_s=f"{settle_s:.3f}",
              cost_before=f"{cost_before:.6f}", cost_after=f"{cost_after:.6f}",
              nodes=f"{nodes_before}->{len(live_nodes)}")

        # The HTTP surface.
        status, body = http_get(metrics + "/metrics")
        check(status == 200, f"/metrics answered {status}")
        series = parse_exposition(body.decode())
        status, body = http_get(metrics + "/debug/stacks", timeout=10.0)
        check(status == 200, f"/debug/stacks answered {status}")
        profile_samples = json.loads(body)["profile_samples"]
        check(profile_samples > 0, "/debug/stacks took no profile sample")
        sweep_count = sum(RECONCILE_TOTAL.get("consolidation", r) for r in ("success", "requeue", "error")) - sweeps_before
        consolidation_solves = ControllerProbe.since(consolidation_before)["device"]
    finally:
        kubelets.clear()
        polling.clear()
        probe_loops.remove()
        if manager is not None:
            manager.stop()
            manager.elector.release()
        set_active_book(None)
    stopped = [http_get(url + "/healthz")[0] for url in (probe, metrics)]
    check(stopped == [503, 503], f"/healthz answered {stopped} after the stop, not 503")
    storm_ms = [p["ms"] for p in storm_passes]
    return {
        "pods": pods, "nodes_after_storm": nodes_before, "main_s": main_s, "ready_s": ready_s,
        "warmup_s": manager.warmup_s, "readyz": statuses, "calibration": calibration,
        "device_compute_ms": solver_mod.BREAK_EVEN_GAUGE.get("device_compute_ms"),
        "applied_s": applied_s, "first_bind_s": first_bind, "last_bind_s": last_bind,
        "pass_p50_ms": float(np.percentile(storm_ms, 50)), "pass_max_ms": max(storm_ms),
        "passes": len(storm_passes), "first_solve_ms": first_solve, "warm_solve_p50_ms": warm_solve,
        "stage_means_ms": {name: total / max(count, 1) * 1e3
                           for name, (total, count) in ControllerProbe.stages().items()},
        "storm_launches": storm_launches, "device_solves": device_solves, "host_solves": host_solves,
        "reprice_generations": book.generation - generation,
        "deleted": len(doomed), "remaining": len(remaining), "sweeps": sweep_count,
        "solve_candidates": len(swept), "sweep_ms": [s["ms"] for s in swept],
        "sweep_k7": [s["k7"] for s in swept],
        "last_problem": swept[-1]["problem"], "actions": actions,
        "consolidation_launches": consolidation_launches, "consolidation_solves": consolidation_solves,
        "evicted": len(moved), "rebound_s": (max(rebind_times) - consolidation_start) if rebind_times else 0.0,
        "joined_s": joined_s, "settle_s": settle_s, "cost_before": cost_before, "cost_after": cost_after,
        "nodes_after": len(live_nodes), "series": series, "profile_samples": profile_samples,
        "lifecycle": lifecycle,
    }


def lifecycle_sweeps(manager, cloud, binds, reschedules, lock, dark) -> dict:
    """The node-lifecycle sweeps through the controller's own loops, once
    the storm is bound and its kubelets heartbeat: a spot interruption on
    CONTROLLER_INTERRUPTED_NODES seeded nodes, one seeded other node's
    kubelet gone dark, an orphaned pod and a leaked instance, all at once.
    Then until every victim is drained and deleted, every displaced pod is
    bound again (once, to a live node) by replacement solves that all ran on
    the device route (the caller holds them to K1, the K2 pair and K3 once
    each on the card), the dark node is escalated by the health sweep, the
    orphan is reaped by podgc and the leak terminated by instancegc. Prints
    the `controller_lifecycle` line and returns its numbers."""
    from karpenter_tpu_torch.api.pods import PodSpec
    from karpenter_tpu_torch.cloudprovider import CloudInstance
    from karpenter_tpu_torch.controllers import health, instancegc, interruption, podgc
    from karpenter_tpu_torch.models import solver as solver_mod

    cluster = manager.cluster
    loaded = sorted({p.node_name for p in cluster.list_pods() if p.node_name})
    rng = np.random.default_rng(CONTROLLER_LIFECYCLE_SEED)
    chosen = [loaded[i] for i in rng.choice(len(loaded), CONTROLLER_INTERRUPTED_NODES + 1, replace=False)]
    victims, dark_node = chosen[:-1], chosen[-1]
    displaced = {p.uid: p for p in cluster.list_pods() if p.node_name in set(chosen)}
    gone = set(chosen)
    before = {
        "events": interruption.INTERRUPTION_EVENTS_TOTAL.get("spot-interruption"),
        "displaced": interruption.INTERRUPTION_DISPLACED_TOTAL.get(),
        "unhealthy": health.NODE_UNHEALTHY_TOTAL.get("stale-heartbeat"),
        "podgc": podgc.PODGC_DELETED_TOTAL.get(),
        "instancegc": instancegc.INSTANCEGC_TERMINATED_TOTAL.get(),
        "device": solver_mod.SOLVE_DISPATCH_TOTAL.get("device"),
        "host": solver_mod.SOLVE_DISPATCH_TOTAL.get("host"),
        "launches": kernel_launches(),
    }
    pool_risk = {(n.instance_type, n.zone): manager.price_book.pool_risk((n.instance_type, n.zone))
                 for n in (cluster.get_node(name) for name in victims)}
    start = time.perf_counter()
    dark.add(dark_node)
    for name in victims:
        cloud.inject_interruption(cluster.get_node(name), deadline_in=CONTROLLER_INTERRUPTION_DEADLINE_S)
    orphan = PodSpec(name="chip-smoke-orphan", requests={"cpu": "100m"}, node_name="chip-smoke-gone-node")
    cluster.apply_pod(orphan)
    sample = cluster.get_node(victims[0])
    leak = CloudInstance(instance_id="chip-smoke-leak", provider_id=f"fake:///{sample.zone}/chip-smoke-leak",
                         instance_type=sample.instance_type, zone=sample.zone, capacity_type="spot",
                         launched_at=cluster.clock.now() - instancegc.LAUNCH_GRACE_SECONDS - 1.0)
    cloud.instances[leak.provider_id] = leak

    def state():
        live = {n.name for n in cluster.list_nodes() if n.deletion_timestamp is None}
        with lock:
            waiting = [uid for uid, pod in displaced.items()
                       if binds[uid] != 1 + reschedules[uid]
                       or getattr(cluster.try_get_pod(pod.namespace, pod.name), "node_name", None) not in live - gone]
        return {
            "victims_left": sum(cluster.try_get_node(name) is not None for name in victims),
            "dark_left": int(cluster.try_get_node(dark_node) is not None),
            "pods_waiting": len(waiting),
            "orphan_left": int(cluster.try_get_pod(orphan.namespace, orphan.name) is not None),
            "leak_left": int(leak.provider_id in cloud.instances),
        }

    check(wait_for(lambda: not any(state().values()), CONTROLLER_LIFECYCLE_TIMEOUT_S, poll_s=0.5),
          f"the lifecycle sweeps did not settle in {CONTROLLER_LIFECYCLE_TIMEOUT_S:.0f} s: {state()}")
    settled_s = time.perf_counter() - start
    launches = {name: count - before["launches"][name] for name, count in kernel_launches().items()}
    solves = solver_mod.SOLVE_DISPATCH_TOTAL.get("device") - before["device"]
    host = solver_mod.SOLVE_DISPATCH_TOTAL.get("host") - before["host"]
    check(host == 0 and solves >= 1, f"{solves:.0f} replacement solves on the device route, {host:.0f} on the host")
    seen = interruption.INTERRUPTION_EVENTS_TOTAL.get("spot-interruption") - before["events"]
    escalated = health.NODE_UNHEALTHY_TOTAL.get("stale-heartbeat") - before["unhealthy"]
    reaped = podgc.PODGC_DELETED_TOTAL.get() - before["podgc"]
    terminated = instancegc.INSTANCEGC_TERMINATED_TOTAL.get() - before["instancegc"]
    check(seen == len(victims), f"the interruption sweep saw {seen:.0f} of {len(victims)} notices")
    check(cloud.poll_interruptions() == [], "an interruption notice was never acked")
    check(all(name in cloud.deleted_nodes for name in chosen), "a drained node was not deleted at the provider")
    check(escalated >= 1, "the health sweep escalated no stale node")
    check(reaped >= 1 and terminated >= 1 and "chip-smoke-leak" in cloud.terminated_instances,
          f"podgc reaped {reaped:.0f} pods and instancegc terminated {terminated:.0f} instances")
    # The interrupted pools' hazard (quantized, so a pool already at risk
    # may stay on its step): every one at risk now.
    after = {pool: manager.price_book.pool_risk(pool) for pool in pool_risk}
    check(all(risk > 0.0 for risk in after.values()),
          f"the PriceBook left an interrupted pool without risk: {after}")
    noted = sum(after[pool] > risk for pool, risk in pool_risk.items())
    result = {
        "interruptions_seen": int(seen), "nodes_drained": len(victims), "dark_nodes": 1,
        "health_escalated": int(escalated), "pods_displaced": len(displaced),
        "interruption_displaced": int(interruption.INTERRUPTION_DISPLACED_TOTAL.get() - before["displaced"]),
        "pods_rebound": len(displaced), "replacement_solves": int(solves), "host_solves": int(host),
        "k1": launches["dominance_prices"], "k2": launches["pack_pair_payload"], "k3": launches["lp_relax"],
        "podgc_reaped": int(reaped), "instancegc_terminated": int(terminated), "pools_noted": noted,
        "settled_s": settled_s,
    }
    phase("controller_lifecycle", **result)
    return result


def kernel_launches() -> dict:
    """Every kernel wrapper's launch count, by name."""
    from karpenter_tpu_torch.ops import consolidate_kernel, cuda_kernels, incremental, pack_kernel, score_kernel

    counters = {
        "dominance_prices": cuda_kernels.dominance_prices, "pack_kernel": pack_kernel.pack_kernel,
        "lp_relax": score_kernel.lp_relax, "pack_pair_payload": pack_kernel.pack_pair_payload,
        "solve_counterfactuals": consolidate_kernel.solve_counterfactuals,
        "scatter": incremental.scatter, "gather": incremental.gather,
    }
    counts = {name: counter.launches for name, counter in counters.items()}
    counts["pack_kernel_quirk"] = pack_kernel.pack_kernel.quirk_launches
    return counts


def controller_phase() -> dict:
    """The `controller` phase on the card, in a process of its own (so the
    boot warmup pays the first launches, as a deployment's would): run by
    `chip_smoke.py --phase controller`, which prints this phase's line and
    a `controller_result` JSON line the parent reads."""
    import torch

    from karpenter_tpu_torch.ops import consolidate, consolidate_kernel

    # The deployment as shipped: on the card the host route is closed
    # unless asked for (models/solver.host_route_open).
    os.environ.pop("KARPENTER_HOST_SOLVE", None)
    device = torch.device("cuda", 0)
    run = run_controller(None, num_pods=CONTROLLER_PODS)
    launches = run["storm_launches"]
    solves = int(run["device_solves"])
    check(all(launches[name] == solves for name in ("dominance_prices", "pack_kernel", "lp_relax", "pack_pair_payload"))
          and solves >= run["passes"],
          f"the storm's {solves} device solves did not each launch K1, K2 (with K4) and K3 once: {launches}")
    lifecycle = run["lifecycle"]
    check(all(lifecycle[kernel] == lifecycle["replacement_solves"] for kernel in ("k1", "k2", "k3")),
          f"the {lifecycle['replacement_solves']} replacement solves did not each launch K1, K2 (with K4) "
          f"and K3 once: {lifecycle}")
    k7 = sum(run["sweep_k7"])
    check(run["sweep_k7"] and set(run["sweep_k7"]) == {1},
          f"the consolidation loop's sweeps did not each launch K7 once: {run['sweep_k7']}")
    problem = run["last_problem"]
    k7_ms = device_ms_per_call(lambda: consolidate.solve_candidates(problem, device=device),
                               ["counterfactual_kernel"], reps=10)
    # K7 alone at this sweep's padded size: its CUDA-event time and plan.
    k7_operands, k7_axes = k7_inputs(problem, device)
    k7_event_ms = time_cuda(functools.partial(
        consolidate_kernel.solve_counterfactuals, *k7_operands, axes=k7_axes), reps=20)
    k7_shape = [int(k7_operands[0].shape[0]), int(k7_operands[0].shape[1]),
                int(k7_operands[2].shape[0]), int(k7_operands[4].shape[0])]
    k7_plan = consolidate_kernel.counterfactual_launch_plan(
        k7_shape[0], k7_shape[1], k7_shape[2], k7_axes, torch.cuda.get_device_properties(device).multi_processor_count)
    calibration = run["calibration"]
    phase(
        "controller", pods=len(run["pods"]), types=NUM_TYPES, main_s=f"{run['main_s']:.3f}",
        ready_s=f"{run['ready_s']:.3f}", warmup_s=f"{run['warmup_s']:.3f}",
        readyz=",".join(f"{s}x{run['readyz'].count(s)}" for s in sorted(set(run["readyz"]))),
        fetch_floor_ms=f"{calibration.fetch_floor_ms:.4f}",
        host_ms_per_pod=f"{calibration.host_ms_per_pod:.6f}",
        device_compute_ms=f"{run['device_compute_ms']:.3f}", max_pods=calibration.max_pods,
        max_pods_batched=calibration.max_pods_batched,
        host_solve_env=os.environ.get("KARPENTER_HOST_SOLVE", "unset"), applied_s=f"{run['applied_s']:.3f}", first_bind_s=f"{run['first_bind_s']:.3f}",
        last_bind_s=f"{run['last_bind_s']:.3f}", pods_per_s=f"{len(run['pods']) / run['last_bind_s']:.1f}",
        passes=run["passes"], pass_p50_ms=f"{run['pass_p50_ms']:.3f}", pass_max_ms=f"{run['pass_max_ms']:.3f}",
        first_solve_ms=f"{run['first_solve_ms']:.3f}", warm_solve_p50_ms=f"{run['warm_solve_p50_ms']:.3f}",
        **{f"{name}_mean_ms": f"{ms:.3f}" for name, ms in run["stage_means_ms"].items()},
        device_solves=solves, host_solves_after_ready=int(run["host_solves"]),
        k1_k4_launches=launches["pack_kernel"], k8_gathers=launches["gather"],
        reprice_generations=run["reprice_generations"],
        nodes_after_storm=run["nodes_after_storm"], deleted=run["deleted"], sweeps=run["sweeps"],
        k7_launches=k7, k7_device_ms=f"{k7_ms:.4f}", k7_event_ms=f"{k7_event_ms:.4f}",
        k7_shape="C={},G={},N={},T={}".format(*k7_shape), k7_cluster=k7_plan.cluster,
        sweep_p50_ms=f"{np.percentile(run['sweep_ms'], 50):.3f}",
        delete_actions=int(run["actions"]["delete"]), replace_actions=int(run["actions"]["replace"]),
        consolidation_solves=int(run["consolidation_solves"]), evicted=run["evicted"],
        joined_s=f"{run['joined_s']:.3f}", rebound_s=f"{run['rebound_s']:.3f}", settle_s=f"{run['settle_s']:.3f}",
        cost_before=f"{run['cost_before']:.6f}", cost_after=f"{run['cost_after']:.6f}",
        nodes_after=run["nodes_after"], metrics_series=run["series"], profile_samples=run["profile_samples"],
    )
    return {"k7_launches": k7, "k7_ms": k7_ms, "k7_event_ms": k7_event_ms, "k7_shape": k7_shape,
            "k7_cluster": k7_plan.cluster, "storm_launches": launches, "device_solves": solves,
            "lifecycle": run["lifecycle"]}


# --- the controller on a live apiserver with the EC2 provider ----------------

# The apiserver phase: a scale-up burst of the main path's shape mix (the
# provisioner batches it in 2,000-pod windows), then consolidation with 40%
# of it deleted. The controller's kube client keeps the reference's QPS 200,
# burst 300 (options.go:33-34), so 5,000 Binding POSTs alone take 25 s.
APISERVER_PODS = 5_000
APISERVER_DELETE_FRACTION = 0.4
APISERVER_DELETE_SEED = 29
APISERVER_POST_THREADS = 8  # the store process's clients creating the pods
APISERVER_CONSOLIDATION_S = 60.0  # consolidation runs at most this long, then the budget goes to 0
APISERVER_HISTORY = 500_000  # the fake apiserver's watch history (events), past every event of the run
APISERVER_TIMEOUT_S = 300.0  # each wait of the phase


def fake_apiserver_module():
    """tests/fake_apiserver.py, the repository's in-process kube-apiserver
    double (CRUD with resourceVersions, the binding, eviction and status
    subresources, Lease CAS, watch streams, served over HTTP by its
    serve_http), loaded as tests/port_twins.py loads the port's twin of a
    test helper: its one import of the JAX package's kubeapi client points
    at the port's, so chip_smoke imports nothing of the JAX package."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "port_twins.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_port_twins", path)
    port_twins = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(port_twins)
    return port_twins.TwinPackage("port", "chip_smoke").module("fake_apiserver")


def _path_kind(path: str) -> str:
    """A request path's resource (and subresource): pods, pods/binding,
    nodes, leases, provisioners/status, ..."""
    parts = [part for part in path.split("?")[0].split("/") if part]
    for resource in ("pods", "nodes", "provisioners", "leases", "daemonsets", "poddisruptionbudgets"):
        if resource in parts:
            rest = parts[parts.index(resource) + 1:]
            return resource + (f"/{rest[1]}" if len(rest) > 1 else "")
    return "other"


class ApiServerTally:
    """What the fake apiserver answered, counted in its handler: the Binding
    POSTs it admitted per pod (and when), the statuses of the node POSTs per
    provider id, the displacements per pod (a PATCH clearing spec.nodeName)."""

    def __init__(self, server):
        import threading
        from collections import Counter

        self.lock = threading.Lock()
        self.binds = Counter()
        self.bind_times = {}
        self.displaced = Counter()
        self.node_posts = {}  # provider id -> the statuses of the node POSTs that carried it
        handle = server.handle

        def counting(method, path, query="", body=None):
            status, payload = handle(method, path, query, body)
            kind = _path_kind(path)
            with self.lock:
                if kind == "pods/binding" and method == "POST" and status < 300:
                    name = path.split("/")[-2]
                    self.binds[name] += 1
                    self.bind_times.setdefault(name, []).append(time.perf_counter())
                elif kind == "nodes" and method == "POST":
                    provider_id = ((body or {}).get("spec") or {}).get("providerID", "")
                    self.node_posts.setdefault(provider_id, []).append(status)
                elif (kind == "pods" and method == "PATCH" and status < 300
                      and "nodeName" in ((body or {}).get("spec") or {})
                      and body["spec"]["nodeName"] is None):
                    self.displaced[path.split("/")[-1]] += 1
            return status, payload

        server.handle = counting


class ControllerChild:
    """The apiserver phase's controller process (`chip_smoke.py --phase
    apiserver-controller`), driven by one command a line on its stdin; each
    command's answer is an `apiserver_ack <json>` line on its stdout."""

    def __init__(self, url: str, metrics_port: int, probe_port: int, device=None):
        import queue
        import threading

        self.process = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--phase", "apiserver-controller", url,
             str(metrics_port), str(probe_port)] + ([str(device)] if device is not None else []),
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, bufsize=1)
        self.lines = queue.Queue()
        self.printed = []
        self.errors = []

        def read_out():
            for line in self.process.stdout:
                self.lines.put(line.rstrip("\n"))
            self.lines.put(None)

        def read_err():
            for line in self.process.stderr:
                if "\tINFO\t" not in line:
                    self.errors.append(line.rstrip("\n"))
                    del self.errors[:-200]

        threading.Thread(target=read_out, name="controller-stdout", daemon=True).start()
        threading.Thread(target=read_err, name="controller-stderr", daemon=True).start()

    def ask(self, command: str, timeout_s: float = 120.0) -> dict:
        import queue

        try:
            self.process.stdin.write(command + "\n")
            self.process.stdin.flush()
        except BrokenPipeError:
            pass
        deadline = time.perf_counter() + timeout_s
        while True:
            try:
                line = self.lines.get(timeout=max(0.0, deadline - time.perf_counter()))
            except queue.Empty:
                line = None
            if line is None:
                check(False, f"the apiserver phase's controller did not answer {command!r} "
                             f"(rc {self.process.poll()}):\n" + "\n".join(self.errors[-40:]))
            if line.startswith("apiserver_ack "):
                return json.loads(line[len("apiserver_ack "):])
            self.printed.append(line)
            print(line, flush=True)

    def stop(self) -> None:
        if self.process.poll() is None:
            self.process.kill()
        self.process.wait()


def private_dns_name(instance_id: str, zone: str) -> str:
    """An instance's private DNS name (its node's name) from its whole id.
    FakeEc2 names an instance from its id modulo 256 and its index in the
    fleet call, so past 256 ids two instances in a zone can share a name;
    the second node's POST then answers 409, the launch adopts the first
    node and the instance leaks until instancegc's grace runs out. A VPC's
    addresses are unique, and so are these."""
    number = int(instance_id.rsplit("-", 1)[1])
    return f"ip-10-{number >> 16 & 255}-{number >> 8 & 255}-{number & 255}.{zone}.compute.internal"


def apiserver_controller(url: str, metrics_port: int, probe_port: int, device=None) -> None:
    """The controller process of the apiserver phase: cmd/controller.main on
    the card with `--cluster-store <url>` (the store process's fake
    apiserver over HTTP), leader election on the apiserver's Lease, and the
    EC2 provider over FakeEc2 (the main path's catalog as EC2 records, its
    three zones, each instance named from its whole id: private_dns_name)
    registered as a provider factory. Then commands from the
    store process on stdin (`apiserver_phase`): mark, provisioner, report,
    consolidate, freeze, stop. `device` None is the card; "cpu" runs the
    kernels' plain versions (a rehearsal: the host route as the caller's
    environment sets it)."""
    import threading
    from collections import Counter

    from karpenter_tpu_torch.cloudprovider import registry
    from karpenter_tpu_torch.cloudprovider.ec2 import Ec2CloudProvider
    from karpenter_tpu_torch.cloudprovider.ec2 import api as ec2_api
    from karpenter_tpu_torch.cloudprovider.ec2.fake import FakeEc2
    from karpenter_tpu_torch.cloudprovider.ec2.instances import PROVIDER_ID_FORMAT
    from karpenter_tpu_torch.cmd import controller
    from karpenter_tpu_torch.controllers import consolidation as consolidation_mod
    from karpenter_tpu_torch.controllers import instancegc
    from karpenter_tpu_torch.kubeapi.client import KUBE_API_LANE_WAIT, KUBE_API_REQUEST_DURATION, HttpTransport
    from karpenter_tpu_torch.kubeapi.cluster import ApiServerCluster
    from karpenter_tpu_torch.models import solver as solver_mod
    from karpenter_tpu_torch.models import warmup

    if device is None:
        # The deployment as shipped: on the card the host route is closed.
        os.environ.pop("KARPENTER_HOST_SOLVE", None)
    world = {"fleet_ids": []}

    def ec2_cloud():
        api = FakeEc2(instance_type_infos=ec2_instance_type_infos(ec2_api), zones=ZONES,
                      cluster_name=APISERVER_CLUSTER)
        create_fleet = api.create_fleet

        def recorded_fleet(request):
            result = create_fleet(request)
            with api._lock:
                for instance_id in result.instance_ids:
                    instance = api.instances.get(instance_id)
                    if instance is not None:
                        api.instances[instance_id] = dataclasses.replace(
                            instance, private_dns_name=private_dns_name(instance_id, instance.zone))
            world["fleet_ids"].extend(result.instance_ids)
            return result

        api.create_fleet = recorded_fleet
        world["api"] = api
        return Ec2CloudProvider(api=api, cluster_name=APISERVER_CLUSTER)

    registry.register_factory(APISERVER_CLOUD, ec2_cloud)
    lock = threading.Lock()
    requests, events = Counter(), Counter()
    original_request, original_stream = HttpTransport.request, HttpTransport.stream
    original_on_watch = ApiServerCluster._on_watch

    def counted_request(transport, method, path, query="", body=None, timeout_s=None):
        with lock:
            requests[f"{method} {_path_kind(path)}"] += 1
        return original_request(transport, method, path, query, body, timeout_s)

    def counted_stream(transport, path, query=""):
        with lock:
            requests[f"WATCH {_path_kind(path)}"] += 1
        return original_stream(transport, path, query)

    def counted_on_watch(cluster, kind, event_type, obj):
        with lock:
            events[f"{kind} {event_type}"] += 1
        return original_on_watch(cluster, kind, event_type, obj)

    probe = ControllerProbe()
    HttpTransport.request, HttpTransport.stream = counted_request, counted_stream
    ApiServerCluster._on_watch = counted_on_watch
    probe.install()
    argv = [
        "--cluster-name", APISERVER_CLUSTER, "--cluster-store", url, "--solver", "cost",
        "--cloud-provider", APISERVER_CLOUD, "--metrics-port", str(metrics_port),
        "--health-probe-port", str(probe_port), "--consolidation-cooldown", "1",
        "--consolidation-max-disruption", str(CONTROLLER_MAX_DISRUPTION),
        "--disruption-budget", str(CONTROLLER_MAX_DISRUPTION),
        "--market-poll-interval", str(CONTROLLER_MARKET_POLL_S),
        "--selection-concurrency", str(CONTROLLER_SELECTION_CONCURRENCY),
    ]
    boot = time.perf_counter()
    manager = controller.main(argv, block=False, device=device)
    main_s = time.perf_counter() - boot
    check(isinstance(manager.cluster, ApiServerCluster) and manager.cloud.api is world["api"],
          "main did not build the apiserver store and the registered EC2 cloud")
    mark = {}

    def since(counter, key):
        return {name: count - mark[key].get(name, 0) for name, count in counter.items()
                if count != mark[key].get(name, 0)}

    def report() -> dict:
        api = world["api"]
        with api._lock:
            live = [PROVIDER_ID_FORMAT.format(zone=i.zone, instance_id=i.instance_id)
                    for i in api.instances.values()]
            live_ids = sorted(api.instances)
            terminated = [i for call in api.calls["terminate_instances"] for i in call]
            fleet_calls = len(api.calls["create_fleet"])
        with lock:
            counted = {"requests": since(requests, "requests"), "events": since(events, "events")}
        solves = ControllerProbe.since(mark)

        def seconds(histogram) -> dict:
            with histogram._lock:
                return {key[0]: total - mark["seconds"].get(id(histogram), {}).get(key[0], 0.0)
                        for key, total in histogram._sums.items()}

        return {
            "lane_wait_s": seconds(KUBE_API_LANE_WAIT), "request_s": seconds(KUBE_API_REQUEST_DURATION),
            "stage_s": {name: total - mark["stages"][name][0] for name, (total, _) in ControllerProbe.stages().items()},
            "instances": live, "instance_ids": live_ids, "fleet_ids": list(world["fleet_ids"]),
            "fleet_calls": fleet_calls, "terminated": terminated,
            "instancegc_terminated": instancegc.INSTANCEGC_TERMINATED_TOTAL.get() - mark["instancegc"],
            "launches": solves["launches"], "device_solves": solves["device"], "host_solves": solves["host"],
            "passes": probe.passes[mark["passes"]:],
            "sweeps": [{key: value for key, value in sweep.items() if key != "problem"}
                       for sweep in probe.sweeps[mark["sweeps"]:]],
            "actions": {kind: consolidation_mod.CONSOLIDATION_ACTIONS_TOTAL.get(kind, "executed")
                        for kind in ("delete", "replace")},
            # Since boot: pump events that arrived while a write-through of
            # the same object was in flight, of those dropped as its echo,
            # and applied after it.
            "echoes": {"held": manager.cluster.echoes_held, "dropped": manager.cluster.echoes_dropped,
                       "applied": manager.cluster.echoes_applied},
            **counted,
        }

    def answer(payload) -> None:
        print("apiserver_ack " + json.dumps(payload), flush=True)

    try:
        for line in sys.stdin:
            command = line.strip()
            if command == "mark":
                ControllerProbe.await_ready(manager)
                with lock:
                    mark.update(requests=Counter(requests), events=Counter(events))
                mark["seconds"] = {}
                for histogram in (KUBE_API_LANE_WAIT, KUBE_API_REQUEST_DURATION):
                    with histogram._lock:
                        mark["seconds"][id(histogram)] = {key[0]: total for key, total in histogram._sums.items()}
                mark.update(ControllerProbe.counts(), stages=ControllerProbe.stages(),
                            instancegc=instancegc.INSTANCEGC_TERMINATED_TOTAL.get(),
                            passes=len(probe.passes), sweeps=len(probe.sweeps))
                answer({"main_s": main_s, "warmup_s": manager.warmup_s,
                        "rung_failures": warmup.WARMUP_RUNG_FAILURES.get(),
                        "calibrated": solver_mod.break_even() is not None,
                        "leader": manager.elector.is_leader.is_set(),
                        "boot_requests": dict(mark["requests"]), "boot_events": dict(mark["events"])})
            elif command == "provisioner":
                answer({"reconciled": wait_for(
                    lambda: manager.provisioning.worker("default") is not None, 60.0)})
            elif command == "report":
                answer(report())
            elif command == "consolidate":
                manager.loops["consolidation"].enqueue("sweep")
                answer({})
            elif command == "freeze":
                manager.disruption_ledger.budget = 0
                answer({})
            elif command == "stop":
                break
    finally:
        HttpTransport.request, HttpTransport.stream = original_request, original_stream
        ApiServerCluster._on_watch = original_on_watch
        probe.remove()
        manager.stop()
        manager.elector.release()
        manager.cluster.close()
    answer({"stopped": True})


def apiserver_phase(device=None, num_pods: int = APISERVER_PODS,
                    consolidation_s: float = APISERVER_CONSOLIDATION_S) -> dict:
    """The `apiserver` phase, run by `chip_smoke.py --phase apiserver` in a
    process of its own: this process is the store (the fake apiserver served
    over HTTP on a loopback port, the kubelets, kubectl), a child the
    controller (`apiserver_controller`, on the card). The controller boots
    (/readyz 503, then 200); a Provisioner and APISERVER_PODS pending pods of
    the main path's shape mix arrive through HTTP POSTs; every pod is bound
    exactly once through the Binding subresource; the kubelets join every
    node; every node is one live FakeEc2 instance launched by a recorded
    create_fleet call; each device solve launched K1, the K2 pair (K4 in its
    epilogue) and K3 once, no host solve after ready. Then 40% of the pods
    are deleted through the API and consolidation runs at most
    APISERVER_CONSOLIDATION_S: a K7 sweep launches, every node it removes
    is terminated through FakeEc2.terminate_instances, every displaced pod
    is bound again once, and the fleet's $/hr falls. Prints the phase's
    lines; returns its numbers. `device` "cpu" rehearses it here (the CPU
    counts no kernel launch: the launch checks are the card's)."""
    import threading

    from karpenter_tpu_torch.api import provisioner as provisioner_module
    from karpenter_tpu_torch.api import requirements as requirements_module
    from karpenter_tpu_torch.api import wellknown
    from karpenter_tpu_torch.cloudprovider.ec2 import api as ec2_api
    from karpenter_tpu_torch.cloudprovider.ec2.fake import SPOT_DISCOUNT
    from karpenter_tpu_torch.kubeapi import KubeClient, convert
    from karpenter_tpu_torch.kubeapi.client import HttpTransport
    from karpenter_tpu_torch.kubeapi.cluster import PROVISIONERS

    fake = fake_apiserver_module()
    server = fake.FakeApiServer(history_limit=APISERVER_HISTORY)
    tally = ApiServerTally(server)
    httpd = fake.serve_http(server, 0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    metrics_port, probe_port = free_port(), free_port()
    while probe_port == metrics_port:
        probe_port = free_port()
    probe = f"http://127.0.0.1:{probe_port}"
    on_demand = {info.name: info.price_on_demand for info in ec2_instance_type_infos(ec2_api)}
    on_card = device is None

    def stored(kind: str) -> list:
        """The store's objects of a kind, read in place under its lock (a
        LIST through the handler deep-copies every object, which at 5,000
        pods would hold the apiserver's lock for much of each poll): the
        fields the phase reads."""
        with server._lock:
            return [{"metadata": {key: obj["metadata"].get(key) for key in
                                  ("name", "labels", "annotations", "deletionTimestamp")},
                     "spec": dict(obj.get("spec") or {})}
                    for obj in server._collection(kind).values()]

    def fleet_cost() -> float:
        cost = 0.0
        for node in stored("nodes"):
            labels = node["metadata"]["labels"]
            price = on_demand[labels[wellknown.INSTANCE_TYPE_LABEL]]
            cost += price * (SPOT_DISCOUNT if labels[wellknown.CAPACITY_TYPE_LABEL] == "spot" else 1.0)
        return cost

    readyz = []
    kubelets_stop = threading.Event()
    child = ControllerChild(url, metrics_port, probe_port, device)
    try:
        boot = time.perf_counter()

        def ready():
            status, _ = http_get(probe + "/readyz", timeout=2.0)
            if status is not None:
                readyz.append(status)
            return status == 200

        check(wait_for(ready, APISERVER_TIMEOUT_S, poll_s=0.05), f"/readyz never answered 200: {set(readyz)}")
        ready_s = time.perf_counter() - boot
        check(503 in readyz and set(readyz) <= {503, 200},
              f"/readyz did not answer 503 before the warmup ended and 200 after: {sorted(set(readyz))}")
        booted = child.ask("mark", APISERVER_TIMEOUT_S)
        check(booted["rung_failures"] == 0 and booted["calibrated"] and booted["leader"],
              f"the controller's boot: {booted}")
        phase("apiserver_boot", ready_s=f"{ready_s:.3f}", main_s=f"{booted['main_s']:.3f}",
              warmup_s=f"{booted['warmup_s']:.3f}", readyz_polls=len(readyz))
        leases = [lease["spec"]["holderIdentity"] for lease in
                  server.handle("GET", "/apis/coordination.k8s.io/v1/namespaces/kube-system/leases")[1]["items"]]
        check(len(leases) == 1, f"the controller holds no Lease on the apiserver: {leases}")

        # kubectl: the provisioner, then the pods, through the API.
        client = KubeClient(HttpTransport(url), qps=1e6, burst=10**6)
        client.create(PROVISIONERS, convert.provisioner_to_kube(
            ec2_provisioner(provisioner_module, requirements_module, wellknown)))
        check(child.ask("provisioner")["reconciled"], "the controller never reconciled the provisioner")
        pods, _ = storm_workload(num_pods)
        bodies = [convert.pod_to_kube(pod) for pod in pods]
        posts_start = time.perf_counter()
        posted = [0.0] * APISERVER_POST_THREADS

        def post(index):
            for body in bodies[index::APISERVER_POST_THREADS]:
                client.create(f"/api/v1/namespaces/{body['metadata']['namespace']}/pods", body)
            posted[index] = time.perf_counter()

        posters = [threading.Thread(target=post, args=(i,), name=f"kubectl-{i}")
                   for i in range(APISERVER_POST_THREADS)]
        for thread in posters:
            thread.start()
        for thread in posters:
            thread.join()
        last_post = max(posted)

        def unbound() -> int:
            return sum(1 for pod in stored("pods") if not pod["spec"].get("nodeName"))

        def all_bound() -> bool:
            with tally.lock:
                if len(tally.binds) < len(pods):
                    return False
            return unbound() == 0

        check(wait_for(all_bound, APISERVER_TIMEOUT_S, poll_s=0.2),
              f"{unbound()} of {len(pods)} pods were never bound")
        with tally.lock:
            binds = dict(tally.binds)
            last_bind = max(times[0] for times in tally.bind_times.values())
            first_bind = min(times[0] for times in tally.bind_times.values())
        phase("apiserver_bound", pods=len(pods), posts_s=f"{last_post - posts_start:.3f}",
              first_bind_s=f"{first_bind - posts_start:.3f}",
              last_post_to_last_bind_s=f"{last_bind - last_post:.3f}")
        names = {pod.name for pod in pods}
        check(set(binds) == names and set(binds.values()) == {1},
              "the storm did not bind every pod exactly once through the Binding subresource: "
              f"{len(set(binds) & names)} of {len(names)} bound, counts {sorted(set(binds.values()))}")

        # The kubelets: every node reports Ready (a status merge-patch, what
        # a kubelet's status loop sends) and heartbeats every
        # CONTROLLER_HEARTBEAT_S; the node loop strips the not-ready taint.
        def heartbeat():
            while True:
                stamp = convert.rfc3339(time.time())
                for node in stored("nodes"):
                    if node["metadata"].get("deletionTimestamp"):
                        continue
                    server.handle("PATCH", f"/api/v1/nodes/{node['metadata']['name']}", body={
                        "status": {"conditions": [{"type": "Ready", "status": "True",
                                                   "lastHeartbeatTime": stamp}]}})
                if kubelets_stop.wait(CONTROLLER_HEARTBEAT_S):
                    return

        threading.Thread(target=heartbeat, name="kubelets", daemon=True).start()

        def not_joined() -> int:
            return sum(1 for node in stored("nodes")
                       if any(t["key"] == wellknown.NOT_READY_TAINT_KEY for t in node["spec"].get("taints") or []))

        joined_start = time.perf_counter()
        check(wait_for(lambda: not_joined() == 0, APISERVER_TIMEOUT_S, poll_s=0.5),
              f"{not_joined()} nodes never joined")
        joined_s = time.perf_counter() - joined_start

        def nodes_are_instances(terminations_allowed: bool):
            """The nodes against FakeEc2's live instances once no launch or
            termination is in flight (an instance bought a moment before
            its node is POSTed, or terminated a moment before its node's
            finalizer goes, is not a leak): waits up to APISERVER_TIMEOUT_S
            for them to agree; the report and the nodes, by name. A leaked
            instance could vanish inside that wait (instancegc reaps an
            orphan once its grace runs out), so agreement alone is not
            enough: every node POST was admitted, instancegc terminated
            nothing, and, before consolidation, nothing was terminated."""
            found = {}

            def agree():
                found["state"] = state = child.ask("report")
                found["nodes"] = nodes = stored("nodes")
                ids = [node["spec"].get("providerID") for node in nodes]
                return len(set(ids)) == len(ids) and set(ids) == set(state["instances"])

            if not wait_for(agree, APISERVER_TIMEOUT_S, poll_s=1.0):
                state, nodes = found["state"], found["nodes"]
                ids = {node["spec"].get("providerID") for node in nodes}
                extra = sorted(set(state["instances"]) - ids)
                with tally.lock:
                    posts = {provider_id: tally.node_posts.get(provider_id) for provider_id in extra[:10]}
                check(False, f"the {len(nodes)} nodes are not the {len(state['instances'])} live FakeEc2 "
                             f"instances: {len(extra)} instances without a node (their node POSTs: {posts}), "
                             f"{len(ids - set(state['instances']))} nodes without an instance")
            state = found["state"]
            check(set(state["instance_ids"]) <= set(state["fleet_ids"]),
                  "a live instance does not come from a recorded create_fleet call")
            with tally.lock:
                refused = {provider_id: statuses for provider_id, statuses in tally.node_posts.items()
                           if any(status >= 300 for status in statuses)}
            check(not refused, f"{len(refused)} node POSTs were refused (a launch adopted another's node "
                               f"and leaked its instance): {dict(list(refused.items())[:10])}")
            check(state["instancegc_terminated"] == 0,
                  f"instancegc terminated {state['instancegc_terminated']:.0f} orphaned instances")
            check(terminations_allowed or not state["terminated"],
                  f"{len(state['terminated'])} instances were terminated before consolidation")
            return state, {node["metadata"]["name"]: node["spec"]["providerID"] for node in found["nodes"]}

        storm, storm_nodes = nodes_are_instances(terminations_allowed=False)
        launches, solves = storm["launches"], int(storm["device_solves"])
        check(storm["host_solves"] == 0, f"{storm['host_solves']:.0f} solves took the host path after ready")
        check(solves >= 1 and (not on_card or all(launches[name] == solves for name in
                                                  ("dominance_prices", "pack_pair_payload", "lp_relax"))),
              f"the {solves} device solves did not each launch K1, the K2 pair (K4) and K3 once: {launches}")
        storm_passes = [p for p in storm["passes"] if p["scheduled"]]
        check(sum(p["scheduled"] for p in storm_passes) == len(pods),
              f"the passes scheduled {sum(p['scheduled'] for p in storm_passes)} of {len(pods)} pods")
        solve_p50 = float(np.percentile([p["solve_ms"] for p in storm_passes], 50))
        phase("apiserver_storm", pods=len(pods), passes=len(storm_passes),
              pass_ms=",".join(f"{p['ms']:.0f}" for p in storm_passes),
              stage_s=json.dumps({k: round(v, 3) for k, v in storm["stage_s"].items()}, separators=(",", ":")),
              lane_wait_s=json.dumps({k: round(v, 3) for k, v in storm["lane_wait_s"].items()}, separators=(",", ":")),
              request_s=json.dumps({k: round(v, 3) for k, v in storm["request_s"].items()}, separators=(",", ":")),
              solve_p50_ms=f"{solve_p50:.3f}", solve_max_ms=f"{max(p['solve_ms'] for p in storm_passes):.3f}",
              device_solves=solves, host_solves=int(storm["host_solves"]),
              nodes=len(storm_nodes), fleet_calls=storm["fleet_calls"], joined_s=f"{joined_s:.3f}",
              launches=json.dumps(launches, separators=(",", ":")))

        # Consolidation: a seeded share of the pods goes away through the API.
        cost_before = fleet_cost()
        rng = np.random.default_rng(APISERVER_DELETE_SEED)
        doomed = set(rng.choice(len(pods), int(APISERVER_DELETE_FRACTION * len(pods)), replace=False).tolist())
        remaining = {pod.name for i, pod in enumerate(pods) if i not in doomed}
        for i in sorted(doomed):
            client.delete(f"/api/v1/namespaces/{pods[i].namespace}/pods/{pods[i].name}")
        consolidation_start = time.perf_counter()
        child.ask("consolidate")
        claim_keys = (wellknown.CONSOLIDATION_ACTION_ANNOTATION, wellknown.DRIFT_ACTION_ANNOTATION)

        def acted() -> bool:
            state = child.ask("report")
            return any(sweep["k7"] for sweep in state["sweeps"]) and sum(
                state["actions"][kind] - storm["actions"][kind] for kind in state["actions"]) > 0

        wait_for(acted, consolidation_s, poll_s=1.0)
        time.sleep(max(0.0, consolidation_s - (time.perf_counter() - consolidation_start)))
        child.ask("freeze")
        frozen = time.perf_counter()

        def settled() -> bool:
            nodes = stored("nodes")
            live = {node["metadata"]["name"] for node in nodes
                    if not node["metadata"].get("deletionTimestamp")
                    and not any(key in (node["metadata"].get("annotations") or {}) for key in claim_keys)}
            if len(live) != len(nodes):
                return False
            pods_now = {pod["metadata"]["name"]: pod for pod in stored("pods")}
            if set(pods_now) != remaining:
                return False
            with tally.lock:
                if any(tally.binds[name] != 1 + tally.displaced[name] for name in remaining):
                    return False
            return all(pod["spec"].get("nodeName") in live for pod in pods_now.values())

        check(wait_for(settled, APISERVER_TIMEOUT_S, poll_s=1.0), "consolidation did not settle")
        settle_s = time.perf_counter() - frozen
        final, final_nodes = nodes_are_instances(terminations_allowed=True)
        sweeps = final["sweeps"][len(storm["sweeps"]):]
        check(sweeps and (not on_card or all(sweep["k7"] == 1 for sweep in sweeps)),
              f"the consolidation sweeps did not each launch K7 once: {[s['k7'] for s in sweeps]}")
        removed = {name: provider_id for name, provider_id in storm_nodes.items() if name not in final_nodes}
        terminated = {f"/{instance_id}" for instance_id in final["terminated"]}
        check(all(any(provider_id.endswith(t) for t in terminated) for provider_id in removed.values()),
              "a node consolidation removed was not terminated through FakeEc2.terminate_instances")
        with tally.lock:
            moved = {name: count for name, count in tally.displaced.items() if name in remaining}
            check(all(tally.binds[name] == 1 + tally.displaced[name] for name in remaining),
                  "a displaced pod was not bound again exactly once")
        check(final["host_solves"] == 0, f"{final['host_solves']:.0f} solves took the host path")
        all_launches = final["launches"]
        all_solves = int(final["device_solves"])
        check(not on_card or all(all_launches[name] == all_solves
                                 for name in ("dominance_prices", "pack_pair_payload", "lp_relax")),
              f"the {all_solves} device solves did not each launch K1, the K2 pair (K4) and K3 once: {all_launches}")
        cost_after = fleet_cost()
        check(cost_after < cost_before, f"consolidation did not lower the fleet's $/hr: {cost_before} -> {cost_after}")
        actions = {kind: final["actions"][kind] - storm["actions"][kind] for kind in final["actions"]}
        phase("apiserver_consolidation", deleted=len(doomed), sweeps=len(sweeps),
              k7_launches=sum(sweep["k7"] for sweep in sweeps),
              sweep_p50_ms=f"{np.percentile([s['ms'] for s in sweeps], 50):.3f}",
              actions=json.dumps(actions, separators=(",", ":")), nodes=f"{len(storm_nodes)}->{len(final_nodes)}",
              removed=len(removed), displaced=len(moved), rebinds=sum(moved.values()),
              settle_s=f"{settle_s:.3f}", cost_before=f"{cost_before:.6f}", cost_after=f"{cost_after:.6f}",
              device_solves=all_solves - solves)
        phase("apiserver_http", controller_requests=json.dumps(final["requests"], separators=(",", ":"), sort_keys=True),
              controller_watch_events=json.dumps(final["events"], separators=(",", ":"), sort_keys=True),
              boot_requests=sum(booted["boot_requests"].values()))
        # The watch-echo race: a count of 0 is no fault (the timing decides
        # whether an echo overtakes its write in a run). Events of a write
        # still in flight at the report are neither dropped nor applied yet.
        echoes = final["echoes"]
        check(echoes["held"] >= echoes["dropped"] + echoes["applied"],
              f"more held pump events released than held: {echoes}")
        phase("apiserver_echoes", during_write=echoes["held"], dropped_as_echo=echoes["dropped"],
              applied_after_write=echoes["applied"],
              still_held=echoes["held"] - echoes["dropped"] - echoes["applied"])
        kubelets_stop.set()
        check(child.ask("stop", APISERVER_TIMEOUT_S).get("stopped"), "the controller did not stop")
        check(child.process.wait(timeout=60) == 0, f"the controller exited with {child.process.returncode}")
    except RuntimeError as error:
        raise RuntimeError(f"{error}\nthe controller's last warnings:\n" + "\n".join(child.errors[-60:])) from error
    finally:
        kubelets_stop.set()
        child.stop()
        httpd.shutdown()
        httpd.server_close()
    return {
        "pods": len(pods), "ready_s": ready_s, "solve_p50_ms": solve_p50,
        "last_post_to_last_bind_s": last_bind - last_post, "storm_launches": launches,
        "device_solves": all_solves, "launches": all_launches,
        "k7_launches": sum(sweep["k7"] for sweep in sweeps), "sweeps": len(sweeps),
        "requests": final["requests"], "watch_events": final["events"],
        "cost_before": cost_before, "cost_after": cost_after, "echoes": final["echoes"],
    }


# --- the solver sidecar and the admission webhook -----------------------------

SIDECAR_SOLVES = 10  # warm unary solves through the sidecar, and as many in process
SIDECAR_PROFILED_SOLVES = 2  # cost solves the profiled sidecar traces
SIDECAR_READY_S = 300.0  # a sidecar's boot: the card's probe, the build (alone: every kernel), the warmup
SIDECAR_STOP_S = 10.0  # SIGTERM to exit 0
SIDECAR_COST_RTOL = 1e-6
SIDECAR_CONTROLLER_PODS = 5 * STORM_WINDOW
SIDECAR_CONTROLLER_TIMEOUT_S = 420.0
SIDECAR_KERNELS = {"dominance_kernel": "dominance_prices", "pack_rounds_kernel": "pack_kernel",
                   "lp_relax_kernel": "lp_relax"}
WEBHOOK_TIMEOUT_S = 60.0


def packing_signature(result):
    """Order-independent structural signature of a PackResult: the
    reference's tests/test_solver_service._packing_signature."""
    packings = []
    for packing in sorted(result.packings, key=lambda p: [it.name for it in p.instance_type_options]):
        packings.append(
            (
                tuple(it.name for it in packing.instance_type_options),
                packing.node_quantity,
                tuple(sorted(len(node) for node in packing.pods_per_node)),
                tuple((p.instance_type.name, p.zone, round(p.price, 6)) for p in packing.pool_options)
                if packing.pool_options else None,
            )
        )
    return packings, sorted(p.name for p in result.unschedulable)


def live_children() -> list:
    """(pid, command line) of this process's live children, read from /proc."""
    found = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as stat:
                parent = int(stat.read().rsplit(")", 1)[1].split()[1])
            if parent != os.getpid():
                continue
            with open(f"/proc/{entry}/cmdline", "rb") as cmdline:
                command = cmdline.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except (OSError, ValueError, IndexError):
            continue
        found.append((int(entry), command))
    return found


def torch_device_type(device) -> str:
    import torch

    return torch.device(device).type


class SidecarChild:
    """The solver sidecar in a process of its own, through its entry point:
    `python -m karpenter_tpu_torch.solver_service.server` (the card), or for
    a rehearsal on the CPU its main with device="cpu". Never a fork: this
    process holds a CUDA context and gRPC threads. Its output goes to a log
    file, whose tail a failed check prints."""

    def __init__(self, device, env=None):
        import tempfile

        self.port = free_port()
        self.endpoint = f"127.0.0.1:{self.port}"
        argv = ["--host", "127.0.0.1", "--port", str(self.port)]
        if torch_device_type(device) == "cuda":
            command = [sys.executable, "-m", "karpenter_tpu_torch.solver_service.server", *argv]
        else:
            command = [sys.executable, "-c", "import sys\nfrom karpenter_tpu_torch.solver_service import server\n"
                       f"server.main({argv!r}, device='cpu')"]
        self.log_path = tempfile.mkstemp(prefix="sidecar-", suffix=".log")[1]
        self._log = open(self.log_path, "w")
        self.started = time.perf_counter()
        self.process = subprocess.Popen(
            command, stdout=self._log, stderr=subprocess.STDOUT, env={**os.environ, **(env or {})},
            cwd=os.path.dirname(os.path.abspath(__file__)))

    def tail(self, chars: int = 3000) -> str:
        with open(self.log_path, errors="replace") as log:
            return log.read()[-chars:]

    def check(self, condition: bool, message: str) -> None:
        check(condition, f"{message}\n--- the sidecar's log:\n{self.tail()}")

    def wait_ready(self, timeout_s: float = SIDECAR_READY_S) -> dict:
        """Poll Health and grpc.health.v1.Health/Check until "ok" and
        SERVING; returns the seconds from start to ready, the answers seen
        on the way and the last Health."""
        import grpc

        from karpenter_tpu_torch.solver_service import solver_pb2, wire

        # Reconnect within 50-200 ms: with gRPC's default backoff a channel
        # that found nothing listening may not try again for seconds, past
        # the warmup.
        channel = grpc.insecure_channel(self.endpoint, options=[
            ("grpc.initial_reconnect_backoff_ms", 50), ("grpc.min_reconnect_backoff_ms", 50),
            ("grpc.max_reconnect_backoff_ms", 200)])
        health_rpc = channel.unary_unary(wire.HEALTH_METHOD,
                                         request_serializer=solver_pb2.HealthRequest.SerializeToString,
                                         response_deserializer=solver_pb2.HealthResponse.FromString)
        check_rpc = channel.unary_unary("/grpc.health.v1.Health/Check",
                                        request_serializer=lambda b: b, response_deserializer=lambda b: b)
        seen, serving = set(), set()
        try:
            deadline = time.perf_counter() + timeout_s
            while True:
                self.check(self.process.poll() is None,
                           f"the sidecar exited (rc {self.process.returncode}) before it was ready")
                try:
                    health = health_rpc(solver_pb2.HealthRequest(), timeout=1.0)
                except grpc.RpcError:
                    health = None
                seen.add(health.status if health is not None else "unreachable")
                try:
                    answer = check_rpc(b"", timeout=1.0)
                    serving.add({b"\x08\x01": "SERVING", b"\x08\x02": "NOT_SERVING"}.get(answer, repr(answer)))
                except grpc.RpcError:
                    answer = None
                if health is not None and health.status == "ok" and answer == b"\x08\x01":
                    return {"ready_s": time.perf_counter() - self.started, "seen": sorted(seen),
                            "serving": sorted(serving), "health": health}
                self.check(time.perf_counter() < deadline, f"the sidecar was not ready in {timeout_s:.0f} s")
                time.sleep(0.05)
        finally:
            channel.close()

    def stop(self) -> float:
        """SIGTERM; the sidecar must exit 0 within SIDECAR_STOP_S. Returns
        the seconds it took."""
        import signal

        start = time.perf_counter()
        self.process.send_signal(signal.SIGTERM)
        try:
            code = self.process.wait(timeout=SIDECAR_STOP_S)
        except subprocess.TimeoutExpired:
            self.kill()
            code = None
        self._log.close()
        self.check(code == 0, f"SIGTERM did not end the sidecar with exit 0 in {SIDECAR_STOP_S:.0f} s (rc {code})")
        return time.perf_counter() - start

    def kill(self) -> None:
        if self.process.poll() is None:
            self.process.kill()
            self.process.wait()


class RecordingRpc:
    """A RemoteSolver's unary or stream RPC, recording each answer: the
    request and response bytes, the wall time of the call and the
    sidecar's own solve_ms, solver string and fallback flag."""

    def __init__(self, rpc, stream: bool = False):
        self.rpc, self.stream = rpc, stream
        self.calls = []

    def __call__(self, request, **kwargs):
        if not self.stream:
            start = time.perf_counter()
            response = self.rpc(request, **kwargs)
            self._record(request.ByteSize(), response, time.perf_counter() - start)
            return response
        sent = []

        def requests():
            for item in request:
                sent.append(item.ByteSize())
                yield item

        def responses(answers):
            for index, response in enumerate(answers):
                self._record(sent[index] if index < len(sent) else 0, response, None)
                yield response

        return responses(self.rpc(requests(), **kwargs))

    def _record(self, request_bytes, response, wall_s):
        self.calls.append({"request_bytes": request_bytes, "response_bytes": response.ByteSize(),
                           "wall_ms": None if wall_s is None else wall_s * 1e3,
                           "solve_ms": response.solve_ms, "solver": response.solver,
                           "fallback": response.fallback})


def recording_client(endpoint: str, **kwargs):
    """A RemoteSolver whose RPCs record their answers (RecordingRpc)."""
    from karpenter_tpu_torch.solver_service.client import RemoteSolver

    client = RemoteSolver(endpoint, **kwargs)
    client._solve_rpc = RecordingRpc(client._solve_rpc)
    client._stream_rpc = RecordingRpc(client._stream_rpc, stream=True)
    return client


def answers(client) -> list:
    return client._solve_rpc.calls + client._stream_rpc.calls


def trace_kernel_records(path: str) -> dict:
    """{kernel name: records} in one torch.profiler Chrome trace: what the
    traced solve launched on the card (copies and fills left out)."""
    import re

    with open(path) as trace:
        events = json.load(trace).get("traceEvents", [])
    records = {}
    for event in events:
        if event.get("cat") != "kernel":
            continue
        match = re.search(r"(\w+_kernel)", event.get("name", ""))
        name = match.group(1) if match else event.get("name", "")
        records[name] = records.get(name, 0) + 1
    return records


def metric_values(body: str, name: str) -> dict:
    """{label text: value} of every sample of `name` on a /metrics page."""
    import re

    found = {}
    for line in body.splitlines():
        match = re.fullmatch(rf"karpenter_{name}(\{{[^}}]*\}})? ([0-9eE+.\-naif]+)", line)
        if match:
            found[match.group(1) or ""] = float(match.group(2))
    return found


def sidecar_controller(endpoint: str, device=None) -> dict:
    """`chip_smoke.py --phase sidecar-controller ENDPOINT`: the controller
    process with `--solver remote --solver-endpoint ENDPOINT`
    (cmd/controller.main, the in-memory store, the storm's cloud and market)
    storming SIDECAR_CONTROLLER_PODS pods of the main path's mix. Counts
    every schedule its RemoteSolver sends, every fallback solve and every
    bind; reads solver_rpc_duration_seconds and remote_solver_blackout_total
    on its /metrics."""
    import threading
    from collections import Counter

    from karpenter_tpu_torch.api import provisioner as provisioner_module
    from karpenter_tpu_torch.api import requirements as requirements_module
    from karpenter_tpu_torch.api import wellknown
    from karpenter_tpu_torch.cloudprovider import registry
    from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider
    from karpenter_tpu_torch.cmd import controller
    from karpenter_tpu_torch.controllers.cluster import Cluster
    from karpenter_tpu_torch.market.feed import MarketFeed, catalog_pools
    from karpenter_tpu_torch.solver_service.client import RemoteSolver

    pods, catalog = storm_workload(SIDECAR_CONTROLLER_PODS)

    def storm_cloud():
        cloud = FakeCloudProvider(instance_types=catalog)
        cloud.attach_market_feed(MarketFeed(catalog_pools(catalog), seed=STORM_FEED_SEED))
        return cloud

    registry.register_factory(CONTROLLER_CLOUD, storm_cloud)
    metrics_port, probe_port = free_port(), free_port()
    while probe_port == metrics_port:
        probe_port = free_port()
    argv = [
        "--cluster-name", "chip-smoke-sidecar", "--solver", "remote", "--solver-endpoint", endpoint,
        "--cloud-provider", CONTROLLER_CLOUD, "--metrics-port", str(metrics_port),
        "--health-probe-port", str(probe_port), "--market-poll-interval", str(CONTROLLER_MARKET_POLL_S),
        "--selection-concurrency", str(CONTROLLER_SELECTION_CONCURRENCY),
    ]
    manager = None
    try:
        boot = time.perf_counter()
        manager = controller.main(argv, cluster=Cluster(), block=False, device=device)
        remote = manager.solver
        check(isinstance(remote, RemoteSolver), f"--solver remote built {type(remote).__name__}")
        check(wait_for(manager.ready.is_set, 120.0), "the controller never became ready")
        ready_s = time.perf_counter() - boot
        fallbacks = Counter()
        host = remote.fallback

        class CountingFallback:
            def solve_encoded(self, groups, fleet):
                fallbacks["solve_encoded"] += 1
                return host.solve_encoded(groups, fleet)

            def solve_encoded_many(self, items):
                fallbacks["solve_encoded_many"] += 1
                return host.solve_encoded_many(items)

            def solve_encoded_pipelined(self, items):
                fallbacks["solve_encoded_pipelined"] += 1
                return host.solve_encoded_pipelined(items)

        remote.fallback = CountingFallback()
        remote._solve_rpc = RecordingRpc(remote._solve_rpc)
        remote._stream_rpc = RecordingRpc(remote._stream_rpc, stream=True)
        cluster = manager.cluster
        binds = Counter()
        lock = threading.Lock()

        def on_delta(verb, kind, obj):
            if kind == "pod" and verb == "bind":
                with lock:
                    binds[obj.uid] += 1

        cluster.watch_deltas(on_delta)
        cluster.apply_provisioner(spot_provisioner(provisioner_module, requirements_module, wellknown))
        check(wait_for(lambda: manager.provisioning.worker("default") is not None, 30.0),
              "the provisioning loop never reconciled the provisioner")
        start = time.perf_counter()
        for pod in pods:
            cluster.apply_pod(pod)
        check(wait_for(lambda: len(binds) >= len(pods), SIDECAR_CONTROLLER_TIMEOUT_S),
              f"the controller bound {len(binds)} of {len(pods)} pods through the sidecar")
        bound_s = time.perf_counter() - start
        time.sleep(1.0)  # a late second bind would show here
        status, body = http_get(f"http://127.0.0.1:{metrics_port}/metrics")
        check(status == 200, f"/metrics answered {status}")
        text = body.decode()
        calls = remote._solve_rpc.calls + remote._stream_rpc.calls
        return {
            "pods": len(pods), "bound": len(binds), "bound_once": all(n == 1 for n in binds.values()),
            "ready_s": ready_s, "bound_s": bound_s, "schedules": len(calls),
            "solvers": sorted({call["solver"] for call in calls}),
            "fallback_answers": sum(call["fallback"] for call in calls),
            "fallbacks": dict(fallbacks),
            "rpc_count": metric_values(text, "solver_rpc_duration_seconds_count"),
            "blackouts": sum(metric_values(text, "remote_solver_blackout_total").values()),
            "blackout_until": remote._blackout_until,
        }
    finally:
        if manager is not None:
            manager.stop()
            manager.elector.release()


def sidecar_phase(device, pods, catalog, groups, fleet, schedules, cost_solver) -> dict:
    """The solver sidecar on the card through its entry point (SidecarChild),
    two of them: one serves the main path, SolveStream, ffd and the
    controller; the other, with KARPENTER_JAX_PROFILE_DIR set, traces two
    cost solves. Returns the numbers the kernels line and PERF.md take."""
    import glob
    import tempfile

    from karpenter_tpu_torch.api.provisioner import Constraints
    from karpenter_tpu_torch.models import solver

    on_card = torch_device_type(device) == "cuda"
    others = live_children()
    print(f"  sidecar: other live children of chip_smoke: {others or 'none'}")
    profile_dir = tempfile.mkdtemp(prefix="sidecar-profile-")
    main_child = SidecarChild(device)
    traced_child = SidecarChild(device, env={"KARPENTER_JAX_PROFILE_DIR": profile_dir})
    children = [main_child, traced_child]
    try:
        # The two boot together; the first is polled from its start, so it
        # must answer "warming" and NOT_SERVING before "ok" and SERVING.
        boot = main_child.wait_ready()
        traced_boot = traced_child.wait_ready()
        main_child.check("warming" in boot["seen"] and "NOT_SERVING" in boot["serving"],
                         f"the sidecar never answered warming and NOT_SERVING before ok: "
                         f"{boot['seen']} {boot['serving']}")
        for label, ready in (("main", boot), ("traced", traced_boot)):
            health = ready["health"]
            main_child.check(health.platform == ("gpu" if on_card else "cpu") and health.device_count == 1,
                             f"the {label} sidecar reports platform {health.platform!r}, "
                             f"{health.device_count} devices")

        # The main path: unary solves, then the same solve in process.
        client = recording_client(main_child.endpoint)
        client.solve_encoded(groups, fleet)  # warm: the first solve of this fleet uploads it
        cost_solver.solve_encoded(groups, fleet)
        remote_ms, local_ms, remote, local = [], [], [], []
        for _ in range(SIDECAR_SOLVES):
            start = time.perf_counter()
            remote.append(client.solve_encoded(groups, fleet))
            remote_ms.append((time.perf_counter() - start) * 1e3)
        unary = client._solve_rpc.calls[1:]
        for _ in range(SIDECAR_SOLVES):
            start = time.perf_counter()
            local.append(cost_solver.solve_encoded(groups, fleet))
            local_ms.append((time.perf_counter() - start) * 1e3)
        want = packing_signature(local[0])
        local_cost = local[0].projected_cost()
        for result in remote + local:
            check(packing_signature(result) == want, "a sidecar solve and the in-process solve pack differently")
            check(abs(result.projected_cost() - local_cost) <= SIDECAR_COST_RTOL * local_cost,
                  f"$/hr through the sidecar {result.projected_cost()} against {local_cost} in process")
        check(all_pods_placed_once(remote[0], pods), "the sidecar's plan did not place every pod once")
        check(all(c["solver"] == "tpu-cost" and not c["fallback"] for c in answers(client)),
              f"a sidecar answer was not tpu-cost: {sorted({c['solver'] for c in answers(client)})}")
        check(client._blackout_until == -float("inf"), "the client armed its blackout")
        wall = [c["wall_ms"] for c in unary]
        served = [c["solve_ms"] for c in unary]
        result = {
            "ready_s": boot["ready_s"], "traced_ready_s": traced_boot["ready_s"],
            "remote_p50_ms": float(np.percentile(remote_ms, 50)), "remote_max_ms": max(remote_ms),
            "rpc_p50_ms": float(np.percentile(wall, 50)), "rpc_max_ms": max(wall),
            "solve_ms_p50": float(np.percentile(served, 50)), "solve_ms_max": max(served),
            "local_p50_ms": float(np.percentile(local_ms, 50)), "local_max_ms": max(local_ms),
            "request_bytes": unary[0]["request_bytes"], "response_bytes": unary[0]["response_bytes"],
            "cost_per_hr": local_cost, "others": others,
        }
        phase("sidecar_solve", pods=len(pods), types=len(catalog), groups=groups.num_groups,
              ready_s=f"{boot['ready_s']:.3f}", seen=",".join(boot["seen"] + boot["serving"]),
              platform=boot["health"].platform, device_count=boot["health"].device_count,
              remote_p50_ms=f"{result['remote_p50_ms']:.3f}", remote_max_ms=f"{result['remote_max_ms']:.3f}",
              rpc_p50_ms=f"{result['rpc_p50_ms']:.3f}", rpc_max_ms=f"{result['rpc_max_ms']:.3f}",
              solve_ms_p50=f"{result['solve_ms_p50']:.3f}", solve_ms_max=f"{result['solve_ms_max']:.3f}",
              local_p50_ms=f"{result['local_p50_ms']:.3f}", local_max_ms=f"{result['local_max_ms']:.3f}",
              request_bytes=result["request_bytes"], response_bytes=result["response_bytes"],
              cost_per_hr=f"{local_cost:.6f}", packings="identical", solver="tpu-cost")

        # SolveStream: the schedules through the pipelined remote solve,
        # after the same in process.
        list(cost_solver.solve_encoded_pipelined(schedules))  # warm
        start = time.perf_counter()
        stream = cost_solver.solve_encoded_pipelined(schedules)
        local_piped = [next(stream)]
        local_first_ms = (time.perf_counter() - start) * 1e3
        local_piped = [plan_signature(r) for r in local_piped + list(stream)]
        local_last_ms = (time.perf_counter() - start) * 1e3
        list(client.solve_encoded_pipelined(schedules))  # warm: these fleets' first upload
        before = len(client._stream_rpc.calls)
        start = time.perf_counter()
        stream = client.solve_encoded_pipelined(schedules)
        piped = [next(stream)]
        first_ms = (time.perf_counter() - start) * 1e3
        piped += list(stream)
        last_ms = (time.perf_counter() - start) * 1e3
        streamed = client._stream_rpc.calls[before:]
        check([plan_signature(r) for r in piped] == local_piped,
              "the sidecar's pipelined plans differ from the in-process pipelined solve's")
        check(len(streamed) == len(schedules) and all(c["solver"] == "tpu-cost" for c in streamed),
              f"the stream answered {[c['solver'] for c in streamed]}")
        result.update(stream_first_ms=first_ms, stream_last_ms=last_ms, stream_schedules=len(schedules),
                      local_stream_first_ms=local_first_ms, local_stream_last_ms=local_last_ms)
        phase("sidecar_stream", schedules=len(schedules), first_result_ms=f"{first_ms:.3f}",
              last_result_ms=f"{last_ms:.3f}", local_first_result_ms=f"{local_first_ms:.3f}",
              local_last_result_ms=f"{local_last_ms:.3f}", plans="identical to the in-process pipelined solve",
              request_bytes=sum(c["request_bytes"] for c in streamed),
              response_bytes=sum(c["response_bytes"] for c in streamed))
        client.close()

        # ffd with the reference's fits() quirk (K2q).
        ffd_client = recording_client(main_child.endpoint, mode="ffd", quirk=True)
        ffd_solver = solver.TPUSolver(mode="ffd", quirk=True, device=device)
        cases = go_parity_cases() + [("main", pods, catalog)]
        for name, case_pods, case_catalog in cases:
            got = ffd_client.solve(case_pods, case_catalog, Constraints())
            expected = ffd_solver.solve(case_pods, case_catalog, Constraints())
            check(go_parity_signature(got) == go_parity_signature(expected)
                  and packing_signature(got) == packing_signature(expected),
                  f"ffd through the sidecar differs from TPUSolver in process on {name}")
        ffd_answers = answers(ffd_client)
        check(len(ffd_answers) == len(cases) and all(c["solver"] == "tpu-ffd" and not c["fallback"]
                                                     for c in ffd_answers),
              f"the ffd answers were {[c['solver'] for c in ffd_answers]}")
        ffd_client.close()
        phase("sidecar_ffd", cases=",".join(name for name, _, _ in cases), solver="tpu-ffd",
              signatures="identical to TPUSolver(quirk=True) in process",
              main_solve_ms=f"{ffd_answers[-1]['solve_ms']:.3f}")

        # The kernels one sidecar solve launches, from the traced sidecar's
        # own torch.profiler traces (KARPENTER_JAX_PROFILE_DIR). Its first
        # traced solve starts the profiler's CUDA tracing (seconds), so it
        # is not counted, and the client waits for it.
        traced_client = recording_client(traced_child.endpoint, timeout_s=SIDECAR_READY_S)
        traced_client.solve_encoded(groups, fleet)
        traced_before = set(glob.glob(os.path.join(profile_dir, "*.json")))
        for _ in range(SIDECAR_PROFILED_SOLVES):
            traced_client.solve_encoded(groups, fleet)
        traced_answers = answers(traced_client)
        traced_client.close()
        traces = sorted(set(glob.glob(os.path.join(profile_dir, "*.json"))) - traced_before)
        traced_child.check(len(traces) == SIDECAR_PROFILED_SOLVES
                           and all(c["solver"] == "tpu-cost" for c in traced_answers),
                           f"the traced sidecar wrote {len(traces)} traces for {SIDECAR_PROFILED_SOLVES} "
                           f"solves; answers {[c['solver'] for c in traced_answers]}")
        per_solve = [trace_kernel_records(path) for path in traces]
        if on_card:
            for records in per_solve:
                check(all(records.get(name) == 1 for name in SIDECAR_KERNELS) and "compact_kernel" not in records,
                      f"a sidecar solve launched {records}: not K1, K2's pair and K3 once each without "
                      "a standalone compaction")
        result["launches_per_solve"] = {SIDECAR_KERNELS[name]: per_solve[0].get(name, 0) for name in SIDECAR_KERNELS}
        result["traced_records"] = per_solve
        result["traced_stop_s"] = traced_child.stop()
        phase("sidecar_kernels", solves=len(traces), records=json.dumps(per_solve[0], sort_keys=True),
              launches=json.dumps(result["launches_per_solve"], sort_keys=True),
              stop_s=f"{result['traced_stop_s']:.3f}")

        # The control plane: cmd/controller with --solver remote.
        health = main_child.wait_ready(timeout_s=10.0)["health"]
        args = ["--phase", "sidecar-controller", main_child.endpoint] + ([] if on_card else ["cpu"])
        controller = child_result(run_child(args, SIDECAR_CONTROLLER_TIMEOUT_S + 180.0),
                                  "sidecar_controller_result")
        after = main_child.wait_ready(timeout_s=10.0)["health"]
        solves = after.solves - health.solves
        check(controller["bound"] == controller["pods"] and controller["bound_once"],
              f"the controller bound {controller['bound']} of {controller['pods']} pods, or one twice")
        check(solves == controller["schedules"] > 0,
              f"the sidecar counted {solves} solves for the {controller['schedules']} schedules sent")
        check(controller["solvers"] == ["tpu-cost"] and controller["fallback_answers"] == 0,
              f"the controller's answers: {controller['solvers']}, {controller['fallback_answers']} fallbacks")
        check(not controller["fallbacks"], f"the controller's client fell back: {controller['fallbacks']}")
        check(set(controller["rpc_count"]) == {'{outcome="ok"}'} and controller["blackouts"] == 0,
              f"solver_rpc_duration_seconds {controller['rpc_count']}, blackouts {controller['blackouts']}")
        result["controller"] = controller
        phase("sidecar_controller", pods=controller["pods"], bound=controller["bound"],
              schedules=controller["schedules"], sidecar_solves=solves,
              rpc=json.dumps(controller["rpc_count"]), blackouts=f"{controller['blackouts']:.0f}",
              fallbacks=0, ready_s=f"{controller['ready_s']:.3f}", bound_s=f"{controller['bound_s']:.3f}")
        result["stop_s"] = main_child.stop()
        phase("sidecar", stop_s=f"{result['stop_s']:.3f}", traced_stop_s=f"{result['traced_stop_s']:.3f}",
              exits="0,0")
        return result
    finally:
        for child in children:
            child.kill()


def webhook_phase() -> dict:
    """The admission webhook through its entry point (`python -m
    karpenter_tpu_torch.cmd.webhook`) with a self-signed serving
    certificate: the certificate fetched from the socket, then the
    reference's TestAdmissionReview checks over HTTPS verified against it,
    with the main path's provisioner. Host code only."""
    import base64
    import socket
    import ssl
    import urllib.error
    import urllib.request

    from karpenter_tpu_torch.api import provisioner as provisioner_module
    from karpenter_tpu_torch.api import requirements as requirements_module
    from karpenter_tpu_torch.api import wellknown
    from karpenter_tpu_torch.api.serialization import provisioner_to_dict

    port = free_port()
    start = time.perf_counter()
    process = subprocess.Popen(
        [sys.executable, "-m", "karpenter_tpu_torch.cmd.webhook", "--cluster-name", "x", "--tls-self-signed",
         "--tls-dns-names", "127.0.0.1", "--port", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        def listening():
            with socket.socket() as sock:
                return sock.connect_ex(("127.0.0.1", port)) == 0

        check(wait_for(lambda: process.poll() is not None or listening(), WEBHOOK_TIMEOUT_S)
              and process.poll() is None, "the webhook did not listen")
        ready_s = time.perf_counter() - start
        pem = ssl.get_server_certificate(("127.0.0.1", port))
        context = ssl.create_default_context(cadata=pem)

        def post(path, payload):
            request = urllib.request.Request(f"https://127.0.0.1:{port}{path}", method="POST",
                                             data=json.dumps(payload).encode())
            try:
                with urllib.request.urlopen(request, context=context, timeout=10) as response:
                    return response.status, json.loads(response.read())
            except urllib.error.HTTPError as error:
                return error.code, None

        def review(obj, uid):
            return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
                    "request": {"uid": uid, "object": obj}}

        main = provisioner_to_dict(spot_provisioner(provisioner_module, requirements_module, wellknown))
        status, answer = post("/validate", review(main, "main-1"))
        check(status == 200 and answer["kind"] == "AdmissionReview" and answer["response"]["uid"] == "main-1"
              and answer["response"]["allowed"] is True, f"/validate of the main path's provisioner: {answer}")
        bad = provisioner_to_dict(provisioner_module.Provisioner(
            name="x" * 80, spec=provisioner_module.ProvisionerSpec()))
        status, answer = post("/validate", review(bad, "bad-1"))
        check(status == 200 and answer["response"]["allowed"] is False and answer["response"]["status"]["message"],
              f"/validate of a bad provisioner: {answer}")
        plain = provisioner_to_dict(provisioner_module.Provisioner(
            name="default", spec=provisioner_module.ProvisionerSpec()))
        status, answer = post("/default", review(plain, "plain-1"))
        response = answer["response"]
        check(status == 200 and response["allowed"] is True and response["patchType"] == "JSONPatch",
              f"/default of a plain provisioner: {answer}")
        ops = json.loads(base64.b64decode(response["patch"]))
        check(ops and ops[0]["path"] == "/spec"
              and wellknown.CAPACITY_TYPE_LABEL in {r["key"] for r in ops[0]["value"]["requirements"]},
              f"/default's patch does not default the capacity type: {ops}")
        defaulted = dict(plain, spec=ops[0]["value"])
        status, answer = post("/default", review(defaulted, "plain-2"))
        check(status == 200 and answer["response"]["allowed"] is True and "patch" not in answer["response"],
              f"/default of a defaulted provisioner patched it again: {answer}")
        status, main_default = post("/default", review(main, "main-2"))
        check(status == 200 and main_default["response"]["allowed"] is True,
              f"/default of the main path's provisioner: {main_default}")
        status, _ = post("/validate", {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview"})
        check(status == 400, f"a malformed AdmissionReview answered {status}, not 400")
        phase("webhook", tls="self-signed, verified", ready_s=f"{ready_s:.3f}", validate="allowed,rejected",
              default="patched,fixed point", main_default_patch="patch" in main_default["response"],
              malformed=400)
        return {"webhook_ready_s": ready_s}
    finally:
        process.terminate()
        try:
            process.wait(timeout=10.0)
        except subprocess.TimeoutExpired:
            process.kill()
            process.wait()


def sidecar_alone() -> None:
    """`chip_smoke.py --phase sidecar`: the sidecar and webhook phases by
    themselves, every kernel built first, on the main path's workload and
    the batch phase's 8 schedules."""
    import torch

    from karpenter_tpu_torch.api.provisioner import Constraints
    from karpenter_tpu_torch.models import solver
    from karpenter_tpu_torch.ops import cuda_build
    from karpenter_tpu_torch.ops.encode import build_fleet, group_pods

    device = torch.device("cuda", 0)
    phase("build", seconds=f"{cuda_build.build_all(cuda_build.port_libraries()):.2f}")
    pods, catalog = make_workload()
    groups = group_pods(pods)
    fleet = build_fleet(catalog, Constraints(), pods, pods_need=groups.vectors.max(axis=0))
    schedules = solver.Solver._encode_problems([(pods[k::8], catalog, Constraints(), ()) for k in range(8)])
    result = sidecar_phase(device, pods, catalog, groups, fleet, schedules, solver.CostSolver(device=device))
    result.update(webhook_phase())
    print("sidecar_result " + json.dumps(result, default=str))


def consolidate_alone() -> None:
    """`chip_smoke.py --phase consolidate`: K7 built, the consolidation
    phase by itself, then K7's device and event times at its sweep."""
    import torch

    from karpenter_tpu_torch.ops import consolidate_kernel, cuda_build

    device = torch.device("cuda", 0)
    build_s = cuda_build.build_all([consolidate_kernel.LIBRARY])
    sweep = consolidate_phase(make_catalog(package=port_package()), device)
    call = functools.partial(consolidate_kernel.solve_counterfactuals, *sweep["operands"], axes=sweep["axes"])
    result = {"k7_ms": device_ms_per_call(call, ["counterfactual_kernel"], reps=50),
              "k7_event_ms": time_cuda(call, reps=50), "cluster": sweep["cluster"]}
    result["records_per_sweep"] = sweep_records(sweep["problem"], device)
    phase("consolidate_timing", build_s=f"{build_s:.2f}", k7_ms=f"{result['k7_ms']:.6f}",
          k7_event_ms=f"{result['k7_event_ms']:.4f}", cluster=result["cluster"],
          records_per_sweep=result["records_per_sweep"])
    print("consolidate_result " + json.dumps(result))


def fused_alone() -> None:
    """`chip_smoke.py --phase fused`: the fused solve at the main path's
    shapes in a process of its own (late in a long run profiler sessions
    lose records): its device records a call by name, and K2's pair with
    its epilogue (the main path's call) and without it, called in turns in
    one profile, whose difference is K4's share of the launch."""
    import torch

    from karpenter_tpu_torch.api.provisioner import Constraints
    from karpenter_tpu_torch.convert import fused_args_from_numpy
    from karpenter_tpu_torch.models import solver
    from karpenter_tpu_torch.ops import cuda_build, cuda_kernels, pack_kernel
    from karpenter_tpu_torch.ops.encode import build_fleet, group_pods

    device = torch.device("cuda", 0)
    cuda_build.build_all(cuda_build.port_libraries())
    pods, catalog = make_workload()
    groups = group_pods(pods)
    fleet = build_fleet(catalog, Constraints(), pods, pods_need=groups.vectors.max(axis=0))
    padded = solver.pad_kernel_args(groups.vectors, groups.counts, fleet.capacity, fleet.total, fleet.prices)
    args = fused_args_from_numpy(*padded, device=device)
    vectors, counts, capacity, total, valid, prices = args
    result = {"records": kernel_records(lambda: solver._cost_fused_body(*args, lp_steps=300), copies=True)}
    effective = cuda_kernels.dominance_prices(capacity, torch.where(valid, prices, torch.inf))
    pair_args = (vectors, counts, capacity, total, valid, effective)
    fused_call = functools.partial(pack_kernel.pack_pair_payload, *pair_args)
    bare_call = functools.partial(pack_kernel.pack_kernel_pair, *pair_args)
    with_ms, without_ms = paired_device_ms(fused_call, bare_call, "pack_rounds_kernel", reps=50)
    result.update(k2_with_epilogue_ms=with_ms, k2_without_epilogue_ms=without_ms,
                  k2_with_epilogue_event_ms=time_cuda(fused_call, reps=50),
                  k2_without_epilogue_event_ms=time_cuda(bare_call, reps=50))
    phase("fused", records_per_call=sum(result["records"].values()),
          k2_with_epilogue_ms=f"{with_ms:.6f}", k2_without_epilogue_ms=f"{without_ms:.6f}",
          k4_share_ms=f"{with_ms - without_ms:.6f}", k4_share=f"{100 * (with_ms / without_ms - 1):+.2f}%",
          k2_with_epilogue_event_ms=f"{result['k2_with_epilogue_event_ms']:.4f}",
          k2_without_epilogue_event_ms=f"{result['k2_without_epilogue_event_ms']:.4f}")
    print("fused_result " + json.dumps(result))


def sharded_alone() -> None:
    """`chip_smoke.py --phase sharded`: the sharded phase by itself, with
    the inputs the full run hands it built here (the constrained cell's
    operands, the many-shapes LP)."""
    import torch

    from karpenter_tpu_torch.api.provisioner import Constraints
    from karpenter_tpu_torch.convert import fused_args_from_numpy
    from karpenter_tpu_torch.models import solver
    from karpenter_tpu_torch.ops import cuda_build, cuda_kernels, score_kernel
    from karpenter_tpu_torch.ops.encode import build_fleet, group_pods

    device = torch.device("cuda", 0)
    phase("build", seconds=f"{cuda_build.build_all(cuda_build.port_libraries()):.2f}")
    os.environ["KARPENTER_HOST_SOLVE"] = "0"
    pods, catalog = make_workload()
    groups = group_pods(pods)
    fleet = build_fleet(catalog, Constraints(), pods, pods_need=groups.vectors.max(axis=0))
    many = many_shapes_pods()
    many_groups = group_pods(many)
    many_fleet = build_fleet(catalog, Constraints(), many, pods_need=many_groups.vectors.max(axis=0))
    padded = solver.pad_kernel_args(many_groups.vectors, many_groups.counts, many_fleet.capacity,
                                    many_fleet.total, many_fleet.prices)
    vectors, counts, capacity, _, valid, prices = fused_args_from_numpy(*padded, device=device)
    effective = cuda_kernels._dominance_prices_ref(capacity, torch.where(valid, prices, torch.inf))
    solvable = torch.where(score_kernel.feasibility_mask(vectors, capacity, valid).any(dim=1), counts, 0)
    sharded = sharded_phase(device, pods, catalog, groups, fleet, constrained_operands(catalog),
                            (vectors, solvable, capacity, valid, effective))
    sharded_device_ms(sharded)


def multiprocess_alone() -> None:
    """`chip_smoke.py --phase multiprocess`: the multiprocess phase by
    itself, the kernels built first."""
    import torch

    from karpenter_tpu_torch.api.provisioner import Constraints
    from karpenter_tpu_torch.ops import cuda_build
    from karpenter_tpu_torch.ops.encode import build_fleet, group_pods

    device = torch.device("cuda", 0)
    phase("build", seconds=f"{cuda_build.build_all(cuda_build.port_libraries()):.2f}")
    os.environ["KARPENTER_HOST_SOLVE"] = "0"
    pods, catalog = make_workload()
    groups = group_pods(pods)
    fleet = build_fleet(catalog, Constraints(), pods, pods_need=groups.vectors.max(axis=0))
    multiprocess_phase(device, pods, groups, fleet)


def run_child(args, timeout_s: float):
    """Start `chip_smoke.py <args>` in a process of its own on the same card;
    its output is read when the caller asks for it (child_result)."""
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), timeout_s


def child_result(child, marker: str):
    """Wait for a child, echo its phase lines, and parse its `marker` JSON
    line; a failed child fails the run with its error's tail."""
    process, timeout_s = child
    try:
        out, err = process.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        process.kill()
        process.communicate()
        raise RuntimeError(f"check failed: chip_smoke.py {marker} did not finish in {timeout_s:.0f} s")
    result = None
    for line in out.splitlines():
        if line.startswith(marker + " "):
            result = json.loads(line[len(marker) + 1:])
        else:
            print(line)
    errors = "\n".join(line for line in err.splitlines() if "\tINFO\t" not in line)
    check(process.returncode == 0 and result is not None,
          f"chip_smoke.py {marker} failed (rc {process.returncode}):\n{errors[-4000:]}")
    return result


def main(argv=None) -> int:
    """With no arguments, every phase. `--greedy-signature`, `--phase
    controller`, `--phase apiserver` (with its `--phase
    apiserver-controller`) and `--phase multiprocess-rank` are the parts
    the full run starts in processes of their own (`--phase apiserver` also
    runs that phase alone, `--phase sidecar-controller` is the sidecar
    phase's controller); `--phase sidecar` runs the sidecar and webhook
    phases alone; `--phase sharded`, `--phase
    consolidate` and `--phase multiprocess` run the sharded, the
    consolidation and the multiprocess phase alone, and `--phase fused` the
    fused solve's records and K4's share of K2's launch."""
    import torch

    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:2] == ["--phase", "sidecar-controller"] and argv[3:] == ["cpu"]:
        # The sidecar phase's controller in a rehearsal on the CPU.
        print("sidecar_controller_result " + json.dumps(sidecar_controller(argv[2], "cpu")))
        return 0
    if argv[:2] == ["--phase", "apiserver-controller"] and argv[5:] == ["cpu"]:
        # The apiserver phase's controller in a rehearsal on the CPU
        # (apiserver_phase("cpu")).
        apiserver_controller(argv[2], int(argv[3]), int(argv[4]), "cpu")
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on the card", file=sys.stderr)
        return 2
    if argv == ["--greedy-signature"]:
        print("greedy_signature " + json.dumps(greedy_signature()))
        return 0
    if argv == ["--phase", "controller"]:
        print("controller_result " + json.dumps(controller_phase()))
        return 0
    if argv == ["--phase", "sharded"]:
        sharded_alone()
        return 0
    if argv == ["--phase", "consolidate"]:
        consolidate_alone()
        return 0
    if argv == ["--phase", "fused"]:
        fused_alone()
        return 0
    if argv == ["--phase", "multiprocess"]:
        multiprocess_alone()
        return 0
    if argv == ["--phase", "apiserver"]:
        print("apiserver_result " + json.dumps(apiserver_phase()))
        return 0
    if argv == ["--phase", "sidecar"]:
        sidecar_alone()
        return 0
    if len(argv) == 3 and argv[:2] == ["--phase", "sidecar-controller"]:
        print("sidecar_controller_result " + json.dumps(sidecar_controller(argv[2])))
        return 0
    if len(argv) == 5 and argv[:2] == ["--phase", "apiserver-controller"]:
        apiserver_controller(argv[2], int(argv[3]), int(argv[4]))
        return 0
    if len(argv) == 5 and argv[:2] == ["--phase", "multiprocess-rank"]:
        multiprocess_rank(int(argv[2]), int(argv[3]), argv[4])
        return 0
    if argv:
        print("usage: python3 chip_smoke.py", file=sys.stderr)
        return 2
    children = []
    try:
        return smoke(children)
    finally:
        for process, _ in children:
            if process.poll() is None:
                process.kill()
                process.communicate()


def smoke(children) -> int:
    """Every phase in turn; `children` collects the processes it starts, for
    the caller to stop."""
    import torch

    from karpenter_tpu_torch.api.provisioner import Constraints
    from karpenter_tpu_torch.convert import fused_args_from_numpy, upload_packed
    from karpenter_tpu_torch.models import solver
    from karpenter_tpu_torch.market import forecast
    from karpenter_tpu_torch.ops import (
        consolidate_kernel, cuda_build, cuda_kernels, forecast_kernel, incremental, launch_floor,
        mix_pack, native, pack_kernel, score_kernel,
    )
    from karpenter_tpu_torch.ops.encode import build_fleet, group_pods

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    capability = torch.cuda.get_device_capability(device)
    check(capability == (9, 0), f"compute capability {capability} is not sm_90")
    phase("card", smi=repr(smi), torch=torch.__version__, cuda=torch.version.cuda,
          capability=f"{capability[0]}.{capability[1]}")

    # 2. build: one nvcc per kernel source (and the launch floor's empty
    # kernel), started together; the host library (g++) meanwhile.
    libraries = cuda_build.port_libraries() + [launch_floor.LIBRARY]
    build_s = cuda_build.build_all(libraries)
    for library in libraries:
        library.load()
        for line in library.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {library.source.name}: {line.strip()}")
    check(native.available(), "host library csrc/host/ffd.cc did not build")
    phase("build", seconds=f"{build_s:.2f}", sources=",".join(lib.source.name for lib in libraries))
    # GreedySolver on the main path's 50,000 pods takes about a minute of
    # host time: a process of its own computes it while the card works. The
    # controller phase (10c) is a process of its own too (a fresh one, so
    # that its boot warmup pays the first launches), and bound by its
    # control loops on one host core: it runs beside phases 3-10b.
    greedy_child = run_child(["--greedy-signature"], 900.0)
    children.append(greedy_child)
    controller_child = run_child(["--phase", "controller"], 1100.0)
    children.append(controller_child)
    # The apiserver phase (10f) is two processes of its own, the store and
    # the controller, started together with the controller phase's.
    apiserver_child = run_child(["--phase", "apiserver"], 1100.0)
    children.append(apiserver_child)

    # Encode the main path's workload once (host work, timed).
    pods, catalog = make_workload()
    start = time.perf_counter()
    groups = group_pods(pods)
    fleet = build_fleet(catalog, Constraints(), pods, pods_need=groups.vectors.max(axis=0))
    encode_ms = (time.perf_counter() - start) * 1e3
    padded = solver.pad_kernel_args(groups.vectors, groups.counts, fleet.capacity, fleet.total, fleet.prices)
    main_args = fused_args_from_numpy(*padded, device=device)
    vectors, counts, capacity, total, valid, prices = main_args
    main_prices = cuda_kernels._dominance_prices_ref(capacity, torch.where(valid, prices, torch.inf))

    # 3. every kernel against its plain version on the card: K1 and K2 bit
    # for bit, K3 to the LP tolerances.
    k1_cases = 0
    k1_err = 0.0
    for cap_np, price_np in list(dominance_cases()) + [
        (padded[2], np.where(padded[4], padded[5], np.inf).astype(np.float32))
    ]:
        cap_t = torch.from_numpy(np.ascontiguousarray(cap_np)).to(device)
        price_t = torch.from_numpy(np.ascontiguousarray(price_np)).to(device)
        got = cuda_kernels.dominance_prices(cap_t, price_t)
        want = cuda_kernels._dominance_prices_ref(cap_t, price_t)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"K1 differs from its plain version at T={cap_np.shape[0]}")
        finite = torch.isfinite(want)
        if finite.any():
            k1_err = max(k1_err, float((got[finite] - want[finite]).abs().max()))
        k1_cases += 1
    rng = np.random.default_rng(7)
    k2_cases = 0
    k2_err = 0.0
    # (32, 512) needs more than 48 KB of shared memory; (64, 1024) and
    # (64, 2048) put the fills in global scratch; (16, 300) leaves part of
    # the block's last warp without a type; (16, 1024) fills a block of
    # 1,024 threads, one type each; (64, 2048) gives each thread two types.
    pack_shapes = ((8, 8), (16, 64), (16, 300), (16, 512), (32, 256), (32, 512), (16, 1024),
                   (64, 1024), (64, 2048))
    k2_plans = [pack_kernel.pack_launch_plan(g, t, 8) for g, t in pack_shapes]
    check({p.fills_in_shared for p in k2_plans} == {True, False}
          and {p.types_per_thread for p in k2_plans} >= {1, 2}
          and any(p.threads * p.types_per_thread > t for p, (_, t) in zip(k2_plans, pack_shapes)),
          "the K2 shapes do not cover every launch plan")
    problems = [random_pack_problem(rng, g, t) for g, t in pack_shapes]
    problems.append(tuple(padded[:5]) + (main_prices.cpu().numpy(),))
    problems += [problem for _, problem, _ in tied_weight_cases() if problem is not None]
    # The dense problems past the compaction's entry budget (G 16 and 64).
    problems += [dense_pack_problem(seed, g) for seed, g in DENSE_PACK_CASES]
    k4_cases = k4_overflowed = 0
    k4_err = 0
    for problem in problems:
        label = f"G={problem[0].shape[0]} T={problem[2].shape[0]}"
        args = fused_args_from_numpy(*problem, device=device)
        pair = pack_kernel.pack_kernel_pair(*args)
        # The plain composition of the fused solve's tail: both modes'
        # rounds, feasible_any, solvable, the dense spill and the payload.
        plain = pack_kernel._pack_pair_payload_ref(*args, True)
        for mode, from_pair, plain_rounds in zip(("ffd", "cost"), pair, plain[:2]):
            alone = pack_kernel.pack_kernel(*args, mode=mode)
            torch.cuda.synchronize()
            check(rounds_equal(alone, plain_rounds), f"K2 {mode} differs from its plain version at {label}")
            check(rounds_equal(from_pair, plain_rounds), f"K2 pair {mode} differs from its plain version")
            k2_err = max(k2_err, rounds_abs_err(from_pair, plain_rounds))
            k2_cases += 1
        again = pack_kernel.pack_kernel_pair(*args)
        torch.cuda.synchronize()
        check(all(rounds_equal(a, b) for a, b in zip(pair, again)), f"two launches of K2 differ at {label}")
        # K4 in the pair launch's epilogue: one launch, word for word.
        k4_err = max(k4_err, fused_against_plain(args, plain, pair, label))
        k4_overflowed += not pack_kernel.decompact_plan(plain.payload.cpu().numpy(), problem[0].shape[0])[3]
        k4_cases += 1
    check(k4_overflowed >= 2, f"{k4_overflowed} fused cases overflowed the entry budget, not the dense two")
    # K3 on the non-degenerate LP family, padded out to each shape: every
    # seed at the shapes of the main path's bucket, two seeds at the shapes
    # that reach the rest of the launch plans (every cluster size the rule
    # chooses, a T the blocks do not divide, G 1 and G 64, T 1024, the state
    # in global scratch), and the main path's shape at every cluster size.
    k3_cases = 0
    k3_err = 0.0
    k3_obj_err = 0.0
    k3_shapes = ((8, 16), (16, 512), (32, 512))
    k3_plan_shapes = ((16, 64), (16, 128), (16, 256), (16, 300), (1, 512), (64, 512), (16, 1024), (128, 2048))
    k3_plans = [score_kernel.lp_launch_plan(g, t, 8) for g, t in k3_shapes + k3_plan_shapes]
    check({p.cluster for p in k3_plans} == {2, 4, 8, 16}
          and {p.state_in_shared for p in k3_plans} == {True, False}
          and any(t % p.types_per_block for p, (_, t) in zip(k3_plans, k3_shapes + k3_plan_shapes)),
          "the K3 shapes do not cover every launch plan")

    def k3_check(lp_args, got, label):
        nonlocal k3_cases, k3_err, k3_obj_err
        want = score_kernel.lp_relax_body(*lp_args, steps=300)
        torch.cuda.synchronize()
        obj_err = abs(float(got.objective) - float(want.objective)) / abs(float(want.objective))
        err = float((got.assignment - want.assignment).abs().max())
        check(obj_err <= LP_OBJECTIVE_RTOL and err <= LP_ASSIGNMENT_ATOL,
              f"K3 differs from its plain version at {label}: "
              f"objective {obj_err:.3e} relative, assignment {err:.3e}")
        k3_err = max(k3_err, err)
        k3_obj_err = max(k3_obj_err, obj_err)
        k3_cases += 1

    for seed in LP_SEEDS:
        for shape in k3_shapes + (k3_plan_shapes if seed in LP_SEEDS[:2] else ()):
            lp_args = lp_inputs(seed, shape, device)
            k3_check(lp_args, score_kernel.lp_relax(*lp_args, steps=300), f"seed {seed} shape {shape}")
    for cluster in (2, 4, 8, 16):
        lp_args = lp_inputs(LP_SEEDS[0], (16, 512), device)
        plan = score_kernel.lp_plan_for_cluster(16, 512, 8, cluster)
        k3_check(lp_args, score_kernel._launch(*lp_args, 300, plan), f"cluster {cluster}")
    # The 50k problem: its prices tie per core within a family, so the LP is
    # degenerate and only the objective is determined by the inputs (PERF.md).
    main_solvable = torch.where(
        score_kernel.feasibility_mask(vectors, capacity, valid).any(dim=1), counts, 0)
    main_lp = (vectors, main_solvable, capacity, valid, main_prices)
    got = score_kernel.lp_relax(*main_lp, steps=300)
    want = score_kernel.lp_relax_body(*main_lp, steps=300)
    torch.cuda.synchronize()
    main_obj_err = abs(float(got.objective) - float(want.objective)) / abs(float(want.objective))
    main_assign_err = float((got.assignment - want.assignment).abs().max())
    again = score_kernel.lp_relax(*main_lp, steps=300)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)), "two launches of K3 differ on the 50k problem")
    main_row_err = float((got.assignment.sum(dim=1) - main_solvable.float()).abs().max())
    print(f"  K3 on the 50k problem: objective {main_obj_err:.3e} relative, assignment "
          f"max abs {main_assign_err:.3e} pods (degenerate), row sums {main_row_err:.3e} pods off the counts")
    check(main_obj_err <= LP_OBJECTIVE_RTOL, f"K3 objective differs on the 50k problem: {main_obj_err:.3e}")
    # K6 on every case of k6_cases, bit for bit; two launches alike.
    k6_plans = [pack_kernel.levels_launch_plan(g, t, 8) for g, t, _, _ in K6_SHAPES]
    check({p.tables_in_shared for p in k6_plans} == {True, False}
          and {p.placed_in_registers for p in k6_plans} == {True, False}
          and {p.cluster for p in k6_plans} == {1, 2, 4, 8, 16}
          and any(t % 32 for _, t, _, _ in K6_SHAPES),
          "the K6 shapes do not cover every launch plan")
    k6_cases_run = 0
    k6_err = 0.0
    tied = [(name, operands, "cost") for name, _, operands in tied_weight_cases() if operands is not None]
    for name, operands, mode in list(k6_cases()) + tied:
        tensors = upload_packed(list(operands), device)
        got = pack_kernel.pack_kernel_levels(*tensors, mode=mode)
        want = plain_levels(tensors, mode)
        torch.cuda.synchronize()
        check(level_packs_equal(got, want), f"K6 differs from its plain version on {name}")
        k6_err = max(k6_err, level_pack_abs_err(got, want))
        k6_cases_run += 1
        if k6_cases_run == 4:
            again = pack_kernel.pack_kernel_levels(*tensors, mode=mode)
            torch.cuda.synchronize()
            check(level_packs_equal(got, again), f"two launches of K6 differ on {name}")
    # K2q (the quirk) on every case of k2q_cases, bit for bit; two launches
    # alike.
    k2q_cases_run = 0
    k2q_err = 0.0
    for label, problem, modes in k2q_cases(tuple(padded)):
        args = fused_args_from_numpy(*problem, device=device)
        for mode in modes:
            got = pack_kernel.pack_kernel(*args, quirk=True, mode=mode)
            plain = pack_kernel._pack_kernel_ref(*args, quirk=True, mode=mode)
            torch.cuda.synchronize()
            check(rounds_equal(got, plain), f"K2q {mode} differs from its plain version on {label}")
            k2q_err = max(k2q_err, rounds_abs_err(got, plain))
            k2q_cases_run += 1
        if label == "main path":
            again = pack_kernel.pack_kernel(*args, quirk=True, mode="ffd")
            torch.cuda.synchronize()
            check(rounds_equal(pack_kernel._pack_kernel_ref(*args, quirk=True, mode="ffd"), again),
                  "two launches of K2q differ on the main path")
    # K8 on every case of k8_cases, bit for bit: one array a call, then
    # batched as a flush and a view batch them.
    k8 = k8_check(device)
    k8_batched = k8_batched_check(device)
    # K10 on every case of k10_cases: bit for bit to the numpy column and
    # to its plain version.
    k10_cases = 0
    for prices_np, risks_np in k10_cases_list():
        want = forecast.penalize_prices(prices_np, risks_np)
        got = forecast.penalize_prices_torch(torch.from_numpy(prices_np).to(device), risks_np)
        plain = forecast_kernel._penalize_prices_ref(
            torch.from_numpy(prices_np).to(device), torch.from_numpy(risks_np).to(device),
            forecast.RISK_PRICE_WEIGHT)
        torch.cuda.synchronize()
        check(same_bytes(got.cpu().numpy(), want), f"K10 differs from the numpy column at T={len(want)}")
        check(same_bits(got, plain), f"K10 differs from its plain version at T={len(want)}")
        k10_cases += 1
    phase("kernels", k1_cases=k1_cases, k2_cases=k2_cases, k2q_cases=k2q_cases_run, k2q_max_abs_err=k2q_err,
          k3_cases=k3_cases, k4_cases=k4_cases,
          k6_cases=k6_cases_run, k8_cases=k8["cases"], k8_flushes=k8_batched["flushes"],
          k8_views=k8_batched["views"], k10_cases=k10_cases, k1_max_abs_err=k1_err, k2_max_abs_err=k2_err,
          k3_max_abs_err=k3_err, k4_max_abs_err=k4_err, k6_max_abs_err=k6_err, k8_max_abs_err=0,
          k3_objective_rel_err=f"{k3_obj_err:.3e}", k3_main_objective_rel_err=f"{main_obj_err:.3e}")

    # 3b. the Go-parity solver (K2q) against GreedySolver.
    go = go_parity_phase(device, child_result(greedy_child, "greedy_signature"))

    # 4. the main path, through the entry point a user calls.
    os.environ["KARPENTER_HOST_SOLVE"] = "0"
    cost_solver = solver.CostSolver(device="cuda")
    cuda_kernels.dominance_prices.launches = 0
    pack_kernel.pack_kernel.launches = 0
    score_kernel.lp_relax.launches = 0
    pack_kernel.pack_pair_payload.launches = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    result = cost_solver.solve(pods, catalog, Constraints())
    first_solve_ms = (time.perf_counter() - start) * 1e3
    solve_fetch_bytes = solver.LAST_FETCH_BYTES
    # K2's one launch is the pair with its epilogue (K4 inside it).
    launches = {
        "dominance_prices": cuda_kernels.dominance_prices.launches,
        "pack_kernel": pack_kernel.pack_kernel.launches,
        "lp_relax": score_kernel.lp_relax.launches,
        "pack_pair_payload": pack_kernel.pack_pair_payload.launches,
    }
    check(all(count == 1 for count in launches.values()),
          f"the main path's solve did not launch each kernel exactly once: {launches}")
    check(all_pods_placed_once(result, pods), "the main path did not place every pod exactly once")
    gpu_cost = result.projected_cost()
    check(np.isfinite(gpu_cost) and gpu_cost > 0, f"projected cost {gpu_cost} is not a finite price")
    solve_ms = []
    for _ in range(10):
        start = time.perf_counter()
        cost_solver.solve_encoded(groups, fleet)
        solve_ms.append((time.perf_counter() - start) * 1e3)
    phase(
        "solve", pods=len(pods), types=len(catalog), nodes=result.node_count,
        cost_per_hr=f"{gpu_cost:.6f}", encode_ms=f"{encode_ms:.3f}",
        first_solve_ms=f"{first_solve_ms:.3f}",
        p50_ms=f"{np.percentile(solve_ms, 50):.3f}", p99_ms=f"{np.percentile(solve_ms, 99):.3f}",
        launches=json.dumps(launches, separators=(",", ":")), fetch_bytes=solve_fetch_bytes,
    )

    # 5. the same encoded problem through the plain versions on the CPU. The
    # card's dispatch may not sync with the host, and returns before the card
    # is done: the host overlap work starts while the card computes.
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        start = time.perf_counter()
        handle = solver.cost_solve_dispatch(
            groups.vectors, groups.counts, fleet.capacity, fleet.total, fleet.prices, device="cuda")
        dispatch_ms = (time.perf_counter() - start) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode("default")
    still_running = not torch.cuda.current_stream().query()
    start = time.perf_counter()
    gpu_plan = solver.fetch_plan(handle)
    fetch_wait_ms = (time.perf_counter() - start) * 1e3
    check(still_running, "cost_solve_dispatch returned after the card had finished")
    # The fetch accounting (pack_kernel.fetch_bytes): what the fetch copied
    # from the card against the payload's shape math, as the reference's
    # tests/test_device_residency.py holds its handle.
    dispatch_fetch_bytes = solver.LAST_FETCH_BYTES
    payload_bytes = 4 * pack_kernel.compact_words_sharded(handle.num_groups, handle.shards) + 4
    check(dispatch_fetch_bytes == payload_bytes == solve_fetch_bytes,
          f"the fused solve fetched {dispatch_fetch_bytes} bytes (the solve {solve_fetch_bytes}), "
          f"not the payload's {payload_bytes}")
    check(handle.shards > 1 or payload_bytes == pack_kernel.compact_bytes(handle.num_groups),
          "compact_bytes disagrees with the single-device payload")
    check(pack_kernel.compact_bytes(16) <= 4096, "a 16-group payload is past 4 KiB")
    cpu_plan = solver.fetch_plan(
        solver.cost_solve_dispatch(groups.vectors, groups.counts, fleet.capacity, fleet.total, fleet.prices, device="cpu")
    )
    for name in ("rounds_ffd", "rounds_cost"):
        for a, b in zip(getattr(gpu_plan, name), getattr(cpu_plan, name)):
            check(np.array_equal(np.asarray(a), np.asarray(b)), f"{name} differs between the card and the CPU")
    check(np.array_equal(gpu_plan.feasible_any, cpu_plan.feasible_any), "feasible_any differs between the card and the CPU")
    cpu_result = solver.CostSolver(device="cpu").solve_encoded(groups, fleet)
    cpu_cost = cpu_result.projected_cost()
    rel = abs(gpu_cost - cpu_cost) / cpu_cost
    check(rel <= 1e-4, f"$/hr differs between the card ({gpu_cost}) and the CPU ({cpu_cost})")
    check(all_pods_placed_once(cpu_result, pods), "the CPU run did not place every pod exactly once")
    lp_rel = abs(gpu_plan.lp_objective - cpu_plan.lp_objective) / abs(cpu_plan.lp_objective)
    check(lp_rel <= 1e-3, f"LP objective differs between the card and the CPU by {lp_rel:.3e} relative")
    phase("cpu", rounds="identical", cost_rel_diff=f"{rel:.3e}", lp_objective_rel_diff=f"{lp_rel:.3e}",
          rounds_ffd=int(gpu_plan.rounds_ffd.num_rounds), rounds_cost=int(gpu_plan.rounds_cost.num_rounds),
          gpu_cost_per_hr=f"{gpu_cost:.6f}", cpu_cost_per_hr=f"{cpu_cost:.6f}",
          dispatch_sync_free="yes", dispatch_ms=f"{dispatch_ms:.3f}", fetch_wait_ms=f"{fetch_wait_ms:.3f}")
    phase("fetch", groups=handle.num_groups, shards=handle.shards, fetch_bytes=dispatch_fetch_bytes,
          compact_bytes=pack_kernel.compact_bytes(handle.num_groups),
          compact_bytes_16=pack_kernel.compact_bytes(16))

    # 5b. K3's own entry on bare arrays: lp_relax_solve on the main path's
    # dense problem, one launch of K3, against the fused solve's LP figures.
    bare_lp = [tensor.cpu().numpy() for tensor in main_lp]
    k3_before = score_kernel.lp_relax.launches
    bare = score_kernel.lp_relax_solve(*bare_lp, steps=300, device="cuda")
    torch.cuda.synchronize()
    bare_launches = score_kernel.lp_relax.launches - k3_before
    check(bare_launches == 1, f"lp_relax_solve launched K3 {bare_launches} times, not once")
    bare_obj_err = abs(float(bare.objective) - gpu_plan.lp_objective) / abs(gpu_plan.lp_objective)
    bare_assign_err = float(np.abs(bare.assignment.cpu().numpy() - gpu_plan.lp_assignment()).max())
    check(bare_obj_err <= LP_OBJECTIVE_RTOL and bare_assign_err <= LP_ASSIGNMENT_ATOL,
          f"lp_relax_solve differs from the fused solve's LP: objective {bare_obj_err:.3e} relative, "
          f"assignment {bare_assign_err:.3e}")
    phase("lp_relax_solve", launches=bare_launches, objective=f"{float(bare.objective):.6f}",
          objective_rel_err=f"{bare_obj_err:.3e}", assignment_max_abs_err=f"{bare_assign_err:.3e}")

    # 5c. the certified plan-cost floor (mix_pack.certified_lp_floor, the
    # reference bench's lp_bound) on the main path's groups and fleet: each
    # type's cheapest pool price as its column price, as bench.py builds it.
    _, pool_prices = solver._pool_price_matrix(fleet)
    pool_floor = np.where(np.isfinite(pool_prices), pool_prices, np.inf).min(axis=1)
    start = time.perf_counter()
    floor = mix_pack.certified_lp_floor(groups.vectors, groups.counts, fleet.capacity, pool_floor)
    floor_s = time.perf_counter() - start
    if floor is None:
        phase("plan_floor", cost_per_hr=f"{gpu_cost:.6f}", floor="none (no milp, or no column)",
              seconds=f"{floor_s:.3f}")
    else:
        floor_cost, certified = floor
        # No plan costs less than a certified lower bound.
        check(not certified or floor_cost <= gpu_cost * (1 + 1e-6),
              f"the certified floor {floor_cost} lies above the plan's $/hr {gpu_cost}")
        phase("plan_floor", cost_per_hr=f"{gpu_cost:.6f}", floor_per_hr=f"{floor_cost:.6f}",
              certified=certified, plan_over_floor=f"{gpu_cost / floor_cost:.6f}",
              seconds=f"{floor_s:.3f}")

    # 6. a batch of 8 schedules sharing one fetch.
    batch = [(pods[k::8], catalog, Constraints(), ()) for k in range(8)]
    encoded = solver.Solver._encode_problems(batch)
    cost_solver.solve_encoded_many(encoded)  # warm
    start = time.perf_counter()
    batch_results = cost_solver.solve_encoded_many(encoded)
    batch_ms = (time.perf_counter() - start) * 1e3
    for (schedule_pods, *_), schedule_result in zip(batch, batch_results):
        check(all_pods_placed_once(schedule_result, schedule_pods), "a batched schedule lost pods")
    phase("batch", schedules=len(batch), pods=sum(len(b[0]) for b in batch), batch8_ms=f"{batch_ms:.3f}")

    # 7. the incremental encode under steady-state churn (K8), the
    # provisioning pass's fast path through it, and the device-memory
    # ladder on the fast path's 8-schedule batch.
    churn = incremental_phase(device)
    fast = fast_path_phase(catalog, cost_solver, device, cpu_cost)
    oom_ladder_phase(cost_solver, fast["encoded"], fast["plans"])

    # 8. the consolidation path: one sweep at the large-cluster envelope.
    sweep = consolidate_phase(catalog, device)
    k7_operands = sweep["operands"]
    c_pad, g_pad, dims_c = k7_operands[0].shape

    # 9. the constrained path: the main path's pods under a zonal spread
    # and two preferences, through Scheduler and solve_constrained.
    levels = constrained_phase(catalog, device, mirror_modes=("cost",))

    # 10. many shapes: K2 and K3 past the sizes they once refused.
    large = large_shapes_phase(catalog, device)
    plan_cases = 0
    plan_err = 0.0
    # K2's pair, and with its epilogue (K4: the scan at 1,024 threads over
    # thousands of tiles; at G 8,192 the tables, which its warp counts
    # reuse, in global scratch).
    for num_groups_x, num_types_x, real in ((2048, 512, 200), (16, 8192, 200), (8192, 64, 40)):
        args = fused_args_from_numpy(*sparse_pack_problem(3, num_groups_x, num_types_x, real), device=device)
        label = f"G={num_groups_x} T={num_types_x}"
        pair = pack_kernel.pack_kernel_pair(*args)
        plain = pack_kernel._pack_pair_payload_ref(*args, True)
        for mode, got, want in zip(("ffd", "cost"), pair, plain[:2]):
            torch.cuda.synchronize()
            check(rounds_equal(got, want), f"K2 {mode} differs from its plain version at {label}")
            plan_err = max(plan_err, rounds_abs_err(got, want))
            plan_cases += 1
        k4_err = max(k4_err, fused_against_plain(args, plain, pair, label))
        k4_cases += 1
    for shape in ((2048, 512), (16, 8192), (2048, 2048)):
        lp_args = lp_inputs(LP_SEEDS[0], shape, device)
        k3_check(lp_args, score_kernel.lp_relax(*lp_args, steps=300), f"launch plan at {shape}")
        plan_cases += 1
    print(f"  launch plans past the old limits: {plan_cases} cases, K2 max abs err {plan_err}, "
          f"K2 at G 2048 T 512: {pack_kernel.pack_launch_plan(2048, 512, 8)}, "
          f"K2 at T 8192: {pack_kernel.pack_launch_plan(16, 8192, 8)}, "
          f"K2 at G 8192 T 64: {pack_kernel.pack_launch_plan(8192, 64, 8)}, "
          f"K3 at G 2048 T 2048: {score_kernel.lp_launch_plan(2048, 2048, 8)}")

    # 10b. the provisioning controllers under a live spot market: 50,000
    # pods through the port's Manager in 2,000-pod windows.
    storm = provision_storm_phase(device)

    # 10d. the sharded solve (K9a, K9b) on 2x2 and 2x4 virtual meshes of the
    # card, while the controller process still runs: its event and wall
    # times carry that host load (K9a is bound by its launches); its
    # kernels' device times are taken in the timing phase, after it ends.
    sharded = sharded_phase(device, pods, catalog, groups, fleet, levels["operands"], large["lp"])

    # 10c. the controller process (cmd/controller.main), started after the
    # build.
    controller = child_result(controller_child, "controller_result")
    lifecycle = controller["lifecycle"]
    # 10f. the controller on a live apiserver with the EC2 provider.
    apiserver = child_result(apiserver_child, "apiserver_result")
    apiserver_launches = apiserver["launches"]

    # 10e. the multi-process sharded solve: two processes share the card
    # over gloo, two shards each (after the controller child, so that its
    # timings carry no other process's load but its follower's).
    multiprocess = multiprocess_phase(device, pods, groups, fleet)
    mp_launches = multiprocess["launches_per_rank"]

    # 10g. the solver sidecar in processes of its own, once every other
    # child has ended; 10h. the admission webhook.
    sidecar = sidecar_phase(device, pods, catalog, groups, fleet, fast["encoded"], cost_solver)
    sidecar_launches = sidecar["launches_per_solve"]
    webhook_phase()

    # 11. kernel timing at the main path's shapes.
    num_types, dims = capacity.shape
    num_groups = vectors.shape[0]
    valid_prices = torch.where(valid, prices, torch.inf)
    k1_call = functools.partial(cuda_kernels.dominance_prices, capacity, valid_prices)
    k1_event_ms = time_cuda(k1_call, reps=200)
    # Profiled in windows of 50 launches: on an H100, 200-launch windows of
    # this 3 us kernel lost 23 records each, past what the check allows.
    k1_ms = device_ms_per_call(k1_call, ["dominance_kernel"], reps=50)
    k1_plain_ms = time_cuda(lambda: cuda_kernels._dominance_prices_ref(capacity, valid_prices), reps=200)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    k1_plan = cuda_kernels.dominance_launch_plan(num_types, dims, sms)
    # K1 at T 4,096 (32 rows a block): the last dominance case.
    wide_capacity, wide_prices = (torch.from_numpy(a).to(device) for a in list(dominance_cases())[-2])
    k1_wide_call = functools.partial(cuda_kernels.dominance_prices, wide_capacity, wide_prices)
    k1_wide_ms = device_ms_per_call(k1_wide_call, ["dominance_kernel"], reps=50)
    k1_wide_event_ms = time_cuda(k1_wide_call, reps=200)
    k1_wide_plan = cuda_kernels.dominance_launch_plan(wide_capacity.shape[0], dims, sms)
    k1_bytes = 4 * (num_types * dims + 2 * num_types)
    k1_ops = num_types * num_types * (dims + 1)
    k2_call = functools.partial(
        pack_kernel.pack_kernel_pair, vectors, counts, capacity, total, valid, main_prices)
    k2_event_ms = time_cuda(k2_call, reps=50)
    k2_ms = device_ms_per_call(k2_call, ["pack_rounds_kernel"], reps=50)
    k2_plain_ms = time_cuda(
        lambda: [pack_kernel._pack_kernel_ref(vectors, counts, capacity, total, valid, main_prices, mode=m) for m in ("ffd", "cost")],
        reps=5, warmup=1,
    )
    # Each mode alone: its device time over its rounds; the pair takes as
    # long as its slower mode, whose time per round the line reports.
    k2_mode_us = {}
    for mode, plan_rounds in (("ffd", gpu_plan.rounds_ffd), ("cost", gpu_plan.rounds_cost)):
        mode_ms = device_ms_per_call(functools.partial(
            pack_kernel.pack_kernel, vectors, counts, capacity, total, valid, main_prices, mode=mode),
            ["pack_rounds_kernel"], reps=20)
        k2_mode_us[mode] = (mode_ms, mode_ms * 1e3 / max(int(plan_rounds.num_rounds), 1))
    k2_slow_mode = max(k2_mode_us, key=lambda m: k2_mode_us[m][0])
    print("  K2 per mode: " + ", ".join(
        f"{m} {ms:.4f} ms, {us:.3f} us a round" for m, (ms, us) in k2_mode_us.items()))
    words = pack_kernel.LIBRARY.load().ktt_pack_rounds_words(num_groups)
    k2_bytes = 4 * (num_groups * dims + num_groups + num_types * dims + num_types) + num_types + 2 * 4 * words
    # Operations this run's data needs: per mode and round, the group scan
    # over every valid type for the groups still holding pods (a division,
    # a minimum, a multiply and a subtract per axis the group requests, an
    # add and a floor).
    valid_types = int(valid.sum())
    scan = valid_types * (4 * (vectors[: groups.num_groups] > 0).sum(dim=1) + 2).long().cpu().numpy()
    k2_ops = 0
    for plan_rounds in (gpu_plan.rounds_ffd, gpu_plan.rounds_cost):
        remaining = groups.counts.astype(np.int64).copy()
        for r in range(int(plan_rounds.num_rounds)):
            k2_ops += int(scan[remaining > 0].sum())
            remaining -= plan_rounds.round_repl[r] * plan_rounds.round_fill[r, : groups.num_groups]

    def bound(byte_count, op_count):
        byte_ms = byte_count / HBM_BYTES_PER_S * 1e3
        op_ms = op_count / FP32_OPS_PER_S * 1e3
        return max(byte_ms, op_ms), ("bytes" if byte_ms >= op_ms else "operations")

    lp_steps = 300
    k3_call = functools.partial(score_kernel.lp_relax, *main_lp, steps=lp_steps)
    k3_event_ms = time_cuda(k3_call, reps=20)
    k3_ms = device_ms_per_call(k3_call, ["lp_relax_kernel"], reps=20)
    k3_plain_ms = time_cuda(lambda: score_kernel.lp_relax_body(*main_lp, steps=lp_steps), reps=5, warmup=1)
    # Every cluster size at the main path's shape; the rule's choice is
    # the launch plan lp_relax takes.
    k3_sweep = {}
    for cluster in (2, 4, 8, 16):
        plan = score_kernel.lp_plan_for_cluster(num_groups, num_types, dims, cluster)
        k3_sweep[cluster] = device_ms_per_call(
            functools.partial(score_kernel._launch, *main_lp, lp_steps, plan), ["lp_relax_kernel"], reps=20)
    k3_rule = score_kernel.lp_launch_plan(num_groups, num_types, dims)
    print(f"  K3 cluster sweep (device ms, rule picks {k3_rule.cluster}): " + ", ".join(
        f"{cluster}: {ms:.4f}" for cluster, ms in k3_sweep.items()))
    # Each input read once (the bias table included), each output written once.
    k3_bytes = (4 * (num_groups * dims + num_groups + num_types * dims + num_types + 2 * lp_steps)
                + num_types + 4 * (num_groups * num_types + num_types + 1))
    k3_ops = lp_operations(num_groups, num_types, dims, lp_steps)

    # K4 runs in the epilogue of K2's pair launch: its share of that launch
    # is measured in a fresh process at the end (fused_alone).
    main_fused = pack_kernel.pack_pair_payload(vectors, counts, capacity, total, valid, main_prices)
    k4_plain_ms = time_cuda(lambda: pack_kernel._compact_plan_ref(
        main_fused.rounds_ffd, main_fused.rounds_cost, main_fused.feasible_any), reps=50)
    mr = pack_kernel.max_rounds(num_groups)
    # Per mode round_type and round_repl [MR], round_fill [MR, G],
    # unschedulable [G], num_rounds and overflow read, feasible_any read,
    # the payload written; a compare and a scan add per fill cell.
    k4_bytes = (2 * 4 * (2 * mr + 2 + mr * num_groups + num_groups) + num_groups
                + 4 * pack_kernel.compact_words(num_groups))
    k4_ops = 2 * 2 * mr * num_groups

    k7_axes = sweep["axes"]
    k7_call = functools.partial(consolidate_kernel.solve_counterfactuals, *k7_operands, axes=k7_axes)
    k7_event_ms = time_cuda(k7_call, reps=20)
    k7_ms = device_ms_per_call(k7_call, ["counterfactual_kernel"], reps=20)
    k7_plain_ms = time_cuda(lambda: consolidate_kernel._counterfactual_ref(*k7_operands), reps=5, warmup=1)
    k7_bins, k7_types = k7_operands[2].shape[0], k7_operands[4].shape[0]
    k7_bytes = k7_needed_bytes(k7_operands)
    # Per plan cell, for each axis the group requests: a division, a max, a
    # min, and the room's multiply and subtract; then the floor and its add,
    # the infinite check, the clamp, the scan's add and two subtracts and
    # the take's clip (9). Per candidate and type, an add and a compare per
    # axis, the select and the minimum; per candidate and group, the demand.
    requested = (k7_operands[0] > 0).sum(dim=2).cpu().numpy()  # [C, G]
    k7_ops = int(k7_bins * (5 * requested.sum() + 9 * requested.size)
                 + c_pad * k7_types * (2 * dims_c + 2) + 2 * c_pad * g_pad * dims_c)

    # K2q, the Go-parity mode (ffd with the quirk), at the main path's
    # shape: its rounds, and the operations they need (K2's count, plus the
    # quirk's compare on every axis of every scanned group).
    quirk_call = functools.partial(pack_kernel.pack_kernel, *main_args, quirk=True, mode="ffd")
    k2q_event_ms = time_cuda(quirk_call, reps=50)
    k2q_ms = device_ms_per_call(quirk_call, ["pack_rounds_kernel"], reps=50)
    k2q_plain_ms = time_cuda(
        lambda: pack_kernel._pack_kernel_ref(*main_args, quirk=True, mode="ffd"), reps=5, warmup=1)
    quirk_rounds = solver._to_host(quirk_call())
    scan_q = valid_types * (4 * (vectors[: groups.num_groups] > 0).sum(dim=1) + 2 + dims).long().cpu().numpy()
    k2q_ops = 0
    remaining = groups.counts.astype(np.int64).copy()
    for r in range(int(quirk_rounds.num_rounds)):
        k2q_ops += int(scan_q[remaining > 0].sum())
        remaining -= quirk_rounds.round_repl[r] * quirk_rounds.round_fill[r, : groups.num_groups]
    k2q_bytes = (4 * (num_groups * dims + num_groups + 2 * num_types * dims + num_types) + num_types
                 + 4 * words)
    k2q_bound, k2q_by = bound(k2q_bytes, k2q_ops)
    print(f"  K2q at the main path: {int(quirk_rounds.num_rounds)} rounds, "
          f"{k2q_ms * 1e3 / max(int(quirk_rounds.num_rounds), 1):.3f} us a round")
    k1_bound, k1_by = bound(k1_bytes, k1_ops)
    k2_bound, k2_by = bound(k2_bytes, k2_ops)
    k3_bound, k3_by = bound(k3_bytes, k3_ops)
    k4_bound, k4_by = bound(k4_bytes, k4_ops)
    k7_bound, k7_by = bound(k7_bytes, k7_ops)
    kernels = [
        {
            "name": "dominance_prices", "route": "cuda",
            "source": "karpenter_tpu_torch/csrc/dominance.cu",
            "replaces": "karpenter_tpu/ops/pallas_kernels.py:63",
            "launches": launches["dominance_prices"], "max_abs_err": k1_err,
            "launches_controller": controller["storm_launches"]["dominance_prices"],
            "launches_controller_lifecycle": lifecycle["k1"],
            "launches_apiserver": apiserver_launches["dominance_prices"],
            "launches_multiprocess_per_rank": mp_launches["dominance_prices"],
            "launches_sidecar_per_solve": sidecar_launches["dominance_prices"],
            "ms": k1_ms, "event_ms": k1_event_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
            "bound_by": k1_by, "library_ms": None, "blocks": k1_plan.blocks, "rows_per_block": k1_plan.rows,
            "ms_t4096": k1_wide_ms, "event_ms_t4096": k1_wide_event_ms, "blocks_t4096": k1_wide_plan.blocks,
        },
        {
            "name": "pack_kernel", "route": "cuda",
            "source": "karpenter_tpu_torch/csrc/pack_rounds.cu",
            "replaces": "karpenter_tpu/ops/pack_kernel.py:141",
            "launches": launches["pack_kernel"], "max_abs_err": k2_err,
            "ms": k2_ms, "event_ms": k2_event_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
            "bound_by": k2_by, "library_ms": None,
            "us_per_round": k2_mode_us[k2_slow_mode][1], "slower_mode": k2_slow_mode,
            "launches_single_mode": storm["k2_single_launches"],
            "launches_controller": controller["storm_launches"]["pack_kernel"],
            "launches_controller_lifecycle": lifecycle["k2"],
            "launches_apiserver": apiserver_launches["pack_pair_payload"],
            "launches_multiprocess_per_rank": mp_launches["pack_pair_payload"],
            "launches_sidecar_per_solve": sidecar_launches["pack_kernel"],
        },
        {
            "name": "pack_kernel_quirk", "route": "cuda",
            "source": "karpenter_tpu_torch/csrc/pack_rounds.cu",
            "replaces": "karpenter_tpu/ops/pack_kernel.py:141",
            "launches": go["launches"], "max_abs_err": k2q_err,
            "ms": k2q_ms, "event_ms": k2q_event_ms, "plain_ms": k2q_plain_ms, "bound_ms": k2q_bound,
            "bound_by": k2q_by, "library_ms": None, "cases": k2q_cases_run,
            "rounds": int(quirk_rounds.num_rounds),
        },
        {
            "name": "lp_relax", "route": "cuda",
            "source": "karpenter_tpu_torch/csrc/lp_relax.cu",
            "replaces": "karpenter_tpu/ops/score_kernel.py:77",
            "launches": launches["lp_relax"], "max_abs_err": k3_err,
            "launches_controller": controller["storm_launches"]["lp_relax"],
            "launches_controller_lifecycle": lifecycle["k3"],
            "launches_apiserver": apiserver_launches["lp_relax"],
            "launches_multiprocess_per_rank": mp_launches["lp_relax"],
            "launches_sidecar_per_solve": sidecar_launches["lp_relax"],
            "ms": k3_ms, "event_ms": k3_event_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound,
            "bound_by": k3_by, "library_ms": None,
            "us_per_step": k3_ms * 1e3 / lp_steps, "cluster": k3_rule.cluster,
        },
        {
            # In the epilogue of K2's pair launch: `launches` counts the
            # launches that ran it (the pair's), `ms` its share of them.
            "name": "compact_plan", "route": "cuda",
            "source": "karpenter_tpu_torch/csrc/compact_rounds.cuh",
            "replaces": "karpenter_tpu/ops/pack_kernel.py:616",
            "launches": launches["pack_pair_payload"], "standalone_launches": 0,
            "fused_into": "pack_kernel", "max_abs_err": k4_err, "cases": k4_cases,
            "launches_controller": controller["storm_launches"]["pack_pair_payload"],
            "launches_apiserver": apiserver_launches["pack_pair_payload"],
            "launches_sidecar_per_solve": sidecar_launches["pack_kernel"],
            "plain_ms": k4_plain_ms,
            "bound_ms": k4_bound, "bound_by": k4_by, "library_ms": None,
        },
        {
            "name": "solve_counterfactuals", "route": "cuda",
            "source": "karpenter_tpu_torch/csrc/consolidate.cu",
            "replaces": "karpenter_tpu/ops/consolidate.py:142",
            "launches": sweep["launches"], "max_abs_err": sweep["max_abs_err"],
            "ms": k7_ms, "event_ms": k7_event_ms, "plain_ms": k7_plain_ms, "bound_ms": k7_bound,
            "bound_by": k7_by, "library_ms": None,
            "launches_controller": controller["k7_launches"], "ms_controller": controller["k7_ms"],
            "launches_apiserver": apiserver["k7_launches"],
            "event_ms_controller": controller["k7_event_ms"], "shape_controller": controller["k7_shape"],
            "cluster_controller": controller["k7_cluster"], "cluster": sweep["cluster"],
        },
    ]
    # K6 at the constrained path's shapes, in the mode the solve runs.
    k6_operands = levels["operands"]
    k6_call = functools.partial(pack_kernel.pack_kernel_levels, *k6_operands, mode="cost")
    k6_event_ms = time_cuda(k6_call, reps=20)
    k6_ms = device_ms_per_call(k6_call, ["pack_levels_kernel", "select_kernel"], reps=20)
    k6_plain_ms = time_cuda(lambda: plain_levels(k6_operands, "cost"), reps=3, warmup=1)
    k6_bytes, k6_ops, k6_rounds = k6_needed(k6_operands)
    k6_bound, k6_by = bound(k6_bytes, k6_ops)
    k6_plan = pack_kernel.levels_launch_plan(
        k6_operands[0].shape[0], k6_operands[2].shape[0], k6_operands[0].shape[1])
    # The levels run side by side: the one with the most rounds sets the time.
    k6_us_per_round = k6_ms * 1e3 / max(max(k6_rounds), 1)
    print(f"  K6 at the constrained cell: rounds a level {k6_rounds}, {k6_us_per_round:.3f} us a round "
          f"(cluster {k6_plan.cluster}, {k6_plan.lanes} lanes a type, {k6_plan.threads} threads)")
    kernels.append({
        "name": "pack_kernel_levels", "route": "cuda",
        "source": "karpenter_tpu_torch/csrc/pack_levels.cu",
        "replaces": "karpenter_tpu/ops/pack_kernel.py:446",
        "launches": levels["launches"], "max_abs_err": max(levels["max_abs_err"], k6_err),
        "ms": k6_ms, "event_ms": k6_event_ms, "plain_ms": k6_plain_ms, "bound_ms": k6_bound,
        "bound_by": k6_by, "library_ms": None,
        "cluster": k6_plan.cluster, "lanes": k6_plan.lanes, "rounds": k6_rounds,
        "us_per_round": k6_us_per_round,
    })
    # K8: one steady-state sweep's scatters and gathers on the churn
    # phase's arrays.
    k8_scatters, k8_gathers, k8_bytes = k8_sweep_operands(churn["state"], churn["deltas"], device)

    def k8_call(flush=incremental.scatter_flush, view=incremental.gather_view):
        flush(k8_scatters)
        view([src for src, _ in k8_gathers], k8_gathers[0][1])

    # Every device record of a sweep's call, copies included: the flush's
    # copies of the old rows run inside its one launch.
    # (A profiler session late in the run may drop a record: device_ms_per_call
    # measures again then, so this only checks that nothing else ran.)
    k8_launches = {"scatter_flush_kernel": 1, "gather_view_kernel": 1}
    k8_records = kernel_records(k8_call, copies=True)
    check(all(k8_launches.get(name, 0) >= count for name, count in k8_records.items()),
          f"a sweep's K8 call made the device records {k8_records}, not one flush and one view launch")
    k8_ms = device_ms_per_call(k8_call, k8_launches, reps=50)
    k8_event_ms = time_cuda(k8_call, reps=50)
    k8_plain_ms = time_cuda(functools.partial(
        k8_call, incremental._scatter_flush_ref, incremental._gather_view_ref), reps=20)
    k8_bound, k8_by = bound(k8_bytes, 0)
    kernels.append({
        "name": "incremental_scatter_gather", "route": "cuda",
        "source": "karpenter_tpu_torch/csrc/incremental.cu",
        "replaces": "karpenter_tpu/ops/incremental.py:37",
        "launches": churn["launches"]["scatter"] + churn["launches"]["gather"], "max_abs_err": 0.0,
        "ms": k8_ms, "event_ms": k8_event_ms, "plain_ms": k8_plain_ms, "bound_ms": k8_bound,
        "bound_by": k8_by, "library_ms": None,
        "launches_scatter": churn["launches"]["scatter"], "launches_gather": churn["launches"]["gather"],
        "flushes": churn["flushes"], "cases": k8["cases"], "batched_flushes": k8_batched["flushes"],
        "batched_views": k8_batched["views"], "records_per_sweep": k8_records, "bytes": k8_bytes,
    })
    # K10 on the storm fleet's own [T] column and risks.
    k10_prices = torch.from_numpy(storm["prices"]["prices"]).to(device)
    k10_risks = torch.from_numpy(storm["prices"]["risks"]).to(device)
    weight = forecast.RISK_PRICE_WEIGHT
    k10_call = functools.partial(forecast_kernel.penalize_prices, k10_prices, k10_risks, weight)
    k10_event_ms = time_cuda(k10_call, reps=200)
    k10_ms = device_ms_per_call(k10_call, ["penalize_kernel"], reps=200)
    k10_plain_ms = time_cuda(
        lambda: forecast_kernel._penalize_prices_ref(k10_prices, k10_risks, weight), reps=200)
    library_call = functools.partial(torch.addcmul, k10_prices, k10_prices, k10_risks, value=weight)
    k10_library_ms = time_cuda(library_call, reps=200)
    k10_paired_ms, k10_library_device_ms, library_kernel = k10_against_library_device_ms(
        k10_call, library_call, reps=200)
    print(f"k10_against_addcmul device_ms={k10_paired_ms:.6f} addcmul_device_ms={k10_library_device_ms:.6f} "
          f"addcmul_event_ms={k10_library_ms:.4f} addcmul_kernel={library_kernel!r} (in turns, one profile)")
    library_same = same_bits(library_call(), k10_call())
    k10_types = k10_prices.shape[0]
    k10_bound, k10_by = bound(3 * 4 * k10_types, 3 * k10_types)
    print(f"  K10 at T={k10_types}: torch.addcmul {k10_library_ms:.4f} ms, "
          f"{'the same bits' if library_same else 'other bits'} than K10")
    # The card's launch floor: an empty kernel through the same ctypes and
    # launch_stream path, timed as K10 and K4 are.
    floor_call = functools.partial(launch_floor.empty_launch, k10_prices)
    floor_event_ms = time_cuda(floor_call, reps=200)
    floor_ms = device_ms_per_call(floor_call, ["empty_kernel"], reps=200)
    print(f"launch_floor device_ms={floor_ms:.6f} event_ms={floor_event_ms:.4f} "
          f"k10_device_ms={k10_ms:.6f} k10_event_ms={k10_event_ms:.4f} "
          f"source=karpenter_tpu_torch/csrc/launch_floor.cu")
    kernels.append({
        "name": "penalize_prices", "route": "cuda",
        "source": "karpenter_tpu_torch/csrc/forecast.cu",
        "replaces": "karpenter_tpu/market/forecast.py:77",
        "launches": storm["k10_launches"], "max_abs_err": storm["k10_err"],
        "ms": k10_ms, "event_ms": k10_event_ms, "plain_ms": k10_plain_ms, "bound_ms": k10_bound,
        "bound_by": k10_by, "library_ms": k10_library_ms, "library_same_bits": library_same,
        "library_device_ms": k10_library_device_ms, "ms_same_session": k10_paired_ms,
        "floor_ms": floor_ms, "floor_event_ms": floor_event_ms,
        "cases": k10_cases, "types": k10_types,
    })
    # K2 and K3 at the many-shapes schedule's padded G 2,048: milliseconds
    # a launch, so CUDA events around the wrapper.
    big_args = large["args"]
    k2_big_ms = time_cuda(functools.partial(pack_kernel.pack_kernel_pair, *big_args), reps=5, warmup=1)
    k3_big_ms = time_cuda(functools.partial(score_kernel.lp_relax, *large["lp"], steps=lp_steps),
                          reps=5, warmup=1)
    print(f"  at G={big_args[0].shape[0]} T={big_args[2].shape[0]}: K2 pair {k2_big_ms:.4f} ms, "
          f"K3 {k3_big_ms:.4f} ms (CUDA events)")
    # K9a and K9b at the main path's shapes on the 2x4 mesh (the 2x2
    # mesh's numbers beside). K9a does the LP's work, so K3's bound; K9b
    # reads both modes' fills, headers and feasible_any, and writes the
    # whole payload.
    sharded_device_ms(sharded, lp_steps)
    wide, square = sharded["meshes"]["2x4"], sharded["meshes"]["2x2"]
    k9b_shards = wide["shards"]
    k9b_bound, k9b_by = bound(
        2 * 4 * mr * num_groups + 2 * 4 * (2 * mr + num_groups + 2) + num_groups
        + 4 * pack_kernel.compact_words_sharded(num_groups, k9b_shards),
        2 * 2 * mr * num_groups)
    # K9a at G 2,048 x T 512: the same LP's work at that width.
    big_g, big_t, big_r = sharded["g2048"]["lp"]
    k9a_big_bound, k9a_big_by = bound(
        4 * (big_g * big_r + big_g + big_t * big_r + big_t + 2 * lp_steps) + big_t
        + 4 * (big_g * big_t + big_t + 1),
        lp_operations(big_g, big_t, big_r, lp_steps))
    kernels.append({
        "name": "lp_shard", "route": "cuda",
        "source": "karpenter_tpu_torch/csrc/lp_shard.cu",
        "replaces": "karpenter_tpu/models/solver.py:500",
        "launches": wide["launches"]["lp_shard"], "max_abs_err": max(wide["k9a_err"], square["k9a_err"]),
        "ms": wide["k9a_ms"], "event_ms": wide["k9a_event_ms"], "plain_ms": wide["k9a_plain_ms"],
        "bound_ms": k3_bound, "bound_by": k3_by, "library_ms": None,
        "mesh": "2x4", "lp_route": "persistent", "blocks": wide["k9a_plan"].blocks,
        "us_per_step": wide["k9a_ms"] * 1e3 / lp_steps,
        "launches_per_solve": wide["launches"]["lp_shard"],
        "ms_2x2": square["k9a_ms"], "event_ms_2x2": square["k9a_event_ms"],
        "plain_ms_2x2": square["k9a_plain_ms"], "launches_2x2": square["launches"]["lp_shard"],
        "blocks_2x2": square["k9a_plan"].blocks, "us_per_step_2x2": square["k9a_ms"] * 1e3 / lp_steps,
        "ms_g2048": sharded["g2048"]["k9a_ms"], "event_ms_g2048": sharded["g2048"]["k9a_event_ms"],
        "bound_ms_g2048": k9a_big_bound, "bound_by_g2048": k9a_big_by,
        "blocks_g2048": sharded["g2048"]["blocks"], "k3_event_ms_g2048": k3_big_ms,
        # The per-phase route (a mesh across cards) forced on the 2x4 mesh.
        "launches_per_phase": sharded["per_phase"]["launches"], "ms_per_phase": sharded["per_phase"]["ms"],
        "event_ms_per_phase": sharded["per_phase"]["event_ms"],
        "us_per_step_per_phase": sharded["per_phase"]["ms"] * 1e3 / lp_steps,
        "objective_rel_per_phase": sharded["per_phase"]["objective_rel"],
        "ms_per_phase_g2048": sharded["g2048"]["per_phase_ms"],
        "event_ms_per_phase_g2048": sharded["g2048"]["per_phase_event_ms"],
        # The 2-process mesh (the per-phase route, each rank its two shards).
        "launches_multiprocess_per_rank": mp_launches["lp_shard"],
        "ms_multiprocess_by_rank": {rank: sum(ms for name, ms in by_kernel.items() if "lp_shard" in name)
                                    for rank, by_kernel in multiprocess["device_ms_by_kernel"].items()},
    })
    kernels.append({
        "name": "compact_shard", "route": "cuda",
        "source": "karpenter_tpu_torch/csrc/compact_shard.cu",
        "replaces": "karpenter_tpu/ops/pack_kernel.py:709",
        "launches": wide["launches"]["compact_shard"], "max_abs_err": 0,
        "ms": wide["k9b_ms"], "event_ms": wide["k9b_event_ms"], "plain_ms": wide["k9b_plain_ms"],
        "bound_ms": k9b_bound, "bound_by": k9b_by, "library_ms": None, "mesh": "2x4",
        "cases": wide["k9b"]["cases"] + square["k9b"]["cases"],
        "launches_per_solve": wide["launches"]["compact_shard"],
        "ms_2x2": square["k9b_ms"], "event_ms_2x2": square["k9b_event_ms"],
        "launches_2x2": square["launches"]["compact_shard"],
        # The per-card route (a mesh across cards) forced on the card: the
        # shards in runs of three, a launch each.
        "event_ms_per_card": wide["k9b_per_card_event_ms"],
        "event_ms_per_card_2x2": square["k9b_per_card_event_ms"],
        "launches_multiprocess_per_rank": mp_launches["compact_shard"],
        "ms_multiprocess_by_rank": {rank: sum(ms for name, ms in by_kernel.items() if "compact_shard" in name)
                                    for rank, by_kernel in multiprocess["device_ms_by_kernel"].items()},
    })
    phase("timing", shapes=f"T={num_types},R={dims},G={num_groups}", k7_shapes=f"C={c_pad},G={g_pad},N={k7_bins},T={k7_types}",
          k6_shapes="G={},T={},L={}".format(k6_operands[0].shape[0], k6_operands[2].shape[0], k6_operands[1].shape[0]),
          k2_g2048_ms=f"{k2_big_ms:.4f}", k3_g2048_ms=f"{k3_big_ms:.4f}")

    # 12. where one warm solve's time goes, layer by layer, and the device's
    # busy share of a solve.
    layers = layer_breakdown(groups, fleet, device)
    phase("layers", **{name: f"{ms:.3f}" for name, ms in layers.items()})
    busy = profile_call(lambda: cost_solver.solve_encoded(groups, fleet))
    phase("profile", wall_ms=f"{busy['wall_ms']:.3f}", device_ms=f"{busy['device_ms']:.3f}",
          busy_share=f"{busy['busy_share']:.4f}", device_launches=busy["device_launches"])
    for key, count, ms in busy["top"]:
        print(f"  device {ms:9.3f} ms  x{count:<6d} {key}")
    check(solver.SOLVER_BATCH_SPLIT_TOTAL.get("floor") == 0,
          "a solve reached the device-memory ladder's floor")

    # 13. the card's busy share of a storm pass, last (see the docstring).
    storm_profile_phase(device, storm)
    # 14. K7's kernel records a sweep, in a fresh process (see sweep_records).
    consolidate_child = run_child(["--phase", "consolidate"], 300.0)
    children.append(consolidate_child)
    records = child_result(consolidate_child, "consolidate_result")["records_per_sweep"]
    kernels[[entry["name"] for entry in kernels].index("solve_counterfactuals")]["records_per_sweep"] = records
    # 15. the fused solve's device records a call and K4's share of K2's
    # launch, in a fresh process (see fused_alone).
    fused_child = run_child(["--phase", "fused"], 300.0)
    children.append(fused_child)
    fused = child_result(fused_child, "fused_result")
    records = fused["records"]
    print(f"fused_solve_records per_call={sum(records.values())} by_name={json.dumps(records, sort_keys=True)}")
    check(records.get("pack_rounds_kernel") == 1 and "compact_kernel" not in records,
          f"the fused solve's records {records} are not one K2 launch and no compaction launch")
    k2_entry = kernels[[entry["name"] for entry in kernels].index("pack_kernel")]
    k2_entry.update(ms_with_epilogue=fused["k2_with_epilogue_ms"],
                    event_ms_with_epilogue=fused["k2_with_epilogue_event_ms"])
    k4_entry = kernels[[entry["name"] for entry in kernels].index("compact_plan")]
    k4_entry.update(ms=fused["k2_with_epilogue_ms"] - fused["k2_without_epilogue_ms"],
                    ms_k2_with_epilogue=fused["k2_with_epilogue_ms"],
                    ms_k2_without_epilogue=fused["k2_without_epilogue_ms"],
                    event_ms_k2_with_epilogue=fused["k2_with_epilogue_event_ms"])
    print(f"wall total_s={time.perf_counter() - _START:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
