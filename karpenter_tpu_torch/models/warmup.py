"""Boot-time warmup of the card's solve path, shared by every deployment
shape.

The port of karpenter_tpu/models/warmup.py. The reference's compile debt is
XLA's jit per (groups, types) bucket; the port's is its kernels' nvcc builds
(one per csrc/*.cu source, into the package's build directory) and their
first launches. The reference has no compile step at all
(cmd/controller/main.go:61-99 goes straight from registration to serving),
so a deployment pays that debt at boot, never on a live batch: the
in-process Manager runs this behind /readyz (runtime.py).

`warmup_ladder` builds every kernel source (ops/cuda_build.build_all), runs
one solve per rung of the bucket ladder (KARPENTER_WARMUP_SHAPES,
"GxT,GxT,..."; the default covers the small/medium/headline buckets), from
host arrays and from pod tensors already on the device, then calibrates the
host/device break-even on this card (on a mesh, cost_solve_dispatch's mesh
selection means this warms the sharded solve, whatever solve_mesh()
selects); the calibration's solve is finished
with its host half (the column-LP mix candidate, whose LP solver's first
import alone costs about a second, and the host scoring). A rung that fails
is logged and counted on warmup_rung_failures_total. On the CPU warmup never
kills a boot; on the card a failed build, rung or calibration ends the
warmup with its error, and the Manager stops rather than serve from a card
that cannot solve (runtime.py).
"""

from __future__ import annotations

import os
import time

import numpy as np

from karpenter_tpu_torch.utils import logging as klog
from karpenter_tpu_torch.utils.metrics import REGISTRY

DEFAULT_SHAPES = "8x8,8x16,16x64,16x512"

log = klog.named("warmup")

# Rungs of the ladder that raised (and were skipped): a boot that counts
# any served its first batches on a path that was never warmed.
WARMUP_RUNG_FAILURES = REGISTRY.counter(
    "warmup_rung_failures_total", "Warmup ladder rungs that failed (logged and skipped)"
)

def make_synthetic_problem(num_groups: int, num_types: int, pods_per_group: int = 1):
    """One synthetic dense solve problem — (vectors, counts, capacity) —
    shared by the warmup compile pass and the break-even probes so the
    shapes they compile and the shapes they time can never drift apart."""
    rng = np.random.default_rng(0)
    vectors = np.zeros((num_groups, 8), np.float32)
    vectors[:, 0] = rng.integers(1, 9, num_groups) * 250
    vectors[:, 1] = rng.integers(1, 17, num_groups) * 256
    vectors[:, 2] = 1.0
    counts = np.full(num_groups, pods_per_group, np.int32)
    sizes = np.arange(1, num_types + 1, dtype=np.float32)
    capacity = np.zeros((num_types, 8), np.float32)
    capacity[:, 0] = 4000.0 * sizes
    capacity[:, 1] = 16384.0 * sizes
    capacity[:, 2] = 110.0
    return vectors, counts, capacity


def warmup_ladder(shapes: str | None = None, device=None) -> float:
    """Build the kernels and warm the bucket ladder on `device` (the card
    for None), then calibrate the break-even; returns elapsed seconds. On
    the CPU each failure is logged, counted and skipped; on the card it is
    logged, counted and raised."""
    from karpenter_tpu_torch.device import resolve_device
    from karpenter_tpu_torch.models import solver as solver_models
    from karpenter_tpu_torch.ops import cuda_build

    device = resolve_device(device)
    if shapes is None:
        shapes = os.environ.get("KARPENTER_WARMUP_SHAPES", DEFAULT_SHAPES)
    start = time.perf_counter()
    # Solves racing this warmup prefer the host path (steady-state latency)
    # over unbuilt kernels where that route is open; cleared in the finally
    # below.
    solver_models.set_warming_host_preference(True)
    try:
        if device.type == "cuda":
            build_s = cuda_build.build_all(cuda_build.port_libraries())
            log.info("kernel sources built in %.1fs", build_s)
        _compile_shapes(shapes, device=device)
    finally:
        solver_models.set_warming_host_preference(False)
    # With the ladder warm the device path is live — measure the actual
    # fetch floor, host rate, AND warm device compute on THIS card and
    # derive the host/device break-even from them (instead of the
    # reference's never-calibrated constants). Device compute = a warm
    # re-solve of the mid-ladder shape minus the fetch floor.
    try:
        floor_ms = solver_models._probe_fetch_floor_ms(device=device)
        warm_solve_ms = _timed_device_solve_ms(16, 64, device=device, finish=True)
        device_compute_ms = max(warm_solve_ms - floor_ms, 1.0)
        cal = solver_models.calibrate_break_even(
            fetch_floor_ms=floor_ms, device_compute_ms=device_compute_ms
        )
        log.info(
            "dispatch break-even: fetch floor %.2fms, host %.4fms/pod "
            "-> host <= %d pods (batched <= %d)",
            cal.fetch_floor_ms, cal.host_ms_per_pod,
            cal.max_pods, cal.max_pods_batched,
        )
    except Exception:  # noqa: BLE001 — calibration never kills a CPU boot
        log.warning("break-even calibration failed", exc_info=True)
        if device.type == "cuda":
            raise
    elapsed = time.perf_counter() - start
    log.info("bucket ladder warm in %.1fs (%s)", elapsed, shapes)
    return elapsed


def _compile_shapes(shapes: str, device=None) -> None:
    from karpenter_tpu_torch.device import resolve_device

    device = resolve_device(device)
    for token in shapes.split(","):
        token = token.strip()
        if not token:
            continue
        try:
            num_groups, num_types = (int(x) for x in token.split("x"))
            _timed_device_solve_ms(num_groups, num_types, device=device)
            # The encoded-state fast path (models/cluster_state) dispatches
            # pod tensors already on the device: warm that route per rung
            # too.
            _timed_device_solve_ms(num_groups, num_types, device_pods=True, device=device)
        except Exception:  # noqa: BLE001 — a failed rung never kills a CPU boot
            WARMUP_RUNG_FAILURES.inc()
            log.warning("warmup shape %s failed", token, exc_info=True)
            if device.type == "cuda":
                raise


def _timed_device_solve_ms(
    num_groups: int, num_types: int, device_pods: bool = False, device=None,
    finish: bool = False,
) -> float:
    """Run one device solve at the given shape on `device` and return its
    wall time — the warmup pass and the device-compute probe are the same
    call. Fetches through the COMPACTED helper so the timed number is the
    real pipeline's cost (eager payload only). device_pods=True feeds the
    pod tensors as bucket-padded tensors already on the device, as the
    incremental-encode fast path does; no kernel writes into them.
    finish=True then finishes the fetched plan, untimed, with the column-LP
    mix candidate and the host scoring, so their first-call costs are paid
    here and not by the first live batch."""
    import torch

    from karpenter_tpu_torch.device import resolve_device
    from karpenter_tpu_torch.models import solver as solver_models
    from karpenter_tpu_torch.ops.pack_kernel import bucket_size, pad_to

    device = resolve_device(device)
    host_vectors, host_counts, capacity = make_synthetic_problem(num_groups, num_types)
    vectors, counts = host_vectors, host_counts
    prices = (0.1 * np.arange(1, num_types + 1, dtype=np.float32))
    if device_pods:
        bucket = bucket_size(num_groups)
        vectors = torch.from_numpy(pad_to(vectors, bucket)).to(device)
        counts = torch.from_numpy(pad_to(counts, bucket)).to(device)
    start = time.perf_counter()
    fetched = solver_models.fetch_plan(
        solver_models.cost_solve_dispatch(
            vectors, counts, capacity, capacity.copy(), prices, 300, device=device
        )
    )
    elapsed_ms = (time.perf_counter() - start) * 1e3
    if finish:
        pool_prices = np.repeat(prices[:, None].astype(np.float64), 3, axis=1)
        mix_plan = solver_models.compute_mix_candidate(host_vectors, host_counts, capacity, pool_prices)
        solver_models.cost_solve_finish(
            fetched, host_vectors, host_counts, capacity, capacity.copy(), prices, pool_prices,
            mix_plan=mix_plan,
        )
    return elapsed_ms
