#!/usr/bin/env python3
"""Where K7's device time goes, on the card: by launch and by pod group.

    python3 tools/k7_split.py [--tree DIR] [--probe]

Builds chip_smoke's real-size consolidation sweep (5,000 nodes, padded C 64,
G 16, N 8,192, T 512) with the package of the tree DIR (default: this
checkout) and prints one JSON line:

  * `launches`: torch.profiler's device microseconds a sweep of each kernel
    that K7's wrapper launches, over 50 sweeps;
  * with `--probe`, `groups`: the candidate kernel of DIR's
    csrc/consolidate.cu built again with clock64() stamps taken by thread 0
    of every block (the probe lives only in that scratch build, under DIR's
    git-ignored build directory), as mean cycles over the blocks. For the
    one-block-a-candidate kernel (K7's first port): the prologue (axes and room),
    each group's fit sum and scan, take pass and placed sum, and the
    replace leg. For the cluster kernel (its redesign): the prologue, the
    replace leg, the room, each group's fits and exchange (up to its
    cluster barrier) and take pass (a group with no pods is skipped: its
    zeros' store), the tail, and in the last cluster the argmax and the
    copy of the winner's row. The stamps are anchored on
    those two sources, and raise on any other.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

# (anchor in consolidate.cu, stamp inserted after it); {slot} is the stamp's
# index a candidate: 0 the prologue, then three a group, then the tail.
_STAMPS = [
    ("  const int first_bin = tid * per_thread;\n",
     "  const long long probe_start = clock64();\n"),
    ("  for (int g = 0; g < groups; ++g) {\n    const size_t row = size_t(c) * groups + g;\n",
     None),
    ("    float running = block_exclusive_scan(local, s_scan, total);\n",
     "    if (tid == 0) probe_out[size_t(c) * probe_slots + 1 + 3 * g] = clock64() - probe_start;\n"),
    ("    placed = block_sum(placed, s_sum);\n",
     "    if (tid == 0) probe_out[size_t(c) * probe_slots + 3 + 3 * g] = clock64() - probe_start;\n"),
    ("  __syncthreads();\n  float best_price = INFINITY;\n", None),
    ("    eager[2 * candidates + c] = __float_as_int(best_price);\n",
     "    probe_out[size_t(c) * probe_slots + probe_slots - 1] = clock64() - probe_start;\n"),
]


_PROBE_HEAD = ("#include <cuda_runtime.h>\n"
               "__device__ long long probe_out[1 << 16];\n"
               "__device__ int probe_slots;\n"
               "extern \"C\" int ktt_probe_fetch(long long* host, int count, int slots) {\n"
               "  cudaMemcpyFromSymbol(host, probe_out, sizeof(long long) * count);\n"
               "  return static_cast<int>(cudaGetLastError());\n"
               "}\n"
               "extern \"C\" int ktt_probe_slots(int slots) {\n"
               "  return static_cast<int>(cudaMemcpyToSymbol(probe_slots, &slots, sizeof(int)));\n"
               "}\n")


def _patched_source(text: str) -> str:
    """The candidate kernel with clock64() stamps: the prologue's end before
    the group loop, the take pass's end before the placed sum."""
    for anchor, _ in _STAMPS:
        if text.count(anchor) != 1:
            raise SystemExit(f"k7_split: anchor not found once in consolidate.cu: {anchor!r}")
    for anchor, stamp in _STAMPS:
        if stamp is not None:
            text = text.replace(anchor, anchor + stamp)
    text = text.replace(
        "  for (int g = 0; g < groups; ++g) {\n    const size_t row = size_t(c) * groups + g;\n",
        "  if (tid == 0) probe_out[size_t(c) * probe_slots] = clock64() - probe_start;\n"
        "  for (int g = 0; g < groups; ++g) {\n    const size_t row = size_t(c) * groups + g;\n")
    text = text.replace(
        "    placed = block_sum(placed, s_sum);\n",
        "    if (tid == 0) probe_out[size_t(c) * probe_slots + 2 + 3 * g] = clock64() - probe_start;\n"
        "    placed = block_sum(placed, s_sum);\n", 1)
    return _PROBE_HEAD + text


# The cluster kernel: (anchor, stamp after it). Slots: 0 prologue, 1 replace
# leg, 2 room, 3 + 2g after group g's exchange, 4 + 2g after its stores,
# then the tail, the ticket, the argmax and the copy.
_CLUSTER_STAMPS = [
    ("  const int first_bin = rank * slice + tid * kBins;\n",
     "  const long long probe_start = clock64();\n"
     "  long long* probe = probe_out + size_t(blockIdx.x) * probe_slots;\n"),
    ("  const int axes = ctl->axes;\n  const bool sized = axes <= max_axes;\n",
     "  if (tid == 0) probe[0] = clock64() - probe_start;\n"),
    ("  float* room = room_scratch == nullptr\n", None),
    ("      cluster.sync();\n      float offset = 0.0f;\n",
     "      if (tid == 0) probe[3 + 2 * g] = clock64() - probe_start;\n"),
    ("          if (j < owned) take_row[first_bin + j] = out[j];\n        }\n      }\n",
     "      if (tid == 0) probe[4 + 2 * g] = clock64() - probe_start;\n"),
    ("  cluster.sync();\n  if (rank == 0 && tid == 0) {\n    long long last_placed = 0;\n", None),
    ("        continue;\n      }\n      const int parity = step & 1;\n", None),
    ("  if (!ctl->last) return;\n",
     "  if (tid == 0) probe[4 + 2 * groups] = clock64() - probe_start;\n"),
    ("  if (ctl->unsized) return;\n",
     "  if (tid == 0) probe[5 + 2 * groups] = clock64() - probe_start;\n"),
]


def _patched_cluster_source(text: str) -> str:
    """The cluster kernel with clock64() stamps by thread 0 of every block."""
    for anchor, _ in _CLUSTER_STAMPS:
        if text.count(anchor) != 1:
            raise SystemExit(f"k7_split: anchor not found once in consolidate.cu: {anchor!r}")
    for anchor, stamp in _CLUSTER_STAMPS:
        if stamp is not None:
            text = text.replace(anchor, anchor + stamp)
    text = text.replace("        continue;\n      }\n      const int parity = step & 1;\n",
                        "        if (tid == 0) probe[3 + 2 * g] = probe[4 + 2 * g] = clock64() - probe_start;\n"
                        "        continue;\n      }\n      const int parity = step & 1;\n")
    text = text.replace("  float* room = room_scratch == nullptr\n",
                        "  if (tid == 0) probe[1] = clock64() - probe_start;\n"
                        "  float* room = room_scratch == nullptr\n")
    loop = ("    for (int g = 0; g < groups; ++g) {\n      const size_t row = size_t(c) * groups + g;\n"
            "      int* take_row = takes + row * bins;\n")
    if text.count(loop) != 1:
        raise SystemExit(f"k7_split: anchor not found once in consolidate.cu: {loop!r}")
    text = text.replace(loop, "    if (tid == 0) probe[2] = clock64() - probe_start;\n" + loop)
    text = text.replace("  cluster.sync();\n  if (rank == 0 && tid == 0) {\n    long long last_placed = 0;\n",
                        "  if (tid == 0) {\n    probe[3 + 2 * groups] = clock64() - probe_start;\n"
                        "    for (int i = 4 + 2 * groups; i < probe_slots; ++i) probe[i] = -1;\n  }\n"
                        "  cluster.sync();\n  if (rank == 0 && tid == 0) {\n    long long last_placed = 0;\n")
    text = text.replace("           static_cast<long long>(rank) * threads + tid, static_cast<long long>(k) * threads);\n}\n",
                        "           static_cast<long long>(rank) * threads + tid, static_cast<long long>(k) * threads);\n"
                        "  if (tid == 0) probe[6 + 2 * groups] = clock64() - probe_start;\n}\n")
    if "probe[6 + 2 * groups]" not in text:
        raise SystemExit("k7_split: the copy's anchor was not found in consolidate.cu")
    return _PROBE_HEAD + text


def _launch_split(operands, axes, reps: int = 50) -> dict:
    """torch.profiler's device microseconds a sweep of each kernel K7's
    wrapper launches, over `reps` sweeps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from karpenter_tpu_torch.ops import consolidate_kernel

    for _ in range(5):
        consolidate_kernel.solve_counterfactuals(*operands, axes=axes)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            consolidate_kernel.solve_counterfactuals(*operands, axes=axes)
        torch.cuda.synchronize()
    return {event.key[:60]: {"count": event.count, "us_per_sweep": event.self_device_time_total / reps}
            for event in prof.key_averages() if event.device_type == torch.autograd.DeviceType.CUDA}


def _probe_launcher(lib, operands, axes, clustered: bool, device):
    """(launch, blocks, plan or None): one call of the probed library's
    ktt_consolidate on the operands, with its own outputs."""
    import torch

    from karpenter_tpu_torch.ops import consolidate_kernel

    num_candidates, num_groups = operands[1].shape
    num_bins, num_types = operands[2].shape[0], operands[4].shape[0]
    dims = operands[0].shape[2]
    lib.ktt_consolidate.restype, lib.ktt_consolidate.argtypes = \
        consolidate_kernel.LIBRARY._signatures["ktt_consolidate"]
    takes = torch.empty((num_candidates, num_groups, num_bins), dtype=torch.int32, device=device)
    eager = torch.empty(consolidate_kernel.eager_words(num_candidates, num_groups, num_bins),
                        dtype=torch.int32, device=device)
    savings = torch.empty(num_candidates, dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    head = (*(t.data_ptr() for t in operands), num_candidates, num_groups, dims, num_bins, num_types, axes)
    if clustered:
        plan = consolidate_kernel.counterfactual_launch_plan(
            num_candidates, num_groups, num_bins, axes,
            torch.cuda.get_device_properties(device).multi_processor_count)
        ticket = torch.zeros(1, dtype=torch.int32, device=device)
        args = head + (plan.cluster, plan.threads, plan.bins_per_thread, plan.bins_per_block,
                       plan.shared_bytes, takes.data_ptr(), eager.data_ptr(), savings.data_ptr(), 0,
                       ticket.data_ptr(), stream)
        return (lambda: lib.ktt_consolidate(*args)), num_candidates * plan.cluster, plan
    lib.ktt_consolidate_threads.argtypes = [ctypes.c_int]
    lib.ktt_consolidate_room_words.restype = ctypes.c_longlong
    lib.ktt_consolidate_room_words.argtypes = [ctypes.c_int, ctypes.c_int]
    threads = lib.ktt_consolidate_threads(num_bins)
    shared = 4 * threads * lib.ktt_consolidate_room_words(num_bins, axes)
    args = head + (shared, takes.data_ptr(), eager.data_ptr(), savings.data_ptr(), 0, stream)
    return (lambda: lib.ktt_consolidate(*args)), num_candidates, None


def _cluster_split(samples, groups: int) -> dict:
    """Mean cycles of each part of the cluster kernel: the group loop and
    tail over every block, the argmax and copy over the last cluster's
    (their slots are -1 elsewhere). The first launch is cold."""
    import numpy as np

    runs = np.stack(samples[1:])
    body = runs[:, :, : 4 + 2 * groups].mean(axis=(0, 1))
    segments = np.diff(np.concatenate([[0.0], body]))
    last = np.concatenate([run[run[:, -1] >= 0][:, 4 + 2 * groups:] for run in runs]).mean(axis=0)
    return {
        "cycles_tail_end": float(body[-1]),
        "prologue": float(segments[0]), "replace_leg": float(segments[1]), "room": float(segments[2]),
        "per_group": [{"fits_exchange": float(segments[3 + 2 * g]), "take": float(segments[4 + 2 * g])}
                      for g in range(groups)],
        "tail": float(segments[3 + 2 * groups]),
        "last_cluster_ticket": float(last[0] - body[-1]), "argmax": float(last[1] - last[0]),
        "copy": float(last[2] - last[1]), "cycles_total_last": float(last[2]),
    }


def _block_split(samples, groups: int) -> dict:
    """Mean cycles of each part of the one-block-a-candidate kernel over
    its blocks. The first launch is cold."""
    import numpy as np

    stamps = np.mean(samples[1:], axis=0).mean(axis=0)
    segments = np.diff(np.concatenate([[0.0], stamps]))
    return {
        "cycles_total": float(stamps[-1]),
        "prologue": float(segments[0]),
        "per_group": [{"fit_scan": float(segments[1 + 3 * g]), "take": float(segments[2 + 3 * g]),
                       "placed_sum": float(segments[3 + 3 * g])} for g in range(groups)],
        "replace_leg": float(segments[-1]),
    }


def _probe(tree: Path, operands, axes, device) -> dict:
    """Build the tree's consolidate.cu with the stamps, run it six times,
    and split its cycles."""
    import numpy as np
    import torch

    from karpenter_tpu_torch.ops import cuda_build

    source = (tree / "karpenter_tpu_torch" / "csrc" / "consolidate.cu").read_text()
    clustered = "cg::cluster_group" in source
    build = tree / "karpenter_tpu_torch" / "build" / "probe"
    build.mkdir(parents=True, exist_ok=True)
    patched = _patched_cluster_source(source) if clustered else _patched_source(source)
    (build / "consolidate_probe.cu").write_text(patched)
    library = build / "libconsolidate_probe.so"
    subprocess.run([cuda_build._nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(library),
                    str(build / "consolidate_probe.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(library))
    groups = operands[1].shape[1]
    slots = 7 + 2 * groups if clustered else 2 + 3 * groups
    lib.ktt_probe_slots.argtypes = [ctypes.c_int]
    if lib.ktt_probe_slots(slots) != 0:
        raise SystemExit("k7_split: could not set the probe's slots")
    launch, blocks, plan = _probe_launcher(lib, operands, axes, clustered, device)
    samples = []
    for _ in range(6):
        status = launch()
        torch.cuda.synchronize()
        if status != 0:
            raise SystemExit(f"k7_split: the probed kernel failed with {status}")
        host = np.zeros(blocks * slots, np.int64)
        lib.ktt_probe_fetch(host.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)), host.size, slots)
        samples.append(host.reshape(blocks, slots))
    split = _cluster_split(samples, groups) if clustered else _block_split(samples, groups)
    split["clocks_sm_mhz"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    return {"plan": plan._asdict() if plan else None, "groups": split}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=str(Path(__file__).resolve().parent.parent))
    parser.add_argument("--probe", action="store_true")
    args = parser.parse_args(argv)
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("k7_split: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    package = chip_smoke.port_package()
    catalog = chip_smoke.make_catalog(package=package)
    shapes = chip_smoke.pod_shapes(0)
    cluster = chip_smoke.make_cluster(chip_smoke.usable_capacity(catalog, package),
                                      chip_smoke.shape_vectors(shapes, package))
    problem = chip_smoke.consolidation_problem(cluster, catalog, shapes, package)[0]
    operands, axes = chip_smoke.k7_inputs(problem, device)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    out = {"card": smi, "tree": str(tree), "shape": [int(s) for s in operands[0].shape[:2]]
           + [int(operands[2].shape[0]), int(operands[4].shape[0])], "axes": axes,
           "launches": _launch_split(operands, axes)}
    if args.probe:
        out.update(_probe(tree, operands, axes, device))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
