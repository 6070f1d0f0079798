"""DeviceClusterState — device-resident cluster tensors updated O(churn).

The port of karpenter_tpu/models/cluster_state.py. Without it every sweep
re-encodes the full cluster snapshot (``group_pods`` over every pending pod
plus ``build_fleet``), work that scales with the cluster, not the churn.
Here ``Cluster`` watch events stream into slot arrays that live ON THE
DEVICE, and per-sweep encode work becomes proportional to the watch-event
churn.

The device is explicit: ``DeviceClusterState(cluster, device=None)`` keeps
its arrays on the CUDA card and raises without one
(karpenter_tpu_torch/device.py); ``device="cpu"`` keeps them in host
memory, where the scatters and gathers run their plain versions.

Architecture:

- **Slot allocator with free-list reuse.** Pod groups (distinct request
  vectors) and nodes each own a row in mirror arrays (numpy, host) with a
  device copy. Deleting a group/node frees its slot into a free-list
  (row left behind as a tombstone, masked by the live flags); the next
  allocation reuses it. Slot indices are NEVER stored in per-pod records —
  records hold the vector key / node name and resolve slots through the
  slot maps, so compaction remaps O(G+N) map entries, not O(pods).

- **Sync-by-key, not op-replay.** ``Cluster.watch_deltas`` delivery order
  across threads is unordered, so each event is only a hint: the handler
  re-reads the store (always at least as new as the event) and reconciles
  the pod's recorded contribution (pending group / node used) to what it
  sees. Out-of-order delivery converges because the LAST event per key
  syncs against the final store state.

- **O(delta) flush.** Host syncs mark dirty slots; ``flush()`` drains them
  under the lock and, OUTSIDE the lock, uploads every delta row with its
  padded index vector in one pinned non-blocking copy and applies one
  masked scatter per array (K8, ops/incremental.py). Device work per sweep
  is O(churn).

- **Epoch-tagged generations + snapshot rebuild.** Rebuilds, compactions,
  and capacity growth bump ``epoch``; every flush bumps ``generation``. A
  consumer holding an older handle detects staleness via ``is_current`` and
  simply re-encodes; the state itself falls back to the SNAPSHOT path
  (``group_pods`` over a fresh ``cluster.list_pods()`` — which stays
  authoritative and bit-identical, asserted by the parity suite) whenever
  an apply was torn mid-way (``encode.mid-apply`` crashpoint, a callback
  error, or a failed flush).

- **Masked compaction.** When tombstone density (freed-but-unreused slots
  over the high-water mark) crosses ``compaction_threshold``, the live rows
  are packed to the front, slot maps remapped, and the (possibly shrunken)
  mirrors re-uploaded — an epoch bump, amortized-rare and O(live).

Generations: every flush writes new slot arrays (the scatter writes into a
copy), so a handle to an older generation stays readable. The per-sweep
sorted gather outputs handed to the solver are fresh tensors, and no solve
kernel writes into its inputs, so a handle stays readable after its solve.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.pods import PodSpec
from karpenter_tpu_torch.controllers.cluster import Cluster, PodKey
from karpenter_tpu_torch.convert import upload_packed
from karpenter_tpu_torch.device import DeviceLike, resolve_device
from karpenter_tpu_torch.ops import incremental
from karpenter_tpu_torch.ops.encode import (
    InstanceFleet,
    PodGroups,
    build_fleet,
    group_pods,
    group_sort_key,
    resource_vector,
)
from karpenter_tpu_torch.ops.pack_kernel import bucket_size, pad_to
from karpenter_tpu_torch.utils import logging as klog
from karpenter_tpu_torch.utils.crashpoints import crashpoint
from karpenter_tpu_torch.utils.metrics import REGISTRY

log = klog.named("cluster-state")

# Per-flush device update latency — the number the <2ms-per-sweep budget
# watches (bench.py encode_incremental publishes the same quantity as
# encode_delta_ms). Buckets sized for sub-ms..tens-of-ms.
ENCODE_DELTA_SECONDS = REGISTRY.histogram(
    "encode_delta_seconds",
    "Incremental encode flush duration (delta scatter path only)",
    buckets=(0.0005, 0.001, 0.002, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25),
)
# Every full rebuild from the snapshot path, by why it was needed. A rising
# non-"initial" rate means the delta path keeps invalidating itself —
# investigate before trusting the O(churn) story.
ENCODE_REBUILDS_TOTAL = REGISTRY.counter(
    "encode_rebuilds_total",
    "Full snapshot rebuilds of the incremental encode state, by reason",
    ["reason"],
)

DEFAULT_COMPACTION_THRESHOLD = 0.5
# Below this high-water mark compaction is pointless — the arrays are
# already a single bucket.
_COMPACTION_MIN_ROWS = 16

_NUM_DIMS = wellknown.NUM_RESOURCE_DIMS


class StaleEncodingError(RuntimeError):
    """A consumer asserted freshness on a handle whose epoch or generation
    the state has moved past — re-encode via pending_groups()/the snapshot
    path."""


@dataclass
class DevicePodGroups(PodGroups):
    """A PodGroups snapshot whose tensors ALSO exist on device: vectors and
    counts are the sorted, bucket-padded gather of the state's slot arrays
    (host mirrors sliced identically — bit-identical to group_pods over the
    same pending set). epoch/generation tag which array generation produced
    it; ``state.is_current(handle)`` tells a lagging consumer to re-encode."""

    epoch: int = 0
    generation: int = 0
    device_vectors: object = None  # [Gbucket, R] f32 tensor on the device
    device_counts: object = None  # [Gbucket] i32 tensor on the device
    state: Optional["DeviceClusterState"] = None


@dataclass(slots=True)
class _PodRecord:
    """One pod's recorded contribution. Slot indices are resolved through
    the slot maps at use time (never stored) so compaction stays O(G+N).
    slots=True: one record exists per pod in the cluster — at 10^5-10^6
    pods the dict-less layout is a real rebuild-time and memory win."""

    vector: np.ndarray
    vec_key: bytes
    pending: bool
    node_name: Optional[str]
    counted: bool  # contributes to node_used (bound and not terminal)


class DeviceClusterState:
    """Owns the device-resident pod/node arrays and keeps them synced to a
    ``Cluster`` via its verb-level watch feed. Construct once per process
    (the Manager does) and hand to the provisioning / consolidation /
    interruption controllers."""

    def __init__(
        self,
        cluster: Cluster,
        compaction_threshold: float = DEFAULT_COMPACTION_THRESHOLD,
        subscribe: bool = True,
        device: DeviceLike = None,
    ):
        self.cluster = cluster
        self.device = resolve_device(device)
        self.compaction_threshold = compaction_threshold
        self._lock = threading.RLock()
        self._flush_cv = threading.Condition(self._lock)
        # --- pod-group side ---------------------------------------------------
        self._pod_rec: Dict[PodKey, _PodRecord] = {}  # vet: guarded-by(self._lock)
        self._group_slot: Dict[bytes, int] = {}  # vet: guarded-by(self._lock)
        self._group_vectors = np.zeros((8, _NUM_DIMS), np.float32)  # vet: guarded-by(self._lock)
        self._group_counts = np.zeros(8, np.int32)  # vet: guarded-by(self._lock)
        self._group_live = np.zeros(8, bool)  # vet: guarded-by(self._lock)
        self._group_members: List[Dict[PodKey, PodSpec]] = [dict() for _ in range(8)]  # vet: guarded-by(self._lock)
        self._group_free: List[int] = []  # vet: guarded-by(self._lock)
        self._group_high = 0  # vet: guarded-by(self._lock)
        self._group_dirty: set = set()  # vet: guarded-by(self._lock)
        self._pending_total = 0  # vet: guarded-by(self._lock)
        # --- node side --------------------------------------------------------
        self._node_slot: Dict[str, int] = {}  # vet: guarded-by(self._lock)
        self._node_capacity = np.zeros((8, _NUM_DIMS), np.float32)  # vet: guarded-by(self._lock)
        # float64 HOST mirror: used is maintained by += / -= churn for the
        # process lifetime, and while kernel-unit vectors are integral
        # (exact in f32 to 2^24), f64 keeps the ledger exact to 2^53 so no
        # pathological magnitude or fractional request can ever accrete
        # rounding residue vs a fresh pod-walk sum. The DEVICE copy is cast
        # to f32 at flush (what the kernels consume).
        self._node_used = np.zeros((8, _NUM_DIMS), np.float64)  # vet: guarded-by(self._lock)
        self._node_live = np.zeros(8, bool)  # vet: guarded-by(self._lock)
        self._node_free: List[int] = []  # vet: guarded-by(self._lock)
        self._node_high = 0  # vet: guarded-by(self._lock)
        self._node_dirty: set = set()  # vet: guarded-by(self._lock)
        self._node_pods: Dict[str, Dict[PodKey, PodSpec]] = {}  # vet: guarded-by(self._lock)
        # --- generations ------------------------------------------------------
        self._dev: Optional[Dict[str, object]] = None  # vet: guarded-by(self._lock)
        self._epoch = 0  # vet: guarded-by(self._lock)
        self._generation = 0  # vet: guarded-by(self._lock)
        self._torn: Optional[str] = "initial"  # vet: guarded-by(self._lock)
        self._full_upload = True  # vet: guarded-by(self._lock)
        self._flushing = False  # vet: guarded-by(self._lock)
        self._event_seq = 0  # vet: guarded-by(self._lock)
        self._fleet_cache: Dict[Tuple, InstanceFleet] = {}  # vet: guarded-by(self._lock)
        self.compaction_count = 0  # vet: unguarded(monotonic int for bench/tests; writes hold the lock)
        self.rebuild_count = 0  # vet: unguarded(monotonic int for bench/tests; writes hold the lock)
        if subscribe:
            cluster.watch_deltas(self._on_event)

    # --- event intake --------------------------------------------------------

    def _on_event(self, verb: str, kind: str, obj) -> None:
        try:
            if kind == "pod":
                self._sync_pod((obj.namespace, obj.name))
            elif kind == "node":
                self._sync_node(obj.name)
            elif kind == "daemonset":
                with self._lock:
                    # Daemon overhead feeds build_fleet — drop cached fleets.
                    self._fleet_cache.clear()
        except Exception:  # noqa: BLE001 — a sync bug must not break store verbs
            # SimulatedCrash is a BaseException and punches through (the
            # encode.mid-apply battletest depends on it); anything else
            # marks the state torn so the next flush rebuilds from the
            # snapshot path instead of serving silently-wrong tensors.
            log.exception("incremental sync failed; state marked torn")
            with self._lock:
                self._torn = self._torn or "error"

    def _sync_pod(self, key: PodKey) -> None:
        with self._lock:
            # The point read happens UNDER our lock (it is lock-free on the
            # store side, so there is no lock-order hazard): read-then-apply
            # is atomic against other syncs of the same key, so the handler
            # serialized LAST for a key always reconciles against the
            # newest store state — read outside the lock, two concurrent
            # events could apply in reverse order of their reads and leave
            # the bookkeeping permanently stale.
            pod = self.cluster.try_get_pod(*key)
            self._event_seq += 1
            torn_before = self._torn
            # Torn marker held across the two-phase update: a crash between
            # remove and add leaves it set, and the next flush rebuilds.
            self._torn = self._torn or "torn"
            self._remove_pod_locked(key)
            crashpoint("encode.mid-apply")
            if pod is not None:
                self._add_pod_locked(key, pod)
            self._torn = torn_before

    def _sync_node(self, name: str) -> None:
        with self._lock:
            # Under the lock for the same read-then-apply atomicity as
            # _sync_pod (the store read itself is lock-free).
            node = self.cluster.try_get_node(name)
            self._event_seq += 1
            if node is None:
                slot = self._node_slot.pop(name, None)
                if slot is not None:
                    self._node_live[slot] = False
                    self._node_capacity[slot] = 0.0
                    self._node_used[slot] = 0.0
                    self._node_free.append(slot)
                    self._node_dirty.add(slot)
                return
            slot = self._ensure_node_locked(name)
            capacity = resource_vector(node.capacity)
            if not np.array_equal(self._node_capacity[slot], capacity):
                self._node_capacity[slot] = capacity
                self._node_dirty.add(slot)

    # --- contribution bookkeeping (lock held) --------------------------------

    def _remove_pod_locked(self, key: PodKey) -> None:
        record = self._pod_rec.pop(key, None)
        if record is None:
            return
        if record.pending:
            slot = self._group_slot.get(record.vec_key)
            if slot is not None:
                self._group_counts[slot] -= 1
                self._group_members[slot].pop(key, None)
                self._group_dirty.add(slot)
                self._pending_total -= 1
                if self._group_counts[slot] <= 0:
                    # Free-list reuse: the vector row stays behind as a
                    # tombstone (masked by live=False) until reuse/compaction.
                    self._group_slot.pop(record.vec_key, None)
                    self._group_live[slot] = False
                    self._group_counts[slot] = 0
                    self._group_members[slot] = {}
                    self._group_free.append(slot)
        if record.node_name is not None:
            pods = self._node_pods.get(record.node_name)
            if pods is not None:
                pods.pop(key, None)
                if not pods:
                    self._node_pods.pop(record.node_name, None)
            if record.counted:
                slot = self._node_slot.get(record.node_name)
                if slot is not None:
                    self._node_used[slot] -= record.vector
                    self._node_dirty.add(slot)

    def _add_pod_locked(self, key: PodKey, pod: PodSpec) -> None:
        cached = pod.dense_vector
        if cached is None:  # pragma: no cover — defensive, mirrors group_pods
            from karpenter_tpu_torch.api.pods import _dense_request_cache

            pod.dense_vector = cached = _dense_request_cache(pod.requests)
        vector, vec_key = cached[0], cached[1]
        pending = pod.is_provisionable()
        node_name = pod.node_name
        counted = bool(node_name) and not pod.is_terminal()
        if pending:
            slot = self._group_slot.get(vec_key)
            if slot is None:
                slot = self._alloc_group_locked(vec_key, vector)
            self._group_counts[slot] += 1
            self._group_members[slot][key] = pod
            self._group_dirty.add(slot)
            self._pending_total += 1
        if node_name:
            self._node_pods.setdefault(node_name, {})[key] = pod
            if counted:
                slot = self._ensure_node_locked(node_name)
                self._node_used[slot] += vector
                self._node_dirty.add(slot)
        self._pod_rec[key] = _PodRecord(
            vector=vector,
            vec_key=vec_key,
            pending=pending,
            node_name=node_name if node_name else None,
            counted=counted,
        )

    def _alloc_group_locked(self, vec_key: bytes, vector: np.ndarray) -> int:
        if self._group_free:
            slot = self._group_free.pop()
        else:
            slot = self._group_high
            self._group_high += 1
            if self._group_high > self._group_vectors.shape[0]:
                self._grow_groups_locked()
        self._group_slot[vec_key] = slot
        self._group_vectors[slot] = vector
        self._group_counts[slot] = 0
        self._group_live[slot] = True
        self._group_members[slot] = {}
        self._group_dirty.add(slot)
        return slot

    def _ensure_node_locked(self, name: str) -> int:
        slot = self._node_slot.get(name)
        if slot is not None:
            return slot
        if self._node_free:
            slot = self._node_free.pop()
        else:
            slot = self._node_high
            self._node_high += 1
            if self._node_high > self._node_capacity.shape[0]:
                self._grow_nodes_locked()
        self._node_slot[name] = slot
        self._node_capacity[slot] = 0.0
        self._node_used[slot] = 0.0
        self._node_live[slot] = True
        self._node_dirty.add(slot)
        return slot

    def _grow_groups_locked(self) -> None:
        cap = bucket_size(self._group_high)
        grow = cap - self._group_vectors.shape[0]
        self._group_vectors = np.concatenate(
            [self._group_vectors, np.zeros((grow, _NUM_DIMS), np.float32)]
        )
        self._group_counts = np.concatenate(
            [self._group_counts, np.zeros(grow, np.int32)]
        )
        self._group_live = np.concatenate([self._group_live, np.zeros(grow, bool)])
        self._group_members.extend(dict() for _ in range(grow))
        self._full_upload = True

    def _grow_nodes_locked(self) -> None:
        cap = bucket_size(self._node_high)
        grow = cap - self._node_capacity.shape[0]
        self._node_capacity = np.concatenate(
            [self._node_capacity, np.zeros((grow, _NUM_DIMS), np.float32)]
        )
        self._node_used = np.concatenate(
            [self._node_used, np.zeros((grow, _NUM_DIMS), np.float64)]
        )
        self._node_live = np.concatenate([self._node_live, np.zeros(grow, bool)])
        self._full_upload = True

    # --- compaction ----------------------------------------------------------

    def tombstone_density(self) -> Tuple[float, float]:
        """(group, node) tombstone density: freed-but-unreused slots over the
        high-water mark."""
        with self._lock:
            return (
                self._density_locked(self._group_high, self._group_live),
                self._density_locked(self._node_high, self._node_live),
            )

    @staticmethod
    def _density_locked(high: int, live: np.ndarray) -> float:
        if high <= 0:
            return 0.0
        return 1.0 - float(live[:high].sum()) / float(high)

    def _maybe_compact_locked(self) -> None:
        if (
            self._group_high >= _COMPACTION_MIN_ROWS
            and self._density_locked(self._group_high, self._group_live)
            >= self.compaction_threshold
        ):
            self._compact_groups_locked()
        if (
            self._node_high >= _COMPACTION_MIN_ROWS
            and self._density_locked(self._node_high, self._node_live)
            >= self.compaction_threshold
        ):
            self._compact_nodes_locked()

    def _compact_groups_locked(self) -> None:
        order = [s for s in range(self._group_high) if self._group_live[s]]
        cap = bucket_size(max(len(order), 8))
        vectors = np.zeros((cap, _NUM_DIMS), np.float32)
        counts = np.zeros(cap, np.int32)
        live = np.zeros(cap, bool)
        members: List[Dict[PodKey, PodSpec]] = [dict() for _ in range(cap)]
        remap: Dict[int, int] = {}
        for new, old in enumerate(order):
            vectors[new] = self._group_vectors[old]
            counts[new] = self._group_counts[old]
            live[new] = True
            members[new] = self._group_members[old]
            remap[old] = new
        self._group_slot = {
            key: remap[slot] for key, slot in self._group_slot.items()
        }
        self._group_vectors, self._group_counts = vectors, counts
        self._group_live, self._group_members = live, members
        self._group_free = []
        self._group_high = len(order)
        self._group_dirty = set()
        self._full_upload = True
        self.compaction_count += 1

    def _compact_nodes_locked(self) -> None:
        order = [s for s in range(self._node_high) if self._node_live[s]]
        cap = bucket_size(max(len(order), 8))
        capacity = np.zeros((cap, _NUM_DIMS), np.float32)
        used = np.zeros((cap, _NUM_DIMS), np.float64)
        live = np.zeros(cap, bool)
        remap: Dict[int, int] = {}
        for new, old in enumerate(order):
            capacity[new] = self._node_capacity[old]
            used[new] = self._node_used[old]
            live[new] = True
            remap[old] = new
        self._node_slot = {
            name: remap[slot] for name, slot in self._node_slot.items()
        }
        self._node_capacity, self._node_used, self._node_live = capacity, used, live
        self._node_free = []
        self._node_high = len(order)
        self._node_dirty = set()
        self._full_upload = True
        self.compaction_count += 1

    # --- snapshot rebuild ----------------------------------------------------

    def _rebuild_locked(self, reason: str) -> None:
        """Reconstruct ALL host bookkeeping from the authoritative snapshot
        path: group_pods over the live pending set (bit-identical tensors by
        construction) + a single pod/node walk for the bound side. Runs
        under the lock so no sync can interleave; pure host work (the device
        upload happens in the flush that called us)."""
        ENCODE_REBUILDS_TOTAL.inc(reason)
        self.rebuild_count += 1
        pods = self.cluster.list_pods()
        nodes = self.cluster.list_nodes()
        pending = [p for p in pods if p.is_provisionable()]
        groups = group_pods(pending)
        gcap = bucket_size(max(groups.num_groups, 8))
        self._group_vectors = np.zeros((gcap, _NUM_DIMS), np.float32)
        self._group_counts = np.zeros(gcap, np.int32)
        self._group_live = np.zeros(gcap, bool)
        self._group_members = [dict() for _ in range(gcap)]
        self._group_slot = {}
        self._group_free = []
        self._group_high = groups.num_groups
        self._group_dirty = set()
        self._pending_total = groups.num_pods
        for slot in range(groups.num_groups):
            vec = groups.vectors[slot]
            self._group_vectors[slot] = vec
            self._group_counts[slot] = groups.counts[slot]
            self._group_live[slot] = True
            self._group_members[slot] = {
                (p.namespace, p.name): p for p in groups.members[slot]
            }
            self._group_slot[vec.tobytes()] = slot
        ncap = bucket_size(max(len(nodes), 8))
        self._node_capacity = np.zeros((ncap, _NUM_DIMS), np.float32)
        self._node_used = np.zeros((ncap, _NUM_DIMS), np.float64)
        self._node_live = np.zeros(ncap, bool)
        self._node_slot = {}
        self._node_free = []
        self._node_high = len(nodes)
        self._node_dirty = set()
        self._node_pods = {}
        for slot, node in enumerate(nodes):
            self._node_slot[node.name] = slot
            self._node_capacity[slot] = resource_vector(node.capacity)
            self._node_live[slot] = True
        self._pod_rec = {}
        for pod in pods:
            key = (pod.namespace, pod.name)
            cached = pod.dense_vector
            if cached is None:  # pragma: no cover — defensive
                from karpenter_tpu_torch.api.pods import _dense_request_cache

                pod.dense_vector = cached = _dense_request_cache(pod.requests)
            vector, vec_key = cached[0], cached[1]
            pending_pod = pod.is_provisionable()
            node_name = pod.node_name
            counted = bool(node_name) and not pod.is_terminal()
            if node_name:
                self._node_pods.setdefault(node_name, {})[key] = pod
                if counted:
                    slot = self._ensure_node_locked(node_name)
                    self._node_used[slot] += vector
            self._pod_rec[key] = _PodRecord(
                vector=vector,
                vec_key=vec_key,
                pending=pending_pod,
                node_name=node_name if node_name else None,
                counted=counted,
            )
        self._torn = None
        self._full_upload = True

    # --- flush ---------------------------------------------------------------

    def flush(self) -> None:
        """Bring the device arrays up to date with the host mirrors: the
        O(delta) scatter in steady state, a full snapshot rebuild + upload
        when the state is torn/new, a full upload after growth/compaction.
        Device work runs OUTSIDE the lock (blocking-under-lock discipline);
        concurrent flushes serialize on a condition flag."""
        with self._lock:
            while self._flushing:
                self._flush_cv.wait()
            if (
                self._dev is not None
                and not self._full_upload
                and self._torn is None
                and not self._group_dirty
                and not self._node_dirty
            ):
                return  # already current
            self._flushing = True
            plan = self._drain_plan_locked()
        completed = False
        try:
            start = time.perf_counter()
            arrays = self._dispatch_plan(plan)
            if not plan["full"]:
                ENCODE_DELTA_SECONDS.observe(time.perf_counter() - start)
            completed = True
        finally:
            with self._lock:
                self._flushing = False
                self._flush_cv.notify_all()
                if completed:
                    self._dev = arrays
                    self._generation += 1
                    if plan["full"]:
                        self._epoch += 1
                        self._full_upload = False
                else:
                    # The drained deltas never reached the device: rebuild
                    # next time rather than serve a silently-partial state.
                    self._torn = "flush-failed"

    def _drain_plan_locked(self) -> dict:
        if self._torn is not None:
            self._rebuild_locked(self._torn)
        self._maybe_compact_locked()
        if self._full_upload or self._dev is None:
            self._group_dirty = set()
            self._node_dirty = set()
            return {
                "full": True,
                "mirrors": {
                    "group_vectors": self._group_vectors.copy(),
                    "group_counts": self._group_counts.copy(),
                    "node_capacity": self._node_capacity.copy(),
                    "node_used": self._node_used.astype(np.float32),
                    "node_live": self._node_live.copy(),
                },
            }
        group_idx = np.fromiter(sorted(self._group_dirty), np.int32, len(self._group_dirty))
        node_idx = np.fromiter(sorted(self._node_dirty), np.int32, len(self._node_dirty))
        plan = {
            "full": False,
            "dev": self._dev,
            "group": None,
            "node": None,
        }
        if len(group_idx):
            padded = incremental.pad_indices(group_idx, self._group_vectors.shape[0])
            plan["group"] = (
                padded,
                self._group_vectors[group_idx].copy(),
                self._group_counts[group_idx].copy(),
            )
        if len(node_idx):
            padded = incremental.pad_indices(node_idx, self._node_capacity.shape[0])
            plan["node"] = (
                padded,
                self._node_capacity[node_idx].copy(),
                self._node_used[node_idx].astype(np.float32),
                self._node_live[node_idx].copy(),
            )
        self._group_dirty = set()
        self._node_dirty = set()
        return plan

    def _dispatch_plan(self, plan: dict) -> Dict[str, object]:
        if plan["full"]:
            mirrors = plan["mirrors"]
            # A rebuild, compaction or growth (an epoch bump): every mirror
            # goes up in one packed copy.
            return dict(zip(mirrors, upload_packed(list(mirrors.values()), self.device)))
        arrays = dict(plan["dev"])
        # Every delta row and both padded index vectors reach the device in
        # ONE pinned, non-blocking copy; padded rows ride sentinel indices.
        host: List[np.ndarray] = []
        for part in ("group", "node"):
            if plan[part] is not None:
                idx = plan[part][0]
                host += [idx] + [pad_to(rows, len(idx)) for rows in plan[part][1:]]
        on_device = iter(upload_packed(host, self.device))
        # Every changed array's new generation in ONE scatter_flush (one
        # launch on the card, the copies of the old rows included).
        names: List[str] = []
        updates = []
        if plan["group"] is not None:
            idx, rows, counts = (next(on_device) for _ in range(3))
            names += ["group_vectors", "group_counts"]
            updates += [(arrays["group_vectors"], idx, rows), (arrays["group_counts"], idx, counts)]
        if plan["node"] is not None:
            idx, capacity, used, live = (next(on_device) for _ in range(4))
            names += ["node_capacity", "node_used", "node_live"]
            updates += [(arrays["node_capacity"], idx, capacity), (arrays["node_used"], idx, used),
                        (arrays["node_live"], idx, live)]
        arrays.update(zip(names, incremental.scatter_flush(updates)))
        return arrays

    # --- epoch / freshness protocol ------------------------------------------

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation

    def compile_tag(self) -> Optional[Tuple[int, int]]:
        """(epoch, generation) for keying compiled-constraint envelopes
        (constraints/compiler.CompilerCache). Generation bumps on EVERY
        delta flush and epoch on full uploads, so the pair changes whenever
        the encoded cluster changes — epoch alone would serve a stale
        envelope across ordinary watch deltas. None while deltas are still
        pending (or the state is torn/unflushed): the store has moved past
        the last flush, so callers skip caching rather than key live
        cluster reads (spread seed counts, anti-affinity exclusions) to a
        tag that predates them."""
        with self._lock:
            if (
                self._dev is None
                or self._full_upload
                or self._torn is not None
                or self._group_dirty
                or self._node_dirty
            ):
                return None
            return (self._epoch, self._generation)

    def is_current(self, handle: DevicePodGroups) -> bool:
        with self._lock:
            return (
                handle.epoch == self._epoch
                and handle.generation == self._generation
            )

    def assert_current(self, handle: DevicePodGroups) -> None:
        if not self.is_current(handle):
            raise StaleEncodingError(
                "encoded handle is from a superseded array generation — "
                "re-encode via pending_groups() (the snapshot path stays "
                "authoritative)"
            )

    # --- consumer views ------------------------------------------------------

    def pending_groups(self) -> DevicePodGroups:
        """The pending (provisionable) pods as sorted group tensors, host +
        device — bit-identical to ``group_pods`` over the same pods. Flushes
        first; O(churn + G log G) per call."""
        self.flush()
        with self._lock:
            clean = (
                self._torn is None
                and not self._group_dirty
                and not self._node_dirty
                and not self._full_upload
            )
            live = [s for s in range(self._group_high) if self._group_live[s]]
            live.sort(key=lambda s: group_sort_key(self._group_vectors[s]))
            perm = np.array(live, np.int32)
            vectors = (
                self._group_vectors[perm]
                if len(perm)
                else np.zeros((0, _NUM_DIMS), np.float32)
            )
            counts = (
                self._group_counts[perm] if len(perm) else np.zeros(0, np.int32)
            )
            # Member lists are FROZEN copies taken in the same critical
            # section as the tensors: a handle's members may never diverge
            # from its counts snapshot (the bind path slices members by the
            # solved counts — a live view would drop or invent pods under
            # churn). list(dict.values()) is one C-level call per group.
            members = [list(self._group_members[s].values()) for s in live]
            dev = self._dev if clean else None
            epoch, generation = self._epoch, self._generation
        device_vectors = device_counts = None
        if dev is not None:
            # Sorted + bucket-padded gather OUT of the slot arrays — the pod
            # data never leaves the device; only the permutation goes up. Padding lanes read back zeros (an
            # empty group), inert in every kernel.
            padded = incremental.pad_indices(
                perm, int(dev["group_vectors"].shape[0])
            )
            (padded,) = upload_packed([padded], self.device)
            device_vectors, device_counts = incremental.gather_view(
                [dev["group_vectors"], dev["group_counts"]], padded
            )
        else:
            # A sync raced in between flush and capture (or the state is
            # torn): fall back to uploading the host slices — exact, just
            # not zero-copy. Rare by construction.
            padded_len = bucket_size(max(len(perm), 8))
            device_vectors, device_counts = upload_packed(
                [pad_to(vectors, padded_len), pad_to(counts, padded_len)],
                self.device,
            )
        return DevicePodGroups(
            vectors=vectors,
            counts=counts,
            members=members,
            epoch=epoch,
            generation=generation,
            device_vectors=device_vectors,
            device_counts=device_counts,
            state=self,
        )

    def _ensure_host_fresh(self) -> None:
        with self._lock:
            torn = self._torn is not None
        if torn:
            self.flush()

    def pods_on_node(self, name: str) -> List[PodSpec]:
        """All pods bound to `name` (terminal included — parity with
        ``cluster.list_pods(node_name=name)``), O(pods on that node) instead
        of O(cluster)."""
        self._ensure_host_fresh()
        with self._lock:
            pods = self._node_pods.get(name)
            return list(pods.values()) if pods else []

    def node_used(self, name: str) -> Optional[np.ndarray]:
        """Summed request vector of the node's non-terminal pods (float64
        copy — the consolidation controller's accounting dtype). None for an
        unknown node."""
        self._ensure_host_fresh()
        with self._lock:
            slot = self._node_slot.get(name)
            if slot is None:
                return None
            return self._node_used[slot].copy()

    def pending_count(self) -> int:
        self._ensure_host_fresh()
        with self._lock:
            return self._pending_total

    def covers(self, pods: Sequence[PodSpec]) -> bool:
        """True iff `pods` is EXACTLY the tracked pending set (the
        provisioner's hot path: one schedule draining the whole backlog) —
        then pending_groups() encodes this batch O(churn)."""
        self._ensure_host_fresh()
        with self._lock:
            if len(pods) != self._pending_total:
                return False
            for pod in pods:
                record = self._pod_rec.get((pod.namespace, pod.name))
                if record is None or not record.pending:
                    return False
            return True

    def device_view(self) -> Tuple[int, Optional[Dict[str, object]]]:
        """(epoch, current device arrays) — test/bench surface."""
        with self._lock:
            return self._epoch, self._dev

    # --- fleet (offering-array) cache ----------------------------------------

    def encode_fleet(
        self,
        instance_types,
        constraints,
        daemons: Sequence[PodSpec],
        pods_need: Optional[np.ndarray],
    ) -> InstanceFleet:
        """build_fleet behind a content-fingerprint cache: repeat sweeps over
        an unchanged catalog/constraint envelope skip the filter + densify
        walk entirely, and the fleet arrays then ride the device_resident
        cache at dispatch — the offering arrays never leave the device
        between sweeps. Any content drift (price/ICE churn, new types,
        daemonset change) misses and rebuilds."""
        need_key = pods_need.tobytes() if pods_need is not None else b""
        # The market fingerprint keys the live price surface into the cache:
        # a reprice (generation) or a forecast-risk move (risk_generation)
        # rebuilds the fleet — whose changed price bytes then also miss the
        # content-keyed device_resident cache at dispatch, so the offering
        # arrays re-upload exactly when the market moved. None (no active
        # book) keys a static market, the pre-market behavior.
        from karpenter_tpu_torch.market.pricebook import active_fingerprint

        key = (
            _constraints_fingerprint(constraints),
            _catalog_fingerprint(instance_types),
            tuple(sorted(p.uid for p in daemons)),
            need_key,
            active_fingerprint(),
        )
        with self._lock:
            fleet = self._fleet_cache.get(key)
        if fleet is not None:
            return fleet
        fleet = build_fleet(
            instance_types, constraints, pods=[], daemons=daemons,
            pods_need=pods_need
            if pods_need is not None
            else np.zeros(_NUM_DIMS, np.float32),
        )
        with self._lock:
            if len(self._fleet_cache) >= 8:
                self._fleet_cache.clear()
            self._fleet_cache[key] = fleet
        return fleet

    def encode_schedule(
        self, pods: Sequence[PodSpec], instance_types, constraints, daemons
    ) -> Optional[Tuple[DevicePodGroups, InstanceFleet]]:
        """The provisioning fast path: when `pods` is exactly the tracked
        pending set, return (groups, fleet) without walking the batch —
        group tensors from the slot arrays, fleet from the fingerprint
        cache. None → caller takes the snapshot path.

        The coverage check runs AGAINST THE ENCODED SNAPSHOT, not just the
        live bookkeeping: covers() alone races a pod applied between the
        check and the capture, and a foreign pod encoded into the tensors
        would be bound without ever passing the scheduler — so the frozen
        member lists are re-verified to be exactly the batch."""
        if not self.covers(pods):
            return None
        groups = self.pending_groups()
        keys = {(p.namespace, p.name) for p in pods}
        if groups.num_pods != len(keys):
            return None
        for g in range(groups.num_groups):
            for member in groups.members[g]:
                if (member.namespace, member.name) not in keys:
                    return None
        pods_need = (
            groups.vectors.max(axis=0) if groups.num_groups else None
        )
        fleet = self.encode_fleet(instance_types, constraints, daemons, pods_need)
        return groups, fleet


def _constraints_fingerprint(constraints) -> Tuple:
    return (
        tuple(sorted(constraints.labels.items())),
        tuple(constraints.taints),
        constraints.requirements.canonical_key(),
    )


def _catalog_fingerprint(instance_types) -> Tuple:
    return tuple(
        (
            it.name,
            it.architecture,
            tuple(sorted(it.capacity.items())),
            tuple(sorted(it.overhead.items())),
            tuple(
                (
                    o.zone,
                    o.capacity_type,
                    o.price,
                    getattr(o, "available", True),
                    getattr(o, "consolidatable", True),
                )
                for o in it.offerings
            ),
        )
        for it in instance_types
    )
