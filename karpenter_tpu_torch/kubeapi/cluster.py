"""ApiServerCluster — the Cluster verb set against a real kube-apiserver.

Ref: pkg/controllers/manager.go:33-66 — controller-runtime gives the
reference cached reads (informers), direct writes, and watch-driven
reconciles. This class is that architecture on our verb surface:

- READS come from the inherited in-memory Cluster, which acts as the
  informer cache. Watch pump threads keep it synced with the apiserver.
- WRITES go through to the apiserver REST API first (binding and eviction
  use their subresources, exactly the RPCs the reference issues), then
  update the cache so same-thread read-after-write is consistent — the
  watch event that follows is deduplicated by resourceVersion. A watch
  event for an object while a write-through of it is in flight is held
  until the write has recorded its resourceVersion (_write_through), so
  the write's own echo never replaces the cached instance.
- The leader-election lease is a real coordination.k8s.io/v1 Lease with
  optimistic-concurrency CAS, so mutual exclusion spans every replica
  (cmd/controller/main.go:80-81).

Controllers cannot tell the backends apart; the test suites run against
both (tests/test_backend_parity.py).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Tuple

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.pods import PodSpec
from karpenter_tpu_torch.api.provisioner import Provisioner
from karpenter_tpu_torch.cloudprovider import NodeSpec
from karpenter_tpu_torch.controllers.cluster import Cluster
from karpenter_tpu_torch.controllers.errors import PDBViolationError
from karpenter_tpu_torch.utils.metrics import REGISTRY
from karpenter_tpu_torch.kubeapi import convert
from karpenter_tpu_torch.kubeapi.client import ApiError, KubeClient, critical_lane
from karpenter_tpu_torch.utils import faultpoints
from karpenter_tpu_torch.utils import logging as klog
from karpenter_tpu_torch.utils.clock import Clock

log = klog.named("kubeapi")

PODS = "/api/v1/pods"
NODES = "/api/v1/nodes"
DAEMONSETS = "/apis/apps/v1/daemonsets"
PROVISIONERS = f"/apis/{convert.GROUP}/{convert.VERSION}/provisioners"
LEASES = "/apis/coordination.k8s.io/v1/namespaces/kube-system/leases"
PDBS = "/apis/policy/v1/namespaces/default/poddisruptionbudgets"


def _pod_path(namespace: str, name: str = "") -> str:
    base = f"/api/v1/namespaces/{namespace}/pods"
    return f"{base}/{name}" if name else base


# Watch-plane health: a re-list means a watch gap outlived the apiserver's
# history window (410 Gone) — rare in steady state; a rising rate signals
# network trouble or an undersized watch cache.
WATCH_RELIST_TOTAL = REGISTRY.counter(
    "watch_relist_total", "410-triggered re-LISTs per resource kind", ["kind"]
)


class ApiServerCluster(Cluster):
    """The in-memory Cluster as informer cache + write-through REST verbs."""

    WATCHES = (
        ("pod", PODS),
        ("node", NODES),
        ("provisioner", PROVISIONERS),
        ("daemonset", DAEMONSETS),
    )

    # How long a deletion tombstone suppresses late events for its key.
    # Must exceed any plausible delivery delay of an in-flight stale event
    # (watch replays after reconnects); pruned opportunistically on delete.
    TOMBSTONE_TTL_S = 120.0

    def __init__(self, client: KubeClient, clock: Optional[Clock] = None):
        super().__init__(clock)
        self.api = client
        self._rv: Dict[Tuple[str, object], int] = {}  # vet: guarded-by(self._rv_lock)
        # Deletion tombstones: key -> (deletion rv, monotonic stamp). A
        # deleted key's rv entry can't just be popped — a stale MODIFIED
        # replayed after the DELETED event would pass _newer and resurrect
        # the object in the cache (the client-go informer solves this with
        # DeletedFinalStateUnknown tombstones).
        self._tombstones: Dict[Tuple[str, object], Tuple[int, float]] = {}  # vet: guarded-by(self._rv_lock)
        self._rv_lock = threading.Lock()
        # Write-throughs in flight per (kind, key), and the watch events for
        # those objects held back until the last of them ends: an echo of
        # the write that the pump delivers before the write has recorded its
        # rv must not replace the cached instance the caller holds.
        self._in_flight: Dict[Tuple[str, object], int] = {}  # vet: guarded-by(self._rv_lock)
        self._held: Dict[Tuple[str, object], list] = {}  # vet: guarded-by(self._rv_lock)
        # Events held during a write of their object; of those, the ones
        # dropped as echoes of it and the ones applied after it.
        self.echoes_held = 0
        self.echoes_dropped = 0
        self.echoes_applied = 0
        # Serializes the PDB gate + displacement write (reschedule_pod):
        # the interruption and consolidation drain loops displace
        # concurrently, and two gates passing on the same budget instant
        # would jointly overspend it.
        self._disruption_lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: list = []
        self.resync_count = 0  # 410-triggered re-LISTs (observability + tests)
        # On this backend the inherited store is ONLY the informer cache —
        # the watch pump must keep syncing it even for a deposed leader —
        # so the write fence moves from the base verbs to the write-through
        # verbs below (checked before the remote call goes out).
        self._fence_is_store = False

    # --- lifecycle ----------------------------------------------------------

    def start(self) -> "ApiServerCluster":
        """Initial LIST of every watched resource, then start watch pumps.
        Controllers constructed after start() see a warm cache. Each watch
        resumes from its LIST's collection resourceVersion so no event in
        the list-to-watch window is lost (the client-go reflector contract,
        ref: pkg/controllers/manager.go:33-40 via controller-runtime)."""
        for kind, path in self.WATCHES:
            items, rv = self.api.list_with_rv(path)
            for obj in items:
                self._apply_remote(kind, obj)
            thread = threading.Thread(  # vet: fence-exempt(informer sync: pump writes land in the cache only — _fence_is_store is False, the write-through verbs fence directly — and a deposed leader MUST keep its cache syncing)
                target=self._pump,
                args=(kind, path, rv),
                name=f"watch-{kind}",
                daemon=True,
            )
            thread.start()
            self._threads.append(thread)
        # PDBs seed from the server too: a RESTARTED controller that only
        # re-listed pods/nodes would hold an empty budget table, and every
        # post-restart drain would displace unbudgeted (the market-storm
        # smoke caught exactly this — one interruption sweep took all four
        # replicas behind a PDB down at once).
        for item in self.api.list(PDBS):
            spec = item.get("spec") or {}
            selector = (spec.get("selector") or {}).get("matchLabels") or {}
            Cluster.apply_pdb(
                self,
                (item.get("metadata") or {}).get("name", ""),
                selector,
                int(spec.get("minAvailable", 0)),
            )
        return self

    def close(self) -> None:
        self._stop.set()
        self.api.transport.close()  # unblock watch streams
        for thread in self._threads:
            thread.join(timeout=2.0)
        self._threads.clear()

    def _pump(self, kind: str, path: str, resource_version: str) -> None:
        self.api.watch(
            path,
            lambda event_type, obj: self._on_watch(kind, event_type, obj),
            self._stop,
            resource_version=resource_version,
            relist=lambda: self._relist(kind, path),
        )

    def _relist(self, kind: str, path: str) -> str:
        """410-recovery: replace the cache snapshot for `kind` from a fresh
        LIST — apply every live object, delete cached objects that vanished
        during the watch gap — and return the new collection rv to resume
        the watch from."""
        items, rv = self.api.list_with_rv(path)
        live = {self._key(kind, obj) for obj in items}
        try:
            list_rv = int(rv)
        except (TypeError, ValueError):
            list_rv = 0
        with self._lock:
            if kind == "pod":
                cached = list(self._pods.keys())
            elif kind == "node":
                cached = list(self._nodes.keys())
            elif kind == "provisioner":
                cached = list(self._provisioners.keys())
            else:
                cached = list(self._daemonsets.keys())
        for key in cached:
            if key in live:
                continue
            # The guard and the removal must be one atomic step: holding
            # _rv_lock across both means a write-through re-create either
            # fully precedes the guard (its newer rv skips the sweep) or
            # blocks at _record_rv until the sweep is done and then
            # re-inserts the object — no interleaving can delete a live
            # object and then have its watch replay suppressed by _newer.
            with self._rv_lock:
                # Write-through can land an object between our LIST and this
                # sweep; its rv is newer than the LIST's collection rv, so it
                # is not a ghost — leave it for the resumed watch to confirm.
                if list_rv and self._rv.get((kind, key), 0) > list_rv:
                    continue
                # Tombstone at the LIST's rv: any event predating the LIST
                # is a stale replay of this vanished object.
                self._entomb_locked((kind, key), list_rv)
                if kind == "pod":
                    namespace, name = key
                    ghost = {"metadata": {"namespace": namespace, "name": name}}
                else:
                    ghost = {"metadata": {"name": key}}
                self._remove_local(kind, ghost)
        for obj in items:
            # Gate on rv like _on_watch does: a write-through landing between
            # our LIST and this apply has a newer rv, and overwriting it with
            # the LIST's older copy would stick (the watch echo of the newer
            # write is deduplicated by _newer).
            if self._newer(kind, obj):
                self._apply_remote(kind, obj)
        self.resync_count += 1
        WATCH_RELIST_TOTAL.inc(kind)
        log.warning("watch for %s expired (410); re-listed %d objects", kind, len(items))
        return rv

    # --- cache application ---------------------------------------------------

    @staticmethod
    def _key(kind: str, obj: dict):
        metadata = obj.get("metadata") or {}
        if kind == "pod":
            return (metadata.get("namespace", "default"), metadata.get("name", ""))
        return metadata.get("name", "")

    def _newer(self, kind: str, obj: dict) -> bool:
        """resourceVersion gate: a watch event at-or-below what write-through
        already put in the cache is an echo of our own write — skipping it
        keeps cached object INSTANCES stable (controllers and tests hold
        references), while genuinely external changes (higher rv) re-sync.
        Events at-or-below a deletion tombstone are stale replays of a dead
        object and must not resurrect it."""
        metadata = obj.get("metadata") or {}
        try:
            rv = int(metadata.get("resourceVersion", 0))
        except (TypeError, ValueError):
            return True
        key = (kind, self._key(kind, obj))
        # Locked check-then-set: watch pumps and write-through callers (incl.
        # the bind fan-out) race on this dict; unlocked, an older event could
        # be applied after a newer one.
        with self._rv_lock:
            tombstone = self._tombstones.get(key)
            if tombstone is not None:
                if rv <= tombstone[0]:
                    return False
                self._tombstones.pop(key, None)  # genuine re-creation
            if rv <= self._rv.get(key, 0):
                return False
            self._rv[key] = rv
        return True

    def _entomb_locked(self, key, rv: int) -> None:
        """Record a deletion tombstone (caller holds _rv_lock). The rv map
        entry goes with the object (pod churn must not leak an entry per pod
        ever observed); the tombstone carries the deletion rv forward for
        TOMBSTONE_TTL_S so late replays can't resurrect the object, and the
        TTL bounds the tombstone map the same way popping bounded _rv.

        Prune cost: insertion order IS stamp order (appended with a fresh
        monotonic stamp), so expiry pops from the front and stops at the
        first live entry — O(expired) per delete, never a full scan."""
        now = self.clock.monotonic()
        self._rv.pop(key, None)
        cutoff = now - self.TOMBSTONE_TTL_S
        while self._tombstones:
            oldest = next(iter(self._tombstones))
            if self._tombstones[oldest][1] >= cutoff:
                break
            del self._tombstones[oldest]
        # Re-entombing an existing key must keep stamp order (drop the old
        # slot so the new entry appends at the back) and must NEVER lower
        # the rv — a stale replayed DELETED of an older incarnation would
        # otherwise reopen the gate for stale events of a newer one.
        old = self._tombstones.pop(key, None)
        if old is not None and old[0] > rv:
            rv = old[0]
        self._tombstones[key] = (rv, now)

    def _on_watch(self, kind: str, event_type: str, obj: dict) -> None:
        try:
            if event_type == "DELETED":
                key = (kind, self._key(kind, obj))
                metadata = obj.get("metadata") or {}
                try:
                    delete_rv = int(metadata.get("resourceVersion", 0))
                except (TypeError, ValueError):
                    delete_rv = 0
                with self._rv_lock:
                    # DELETED needs the same staleness gate as every other
                    # event: a replayed DELETED of a PRIOR incarnation must
                    # not evict a live re-created object (cache rv newer)
                    # nor lower an existing tombstone.
                    tombstone = self._tombstones.get(key)
                    if (
                        delete_rv
                        and tombstone is not None
                        and delete_rv <= tombstone[0]
                    ):
                        return  # replay of a deletion already tombstoned
                    if delete_rv and delete_rv < self._rv.get(key, 0):
                        return  # the live object is a newer incarnation
                    # The DELETED event's rv is >= every prior event of the
                    # object; fall back to the last rv we applied.
                    self._entomb_locked(
                        key, max(delete_rv, self._rv.get(key, 0))
                    )
                self._remove_local(kind, obj)
            elif not self._hold(kind, obj) and self._newer(kind, obj):
                self._apply_remote(kind, obj)
        except Exception:  # noqa: BLE001 — one bad event must not kill the pump
            log.exception("applying %s %s event failed", kind, event_type)

    def _hold(self, kind: str, obj: dict) -> bool:
        """Hold back a pump event for an object a write-through has in
        flight; _end_write applies it, or drops it as the write's echo,
        once the write has recorded its rv. Only the pump's ADDED and
        MODIFIED events come here: DELETED keeps its own gate above, and
        LIST items (start, _relist) are never held."""
        slot = (kind, self._key(kind, obj))
        with self._rv_lock:
            if slot not in self._in_flight:
                return False
            self._held.setdefault(slot, []).append(obj)
            self.echoes_held += 1
        return True

    @contextlib.contextmanager
    def _write_through(self, kind: str, key):
        """Mark one write-through of (kind, key) in flight for the body: the
        RPC, its _record_rv and the cache update. The pump's events for the
        object wait meanwhile (_hold), and are released when the body ends,
        whether it returned or raised. _rv_lock is held only around the
        bookkeeping, never across the RPC."""
        slot = (kind, key)
        with self._rv_lock:
            self._in_flight[slot] = self._in_flight.get(slot, 0) + 1
        try:
            yield
        finally:
            self._end_write(slot)

    def _end_write(self, slot) -> None:
        """End one write of `slot`. The last write in flight applies the
        held events in their order through the rv gate: one at or below the
        rv the write recorded is its echo and is dropped, one above it is an
        external change and is applied. The slot stays in flight until no
        event is left, so events arriving meanwhile queue behind them."""
        kind = slot[0]
        while True:
            with self._rv_lock:
                held = self._held.pop(slot, None)
                if held is None or self._in_flight[slot] > 1:
                    if held is not None:
                        self._held[slot] = held  # the last write releases them
                    left = self._in_flight[slot] - 1
                    if left:
                        self._in_flight[slot] = left
                    else:
                        del self._in_flight[slot]
                    return
            for obj in held:
                try:
                    applied = self._newer(kind, obj)
                    if applied:
                        self._apply_remote(kind, obj)
                except Exception:  # noqa: BLE001 — one bad event must not fail the write
                    log.exception("applying a held %s event failed", kind)
                    continue
                with self._rv_lock:
                    if applied:
                        self.echoes_applied += 1
                    else:
                        self.echoes_dropped += 1

    def _apply_remote(self, kind: str, obj: dict) -> None:
        self._newer(kind, obj)  # record rv on initial LIST too
        if kind == "pod":
            super().apply_pod(convert.pod_from_kube(obj))
        elif kind == "node":
            node = convert.node_from_kube(obj)
            existing = super().try_get_node(node.name)
            if existing is None or node.deletion_timestamp is None:
                super().apply_node(node)
            else:
                # Deletion flows through the finalizer protocol locally too.
                existing.deletion_timestamp = node.deletion_timestamp
                existing.finalizers = node.finalizers
                super().update_node(existing)
        elif kind == "provisioner":
            super().apply_provisioner(convert.provisioner_from_kube(obj))
        elif kind == "daemonset":
            metadata = obj.get("metadata") or {}
            super().apply_daemonset(
                metadata.get("name", ""), convert.daemonset_template_from_kube(obj)
            )

    def _remove_local(self, kind: str, obj: dict) -> None:
        key = self._key(kind, obj)
        if kind == "pod":
            super().delete_pod(*key)
        elif kind == "node":
            with self._lock:
                node = self._nodes.pop(key, None)
            if node is not None:
                self._notify("node", node, verb="delete")
        elif kind == "provisioner":
            with self._lock:
                provisioner = self._provisioners.pop(key, None)
            if provisioner is not None:
                provisioner.deletion_timestamp = (
                    provisioner.deletion_timestamp or self.clock.now()
                )
                self._notify("provisioner", provisioner, verb="delete")
        elif kind == "daemonset":
            with self._lock:
                self._daemonsets.pop(key, None)

    def _record_rv(self, kind: str, obj: dict) -> None:
        self._newer(kind, obj)

    # --- pods ---------------------------------------------------------------

    def _create_or_update(self, collection_path: str, obj_path: str, body: dict):
        """Create-first apply: POST, and only on 409 (already exists) GET the
        current resourceVersion and PUT. The common case (new object — every
        pod of a storm) is one RPC instead of the GET-then-POST pair, which
        at 10k-pod scale halves the write-plane round trips."""
        try:
            return self.api.create(collection_path, body)
        except ApiError as error:
            if error.status != 409:
                raise
        existing = self.api.try_get(obj_path)
        if existing is None:
            # Deleted between our 409 and the GET: retry the create once.
            return self.api.create(collection_path, body)
        body.setdefault("metadata", {})["resourceVersion"] = (
            existing.get("metadata", {}).get("resourceVersion")
        )
        return self.api.update(obj_path, body)

    def apply_pod(self, pod: PodSpec) -> PodSpec:
        self.fence.check("apply_pod")
        with self._write_through("pod", (pod.namespace, pod.name)):
            created = self._create_or_update(
                _pod_path(pod.namespace),
                _pod_path(pod.namespace, pod.name),
                convert.pod_to_kube(pod),
            )
            self._record_rv("pod", created)
            return super().apply_pod(pod)

    def bind_pod(self, pod: PodSpec, node: NodeSpec) -> None:
        self.fence.check("bind_pod")
        # The actual Binding RPC the reference issues per pod
        # (provisioner.go:239-247 → coreV1Client.Pods(...).Bind).
        try:
            self.api.create(
                _pod_path(pod.namespace, pod.name) + "/binding",
                {
                    "apiVersion": "v1",
                    "kind": "Binding",
                    "metadata": {"name": pod.name, "namespace": pod.namespace},
                    "target": {"kind": "Node", "name": node.name},
                },
            )
        except ApiError as error:
            if error.status != 409:
                raise
            # 409 "already bound": either the retry envelope re-POSTed a
            # Binding whose first attempt committed (response lost to a
            # timeout), or a rival bound the pod first. Ask the server WHOSE
            # bind won — ours is a success, anyone else's stays a conflict.
            live = self.api.try_get(_pod_path(pod.namespace, pod.name))
            bound_to = ((live or {}).get("spec") or {}).get("nodeName")
            if bound_to != node.name:
                raise
        super().bind_pod(pod, node)

    def delete_pod(
        self, namespace: str, name: str, uid: Optional[str] = None
    ) -> bool:
        self.fence.check("delete_pod")
        try:
            self.api.delete(_pod_path(namespace, name), uid=uid)
        except ApiError as error:
            if error.status == 409 and uid:
                # UID precondition failed: the name now belongs to a new
                # incarnation — the pod the caller observed is already gone.
                return False
            if error.status != 404:
                raise
            super().delete_pod(namespace, name, uid=uid)
            return False  # someone else already deleted it
        super().delete_pod(namespace, name, uid=uid)
        return True

    def evict_pod(self, namespace: str, name: str) -> None:
        """POST the Eviction subresource; the apiserver enforces PDBs and
        answers 429 (ref: termination/eviction.go:90-109)."""
        self.fence.check("evict_pod")
        try:
            self.api.create(
                _pod_path(namespace, name) + "/eviction",
                {
                    "apiVersion": "policy/v1",
                    "kind": "Eviction",
                    "metadata": {"name": name, "namespace": namespace},
                },
            )
        except ApiError as error:
            if error.status == 429 or error.status == 500:
                raise PDBViolationError(f"pod {namespace}/{name} blocked by PDB")
            if error.status == 404:
                return
            raise
        pod = super().try_get_pod(namespace, name)
        if pod is not None:
            pod.deletion_timestamp = self.clock.now()
            self._notify("pod", pod, verb="update")

    def reschedule_pod(self, namespace: str, name: str, override_pdb: bool = False):
        self.fence.check("reschedule_pod")
        # One displacement in flight at a time: the server-truth gate below
        # reads a fresh LIST, and two concurrent drains passing on the same
        # healthy count would jointly overspend the budget. The gate runs
        # ONLY here, on the actual displacement — nomination pre-checks
        # (consolidation's _drainable_pods) keep the cache-based
        # _pdb_allows, or every sweep would pay O(candidates x pods) full
        # server LISTs.
        with self._disruption_lock:
            if not override_pdb:
                pod = self.try_get_pod(namespace, name)
                if (
                    pod is not None
                    and pod.node_name is not None
                    and not self._pdb_allows_server(pod)
                ):
                    from karpenter_tpu_torch.controllers.errors import PDBViolationError

                    raise PDBViolationError(
                        f"pod {namespace}/{name} blocked by PDB"
                    )
            return super().reschedule_pod(namespace, name, override_pdb)

    def _pdb_allows_server(self, pod) -> bool:
        """Server-truth budget check — the displacement analogue of the
        server-gated Eviction subresource. The cache-based _pdb_allows
        rides the chaos-mangled watch streams: a duplicated/reordered event
        from BEFORE a displacement can resurrect the victim's bound state,
        the stale count over-reports, and one polite drain sweep displaces
        every replica behind the PDB (the market-storm smoke caught exactly
        this). So the budget is counted from a fresh server LIST — the
        un-mangled truth — with the victim's own bound state read from the
        same snapshot."""
        with self._lock:
            pdbs = list(self._pdbs.values())
        matching = [
            (labels, min_available)
            for labels, min_available in pdbs
            if all(pod.labels.get(k) == v for k, v in labels.items())
        ]
        if not matching:
            return True
        healthy_labels, victim_counts = self._server_healthy_pods(pod)
        for match_labels, min_available in matching:
            healthy = sum(
                1
                for labels in healthy_labels
                if all(labels.get(k) == v for k, v in match_labels.items())
            )
            if healthy - (1 if victim_counts else 0) < min_available:
                return False
        return True

    def _server_healthy_pods(self, victim):
        """One fresh server LIST -> (label dicts of every healthy BOUND
        non-terminating pod, whether the victim itself is among them)."""
        victim_counts = False
        healthy_labels = []
        for item in self.api.list(PODS):
            meta = item.get("metadata") or {}
            if meta.get("deletionTimestamp"):
                continue
            if not (item.get("spec") or {}).get("nodeName"):
                continue
            healthy_labels.append(meta.get("labels") or {})
            if (
                meta.get("namespace", "default") == victim.namespace
                and meta.get("name") == victim.name
            ):
                victim_counts = True
        return healthy_labels, victim_counts

    def _reschedule_local(self, namespace: str, name: str):
        """Write-through displacement: clear spec.nodeName (merge-patch null
        removes the key), restore the Unschedulable condition so a re-list
        sees the pod as provisionable again, and persist the bumped
        reschedule epoch (launch-identity input); then update the cache. The
        PDB gate already ran in reschedule_pod against the SERVER's pod list
        (_pdb_allows above; PDBs write through both sides)."""
        from karpenter_tpu_torch.controllers.cluster import reschedule_epoch

        with self._write_through("pod", (namespace, name)):
            pod = self.try_get_pod(namespace, name)
            epoch = reschedule_epoch(pod) + 1 if pod is not None else 1
            try:
                updated = self.api.patch(
                    _pod_path(namespace, name),
                    {
                        "metadata": {
                            "annotations": {
                                wellknown.RESCHEDULE_EPOCH_ANNOTATION: str(epoch)
                            }
                        },
                        "spec": {"nodeName": None},
                        "status": {
                            "conditions": [
                                {
                                    "type": "PodScheduled",
                                    "status": "False",
                                    "reason": "Unschedulable",
                                }
                            ]
                        },
                    },
                )
                self._record_rv("pod", updated)
            except ApiError as error:
                if error.status != 404:
                    raise
            return super()._reschedule_local(namespace, name)

    def apply_pdb(self, name: str, match_labels, min_available: int):
        self.fence.check("apply_pdb")
        path = "/apis/policy/v1/namespaces/default/poddisruptionbudgets"
        body = {
            "apiVersion": "policy/v1",
            "kind": "PodDisruptionBudget",
            "metadata": {"name": name, "namespace": "default"},
            "spec": {
                "minAvailable": min_available,
                "selector": {"matchLabels": dict(match_labels)},
            },
        }
        self._create_or_update(path, f"{path}/{name}", body)
        super().apply_pdb(name, match_labels, min_available)

    # --- nodes --------------------------------------------------------------

    def create_node(self, node: NodeSpec) -> NodeSpec:
        self.fence.check("create_node")
        with self._write_through("node", node.name):
            if not node.created_at:
                node.created_at = self.clock.now()
            # The apiserver is the strictness authority here (duplicate names
            # come back as ApiError 409 from the create); the local cache update
            # is an upsert so a watch event racing our own write can't trip the
            # in-memory duplicate check.
            try:
                created = self.api.create(NODES, convert.node_to_kube(node))
            except ApiError as error:
                if error.status != 409:
                    raise
                # Verify the conflict before letting it become the adoption
                # signal upstream: a 409 for a node a GET cannot find is either
                # a conflict-storm artifact or a delete racing our create —
                # adopting a ghost would bind pods to a node that doesn't
                # exist. Retry the create once; a REAL AlreadyExists re-raises.
                if self.api.try_get(f"{NODES}/{node.name}") is not None:
                    raise
                created = self.api.create(NODES, convert.node_to_kube(node))
            self._record_rv("node", created)
            return super().apply_node(node)

    def update_node(self, node: NodeSpec) -> None:
        self.fence.check("update_node")
        with self._write_through("node", node.name):
            # PATCH (merge) only the fields controllers own; a full PUT would
            # clobber concurrent kubelet status updates.
            patch = {
                "metadata": {
                    "labels": dict(node.labels),
                    "annotations": dict(node.annotations),
                    "finalizers": list(node.finalizers),
                },
                "spec": {
                    "unschedulable": node.unschedulable,
                    "taints": [
                        {"key": t.key, "value": t.value, "effect": t.effect}
                        for t in node.taints
                    ],
                },
            }
            try:
                updated = self.api.patch(f"{NODES}/{node.name}", patch)
                self._record_rv("node", updated)
            except ApiError as error:
                if error.status != 404:
                    raise
            super().update_node(node)

    def heartbeat_node(self, name: str, ready: bool = True):
        # Status-only merge-patch — the write a real kubelet's status loop
        # issues. Deliberately disjoint from update_node's metadata/spec
        # patch so neither side clobbers the other. Unfenced (see base):
        # the reporter is the node, not the controller leader. Critical
        # lane: a heartbeat parked behind a bulk bind storm reads as a
        # gone-dark node and trips the health ladder for no reason.
        with self._write_through("node", name):
            try:
                with critical_lane():
                    updated = self.api.patch(
                        f"{NODES}/{name}",
                        {
                            "status": {
                                "conditions": [
                                    {
                                        "type": "Ready",
                                        "status": "True" if ready else "False",
                                        "lastHeartbeatTime": convert.rfc3339(
                                            self.clock.now()
                                        ),
                                    }
                                ]
                            }
                        },
                    )
                self._record_rv("node", updated)
            except ApiError as error:
                if error.status != 404:
                    raise
                return None
            return super().heartbeat_node(name, ready)

    def remove_node_annotation(self, node: NodeSpec, key: str) -> None:
        self.fence.check("remove_node_annotation")
        with self._write_through("node", node.name):
            # Merge-patch null is the only way to DELETE a key server-side
            # (RFC 7386); sending the remaining map would leave it in place and
            # the watch pump would resurrect it into the cache.
            try:
                updated = self.api.patch(
                    f"{NODES}/{node.name}", {"metadata": {"annotations": {key: None}}}
                )
                self._record_rv("node", updated)
            except ApiError as error:
                if error.status != 404:
                    raise
            super().remove_node_annotation(node, key)

    def delete_node(self, name: str) -> None:
        self.fence.check("delete_node")
        # Critical lane (with remove_finalizer below): the drain path's
        # teardown verbs — parking them behind a bulk storm holds reclaimed
        # capacity (and its cost) alive for the storm's duration.
        try:
            with critical_lane():
                self.api.delete(f"{NODES}/{name}")
        except ApiError as error:
            if error.status != 404:
                raise
        super().delete_node(name)

    def remove_finalizer(self, node: NodeSpec, finalizer: str) -> None:
        self.fence.check("remove_finalizer")
        with self._write_through("node", node.name):
            remaining = [f for f in node.finalizers if f != finalizer]
            try:
                with critical_lane():
                    updated = self.api.patch(
                        f"{NODES}/{node.name}",
                        {"metadata": {"finalizers": remaining}},
                    )
                self._record_rv("node", updated)
            except ApiError as error:
                if error.status != 404:
                    raise
            super().remove_finalizer(node, finalizer)

    # --- provisioners --------------------------------------------------------

    def apply_provisioner(self, provisioner: Provisioner) -> Provisioner:
        self.fence.check("apply_provisioner")
        with self._write_through("provisioner", provisioner.name):
            created = self._create_or_update(
                PROVISIONERS,
                f"{PROVISIONERS}/{provisioner.name}",
                convert.provisioner_to_kube(provisioner),
            )
            self._record_rv("provisioner", created)
            return super().apply_provisioner(provisioner)

    def update_provisioner_status(self, provisioner: Provisioner) -> None:
        self.fence.check("update_provisioner_status")
        with self._write_through("provisioner", provisioner.name):
            status = convert.provisioner_to_kube(provisioner).get("status", {})
            try:
                updated = self.api.patch(
                    f"{PROVISIONERS}/{provisioner.name}/status", {"status": status}
                )
                self._record_rv("provisioner", updated)
            except ApiError as error:
                if error.status != 404:
                    raise
            super().update_provisioner_status(provisioner)

    def delete_provisioner(self, name: str) -> None:
        self.fence.check("delete_provisioner")
        try:
            self.api.delete(f"{PROVISIONERS}/{name}")
        except ApiError as error:
            if error.status != 404:
                raise
        super().delete_provisioner(name)

    # --- daemonsets -----------------------------------------------------------

    def apply_daemonset(self, name: str, pod_template: PodSpec) -> None:
        self.fence.check("apply_daemonset")
        body = {
            "apiVersion": "apps/v1",
            "kind": "DaemonSet",
            "metadata": {"name": name, "namespace": "default"},
            "spec": {"template": convert.pod_to_kube(pod_template)},
        }
        path = f"{DAEMONSETS.replace('/daemonsets', '')}/namespaces/default/daemonsets"
        self._create_or_update(path, f"{path}/{name}", body)
        super().apply_daemonset(name, pod_template)

    # --- leases ---------------------------------------------------------------

    def acquire_lease(
        self,
        name: str,
        holder: str,
        duration_s: float,
        *,
        transitions: Optional[int] = None,
    ) -> int:
        """CAS over a real coordination.k8s.io Lease: optimistic-concurrency
        update keyed on resourceVersion; a 409 means a rival won the race.

        Returns the committed ``leaseTransitions`` (the fencing generation,
        bumped only on holder change) or 0 on a lost CAS, mirroring the
        server's counter into the in-memory cache so both backends report
        the identical generation. The ``lease.cas`` faultpoint flaps this
        verb for the chaos smokes: ``conflict`` loses the CAS outright,
        ``commit-lost`` performs the server write but reports it lost —
        the split-brain seed, which the next campaign must absorb by
        observing itself as holder WITHOUT a transitions bump.
        """
        fault = faultpoints.draw("lease.cas")
        if fault is not None and fault.kind == "conflict":
            return 0
        commit_lost = fault is not None and fault.kind == "commit-lost"
        # Critical lane for the whole read-CAS round: a lease renew queued
        # behind a bulk LIST/bind storm past the TTL deposes the leader —
        # the exact failure the reserved token budget exists to prevent.
        with critical_lane():
            now = self.clock.now()
            current = self.api.try_get(f"{LEASES}/{name}")
            if current is None:
                committed = int(transitions) if transitions is not None else 1
                won = self._lease_create(name, holder, duration_s, now, committed)
            else:
                committed = self._lease_next_transitions(
                    current, holder, now, transitions
                )
                won = committed > 0 and self._lease_update(
                    name, holder, duration_s, now, committed, current
                )
        if not won or commit_lost:
            return 0
        return super().acquire_lease(name, holder, duration_s, transitions=committed)

    def _lease_create(self, name, holder, duration_s, now, committed) -> bool:
        try:
            self.api.create(
                LEASES,
                convert.lease_to_kube(name, holder, duration_s, now, committed),
            )
        except ApiError as error:
            if error.status == 409:
                return False
            raise
        return True

    def _lease_next_transitions(self, current, holder, now, transitions):
        """The generation this acquire would commit, or 0 when the CAS is
        already lost (a rival holds an unexpired term)."""
        state = convert.lease_from_kube(current)
        # A vacated Lease (released holder) still carries its counter; read
        # it from the raw spec so the next generation doesn't restart at 1.
        prior_transitions = int(
            (current.get("spec") or {}).get("leaseTransitions", 0)
        )
        same_holder = False
        if state is not None:
            current_holder, renew, held_duration, prior_transitions = state
            if current_holder != holder and now < renew + held_duration:
                return 0
            same_holder = current_holder == holder
        if transitions is not None:
            return int(transitions)
        return prior_transitions if same_holder else prior_transitions + 1

    def _lease_update(
        self, name, holder, duration_s, now, committed, current
    ) -> bool:
        body = convert.lease_to_kube(name, holder, duration_s, now, committed)
        body["metadata"]["resourceVersion"] = current.get("metadata", {}).get(
            "resourceVersion"
        )
        try:
            self.api.update(f"{LEASES}/{name}", body)
        except ApiError as error:
            if error.status == 409:
                return False  # rival CAS'd first
            raise
        return True

    def release_lease(self, name: str, holder: str) -> bool:
        path = f"{LEASES}/{name}"
        with critical_lane():
            current = self.api.try_get(path)
            state = convert.lease_from_kube(current) if current else None
            if state is None or state[0] != holder:
                return False
            # Vacate by clearing holderIdentity instead of deleting the
            # object: leaseTransitions must survive a voluntary release, or
            # the next holder's generation would alias the first one's
            # fence token.
            body = convert.lease_to_kube(name, "", 0, self.clock.now(), state[3])
            body["metadata"]["resourceVersion"] = current.get("metadata", {}).get(
                "resourceVersion"
            )
            try:
                self.api.update(path, body)
            except ApiError as error:
                if error.status not in (404, 409):
                    raise
        return super().release_lease(name, holder)

    def get_lease(self, name: str):
        with critical_lane():
            current = self.api.try_get(f"{LEASES}/{name}")
        state = convert.lease_from_kube(current) if current else None
        if state is None:
            return None
        holder, renew, duration, lease_transitions = state
        if self.clock.now() >= renew + duration:
            return None
        return holder, renew + duration, lease_transitions
