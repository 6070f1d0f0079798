"""In-memory cluster state store — the envtest replacement.

Ref: pkg/test/environment.go boots a real apiserver via envtest; controllers
talk to it through a client. Here the same role is played by a thread-safe
in-process store with the handful of verbs the controllers use (get / list /
create / delete / bind / patch-like mutation under lock) plus watch-style
callbacks so the runtime can trigger reconciles on changes. All state the
framework needs survives in this store (SURVEY.md §5 checkpoint/resume: "all
state is in the Kubernetes API"); controllers stay stateless-restartable.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.pods import PodSpec
from karpenter_tpu_torch.api.provisioner import Provisioner
from karpenter_tpu_torch.cloudprovider import NodeSpec
from karpenter_tpu_torch.utils.clock import Clock, SYSTEM_CLOCK
from karpenter_tpu_torch.utils.fence import WriteFence

PodKey = Tuple[str, str]  # (namespace, name)


def reschedule_epoch(pod: PodSpec) -> int:
    """How many times this pod has been displaced back to pending (0 = never;
    see RESCHEDULE_EPOCH_ANNOTATION)."""
    raw = pod.annotations.get(wellknown.RESCHEDULE_EPOCH_ANNOTATION, "0")
    try:
        return int(raw)
    except ValueError:
        return 0


class NotFoundError(KeyError):
    pass


class AlreadyExistsError(Exception):
    """In-memory analogue of the apiserver's 409 AlreadyExists. Carries
    `status` so callers that branch on coded apiserver errors (e.g. the
    provisioning adopt-on-409 path) behave identically on both backends."""

    status = 409


class BindConflictError(Exception):
    """In-memory analogue of the apiserver's 409 on a Binding for a pod
    already assigned to another node."""

    status = 409


class Cluster:
    def __init__(self, clock: Optional[Clock] = None):
        self.clock = clock or SYSTEM_CLOCK
        self._lock = threading.RLock()
        self._pods: Dict[PodKey, PodSpec] = {}  # vet: guarded-by(self._lock)
        self._nodes: Dict[str, NodeSpec] = {}  # vet: guarded-by(self._lock)
        self._provisioners: Dict[str, Provisioner] = {}  # vet: guarded-by(self._lock)
        self._daemonsets: Dict[str, PodSpec] = {}  # vet: guarded-by(self._lock) — name -> pod template
        self._pdbs: Dict[str, Tuple[Dict[str, str], int]] = {}  # vet: guarded-by(self._lock) — selector, minAvailable
        self._leases: Dict[str, Tuple[str, float, int]] = {}  # vet: guarded-by(self._lock) — name -> (holder, expiry, transitions)
        self._watchers: List[Callable[[str, object], None]] = []
        self._delta_watchers: List[Callable[[str, str, object], None]] = []
        # Write fence: armed with the lease generation by the LeaderElector,
        # revoked the instant leadership is lost. Standalone in-memory this
        # store IS the shared state, so every origin write is fenced here;
        # the apiserver backend flips _fence_is_store off because this layer
        # is then only the informer cache — a deposed leader's watch pump
        # must keep syncing it — and moves the fence to the write-through
        # verbs (kubeapi/cluster.py).
        self.fence = WriteFence()
        self._fence_is_store = True

    def _fence_check(self, verb: str) -> None:
        if self._fence_is_store:
            self.fence.check(verb)

    # --- watch plumbing ----------------------------------------------------

    def watch(self, callback: Callable[[str, object], None]) -> None:
        """callback(kind, obj) on every mutation; kind in
        {pod, node, provisioner, daemonset}."""
        self._watchers.append(callback)

    def watch_deltas(self, callback: Callable[[str, str, object], None]) -> None:
        """callback(verb, kind, obj) on every mutation — the verb-level feed
        the incremental encoder consumes (models/cluster_state.py). Verbs:
        apply | bind | update | delete | reschedule. Delivery order across
        threads is NOT guaranteed; consumers must treat each event as a
        sync-this-key hint and re-read the store (which is always at least
        as new as the event), never as a replayable op log."""
        self._delta_watchers.append(callback)

    def _notify(self, kind: str, obj, verb: str = "apply") -> None:
        # INVARIANT (pinned by the blocking-under-lock vet rule): callback
        # dispatch runs OUTSIDE self._lock. Watch callbacks fan out into
        # reconcile enqueues and the incremental-encode sync, both of which
        # take their own locks — firing them under the store lock would
        # convoy every verb behind the slowest consumer and invite
        # lock-order inversions.
        for callback in list(self._watchers):
            callback(kind, obj)
        for callback in list(self._delta_watchers):
            callback(verb, kind, obj)

    # --- pods --------------------------------------------------------------

    def apply_pod(self, pod: PodSpec) -> PodSpec:
        self._fence_check("apply_pod")
        with self._lock:
            if pod.created_at is None:
                # Stamp creationTimestamp on first apply; an update arriving
                # without one (e.g. a watch-pump conversion) inherits the
                # stored pod's — the lifecycle tracker's restart re-anchor
                # depends on this surviving every round trip.
                existing = self._pods.get((pod.namespace, pod.name))
                pod.created_at = (
                    existing.created_at
                    if existing is not None and existing.created_at is not None
                    else self.clock.now()
                )
            self._pods[(pod.namespace, pod.name)] = pod
        self._notify("pod", pod)
        return pod

    def get_pod(self, namespace: str, name: str) -> PodSpec:
        with self._lock:
            try:
                return self._pods[(namespace, name)]
            except KeyError:
                raise NotFoundError(f"pod {namespace}/{name}")

    def try_get_pod(self, namespace: str, name: str) -> Optional[PodSpec]:
        # Lock-free: a single dict read is atomic under the GIL, and
        # mutators replace whole entries (never partially mutate the
        # mapping), so the read sees either the previous or the current
        # object — the same guarantee the lock gave a point read. This is
        # THE hottest read in a pod storm (one per selection reconcile),
        # and 128 selection workers convoyed on the cluster lock here.
        return self._pods.get((namespace, name))  # vet: unguarded(GIL-atomic point read; rationale above)

    def list_pods(
        self,
        node_name: Optional[str] = None,
        predicate: Optional[Callable[[PodSpec], bool]] = None,
    ) -> List[PodSpec]:
        """node_name uses the same role as the reference's spec.nodeName field
        index (ref: manager.go:60-66)."""
        with self._lock:
            pods = list(self._pods.values())
        if node_name is not None:
            pods = [p for p in pods if p.node_name == node_name]
        if predicate is not None:
            pods = [p for p in pods if predicate(p)]
        return pods

    def bind_pod(self, pod: PodSpec, node: NodeSpec) -> None:
        self._fence_check("bind_pod")
        with self._lock:
            stored = self._pods.get((pod.namespace, pod.name))
            if stored is None:
                raise NotFoundError(f"pod {pod.namespace}/{pod.name}")
            if stored.node_name is not None and stored.node_name != node.name:
                # Two binders raced for one pending pod (a provisioning pass
                # drained it just before consolidation rebound it): the
                # first binding stands, as the apiserver keeps it.
                raise BindConflictError(
                    f"pod {pod.namespace}/{pod.name} is already bound to {stored.node_name}"
                )
            stored.node_name = node.name
            stored.unschedulable = False
        self._notify("pod", stored, verb="bind")

    def delete_pod(
        self, namespace: str, name: str, uid: Optional[str] = None
    ) -> bool:
        """uid, when given, preconditions the delete (DeleteOptions
        semantics): a same-name pod re-created since the caller observed the
        victim is left alone (compare-and-pop under the lock). Returns True
        iff this call removed the pod."""
        self._fence_check("delete_pod")
        with self._lock:
            pod = self._pods.get((namespace, name))
            if pod is None:
                return False
            if uid and (getattr(pod, "uid", "") or "") != uid:
                return False
            self._pods.pop((namespace, name), None)
        self._notify("pod", pod, verb="delete")
        return True

    def evict_pod(self, namespace: str, name: str) -> None:
        """Eviction-API analogue: honors PDBs (429-equivalent refusal)
        (ref: termination/eviction.go:90-109)."""
        self._fence_check("evict_pod")
        with self._lock:
            pod = self._pods.get((namespace, name))
            if pod is None:
                return
            if not self._pdb_allows(pod):
                from karpenter_tpu_torch.controllers.errors import PDBViolationError

                raise PDBViolationError(f"pod {namespace}/{name} blocked by PDB")
            pod.deletion_timestamp = self.clock.now()
        self._notify("pod", pod, verb="update")

    def reschedule_pod(
        self, namespace: str, name: str, override_pdb: bool = False
    ) -> Optional[PodSpec]:
        """Displace a bound pod back to pending (node_name cleared,
        unschedulable set) so the provisioning path rebinds it onto fresh
        capacity — the interruption drain's replacement for evict-to-death
        (this store has no workload controller to re-create an evicted pod,
        so displacement IS the re-creation; see docs/design/interruption.md).
        The disruption is PDB-gated like eviction unless `override_pdb` (the
        deadline-escalation path, which prefers a budget violation over
        losing the pod uncleanly). Returns the displaced pod, or None when it
        no longer exists; a pod already unbound is returned unchanged."""
        self._fence_check("reschedule_pod")
        pod = self.try_get_pod(namespace, name)
        if pod is None or pod.node_name is None:
            return pod
        if not override_pdb and not self._pdb_allows(pod):
            from karpenter_tpu_torch.controllers.errors import PDBViolationError

            raise PDBViolationError(f"pod {namespace}/{name} blocked by PDB")
        return self._reschedule_local(namespace, name)

    def _reschedule_local(self, namespace: str, name: str) -> Optional[PodSpec]:
        """The store-side half of reschedule_pod (the apiserver backend
        overrides this to write through first)."""
        with self._lock:
            pod = self._pods.get((namespace, name))
            if pod is None:
                return None
            if pod.node_name is None:
                # Displaced by another caller since reschedule_pod looked.
                return pod
            pod.node_name = None
            pod.unschedulable = True
            # The epoch bump makes the replacement a DIFFERENT logical launch
            # than the purchase backing the old node (the launch identity
            # hashes uid@epoch) — without it, a restart-idempotent provider
            # would adopt the dying instance and rebind the pod onto the very
            # node being reclaimed.
            pod.annotations[wellknown.RESCHEDULE_EPOCH_ANNOTATION] = str(
                reschedule_epoch(pod) + 1
            )
        self._notify("pod", pod, verb="reschedule")
        return pod

    # --- pod disruption budgets (simplified) --------------------------------

    def apply_pdb(self, name: str, match_labels: Dict[str, str], min_available: int):
        self._fence_check("apply_pdb")
        with self._lock:
            self._pdbs[name] = (dict(match_labels), min_available)

    def _pdb_allows(self, pod: PodSpec) -> bool:
        """Healthy = bound and not terminating: a pod displaced back to
        pending (reschedule_pod) is down for the whole relaunch+rebind
        latency, so it must not count toward the budget — otherwise one
        polite drain sweep could displace every replica behind a PDB, each
        step still seeing the previous victims as 'healthy'."""
        with self._lock:
            pdbs = list(self._pdbs.values())
        for match_labels, min_available in pdbs:
            if not all(pod.labels.get(k) == v for k, v in match_labels.items()):
                continue
            with self._lock:
                healthy = [
                    p
                    for p in self._pods.values()
                    if p.deletion_timestamp is None
                    and p.node_name is not None
                    and all(p.labels.get(k) == v for k, v in match_labels.items())
                ]
            # Disrupting an already-unhealthy pod costs the budget nothing.
            victim_counts = (
                pod.deletion_timestamp is None and pod.node_name is not None
            )
            if len(healthy) - (1 if victim_counts else 0) < min_available:
                return False
        return True

    # --- nodes -------------------------------------------------------------

    def create_node(self, node: NodeSpec) -> NodeSpec:
        """Strict create, like the apiserver: a duplicate name is a 409, not
        a silent overwrite — the provisioning adopt-on-409 path depends on
        creates failing loudly. Remote-sourced state (watch events) goes
        through `apply_node` instead."""
        self._fence_check("create_node")
        with self._lock:
            if node.name in self._nodes:
                raise AlreadyExistsError(f"node {node.name} already exists")
            if not node.created_at:
                node.created_at = self.clock.now()
            self._nodes[node.name] = node
        self._notify("node", node)
        return node

    def apply_node(self, node: NodeSpec) -> NodeSpec:
        """Upsert from an authoritative source (the kubeapi watch pump, a
        write-through whose create the real apiserver already admitted)."""
        with self._lock:
            if not node.created_at:
                node.created_at = self.clock.now()
            self._nodes[node.name] = node
        self._notify("node", node)
        return node

    def get_node(self, name: str) -> NodeSpec:
        with self._lock:
            try:
                return self._nodes[name]
            except KeyError:
                raise NotFoundError(f"node {name}")

    def try_get_node(self, name: str) -> Optional[NodeSpec]:
        # Lock-free point read — same GIL-atomicity argument as try_get_pod.
        return self._nodes.get(name)  # vet: unguarded(GIL-atomic point read; same argument as try_get_pod)

    def list_nodes(
        self, predicate: Optional[Callable[[NodeSpec], bool]] = None
    ) -> List[NodeSpec]:
        with self._lock:
            nodes = list(self._nodes.values())
        if predicate is not None:
            nodes = [n for n in nodes if predicate(n)]
        return nodes

    def update_node(self, node: NodeSpec) -> None:
        self._fence_check("update_node")
        self._notify("node", node, verb="update")

    def heartbeat_node(self, name: str, ready: bool = True) -> Optional[NodeSpec]:
        """Kubelet-side status report: stamp status_reported_at with the
        current clock and set the Ready condition. A dedicated verb (not
        update_node) because heartbeats are STATUS writes — the apiserver
        backend patches only status.conditions so a controller's concurrent
        metadata/spec patch is never clobbered, and vice versa. Unfenced:
        heartbeats come from the node's kubelet, not the (possibly deposed)
        controller leader. Returns the node, or None if it doesn't exist."""
        with self._lock:
            node = self._nodes.get(name)
            if node is None:
                return None
            node.ready = ready
            node.status_reported_at = self.clock.now()
        self._notify("node", node, verb="update")
        return node

    def remove_node_annotation(self, node: NodeSpec, key: str) -> None:
        """Delete one annotation. A dedicated verb because removal does NOT
        survive update_node on the apiserver backend: its merge-patch sends
        the annotations map, and RFC 7386 keeps server keys absent from the
        patch — the popped key would resurrect through the watch pump. The
        apiserver override patches the key to null explicitly."""
        self._fence_check("remove_node_annotation")
        with self._lock:
            node.annotations.pop(key, None)
        self._notify("node", node, verb="update")

    def delete_node(self, name: str) -> None:
        """Marks deletion; the object lingers while finalizers remain
        (ref: the apiserver finalizer protocol driving termination §3.4)."""
        self._fence_check("delete_node")
        with self._lock:
            node = self._nodes.get(name)
            if node is None:
                return
            if node.deletion_timestamp is None:
                node.deletion_timestamp = self.clock.now()
            removed = not node.finalizers
            if removed:
                self._nodes.pop(name, None)
        self._notify("node", node, verb="delete" if removed else "update")

    def remove_finalizer(self, node: NodeSpec, finalizer: str) -> None:
        self._fence_check("remove_finalizer")
        with self._lock:
            if finalizer in node.finalizers:
                node.finalizers.remove(finalizer)
            removed = node.deletion_timestamp is not None and not node.finalizers
            if removed:
                self._nodes.pop(node.name, None)
        self._notify("node", node, verb="delete" if removed else "update")

    # --- provisioners ------------------------------------------------------

    def apply_provisioner(self, provisioner: Provisioner) -> Provisioner:
        self._fence_check("apply_provisioner")
        with self._lock:
            self._provisioners[provisioner.name] = provisioner
        self._notify("provisioner", provisioner)
        return provisioner

    def try_get_provisioner(self, name: str) -> Optional[Provisioner]:
        # Lock-free point read — same GIL-atomicity argument as try_get_pod.
        return self._provisioners.get(name)  # vet: unguarded(GIL-atomic point read; same argument as try_get_pod)

    def list_provisioners(self) -> List[Provisioner]:
        # Copy under the lock, sort OUTSIDE it (the list_pods/list_nodes
        # pattern): the convoy on this path came from the O(n log n) sort
        # with its Python key lambda running under the shared lock, while
        # selection routes every reconcile through here. The copy itself is
        # not safely lock-free — list() allocation can trigger a GC pass
        # whose callbacks yield the GIL mid-materialization.
        with self._lock:
            provisioners = list(self._provisioners.values())
        return sorted(provisioners, key=lambda p: p.name)

    def update_provisioner_status(self, provisioner: Provisioner) -> None:
        """Persist a status mutation (resources/conditions/lastScaleTime).
        In-memory the object IS the store so this only notifies; the
        apiserver backend PATCHes the CRD status subresource — controllers
        must route status writes through here to survive either backend."""
        self._fence_check("update_provisioner_status")
        self._notify("provisioner", provisioner)

    def delete_provisioner(self, name: str) -> None:
        self._fence_check("delete_provisioner")
        with self._lock:
            provisioner = self._provisioners.pop(name, None)
        if provisioner is not None:
            provisioner.deletion_timestamp = self.clock.now()
            self._notify("provisioner", provisioner, verb="delete")

    # --- daemonsets ---------------------------------------------------------

    def apply_daemonset(self, name: str, pod_template: PodSpec) -> None:
        self._fence_check("apply_daemonset")
        with self._lock:
            self._daemonsets[name] = pod_template
        self._notify("daemonset", pod_template)

    def list_daemonset_templates(self) -> List[PodSpec]:
        with self._lock:
            return list(self._daemonsets.values())

    # --- leases (coordination.k8s.io Lease analogue) -----------------------

    def acquire_lease(
        self,
        name: str,
        holder: str,
        duration_s: float,
        *,
        transitions: Optional[int] = None,
    ) -> int:
        """Compare-and-swap acquire/renew: succeeds when the lease is free,
        expired, or already held by `holder` (renewal). The store-side
        analogue of the Lease object the reference's leader election uses
        (ref: cmd/controller/main.go:80-81).

        Returns the lease's ``transitions`` counter (>= 1) on success and 0
        on a lost CAS, so callers keep their old truthiness checks while the
        elector learns its generation. The counter bumps only on a holder
        CHANGE (kube leaseTransitions semantics): renewals — and a holder
        re-acquiring its own expired or committed-then-lost lease — keep the
        prior value, which is what makes the generation a fencing token: it
        moves exactly when writes may have interleaved with a rival's.

        ``transitions`` (keyword-only) lets the apiserver backend mirror the
        SERVER's committed counter into this cache instead of recomputing it
        locally — the mirror must never drift from the store of record.
        """
        with self._lock:
            now = self.clock.now()
            current = self._leases.get(name)
            prior_holder: Optional[str] = None
            prior_transitions = 0
            if current is not None:
                prior_holder, expiry, prior_transitions = current
                if prior_holder != holder and now < expiry:
                    return 0
            if transitions is not None:
                committed = int(transitions)
            elif prior_holder == holder:
                committed = prior_transitions
            else:
                committed = prior_transitions + 1
            self._leases[name] = (holder, now + duration_s, committed)
            return committed

    def release_lease(self, name: str, holder: str) -> bool:
        with self._lock:
            current = self._leases.get(name)
            if current is None or current[0] != holder:
                return False
            # Keep the transitions counter under the tombstoned name so the
            # next holder still observes a bump — dropping it would reissue
            # generation 1 and alias the first holder's fence token.
            _, _, prior_transitions = current
            self._leases[name] = ("", 0.0, prior_transitions)
            return True

    def get_lease(self, name: str) -> Optional[Tuple[str, float, int]]:
        """(holder, expiry, transitions) or None; expired or released leases
        read as None."""
        with self._lock:
            current = self._leases.get(name)
            if current is None or not current[0] or self.clock.now() >= current[1]:
                return None
            return current
