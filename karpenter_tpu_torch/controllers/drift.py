"""Drift detection and budgeted rolling replacement.

A Provisioner's spec is a statement about what its nodes SHOULD look like;
nothing before this controller ever re-checked running capacity against it.
Flip a taint, move an AMI, drop an instance type from the catalog — and the
old fleet keeps running the old answer forever (the reference calls this
drift; ref: the machine-drift controller in modern Karpenter). This sweep
closes that loop with three drift kinds, all rolled through ONE budgeted,
strictly-voluntary replacement path:

1. **Spec-hash drift** (kind ``spec``). Every node is stamped at
   registration with `karpenter.sh/provisioner-hash` — the canonical hash
   (karpenter_tpu/drift) of the STORED constraint envelope that launched
   it. The sweep recomputes the hash from the current stored spec; a
   mismatch means the operator changed the envelope and this node predates
   the change. A MISSING hash is never drift: legacy/adopted nodes are
   stamped with the current hash on sight (here and by the node
   controller's HashStamp) and participate from the next change onward.

2. **Provider-side drift** (kind ``provider``). `CloudProvider.
   instance_drifted(node)` — launch-template/AMI generation moved, the
   instance type vanished from the raw catalog, or the node's spot pool has
   been ICE-closed past a sustained window. The provider returns a human
   reason string; any non-None answer nominates the node.

3. **Expiration** (kind ``expired``). `ttlSecondsUntilExpired` elapsed —
   previously its own sub-reconciler deleting unconditionally, now just
   another drift kind riding the same budget (controllers/node.py's
   Expiration claims through the same ledger, so whichever actor sees the
   expired node first wins and the other never double-claims).

Replacement follows the consolidation drain discipline: durable
DRIFT_ACTION annotation FIRST (the restart-resume record and the ledger's
in-flight marker), cordon, PDB-gated `reschedule_pod` displacement with the
epoch bump, displaced pods fed straight to the owning provisioner's batch
window — replacement capacity is launching BEFORE the victim finishes
draining — then the finalizer-path delete. Strictly voluntary: PDB refusals
roll to the next sweep, a do-not-evict pod cancels the action, and
interruption-claimed or deleting nodes are never touched.

The sweep claims at most `DisruptionLedger.headroom("drift")` new victims
per pass — min(global `--disruption-budget` remaining, `--drift-max-
disruption` remaining) — so a spec flip over a 50-node fleet rolls
budget-at-a-time instead of draining everything at once.

Crash consistency: `drift.{after-mark,mid-replace,before-delete}` are named
crashpoints; tests/test_drift.py kills the controller at each and asserts a
restart converges from the durable annotation — pods bound exactly once,
victim gone, zero leaks.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from karpenter_tpu_torch import drift as driftlib
from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.cloudprovider import CloudProvider, NodeSpec
from karpenter_tpu_torch.controllers import eligibility
from karpenter_tpu_torch.controllers.cluster import Cluster
from karpenter_tpu_torch.controllers.errors import PDBViolationError
from karpenter_tpu_torch.controllers.provisioning import ProvisioningController
from karpenter_tpu_torch.controllers.termination import TerminationController
from karpenter_tpu_torch.utils import logging as klog
from karpenter_tpu_torch.utils.crashpoints import crashpoint
from karpenter_tpu_torch.utils.metrics import REGISTRY
from karpenter_tpu_torch.utils.obs import RECORDER

SWEEP_SECONDS = 30.0

DRIFT_NODES = REGISTRY.gauge(
    "drift_nodes",
    "Live nodes currently detected as drifted, by reason "
    "(spec|provider|expired), as of the last sweep — includes nodes the "
    "budget hasn't reached yet",
    ["reason"],
)
DRIFT_REPLACEMENTS_TOTAL = REGISTRY.counter(
    "drift_replacements_total",
    "Drift replacement outcomes by drift kind and result "
    "(executed|blocked|cancelled)",
    ["kind", "result"],
)


class DriftController:
    """Periodic sweep (Manager drives it like consolidation): detect
    drifted nodes, claim up to the shared budget, roll each through the
    annotate->cordon->displace->delete replacement path."""

    def __init__(
        self,
        cluster: Cluster,
        cloud: CloudProvider,
        provisioning: ProvisioningController,
        termination: TerminationController,
        ledger: Optional[eligibility.DisruptionLedger] = None,
        enabled: bool = True,
    ):
        self.cluster = cluster
        self.cloud = cloud
        self.provisioning = provisioning
        self.termination = termination
        self.enabled = enabled
        self.ledger = ledger or eligibility.DisruptionLedger(cluster)
        self.log = klog.named("drift")

    # --- sweep --------------------------------------------------------------

    def reconcile(self, _key=None) -> float:
        if not self.enabled:
            return SWEEP_SECONDS
        # Resume in-flight replacements first: the durable annotation is the
        # restart-resume record, exactly like consolidation's.
        for node in self.cluster.list_nodes():
            if (
                wellknown.DRIFT_ACTION_ANNOTATION in node.annotations
                and node.deletion_timestamp is None
            ):
                self._drain(node)
        drifted = self._detect()
        counts = {kind: 0 for kind in driftlib.DRIFT_KINDS}
        for _, kind, _ in drifted:
            counts[kind] += 1
        for kind in driftlib.DRIFT_KINDS:
            DRIFT_NODES.set(float(counts[kind]), kind)
        budget = self.ledger.headroom(eligibility.REASON_DRIFT)
        for node, kind, reason in drifted[:budget]:
            self._begin(node, kind, reason)
        return SWEEP_SECONDS

    def _detect(self) -> List[Tuple[NodeSpec, str, str]]:
        """Every un-claimed drifted node as (node, kind, reason), oldest
        first — a rolling upgrade replaces the stalest capacity first and
        the order is deterministic under equal ages (name tie-break)."""
        drifted: List[Tuple[NodeSpec, str, str]] = []
        for node in sorted(
            self.cluster.list_nodes(), key=lambda n: (n.created_at, n.name)
        ):
            provisioner_name = node.labels.get(wellknown.PROVISIONER_NAME_LABEL)
            if provisioner_name is None:
                continue  # not ours
            provisioner = self.cluster.try_get_provisioner(provisioner_name)
            if provisioner is None:
                continue
            if not eligibility.voluntary_disruption_allowed(node):
                continue
            if eligibility.claim_reason(node) is not None:
                continue  # already in flight (ours or another actor's)
            verdict = self._drift_verdict(provisioner, node)
            if verdict is not None:
                drifted.append((node, verdict[0], verdict[1]))
        return drifted

    def _drift_verdict(self, provisioner, node: NodeSpec) -> Optional[Tuple[str, str]]:
        """(kind, reason) when the node is drifted, else None. The spec hash
        is checked first (the cheapest and most common), then expiration,
        then the provider round-trip (potentially an API call per node)."""
        current = driftlib.spec_hash(provisioner)
        stamped = node.annotations.get(wellknown.PROVISIONER_HASH_ANNOTATION)
        if stamped is None:
            # Never drift while unstamped: adopt the node into the CURRENT
            # generation (see module docstring).
            node.annotations[wellknown.PROVISIONER_HASH_ANNOTATION] = current
            self.cluster.update_node(node)
            return None
        if stamped != current:
            return (
                driftlib.DRIFT_KIND_SPEC,
                f"provisioner hash {stamped} != current {current}",
            )
        ttl = provisioner.spec.ttl_seconds_until_expired
        if ttl is not None:
            age = self.cluster.clock.now() - node.created_at
            if age >= ttl:
                return (
                    driftlib.DRIFT_KIND_EXPIRED,
                    f"node age {age:.0f}s >= ttlSecondsUntilExpired {ttl}s",
                )
        try:
            provider_reason = self.cloud.instance_drifted(node)
        except Exception:  # noqa: BLE001 — drift is voluntary; API trouble = not drifted
            provider_reason = None
        if provider_reason is not None:
            return (driftlib.DRIFT_KIND_PROVIDER, provider_reason)
        return None

    # --- execution -----------------------------------------------------------

    def _begin(self, node: NodeSpec, kind: str, reason: str) -> None:
        live = self.cluster.try_get_node(node.name)
        if (
            live is None
            or not eligibility.voluntary_disruption_allowed(live)
            or eligibility.claim_reason(live) is not None
        ):
            return  # the cluster moved under the sweep: drop the nomination
        # Durable intent FIRST: a controller that dies past this point
        # resumes the replacement from the annotation.
        live.annotations[wellknown.DRIFT_ACTION_ANNOTATION] = kind
        self.cluster.update_node(live)
        RECORDER.record(
            "drift",
            node=live.name,
            drift_kind=kind,
            reason=reason,
            instance_type=live.instance_type,
        )
        self.log.info(
            "drift (%s) on %s (%s %s/%s): %s — beginning rolling replacement",
            kind, live.name, live.instance_type, live.zone,
            live.capacity_type, reason,
        )
        crashpoint("drift.after-mark")
        displaced = self._drain(live)
        if displaced == 0 and self.cluster.try_get_node(live.name) is not None:
            DRIFT_REPLACEMENTS_TOTAL.inc(kind, "blocked")

    def _drain(self, node: NodeSpec) -> Optional[int]:
        """One polite drain pass; returns how many pods were displaced, or
        None when the action was CANCELLED. Completes with the finalizer-
        path delete once nothing replaceable remains."""
        pods = [
            p
            for p in self.cluster.list_pods(node_name=node.name)
            if p.survives_node_drain()
        ]
        if any(
            wellknown.DO_NOT_EVICT_ANNOTATION in p.annotations for p in pods
        ):
            # A protection appeared after nomination: drift replacement is
            # voluntary, so the action is cancelled, not escalated. The node
            # stays drifted and re-nominates once the protection lifts.
            self._cancel(node)
            return None
        self.termination.terminator.cordon(node)
        displaced = 0
        for pod in pods:
            try:
                live = self.cluster.reschedule_pod(pod.namespace, pod.name)
            except PDBViolationError:
                continue  # budget spent: the drain rolls, one sweep at a time
            if live is None:
                continue  # vanished under us
            displaced += 1
            crashpoint("drift.mid-replace")
            # Replacement ahead of the drain: the displaced pod goes straight
            # to the owning provisioner's batch window, so fresh capacity —
            # carrying the CURRENT spec hash — is launching while the rest of
            # the victim drains.
            self._feed(node, live)
        remaining = [
            p
            for p in self.cluster.list_pods(node_name=node.name)
            if p.survives_node_drain()
        ]
        if not remaining:
            self._complete(node)
        return displaced

    def _complete(self, node: NodeSpec) -> None:
        crashpoint("drift.before-delete")
        kind = node.annotations.get(
            wellknown.DRIFT_ACTION_ANNOTATION, driftlib.DRIFT_KIND_SPEC
        )
        DRIFT_REPLACEMENTS_TOTAL.inc(kind, "executed")
        self.cluster.delete_node(node.name)
        self.log.info("drifted node %s drained; deleting (%s)", node.name, kind)

    def _cancel(self, node: NodeSpec) -> None:
        kind = node.annotations.get(
            wellknown.DRIFT_ACTION_ANNOTATION, driftlib.DRIFT_KIND_SPEC
        )
        # The dedicated removal verb: a plain update_node merge-patch cannot
        # delete the key on the apiserver backend, and a resurrected claim
        # would consume the disruption budget forever.
        self.cluster.remove_node_annotation(
            node, wellknown.DRIFT_ACTION_ANNOTATION
        )
        if (
            node.deletion_timestamp is None
            and wellknown.INTERRUPTION_KIND_ANNOTATION not in node.annotations
        ):
            node.unschedulable = False  # undo our cordon
        self.cluster.update_node(node)
        DRIFT_REPLACEMENTS_TOTAL.inc(kind, "cancelled")
        self.log.warning(
            "drift replacement of %s cancelled: a do-not-evict pod appeared "
            "mid-drain (voluntary disruption never overrides protections)",
            node.name,
        )

    def _feed(self, node: NodeSpec, pod) -> None:
        name = node.labels.get(wellknown.PROVISIONER_NAME_LABEL, "")
        worker = self.provisioning.worker(name)
        if worker is not None:
            worker.add(pod)
