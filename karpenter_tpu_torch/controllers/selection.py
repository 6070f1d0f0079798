"""Selection: route unschedulable pods to provisioners.

Ref: pkg/controllers/selection/{controller,preferences}.go — watches all pods
(MaxConcurrentReconciles 10,000 in the reference; our runtime fans out over a
thread pool), filters provisionable ones, rejects unsupported scheduling
features, and hands the pod to the first matching provisioner in alphabetical
order.

Preference relaxation no longer lives here: the reference re-ran the whole
schedule once per relaxation level across retries (preferences.go:64-106);
the constraint compiler now lowers the full ladder into the [L, G, T] kernel
dispatch (constraints/), which solves every level at once and picks the
strictest feasible one on device. The UID-keyed TTL cache survives as the
BOOKKEEPING layer: the provisioning worker records the kernel-chosen level
per pod after each constrained solve (Preferences.record), preserving the
reference's observability (which pods are running relaxed, at what level)
without the retry loop or its detached-copy re-solve.
"""

from __future__ import annotations

from typing import Optional, Tuple

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.api.pods import DO_NOT_SCHEDULE, PodSpec
from karpenter_tpu_torch.api.provisioner import PodIncompatibleError
from karpenter_tpu_torch.api.requirements import SUPPORTED_OPERATORS
from karpenter_tpu_torch.constraints import greedy_topology_enabled
from karpenter_tpu_torch.constraints.terms import term_topology_key
from karpenter_tpu_torch.controllers.cluster import Cluster
from karpenter_tpu_torch.controllers.provisioning import ProvisioningController
from karpenter_tpu_torch.controllers.scheduling import SUPPORTED_TOPOLOGY_KEYS
from karpenter_tpu_torch.utils.cache import TtlCache
from karpenter_tpu_torch.utils.clock import Clock
from karpenter_tpu_torch.utils.obs import OBS


class UnsupportedPodError(Exception):
    """The pod uses features the provisioning path doesn't support
    (ref: selection/controller.go validate:108-159)."""


class Preferences:
    """UID-keyed TTL cache of each pod's kernel-chosen relaxation level
    (ref: selection/preferences.go:40-106 — the reference stored the relaxed
    terms themselves and re-drove the solve; the kernel now solves every
    level in one dispatch, so this cache records the OUTCOME). The stored
    pod spec is never mutated. Entries expire on their own TTL, matching the
    reference's go-cache: a pod that stops being re-solved for five minutes
    simply ages out."""

    TTL_SECONDS = 300.0

    def __init__(self, clock: Optional[Clock] = None):
        self._cache = TtlCache(self.TTL_SECONDS, clock)

    def record(self, uid: str, level: int, description: str = "") -> None:
        """Record the level the [L, G, T] dispatch chose for this pod's
        schedule (called by the provisioning worker after each constrained
        solve). Level 0 = full preferences honored — recorded too, so
        `level()` distinguishes "solved strict" from "never solved"."""
        self._cache.set(uid, (int(level), description))

    def level(self, pod_or_uid) -> Optional[int]:
        uid = getattr(pod_or_uid, "uid", pod_or_uid)
        entry: Optional[Tuple[int, str]] = self._cache.get(uid)
        return None if entry is None else entry[0]

    def describe(self, pod_or_uid) -> Optional[str]:
        uid = getattr(pod_or_uid, "uid", pod_or_uid)
        entry: Optional[Tuple[int, str]] = self._cache.get(uid)
        return None if entry is None else entry[1]

    def forget(self, uid: str) -> None:
        self._cache.delete(uid)


class SelectionController:
    """Ref: selection/controller.go:55-102."""

    # Re-verify cadence for pods a worker has ACCEPTED (batched or in its
    # overflow backlog): the worker owns delivery from here and watch events
    # still pull the key forward immediately, so the safety re-verify can be
    # slow — at 1 Hz a 50k-pod backlog burns the GIL on no-op reconciles
    # (measured: ~15s of queue mechanics per 2000-pod batch).
    ACCEPTED_REQUEUE_SECONDS = 5.0
    # Exponential backoff for pods no provisioner matches, mirroring
    # workqueue.DefaultControllerRateLimiter (5ms→1000s) that the reference
    # gets for free when it returns the match error. Our reconcile loop tick
    # floors the base at 1s; the cap matches the reference's 1000s.
    BACKOFF_BASE_SECONDS = 1.0
    BACKOFF_MAX_SECONDS = 1000.0
    # Backoff cap for pods REFUSED at a full provisioning queue
    # (--provision-queue-max-pods): unlike a no-match, the queue drains at
    # batch cadence, so the retry ceiling stays tight — the pod keeps aging
    # on its lifecycle anchor and re-enters the worker's aging-ordered
    # refill as soon as admission reopens.
    REFUSED_BACKOFF_MAX_SECONDS = 30.0

    def __init__(self, cluster: Cluster, provisioning: ProvisioningController):
        self.cluster = cluster
        self.provisioning = provisioning
        self.preferences = Preferences(cluster.clock)
        # The provisioning workers report each constrained solve's chosen
        # relaxation level back through this hook — selection owns the
        # bookkeeping cache, provisioning owns the solve.
        provisioning.level_recorder = self.preferences.record
        # UID → consecutive no-match failures; entries expire on their own so
        # deleted pods don't leak state.
        self._failures = TtlCache(2 * self.BACKOFF_MAX_SECONDS, cluster.clock)

    def reconcile(self, namespace: str, name: str) -> Optional[float]:
        pod = self.cluster.try_get_pod(namespace, name)
        if pod is None or not pod.is_provisionable():
            return None
        # Lifecycle anchor for harness-driven paths (the Manager path also
        # anchors from the watch-delta feed; first sight wins in both).
        OBS.first_seen(pod)
        try:
            self._validate(pod)
        except UnsupportedPodError:
            return None  # ignored; kube-scheduler owns it (ref: :70-75)

        # Hand the STORED pod over untouched: the scheduler compiles its
        # full relaxation ladder into the solve, so there is no relaxed copy
        # to fabricate here (the old detached-copy re-solve loop is gone).
        outcome = self._select_and_enqueue(pod)
        if outcome == "accepted":
            self._failures.delete(pod.uid)
            return self.ACCEPTED_REQUEUE_SECONDS
        # No provisioner matched, or the matching worker's admission queue
        # is full. The retry happens anyway — the reference returns the
        # match error so controller-runtime keeps requeueing
        # (selectProvisioner:80-102), which is what heals a pod whose
        # provisioner appears (or widens) later — but with exponential
        # backoff, so a permanently-unschedulable pod isn't polled at 1 Hz
        # forever. (Relaxation cannot help a no-match: every ladder level is
        # already solved inside the kernel dispatch once a worker accepts.)
        failures = self._failures.get(pod.uid) or 0
        self._failures.set(pod.uid, failures + 1)
        # min() on the exponent too: the counter keeps growing for a pod
        # that never schedules, and 2.0**1024 overflows.
        cap = (
            self.REFUSED_BACKOFF_MAX_SECONDS
            if outcome == "refused"
            else self.BACKOFF_MAX_SECONDS
        )
        return min(self.BACKOFF_BASE_SECONDS * (2.0 ** min(failures, 16)), cap)

    def _validate(self, pod: PodSpec) -> None:
        greedy = greedy_topology_enabled()
        SelectionController._validate_affinity(pod, greedy)
        if pod.match_fields_terms:
            raise UnsupportedPodError("node affinity matchFields is not supported")
        if greedy:
            for constraint in pod.topology_spread:
                if constraint.topology_key not in SUPPORTED_TOPOLOGY_KEYS:
                    raise UnsupportedPodError(
                        f"topology key {constraint.topology_key!r} is not supported"
                    )
        for terms in [
            *[term.requirements for term in pod.preferred_terms],
            *pod.required_terms,
        ]:
            for requirement in terms:
                if requirement.operator not in SUPPORTED_OPERATORS:
                    raise UnsupportedPodError(
                        f"operator {requirement.operator!r} is not supported"
                    )

    @staticmethod
    def _validate_affinity(pod: PodSpec, greedy: bool) -> None:
        for term in pod.pod_affinity_terms:
            key = term_topology_key(term)
            if greedy or key == wellknown.HOSTNAME_LABEL:
                # Hostname affinity ("pack my pods onto one node") has no
                # sound lowering onto fresh nodes; the greedy oracle path
                # keeps the reference's blanket rejection.
                raise UnsupportedPodError("pod affinity on this key is not supported")
            if key != wellknown.ZONE_LABEL and not any(
                c.topology_key == key for c in pod.topology_spread
            ):
                # Affinity on a custom key needs that key's spread
                # constraint to give fresh nodes a domain (labels are
                # stamped at registration); without it the compiler has no
                # sound lowering and would silently drop the term.
                raise UnsupportedPodError(
                    f"pod affinity on key {key!r} requires a topology spread "
                    "constraint on the same key"
                )
        if greedy and pod.pod_anti_affinity_terms:
            raise UnsupportedPodError("pod anti-affinity is not supported")
        for term in pod.pod_anti_affinity_terms:
            key = term_topology_key(term)
            if key in (wellknown.HOSTNAME_LABEL, wellknown.ZONE_LABEL):
                continue
            if not any(
                c.topology_key == key
                and c.when_unsatisfiable == DO_NOT_SCHEDULE
                for c in pod.topology_spread
            ):
                # The compiler only lowers custom-key exclusions for the
                # domain-expanded (hard) spread key; accepting anything else
                # would silently drop the constraint (the reference rejects
                # these pods so kube-scheduler owns them).
                raise UnsupportedPodError(
                    f"pod anti-affinity on key {key!r} requires a "
                    "DoNotSchedule topology spread constraint on the same key"
                )

    def _select_and_enqueue(self, pod: PodSpec) -> str:
        """Highest-weight matching provisioner wins; alphabetical order
        breaks ties (ref: selectProvisioner:80-102, plus real Karpenter's
        `.spec.weight` preference). Outcomes: "accepted" (a worker holds the
        pod — batch window or overflow), "refused" (the matching worker's
        admission queue is at --provision-queue-max-pods; the pod stays on
        the requeue ladder and ages there), "no-match"."""
        ranked = sorted(
            self.cluster.list_provisioners(),
            key=lambda p: (-p.spec.weight, p.name),
        )
        for provisioner in ranked:
            if provisioner.deletion_timestamp is not None:
                continue
            worker = self.provisioning.worker(provisioner.name)
            if worker is None:
                continue
            try:
                # Validate against the worker's EFFECTIVE constraints (fleet
                # -refreshed requirements), matching the reference where
                # selection reads the provisioning controller's in-memory
                # provisioners (ref: selectProvisioner:80-102) — the stored
                # spec is pristine and intentionally wider.
                self._compatible(worker, pod)
            except PodIncompatibleError:
                continue
            # First match decides: a refusal here must NOT fall through to a
            # later (alphabetically lower-priority) provisioner — that would
            # flip placement priority under load and flap back after drain.
            return "accepted" if worker.add(pod) else "refused"
        return "no-match"

    @staticmethod
    def _compatible(worker, pod: PodSpec) -> None:
        """Raise PodIncompatibleError unless SOME relaxation level of the
        pod fits the worker's constraints — level 0 alone would wrongly
        bounce a pod whose impossible preference the kernel ladder will
        drop (the legacy path healed this across relax-retry rounds)."""
        constraints = worker.provisioner.spec.constraints
        try:
            constraints.validate_pod(pod)
            return
        except PodIncompatibleError:
            if not pod.preferred_terms and len(pod.required_terms) <= 1:
                raise
        from karpenter_tpu_torch.constraints.ladder import build_ladder
        from karpenter_tpu_torch.controllers.scheduling import Scheduler

        for state in build_ladder(pod).states[1:]:
            try:
                constraints.validate_pod(Scheduler._level_shadow(pod, state))
                return
            except PodIncompatibleError:
                continue
        raise PodIncompatibleError(
            f"pod {pod.namespace}/{pod.name} incompatible at every relaxation level"
        )
