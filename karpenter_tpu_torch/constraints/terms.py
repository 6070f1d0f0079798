"""Raw kube (anti-)affinity term helpers — jax-free, shared by the compiler
and the scheduler's signature builder (controllers/scheduling.py must stay
importable without pulling the kernel stack)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from karpenter_tpu_torch.api import wellknown


def node_domain(node, key: str) -> Optional[str]:
    """A node's domain value for one topology key — THE zone-vs-label
    fallback rule, shared by the compiler's domain discovery and the greedy
    oracle's Topology pass so the two can never diverge on what domain a
    node belongs to."""
    if key == wellknown.ZONE_LABEL:
        return node.zone or node.labels.get(key)
    return node.labels.get(key)


def term_topology_key(term: dict) -> str:
    return str(term.get("topologyKey") or term.get("topology_key") or "")


def term_match_labels(term: dict) -> Dict[str, str]:
    """Selector of a raw kube (anti-)affinity term dict; supports both the
    kube nesting ({"labelSelector": {"matchLabels": ...}}) and a flat
    {"matchLabels": ...}. Empty selector matches every pod."""
    selector = term.get("labelSelector") or {}
    labels = selector.get("matchLabels") or term.get("matchLabels") or {}
    return dict(labels)


def selector_matches(labels: Dict[str, str], pod_labels: Dict[str, str]) -> bool:
    return all(pod_labels.get(k) == v for k, v in labels.items())


def term_fingerprint(terms) -> Tuple:
    """Hashable identity of a term list — part of the compiled signature."""
    return tuple(
        sorted(
            (term_topology_key(t), tuple(sorted(term_match_labels(t).items())))
            for t in terms
        )
    )
