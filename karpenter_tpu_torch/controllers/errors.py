"""Control-plane error types."""


class PDBViolationError(Exception):
    """Eviction refused because it would violate a PodDisruptionBudget
    (ref: termination/eviction.go treats HTTP 429 as retryable)."""
