"""Resource quantities and ResourceList arithmetic.

Ref: pkg/utils/resources/resources.go — the reference leans on k8s
resource.Quantity; we implement the subset of quantity syntax the provisioning
path actually exercises (decimal + binary SI suffixes, millicores) on plain
floats, plus merge/sum/fit predicates over dict-shaped resource lists.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Mapping, Union

# A parsed quantity is a float in base units (cores for cpu, bytes for memory,
# counts otherwise).
Quantity = float

# "cpu": 1.5, "memory": 2 * 1024**3, ...
ResourceList = Dict[str, Quantity]

_BINARY_SUFFIX = {
    "Ki": 1024.0,
    "Mi": 1024.0**2,
    "Gi": 1024.0**3,
    "Ti": 1024.0**4,
    "Pi": 1024.0**5,
    "Ei": 1024.0**6,
}
_DECIMAL_SUFFIX = {
    "n": 1e-9,
    "u": 1e-6,
    "m": 1e-3,
    "": 1.0,
    "k": 1e3,
    "M": 1e6,
    "G": 1e9,
    "T": 1e12,
    "P": 1e15,
    "E": 1e18,
}

_QUANTITY_RE = re.compile(
    r"^\s*([+-]?[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?)\s*"
    r"(Ki|Mi|Gi|Ti|Pi|Ei|n|u|m|k|M|G|T|P|E)?\s*$"
)


def parse_quantity(value: Union[str, int, float]) -> Quantity:
    """Parse a k8s-style quantity ("100m", "512Mi", "2", 1.5) into a float."""
    if isinstance(value, (int, float)):
        return float(value)
    match = _QUANTITY_RE.match(value)
    if match is None:
        raise ValueError(f"invalid quantity {value!r}")
    number, suffix = match.groups()
    scale = _BINARY_SUFFIX.get(suffix or "", None)
    if scale is None:
        scale = _DECIMAL_SUFFIX[suffix or ""]
    return float(number) * scale


def parse_resource_list(raw: Mapping[str, Union[str, int, float]]) -> ResourceList:
    return {key: parse_quantity(value) for key, value in raw.items()}


def add_resources(*lists: Mapping[str, Quantity]) -> ResourceList:
    """Union of resource lists, summing overlapping keys (ref: resources.go Merge)."""
    out: ResourceList = {}
    for rl in lists:
        for key, value in rl.items():
            out[key] = out.get(key, 0.0) + value
    return out


def subtract_resources(
    a: Mapping[str, Quantity], b: Mapping[str, Quantity]
) -> ResourceList:
    out: ResourceList = dict(a)
    for key, value in b.items():
        out[key] = out.get(key, 0.0) - value
    return out


def scale_resources(a: Mapping[str, Quantity], factor: float) -> ResourceList:
    return {key: value * factor for key, value in a.items()}


def fits_within(request: Mapping[str, Quantity], capacity: Mapping[str, Quantity]) -> bool:
    """True iff every requested resource is available in capacity."""
    for key, value in request.items():
        if value <= 0:
            continue
        if capacity.get(key, 0.0) < value:
            return False
    return True


def max_resources(*lists: Mapping[str, Quantity]) -> ResourceList:
    """Per-key maximum — used for pod effective request = max(init, containers)."""
    out: ResourceList = {}
    for rl in lists:
        for key, value in rl.items():
            out[key] = max(out.get(key, 0.0), value)
    return out


def sum_requests(requests: Iterable[Mapping[str, Quantity]]) -> ResourceList:
    return add_resources(*list(requests))


def nonzero(rl: Mapping[str, Quantity]) -> ResourceList:
    return {key: value for key, value in rl.items() if value > 0}
