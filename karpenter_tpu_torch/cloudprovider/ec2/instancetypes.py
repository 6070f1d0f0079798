"""Instance-type discovery: raw catalog → solver-ready InstanceTypes.

Ref: pkg/cloudprovider/aws/{instancetype.go,instancetypes.go} — adapts raw
instance-type records (VM memory factor, ENI pod formula, allocatable
overhead model) and assembles offerings as
(subnet zones ∩ offered zones) × usage classes, minus the
insufficient-capacity blackout cache, all behind a 5-minute catalog cache.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set, Tuple

from karpenter_tpu_torch.api import wellknown
from karpenter_tpu_torch.cloudprovider import ARCH_AMD64, ARCH_ARM64, InstanceType, Offering
from karpenter_tpu_torch.cloudprovider.ec2.api import Ec2Api, InstanceTypeInfo
from karpenter_tpu_torch.cloudprovider.ec2.network import SubnetProvider
from karpenter_tpu_torch.cloudprovider.ec2.vendor import Ec2Provider
from karpenter_tpu_torch.utils.cache import TtlCache
from karpenter_tpu_torch.utils.clock import Clock, SYSTEM_CLOCK

# The VM consumes <7.5% of machine memory (ref: instancetype.go:31-32).
VM_AVAILABLE_MEMORY_FACTOR = 0.925

CATALOG_CACHE_TTL = 5 * 60.0  # ref: instancetypes.go:36
ICE_BLACKOUT_TTL = 45.0  # ref: instancetypes.go:37

_ARCH_MAP = {"x86_64": ARCH_AMD64, "arm64": ARCH_ARM64}

# Families useful for Kubernetes (ref: instancetypes.go filter:157-170):
# standard (m,c,r,a), burstable (t3,t4), accelerators (p,inf,g).
_USEFUL_PREFIXES = ("m", "c", "r", "a", "t3", "t4", "p", "inf", "g")


def pods_per_node(info: InstanceTypeInfo) -> int:
    """ENI formula: max ENIs × (IPv4 addrs per ENI − 1) + 2
    (ref: instancetype.go:72-77)."""
    return info.max_network_interfaces * (info.ipv4_addresses_per_interface - 1) + 2


def kube_reserved_cpu_millis(vcpus: int) -> int:
    """Piecewise kube-reserved CPU (ref: instancetype.go Overhead:140-157,
    the Bottlerocket formula): 6% of the first core, 1% of the second,
    0.5% of cores 3-4, 0.25% of the rest — plus 100m system-reserved."""
    millis = vcpus * 1000
    reserved = 100.0  # system-reserved
    for start, end, percentage in (
        (0, 1000, 0.06),
        (1000, 2000, 0.01),
        (2000, 4000, 0.005),
        (4000, 1 << 31, 0.0025),
    ):
        if millis >= start:
            covered = min(millis, end) - start
            reserved += covered * percentage
    return int(reserved)


def overhead_for(info: InstanceTypeInfo) -> Dict[str, str]:
    """Allocatable overhead: kube-reserved + system-reserved + eviction
    threshold (ref: instancetype.go Overhead:124-159)."""
    pods = pods_per_node(info)
    memory_mib = (11 * pods + 255) + 100 + 100
    return {
        "cpu": f"{kube_reserved_cpu_millis(info.vcpus)}m",
        "memory": f"{memory_mib}Mi",
    }


def adapt_instance_type(
    info: InstanceTypeInfo, offerings: List[Offering]
) -> InstanceType:
    """Raw record → solver InstanceType with allocatable-view capacity."""
    capacity = {
        wellknown.RESOURCE_CPU: info.vcpus,
        wellknown.RESOURCE_MEMORY: f"{int(info.memory_mib * VM_AVAILABLE_MEMORY_FACTOR)}Mi",
        wellknown.RESOURCE_PODS: pods_per_node(info),
    }
    if info.nvidia_gpus:
        capacity[wellknown.RESOURCE_NVIDIA_GPU] = info.nvidia_gpus
    if info.amd_gpus:
        capacity[wellknown.RESOURCE_AMD_GPU] = info.amd_gpus
    if info.neurons:
        capacity[wellknown.RESOURCE_AWS_NEURON] = info.neurons
    if info.tpus:
        capacity[wellknown.RESOURCE_GOOGLE_TPU] = info.tpus
    if info.pod_eni_branch_interfaces:
        capacity[wellknown.RESOURCE_AWS_POD_ENI] = info.pod_eni_branch_interfaces
    architecture = ARCH_AMD64
    for raw_arch in info.architectures:
        if raw_arch in _ARCH_MAP:
            architecture = _ARCH_MAP[raw_arch]
            break
    return InstanceType(
        name=info.name,
        capacity=capacity,
        overhead=overhead_for(info),
        architecture=architecture,
        offerings=offerings,
    )


def useful_for_kubernetes(info: InstanceTypeInfo) -> bool:
    """Opinionated filter (ref: instancetypes.go filter:157-170)."""
    if info.fpga or info.bare_metal:
        return False
    if "hvm" not in info.supported_virtualization_types:
        return False
    return info.name.startswith(_USEFUL_PREFIXES)


class InstanceTypeProvider:
    """Ref: aws/instancetypes.go InstanceTypeProvider:41-104."""

    def __init__(
        self,
        api: Ec2Api,
        subnet_provider: SubnetProvider,
        clock: Optional[Clock] = None,
    ):
        clock = clock or SYSTEM_CLOCK
        self.api = api
        self.subnet_provider = subnet_provider
        # Catalog cached *before* ICE filtering so blackouts apply instantly
        # (ref: instancetypes.go:44-46).
        self._cache = TtlCache(CATALOG_CACHE_TTL, clock)
        self._unavailable = TtlCache(ICE_BLACKOUT_TTL, clock)
        # The controller's PriceBook (attach_market): advertised spot prices
        # track its folded market; ICE-closed pools drop their spot
        # offering. Plain slot, GIL-atomic swap at boot.
        self._market_book = None
        self._lock = threading.Lock()

    def attach_market(self, book) -> None:
        self._market_book = book

    def get(self, provider: Ec2Provider) -> List[InstanceType]:
        """All instance types purchasable in the provider's subnet zones,
        with per-offering prices, minus blacked-out pools
        (ref: instancetypes.go Get:61-104)."""
        infos = self._get_infos()
        offerings_by_type = self._get_offerings()
        subnet_zones = {
            subnet.zone for subnet in self.subnet_provider.get(provider)
        }
        # One on-demand anchor map per get(), not per offering: with a
        # book attached every spot offering reprices against it, and
        # rebuilding it inside the loop would make the catalog quadratic
        # in offerings.
        od_prices = (
            self.on_demand_prices() if self._market_book is not None else {}
        )
        result = []
        for info in infos.values():
            offerings = []
            for offering in offerings_by_type.get(info.name, []):
                if offering.zone not in subnet_zones:
                    continue
                if offering.capacity_type not in info.supported_usage_classes:
                    continue
                if self.is_unavailable(
                    info.name, offering.zone, offering.capacity_type
                ):
                    continue
                priced = self._market_priced(info.name, offering, od_prices)
                if priced is not None:
                    offerings.append(priced)
            if offerings:
                result.append(adapt_instance_type(info, offerings))
        return result

    def _market_priced(self, name: str, offering, od_prices) -> Optional[Offering]:
        """One offering under the attached PriceBook, priced by the SHARED
        rule (market.pricebook.advertised_price — the fake provider calls
        the same function, so the backends cannot drift): spot follows the
        folded market (on-demand anchor x live discount), ICE-closed pools
        vanish, anything unpriced keeps the wire/catalog price."""
        from karpenter_tpu_torch.market.pricebook import advertised_price

        pool = (name, offering.zone)
        price = advertised_price(
            self._market_book,
            pool,
            offering.capacity_type,
            offering.price,
            od_prices.get(pool),
        )
        if price is None:
            return None
        return Offering(
            zone=offering.zone, capacity_type=offering.capacity_type, price=price
        )

    def on_demand_prices(self) -> Dict[tuple, float]:
        """{(type, zone): on-demand $/hr} from the cached offering listing —
        the anchor spot discounts are computed against."""
        out: Dict[tuple, float] = {}
        for name, offerings in self._get_offerings().items():
            for offering in offerings:
                if offering.capacity_type == "on-demand":
                    out[(name, offering.zone)] = offering.price
        return out

    def _get_infos(self) -> Dict[str, InstanceTypeInfo]:
        with self._lock:
            cached = self._cache.get("types")
            if cached is not None:
                return cached
            infos = {
                info.name: info
                for info in self.api.describe_instance_types()
                if useful_for_kubernetes(info)
            }
            self._cache.set("types", infos)
            return infos

    def _get_offerings(self):
        with self._lock:
            cached = self._cache.get("offerings")
            if cached is not None:
                return cached
            by_type: Dict[str, list] = {}
            for offering in self.api.describe_instance_type_offerings():
                by_type.setdefault(offering.instance_type, []).append(offering)
            self._cache.set("offerings", by_type)
            return by_type

    # --- ICE blackout (ref: instancetypes.go CacheUnavailable:174-187) -----

    def cache_unavailable(
        self, instance_type: str, zone: str, capacity_type: str
    ) -> None:
        """Record a temporary capacity shortage; the offering disappears from
        get() for ICE_BLACKOUT_TTL so retries pick another pool."""
        self._unavailable.set((capacity_type, instance_type, zone))

    def is_unavailable(
        self, instance_type: str, zone: str, capacity_type: str
    ) -> bool:
        return (capacity_type, instance_type, zone) in self._unavailable
