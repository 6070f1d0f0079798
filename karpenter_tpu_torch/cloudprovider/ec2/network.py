"""Subnet and security-group discovery by tag selector.

Ref: pkg/cloudprovider/aws/{subnets.go,securitygroups.go} — tag-selector
lookup ("*" value = key existence), cached; security groups keep at most one
cluster-tagged group (the load-balancer-controller workaround,
securitygroups.go:44-66).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from karpenter_tpu_torch.cloudprovider.ec2.api import (
    SETUP_CACHE_TTL,
    Ec2Api,
    SecurityGroup,
    Subnet,
)
from karpenter_tpu_torch.cloudprovider.ec2.vendor import (
    CLUSTER_TAG_KEY_FORMAT,
    Ec2Provider,
)
from karpenter_tpu_torch.utils.cache import TtlCache
from karpenter_tpu_torch.utils.clock import Clock, SYSTEM_CLOCK

class NoMatchError(Exception):
    """Selector matched nothing (ref: subnets.go:43-45, securitygroups.go:47)."""


def _selector_key(selector: Dict[str, str]) -> Tuple:
    return tuple(sorted(selector.items()))


class SubnetProvider:
    """Ref: aws/subnets.go SubnetProvider:18-49."""

    def __init__(self, api: Ec2Api, clock: Optional[Clock] = None):
        self.api = api
        self._cache = TtlCache(SETUP_CACHE_TTL, clock or SYSTEM_CLOCK)
        self._lock = threading.Lock()

    def get(self, provider: Ec2Provider) -> List[Subnet]:
        selector = provider.subnet_selector or {}
        key = _selector_key(selector)
        with self._lock:
            cached = self._cache.get(key)
            if cached is not None:
                return cached
            subnets = self.api.describe_subnets(selector)
            if not subnets:
                raise NoMatchError(f"no subnets matched selector {selector}")
            self._cache.set(key, subnets)
            return subnets


class SecurityGroupProvider:
    """Ref: aws/securitygroups.go SecurityGroupProvider:19-99."""

    def __init__(
        self, api: Ec2Api, cluster_name: str, clock: Optional[Clock] = None
    ):
        self.api = api
        self.cluster_name = cluster_name
        self._cache = TtlCache(SETUP_CACHE_TTL, clock or SYSTEM_CLOCK)
        self._lock = threading.Lock()

    def get(self, provider: Ec2Provider) -> List[str]:
        selector = provider.security_group_selector or {}
        key = _selector_key(selector)
        with self._lock:
            cached = self._cache.get(key)
            if cached is None:
                cached = self.api.describe_security_groups(selector)
                self._cache.set(key, cached)
        groups = self._drop_extra_cluster_tagged(cached)
        if not groups:
            raise NoMatchError(f"no security groups matched selector {selector}")
        return [group.group_id for group in groups]

    def _drop_extra_cluster_tagged(
        self, groups: List[SecurityGroup]
    ) -> List[SecurityGroup]:
        """Keep at most one group carrying the cluster discovery tag
        (ref: securitygroups.go filterClusterTaggedGroups:44-66)."""
        cluster_tag = CLUSTER_TAG_KEY_FORMAT.format(self.cluster_name)
        kept, found = [], False
        for group in groups:
            if cluster_tag in group.tags:
                if found:
                    continue
                found = True
            kept.append(group)
        return kept
