"""Cloud-provider registry.

Ref: pkg/cloudprovider/registry/register.go — the reference selects the
provider at compile time via build tags and installs its Default/Validate
hooks into the API package. We select at runtime (config/env) and do the same
hook installation.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from karpenter_tpu_torch.api import validation
from karpenter_tpu_torch.cloudprovider import CloudProvider

_factories: Dict[str, Callable[[], CloudProvider]] = {}
_active: Optional[CloudProvider] = None


def register_factory(name: str, factory: Callable[[], CloudProvider]) -> None:
    _factories[name] = factory


def new_cloud_provider(name: str = "fake") -> CloudProvider:
    """Instantiate and install API hooks (ref: register.go:24-37)."""
    global _active
    if name not in _factories:
        raise KeyError(f"unknown cloud provider {name!r}; known: {sorted(_factories)}")
    provider = _factories[name]()
    validation.DEFAULT_HOOK = provider.default
    validation.VALIDATE_HOOK = provider.validate
    _active = provider
    return provider


def active() -> Optional[CloudProvider]:
    return _active


def _register_builtins() -> None:
    from karpenter_tpu_torch.cloudprovider.fake import FakeCloudProvider

    register_factory("fake", FakeCloudProvider)

    def _ec2_factory():
        from karpenter_tpu_torch.cloudprovider.ec2 import Ec2CloudProvider

        return Ec2CloudProvider()

    register_factory("ec2", _ec2_factory)


_register_builtins()
