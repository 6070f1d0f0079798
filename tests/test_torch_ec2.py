"""The port's EC2 cloud provider under the reference's own suite, on the CPU.

tests/test_ec2.py runs here a second time with every `karpenter_tpu` name
pointed at `karpenter_tpu_torch` (tests/port_twins.py): the vendor hooks,
instance-type adaptation, discovery, launch templates, fleet launches, ICE
blackouts, termination, the registry, a provisioning pass end to end, the
pool-pinned launch, the crash-consistent launch, the interruption feed and
the market poll, all over `FakeEc2`. The reference's file runs the same
cases on the JAX package's provider.
"""

import pytest
import torch

from tests import port_twins

torch.set_num_threads(2)

SUITE = port_twins.TwinPackage("port", "ec2").module("test_ec2")
CLASSES = port_twins.expose(SUITE, globals())


@pytest.fixture(autouse=True)
def _port_state():
    port_twins.reset_port_state()
    yield
    port_twins.reset_port_state()


def test_every_reference_class_runs_on_the_port():
    import ast

    tree = ast.parse((port_twins.TESTS / "test_ec2.py").read_text())
    assert set(CLASSES) == {node.name for node in tree.body
                            if isinstance(node, ast.ClassDef) and node.name.startswith("Test")}
    assert SUITE.Ec2CloudProvider.__module__ == "karpenter_tpu_torch.cloudprovider.ec2"


def test_the_registry_builds_the_ec2_provider():
    from karpenter_tpu_torch.cloudprovider import registry
    from karpenter_tpu_torch.cloudprovider.ec2 import Ec2CloudProvider
    from karpenter_tpu_torch.cloudprovider.ec2.fake import FakeEc2

    try:
        provider = registry.new_cloud_provider("ec2")
        assert isinstance(provider, Ec2CloudProvider) and isinstance(provider.api, FakeEc2)
        assert registry.active() is provider
    finally:
        registry.new_cloud_provider("fake")
