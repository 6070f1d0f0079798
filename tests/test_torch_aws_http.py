"""The port's AWS wire layer (cloudprovider/ec2/aws_http.py) under the
reference's own suite, on the CPU.

tests/test_aws_http.py runs here a second time with every `karpenter_tpu`
name pointed at `karpenter_tpu_torch` (tests/port_twins.py): SigV4, the EC2
Query encoding, pagination, error mapping, the SQS interruption queue,
retries, the wire fake's round trip, the whole EC2 provider suite over
signed bytes (its own twin of tests/test_ec2.py, through the suite's
autouse `_wire_backend`), urllib over real sockets and restart idempotency.
The reference's file runs the same cases on the JAX package's layer.
"""

import pytest
import torch

from tests import port_twins

torch.set_num_threads(2)

SUITE = port_twins.TwinPackage("port", "aws_http").module("test_aws_http")
CLASSES = port_twins.expose(SUITE, globals())


@pytest.fixture(autouse=True)
def _port_state():
    port_twins.reset_port_state()
    yield
    port_twins.reset_port_state()


def test_every_reference_class_runs_on_the_port():
    import ast

    tree = ast.parse((port_twins.TESTS / "test_aws_http.py").read_text())
    assert set(CLASSES) == {node.name for node in tree.body
                            if isinstance(node, ast.ClassDef) and node.name.startswith("Test")}
    assert SUITE.AwsHttpEc2Api.__module__ == "karpenter_tpu_torch.cloudprovider.ec2.aws_http"
    assert SUITE._suite.make_api.__module__.startswith("_twin_aws_http_port")
