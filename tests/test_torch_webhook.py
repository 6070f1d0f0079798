"""The port's admission webhook (cmd/webhook) and its serving certificates
(utils/certs) under the reference's own suites, and against the
reference's webhook, on the CPU.

tests/test_webhook_certs.py and the webhook classes of tests/test_runtime.py
(TestAdmissionReview, TestWebhook) run here a second time over the port
(tests/port_twins.py). Those files bind fixed ports; their twins bind
others (PORTS), since the test workers run both files at once. Then the
same provisioner JSON, as an AdmissionReview and as plain JSON, goes to
both packages' webhooks, each on a port the system picked: the answers
(the verdict, the reason, the base64 JSONPatch) must be equal.
"""

import ast
import base64
import json
import urllib.error
import urllib.request

import pytest
import torch

from karpenter_tpu.api import provisioner as ref_provisioner
from karpenter_tpu.api.serialization import provisioner_to_dict as ref_to_dict
from karpenter_tpu.cmd import webhook as ref_webhook
from karpenter_tpu_torch.api import provisioner as port_provisioner
from karpenter_tpu_torch.api.serialization import provisioner_to_dict as port_to_dict
from karpenter_tpu_torch.cmd import webhook as port_webhook
from tests import port_twins

torch.set_num_threads(2)

# The reference's fixed ports -> the twins' own.
PORTS = {18443: 18643, 18445: 18645, 18446: 18646, 18447: 18647}
_TWINS = port_twins.TwinPackage(
    "port", "webhook", [(rf"\b{old}\b", str(new)) for old, new in PORTS.items()]
)
CERTS = _TWINS.module("test_webhook_certs")
CERT_CLASSES = port_twins.expose(CERTS, globals())
RUNTIME = _TWINS.module("test_runtime")
TestAdmissionReview = RUNTIME.TestAdmissionReview
TestWebhook = RUNTIME.TestWebhook


@pytest.fixture(autouse=True)
def _port_state():
    port_twins.reset_port_state()
    yield
    port_twins.reset_port_state()


def test_every_reference_class_runs_on_the_port():
    tree = ast.parse((port_twins.TESTS / "test_webhook_certs.py").read_text())
    assert set(CERT_CLASSES) == {node.name for node in tree.body
                                 if isinstance(node, ast.ClassDef) and node.name.startswith("Test")}
    assert CERTS.CertManager.__module__ == "karpenter_tpu_torch.utils.certs"
    source = "".join((port_twins.TESTS / f"{stem}.py").read_text()
                     for stem in ("test_runtime", "test_webhook_certs"))
    for old, new in PORTS.items():
        assert str(old) in source and str(new) not in source


# --- the two packages' webhooks on the same provisioners -----------------------


def _provisioners(provisioner_mod):
    """Provisioners to admit, as each package builds them: the plain one
    (defaulting adds the capacity-type requirement), one whose name is too
    long (rejected), and one with an emptiness TTL."""
    Provisioner, ProvisionerSpec = provisioner_mod.Provisioner, provisioner_mod.ProvisionerSpec
    return {
        "plain": Provisioner(name="default", spec=ProvisionerSpec()),
        "long-name": Provisioner(name="x" * 80, spec=ProvisionerSpec()),
        "ttl": Provisioner(name="ttl", spec=ProvisionerSpec(ttl_seconds_after_empty=30)),
    }


def _serve(webhook_mod):
    server = webhook_mod.main(["--cluster-name", "test"], port=0, block=False)
    return server, f"http://127.0.0.1:{server.server_address[1]}"


def _post(url, payload):
    request = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST")
    try:
        with urllib.request.urlopen(request, timeout=10) as response:
            return response.status, json.loads(response.read())
    except urllib.error.HTTPError as error:
        return error.code, json.loads(error.read())


def _answers(webhook_mod, provisioner_mod, to_dict):
    server, base = _serve(webhook_mod)
    try:
        out = {}
        for name, provisioner in _provisioners(provisioner_mod).items():
            obj = to_dict(provisioner)
            # Each package numbers the uids it mints: name one.
            obj["metadata"]["uid"] = f"uid-{name}"
            review = {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
                      "request": {"uid": f"uid-{name}", "object": obj}}
            for path in ("default", "validate"):
                out[(name, path, "review")] = _post(f"{base}/{path}", review)
                out[(name, path, "plain")] = _post(f"{base}/{path}", obj)
        return out
    finally:
        server.shutdown()


def test_the_port_admits_as_the_reference():
    want = _answers(ref_webhook, ref_provisioner, ref_to_dict)
    port_twins.reset_port_state()
    got = _answers(port_webhook, port_provisioner, port_to_dict)
    assert got == want
    status, review = got[("plain", "default", "review")]
    assert status == 200 and review["response"]["patchType"] == "JSONPatch"
    ops = json.loads(base64.b64decode(review["response"]["patch"]))
    assert {r["key"] for r in ops[0]["value"]["requirements"]} >= {"karpenter.sh/capacity-type"}
    assert got[("long-name", "validate", "review")][1]["response"]["allowed"] is False
    assert got[("long-name", "validate", "plain")][0] == 422
