"""The port stands alone: karpenter_tpu_torch imports neither JAX nor the
reference package, and chip_smoke.py refuses to run without a card or
without the repository beside it."""

import ast
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

import karpenter_tpu_torch

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
PACKAGE = Path(karpenter_tpu_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "optax", "karpenter_tpu")
PORT_FILES = sorted(PACKAGE.rglob("*.py"))


def _module_names():
    return [
        ".".join(path.relative_to(PACKAGE.parent).with_suffix("").parts).removesuffix(".__init__")
        for path in PORT_FILES
    ]


def _forbidden_imports(source: str):
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            if name.split(".")[0] in FORBIDDEN:
                found.append(name)
    return found


# chip_smoke.py and the card tests run where JAX is not installed.
@pytest.mark.parametrize(
    "path",
    PORT_FILES + [REPO / "chip_smoke.py", REPO / "tests" / "test_torch_cuda.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_no_forbidden_import(path):
    assert _forbidden_imports(path.read_text()) == []


def test_the_incremental_encode_modules_are_checked():
    """The blocked-import check below covers every module of the port; the
    incremental encode's among them."""
    names = _module_names()
    for name in ("karpenter_tpu_torch.ops.incremental", "karpenter_tpu_torch.models.cluster_state",
                 "karpenter_tpu_torch.utils.faultpoints"):
        assert name in names


def test_every_module_imports_with_jax_blocked():
    script = textwrap.dedent(
        f"""
        import importlib, sys

        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in {FORBIDDEN!r}:
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Refuse())
        for name in {_module_names()!r}:
            importlib.import_module(name)
        loaded = [m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r}]
        assert not loaded, loaded
        print("imported", len({_module_names()!r}))
        """
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    result = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert result.returncode == 0, result.stderr
    assert f"imported {len(PORT_FILES)}" in result.stdout


def _run_smoke(cwd: Path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=120,
    )


def test_chip_smoke_refuses_without_a_card():
    result = _run_smoke(REPO)
    assert result.returncode != 0
    assert '"ok"' not in result.stdout


def test_chip_smoke_refuses_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    result = _run_smoke(tmp_path)
    assert result.returncode != 0
    assert '"ok"' not in result.stdout
