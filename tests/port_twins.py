"""Load the reference's own test modules a second time, over either package.

A twin of tests/<stem>.py is that file's source with every `from tests ...`
import pointed at a synthetic package of twins, and, for the port, every
`karpenter_tpu` name pointed at `karpenter_tpu_torch`. Its helpers (the
Harness, the fake apiserver, the fixtures, the wire fake) are twins too, so
a twin suite over the port never reaches the reference through them.

    port = TwinPackage("port", "kubeapi")
    suite = port.module("test_apiserver_cluster")

Twins are imported on first use: a twin module's own `from tests import x`
loads the twin of x in the same synthetic package.
"""

from __future__ import annotations

import importlib
import importlib.abc
import importlib.machinery
import re
import sys
from pathlib import Path

TESTS = Path(__file__).resolve().parent
PACKAGES = ("reference", "port")


def twin_source(path: Path, package: str, prefix: str) -> str:
    """tests/<stem>.py as the twin in `prefix` over `package` reads it."""
    text = path.read_text()
    if package == "port":
        text = re.sub(r"\bkarpenter_tpu\b", "karpenter_tpu_torch", text)
    text = re.sub(r"\bfrom tests import\b", f"from {prefix} import", text)
    return re.sub(r"\bfrom tests\.(\w+) import\b", rf"from {prefix}.\1 import", text)


class _TwinLoader(importlib.abc.Loader):
    def __init__(self, package: str, prefix: str, path: Path | None, substitutions=()):
        self.package, self.prefix, self.path = package, prefix, path
        self.substitutions = substitutions

    def create_module(self, spec):
        return None

    def exec_module(self, module):
        if self.path is None:  # the synthetic package itself
            module.__path__ = []
            return
        module.__file__ = str(self.path)
        source = twin_source(self.path, self.package, self.prefix)
        for pattern, replacement in self.substitutions:
            source = re.sub(pattern, replacement, source)
        exec(compile(source, str(self.path), "exec"), module.__dict__)


class _TwinFinder(importlib.abc.MetaPathFinder):
    """Finds the twins of every registered synthetic package."""

    prefixes: dict = {}

    def find_spec(self, fullname, path=None, target=None):
        head, _, stem = fullname.partition(".")
        registered = self.prefixes.get(head)
        if registered is None or "." in stem:
            return None
        package, substitutions = registered
        source = TESTS / f"{stem}.py" if stem else None
        if source is not None and not source.exists():
            return None
        loader = _TwinLoader(package, head, source, substitutions)
        return importlib.machinery.ModuleSpec(fullname, loader, is_package=not stem)


_FINDER = _TwinFinder()


class TwinPackage:
    """The twins of tests/ over one package, under `_twin_<name>_<package>`.
    `substitutions`, (regex, replacement) pairs, are applied to every twin's
    source after the imports are pointed (say, a fixed port the reference's
    file binds, which its twin in another test worker must not share)."""

    def __init__(self, package: str, name: str, substitutions=()):
        assert package in PACKAGES, package
        self.package = package
        self.prefix = f"_twin_{name}_{package}"
        _FINDER.prefixes[self.prefix] = (package, tuple(substitutions))
        if _FINDER not in sys.meta_path:
            sys.meta_path.insert(0, _FINDER)
        importlib.import_module(self.prefix)

    def module(self, stem: str):
        return importlib.import_module(f"{self.prefix}.{stem}")

    @property
    def base(self) -> str:
        """The package's import name."""
        return "karpenter_tpu_torch" if self.package == "port" else "karpenter_tpu"

    def library(self, name: str):
        """A module of the package, by its dotted name under the package."""
        return importlib.import_module(f"{self.base}.{name}")


def _is_fixture(value) -> bool:
    return type(value).__name__ == "FixtureFunctionDefinition" or hasattr(
        value, "_pytestfixturefunction"
    )


def expose(module, namespace: dict) -> list:
    """Put a twin module's test classes and its module-level fixtures into a
    collecting test file's namespace, so pytest collects them there.
    Returns the class names."""
    names = []
    for name, value in vars(module).items():
        if _is_fixture(value):
            namespace[name] = value
        elif isinstance(value, type) and name.startswith("Test"):
            namespace[name] = value
            names.append(name)
    return names


def reset_port_state() -> None:
    """The port's process-global state that tests/conftest.py resets for the
    reference only (armed crashpoints and faultpoints, the active PriceBook),
    and the provider hooks a registry call installs, back to none."""
    from karpenter_tpu_torch.api import validation
    from karpenter_tpu_torch.market.pricebook import set_active_book
    from karpenter_tpu_torch.utils import crashpoints, faultpoints

    crashpoints.disarm_all()
    faultpoints.disarm_all()
    set_active_book(None)
    validation.DEFAULT_HOOK = None
    validation.VALIDATE_HOOK = None


# The port's modules that bind resolve_device at import; the others look it
# up in karpenter_tpu_torch.device at the call.
_RESOLVERS = (
    "device", "models.solver", "models.cluster_state", "ops.consolidate", "ops.score_kernel",
)


def cpu_by_default(monkeypatch) -> None:
    """Run the port's entry points on the CPU where a reference test, which
    names no device, builds them: a device of None resolves to "cpu" for the
    test's duration. The caller asks for the CPU, as every port test does;
    the modules' own default (the card) is untouched."""
    from karpenter_tpu_torch import device as device_module

    resolve = device_module.resolve_device

    def on_the_cpu(device=None):
        return resolve("cpu" if device is None else device)

    for name in _RESOLVERS:
        module = importlib.import_module(f"karpenter_tpu_torch.{name}")
        monkeypatch.setattr(module, "resolve_device", on_the_cpu)
