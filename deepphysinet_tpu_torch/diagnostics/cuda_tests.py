"""Run the port's card tests, the nine ``cuda``-marked tests of ``tests/test_torch_port_*.py``, on a
machine with a card and without JAX.

Those test files compare the port with the JAX package on the CPU, so they load JAX and the JAX
package when they are imported; their ``cuda`` tests use only the port.  The card's machine has
neither, so this runner puts an import hook in front of every other: ``jax``, ``jaxlib``, ``flax``,
``optax`` and ``deepphysinet_tpu`` (not ``deepphysinet_tpu_torch``), with all their submodules,
import as stub modules.  Any name read from a stub module is a stub too, and calling, indexing,
iterating or testing one raises ``StubReached``: a card test that still reaches the JAX side fails
with that error and its name; it never skips.  ``tests/conftest.py`` (which configures JAX) is not
loaded, and ``tests`` is the repository's own directory, not another installed ``tests`` package.

It runs ``pytest -m cuda`` on the nine tests' files, prints one line a test case and one a test,
and exits with 0 only when every case of all nine tests ran and passed (a skip is a failure here:
the card is present).  Run from the repository's root on a machine with a card:

    python -m deepphysinet_tpu_torch.diagnostics.cuda_tests
"""
from __future__ import annotations

import importlib.abc
import importlib.util
import os
import sys
import types

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# file :: test function of every cuda-marked test of the port
CARD_TESTS = (
    "tests/test_torch_port_attention.py::test_attention_kernels_match_plain",
    "tests/test_torch_port_encoder_kernel.py::test_encoder_kernel_matches_plain",
    "tests/test_torch_port_ops.py::test_decode_primal_kernel_matches_plain",
    "tests/test_torch_port_residual_kernel.py::test_residual_kernel_matches_plain",
    "tests/test_torch_port_v2.py::test_v2_and_v3_kernels_match_plain",
    "tests/test_torch_port_v4.py::test_v4_kernels_match_plain",
    "tests/test_torch_port_v4pe.py::test_v4pe_and_v5_kernels_match_plain",
    "tests/test_torch_port_v4s.py::test_v4s_kernels_match_plain",
    "tests/test_torch_port_v6.py::test_v6_kernels_match_plain",
)
STUBBED = ("jax", "jaxlib", "flax", "optax", "deepphysinet_tpu")


class StubReached(RuntimeError):
    """A card test used a name of a stubbed module."""


class _Stub:
    """Any name read from a stub module: reading attributes gives more stubs, any use raises."""

    def __init__(self, name: str):
        object.__setattr__(self, "_name", name)

    def __getattr__(self, attr):
        if attr.startswith("__"):
            raise AttributeError(attr)
        return _Stub(f"{self._name}.{attr}")

    def _reached(self, *_args, **_kwargs):
        raise StubReached(f"{self._name} is a stub: a card test reached the JAX side")

    __call__ = __getitem__ = __iter__ = __bool__ = __len__ = __float__ = __int__ = __index__ = _reached
    __add__ = __radd__ = __sub__ = __rsub__ = __mul__ = __rmul__ = __truediv__ = __matmul__ = _reached
    __array__ = _reached

    def __repr__(self):
        return f"<stub {self._name}>"


class _StubModule(types.ModuleType):
    def __getattr__(self, attr):
        if attr.startswith("__"):
            raise AttributeError(attr)
        return _Stub(f"{self.__name__}.{attr}")


class _StubFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    def find_spec(self, fullname, path=None, target=None):
        if fullname.split(".")[0] not in STUBBED:
            return None
        return importlib.util.spec_from_loader(fullname, self, is_package=True)

    def create_module(self, spec):
        return _StubModule(spec.name)

    def exec_module(self, module):
        module.__path__ = []


def install_stubs() -> None:
    """Stub the JAX side and make ``tests`` the repository's directory; call before any test
    module is imported."""
    loaded = [m for m in sys.modules if m.split(".")[0] in STUBBED]
    if loaded:
        raise RuntimeError(f"already imported, cannot be stubbed: {sorted(loaded)[:5]}")
    sys.meta_path.insert(0, _StubFinder())
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    tests = types.ModuleType("tests")
    tests.__path__ = [os.path.join(REPO, "tests")]
    sys.modules["tests"] = tests


class _Report:
    """Pytest plugin: each case's outcome (a failure in set-up or tear-down counts)."""

    def __init__(self):
        self.outcomes = {}

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            prior = self.outcomes.get(report.nodeid)
            if prior is None or prior == "passed":
                self.outcomes[report.nodeid] = report.outcome


def main() -> int:
    install_stubs()
    import pytest
    import torch

    report = _Report()
    files = sorted({t.split("::")[0] for t in CARD_TESTS})
    os.chdir(REPO)
    rc = pytest.main([*files, "-m", "cuda", "--noconftest", "-p", "no:cacheprovider", "-p", "no:randomly",
                      "-p", "no:xdist", "-q", "-rfEs", f"--rootdir={REPO}"], plugins=[report])
    device = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "no CUDA device"
    print(f"[cuda tests] on {device}, pytest exit code {int(rc)}")
    bad = 0
    for test in CARD_TESTS:
        name = test.split("::")[1]
        cases = {k: v for k, v in report.outcomes.items() if k.split("::")[-1].split("[")[0] == name}
        for nodeid, outcome in sorted(cases.items()):
            print(f"[cuda tests]   {nodeid}: {outcome}")
        ok = bool(cases) and all(v == "passed" for v in cases.values())
        bad += not ok
        print(f"[cuda tests] {test}: {'passed' if ok else 'FAILED'} "
              f"({sum(v == 'passed' for v in cases.values())} of {len(cases)} cases passed)")
    print(f"[cuda tests] {len(CARD_TESTS) - bad} of {len(CARD_TESTS)} tests passed")
    return 0 if bad == 0 and rc == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
