"""What the benchmark may import and read: no JAX and no JAX package, and
a reference that takes nothing of the port."""

import ast
import sys

import pytest

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
#: the JAX package's benchmark folder, which nothing here reads
OLD_BENCH = "benchmarks" + "/"
SOURCES = sorted((ROOT / "portbench").rglob("*.py"))


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_and_no_benchmarks_dir(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN, tops & FORBIDDEN
    assert "benchmarks" not in tops
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert OLD_BENCH not in node.value


def test_reference_takes_nothing_of_the_port():
    for path in sorted((ROOT / "portbench/reference").glob("*.py")):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top != "repro_torch", (path, name)
            assert top != "portbench" or name.startswith(
                "portbench.reference"), (path, name)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from portbench import harness
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert harness.forbidden_modules() == ["repro"]
