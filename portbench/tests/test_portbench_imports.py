"""No file of the benchmark imports JAX or the JAX package, and the plain
references import nothing of the program. Top-level module names are
compared whole: the port's name begins with the JAX package's."""

import ast

import pytest

from conftest import ROOT

BENCH = ROOT / "portbench"
JAX = {"jax", "jaxlib", "flax", "torch_admm_deconv_tpu"}
PORT = "torch_admm_deconv_tpu_torch"


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not _top_level_imports(path) & JAX


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_references_are_independent_of_the_program(path):
    assert PORT not in _top_level_imports(path)
    assert PORT not in path.read_text()
