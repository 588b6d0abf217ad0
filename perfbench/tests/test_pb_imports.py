"""No module of the benchmark imports JAX or the JAX package, and the
plain reference imports nothing of the program either.  Top-level names
are compared whole: ``coast_tpu_torch`` is not ``coast_tpu``."""

import ast
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "coast_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


MODULES = sorted(PB.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(PB)) for p in MODULES])
def test_no_jax(path):
    assert not set(_imports(path)) & FORBIDDEN


REFERENCE = sorted((PB / "reference").rglob("*.py"))


@pytest.mark.parametrize("path", REFERENCE,
                         ids=[p.name for p in REFERENCE])
def test_reference_imports_nothing_of_the_program(path):
    assert "coast_tpu_torch" not in set(_imports(path))
    assert not set(_imports(path)) & FORBIDDEN


def test_the_check_sees_whole_names():
    names = {"coast_tpu_torch", "perfbench"}
    assert not names & FORBIDDEN
