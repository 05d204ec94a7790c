"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program: each import's top-level name is
compared whole (``repro_torch`` is not ``repro``)."""

import ast

import pytest

from bench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(harness.BENCH.rglob("*.py"))


def top_level_imports(path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(harness.BENCH))
                              for p in SOURCES])
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in (harness.BENCH / "reference").rglob("*.py"):
        names = top_level_imports(path)
        assert "repro_torch" not in names, path
        assert names <= {"__future__", "bench", "math", "dataclasses",
                         "statistics", "numpy", "torch"}, (path, names)


def test_the_check_catches_a_whole_name():
    assert "repro" in {"repro.models".split(".")[0]} & FORBIDDEN
    assert not {"repro_torch"} & FORBIDDEN
