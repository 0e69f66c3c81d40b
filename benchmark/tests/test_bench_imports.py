"""Nothing under benchmark/ imports JAX, its libraries or the JAX package
(top-level names compared whole: molclr_tpu_torch is not molclr_tpu), and
the plain reference imports nothing of the program."""

import ast

import pytest

from benchmark import harness

FILES = sorted(harness.HERE.rglob("*.py"))


def imported(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(harness.HERE)))
def test_no_jax(path):
    assert not imported(path) & set(harness.FORBIDDEN)


def test_reference_stands_alone():
    for path in (harness.HERE / "reference").glob("*.py"):
        assert imported(path) <= {"__future__", "contextlib", "numpy",
                                  "torch"}, path


def test_forbidden_names_compared_whole(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "molclr_tpu_torch_like",
                        types.ModuleType("molclr_tpu_torch_like"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert harness.forbidden_modules() == ["jax"]
