"""Nothing under portbench/ imports JAX or the JAX package, and the
reference imports nothing of the program. Top-level module names are
compared whole: the port's name begins with the JAX package's."""
import ast
import os

from portbench.harness import cell, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "streamvln_tpu"}


def _imports(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def _files(top):
    for d, _, fs in os.walk(top):
        for f in fs:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    for path in _files(spec.PORTBENCH):
        found = FORBIDDEN.intersection(_imports(path))
        assert not found, (path, found)


def test_the_reference_imports_nothing_of_the_program():
    for path in _files(os.path.join(spec.PORTBENCH, "reference")):
        mods = set(_imports(path))
        assert "streamvln_tpu_torch" not in mods, path
        assert not FORBIDDEN & mods, path
        assert mods <= {"__future__", "bisect", "dataclasses", "json",
                        "math", "os", "re", "typing", "torch", "numpy",
                        "portbench"}, (path, mods)


def test_whole_names_are_compared(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "streamvln_tpu_torch_x",
                        types.ModuleType("streamvln_tpu_torch_x"))
    assert "streamvln_tpu_torch_x" not in cell.forbidden_modules()
    monkeypatch.setitem(sys.modules, "streamvln_tpu.models",
                        types.ModuleType("streamvln_tpu.models"))
    assert cell.forbidden_modules() == ["streamvln_tpu.models"]
