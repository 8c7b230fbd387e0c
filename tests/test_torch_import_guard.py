"""The port stands alone: every module of `streamvln_tpu_torch`, and
`chip_smoke.py`, imports with jax blocked, and none of them pulls in jax
or anything of the JAX package."""
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, importlib.util, pkgutil, sys
    sys.modules["jax"] = None          # any `import jax` now raises
    import streamvln_tpu_torch
    names = ["streamvln_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(
            streamvln_tpu_torch.__path__, "streamvln_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  "chip_smoke.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    bad = sorted(m for m in sys.modules
                 if (m == "jax" or m.startswith(("jax.", "jaxlib")) or
                     m == "streamvln_tpu" or m.startswith("streamvln_tpu."))
                 and sys.modules[m] is not None)
    print(len(names), "modules")
    assert not bad, bad
""")


def test_port_imports_nothing_of_jax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[0]) >= 15


BANNED = ("jax", "jaxlib", "streamvln_tpu")


def _banned(name: str) -> bool:
    return any(name == b or name.startswith(b + ".") for b in BANNED)


def test_no_import_of_jax_or_the_jax_package_at_any_depth():
    """The runtime check above sees only imports made while a module is
    imported; this one reads every `.py` file of the port and
    `chip_smoke.py` and refuses an `import` or `from ... import` naming jax,
    jaxlib, streamvln_tpu or a submodule of it anywhere, inside functions
    and branches included."""
    import ast
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, dirs, names in os.walk(os.path.join(ROOT, "streamvln_tpu_torch")):
        dirs[:] = [x for x in dirs if x != "_build"]     # build outputs
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, ROOT)}:{node.lineno} {n}"
                    for n in names if _banned(n)]
    assert len(files) >= 30
    assert not bad, bad
