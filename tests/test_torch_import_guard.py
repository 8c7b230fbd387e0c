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
