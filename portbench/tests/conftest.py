"""The benchmark's own tests: `python -m pytest portbench/tests -q` from the
repository root. Tests marked `cuda` run on the card and skip elsewhere."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import shutil  # noqa: E402

import pytest  # noqa: E402


def _compose(dest, *subs):
    """A benchmark folder at `dest`: the loops and metric readers of
    portbench/, then the tiny configuration, mix and cells of
    portbench/tests/tiny/, then each of `subs` ({path: text}) written in."""
    from portbench.harness import spec
    for sub in ("loops", "metrics"):
        shutil.copytree(os.path.join(spec.PORTBENCH, sub),
                        os.path.join(dest, sub))
    tiny = os.path.join(spec.PORTBENCH, "tests", "tiny")
    for sub in ("configs", "traffic", "workloads"):
        shutil.copytree(os.path.join(tiny, sub), os.path.join(dest, sub))
    for files in subs:
        for rel, text in files.items():
            with open(os.path.join(dest, rel), "w", encoding="utf-8") as f:
                f.write(text)
    return str(dest)


@pytest.fixture(scope="session")
def compose():
    return _compose


@pytest.fixture(scope="session")
def tiny_base(tmp_path_factory):
    """The tiny cells' benchmark folder, as a later PR's copy would hold
    them: portbench/'s loops and readers beside the tiny files."""
    return _compose(tmp_path_factory.mktemp("portbench_tiny") / "portbench")
