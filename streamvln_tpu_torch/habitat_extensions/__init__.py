"""Habitat registry extensions of the port (a twin of
`streamvln_tpu/habitat_extensions`). habitat-sim exists only on simulator
hosts, so importing this package never imports habitat.

Call `register_measures()` on a habitat host before building an env, so
that PathLength / OracleSuccess / OracleNavigationError / OracleSPL / PL /
StepsTaken / NDTW resolve from `config.habitat.task.measurements` and show
up in `env.get_metrics()`.
"""
from __future__ import annotations

_registered = False


def habitat_available() -> bool:
    try:
        import habitat  # noqa: F401
        return True
    except ImportError:
        return False


def register_measures():
    """Import and register the measure extensions into habitat's registry,
    once per process. Raises ImportError when habitat is absent."""
    global _registered
    from streamvln_tpu_torch.habitat_extensions import measures
    if not _registered:
        measures.register_all()
        _registered = True
    return measures
