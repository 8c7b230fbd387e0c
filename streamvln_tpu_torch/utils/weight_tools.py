"""Delta-weight publish/apply and consolidation over the port's parameter
trees (nested dicts and lists of tensors).

Counterpart of `streamvln_tpu/utils/weight_tools.py` (reference surface:
llava/model/apply_delta.py, make_delta.py, consolidate.py, used for
license-safe weight publishing).
"""
from __future__ import annotations

import torch


def _map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def make_delta(base_params, target_params):
    """delta = target - base in f32, leaf for leaf (same tree shape)."""
    return _map(lambda t, b: t.float() - b.float(), target_params,
                base_params)


def apply_delta(base_params, delta):
    """target = base + delta in f32, cast back to each base leaf's dtype."""
    return _map(lambda b, d: (b.float() + d.float().to(b.device)).to(b.dtype),
                base_params, delta)


def consolidate(params):
    """The tree gathered into host memory: contiguous CPU tensors,
    detached, in their dtypes (the single-file publishable form)."""
    return _map(lambda x: x.detach().to("cpu").contiguous(), params)
