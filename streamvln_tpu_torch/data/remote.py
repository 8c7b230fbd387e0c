"""Remote dataset IO: a pluggable URI opener.

Own copy of `streamvln_tpu/data/remote.py`. The reference stack reads
MMC4/QA shards and images from ceph through petrel_client; this is the
infra-agnostic equivalent: one `read_bytes(uri)` used by the co-training
datasets and the mixture loader, dispatching on scheme:

- plain paths / file://  -> local filesystem
- http:// / https://     -> urllib (stdlib)
- s3://                  -> boto3 when installed (gated, like the
                            reference's petrel import guard)
- petrel://              -> petrel_client when installed

Custom schemes register with `register_scheme("myfs", fn)`, the
deployment hook for site clients.
"""
from __future__ import annotations

import io
import os
from typing import Callable, Dict
from urllib.parse import urlparse

_OPENERS: Dict[str, Callable[[str], bytes]] = {}


def register_scheme(scheme: str, reader: Callable[[str], bytes]):
    """Register a `uri -> bytes` reader for a scheme (site IO plug)."""
    _OPENERS[scheme.lower()] = reader


def _read_local(uri: str) -> bytes:
    path = uri[len("file://"):] if uri.startswith("file://") else uri
    with open(path, "rb") as f:
        return f.read()


def _read_http(uri: str) -> bytes:
    from urllib.request import urlopen
    with urlopen(uri, timeout=30) as r:
        return r.read()


def _read_s3(uri: str) -> bytes:
    try:
        import boto3
    except ImportError as e:  # same gating shape as the reference's
        raise ImportError(
            "s3:// dataset paths need boto3 (reference gates "
            "petrel_client the same way)") from e
    p = urlparse(uri)
    buf = io.BytesIO()
    boto3.client("s3").download_fileobj(p.netloc, p.path.lstrip("/"),
                                        buf)
    return buf.getvalue()


def _read_petrel(uri: str) -> bytes:
    try:
        from petrel_client.client import Client
    except ImportError as e:
        raise ImportError("petrel:// paths need petrel_client") from e
    global _PETREL
    try:
        _PETREL
    except NameError:
        _PETREL = Client("~/petreloss.conf")
    return _PETREL.get(uri[len("petrel://"):])


def read_bytes(uri: str) -> bytes:
    """Read a dataset artifact (json shard, image) from any backend."""
    scheme = urlparse(str(uri)).scheme.lower()
    if scheme in _OPENERS:
        return _OPENERS[scheme](uri)
    if scheme in ("", "file") or (len(scheme) == 1 and os.name == "nt"):
        return _read_local(uri)
    if scheme in ("http", "https"):
        return _read_http(uri)
    if scheme == "s3":
        return _read_s3(uri)
    if scheme == "petrel":
        return _read_petrel(uri)
    raise ValueError(f"unsupported dataset URI scheme: {uri!r}")


def is_remote(uri: str) -> bool:
    scheme = urlparse(str(uri)).scheme.lower()
    return scheme not in ("", "file") and not (
        len(scheme) == 1 and os.name == "nt")


def open_image(uri: str):
    """PIL image from any backend (RGB)."""
    from PIL import Image
    if not is_remote(uri):
        return Image.open(uri).convert("RGB")
    return Image.open(io.BytesIO(read_bytes(uri))).convert("RGB")
