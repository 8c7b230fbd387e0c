"""Serving-side content moderation hook.

Reference: llava/utils.py:182-203 `violates_moderation` posts the user
text to the OpenAI moderation API (gradio_web_server.py gates requests
on it when --moderate is set). Same contract here on stdlib urllib,
pluggable so deployments can swap in their own classifier:

- set_moderator(fn): any `text -> bool` callable wins
- env OPENAI_API_KEY + provider="openai": the reference's behavior
- no key / network error: fail-open (returns False), exactly like the
  reference's try/except.

A copy of `streamvln_tpu/serve/moderation.py`.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Optional

_MODERATOR: Optional[Callable[[str], bool]] = None


def set_moderator(fn: Optional[Callable[[str], bool]]):
    global _MODERATOR
    _MODERATOR = fn


def violates_moderation(text: str, provider: str = "openai") -> bool:
    """True if the text is flagged. Fail-open on any error
    (reference: llava/utils.py:191-199)."""
    if _MODERATOR is not None:
        return bool(_MODERATOR(text))
    if provider != "openai" or "OPENAI_API_KEY" not in os.environ:
        return False
    from urllib.request import Request, urlopen
    data = json.dumps({"input": text.replace("\n", "")}).encode()
    req = Request(
        "https://api.openai.com/v1/moderations", data=data,
        headers={"Content-Type": "application/json",
                 "Authorization":
                     "Bearer " + os.environ["OPENAI_API_KEY"]})
    try:
        with urlopen(req, timeout=5) as r:
            return bool(json.load(r)["results"][0]["flagged"])
    except Exception as e:  # noqa: BLE001 — fail-open like the ref
        print(f"moderation error: {e!r}")
        return False
