"""ChatML prompt construction + label masking + action parsing.

Reproduces the reference's preprocess_qwen semantics exactly
(reference: streamvln/dataset/vln_action_dataset.py:229-307 for training
with labels; streamvln/streamvln_eval.py:393-469 for eval without labels):

- template per message: '<|im_start|>' + role + '\n' + content +
  '<|im_end|>' + '\n'
- optional leading system message ("You are a helpful assistant.")
- labels: system/user turns masked to IGNORE_INDEX; assistant turns keep
  ids; tokens in {newline, im_start, im_end} are ALWAYS unmasked
  (vln_action_dataset.py:247, 291-293)
- <image>/<memory> token ids remapped to -200 / -300 sentinels
"""
from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

from streamvln_tpu_torch.data.tokenizer import Tokenizer
from streamvln_tpu_torch.utils.constants import (
    ACTIONS_TO_IDX, CONJUNCTIONS, IDX_TO_ACTION_TEXT, IGNORE_INDEX,
    IMAGE_TOKEN_INDEX, MEMORY_TOKEN_INDEX, SYSTEM_MESSAGE)


def encode_message(tok: Tokenizer, role: str, content: str) -> List[int]:
    """One ChatML message -> ids (template parity with the reference's
    custom chat_template string, vln_action_dataset.py:251)."""
    return (
        [tok.im_start_id]
        + tok.encode(role + "\n" + content)
        + [tok.im_end_id]
        + tok.encode("\n")
    )


def generation_prompt(tok: Tokenizer) -> List[int]:
    """'<|im_start|>assistant\n' — appended before decoding."""
    return [tok.im_start_id] + tok.encode("assistant\n")


def tokenize_dialogue(
    tok: Tokenizer,
    turns: Sequence[Tuple[str, str]],     # (role in {user, assistant}, text)
    add_system: bool = True,
    with_labels: bool = True,
    system_message: str = SYSTEM_MESSAGE,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (input_ids, labels) int32 arrays (labels all-IGNORE when
    with_labels=False)."""
    input_ids: List[int] = []
    labels: List[int] = []

    if add_system:
        ids = encode_message(tok, "system", system_message)
        input_ids += ids
        labels += [IGNORE_INDEX] * len(ids)

    for role, content in turns:
        ids = encode_message(tok, role, content)
        input_ids += ids
        if with_labels and role == "assistant":
            labels += ids
        else:
            labels += [IGNORE_INDEX] * len(ids)

    unmask = {tok.newline_id, tok.im_start_id, tok.im_end_id}
    out_ids: List[int] = []
    out_labels: List[int] = []
    for t, lab in zip(input_ids, labels):
        if with_labels and t in unmask:
            lab = t
        if t == tok.image_token_id:
            t = IMAGE_TOKEN_INDEX
        elif t == tok.memory_token_id:
            t = MEMORY_TOKEN_INDEX
        out_ids.append(t)
        out_labels.append(lab)

    return (np.asarray(out_ids, np.int32),
            np.asarray(out_labels, np.int32) if with_labels
            else np.full(len(out_ids), IGNORE_INDEX, np.int32))


def observation_prompt(rng: Optional[np.random.Generator],
                       base_text: str) -> str:
    """Append the per-round observation clause: '<conjunction> <image>.'
    (reference: streamvln_eval.py:424-428). Deterministic (first
    conjunction) when rng is None, matching the agent
    (streamvln_agent.py:126)."""
    conj = CONJUNCTIONS[0] if rng is None else \
        CONJUNCTIONS[int(rng.integers(len(CONJUNCTIONS)))]
    prompt = conj + "<image>"
    if base_text:
        return f"{base_text} {prompt}."
    return f"{prompt}."


_ACTION_RE = re.compile("|".join(re.escape(a) for a in ACTIONS_TO_IDX))


def parse_actions(text: str) -> List[int]:
    """Regex-parse action glyphs from decoded text
    (reference: streamvln_eval.py:382-389)."""
    return [ACTIONS_TO_IDX[m] for m in _ACTION_RE.findall(text)]



def actions_to_text(actions: Sequence[int]) -> str:
    """Action indices -> glyph string (reference:
    vln_action_dataset.py:702-711)."""
    return "".join(IDX_TO_ACTION_TEXT[int(a)] for a in actions)
