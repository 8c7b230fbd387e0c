"""Tokenizers for the port: the `Tokenizer` protocol and the
dependency-free `ByteTokenizer`.

Own copy of `streamvln_tpu/data/tokenizer.py` (the port imports nothing
of the JAX package). The HF-backed adapter is not carried over yet: it
needs `transformers`, which the GPU image does not ship.
"""
from __future__ import annotations

from typing import List, Protocol, Sequence


class Tokenizer(Protocol):
    im_start_id: int
    im_end_id: int
    newline_id: int
    pad_id: int
    image_token_id: int
    memory_token_id: int

    def encode(self, text: str) -> List[int]: ...
    def decode(self, ids: Sequence[int]) -> str: ...
    @property
    def vocab_size(self) -> int: ...


class ByteTokenizer:
    """UTF-8 byte tokenizer with ChatML + multimodal specials.

    ids 0..255 = raw bytes; specials follow. Reversible for arbitrary text.
    `newline_id` is ord('\\n') = 10 (plays the role of Qwen's token 198 in
    the unmask set).
    """

    SPECIALS = ("<|im_start|>", "<|im_end|>", "<|endoftext|>",
                "<image>", "<memory>")

    def __init__(self):
        self._special_to_id = {s: 256 + i for i, s in enumerate(self.SPECIALS)}
        self._id_to_special = {v: k for k, v in self._special_to_id.items()}
        self.im_start_id = self._special_to_id["<|im_start|>"]
        self.im_end_id = self._special_to_id["<|im_end|>"]
        self.eos_id = self._special_to_id["<|endoftext|>"]
        self.pad_id = self.eos_id
        self.image_token_id = self._special_to_id["<image>"]
        self.memory_token_id = self._special_to_id["<memory>"]
        self.newline_id = ord("\n")

    @property
    def vocab_size(self) -> int:
        return 256 + len(self.SPECIALS)

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        i = 0
        while i < len(text):
            matched = False
            for s, sid in self._special_to_id.items():
                if text.startswith(s, i):
                    ids.append(sid)
                    i += len(s)
                    matched = True
                    break
            if not matched:
                ids.extend(text[i].encode("utf-8"))
                i += 1
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        out: List[str] = []
        buf = bytearray()
        for t in ids:
            t = int(t)
            if t < 0:
                t = {-200: self.image_token_id,
                     -300: self.memory_token_id}.get(t, None)
                if t is None:
                    continue
            if t >= 256:
                if buf:
                    out.append(buf.decode("utf-8", errors="replace"))
                    buf = bytearray()
                out.append(self._id_to_special.get(t, ""))
            else:
                buf.append(t)
        if buf:
            out.append(buf.decode("utf-8", errors="replace"))
        return "".join(out)
