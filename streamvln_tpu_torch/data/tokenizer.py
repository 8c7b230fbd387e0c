"""Tokenizers for the port: the `Tokenizer` protocol, the HF Qwen2
adapter and the dependency-free `ByteTokenizer`.

Own copy of `streamvln_tpu/data/tokenizer.py` (the port imports nothing
of the JAX package). `load_tokenizer(path)` returns the HF-backed adapter
for a checkpoint directory with tokenizer files (exact Qwen2 BPE; needs
`transformers`, and raises ImportError without it) and the ByteTokenizer
otherwise (deterministic and reversible, the action glyphs included).
"""
from __future__ import annotations

import os
from typing import List, Optional, Protocol, Sequence


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


class HFTokenizerAdapter:
    """A HF Qwen2 tokenizer directory, with the reference's runtime
    special-token registration: <image>/<memory> are added as specials,
    im_start/im_end come from the vocabulary (or, on older checkpoints,
    the first two additional specials), and the standalone-newline token
    joins the unmask set."""

    def __init__(self, path: str, model_max_length: int = 4096):
        import transformers
        self._tok = transformers.AutoTokenizer.from_pretrained(
            path, model_max_length=model_max_length, padding_side="right")
        self._tok.add_tokens(["<image>"], special_tokens=True)
        self._tok.add_tokens(["<memory>"], special_tokens=True)
        self.image_token_id = self._tok.convert_tokens_to_ids("<image>")
        self.memory_token_id = self._tok.convert_tokens_to_ids("<memory>")
        self.im_start_id = self._tok.convert_tokens_to_ids("<|im_start|>")
        self.im_end_id = self._tok.convert_tokens_to_ids("<|im_end|>")
        if None in (self.im_start_id, self.im_end_id):
            # older checkpoints: the first two additional specials are
            # im_start/im_end
            self.im_start_id, self.im_end_id = \
                self._tok.additional_special_tokens_ids[:2]
        # 198 on the real Qwen2 vocabulary; derived here so any BPE works
        nl = self._tok("\n", add_special_tokens=False)["input_ids"]
        assert len(nl) == 1, f"newline is not a single token: {nl}"
        self.newline_id = nl[0]
        # im_end may have come from the additional specials above: eos
        # follows it (a literal "<|im_end|>" lookup fails on those vocabs)
        self.eos_id = self.im_end_id
        self.pad_id = (self._tok.pad_token_id
                       if self._tok.pad_token_id is not None
                       else self._tok.convert_tokens_to_ids("<|endoftext|>"))

    @property
    def vocab_size(self) -> int:
        return len(self._tok)

    def encode(self, text: str) -> List[int]:
        return self._tok(text, add_special_tokens=False)["input_ids"]

    def decode(self, ids: Sequence[int]) -> str:
        clean = [int(t) for t in ids if int(t) >= 0]
        return self._tok.decode(clean, skip_special_tokens=False)


def load_tokenizer(path: Optional[str] = None,
                   model_max_length: int = 4096) -> Tokenizer:
    """The HF adapter when `path` holds tokenizer files (ImportError
    without `transformers`: never the ByteTokenizer in its place), else
    the ByteTokenizer."""
    if path and os.path.isdir(path) and (
            os.path.exists(os.path.join(path, "tokenizer.json"))
            or os.path.exists(os.path.join(path, "tokenizer_config.json"))):
        return HFTokenizerAdapter(path, model_max_length)
    return ByteTokenizer()
