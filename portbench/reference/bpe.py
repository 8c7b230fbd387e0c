"""A byte-level BPE reader in pure Python, for the committed tokenizer file
`portbench/data/bpe_tokenizer.json` (a `tokenizers` JSON with a ByteLevel
pre-tokenizer, its merges and three ChatML specials). The card has no
`transformers` or `tokenizers`, so the benchmark tokenizes with this.

`<image>` and `<memory>` are registered as specials after the file's own
tokens, as the serving stack's HF adapter registers them. Besides the
reader, `Tokenizer` carries the attributes the agent's prompt builder
reads (`im_start_id`, `im_end_id`, `eos_id`, `pad_id`, `newline_id`,
`image_token_id`, `memory_token_id`, `vocab_size`).
"""
from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Sequence, Tuple

DEFAULT_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "bpe_tokenizer.json")
EXTRA_SPECIALS = ("<image>", "<memory>")

# GPT-2's pre-tokenizer pattern with \p{L} as [^\W\d_] and \p{N} as \d
# (the standard library's `re` has no Unicode classes)
_PRETOKEN = re.compile(
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?(?:[^\s\w]|_)+"""
    r"""|\s+(?!\S)|\s+""")


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible map of the 256 bytes onto printable characters."""
    keep = list(range(ord("!"), ord("~") + 1)) + \
        list(range(ord("\xa1"), ord("\xac") + 1)) + \
        list(range(ord("\xae"), ord("\xff") + 1))
    chars = keep[:]
    n = 0
    for b in range(256):
        if b not in keep:
            keep.append(b)
            chars.append(256 + n)
            n += 1
    return dict(zip(keep, map(chr, chars)))


class Tokenizer:
    """Encode and decode with the file's vocabulary, merges and specials."""

    def __init__(self, path: str = DEFAULT_PATH):
        with open(path, encoding="utf-8") as f:
            spec = json.load(f)
        model = spec["model"]
        self.vocab: Dict[str, int] = dict(model["vocab"])
        merges = [tuple(m.split(" ")) if isinstance(m, str) else tuple(m)
                  for m in model["merges"]]
        self.ranks: Dict[Tuple[str, str], int] = {
            m: i for i, m in enumerate(merges)}
        self.specials: Dict[str, int] = {
            t["content"]: t["id"] for t in spec["added_tokens"]}
        nxt = max(list(self.vocab.values()) + list(self.specials.values())) + 1
        for s in EXTRA_SPECIALS:
            self.specials[s] = nxt
            nxt += 1
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.id_to_special = {i: s for s, i in self.specials.items()}
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {c: b for b, c in self.byte_encoder.items()}
        self._split = re.compile("(" + "|".join(
            re.escape(s) for s in sorted(self.specials, key=len,
                                         reverse=True)) + ")")
        self._cache: Dict[str, List[int]] = {}
        self.im_start_id = self.specials["<|im_start|>"]
        self.im_end_id = self.specials["<|im_end|>"]
        self.eos_id = self.im_end_id
        self.pad_id = self.specials["<|endoftext|>"]
        self.image_token_id = self.specials["<image>"]
        self.memory_token_id = self.specials["<memory>"]
        (self.newline_id,) = self.encode("\n")

    @property
    def vocab_size(self) -> int:
        return len(self.vocab) + len(self.specials)

    def _bpe(self, word: str) -> List[int]:
        ids = self._cache.get(word)
        if ids is not None:
            return ids
        parts = list(word)
        while len(parts) > 1:
            pairs = [(self.ranks.get((a, b), -1), i)
                     for i, (a, b) in enumerate(zip(parts, parts[1:]))]
            best = min((r, i) for r, i in pairs if r >= 0) \
                if any(r >= 0 for r, _ in pairs) else None
            if best is None:
                break
            a, b = parts[best[1]], parts[best[1] + 1]
            merged, i = [], 0
            while i < len(parts):
                if i + 1 < len(parts) and parts[i] == a and parts[i + 1] == b:
                    merged.append(a + b)
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        ids = [self.vocab[p] for p in parts]
        self._cache[word] = ids
        return ids

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for piece in self._split.split(text):
            if not piece:
                continue
            if piece in self.specials:
                ids.append(self.specials[piece])
                continue
            for word in _PRETOKEN.findall(piece):
                ids.extend(self._bpe("".join(
                    self.byte_encoder[b] for b in word.encode("utf-8"))))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        """Text of the ids; ids outside the vocabulary (a model's logits
        cover more rows than this file names) are skipped."""
        out, buf = [], bytearray()
        for t in map(int, ids):
            if t in self.id_to_special:
                out.append(buf.decode("utf-8", errors="replace"))
                buf = bytearray()
                out.append(self.id_to_special[t])
            elif t in self.id_to_token:
                buf.extend(self.byte_decoder[c] for c in self.id_to_token[t])
        out.append(buf.decode("utf-8", errors="replace"))
        return "".join(out)
