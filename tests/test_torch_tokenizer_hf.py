"""The port's HF tokenizer adapter against the JAX package's on the
committed byte-level BPE fixture (tests/fixtures/bpe_tokenizer, Qwen2's
structure): special ids, encode/decode, the generation prompt and the
dialogue's ids and labels equal; the committed golden ids reproduced; the
ByteTokenizer for a directory without tokenizer files, and ImportError
(never the ByteTokenizer) for one with them on a host without
`transformers`."""
import json
import os
import sys

import pytest

pytest.importorskip("transformers")

from streamvln_tpu.data import chatml as jchatml  # noqa: E402
from streamvln_tpu.data import tokenizer as jtok  # noqa: E402
from streamvln_tpu_torch.data import chatml, tokenizer  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
FIXTURE = os.path.join(FIXTURES, "bpe_tokenizer")
SPECIALS = ("im_start_id", "im_end_id", "eos_id", "pad_id", "newline_id",
            "image_token_id", "memory_token_id", "vocab_size")
# the dialogue of tests/test_tokenizer_golden.py (its golden ids)
DIALOGUE = [
    ("user", "You are an autonomous navigation assistant. Your task is "
             "to walk past the table and stop at the red door. "
             "you can see <image>."),
    ("assistant", "↑↑←→"),
    ("user", "you can see <image>."),
    ("assistant", "↑↑ STOP"),
]
TEXTS = ["", "\n", "<image>", "you can see <image>. Where to?",
         " These are your historical observations <memory>. you can spot "
         "<image>.", "↑←→ STOP", "<|im_start|>assistant\n↑↑<|im_end|>\n",
         "Walk past the sofa, turn left at the kitchen door."]


@pytest.fixture(scope="module")
def toks():
    t = tokenizer.load_tokenizer(FIXTURE, model_max_length=2048)
    assert isinstance(t, tokenizer.HFTokenizerAdapter)
    return jtok.load_tokenizer(FIXTURE, model_max_length=2048), t


def test_special_ids_match_jax(toks):
    j, t = toks
    for name in SPECIALS:
        assert getattr(t, name) == getattr(j, name), name
    assert t.newline_id == 198                    # Qwen2's newline id
    assert t.eos_id == t.im_end_id


@pytest.mark.parametrize("text", TEXTS)
def test_encode_decode_match_jax(toks, text):
    j, t = toks
    ids = t.encode(text)
    assert ids == j.encode(text)
    assert t.decode(ids) == j.decode(ids) == text
    # sentinels and negative ids are dropped in decode, as in the reference
    assert t.decode(ids + [-200, -300]) == j.decode(ids + [-200, -300])


def test_prompts_and_dialogue_match_jax(toks):
    j, t = toks
    assert chatml.generation_prompt(t) == jchatml.generation_prompt(j)
    for add_system in (True, False):
        for with_labels in (True, False):
            a = chatml.tokenize_dialogue(t, DIALOGUE, add_system=add_system,
                                         with_labels=with_labels)
            b = jchatml.tokenize_dialogue(j, DIALOGUE, add_system=add_system,
                                          with_labels=with_labels)
            assert a[0].tolist() == b[0].tolist()
            assert a[1].tolist() == b[1].tolist()
    text = chatml.actions_to_text([1, 1, 2, 3, 0])
    assert chatml.parse_actions(t.decode(t.encode(text))) == [1, 1, 2, 3, 0]


def test_golden_ids_reproduced(toks):
    _, t = toks
    with open(os.path.join(FIXTURES, "golden_chatml_ids.json")) as f:
        golden = json.load(f)
    ids, labels = chatml.tokenize_dialogue(t, DIALOGUE, add_system=True,
                                           with_labels=True)
    assert ids.tolist() == golden["input_ids"]
    assert labels.tolist() == golden["labels"]
    assert chatml.generation_prompt(t) == golden["generation_prompt"]


def test_load_tokenizer_without_files_or_transformers(tmp_path,
                                                      monkeypatch):
    assert isinstance(tokenizer.load_tokenizer(None),
                      tokenizer.ByteTokenizer)
    (tmp_path / "model.safetensors").write_bytes(b"")
    assert isinstance(tokenizer.load_tokenizer(str(tmp_path)),
                      tokenizer.ByteTokenizer)
    assert isinstance(tokenizer.load_tokenizer(str(tmp_path / "absent")),
                      tokenizer.ByteTokenizer)
    # tokenizer files but no transformers: ImportError, as the reference
    monkeypatch.setitem(sys.modules, "transformers", None)
    for mod in (tokenizer, jtok):
        with pytest.raises(ImportError):
            mod.load_tokenizer(FIXTURE)
