"""The port's benchmark harness (eval/benchmark.py) against the JAX
package's on the CPU: the three subjects of tests/test_benchmark.py (the
scoring rules, the subprocess round trip, ROUGE-L and TF-IDF), the
scorers equal to the reference's on the same strings, `run_task`'s
samples and metrics equal to the JAX harness's on one tiny tree, and the
child process that runs on the device it is given.
"""
import json
import os
import sys

import numpy as np
import pytest

from streamvln_tpu.eval import benchmark as jb
from streamvln_tpu_torch.eval import benchmark as tb

_TEXTS = ["The answer is B.", "I think (C)", "no letters here",
          "A red door!", "it is a red door", "blue door", "the red door",
          "the blue door", "  Mixed   CASE, punctuation!! ", "", "a",
          "e) five", "same words here", "alpha beta", "x y z"]


def test_scoring_rules():
    assert tb.score_answer("The answer is B.", "b", "multiple_choice") == 1
    assert tb.score_answer("I think (C)", "B", "multiple_choice") == 0
    assert tb.extract_choice("no letters here") is None
    assert tb.score_answer("A red door!", "a red door", "exact") == 1
    assert tb.score_answer("it is a red door", "red door", "contains") == 1
    assert tb.score_answer("blue door", "red door", "contains") == 0
    for pred in _TEXTS:
        assert tb._normalize(pred) == jb._normalize(pred)
        assert tb.extract_choice(pred) == jb.extract_choice(pred)
        for gold in _TEXTS[::3]:
            for kind in ("exact", "contains", "multiple_choice", "rouge_l",
                         "tfidf_sim"):
                assert tb.score_answer(pred, gold, kind) == \
                    jb.score_answer(pred, gold, kind)


def test_rouge_l_and_tfidf_scores():
    assert tb.rouge_l("the red door is open", "the red door is open") == 1.0
    assert tb.rouge_l("a b c", "x y z") == 0.0
    mid = tb.rouge_l("the red door", "the blue door")
    assert 0.0 < mid < 1.0
    assert tb.tfidf_similarity("same words here", "same words here") > 0.99
    assert tb.tfidf_similarity("alpha beta", "gamma delta") < 0.1
    assert tb.score_answer("the red door", "the red door", "rouge_l") == 1.0
    assert 0 <= tb.score_answer("a cat", "a dog", "tfidf_sim") <= 1
    for a in _TEXTS:
        for b in _TEXTS:
            assert tb.rouge_l(a, b) == jb.rouge_l(a, b)
            assert tb.tfidf_similarity(a, b) == jb.tfidf_similarity(a, b)


def _write_task(path, name, entries):
    with open(path / f"{name}.jsonl", "w") as f:
        for e in entries:
            f.write(json.dumps(e) + "\n")


def _toy_task(tmp_path):
    from PIL import Image
    img_dir = tmp_path / "media"
    os.makedirs(img_dir)
    Image.fromarray(np.zeros((64, 64, 3), np.uint8)).save(
        img_dir / "im0.jpg")
    entries = [
        {"id": 0, "image": "im0.jpg",
         "question": "<image>\nWhat color? A. red B. blue",
         "answer": "A", "answer_type": "multiple_choice"},
        {"id": 1, "question": "Say hi", "answer": "hi",
         "answer_type": "contains"},
        {"id": 2, "conversations": [{"from": "human", "value": "Name it"}],
         "answer": "a door", "answer_type": "rouge_l"},
    ]
    _write_task(tmp_path, "toyvqa", entries)
    return str(img_dir), entries


def test_subprocess_benchmark_roundtrip(tmp_path):
    """run_external_benchmark launches the port's benchmark CLI in a fresh
    process on the device it is given (the CPU here; the child never picks
    a device on its own), waits and parses results.json."""
    media, _ = _toy_task(tmp_path)
    out_dir = tmp_path / "out"
    flat = tb.run_external_benchmark(
        tasks="toyvqa", task_dir=str(tmp_path), output_path=str(out_dir),
        model_size="tiny", media_root=media, device="cpu")
    assert set(flat) == {"toyvqa_accuracy", "toyvqa_contains_match",
                         "toyvqa_rouge_l_f"}
    payload = json.load(open(out_dir / "results.json"))
    assert set(payload["results"]) == {"toyvqa"}
    assert payload["device"] == "cpu"
    assert payload["results"]["toyvqa"]["n"] == 3.0
    samples = [json.loads(line) for line in
               open(out_dir / "samples_toyvqa.jsonl")]
    assert len(samples) == 3 and all("score" in s for s in samples)
    # a failing child raises with its error output
    with pytest.raises(RuntimeError, match="benchmark subprocess failed"):
        tb.run_external_benchmark(
            tasks="missing", task_dir=str(tmp_path),
            output_path=str(tmp_path / "bad"), model_size="tiny",
            device="cpu")


def test_run_task_matches_jax(tmp_path):
    """run_task's predictions, scores and metrics against the JAX
    harness's, on agents over one tiny tree."""
    sys.path.insert(0, os.path.dirname(__file__))
    from test_torch_aux import make_agents

    media, entries = _toy_task(tmp_path)
    jagent, agent = make_agents()
    got = tb.run_task(agent, entries, media, str(tmp_path / "p.jsonl"))
    want = jb.run_task(jagent, entries, media, str(tmp_path / "j.jsonl"),
                       limit=None)
    assert got == want
    assert [json.loads(line) for line in open(tmp_path / "p.jsonl")] == \
        [json.loads(line) for line in open(tmp_path / "j.jsonl")]
    assert tb.run_task(agent, entries, media, str(tmp_path / "l.jsonl"),
                       limit=1)["n"] == 1.0
    assert tb.load_task(str(tmp_path / "toyvqa.jsonl")) == entries
