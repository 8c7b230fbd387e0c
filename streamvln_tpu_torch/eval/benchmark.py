"""External benchmark harness of the PyTorch port (lmms_eval-style
adapter).

Counterpart of `streamvln_tpu/eval/benchmark.py`. The reference's
mid-training eval shells out to `accelerate launch -m lmms_eval`, waits
for a results.json and parses the task metrics back (reference:
llava/train/llava_trainer_eval.py:8-50). The contract kept here:

- task files: <task>.json[l] entries
  {id, image|video?, question|conversations, answer,
   answer_type?: exact|contains|multiple_choice|rouge_l|tfidf_sim}
- generation through the standard agent, samples logged per task
- a results.json in the lmms_eval shape {"results": {task: {metric:
  value}}}, parsed back into a flat {task_metric: value} dict by
  `run_external_benchmark`, which runs the whole thing in a fresh
  process (the training process never shares its device with the eval
  run). The child runs on the device it is given (`--device`, cuda by
  default) and never falls back to the CPU on its own.

    python -m streamvln_tpu_torch.eval.benchmark --tasks toyvqa \
        --task_dir <dir> --output_path <out> --model_size tiny --device cpu
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
from collections import Counter
from typing import Dict, List, Optional


# ---------------------------------------------------------------------------
# Scoring
# ---------------------------------------------------------------------------

def _normalize(text: str) -> str:
    text = text.lower().strip()
    text = re.sub(r"[^\w\s]", "", text)
    return re.sub(r"\s+", " ", text)


def extract_choice(text: str) -> Optional[str]:
    """First standalone option letter A-E in the response (the common
    lmms_eval multiple-choice post-process)."""
    m = re.search(r"\b([A-Ea-e])\b", text)
    return m.group(1).upper() if m else None


def rouge_l(pred: str, gold: str) -> float:
    """ROUGE-L F1 over normalized word sequences, by the LCS (the
    interleave benchmarks' free-form metric, reference:
    llava/eval/evaluate_interleave.py)."""
    a = _normalize(pred).split()
    b = _normalize(gold).split()
    if not a or not b:
        return 0.0
    dp = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b, 1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    lcs = dp[-1]
    p, r = lcs / len(a), lcs / len(b)
    return 0.0 if p + r == 0 else 2 * p * r / (p + r)


def tfidf_similarity(pred: str, gold: str) -> float:
    """TF-IDF cosine over the two documents (reference
    evaluate_interleave.py's metric for the visual-cloze and
    image-coherence families), with sklearn's smoothed idf
    ln((1 + n) / (1 + df)) + 1 at n = 2; single-character tokens count,
    so identical texts always score 1."""
    a = Counter(_normalize(pred).split())
    b = Counter(_normalize(gold).split())
    if not a or not b:
        return 0.0
    vocab = set(a) | set(b)
    idf = {t: math.log(3.0 / (1 + ((t in a) + (t in b)))) + 1.0
           for t in vocab}
    va = {t: c * idf[t] for t, c in a.items()}
    vb = {t: c * idf[t] for t, c in b.items()}
    dot = sum(va[t] * vb.get(t, 0.0) for t in va)
    na = math.sqrt(sum(x * x for x in va.values()))
    nb = math.sqrt(sum(x * x for x in vb.values()))
    return 0.0 if na == 0 or nb == 0 else dot / (na * nb)


def score_answer(pred: str, gold: str, answer_type: str) -> float:
    if answer_type == "multiple_choice":
        return float(extract_choice(pred) == gold.strip().upper())
    if answer_type == "contains":
        return float(_normalize(gold) in _normalize(pred))
    if answer_type == "rouge_l":
        return rouge_l(pred, gold)
    if answer_type == "tfidf_sim":
        return tfidf_similarity(pred, gold)
    return float(_normalize(pred) == _normalize(gold))


_METRIC_NAME = {"exact": "exact_match", "multiple_choice": "accuracy",
                "contains": "contains_match", "rouge_l": "rouge_l_f",
                "tfidf_sim": "tfidf_similarity"}


# ---------------------------------------------------------------------------
# Task running
# ---------------------------------------------------------------------------

def load_task(path: str) -> List[dict]:
    with open(path) as f:
        if path.endswith(".jsonl"):
            return [json.loads(line) for line in f if line.strip()]
        return json.load(f)


def run_task(agent, entries: List[dict], media_root: str,
             samples_path: str, limit: Optional[int] = None) -> Dict:
    """Generate and score one task; returns its metric dict."""
    import numpy as np

    n = len(entries) if limit is None else min(limit, len(entries))
    per_type: Dict[str, List[float]] = {}
    os.makedirs(os.path.dirname(samples_path) or ".", exist_ok=True)
    with open(samples_path, "w") as f:
        for entry in entries[:n]:
            question = entry.get("question") or next(
                (c.get("value", c.get("content", ""))
                 for c in entry.get("conversations", [])
                 if c.get("from", c.get("role")) in ("human", "user")),
                "")
            question_clean = question.replace("<image>", "").strip()
            media = entry.get("image") or entry.get("video")
            if media:
                from PIL import Image
                rgb = np.asarray(Image.open(
                    os.path.join(media_root, media)).convert("RGB"),
                    np.uint8)
            else:
                rgb = np.zeros((384, 384, 3), np.uint8)
            agent.reset_memory(0)
            _, _, text = agent.step(0, rgb, question_clean,
                                    run_model=True)
            atype = entry.get("answer_type", "exact")
            s = score_answer(text or "", str(entry.get("answer", "")),
                             atype)
            per_type.setdefault(atype, []).append(s)
            f.write(json.dumps({"id": entry.get("id"),
                                "prediction": text,
                                "answer": entry.get("answer"),
                                "score": s}) + "\n")
    metrics = {_METRIC_NAME.get(t, t): (sum(v) / len(v) if v else 0.0)
               for t, v in per_type.items()}
    metrics["n"] = float(n)
    return metrics


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", default=None)
    p.add_argument("--model_size", default="7b")
    p.add_argument("--tasks", required=True,
                   help="comma-separated task names")
    p.add_argument("--task_dir", required=True,
                   help="directory holding <task>.json[l] files")
    p.add_argument("--media_root", default="")
    p.add_argument("--output_path", required=True)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--max_new_tokens", type=int, default=32)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    args = p.parse_args(argv)

    from streamvln_tpu_torch.eval_cli import build_agent
    agent = build_agent(args.model_path, args.model_size,
                        max_new_tokens=args.max_new_tokens,
                        device=args.device)

    results = {}
    os.makedirs(args.output_path, exist_ok=True)
    for task in args.tasks.split(","):
        task = task.strip()
        path = os.path.join(args.task_dir, f"{task}.jsonl")
        if not os.path.exists(path):
            path = os.path.join(args.task_dir, f"{task}.json")
        results[task] = run_task(
            agent, load_task(path), args.media_root,
            os.path.join(args.output_path, f"samples_{task}.jsonl"),
            args.limit)
    out = {"results": results,
           "device": str(agent.engine.device)}
    with open(os.path.join(args.output_path, "results.json"), "w") as f:
        json.dump(out, f)
    print(json.dumps(out))
    return out


def run_external_benchmark(tasks: str, task_dir: str, output_path: str,
                           model_path: Optional[str] = None,
                           model_size: str = "tiny",
                           media_root: str = "",
                           limit: Optional[int] = None,
                           extra_env: Optional[dict] = None,
                           device: str = "cuda") -> dict:
    """The reference hook's contract (llava_trainer_eval.py:17-50): launch
    the benchmark CLI in a fresh process on `device`, wait, parse
    results.json and return the flat {task_metric: value} dict."""
    cmd = [sys.executable, "-m", "streamvln_tpu_torch.eval.benchmark",
           "--tasks", tasks, "--task_dir", task_dir,
           "--output_path", output_path, "--model_size", model_size,
           "--media_root", media_root, "--device", device]
    if model_path:
        cmd += ["--model_path", model_path]
    if limit:
        cmd += ["--limit", str(limit)]
    env = dict(os.environ)
    env.update(extra_env or {})
    r = subprocess.run(cmd, env=env, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(
            f"benchmark subprocess failed rc={r.returncode}:\n"
            f"{r.stderr[-2000:]}")
    with open(os.path.join(output_path, "results.json")) as f:
        payload = json.load(f)
    flat = {}
    for task, metrics in payload["results"].items():
        for k, v in metrics.items():
            if k != "n":
                flat[f"{task}_{k}"] = v
    return flat


if __name__ == "__main__":
    main()
