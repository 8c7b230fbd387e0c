"""Offline batch evaluation of the PyTorch port: answer generation over
QA and interleaved datasets (reference surface: llava/eval/model_vqa.py
and evaluate_interleave.py: load questions, generate, write answers
jsonl).

Counterpart of `streamvln_tpu/eval/offline.py`, over the entry schema of
the co-training ConversationDataset ({id, video|image, conversations});
each entry's first human turn is the prompt, and the answers go to an
answers.jsonl with their ids. A video entry's frames go through the
agent as dialogue turns (the streaming path); under
--image_aspect_ratio anyres a single image goes through the tiled encode
and the spatial_unpad merge (models/anyres.py).

    python -m streamvln_tpu_torch.eval.offline --question_file q.json \
        --media_root <dir> --answers_file answers.jsonl \
        --model_size tiny --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

import numpy as np


def run_offline_eval(agent, entries: List[dict], media_root: str,
                     output_path: str, num_frames_qa: int = 8,
                     max_entries: Optional[int] = None,
                     image_aspect_ratio: str = "square") -> List[dict]:
    from PIL import Image

    from streamvln_tpu_torch.data.cotrain_datasets import (
        ConversationDataset)

    ds = ConversationDataset(agent.tok, agent.cfg, entries, media_root,
                             num_frames_qa=num_frames_qa)
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    answers = []
    n = len(ds) if max_entries is None else min(len(ds), max_entries)
    with open(output_path, "w") as f:
        for i in range(n):
            entry = ds.entries[i]
            frames = [np.asarray(Image.open(p).convert("RGB"), np.uint8)
                      for p in ds._frame_paths(entry)]
            question = next(
                (c.get("value", c.get("content", ""))
                 for c in entry["conversations"]
                 if c.get("from", c.get("role")) in ("human", "user")),
                "")
            question_clean = question.replace("<image>", "").strip()

            t0 = time.perf_counter()
            if image_aspect_ratio == "anyres" and len(frames) == 1:
                # single-image anyres path (reference:
                # llava_arch.py:317-408 with --image_aspect_ratio anyres)
                text = _answer_anyres(agent, frames[0], question_clean)
            else:
                agent.reset_memory(0)
                # the frames as dialogue turns: all but the last are
                # context
                for frame in frames[:-1]:
                    agent.step(0, frame, question_clean, run_model=False)
                _, _, text = agent.step(0, frames[-1], question_clean,
                                        run_model=True)
            rec = {
                "question_id": entry.get("id", i),
                "prompt": question_clean,
                "text": text,
                "answer_time": time.perf_counter() - t0,
            }
            answers.append(rec)
            f.write(json.dumps(rec) + "\n")
    return answers


def _answer_anyres(agent, image: np.ndarray, question: str) -> str:
    from streamvln_tpu_torch.data import chatml
    from streamvln_tpu_torch.models import anyres

    ids, _ = chatml.tokenize_dialogue(
        agent.tok, [("user", "<image>\n" + question)], add_system=True,
        with_labels=False)
    ids = np.concatenate([ids, np.asarray(
        chatml.generation_prompt(agent.tok), np.int32)])
    engine = agent.engine
    toks = anyres.generate_anyres(
        engine.params, agent.cfg, agent.tok, image, ids,
        max_new=engine.max_new, stop_ids=engine.stop_ids)
    return agent.tok.decode(toks)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", default=None)
    p.add_argument("--model_size", default="7b")
    p.add_argument("--question_file", required=True)
    p.add_argument("--media_root", default="")
    p.add_argument("--answers_file", default="answers.jsonl")
    p.add_argument("--num_frames_qa", type=int, default=8)
    p.add_argument("--max_entries", type=int, default=None)
    p.add_argument("--image_aspect_ratio", default="square",
                   choices=["square", "anyres"],
                   help="anyres: single images go through the tiled "
                        "encode + spatial_unpad merge")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    args = p.parse_args(argv)

    from streamvln_tpu_torch.eval_cli import build_agent
    agent = build_agent(args.model_path, args.model_size,
                        device=args.device)
    with open(args.question_file) as f:
        entries = json.load(f) if args.question_file.endswith(".json") \
            else [json.loads(line) for line in f]
    answers = run_offline_eval(agent, entries, args.media_root,
                               args.answers_file, args.num_frames_qa,
                               args.max_entries,
                               image_aspect_ratio=args.image_aspect_ratio)
    print(json.dumps({"answered": len(answers)}))
    return answers


if __name__ == "__main__":
    main()
