"""What decides `correct`: the served tokens of a sample of the window's
dialogue windows, judged by the plain reference.

The sample (drawn from the seed) holds the window with the longest
dialogue and `windows - 1` others, among the 32-step windows whose calls
the measured window completed. Each is rebuilt by the reference from what
the benchmark sent (portbench/reference/dialogue.py) and run in one
causal f32 pass from its first position; at each served token the gap
`max(reference logits) - reference logit of the served token` is read.
A greedy token that the reference also ranks first reads 0. The largest
gap over the sample is compared with the cell's limit.

The control puts the reference itself in the program's place at the next
precision down (`reference_bits`): teacher-forced over the same
dialogues, it picks its own first token at each judged position, and that
token's gap under the judge is read. (Where the program has that path of
its own, `program_bits`, the harness runs the program with it instead and
judges its tokens as any run's.)
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench.reference import dialogue, model, weights

GROUP = 64


def windows_of(calls: List[dict], episodes: dict,
               num_frames: int) -> Dict[Tuple[int, int, int], dict]:
    """{(episode, env, window): {"win": Window, "size": tokens}} of the
    recorded calls, calls in step order."""
    out: Dict[Tuple[int, int, int], dict] = {}
    for c in sorted(calls, key=lambda c: (c["episode"], c["env"], c["step"])):
        key = (c["episode"], c["env"], c["step"] // num_frames)
        ep = episodes[c["episode"]]
        item = out.setdefault(key, {"win": dialogue.Window(
            ep.instruction, [], ep.step_frames), "size": 0})
        item["win"].calls.append(dialogue.Call(c["step"], c["frame"],
                                               c["served"]))
        item["size"] += c["prefill_len"] + len(c["served"])
    return out


def sample(wins: dict, n: int, seed: int) -> List[dialogue.Window]:
    """The windows to judge: the longest dialogue, then n - 1 drawn from
    the seed."""
    keys = sorted(wins)
    longest = max(keys, key=lambda k: wins[k]["size"])
    rest = [k for k in keys if k != longest]
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, 0xC4EC])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [wins[k]["win"] for k in [longest] + [rest[i] for i in
                                                 sorted(pick)]]


def judge(cfg: dict, seed: int, device, tok, wins: List[dialogue.Window],
          pool: np.ndarray, dtype, control_bits: Optional[int] = None
          ) -> dict:
    """The reference over `wins` with the benchmark's weights drawn again
    from the seed. Returns the largest gap of the served tokens, the
    tokens judged, and with `control_bits` the control's largest gap."""
    model.no_tf32()
    params = weights.make(cfg, seed, device, dtype)
    lc = cfg["llm"]
    side = cfg["vision"]["image_size"] // cfg["vision"]["patch_size"]
    tpf = (-(-side // cfg["spatial_pool_stride"])) ** 2
    seqs = [dialogue.sequence(tok, w, cfg["num_history"], tpf) for w in wins]
    frames = sorted({f for segs, _ in seqs for kind, items in segs
                     if kind == "frames" for f in items})
    with torch.no_grad():
        feats = model.encode_frames(params, cfg, torch.from_numpy(
            pool[frames]).to(device))
        feat = dict(zip(frames, feats))
        embeds = [model.dialogue_embeds(params["llm"], segs, feat, device)
                  for segs, _ in seqs]
        positions = [torch.tensor([p for p, _, _ in t], dtype=torch.long,
                                  device=device)
                     for _, t in seqs]
        bits = cfg["serving"]["bits"]
        views = [model.weight_view(bits if bits < 16 else None, GROUP)]
        if control_bits:
            views.append(model.weight_view(control_bits, GROUP))
        logits = model.decoder_logits(params["llm"], lc, embeds, positions,
                                      views)
    vocab = lc["vocab_size"]
    gaps, ctrl, n_bad = [], [], 0
    for d, (_, targets) in enumerate(seqs):
        lg = logits[0][d]
        toks = torch.tensor([t for _, t, _ in targets], dtype=torch.long,
                            device=device)
        ok = (toks >= 0) & (toks < vocab)
        n_bad += int((~ok).sum())
        best = lg.max(dim=-1).values
        served = lg.gather(1, toks.clamp(0, vocab - 1)[:, None])[:, 0]
        gaps.append(torch.where(ok, best - served,
                                torch.full_like(best, float("inf"))))
        if control_bits:
            pick = logits[1][d].argmax(dim=-1)
            ctrl.append(best - lg.gather(1, pick[:, None])[:, 0])
    gap = torch.cat(gaps)
    out = {"max_gap": float(gap.max()) if gap.numel() else float("inf"),
           "tokens": int(gap.numel()),
           "flips": int((gap > 0).sum()), "out_of_vocab": n_bad,
           "windows": len(wins)}
    if control_bits:
        cg = torch.cat(ctrl)
        out.update(control_max_gap=float(cg.max()),
                   control_flips=int((cg > 0).sum()))
    del params, feats, feat, embeds, logits
    return out
