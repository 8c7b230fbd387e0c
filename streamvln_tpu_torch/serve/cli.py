"""Terminal chat CLI (reference surface: llava/serve/cli.py — interactive
image + instruction chat against a loaded model).

Usage:
  python -m streamvln_tpu_torch.serve.cli --device cuda \
      [--image path.jpg] [--instruction "..."]
Interactive: type instructions; 'reset' clears the dialogue; 'exit'
quits. Non-interactive: pass --instruction for a single turn.

A twin of `streamvln_tpu/serve/cli.py` over the port's agent
(`eval_cli.build_agent`, on the card unless --device says otherwise).
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", default=None)
    p.add_argument("--model_size", default="7b")
    p.add_argument("--image", default=None)
    p.add_argument("--instruction", default=None,
                   help="single-turn mode: answer once and exit")
    p.add_argument("--num_frames", type=int, default=32)
    p.add_argument("--num_future_steps", type=int, default=4)
    p.add_argument("--num_history", type=int, default=8)
    p.add_argument("--stream", action="store_true",
                   help="print tokens as they decode (chunked via "
                        "engine.continue_decode)")
    p.add_argument("--stream_budget", type=int, default=64,
                   help="total decode budget in --stream mode")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="sampling temperature (<=0.001 is greedy, "
                        "reference serving semantics)")
    p.add_argument("--top_p", type=float, default=1.0,
                   help="nucleus sampling cutoff")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    args = p.parse_args(argv)
    sample_kw = dict(temperature=args.temperature, top_p=args.top_p)

    from streamvln_tpu_torch.eval_cli import build_agent
    agent = build_agent(args.model_path, args.model_size,
                        args.num_frames, args.num_future_steps,
                        args.num_history, device=args.device)

    if args.image:
        from PIL import Image
        rgb = np.asarray(Image.open(args.image).convert("RGB"))
    else:
        rgb = np.zeros((480, 640, 3), np.uint8)

    def one_turn(text):
        if args.stream:
            # chunked decode: print each partial as it lands
            # (reference: the serve stack's generate_stream protocol)
            from streamvln_tpu_torch.data import chatml
            eng = agent.engine
            req = agent.prepare_model_step(0, rgb, text)
            toks = eng.generate_batch([req["request"]], **sample_kw)[0]
            agent.finish_model_step(0)
            stops = set(eng.stop_ids)
            all_toks = list(toks)
            print(agent.tok.decode(all_toks), end="", flush=True)
            while (toks and len(all_toks) < args.stream_budget
                   and all_toks[-1] not in stops):
                toks = eng.continue_decode(0, **sample_kw)
                all_toks.extend(toks)
                print(agent.tok.decode(toks), end="", flush=True)
            print(flush=True)
            actions = chatml.parse_actions(
                agent.tok.decode(all_toks)) or [0]
            print(json.dumps({"actions": actions}), flush=True)
            return
        actions, gen_t, out = agent.step(0, rgb, text, run_model=True,
                                         **sample_kw)
        print(json.dumps({"text": out, "actions": actions,
                          "generate_s": round(gen_t, 3)}), flush=True)

    if args.instruction is not None:
        one_turn(args.instruction)
        return

    print("streamvln chat — type an instruction ('reset'/'exit')",
          flush=True)
    for line in sys.stdin:
        text = line.strip()
        if not text:
            continue
        if text == "exit":
            break
        if text == "reset":
            agent.reset_memory(0)
            print("(dialogue reset)", flush=True)
            continue
        one_turn(text)


if __name__ == "__main__":
    main()
