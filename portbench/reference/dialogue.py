"""The streaming dialogue of one 32-step window, rebuilt from what the
benchmark sent: the instruction, the env step of every model call, the
frames, and the tokens the program served.

The prompt follows the published StreamVLN agent (ChatML; the first call
of a window carries the system message, the navigation prompt with the
instruction and, past step 0, the memory clause with `<memory>`; every
call ends its user turn with "<conjunction><image>." and opens the
assistant turn). The last token a call served is not in the cache after
that call: it opens the next call's prefill. So the window's sequence is,
call by call, [previous call's last token] + prompt + served tokens but
the last, with `<image>` standing for the current frame's 196 tokens and
`<memory>` for the 8 history frames' 8 x 196.

A served token is judged at the position before it: the last prompt
position for a call's first token, the previous served token for the
rest.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

NAV_PROMPT = (
    "You are an autonomous navigation assistant. Your task is to "
    "<instruction>. Devise an action sequence to follow the instruction "
    "using the four actions: TURN LEFT (←) or TURN RIGHT (→) by 15 "
    "degrees, MOVE FORWARD (↑) by 25 centimeters, or STOP.")
NAV_SUFFIX = (
    " Please devise an action sequence to follow the instruction which may "
    "include turning left or right by a certain degree, moving forward by a "
    "certain distance or stopping once the task is complete.")
MEMORY_CLAUSE = " You have visited these areas <memory>."
CONJUNCTION = "you can see "
SYSTEM = "You are a helpful assistant."


@dataclasses.dataclass
class Call:
    """One model call as the benchmark saw it."""
    step: int                  # episode step of the call
    frame: int                 # frame index of the call's observation
    served: List[int]          # tokens the program returned


@dataclasses.dataclass
class Window:
    """A window's calls (in order, the first at the window's first step)
    and the frames of the episode's steps."""
    instruction: str
    calls: List[Call]
    step_frames: Sequence[int]  # frame index of each episode step


def history_steps(t0: int, num_history: int) -> List[int]:
    """Episode steps whose frames the memory shows at a window that starts
    at step t0: num_history steps from 0, spaced by t0 // num_history."""
    stride = max(t0 // num_history, 1)
    return list(range(0, t0, stride))


def prompt_text(first: bool, instruction: str, with_memory: bool) -> str:
    """The ChatML text of one call's prompt (user turn and the opened
    assistant turn)."""
    if first:
        base = NAV_PROMPT.replace("<instruction>.", instruction) + NAV_SUFFIX
        if with_memory:
            base += MEMORY_CLAUSE
        user = f"{base} {CONJUNCTION}<image>."
        head = f"<|im_start|>system\n{SYSTEM}<|im_end|>\n"
    else:
        user = f"{CONJUNCTION}<image>."
        head = ""
    return (f"{head}<|im_start|>user\n{user}<|im_end|>\n"
            f"<|im_start|>assistant\n")


def sequence(tok, win: Window, num_history: int, tokens_per_frame: int):
    """The window's sequence as a list of segments and its judged tokens.

    Segments: ("text", [ids]) or ("frames", [frame indices]), each frame
    standing for its `tokens_per_frame` pooled tokens. Returns (segments,
    targets), targets a list of (position, token, call index) over the
    expanded sequence: the token is judged by the logits at that
    position. `tok` is portbench/reference/bpe.py's Tokenizer."""
    t0 = win.calls[0].step
    hist = history_steps(t0, num_history) if t0 else []
    segs: List[Tuple[str, list]] = []
    targets: List[Tuple[int, int, int]] = []
    pos = 0

    def put(kind, items):
        nonlocal pos
        if items:
            segs.append((kind, items))
            pos += len(items) * (tokens_per_frame if kind == "frames" else 1)

    pending = None
    for j, call in enumerate(win.calls):
        ids = tok.encode(prompt_text(j == 0, win.instruction, bool(hist)))
        text: List[int] = [] if pending is None else [pending]
        for t in ids:
            if t in (tok.image_token_id, tok.memory_token_id):
                put("text", text)
                text = []
                put("frames", [call.frame] if t == tok.image_token_id else
                    [win.step_frames[s] for s in hist])
            else:
                text.append(t)
        put("text", text)
        served = [int(t) for t in call.served]
        # the first token is read off the last prompt position, each later
        # one off the served token before it
        for i, t in enumerate(served):
            targets.append((pos - 1 + i, t, j))
        put("text", served[:-1])
        pending = served[-1] if served else None
    return segs, targets
