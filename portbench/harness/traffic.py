"""The one traffic generator: episodes, instructions and frames from the
seed, shaped by a mix's parameters (`portbench/traffic/<mix>.json`).

A mix names its `loop` (how the harness drives the program: the module
`portbench/loops/<loop>.py`; "robot" is one env through `VLNAgent.step`)
and the shapes:

- `episode_steps` {min, max, levels}: episode lengths in env steps. Every
  seed gets the same `levels` lengths, evenly spaced from min to max, in
  an order the seed shuffles, block after block, so seeds change the
  order of the work and not its amount.
- `instruction_words` {min, max, levels}: instruction lengths in words,
  the same way.
- `call_every`: a model call at every episode step divisible by it (the
  deployed cadence: one call per `num_future_steps` actions, set by the
  traffic and not by parsed actions, which random weights never emit).
- `frames`, `frame_hw`: a pool of frames made from the seed on the
  device; each env step shows one, drawn from the seed.
- `warmup_steps`: the length of the set-up's warm-up episodes (past the
  first <memory> call); `trace_calls`: the traced segment's length, in
  the loop's units (the robot's: calls).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterator, List

import numpy as np
import torch

# R2R-like instructions: clauses of a path through rooms (Anderson et
# al., CVPR 2018: ~29 words on average)
_VERBS = ("walk", "go", "head", "continue", "move")
_TURNS = ("turn left", "turn right", "make a left", "make a right",
          "veer left", "veer right")
_PREPS = ("past", "through", "along", "around", "toward", "into", "out of",
          "across", "between", "beside")
_PLACES = ("the kitchen", "the hallway", "the bedroom door", "the sofa",
           "the dining table", "the staircase", "the bathroom", "the rug",
           "the open doorway", "the white cabinet", "the potted plant",
           "the fireplace", "the glass door", "the bookshelf", "the desk",
           "the washing machine", "the large mirror", "the landing")
_STOPS = ("stop in front of", "wait next to", "stop at", "stop beside")


@dataclasses.dataclass
class Episode:
    index: int
    instruction: str
    length: int                # env steps
    step_frames: List[int]     # frame index shown at each step


def _levels(spec: dict) -> np.ndarray:
    return np.round(np.linspace(spec["min"], spec["max"],
                                spec["levels"])).astype(int)


def _shuffled(levels: np.ndarray, rng: np.random.Generator) -> Iterator[int]:
    while True:
        yield from (int(x) for x in rng.permutation(levels))


def instruction(rng: np.random.Generator, n_words: int) -> str:
    """An instruction of exactly n_words words, clause by clause."""
    words: List[str] = []
    while len(words) < n_words:
        kind = rng.integers(3)
        if kind == 0:
            clause = f"{_VERBS[rng.integers(len(_VERBS))]} " \
                f"{_PREPS[rng.integers(len(_PREPS))]} " \
                f"{_PLACES[rng.integers(len(_PLACES))]}"
        elif kind == 1:
            clause = f"{_TURNS[rng.integers(len(_TURNS))]} at " \
                f"{_PLACES[rng.integers(len(_PLACES))]}"
        else:
            clause = f"{_STOPS[rng.integers(len(_STOPS))]} " \
                f"{_PLACES[rng.integers(len(_PLACES))]}"
        words.extend(clause.split())
        words[-1] += "," if len(words) < n_words else ""
    words = words[:n_words]
    words[-1] = words[-1].rstrip(",")
    text = " ".join(words)
    return text[0].upper() + text[1:] + "."


def episodes(mix: dict, seed: int) -> Iterator[Episode]:
    """The endless episode queue of a mix for a seed."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32,
                                 0x7A11])
    lengths = _shuffled(_levels(mix["episode_steps"]), rng)
    words = _shuffled(_levels(mix["instruction_words"]), rng)
    for i in itertools.count():
        n = next(lengths)
        yield Episode(i, instruction(rng, next(words)), n,
                      [int(f) for f in rng.integers(mix["frames"], size=n)])


def extreme_instructions(mix: dict, seed: int) -> List[str]:
    """The shortest and the longest instruction the mix sends (for warm-up:
    together they reach every prompt bucket the mix uses)."""
    rng = np.random.default_rng(int(seed) & 0xFFFFFFFF)
    spec = mix["instruction_words"]
    return [instruction(rng, spec["min"]), instruction(rng, spec["max"])]


def frame_pool(mix: dict, seed: int, device) -> np.ndarray:
    """[frames, H, W, 3] uint8 on the host: smooth colour fields with
    texture, made on the device from the seed in a few calls."""
    n, (H, W) = mix["frames"], mix["frame_hw"]
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 7919 + 17) % (1 << 63))
    coarse = torch.rand((n, 3, H // 32, W // 32), generator=gen,
                        device=device) * 255.0
    img = torch.nn.functional.interpolate(coarse, size=(H, W),
                                          mode="bilinear",
                                          align_corners=False)
    img += torch.randn((n, 3, H, W), generator=gen, device=device) * 12.0
    img = img.clamp(0, 255).round().to(torch.uint8)
    return img.permute(0, 2, 3, 1).contiguous().cpu().numpy()
