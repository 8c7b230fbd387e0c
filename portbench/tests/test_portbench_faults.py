"""A witness, independent of the program, of why an evaluation cell
(8 env slots fed from one episode queue, waves of the slots due a call, as
`BatchedVLNEvaluator.run`) cannot be a cell yet (PERF.md, Open
questions): a batched call pads every row's
prompt to the wave's largest bucket and writes the padded prompt at each
row's cache offset, so a wave that holds a window's <memory> call (the
2,048 bucket) and a row late in its window needs more than the 4,096
slots that the evaluation command gives. The slots' windows drift apart
as episodes end at different steps, and such a wave comes on every seed
tried."""
import numpy as np

from portbench.harness import spec, traffic
from portbench.reference import bpe, dialogue

BUCKETS = (256, 512, 768, 1024, 1536, 2048, 2560, 3072, 4096)
SLOTS = 8        # the evaluation's env slots, fed from the robot's mix


def _expanded(tok, first, instruction, memory, pending):
    n = int(pending)
    for t in tok.encode(dialogue.prompt_text(first, instruction, memory)):
        n += 196 if t == tok.image_token_id else \
            1568 if t == tok.memory_token_id else 1
    return n


def first_refusal(seed: int, capacity: int = 4096, served: int = 16):
    """The first global step at which a wave's padded write overflows, or
    None within 2,000 steps."""
    mix = spec.mix("robot")
    tok, queue = bpe.Tokenizer(), traffic.episodes(mix, seed)
    slots = [[next(queue), 0, 0] for _ in range(SLOTS)]  # ep, s, kv
    for step in range(2000):
        rows = []
        for slot in slots:
            if slot[1] >= slot[0].length:
                slot[:] = [next(queue), 0, 0]
            ep, s, kv = slot
            if s % mix["call_every"] == 0:
                first = s % 32 == 0
                kv = 0 if first else kv
                n = _expanded(tok, first, ep.instruction, first and s > 0,
                              not first)
                rows.append((slot, kv, n))
        if rows:
            pad = next(b for b in BUCKETS if b >= max(n for _, _, n in rows))
            if any(kv + pad > capacity for _, kv, _ in rows):
                return step
            for slot, kv, n in rows:
                slot[2] = kv + n + served - 1
        for slot in slots:
            slot[1] += 1
    return None


def test_eight_slots_overflow_the_padded_write_on_every_seed():
    for seed in range(5):
        assert first_refusal(1_000_000_511 + seed) is not None


def test_one_robot_never_overflows():
    """The same arithmetic for one slot (the robot cells) never refuses."""
    mix = spec.mix("robot")
    tok, queue = bpe.Tokenizer(), traffic.episodes(mix, 3)
    for _ in range(30):
        ep, kv = next(queue), 0
        for s in range(0, ep.length, mix["call_every"]):
            first = s % 32 == 0
            kv = 0 if first else kv
            n = _expanded(tok, first, ep.instruction, first and s > 0,
                          not first)
            pad = next(b for b in BUCKETS if b >= n)
            assert kv + pad <= 4096
            kv += n + 15
