"""The harness end to end at tiny_streamvln on the CPU (the port's plain
paths), with the look for a chip skipped: the robot loop, its metrics,
the reference agreeing with the program, and the check coming out false
when the timed path is broken underneath."""
import time

import pytest
import torch

from portbench.harness import cell, check, drive, spec, system, traffic
from portbench.reference import bpe, dialogue, model, weights

SEED = (1 << 32) + 12345           # past 32 bits, as the driver's are


def _bench():
    bench = spec.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    return bench


@pytest.fixture
def run(tiny_base):
    # a window of some tens of calls even on a loaded host: one that
    # completes none is not correct, by design
    def go(seconds=3.0, traced=False, control=False, seed=SEED):
        return cell.run("tiny_robot", seed, seconds, traced,
                        torch.device("cpu"), time.perf_counter(),
                        bench=_bench(), base=tiny_base, control=control)
    return go


def test_a_run_is_correct_and_reports_its_metrics(run):
    out = run()
    assert out["correct"], out["checks"]
    assert out["judged"]["tokens"] >= 16 and out["judged"]["max_gap"] < 1e-3
    assert {"call_ms_p50", "call_ms_p95", "setup_s"} <= set(out["metrics"])
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"


def test_a_traced_run_reports_per_layer_metrics(run):
    out = run(traced=True)
    assert out["correct"]
    names = set(out["metrics"])
    assert "mfu.robot" in names
    # the CPU has no device trace and no CUDA events: nothing read from
    # the device is reported
    assert not names & {"device_idle_share.robot",
                        "int4_decode_roofline.robot", "host_ms.robot",
                        "vision_ms.robot", "prefill_ms.robot",
                        "decode_ms_per_token.robot"}


def test_the_reference_follows_the_program_call_by_call(tiny_base):
    """The reference's logits at each call's last prompt position against
    the program's own prefill logits (the engine's `last_logits`), over
    two windows, the second with the <memory> call."""
    base = tiny_base
    wl = spec.workload("tiny_robot", base)
    cfg = spec.config(wl["config"], base)
    mix = spec.mix(wl["traffic"], None, base)
    dev, tok = torch.device("cpu"), bpe.Tokenizer()
    agent = system.build_agent(
        cfg, lambda: weights.make(cfg, 5, dev, torch.float32), tok, 1, dev)
    rec = drive.Recorder(agent)
    pool = traffic.frame_pool(mix, 5, dev)
    d = spec.loop("robot", base).Driver(agent, rec, traffic.episodes(mix, 5),
                                        pool, mix["call_every"])
    calls, lasts = [], []
    for _ in range(8):
        calls += d.run(count=1)
        lasts.append(agent.engine.last_logits[0].clone())
    assert calls[4]["step"] == 8            # the window with <memory>
    params = weights.make(cfg, 5, dev, torch.float32)
    wins = check.windows_of(calls, d.episodes, cfg["num_frames"])
    assert len(wins) >= 2
    k = 0
    for item in wins.values():
        segs, targets = dialogue.sequence(tok, item["win"],
                                          cfg["num_history"], 4)
        frames = sorted({f for kind, it in segs if kind == "frames"
                         for f in it})
        feat = dict(zip(frames, model.encode_frames(
            params, cfg, torch.from_numpy(pool[frames]))))
        emb = model.dialogue_embeds(params["llm"], segs, feat, dev)
        firsts = [next(p for p, _, j in targets if j == c)
                  for c in range(len(item["win"].calls))]
        (lg,), = model.decoder_logits(
            params["llm"], cfg["llm"], [emb], [torch.tensor(firsts)],
            [model.weight_view(None, 64)])
        for row in lg:
            assert torch.allclose(row, lasts[k], atol=1e-4, rtol=0)
            k += 1
    assert k == len(calls)


def test_an_altered_token_fails_the_check(monkeypatch, run):
    from streamvln_tpu_torch.streaming import engine
    real = engine._argmax

    def second_best(logits):           # the runner-up where argmax was
        return logits.topk(2, dim=-1).indices[..., 1].to(torch.int32)
    monkeypatch.setattr(engine, "_argmax", second_best)
    out = run()
    monkeypatch.setattr(engine, "_argmax", real)
    assert not out["correct"]
    assert out["checks"]["max_gap"]["value"] > \
        out["checks"]["max_gap"]["limit"]


def test_a_step_that_leaves_the_cache_unchanged_fails_the_check(
        monkeypatch, run):
    from streamvln_tpu_torch.models import qwen2
    monkeypatch.setattr(qwen2, "_append", lambda buf, new, start, rows: None)
    out = run()
    assert not out["correct"]


def test_the_control_reads_wider_gaps_than_the_program(run):
    """The control (the program's int8 path) against the f32 reference:
    at this size its gaps stand far above the program's f32 ones."""
    ok, ctl = run(seed=7), run(seed=7, control=True)
    assert ctl["judged"]["max_gap"] > 10 * max(ok["judged"]["max_gap"],
                                                1e-6)
    assert not ctl["correct"]


@pytest.mark.cuda
def test_the_harness_refuses_without_a_card():
    """On a machine without CUDA, run.py exits 2 and prints no result
    (on the card it finds one, and this reads nothing)."""
    import subprocess
    import sys
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal path is not taken")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "7b_robot_b1", "--seed", "1", "--seconds", "1"],
                       cwd=spec.ROOT, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 2 and not p.stdout.strip()
