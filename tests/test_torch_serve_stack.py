"""The port's serve stack against the JAX package's on the CPU: the
controller's registry and dispatch (shortest queue, seeded lottery,
expiry, its HTTP routes), ModelWorker.generate and generate_stream token
for token with the JAX worker's (a greedy request of 3x max_new, so the
stream is one generate and two continue_decode chunks), a BatchedWorker
wave of 3 requests on 4 env slots driven without timing and equal to the
JAX worker's row for row (greedy, then with a temperature on one slot:
the greedy rows still equal JAX's, the sampled one is the engine's seeded
draw), the heartbeat, the web server's /chat proxy and moderation gate,
and the CLI's single-turn, streamed and interactive modes.

Both packages get tiny_streamvln in float32 with the JAX init's weights
carried across and agents with random conjunctions drawn from their own
default_rng(0), so their prompts line up call for call.
"""
import base64
import io
import json
import random
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamvln_tpu.agent import VLNAgent as JaxAgent
from streamvln_tpu.configs import tiny_streamvln as jax_tiny
from streamvln_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from streamvln_tpu.models import streamvln as jsv
from streamvln_tpu.serve import batch_worker as jbw
from streamvln_tpu.serve import controller as jctrl
from streamvln_tpu.serve import model_worker as jmw
from streamvln_tpu.streaming.engine import StreamingEngine as JaxEngine
from streamvln_tpu_torch.agent import VLNAgent
from streamvln_tpu_torch.configs import tiny_streamvln
from streamvln_tpu_torch.data.tokenizer import ByteTokenizer
from streamvln_tpu_torch.serve import batch_worker as tbw
from streamvln_tpu_torch.serve import controller as tctrl
from streamvln_tpu_torch.serve import model_worker as tmw
from streamvln_tpu_torch.serve import moderation
from streamvln_tpu_torch.serve.web_server import serve_web
from streamvln_tpu_torch.streaming.engine import StreamingEngine
from streamvln_tpu_torch.weights import from_jax_params

TIMEOUT = 120


def _post(url, payload, timeout=TIMEOUT):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def _start(server):
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return f"http://127.0.0.1:{server.server_address[1]}", thread


def _stop(server, thread):
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _png_b64(seed, shape=(48, 64, 3)):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(seed).integers(
        0, 256, shape, np.uint8)).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


# -- controller ------------------------------------------------------------

def _controller_decisions(mod, method):
    ctrl = mod.Controller(method)
    for name, models, speed, q in (("http://a", ["m"], 1.0, 3),
                                   ("http://b", ["m", "x"], 2.5, 1),
                                   ("http://c", ["m"], 0.5, 0),
                                   ("http://d", ["x"], 1.0, 0)):
        ctrl.register_worker(name, True, {"model_names": models,
                                          "speed": speed,
                                          "queue_length": q})
    random.seed(0)
    picks = [ctrl.get_worker_address(m) for m in ["m"] * 40 + ["x"] * 10]
    ctrl.heartbeat("http://b", 0)
    picks += [ctrl.get_worker_address("m") for _ in range(5)]
    picks.append(ctrl.heartbeat("http://nobody", 1))
    ctrl.workers["http://c"].last_heart_beat -= 1000
    picks.append(ctrl.get_worker_address("missing"))
    queues = {n: w.queue_length for n, w in ctrl.workers.items()}
    return picks, ctrl.list_models(), queues


@pytest.mark.parametrize("method", ["shortest_queue", "lottery"])
def test_controller_decisions_match_jax(method):
    """The same registrations, heartbeats and 55 dispatches under
    random.seed(0): the same workers picked, queues and expiries."""
    got = _controller_decisions(tctrl, method)
    assert got == _controller_decisions(jctrl, method)
    picks, _, queues = got
    assert "http://c" not in queues           # expired
    if method == "lottery":                   # the draw spreads the load
        assert len(set(picks[:40])) >= 2


def test_controller_http_routes_match_jax():
    """The same request sequence through both controllers' handlers gives
    the same replies (heart-beat times aside)."""
    replies = []
    for mod in (jctrl, tctrl):
        srv = mod.serve_controller(mod.Controller(), "127.0.0.1", 0)
        url, thread = _start(srv)
        out = []
        try:
            out.append(_post(url + "/register_worker", {
                "worker_name": "http://w1", "check_heart_beat": True,
                "worker_status": {"model_names": ["m"], "queue_length": 2}}))
            out.append(_post(url + "/register_worker", {
                "worker_name": "http://w2",
                "worker_status": {"model_names": ["m", "n"]}}))
            out.append(_post(url + "/receive_heart_beat",
                             {"worker_name": "http://w1", "queue_length": 0}))
            out.append(_post(url + "/receive_heart_beat",
                             {"worker_name": "http://w9"}))
            out.append(_post(url + "/list_models", {}))
            out.append(_post(url + "/get_worker_address", {"model": "m"}))
            out.append(_post(url + "/get_worker_address", {"model": "q"}))
            out.append(_post(url + "/refresh_all_workers", {}))
            workers = _post(url + "/list_workers", {})["workers"]
            out.append({n: {k: v for k, v in w.items()
                            if k != "last_heart_beat"}
                        for n, w in workers.items()})
            for path, body, code in (("/nope", b"{}", 404),
                                     ("/list_models", b"{bad", 400)):
                req = urllib.request.Request(url + path, data=body)
                with pytest.raises(urllib.error.HTTPError) as e:
                    urllib.request.urlopen(req, timeout=TIMEOUT)
                out.append(e.value.code == code)
        finally:
            _stop(srv, thread)
        replies.append(out)
    assert replies[1] == replies[0]
    assert replies[1][5] == {"address": "http://w1"}


# -- workers against JAX ---------------------------------------------------

@pytest.fixture(scope="module")
def params():
    jp = jax.tree.map(np.asarray, jsv.init(jax.random.PRNGKey(0),
                                           jax_tiny()))
    return jp, from_jax_params(jp, tiny_streamvln(), device="cpu")


def _agents(params, n_envs=1, max_new=4, stop=None, spec=6):
    jp, tp = params
    tok = ByteTokenizer()
    kw = dict(n_envs=n_envs, max_new_tokens=max_new, cache_capacity=2048,
              buckets=(512, 768, 1024), spec_lookup=spec,
              stop_ids=(tok.im_end_id,) if stop is None else stop)
    je = JaxEngine(jp, jax_tiny(), compute_dtype=jnp.float32, **kw)
    te = StreamingEngine(tp, tiny_streamvln(), compute_dtype=torch.float32,
                         device="cpu", **kw)
    return (JaxAgent(je, JaxByteTokenizer(), deterministic_conjunction=False),
            VLNAgent(te, tok, deterministic_conjunction=False))


def _record_tokens(engine):
    """Every token list the engine hands back (calls and chunks)."""
    seen = []
    collect, cont = engine.collect, engine.continue_decode

    def collect_rec(handle):
        out = collect(handle)
        seen.append({int(k): list(v) for k, v in out.items()})
        return out

    def cont_rec(env, **kw):
        out = cont(env, **kw)
        seen.append(list(out))
        return out
    engine.collect, engine.continue_decode = collect_rec, cont_rec
    return seen


def test_model_worker_generate_and_stream_match_jax(params):
    """generate() twice (an image, then none) and generate_stream() of a
    greedy request of 3 x max_new with no stop id: one generate and two
    continue_decode chunks; every chunk's text and every token list equal
    the JAX worker's, and each chunk extends the one before."""
    ja, ta = _agents(params, stop=())
    out = {}
    for name, agent, mod in (("jax", ja, jmw), ("port", ta, tmw)):
        seen = _record_tokens(agent.engine)
        w = mod.ModelWorker(agent, agent.tok, "tiny")
        gens = [w.generate("walk to the kitchen", _png_b64(1)),
                w.generate("turn left")]
        chunks = list(w.generate_stream("go forward", _png_b64(2),
                                        max_new_tokens=12))
        out[name] = (gens, chunks, seen, agent.engine.envs[0].kv_length)
    (jg, jc, js, jk), (tg, tc, ts, tk) = out["jax"], out["port"]
    strip = [{k: v for k, v in g.items() if k != "generate_time"}
             for g in tg]
    assert strip == [{k: v for k, v in g.items() if k != "generate_time"}
                     for g in jg]
    assert all(g["error_code"] == 0 for g in tg)
    assert ts == js and tk == jk
    assert tc == jc
    assert len(tc) == 3 and [len(ts[-3][0]), len(ts[-2]), len(ts[-1])] \
        == [4, 4, 4]
    texts = [c["text"] for c in tc]
    assert all(b.startswith(a) for a, b in zip(texts, texts[1:]))


def test_model_worker_stream_over_http_and_heartbeat(params, monkeypatch):
    """The \\0-delimited /worker_generate_stream route carries the same
    chunks as the generator API; the worker registers with a controller and
    its heartbeat reaches it; /worker_get_status reports the worker."""
    _, ta = _agents(params, stop=())
    ctrl = tctrl.Controller()
    c_srv = tctrl.serve_controller(ctrl, "127.0.0.1", 0)
    c_url, c_thread = _start(c_srv)
    w = tmw.ModelWorker(ta, ta.tok, "tiny", controller_addr=c_url)
    w_srv = tmw.serve_worker(w, "127.0.0.1", 0)
    w_url, w_thread = _start(w_srv)
    w.worker_addr = w_url
    monkeypatch.setattr(tmw, "HEARTBEAT_INTERVAL_S", 0.05)
    try:
        w.register()
        assert list(ctrl.workers) == [w_url]
        t0 = ctrl.workers[w_url].last_heart_beat
        ctrl.workers[w_url].queue_length = 7
        w.start_heartbeat()
        deadline = time.monotonic() + 30
        while ctrl.workers[w_url].queue_length and \
                time.monotonic() < deadline:
            time.sleep(0.02)
        assert ctrl.workers[w_url].queue_length == 0
        assert ctrl.workers[w_url].last_heart_beat > t0
        assert _post(w_url + "/worker_get_status", {}) == {
            "model_names": ["tiny"], "speed": 1.0, "queue_length": 0}
        ta.rng = np.random.default_rng(0)
        want = list(w.generate_stream("go forward", max_new_tokens=12))
        ta.rng = np.random.default_rng(0)
        req = urllib.request.Request(
            w_url + "/worker_generate_stream",
            data=json.dumps({"prompt": "go forward",
                             "max_new_tokens": 12}).encode())
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            parts = [json.loads(p) for p in r.read().split(b"\0") if p]
        assert len(parts) == 3 and parts == want
    finally:
        monkeypatch.setattr(tmw, "HEARTBEAT_INTERVAL_S", 30.0)
        _stop(w_srv, w_thread)
        _stop(c_srv, c_thread)


class _OneWave:
    """A stop event that lets the batcher loop run exactly one wave."""

    def __init__(self):
        self.n = 0

    def is_set(self):
        self.n += 1
        return self.n > 1

    def set(self):
        pass


def _one_wave(mod, agent, reqs):
    """Queue every request, then run one turn of the batcher loop in this
    thread: the wave drains the queued requests at once (no timing)."""
    worker = mod.BatchedWorker(agent, agent.tok, "tiny-batched",
                               max_wait_ms=300.0)
    worker.stop()
    assert not worker.thread.is_alive()
    pends = []
    for prompt, img, max_new, temp, top_p in reqs:
        from PIL import Image
        rgb = np.asarray(Image.open(io.BytesIO(base64.b64decode(img)))
                         .convert("RGB"))
        pends.append(mod._Pending(prompt, rgb, max_new, temp, top_p))
        worker.requests.put(pends[-1])
    kwargs = []
    gb = agent.engine.generate_batch

    def rec(requests, **kw):
        kwargs.append(kw)
        return gb(requests, **kw)
    agent.engine.generate_batch = rec
    worker._stop = _OneWave()
    worker._loop()
    agent.engine.generate_batch = gb
    assert all(p.done.is_set() for p in pends)
    return [p.result for p in pends], kwargs


def test_batched_worker_wave_matches_jax(params):
    """3 requests on 4 env slots (one idle row): the JAX and the port
    worker serve them in one wave of batch_size 3 with the same texts and
    tokens row for row, a per-request max_new_tokens truncates its row, and
    the idle row keeps its length. A second wave with temperature 0.7 /
    top-p 0.9 on slot 1 passes the per-slot dicts to the engine; its greedy
    rows still equal JAX's (the greedy gate per row), and the sampled row
    is the engine's seeded draw, not the greedy text."""
    ja, ta = _agents(params, n_envs=4)
    greedy = [("walk to the kitchen", _png_b64(3), None, None, None),
              ("turn around", _png_b64(4), 2, None, None),
              ("stop at the door", _png_b64(5), None, None, None)]
    sampled = [greedy[0], ("turn around", _png_b64(4), None, 0.7, 0.9),
               greedy[2]]
    out = {}
    for name, agent, mod in (("jax", ja, jbw), ("port", ta, tbw)):
        seen = _record_tokens(agent.engine)
        r1, k1 = _one_wave(mod, agent, greedy)
        r2, k2 = _one_wave(mod, agent, sampled)
        out[name] = (r1, k1, r2, k2, seen,
                     np.asarray(agent.engine.cache.length).tolist())
    (jr1, jk1, jr2, jk2, js, jl), (tr1, tk1, tr2, tk2, ts, tl) = \
        out["jax"], out["port"]
    assert tr1 == jr1 and ts[0] == js[0] and tk1 == jk1
    assert [r["batch_size"] for r in tr1] == [3, 3, 3]
    assert all(r["error_code"] == 0 and r["max_new_tokens_cap"] == 4
               for r in tr1)
    assert len(ts[0][1]) == 4 and tr1[1]["text"] == \
        ta.tok.decode(ts[0][1][:2])
    assert tk2 == jk2 == [{"temperature": {1: 0.7}, "top_p": {1: 0.9}}]
    assert [tr2[i] for i in (0, 2)] == [jr2[i] for i in (0, 2)]
    assert [ts[1][i] for i in (0, 2)] == [js[1][i] for i in (0, 2)]
    assert ts[1][1] != ts[0][1]
    assert tl[3] == jl[3] == 0


def test_batched_worker_http_coalesces(params):
    """Concurrent /worker_generate posts through the batcher thread: every
    reply is served, and those that met in one wave report its size."""
    _, ta = _agents(params, n_envs=4)
    worker = tbw.BatchedWorker(ta, ta.tok, "tiny-batched",
                               max_wait_ms=500.0)
    srv = tbw.serve_batch_worker(worker, "127.0.0.1", 0)
    url, thread = _start(srv)
    try:
        assert _post(url + "/worker_get_status", {})["model_names"] == \
            ["tiny-batched"]
        results = [None] * 3

        def call(i):
            results[i] = _post(url + "/worker_generate",
                               {"prompt": f"instruction {i}",
                                "image_b64": _png_b64(10 + i)})
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
            assert not t.is_alive()
        assert all(r["error_code"] == 0 for r in results)
        assert max(r["batch_size"] for r in results) >= 2
    finally:
        _stop(srv, thread)
        worker.stop()
        assert not worker.thread.is_alive()


# -- web server and CLI ----------------------------------------------------

def test_web_server_chat_proxy_and_moderation(params):
    """browser -> web server -> controller -> worker: the page, the model
    list, /api/chat (the worker's reply), /api/chat_stream (its chunks),
    a model with no worker (error 2) and the --moderate gate (error 3)."""
    _, ta = _agents(params)
    ctrl = tctrl.Controller()
    c_srv = tctrl.serve_controller(ctrl, "127.0.0.1", 0)
    c_url, c_thread = _start(c_srv)
    w = tmw.ModelWorker(ta, ta.tok, "tiny", controller_addr=c_url)
    w_srv = tmw.serve_worker(w, "127.0.0.1", 0)
    w.worker_addr, w_thread = _start(w_srv)
    w.register()
    web = serve_web(c_url, "127.0.0.1", 0, moderate=True)
    web_url, web_thread = _start(web)
    # the hook decides: no request may reach an outside moderation service
    moderation.set_moderator(lambda t: "bad" in t)
    try:
        with urllib.request.urlopen(web_url + "/", timeout=TIMEOUT) as r:
            assert "StreamVLN chat" in r.read().decode()
        assert _post(web_url + "/api/models", {}) == {"models": ["tiny"]}
        out = _post(web_url + "/api/chat", {"model": "tiny",
                                            "prompt": "walk on",
                                            "image_b64": _png_b64(6)})
        assert out["error_code"] == 0 and isinstance(out["actions"], list)
        assert _post(web_url + "/api/chat", {"model": "nope", "prompt": "x"}
                     )["error_code"] == 2
        req = urllib.request.Request(
            web_url + "/api/chat_stream",
            data=json.dumps({"model": "tiny", "prompt": "walk on",
                             "max_new_tokens": 8}).encode())
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            parts = [json.loads(p) for p in r.read().split(b"\0") if p]
        assert parts and all(p["error_code"] == 0 for p in parts)
        assert _post(web_url + "/api/chat", {"model": "tiny",
                                             "prompt": "a bad prompt"}
                     )["error_code"] == 3
    finally:
        moderation.set_moderator(None)
        for s, t in ((web, web_thread), (w_srv, w_thread),
                     (c_srv, c_thread)):
            _stop(s, t)


def test_moderation_fails_open_without_a_key(monkeypatch):
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    assert moderation.violates_moderation("anything") is False


@pytest.mark.parametrize("extra", [[], ["--stream", "--stream_budget",
                                        "24"]])
def test_cli_single_turn(capsys, extra):
    from streamvln_tpu_torch.serve import cli
    cli.main(["--model_size", "tiny", "--device", "cpu",
              "--instruction", "walk to the door"] + extra)
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert isinstance(rec["actions"], list) and rec["actions"]
    if not extra:
        assert "generate_s" in rec and isinstance(rec["text"], str)


def test_cli_interactive_reset_and_exit(capsys, monkeypatch):
    from streamvln_tpu_torch.serve import cli
    monkeypatch.setattr("sys.stdin", io.StringIO(
        "go forward\nreset\n\nturn left\nexit\nnever read\n"))
    cli.main(["--model_size", "tiny", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "(dialogue reset)" in out
    assert out.count('"actions"') == 2


def test_serve_entry_points_refuse_a_checkpoint(tmp_path):
    """A --model_path holding a checkpoint that cannot be read raises in
    every serve main that builds an agent: no random weights are made in
    its place."""
    from streamvln_tpu_torch.serve import batch_worker, cli, http_server, \
        model_worker
    (tmp_path / "model.safetensors").write_bytes(b"")
    for main in (http_server.main, model_worker.main, batch_worker.main,
                 cli.main):
        with pytest.raises(ValueError, match="not a safetensors file"):
            main(["--model_path", str(tmp_path), "--device", "cpu"])
