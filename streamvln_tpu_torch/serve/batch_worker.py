"""Continuous-batching model worker (sglang-worker capability).

The reference ships an sglang-backed worker
(llava/serve/sglang_worker.py, 237 LoC) whose point is throughput:
concurrent requests are batched through the runtime instead of
serialized. This worker batches concurrent HTTP requests onto the
StreamingEngine's env slots and serves each wave with one
engine.generate_batch: one tower pass, one prefill and one decode loop
for every row.

Protocol matches serve/model_worker.py (/worker_get_status,
/worker_generate) so the controller and web server dispatch to either
interchangeably.

A twin of `streamvln_tpu/serve/batch_worker.py` over the port's engine
(`eval_cli.build_agent(n_envs=...)`, on the card unless --device says
otherwise). All device work runs on the one batcher thread; a wave of
fewer requests than env slots runs at the engine's full batch with the
other rows idle (they keep their KV lengths, shadow and feature slots).
"""
from __future__ import annotations

import argparse
import base64
import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np


class _Pending:
    __slots__ = ("prompt", "rgb", "max_new", "temperature", "top_p",
                 "done", "result")

    def __init__(self, prompt: str, rgb: np.ndarray,
                 max_new: Optional[int] = None,
                 temperature: Optional[float] = None,
                 top_p: Optional[float] = None):
        self.prompt = prompt
        self.rgb = rgb
        self.max_new = max_new
        self.temperature = temperature
        self.top_p = top_p
        self.done = threading.Event()
        self.result: Optional[dict] = None


class BatchedWorker:
    """Queue + batcher thread over a multi-env VLNAgent/engine."""

    def __init__(self, agent, tokenizer, model_name: str,
                 max_wait_ms: float = 15.0):
        self.agent = agent
        self.engine = agent.engine
        self.tok = tokenizer
        self.model_name = model_name
        self.n_envs = self.engine.n_envs
        self.max_wait_s = max_wait_ms / 1e3
        self.requests: "queue.Queue[_Pending]" = queue.Queue()
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def status(self) -> dict:
        return {"model_names": [self.model_name],
                "speed": self.n_envs,
                "queue_length": self.requests.qsize()}

    def stop(self):
        self._stop.set()
        self.thread.join(timeout=5)

    # -- client side ----------------------------------------------------
    def generate(self, prompt: str, image_b64: Optional[str] = None,
                 max_new_tokens: Optional[int] = None,
                 temperature: Optional[float] = None,
                 top_p: Optional[float] = None) -> dict:
        if image_b64 is not None:
            from PIL import Image
            rgb = np.asarray(Image.open(io.BytesIO(
                base64.b64decode(image_b64))).convert("RGB"))
        else:
            rgb = np.zeros((384, 384, 3), np.uint8)
        pend = _Pending(prompt, rgb, max_new_tokens, temperature, top_p)
        self.requests.put(pend)
        pend.done.wait()
        return pend.result

    # -- batcher --------------------------------------------------------
    def _drain_wave(self) -> List[_Pending]:
        try:
            first = self.requests.get(timeout=0.1)
        except queue.Empty:
            return []
        wave = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(wave) < self.n_envs:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                wave.append(self.requests.get(timeout=remaining))
            except queue.Empty:
                break
        return wave

    def _loop(self):
        while not self._stop.is_set():
            wave = self._drain_wave()
            if not wave:
                continue
            try:
                engine_reqs = []
                # coalesced rows may carry different sampling params —
                # pass per-env dicts (engine._sample_params rows them)
                temps, tops = {}, {}
                for slot, pend in enumerate(wave):
                    self.agent.reset_memory(slot)
                    req = self.agent.prepare_model_step(
                        slot, pend.rgb, pend.prompt)
                    engine_reqs.append(req["request"])
                    if pend.temperature is not None:
                        temps[slot] = float(pend.temperature)
                    if pend.top_p is not None:
                        tops[slot] = float(pend.top_p)
                outs = self.engine.generate_batch(
                    engine_reqs,
                    temperature=temps or None, top_p=tops or None)
                for slot, pend in enumerate(wave):
                    self.agent.finish_model_step(slot)
                    toks = outs[slot]
                    # the engine's compiled decode budget is fixed;
                    # honor smaller per-request budgets by truncation
                    if pend.max_new is not None:
                        toks = toks[:int(pend.max_new)]
                    text = self.tok.decode(toks)
                    # echo the engine's compiled decode ceiling so
                    # clients can tell when a larger request budget was
                    # silently capped (ADVICE r2)
                    pend.result = {"text": text, "error_code": 0,
                                   "batch_size": len(wave),
                                   "max_new_tokens_cap":
                                       self.engine.max_new}
                    pend.done.set()
            except Exception as e:  # noqa: BLE001 — report to clients
                for pend in wave:
                    if not pend.done.is_set():
                        pend.result = {"text": "", "error_code": 1,
                                       "error": str(e)}
                        pend.done.set()


def make_handler(worker: BatchedWorker):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _reply(self, payload, code=200):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            try:
                data = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError:
                self._reply({"error": "bad json"}, 400)
                return
            if self.path == "/worker_get_status":
                self._reply(worker.status())
            elif self.path == "/worker_generate":
                self._reply(worker.generate(
                    data.get("prompt", ""), data.get("image_b64"),
                    data.get("max_new_tokens"),
                    data.get("temperature"), data.get("top_p")))
            else:
                self._reply({"error": "unknown route"}, 404)

    return Handler


def serve_batch_worker(worker: BatchedWorker, host="127.0.0.1",
                       port=21003):
    return ThreadingHTTPServer((host, port), make_handler(worker))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model_path", default=None)
    ap.add_argument("--model_size", default="7b")
    ap.add_argument("--model-name", default="streamvln-tpu-batched")
    ap.add_argument("--n-envs", type=int, default=8)
    # loopback by default: unauthenticated endpoint that decodes
    # client-supplied base64 images — expose deliberately with
    # --host 0.0.0.0 behind a trusted network only
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=21003)
    ap.add_argument("--device", type=str, default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    from streamvln_tpu_torch.eval_cli import build_agent
    agent = build_agent(args.model_path, args.model_size,
                        n_envs=args.n_envs, device=args.device)
    worker = BatchedWorker(agent, agent.tok, args.model_name)
    srv = serve_batch_worker(worker, args.host, args.port)
    print(f"batched worker on http://{args.host}:{args.port}")
    srv.serve_forever()


if __name__ == "__main__":
    main()
