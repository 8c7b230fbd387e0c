"""Model worker: text/multimodal generation behind HTTP, registered
with the controller.

Capability parity with the reference's model_worker
(reference: llava/serve/model_worker.py — status reporting, heartbeat
loop, generate endpoint), on stdlib HTTP and the streaming engine.

Endpoints (POST, JSON):
- /worker_get_status {} -> {model_names, speed, queue_length}
- /worker_generate   {prompt, image_b64?, max_new_tokens?} ->
                     {text, output_ids, error_code}
- /worker_generate_stream {prompt, ...} -> \0-delimited JSON chunks

A twin of `streamvln_tpu/serve/model_worker.py` over the port's agent
(`eval_cli.build_agent`, on the card unless --device says otherwise).
`ModelWorker.lock` runs one generation at a time: the server's threads
never launch device work together.
"""
from __future__ import annotations

import argparse
import base64
import io
import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

HEARTBEAT_INTERVAL_S = 30.0


class ModelWorker:
    def __init__(self, agent, tokenizer, model_name: str,
                 worker_addr: str = "",
                 controller_addr: Optional[str] = None):
        self.agent = agent
        self.tok = tokenizer
        self.model_name = model_name
        self.worker_addr = worker_addr
        self.controller_addr = controller_addr
        self.queue_length = 0
        self.lock = threading.Lock()
        self._hb_thread: Optional[threading.Thread] = None

    def status(self) -> dict:
        return {"model_names": [self.model_name], "speed": 1.0,
                "queue_length": self.queue_length}

    # -- controller protocol ---------------------------------------------
    def _post_controller(self, route: str, payload: dict):
        req = urllib.request.Request(
            self.controller_addr.rstrip("/") + route,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=15) as resp:
            return json.loads(resp.read().decode())

    def register(self):
        if not self.controller_addr:
            return
        self._post_controller("/register_worker", {
            "worker_name": self.worker_addr,
            "check_heart_beat": True,
            "worker_status": self.status()})

    def start_heartbeat(self):
        if not self.controller_addr:
            return

        def loop():
            while True:
                time.sleep(HEARTBEAT_INTERVAL_S)
                try:
                    self._post_controller("/receive_heart_beat", {
                        "worker_name": self.worker_addr,
                        "queue_length": self.queue_length})
                except OSError:
                    try:
                        self.register()
                    except OSError:
                        pass

        self._hb_thread = threading.Thread(target=loop, daemon=True)
        self._hb_thread.start()

    # -- generation --------------------------------------------------------
    def generate(self, prompt: str, image_b64: Optional[str] = None,
                 max_new_tokens: Optional[int] = None,
                 temperature: Optional[float] = None,
                 top_p: Optional[float] = None) -> dict:
        with self.lock:
            self.queue_length += 1
            try:
                if image_b64 is not None:
                    from PIL import Image
                    rgb = np.asarray(Image.open(io.BytesIO(
                        base64.b64decode(image_b64))).convert("RGB"))
                else:
                    rgb = np.zeros((384, 384, 3), np.uint8)
                self.agent.reset_memory(0)
                actions, gen_t, text = self.agent.step(
                    0, rgb, prompt, run_model=True,
                    temperature=temperature, top_p=top_p)
                return {"text": text, "actions": actions,
                        "generate_time": gen_t, "error_code": 0}
            except Exception as e:  # noqa: BLE001 — report to client
                return {"text": "", "error_code": 1, "error": str(e)}
            finally:
                self.queue_length -= 1

    def generate_stream(self, prompt: str,
                        image_b64: Optional[str] = None,
                        max_new_tokens: Optional[int] = None,
                        temperature: Optional[float] = None,
                        top_p: Optional[float] = None):
        """Yield cumulative-text chunk dicts (reference protocol: each
        chunk carries the full text so far,
        llava/serve/model_worker.py:126-180 generate_stream). The
        engine's decode loop is one fused device dispatch, so streaming
        = a first generate() of up to engine.max_new tokens followed by
        continue_decode() chunks until a stop token or the request
        budget."""
        with self.lock:
            self.queue_length += 1
            try:
                if image_b64 is not None:
                    from PIL import Image
                    rgb = np.asarray(Image.open(io.BytesIO(
                        base64.b64decode(image_b64))).convert("RGB"))
                else:
                    rgb = np.zeros((384, 384, 3), np.uint8)
                self.agent.reset_memory(0)
                eng = self.agent.engine
                req = self.agent.prepare_model_step(0, rgb, prompt)
                toks = eng.generate(*req["request"],
                                    temperature=temperature,
                                    top_p=top_p)
                self.agent.finish_model_step(0)
                stops = set(eng.stop_ids)
                budget = int(max_new_tokens) if max_new_tokens \
                    else 4 * eng.max_new
                all_toks = list(toks)[:budget]
                yield {"text": self.tok.decode(all_toks),
                       "error_code": 0}
                while (toks and len(all_toks) < budget
                       and all_toks[-1] not in stops):
                    toks = eng.continue_decode(0,
                                               temperature=temperature,
                                               top_p=top_p)
                    all_toks.extend(toks)
                    del all_toks[budget:]
                    if toks:
                        yield {"text": self.tok.decode(all_toks),
                               "error_code": 0}
            except Exception as e:  # noqa: BLE001 — report to client
                yield {"text": "", "error_code": 1, "error": str(e)}
            finally:
                self.queue_length -= 1


def make_handler(worker: ModelWorker):
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
            elif self.path == "/worker_generate_stream":
                # reference wire format: \0-delimited JSON chunks,
                # cumulative text, close-delimited response
                # (llava/serve/model_worker.py generate_stream)
                self.send_response(200)
                self.send_header("Content-Type",
                                 "application/octet-stream")
                self.end_headers()
                try:
                    for chunk in worker.generate_stream(
                            data.get("prompt", ""),
                            data.get("image_b64"),
                            data.get("max_new_tokens"),
                            data.get("temperature"),
                            data.get("top_p")):
                        self.wfile.write(
                            json.dumps(chunk).encode() + b"\0")
                        self.wfile.flush()
                except BrokenPipeError:
                    pass
            else:
                self._reply({"error": "unknown route"}, 404)

    return Handler


def serve_worker(worker: ModelWorker, host="0.0.0.0", port=21002):
    return ThreadingHTTPServer((host, port), make_handler(worker))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", default=None)
    p.add_argument("--model_size", default="7b")
    p.add_argument("--model_name", default="streamvln")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=21002)
    p.add_argument("--controller-address", default=None)
    p.add_argument("--worker-address", default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    args = p.parse_args(argv)

    from streamvln_tpu_torch.eval_cli import build_agent
    agent = build_agent(args.model_path, args.model_size,
                        device=args.device)
    worker = ModelWorker(
        agent, agent.tok, args.model_name,
        worker_addr=args.worker_address
        or f"http://{args.host}:{args.port}",
        controller_addr=args.controller_address)
    worker.register()
    worker.start_heartbeat()
    server = serve_worker(worker, args.host, args.port)
    print(json.dumps({"worker": f"{args.host}:{args.port}"}), flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
