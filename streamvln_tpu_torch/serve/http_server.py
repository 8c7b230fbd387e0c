"""Real-world HTTP agent server.

Behavioral parity with the reference's Flask server (reference:
streamvln/http_realworld_server.py:61-182), on the stdlib http.server so
there is no web-framework dependency:

- POST /eval_vln with multipart or JSON body: a JPEG frame + json
  {"reset": bool, "instruction": optional str}
- reset=true clears the agent's episode state and starts a new run dir
- each request advances the agent num_future_steps sub-steps (model call
  on the step where the queue empties), returns {"action": [...]} —
  [0] once terminated
- arrow-text rendering of the returned action string matches the
  reference's replace table (:116-121)
- warm-up step at startup (:180)

A twin of `streamvln_tpu/serve/http_server.py` over the port's agent
(`eval_cli.build_agent`, on the card unless --device says otherwise).
Requests are handled on the server's threads; `AgentService.lock` runs
one agent step at a time, so no two threads launch device work at once
(a decode graph's capture tolerates no other CUDA work in the process).

Run: python -m streamvln_tpu_torch.serve.http_server --device cuda --port 5801
"""
from __future__ import annotations

import argparse
import io
import json
import os
import threading
from datetime import datetime
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np

ACTION_TO_TEXT = {0: "STOP", 1: "↑", 2: "←", 3: "→"}


class AgentService:
    """Holds the agent + per-run serving state (single client, like the
    reference's module-level globals)."""

    def __init__(self, agent, instruction: str, num_future_steps: int = 4,
                 run_root: str = "runs"):
        self.agent = agent
        self.instruction = instruction
        self.nfs = num_future_steps
        self.run_root = run_root
        self.lock = threading.Lock()
        self.action_seq: List[int] = []
        self.terminate = False
        self.idx = 0
        self.output_dir: Optional[str] = None
        self.total_generate_time = 0.0

    def reset(self):
        self.agent.reset_memory(0)
        self.action_seq = []
        self.terminate = False
        self.idx = 0
        self.total_generate_time = 0.0
        self.output_dir = os.path.join(
            self.run_root, "run" + datetime.now().strftime("%m-%d-%H%M%S"))
        os.makedirs(self.output_dir, exist_ok=True)

    def handle(self, rgb: np.ndarray, reset: bool,
               instruction: Optional[str] = None) -> List[int]:
        with self.lock:
            if instruction:
                self.instruction = instruction
            if reset:
                self.reset()
            self.idx += 1
            if self.terminate:
                return [0]
            for _ in range(self.nfs):
                run_model = self.agent.step_id[0] % self.nfs == 0
                actions, gen_time, _ = self.agent.step(
                    0, rgb, self.instruction, run_model=run_model)
                if gen_time > 0:
                    self.total_generate_time = gen_time
                if actions is not None:
                    self.action_seq = list(actions)
                if 0 in self.action_seq:
                    self.terminate = True
            if not self.action_seq:
                return [0]
            return list(self.action_seq)

    @staticmethod
    def action_text(actions: List[int]) -> str:
        return "".join(ACTION_TO_TEXT.get(a, "?") for a in actions)


def _parse_multipart(headers, body: bytes):
    """Minimal multipart/form-data parse: returns (image_bytes, json)."""
    ctype = headers.get("Content-Type", "")
    if "multipart/form-data" not in ctype:
        payload = json.loads(body.decode())
        img = payload.pop("image_b64", None)
        if img is not None:
            import base64
            return base64.b64decode(img), payload
        return None, payload
    boundary = ctype.split("boundary=")[-1].strip().encode()
    image_bytes, meta = None, {}
    for part in body.split(b"--" + boundary):
        if b"\r\n\r\n" not in part:
            continue
        head, _, content = part.partition(b"\r\n\r\n")
        content = content.rstrip(b"\r\n-")
        if b'name="image"' in head:
            image_bytes = content
        elif b'name="json"' in head:
            meta = json.loads(content.decode())
    return image_bytes, meta


def make_handler(service: AgentService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            if self.path != "/eval_vln":
                self.send_error(404)
                return
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            try:
                image_bytes, meta = _parse_multipart(self.headers, body)
                if image_bytes is not None:
                    from PIL import Image
                    rgb = np.asarray(
                        Image.open(io.BytesIO(image_bytes)).convert("RGB"))
                else:
                    shape = meta.get("shape", [480, 640, 3])
                    rgb = np.zeros(shape, np.uint8)
                actions = service.handle(
                    rgb, bool(meta.get("reset", False)),
                    meta.get("instruction"))
            except Exception as e:  # noqa: BLE001 — surface to client
                self.send_response(400)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(json.dumps(
                    {"error": str(e)}).encode())
                return
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            self.wfile.write(json.dumps({
                "action": actions,
                "action_text": service.action_text(actions),
            }).encode())

    return Handler


def serve(service: AgentService, host: str = "0.0.0.0", port: int = 5801):
    server = ThreadingHTTPServer((host, port), make_handler(service))
    return server


def warm_up(agent, instruction: str):
    """One model call on a black 480x640 frame, then an episode reset:
    the first call's kernel builds and graph captures happen here, not in
    a client's first request (reference :180)."""
    agent.step(0, np.zeros((480, 640, 3), np.uint8), instruction,
               run_model=True)
    agent.reset_memory(0)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--model_size", type=str, default="7b")
    p.add_argument("--num_future_steps", type=int, default=4)
    p.add_argument("--num_frames", type=int, default=32)
    p.add_argument("--num_history", type=int, default=8)
    p.add_argument("--model_max_length", type=int, default=4096)
    p.add_argument("--instruction", type=str,
                   default="Walk forward and immediately stop when you "
                           "exit the room.")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=5801)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    args = p.parse_args(argv)

    from streamvln_tpu_torch.eval_cli import build_agent
    agent = build_agent(args.model_path, args.model_size,
                        args.num_frames, args.num_future_steps,
                        args.num_history, args.model_max_length,
                        device=args.device)
    service = AgentService(agent, args.instruction,
                           args.num_future_steps)
    warm_up(agent, args.instruction)
    server = serve(service, args.host, args.port)
    print(json.dumps({"serving": f"{args.host}:{args.port}"}), flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
