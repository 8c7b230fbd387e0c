"""Serving controller: worker registry + dispatch.

Capability parity with the reference's serve stack controller
(reference: llava/serve/controller.py — worker registry, heartbeat
expiry, lottery / shortest-queue dispatch), on stdlib HTTP. A copy of
`streamvln_tpu/serve/controller.py`; it holds no model.

Endpoints (POST, JSON):
- /register_worker   {worker_name, check_heart_beat, worker_status}
- /receive_heart_beat {worker_name, queue_length}
- /refresh_all_workers {}
- /list_models       {} -> {models: [...]}
- /get_worker_address {model} -> {address}
- /list_workers      {} -> {workers: {...}}
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import random
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

HEARTBEAT_EXPIRY_S = 90.0


@dataclasses.dataclass
class WorkerInfo:
    models: List[str]
    speed: float
    queue_length: int
    check_heart_beat: bool
    last_heart_beat: float


class Controller:
    def __init__(self, dispatch_method: str = "shortest_queue"):
        assert dispatch_method in ("lottery", "shortest_queue")
        self.dispatch_method = dispatch_method
        self.workers: Dict[str, WorkerInfo] = {}
        self.lock = threading.Lock()

    # -- registry --------------------------------------------------------
    def register_worker(self, name: str, check_heart_beat: bool,
                        status: Optional[dict]) -> bool:
        status = status or {}
        with self.lock:
            self.workers[name] = WorkerInfo(
                models=list(status.get("model_names", [])),
                speed=float(status.get("speed", 1.0)),
                queue_length=int(status.get("queue_length", 0)),
                check_heart_beat=check_heart_beat,
                last_heart_beat=time.time())
        return True

    def heartbeat(self, name: str, queue_length: int) -> bool:
        with self.lock:
            w = self.workers.get(name)
            if w is None:
                return False
            w.queue_length = queue_length
            w.last_heart_beat = time.time()
            return True

    def expire_stale(self):
        now = time.time()
        with self.lock:
            dead = [n for n, w in self.workers.items()
                    if w.check_heart_beat
                    and now - w.last_heart_beat > HEARTBEAT_EXPIRY_S]
            for n in dead:
                del self.workers[n]

    # -- dispatch ---------------------------------------------------------
    def list_models(self) -> List[str]:
        with self.lock:
            models = set()
            for w in self.workers.values():
                models.update(w.models)
            return sorted(models)

    def get_worker_address(self, model: str) -> str:
        self.expire_stale()
        with self.lock:
            candidates = [(n, w) for n, w in self.workers.items()
                          if model in w.models]
            if not candidates:
                return ""
            if self.dispatch_method == "lottery":
                speeds = [w.speed for _, w in candidates]
                total = sum(speeds)
                r = random.random() * total
                acc = 0.0
                for (n, w), s in zip(candidates, speeds):
                    acc += s
                    if r <= acc:
                        return n
                return candidates[-1][0]
            # shortest_queue, normalized by speed
            name, w = min(candidates,
                          key=lambda nw: nw[1].queue_length
                          / max(nw[1].speed, 1e-6))
            w.queue_length += 1
            return name


def make_handler(ctrl: Controller):
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
            route = self.path
            if route == "/register_worker":
                ok = ctrl.register_worker(
                    data["worker_name"],
                    bool(data.get("check_heart_beat", True)),
                    data.get("worker_status"))
                self._reply({"exist": ok})
            elif route == "/receive_heart_beat":
                ok = ctrl.heartbeat(data["worker_name"],
                                    int(data.get("queue_length", 0)))
                self._reply({"exist": ok})
            elif route == "/refresh_all_workers":
                ctrl.expire_stale()
                self._reply({})
            elif route == "/list_models":
                self._reply({"models": ctrl.list_models()})
            elif route == "/get_worker_address":
                self._reply(
                    {"address": ctrl.get_worker_address(data["model"])})
            elif route == "/list_workers":
                with ctrl.lock:
                    self._reply({"workers": {
                        n: dataclasses.asdict(w)
                        for n, w in ctrl.workers.items()}})
            else:
                self._reply({"error": "unknown route"}, 404)

    return Handler


def serve_controller(ctrl: Controller, host="0.0.0.0", port=10000):
    return ThreadingHTTPServer((host, port), make_handler(ctrl))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=10000)
    p.add_argument("--dispatch-method", default="shortest_queue",
                   choices=["lottery", "shortest_queue"])
    args = p.parse_args(argv)
    server = serve_controller(Controller(args.dispatch_method),
                              args.host, args.port)
    print(json.dumps({"controller": f"{args.host}:{args.port}"}),
          flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
