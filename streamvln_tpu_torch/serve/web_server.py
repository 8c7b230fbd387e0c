"""Web chat UI: the reference gradio server's capability on stdlib HTTP.

Capability parity with llava/serve/gradio_web_server.py (442 LoC,
gradio): model selector fed from the controller registry, image-upload
chat, generation parameters, worker dispatch via the controller. Here
it is a single-page HTML/JS app served by ThreadingHTTPServer plus two
JSON proxy routes — no external UI framework (this image has no
gradio), same serving topology:

    browser -> web_server -> controller (/list_models,
    /get_worker_address) -> model worker (/worker_generate)

Routes:
- GET  /            -> chat page (inline HTML/JS)
- POST /api/models  {} -> {models: [...]}
- POST /api/chat    {model, prompt, image_b64?, max_new_tokens?}
                    -> worker_generate response

A copy of `streamvln_tpu/serve/web_server.py` (it holds no model), with
the port's moderation hook.
"""
from __future__ import annotations

import argparse
import json
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>StreamVLN chat</title>
<style>
 body{font-family:sans-serif;max-width:760px;margin:2em auto;padding:0 1em}
 #log{border:1px solid #ccc;border-radius:6px;min-height:260px;
      padding:1em;white-space:pre-wrap}
 .u{color:#06c}.a{color:#151}.err{color:#b00}
 textarea{width:100%;box-sizing:border-box}
 .row{display:flex;gap:.5em;margin:.5em 0;align-items:center}
</style></head><body>
<h2>StreamVLN chat</h2>
<div class="row">
 <label>Model <select id="model"></select></label>
 <label>Max new tokens <input id="mnt" type="number" value="64"
  style="width:5em"></label>
 <label>Temperature <input id="temp" type="number" value="0" min="0"
  max="2" step="0.1" style="width:4em"></label>
 <label>Top-p <input id="topp" type="number" value="1" min="0" max="1"
  step="0.05" style="width:4em"></label>
 <label>Image <input id="img" type="file" accept="image/*"></label>
</div>
<div id="log"></div>
<div class="row">
 <textarea id="prompt" rows="2"
  placeholder="Instruction or question"></textarea>
 <button id="send">Send</button>
</div>
<script>
async function refreshModels(){
  const r = await fetch('/api/models',{method:'POST',body:'{}'});
  const d = await r.json();
  const sel = document.getElementById('model');
  sel.innerHTML='';
  (d.models||[]).forEach(m=>{
    const o=document.createElement('option');o.textContent=m;
    sel.appendChild(o);});
}
function log(cls, text){
  const el=document.getElementById('log');
  const d=document.createElement('div');d.className=cls;
  d.textContent=text;el.appendChild(d);el.scrollTop=el.scrollHeight;
}
async function send(){
  const prompt=document.getElementById('prompt').value;
  if(!prompt)return;
  log('u','user: '+prompt);
  const body={model:document.getElementById('model').value,
              prompt:prompt,
              max_new_tokens:+document.getElementById('mnt').value,
              temperature:+document.getElementById('temp').value,
              top_p:+document.getElementById('topp').value};
  const f=document.getElementById('img').files[0];
  if(f){
    body.image_b64=await new Promise(res=>{
      const rd=new FileReader();
      rd.onload=()=>res(rd.result.split(',')[1]);
      rd.readAsDataURL(f);});
  }
  const el=document.getElementById('log');
  const d=document.createElement('div');d.className='a';
  d.textContent='assistant: ';el.appendChild(d);
  const r=await fetch('/api/chat_stream',{method:'POST',
    body:JSON.stringify(body)});
  const reader=r.body.getReader();
  const dec=new TextDecoder();
  let buf='';
  while(true){
    const {done,value}=await reader.read();
    if(done)break;
    buf+=dec.decode(value,{stream:true});
    const parts=buf.split('\\0');
    buf=parts.pop();
    for(const p of parts){
      if(!p)continue;
      const c=JSON.parse(p);
      if(c.error_code){d.className='err';
        d.textContent='error: '+(c.error||c.error_code);}
      else d.textContent='assistant: '+c.text;
      el.scrollTop=el.scrollHeight;
    }
  }
  document.getElementById('prompt').value='';
}
document.getElementById('send').onclick=send;
refreshModels();
</script></body></html>
"""


def _post(url: str, payload: dict, timeout: float = 120.0) -> dict:
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def make_handler(controller_url: str, moderate: bool = False):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _reply(self, payload, code=200,
                   ctype="application/json"):
            body = payload if isinstance(payload, bytes) else \
                json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                self._reply(PAGE.encode(), ctype="text/html")
            else:
                self._reply({"error": "not found"}, 404)

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            try:
                data = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError:
                self._reply({"error": "bad json"}, 400)
                return
            try:
                if moderate and self.path in ("/api/chat",
                                              "/api/chat_stream"):
                    # reference: gradio_web_server gates on
                    # violates_moderation when --moderate is set
                    from streamvln_tpu_torch.serve.moderation import (
                        violates_moderation)
                    if violates_moderation(data.get("prompt", "")):
                        self._reply({"error_code": 3, "error":
                                     "flagged by moderation"})
                        return
                if self.path == "/api/models":
                    self._reply(_post(controller_url + "/list_models",
                                      {}))
                elif self.path == "/api/chat_stream":
                    addr = _post(controller_url
                                 + "/get_worker_address",
                                 {"model": data.get("model", "")})
                    worker = addr.get("address")
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/octet-stream")
                    self.end_headers()
                    if not worker:
                        self.wfile.write(json.dumps(
                            {"error_code": 2,
                             "error": "no worker for model"}).encode()
                            + b"\0")
                        return
                    req = urllib.request.Request(
                        worker + "/worker_generate_stream",
                        data=json.dumps({
                            "prompt": data.get("prompt", ""),
                            "image_b64": data.get("image_b64"),
                            "max_new_tokens":
                                data.get("max_new_tokens"),
                            "temperature": data.get("temperature"),
                            "top_p": data.get("top_p"),
                        }).encode(),
                        headers={"Content-Type": "application/json"})
                    with urllib.request.urlopen(req,
                                                timeout=600) as r:
                        while True:
                            # read1: forward each chunk as it arrives
                            # instead of blocking for a full buffer
                            piece = r.read1(4096) if hasattr(
                                r, "read1") else r.read(4096)
                            if not piece:
                                break
                            self.wfile.write(piece)
                            self.wfile.flush()
                elif self.path == "/api/chat":
                    addr = _post(controller_url
                                 + "/get_worker_address",
                                 {"model": data.get("model", "")})
                    worker = addr.get("address")
                    if not worker:
                        self._reply({"error_code": 2,
                                     "error": "no worker for model"})
                        return
                    self._reply(_post(worker + "/worker_generate", {
                        "prompt": data.get("prompt", ""),
                        "image_b64": data.get("image_b64"),
                        "max_new_tokens": data.get("max_new_tokens"),
                        "temperature": data.get("temperature"),
                        "top_p": data.get("top_p"),
                    }))
                else:
                    self._reply({"error": "unknown route"}, 404)
            except Exception as e:  # noqa: BLE001 — surface to client
                self._reply({"error_code": 1, "error": str(e)})

    return Handler


def serve_web(controller_url: str, host="0.0.0.0", port=7860,
              moderate: bool = False):
    return ThreadingHTTPServer((host, port),
                               make_handler(controller_url, moderate))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--controller-url",
                    default="http://localhost:10000")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--moderate", action="store_true",
                    help="gate prompts through the moderation hook "
                         "(reference: gradio_web_server --moderate)")
    args = ap.parse_args(argv)
    srv = serve_web(args.controller_url, args.host, args.port,
                    moderate=args.moderate)
    print(f"web server on http://{args.host}:{args.port}")
    srv.serve_forever()


if __name__ == "__main__":
    main()
