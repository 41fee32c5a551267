"""Web chat UI for video and image conversations, the port's own copy of
``valley_tpu/serve/web_server.py``: one self-contained HTML page over the
port's stdlib HTTP layer (`serve.httpd`), talking to the port's
controller and workers, with the JAX web server's server side:

* the model list fetched from the controller (`get_model_list`);
* uploaded media saved under ``LOGDIR/serve_images/<md5>``;
* the Video and Image tabs (the active tab is the media mode, an image
  with its preprocess radio: Crop, Resize or Pad), and the conversation
  template picked per request from the model and the mode;
* the prompt built from that template and streamed from the chosen
  worker's ``/worker_generate_stream``, its answers relayed to the
  browser as ``{"text"}\\0`` chunks;
* votes and conversation records appended to ``{date}-conv.json``;
* the limits: text cut to 1536 characters, ``max_new_tokens`` at most
  1536.

The worker is read with ``urllib`` (`httpd.open_json`), not ``requests``:
a worker that cannot be reached, or that answers an HTTP error, gives
error code 3.

    python -m valley_tpu_torch.serve.web_server --port 7860 \\
        --controller-address http://localhost:21001
"""

from __future__ import annotations

import argparse
import base64
import datetime
import hashlib
import http.client
import json
import logging
import os
import time

from valley_tpu_torch.constants import LOGDIR
from valley_tpu_torch.conversation import conv_templates
from valley_tpu_torch.serve.httpd import (JsonHttpServer, iter_delimited,
                                          open_json, post_json)
from valley_tpu_torch.utils.logging import (moderation_msg, server_error_msg,
                                            violates_moderation)

logger = logging.getLogger("web_server")

PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>Valley</title>
<style>
 body{font-family:sans-serif;max-width:860px;margin:24px auto;padding:0 12px}
 #chat{border:1px solid #ccc;border-radius:8px;min-height:320px;padding:12px;
       white-space:pre-wrap}
 .turn{margin:8px 0}.role{font-weight:bold}
 textarea{width:100%;height:64px}
 .controls{display:flex;gap:8px;margin:8px 0;flex-wrap:wrap}
 button{padding:6px 14px}
 .tabbar button{border:1px solid #ccc;border-bottom:none;background:#eee;
   border-radius:6px 6px 0 0}
 .tabbar button.active{background:#fff;font-weight:bold}
 .tab{border:1px solid #ccc;border-radius:0 6px 6px 6px;padding:10px;
   margin-bottom:8px}
 .tab.hidden{display:none}
</style></head><body>
<h2>Valley — video assistant</h2>
<div class="controls">
 <label>Model <select id="model"></select></label>
 <label>Temperature <input id="temp" type="range" value="0.7" step="0.1"
   min="0" max="1" oninput="tempv.textContent=this.value">
   <span id="tempv">0.7</span></label>
 <label>Max new tokens <input id="maxtok" type="range" value="512"
   min="0" max="1024" step="64" oninput="maxtokv.textContent=this.value">
   <span id="maxtokv">512</span></label>
</div>
<div class="tabbar">
 <button id="tabbtn-video" class="active"
   onclick="setTab('video')">Video</button>
 <button id="tabbtn-image" onclick="setTab('image')">Image</button>
</div>
<div id="tab-video" class="tab">
 <input id="media-video" type="file" accept="video/mp4,video/*">
</div>
<div id="tab-image" class="tab hidden">
 <input id="media-image" type="file" accept="image/*">
 <label>Preprocess for non-square image <select id="procmode">
   <option>Crop</option><option>Resize</option><option>Pad</option>
 </select></label>
</div>
<div id="chat"></div>
<textarea id="text" placeholder="Ask about the video…"></textarea>
<div class="controls">
 <button onclick="send()">Send</button>
 <button onclick="regenerate()">&#128260; Regenerate</button>
 <button onclick="vote('upvote')">&#128077;</button>
 <button onclick="vote('downvote')">&#128078;</button>
 <button onclick="clearChat()">Clear</button>
</div>
<script>
let history = [];
let lastRequest = null;   // for regenerate: last human text + media
let mode = 'video';       // active tab = media mode (ref state.mode)
function setTab(m){
  mode = m;
  for (const t of ['video','image']){
    document.getElementById('tab-'+t).classList.toggle('hidden', t!==m);
    document.getElementById('tabbtn-'+t).classList.toggle('active', t===m);
  }
}
async function init(){
  const r = await fetch('/list_models', {method:'POST'});
  const models = (await r.json()).models;
  const sel = document.getElementById('model');
  for (const m of models){ const o=document.createElement('option');
    o.textContent=m; sel.appendChild(o); }
}
function addTurn(role, text){
  history.push([role, text]);
  render();
}
function esc(s){
  return String(s).replace(/&/g,'&amp;').replace(/</g,'&lt;')
                  .replace(/>/g,'&gt;');
}
function render(){
  const chat = document.getElementById('chat');
  chat.innerHTML = history.map(([r,t]) =>
    `<div class="turn"><span class="role">${esc(r)}:</span> ${esc(t)}</div>`
  ).join('');
  chat.scrollTop = chat.scrollHeight;
}
async function send(){
  const text = document.getElementById('text').value.slice(0, 1536);
  if (!text) return;
  document.getElementById('text').value='';
  const input = document.getElementById('media-' + mode);
  const file = input.files[0];
  let media = null, mediaType = null;
  if (file){
    media = await new Promise(res => { const fr = new FileReader();
      fr.onload = () => res(fr.result.split(',')[1]);
      fr.readAsDataURL(file); });
    mediaType = mode;
    input.value = '';
  }
  lastRequest = {text, media, mediaType};
  addTurn('Human', text);
  addTurn('Assistant', '…');
  await stream();
}
async function regenerate(){
  // parity with the reference's Regenerate button
  // (gradio_web_server_video.py:120-133): drop the last assistant reply
  // and replay the last human turn (with its media + current mode)
  if (!lastRequest || history.length < 2) return;
  history[history.length-1][1] = '…';
  render();
  await stream();
}
async function stream(){
  const payload = {
    model: document.getElementById('model').value,
    text: lastRequest.text, media: lastRequest.media,
    media_type: lastRequest.mediaType,
    image_process_mode: document.getElementById('procmode').value,
    temperature: parseFloat(document.getElementById('temp').value),
    max_new_tokens: parseInt(document.getElementById('maxtok').value),
    history: history.slice(0, -2),
  };
  const resp = await fetch('/chat_stream', {method:'POST',
    body: JSON.stringify(payload)});
  const reader = resp.body.getReader();
  const dec = new TextDecoder();
  let buf = '';
  while (true){
    const {value, done} = await reader.read();
    if (done) break;
    buf += dec.decode(value, {stream:true});
    const parts = buf.split('\\0');
    buf = parts.pop();
    for (const p of parts){ if (!p) continue;
      const data = JSON.parse(p);
      history[history.length-1][1] = data.text;
      render();
    }
  }
}
async function vote(kind){
  await fetch('/vote', {method:'POST',
    body: JSON.stringify({type:kind, history})});
}
function clearChat(){ history=[]; render(); }
init();
</script></body></html>"""


class WebServer:
    def __init__(self, controller_addr: str, conv_mode=None,
                 num_frames: int = 8):
        self.controller_addr = controller_addr
        self.conv_mode = conv_mode   # None = auto-select per request
        self.num_frames = num_frames
        os.makedirs(os.path.join(LOGDIR, "serve_images"), exist_ok=True)

    def pick_template(self, model: str, media_type) -> str:
        """Template auto-selection (`gradio_web_server_video.py:193-200`):
        a "stable" (non-"fashion") model chatting over an IMAGE picks the
        "multimodal" template, every other combination "multimodal_video".
        The reference's own registry has no "multimodal" entry (its image
        branch KeyErrors upstream), so that case falls back to
        "multimodal_video" here instead of crashing.  An explicit
        ``--conv-mode`` overrides auto-selection."""
        if self.conv_mode:
            return self.conv_mode
        name = (model or "").lower()
        if ("stable" in name and "fashion" not in name
                and media_type == "image"):
            return ("multimodal" if "multimodal" in conv_templates
                    else "multimodal_video")
        return "multimodal_video"

    def log_file(self) -> str:
        date = datetime.datetime.now().strftime("%Y-%m-%d")
        return os.path.join(LOGDIR, f"{date}-conv.json")

    def log(self, record: dict) -> None:
        record = dict(record, tstamp=round(time.time(), 4))
        with open(self.log_file(), "a") as f:
            f.write(json.dumps(record) + "\n")

    def get_model_list(self):
        post_json(self.controller_addr + "/refresh_all_workers", {})
        models = post_json(self.controller_addr + "/list_models",
                           {}).get("models", [])
        models.sort()
        return models

    def save_media(self, b64: str, suffix: str) -> str:
        raw = base64.b64decode(b64)
        name = hashlib.md5(raw).hexdigest()
        path = os.path.join(LOGDIR, "serve_images", f"{name}.{suffix}")
        if not os.path.isfile(path):
            with open(path, "wb") as f:
                f.write(raw)
        return path

    def chat_stream(self, data: dict):
        model = data.get("model", "")
        text = (data.get("text") or "")[:1536]
        media = data.get("media")
        media_type = data.get("media_type")
        history = data.get("history") or []

        if violates_moderation(text):
            # parity with the web server's moderation gate
            # (`gradio_web_server_video.py:141-148`)
            yield json.dumps({"text": moderation_msg,
                              "error_code": 1}).encode() + b"\0"
            return

        conv = conv_templates[self.pick_template(model, media_type)].copy()
        for role, message in history:
            conv.append_message(role, message)
        payload_media: dict = {}
        if media and media_type == "video":
            path = self.save_media(media, "mp4")
            payload_media["videos"] = [path]
            conv.append_message(conv.roles[0], "<video>" + text)
        elif media and media_type == "image":
            # image-process-mode parity (`gradio_web_server_video.py:
            # 354-370` radio -> `conversation.get_images`): Pad expands
            # to a square, Resize forces 224x224, Crop passes through;
            # all get the reference's aspect-bounded resize
            from io import BytesIO

            from PIL import Image

            mode = data.get("image_process_mode", "Crop")
            pil = Image.open(
                BytesIO(base64.b64decode(media))).convert("RGB")
            conv.append_message(conv.roles[0], ("<image>" + text, [pil],
                                                mode))
            payload_media["images"] = conv.get_images()
        else:
            conv.append_message(conv.roles[0], text)
        conv.append_message(conv.roles[1], None)
        prompt = conv.get_prompt()

        addr = post_json(self.controller_addr + "/get_worker_address",
                         {"model": model}).get("address", "")
        if not addr:
            yield json.dumps({"text": server_error_msg,
                              "error_code": 2}).encode() + b"\0"
            return

        params = {
            "model": model,
            "prompt": prompt,
            "temperature": float(data.get("temperature", 0.7)),
            "max_new_tokens": min(int(data.get("max_new_tokens", 512)),
                                  1536),
            "stop": conv.sep,
            **payload_media,
        }
        try:
            with open_json(addr + "/worker_generate_stream", params,
                           timeout=120) as resp:
                answer = ""
                for chunk in iter_delimited(resp):
                    payload = json.loads(chunk.decode())
                    if payload.get("error_code", 0) == 0:
                        answer = payload["text"][len(prompt):].strip()
                        yield json.dumps({"text": answer}).encode() + b"\0"
                    else:
                        yield json.dumps(payload).encode() + b"\0"
            self.log({"type": "chat", "model": model, "prompt": prompt,
                      "answer": answer})
        except (OSError, http.client.HTTPException):
            yield json.dumps({"text": server_error_msg,
                              "error_code": 3}).encode() + b"\0"


def build_app(web: WebServer) -> JsonHttpServer:
    app = JsonHttpServer()

    @app.get("/")
    def index(_data):
        return PAGE

    @app.post("/list_models")
    def list_models(_data):
        return {"models": web.get_model_list()}

    @app.post("/chat_stream")
    def chat_stream(data):
        return web.chat_stream(data)

    @app.post("/vote")
    def vote(data):
        web.log({"type": data.get("type", "vote"),
                 "history": data.get("history")})
        return {}

    return app


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--controller-address", type=str,
                        default="http://localhost:21001")
    parser.add_argument("--conv-mode", type=str, default=None,
                        help="fix the conversation template (default: "
                             "auto-select per model/media)")
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)
    web = WebServer(args.controller_address, args.conv_mode)
    app = build_app(web)
    app.host, app._port = args.host, args.port
    app.serve_forever()


if __name__ == "__main__":
    main()
