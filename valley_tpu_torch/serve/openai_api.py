"""OpenAI-compatible chat API on the model worker (beyond-parity); the
port's own copy of ``valley_tpu/serve/openai_api.py``.

Adds ``POST /v1/chat/completions`` (JSON + SSE streaming) and
``GET /v1/models`` so off-the-shelf OpenAI clients can talk to a Valley
worker directly.  The reference serves only its own gradio wire format
(`valley/serve/model_worker.py:176-291`); this layer maps OpenAI
messages onto the same conversation template the models were trained on
(`conversation.py`) and delegates to ``ModelWorker.generate_stream`` —
so every serving mode (sessions, continuous batching, speculation,
quantization) composes with it.

Media: message ``content`` may be a list of parts; ``video_url`` /
``image_url`` parts with ``data:`` URLs (base64) attach media exactly
like the native endpoint's ``videos`` / ``images`` fields.
"""

from __future__ import annotations

import json
import time
import uuid
from typing import Iterator, List, Tuple

from valley_tpu_torch.serve.httpd import StreamResponse


def _data_url_payload(url: str) -> str:
    """'data:video/mp4;base64,AAAA' -> 'AAAA' (raw b64 passes through)."""
    if url.startswith("data:"):
        return url.split(",", 1)[1]
    return url


def _media_url(part: dict, keys: Tuple[str, ...]) -> str:
    """Media payload from an OpenAI content part.  Accepts the dict form
    (``{'video_url': {'url': ...}}``), the string form
    (``{'video_url': 'data:...'}``) and the flat form (``{'url': ...}``).
    Raises ValueError (-> HTTP 400) when no non-empty url is present,
    instead of silently queueing an empty payload that would fail as a
    confusing decode error downstream."""
    for k in keys:
        val = part.get(k)
        if isinstance(val, dict) and val.get("url"):
            return _data_url_payload(val["url"])
        if isinstance(val, str) and val:
            return _data_url_payload(val)
    raise ValueError(
        f"content part {part.get('type')!r} has no usable url")


def _flatten_messages(messages: List[dict]) -> Tuple[str, list, list]:
    """OpenAI messages -> (Valley prompt, videos, images).

    Text-only turns are allowed (unlike ``generate.build_prompt``); the
    prompt ends with ' Assistent:' so generation starts with the reply
    (the reference web server's template behavior,
    `conversation.py:211-223`)."""
    videos: list = []
    images: list = []
    parts: List[str] = []
    for m in messages:
        role = m.get("role", "user")
        content = m.get("content", "")
        if isinstance(content, list):
            texts = []
            for part in content:
                ptype = part.get("type")
                if ptype == "text":
                    texts.append(part.get("text", ""))
                elif ptype in ("video_url", "video"):
                    videos.append(_media_url(
                        part, ("video_url", "video", "url")))
                    texts.append("<video>")
                elif ptype in ("image_url", "image"):
                    images.append(_media_url(
                        part, ("image_url", "image", "url")))
                    texts.append("<image>")
                else:
                    raise ValueError(f"unsupported content part {ptype!r}")
            content = " ".join(t for t in texts if t)
        if role == "system":
            parts.append(content + "\n\n###")
        elif role in ("user", "human"):
            parts.append(" Human: " + content + " \n###")
        elif role in ("assistant", "assistent"):
            parts.append(" Assistent: " + content + " \n###")
        else:
            raise ValueError(f"unsupported role {role!r}")
    parts.append(" Assistent:")
    return "".join(parts), videos, images


def register_openai_routes(app, worker) -> None:
    @app.get("/v1/models")
    def models(_body):
        return {"object": "list",
                "data": [{"id": worker.model_name, "object": "model",
                          "created": 0, "owned_by": "valley-tpu"}]}

    @app.post("/v1/chat/completions")
    def chat_completions(body):
        try:
            prompt, videos, images = _flatten_messages(
                body.get("messages", []))
        except (ValueError, KeyError, TypeError) as e:
            return 400, {"error": {"message": str(e),
                                   "type": "invalid_request_error"}}
        params = {
            "prompt": prompt,
            "temperature": float(body.get("temperature", 1.0)),
            "top_p": float(body.get("top_p", 1.0)),
            "max_new_tokens": int(body.get("max_tokens",
                                           body.get("max_new_tokens",
                                                    256))),
            "stop": "###",
        }
        if videos:
            params["videos"] = videos
        if images:
            params["images"] = images
        if body.get("user"):
            # map OpenAI's end-user id onto session-mode KV reuse
            params["session_id"] = str(body["user"])
        rid = "chatcmpl-" + uuid.uuid4().hex[:24]
        created = int(time.time())
        model = body.get("model", worker.model_name)
        base = len(prompt)

        def chunks():
            # the gate maps crashes to error_code 1 (and maintains the
            # worker's concurrency accounting), same as the native route
            for raw in worker.generate_stream_gate(params):
                yield json.loads(raw.rstrip(b"\0").decode())

        if body.get("stream"):
            def sse() -> Iterator[bytes]:
                sent = 0
                finish = "stop"
                for c in chunks():
                    if c.get("error_code", 0) != 0:
                        finish = "error"
                        break
                    text = c["text"][base:]
                    if len(text) > sent:
                        delta = text[sent:]
                        sent = len(text)
                        payload = {
                            "id": rid, "object": "chat.completion.chunk",
                            "created": created, "model": model,
                            "choices": [{"index": 0,
                                         "delta": {"content": delta},
                                         "finish_reason": None}]}
                        yield b"data: " + json.dumps(payload).encode() \
                            + b"\n\n"
                payload = {"id": rid, "object": "chat.completion.chunk",
                           "created": created, "model": model,
                           "choices": [{"index": 0, "delta": {},
                                        "finish_reason": finish}]}
                yield b"data: " + json.dumps(payload).encode() + b"\n\n"
                yield b"data: [DONE]\n\n"

            return StreamResponse(sse(), content_type="text/event-stream")

        text, err = "", None
        for c in chunks():
            if c.get("error_code", 0) != 0:
                err = c
                break
            text = c["text"][base:]
        if err is not None:
            return 500, {"error": {"message": err.get("text", "error"),
                                   "type": "server_error",
                                   "code": err.get("error_code")}}
        text = text.strip()
        n_prompt = len(worker.tokenizer.encode(prompt))
        n_out = len(worker.tokenizer.encode(text)) if text else 0
        return {
            "id": rid, "object": "chat.completion", "created": created,
            "model": model,
            "choices": [{"index": 0,
                         "message": {"role": "assistant", "content": text},
                         "finish_reason": "stop"}],
            "usage": {"prompt_tokens": n_prompt,
                      "completion_tokens": n_out,
                      "total_tokens": n_prompt + n_out}}
