"""The port's web UI (`valley_tpu_torch/serve/web_server.py`), the rest of
its `utils/logging.py` and `utils/decode_img.py` against the JAX package's
modules on the CPU.

The web server runs against the port's controller over localhost HTTP,
beside JAX's web server on the same controller, as ``tests/test_serve.py``
runs the JAX stack.  Two workers serve it: a recording worker, which keeps
each request's parameters and streams two fixed answers, so that what
each web server sends a worker (prompt, stop, limits, media) can be
compared exactly, and a port worker of the tiny model (fp32, greedy),
whose stream the page must relay.  Every comparison here is exact: the
two packages' code is the same text in another idiom, and no arithmetic
is involved.  Each web server's ``LOGDIR`` is a directory of its own under
``tmp_path``; nothing reaches the network (the moderation call is
replaced where a key is set).
"""

import asyncio
import base64
import hashlib
import io
import json
import logging
import logging.handlers
import sys
import threading
import urllib.request

import pytest
import requests
import torch

from valley_tpu.serve import web_server as jweb
from valley_tpu.utils import decode_img as jdecode
from valley_tpu.utils import logging as jlog
from valley_tpu_torch import config as TC
from valley_tpu_torch.inference.engine import Engine
from valley_tpu_torch.models import valley
from valley_tpu_torch.serve import controller as controller_mod
from valley_tpu_torch.serve import model_worker as worker_mod
from valley_tpu_torch.serve import web_server as web
from valley_tpu_torch.serve.controller import Controller
from valley_tpu_torch.serve.httpd import (JsonHttpServer, iter_delimited,
                                          open_json, post_json)
from valley_tpu_torch.serve.model_worker import ModelWorker
from valley_tpu_torch.tokenizer import ByteFallbackTokenizer
from valley_tpu_torch.utils import decode_img
from valley_tpu_torch.utils import logging as tlog


# -- utils/logging.py ---------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda: None, lambda: threading.Semaphore(3),
    lambda: threading.Semaphore(0), lambda: asyncio.Semaphore(2),
    lambda: asyncio.Semaphore(0)],
    ids=["none", "threading3", "threading0", "asyncio2", "asyncio0"])
def test_pretty_print_semaphore_matches_jax(make):
    assert tlog.pretty_print_semaphore(make()) == \
        jlog.pretty_print_semaphore(make())


class _Answer(io.BytesIO):
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_moderation_fails_open_as_jax(monkeypatch):
    """False without ``OPENAI_API_KEY`` (and no request); with a key, the
    flag of the endpoint's answer, and False when the request fails, in
    both packages.  The endpoint is replaced: the port's ``urlopen``, JAX's
    ``requests.post``."""
    monkeypatch.delenv("OPENAI_API_KEY", raising=False)
    asked = []

    def flagged(verdict):
        def answer(req, timeout=None):
            asked.append(json.loads(req.data)["input"])
            return _Answer(json.dumps(
                {"results": [{"flagged": verdict}]}).encode())
        return answer

    def failing(*a, **k):
        raise OSError("unreachable")

    class _Resp:
        def __init__(self, verdict):
            self.verdict = verdict

        def json(self):
            return {"results": [{"flagged": self.verdict}]}

    monkeypatch.setattr(urllib.request, "urlopen", failing)
    monkeypatch.setattr(requests, "post", failing)
    for mod in (tlog, jlog):
        assert mod.violates_moderation("anything") is False
    monkeypatch.setenv("OPENAI_API_KEY", "k")
    for mod in (tlog, jlog):
        assert mod.violates_moderation("anything") is False
    for verdict in (True, False):
        monkeypatch.setattr(urllib.request, "urlopen", flagged(verdict))
        monkeypatch.setattr(requests, "post",
                            lambda *a, v=verdict, **k: _Resp(v))
        assert tlog.violates_moderation("two\nlines") is verdict
        assert jlog.violates_moderation("two\nlines") is verdict
    assert asked == ["twolines", "twolines"]
    assert tlog.moderation_msg == jlog.moderation_msg
    assert tlog.server_error_msg == jlog.server_error_msg


def _messages(path):
    with open(path) as f:
        return [line.split(" | ", 2)[-1].rstrip("\n") for line in f]


def test_get_logger_and_rank_zero_match_jax(tmp_path, caplog):
    for name, mod in (("t_port", tlog), ("t_jax", jlog)):
        log = mod.get_logger(name, str(tmp_path / f"{name}.log"))
        assert log.level == logging.INFO
        with caplog.at_level(logging.INFO):
            mod.rank_zero_info("hello world", log)
        assert any("hello world" in r.message and r.name == name
                   for r in caplog.records)
    assert _messages(tmp_path / "t_port.log") == \
        _messages(tmp_path / "t_jax.log") == ["hello world"]


def test_stream_to_logger_matches_jax(caplog):
    """Whole lines are logged at the stream's level as they complete; a
    partial line waits for its newline or for flush."""
    got = {}
    for mod in (tlog, jlog):
        name = f"stream_{mod.__name__.split('.')[0]}"
        stream = mod.StreamToLogger(logging.getLogger(name), logging.WARNING)
        with caplog.at_level(logging.INFO):
            caplog.clear()
            stream.write("one\ntw")
            stream.write("o\nthree")
            assert stream.linebuf == "three"
            stream.flush()
            stream.write("")
        got[mod] = [(r.levelno, r.message) for r in caplog.records]
        assert stream.encoding == sys.stdout.encoding   # the terminal's
    assert got[tlog] == got[jlog] == [(logging.WARNING, "one"),
                                      (logging.WARNING, "two"),
                                      (logging.WARNING, "three")]


def _detach(h):
    for item in logging.root.manager.loggerDict.values():
        if isinstance(item, logging.Logger) and h in item.handlers:
            item.removeHandler(h)
    h.close()


@pytest.fixture
def global_logging(monkeypatch):
    """`build_logger` replaces stdout and stderr, sets the root handler's
    format and adds a file handler to every logger: all put back after."""
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    monkeypatch.setattr(sys, "stderr", sys.stderr)
    root = logging.getLogger().handlers
    formatter = root[0].formatter if root else None
    for mod in (tlog, jlog):
        monkeypatch.setattr(mod, "handler", None)
    yield
    for mod in (tlog, jlog):
        if mod.handler is not None:
            _detach(mod.handler)
    if root:
        root[0].setFormatter(formatter)


def test_build_logger_matches_jax(global_logging, tmp_path):
    """The named logger at INFO, stdout and stderr redirected into the
    "stdout" (INFO) and "stderr" (ERROR) loggers, and one daily-rotating
    file of the lines of every logger that existed, in both packages."""
    lines = {}
    for mod in (tlog, jlog):
        tag = mod.__name__.split(".")[0]
        saved = sys.stdout, sys.stderr
        logging.getLogger(f"ctrl_{tag}")
        log = mod.build_logger(f"ctrl_{tag}", f"{tag}.log",
                               str(tmp_path / tag))
        try:
            assert log.level == logging.INFO
            assert isinstance(sys.stdout, mod.StreamToLogger)
            assert isinstance(sys.stderr, mod.StreamToLogger)
            assert sys.stderr.log_level == logging.ERROR
            first = mod.handler
            assert isinstance(first, logging.handlers.TimedRotatingFileHandler)
            mod.build_logger(f"ctrl_{tag}", f"{tag}.log",
                             str(tmp_path / tag))
            assert mod.handler is first        # one file handler a process
            log.info("served")
            print("printed")
        finally:
            sys.stdout, sys.stderr = saved
        _detach(mod.handler)
        lines[tag] = [ln.split(" | ", 1)[1] for ln in
                      (tmp_path / tag / f"{tag}.log").read_text()
                      .splitlines()]
    assert lines["valley_tpu_torch"] == [
        "INFO | ctrl_valley_tpu_torch | served", "INFO | stdout | printed"]
    assert lines["valley_tpu"] == [
        "INFO | ctrl_valley_tpu | served", "INFO | stdout | printed"]


def test_disable_progress_matches_jax(monkeypatch):
    import os

    for mod in (tlog, jlog):
        monkeypatch.setenv("TQDM_DISABLE", "0")
        mod.disable_progress()
        assert os.environ["TQDM_DISABLE"] == "1"


# -- utils/decode_img.py ------------------------------------------------

def _frame_b64(color):
    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGB", (8, 8), color).save(buf, format="JPEG")
    return base64.encodebytes(buf.getvalue()).decode()


@pytest.mark.parametrize("rate,limit", [(1.0, 50), (0.5, 50), (0.5, 0)])
def test_decode_img_extract_matches_jax(tmp_path, rate, limit):
    """`extract` on a dump the test writes (three records of three frames
    and their text fields, one without a frame list): the same count,
    file names and bytes as JAX's, and JAX's test case (every frame of the
    first record at rate 1)."""
    recs = [{"title": f"t{i}", "merge_ocr": "o", "gt_label": i,
             "other": "dropped",
             "video_frame": [_frame_b64((40 * i, 10 * j, 200))
                             for j in range(3)]} for i in range(3)]
    del recs[2]["video_frame"]
    src = tmp_path / "dump.jsonl"
    src.write_text("".join(json.dumps(r) + "\n" for r in recs))
    outs = {}
    for name, mod in (("port", decode_img), ("jax", jdecode)):
        out = tmp_path / name
        n = mod.extract(str(src), str(out), frame_sample_rate=rate,
                        limit=limit)
        outs[name] = (n, {p.name: p.read_bytes() for p in out.iterdir()})
    assert outs["port"] == outs["jax"]
    n, files = outs["port"]
    assert json.loads(files["0.json"]) == {"merge_ocr": "o", "title": "t0",
                                           "gt_label": 0}
    if rate == 1.0:
        assert n == 6 and sorted(f for f in files if f.startswith("0_")) \
            == ["0_0.jpg", "0_1.jpg", "0_2.jpg"]


# -- serve/web_server.py ------------------------------------------------

class Recorder:
    """A worker that keeps each request's parameters and streams the
    prompt followed by "a", then by "ab"."""

    def __init__(self):
        self.requests = []
        self.app = JsonHttpServer()
        self.app.post("/worker_get_status")(lambda _d: {
            "model_names": ["recorder"], "speed": 1, "queue_length": 0})
        self.app.post("/worker_generate_stream")(self.generate)
        self.addr = f"http://localhost:{self.app.start()}"

    def generate(self, params):
        self.requests.append(params)
        for tail in ("a", "ab"):
            yield json.dumps({"text": params["prompt"] + tail,
                              "error_code": 0}).encode() + b"\0"


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    """The port's controller with a recording worker and a port worker of
    the tiny model, the port's web server and JAX's on it, each web server
    with its own LOGDIR."""
    logdirs = {n: tmp_path_factory.mktemp(f"logdir_{n}")
               for n in ("port", "jax")}
    mp = pytest.MonkeyPatch()
    mp.setattr(web, "LOGDIR", str(logdirs["port"]))
    mp.setattr(jweb, "LOGDIR", str(logdirs["jax"]))
    ctrl = Controller("shortest_queue")
    ctrl_app = controller_mod.build_app(ctrl)
    ctrl_addr = f"http://localhost:{ctrl_app.start()}"
    rec = Recorder()
    ctrl.register_worker(rec.addr, False, None)

    tk = ByteFallbackTokenizer()
    cfg = TC.valley_tiny().replace(tokens=tk.special_tokens())
    params = valley.init_params(cfg, torch.Generator().manual_seed(0),
                                torch.float32)
    eng = Engine(cfg, params, buckets=(128,), max_new_tokens=16,
                 cache_dtype=torch.float32)
    worker = ModelWorker(ctrl_addr, "placeholder", "valley-tiny", eng, tk,
                         no_register=True, num_frames=2)
    w_app = worker_mod.build_app(worker)
    worker.worker_addr = f"http://localhost:{w_app.start()}"
    worker.register_to_controller()

    apps = {"port": web.build_app(web.WebServer(ctrl_addr)),
            "jax": jweb.build_app(jweb.WebServer(ctrl_addr))}
    addrs = {n: f"http://localhost:{a.start()}" for n, a in apps.items()}
    yield {"ctrl": ctrl, "ctrl_addr": ctrl_addr, "rec": rec,
           "worker_addr": worker.worker_addr, "web": addrs,
           "logdir": logdirs}
    for a in (ctrl_app, rec.app, w_app, *apps.values()):
        a.shutdown()
    mp.undo()


def _chat(addr, payload):
    with open_json(addr + "/chat_stream", payload, timeout=120) as r:
        return [json.loads(c) for c in iter_delimited(r)]


def _conv_records(logdir):
    files = sorted(logdir.glob("*-conv.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return [json.loads(line) for line in f]


def test_web_index_and_models(stack):
    """The page (its two tabs and preprocess radio; no TPU in its text)
    and the sorted model list, as JAX's web server lists them."""
    r = requests.get(stack["web"]["port"] + "/", timeout=10)
    assert r.status_code == 200 and b"Valley" in r.content
    assert r.headers["Content-Type"] == "text/html"
    for part in (b"tab-video", b"tab-image", b"procmode", b"/chat_stream",
                 b"/vote", b"/list_models"):
        assert part in r.content
    assert b"TPU" not in r.content
    models = {n: post_json(a + "/list_models", {})["models"]
              for n, a in stack["web"].items()}
    assert models["port"] == models["jax"] == ["recorder", "valley-tiny"]


def test_web_template_auto_selection_matches_jax():
    """The template of every model and media type, and ``--conv-mode``."""
    models = ["valley-stable-7b", "Valley-Stable-13B", "valley-fashion",
              "stable-fashion", "anything", "", None]
    for conv_mode in (None, "v1"):
        port = web.WebServer("http://localhost:1", conv_mode=conv_mode)
        jax_ = jweb.WebServer("http://localhost:1", conv_mode=conv_mode)
        for m in models:
            for media in ("video", "image", None):
                assert port.pick_template(m, media) == \
                    jax_.pick_template(m, media), (conv_mode, m, media)
                assert port.pick_template(m, media) in web.conv_templates
    assert web.WebServer("u").pick_template(
        "valley-stable-7b", "video") == "multimodal_video"


def _png_b64(size, color):
    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGB", size, color).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


VIDEO_BYTES = bytes(range(256)) * 9      # not decoded by the recorder


def _request(kind):
    history = [["Human", "hello"], ["Assistant", "hi, what can I do?"]]
    base = {"model": "recorder", "temperature": 0.2, "history": history,
            "text": "q" * 1600 + " what happens?", "max_new_tokens": 4000}
    if kind == "video":
        return dict(base, media=base64.b64encode(VIDEO_BYTES).decode(),
                    media_type="video")
    if kind.startswith("image"):
        return dict(base, media=_png_b64((96, 48), (200, 30, 30)),
                    media_type="image", image_process_mode=kind[6:])
    return dict(base, history=[], text="just text", max_new_tokens=7)


@pytest.mark.parametrize("kind", ["text", "video", "image_Crop",
                                  "image_Resize", "image_Pad"])
def test_web_request_to_worker_matches_jax(stack, kind):
    """What reaches the worker from each web server for the same page
    request: the prompt (template, history, media token, text cut at 1536
    characters), the stop, temperature and ``max_new_tokens`` (capped at
    1536), the processed images' base64 for each preprocess mode, and the
    saved video's name and bytes; the relayed chunks; the chat record."""
    rec = stack["rec"]
    got = {}
    for name, addr in stack["web"].items():
        n = len(rec.requests)
        chunks = _chat(addr, _request(kind))
        assert len(rec.requests) == n + 1
        got[name] = (chunks, dict(rec.requests[-1]))
    (pc, preq), (jc, jreq) = got["port"], got["jax"]
    assert pc == jc == [{"text": "a"}, {"text": "ab"}]
    if kind == "video":
        md5 = hashlib.md5(VIDEO_BYTES).hexdigest()
        for name, req in (("port", preq), ("jax", jreq)):
            path = req.pop("videos")[0]
            assert path == str(stack["logdir"][name] / "serve_images"
                               / f"{md5}.mp4")
            with open(path, "rb") as f:
                assert f.read() == VIDEO_BYTES
    assert preq == jreq
    assert preq["max_new_tokens"] == (7 if kind == "text" else 1536)
    if kind != "text":      # the text cut at 1536 characters
        assert "q" * 1536 in preq["prompt"]
        assert "q" * 1537 not in preq["prompt"]
        assert "what happens" not in preq["prompt"]
    if kind.startswith("image"):
        assert len(preq["images"]) == 1
    rec_port = _conv_records(stack["logdir"]["port"])[-1]
    rec_jax = _conv_records(stack["logdir"]["jax"])[-1]
    for r in (rec_port, rec_jax):
        r.pop("tstamp")
    assert rec_port == rec_jax == {"type": "chat", "model": "recorder",
                                   "prompt": preq["prompt"], "answer": "ab"}


def test_web_relays_the_port_worker(stack):
    """A greedy request through the page to the port worker of the tiny
    model: each relayed chunk is the worker's own stream of the same
    prompt with the prompt cut off, and the chat record holds both."""
    chunks = _chat(stack["web"]["port"], {
        "model": "valley-tiny", "text": "hello", "temperature": 0.0,
        "max_new_tokens": 6})
    rec = _conv_records(stack["logdir"]["port"])[-1]
    assert rec["model"] == "valley-tiny"
    with open_json(stack["worker_addr"] + "/worker_generate_stream",
                   {"model": "valley-tiny", "prompt": rec["prompt"],
                    "temperature": 0.0, "max_new_tokens": 6,
                    "stop": "###"}, timeout=120) as r:
        direct = [json.loads(c) for c in iter_delimited(r)]
    assert direct[-1]["error_code"] == 0
    assert chunks == [{"text": d["text"][len(rec["prompt"]):].strip()}
                      for d in direct]
    assert rec["answer"] == chunks[-1]["text"]


@pytest.mark.parametrize("mode", ["Crop", "Resize", "Pad"])
def test_web_image_process_modes_reach_the_port_worker(stack, mode):
    """A non-square image in each preprocess mode goes through the
    conversation's pipeline and the port worker answers it without an
    error (JAX's ``test_web_chat_stream_image_process_modes``)."""
    chunks = _chat(stack["web"]["port"], {
        "model": "valley-tiny", "text": "what color?",
        "media": _png_b64((96, 48), (200, 30, 30)), "media_type": "image",
        "image_process_mode": mode, "temperature": 0.0,
        "max_new_tokens": 4})
    assert chunks and all(c.get("error_code", 0) == 0 for c in chunks)


def test_web_error_codes_match_jax(stack, monkeypatch):
    """Error code 2 for a model no worker serves, 3 for a registered
    worker that is gone, 1 with the moderation text for a flagged input
    (the moderation endpoint replaced in both packages)."""
    stack["ctrl"].register_worker("http://localhost:1", False, {
        "model_names": ["dead"], "speed": 1, "queue_length": 0})
    try:
        for model, code in (("missing", 2), ("dead", 3)):
            got = [_chat(a, {"model": model, "text": "x"})
                   for a in stack["web"].values()]
            assert got[0] == got[1] == [{"text": tlog.server_error_msg,
                                         "error_code": code}]
    finally:
        stack["ctrl"].remove_worker("http://localhost:1")
    monkeypatch.setenv("OPENAI_API_KEY", "k")
    monkeypatch.setattr(urllib.request, "urlopen", lambda *a, **k: _Answer(
        json.dumps({"results": [{"flagged": True}]}).encode()))

    class _Flagged:
        def json(self):
            return {"results": [{"flagged": True}]}

    monkeypatch.setattr(requests, "post", lambda *a, **k: _Flagged())
    n = len(stack["rec"].requests)
    got = [_chat(a, {"model": "recorder", "text": "x"})
           for a in stack["web"].values()]
    assert got[0] == got[1] == [{"text": tlog.moderation_msg,
                                 "error_code": 1}]
    assert len(stack["rec"].requests) == n


def test_web_vote_logged_as_jax(stack):
    history = [["Human", "hi"], ["Assistant", "hello"]]
    for name, addr in stack["web"].items():
        r = requests.post(addr + "/vote", json={"type": "upvote",
                                                "history": history},
                          timeout=10)
        assert r.status_code == 200 and r.json() == {}
    recs = [_conv_records(stack["logdir"][n])[-1] for n in ("port", "jax")]
    for r in recs:
        assert isinstance(r.pop("tstamp"), float)
    assert recs[0] == recs[1] == {"type": "upvote", "history": history}


def test_web_unknown_route_404(stack):
    for addr in stack["web"].values():
        r = requests.post(addr + "/nope", json={}, timeout=10)
        assert r.status_code == 404
        assert requests.get(addr + "/nope", timeout=10).status_code == 404
