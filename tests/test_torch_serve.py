"""The port's serving stack (`valley_tpu_torch/serve/`) on the CPU: its
worker and controller over localhost HTTP beside the JAX package's
``ModelWorker`` on the weights of one JAX init, as ``tests/test_serve.py``
and ``tests/test_openai_api.py`` test the JAX stack.

Greedy streamed chunks (the raw ``{"text", "error_code"}\\0`` bytes) must
equal the JAX worker's in every serving mode: the plain path
(``--no-speculative``), speculation, the dynamic batcher, the pool, the
pool admitting from the prefix cache, sessions and the prefix cache.  Both
engines run the tiny model in fp32, whose greedy tokens agree exactly
(tests/test_torch_engine.py).
"""

import argparse
import base64
import json
import threading
import time
from io import BytesIO

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import requests
import torch

from valley_tpu import config as C
from valley_tpu.inference import Engine as JEngine
from valley_tpu.models import valley as jvalley
from valley_tpu.serve.model_worker import ModelWorker as JWorker
from valley_tpu_torch import config as TC
from valley_tpu_torch.inference.engine import Engine
from valley_tpu_torch.serve import controller as controller_mod
from valley_tpu_torch.serve import model_worker as worker_mod
from valley_tpu_torch.serve.controller import Controller
from valley_tpu_torch.serve.httpd import (iter_delimited, open_json,
                                          post_json, stream_chunks)
from valley_tpu_torch.serve.model_worker import ModelWorker
from valley_tpu_torch.tokenizer import ByteFallbackTokenizer
from valley_tpu_torch.weights import from_jax_params

NEW = 8
TEXT = "### Human: hi there\n### Assistant:"
VIDEO = "You are Valley.### Human: <video> {q}\n### Assistant:"


@pytest.fixture(scope="module")
def engines():
    tk = ByteFallbackTokenizer()
    jcfg = C.valley_tiny().replace(tokens=C.SpecialTokens(
        **tk.special_tokens().__dict__))
    params = jvalley.init_params(jcfg, jax.random.key(0), jnp.float32)
    jeng = JEngine(jcfg, params, buckets=(128,), max_new_tokens=16,
                   cache_dtype=jnp.float32, use_flash=False)
    cfg = TC.valley_tiny().replace(tokens=tk.special_tokens())
    teng = Engine(cfg, from_jax_params(jax.device_get(params), "cpu",
                                       torch.float32),
                  buckets=(128,), max_new_tokens=16,
                  cache_dtype=torch.float32)
    return jeng, teng, tk


@pytest.fixture(scope="module")
def video_dir(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(3)
    for i in range(4):
        Image.fromarray(rng.integers(0, 256, (36, 40, 3), np.uint8)).save(
            d / f"f{i}.png")
    return str(d)


def _serve(worker):
    app = worker_mod.build_app(worker)
    port = app.start()
    return app, f"http://localhost:{port}"


def _port_chunks(base: str, params: dict) -> list:
    with open_json(base + "/worker_generate_stream", params,
                   timeout=120) as r:
        return [c + b"\0" for c in iter_delimited(r)]


def _request(prompt, **kw):
    return {"prompt": prompt, "temperature": 0.0, "max_new_tokens": NEW,
            "stop": "###", **kw}


MODES = {
    "plain": dict(speculative=False),
    "speculative": dict(speculative=True),
    "batcher": dict(batch_window_ms=20.0, max_batch=2),
    "pool": dict(batch_window_ms=-1.0, max_batch=2),
    "pool_prefix": dict(batch_window_ms=-1.0, max_batch=2, prefix_cache=2),
    "sessions": dict(max_sessions=2),
    "prefix_cache": dict(prefix_cache=2),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_streams_match_jax_worker(engines, video_dir, mode):
    """Byte-equal greedy chunks to the JAX worker's, over HTTP on the
    port's side: a text request and two questions on one video (the second
    a prefix-cache hit where the cache is on), and in session mode a
    second turn extending the first."""
    jeng, teng, tk = engines
    kw = dict(no_register=True, num_frames=2, **MODES[mode])
    jw = JWorker("u", "u", "valley-tiny", jeng, tk, **kw)
    tw = ModelWorker("u", "u", "valley-tiny", teng, tk, **kw)
    app, base = _serve(tw)
    try:
        if mode == "sessions":
            first = _request(TEXT, session_id="s1")
            reqs = [first]
        else:
            reqs = [_request(TEXT),
                    _request(VIDEO.format(q="what happens?"),
                             videos=[video_dir]),
                    _request(VIDEO.format(q="and then?"),
                             videos=[video_dir])]
        for i, req in enumerate(reqs):
            want = list(jw.generate_stream_gate(dict(req)))
            got = _port_chunks(base, req)
            assert got == want, (mode, i, got[-1:], want[-1:])
            assert json.loads(got[-1][:-1])["error_code"] == 0
        if mode == "sessions":
            reply = json.loads(want[-1][:-1])["text"][len(TEXT):]
            turn2 = _request(TEXT + reply + "###Human: more\n### "
                             "Assistant:", session_id="s1")
            want = list(jw.generate_stream_gate(dict(turn2)))
            assert _port_chunks(base, turn2) == want
            assert list(tw._sessions) == list(jw._sessions) == ["s1"]
        if "prefix" in mode:
            assert (tw.prefix_misses, tw.prefix_hits) == \
                (jw.prefix_misses, jw.prefix_hits) == (1, 1)
        stats = post_json(base + "/worker_get_status", {})["stats"]
        assert stats["requests"] == len(reqs) + (mode == "sessions")
        assert stats["tokens_generated"] > 0
        if mode == "speculative":
            assert stats["spec_rounds"] > 0
    finally:
        app.shutdown()
        for w in (tw, jw):
            if getattr(w, "continuous", None) is not None and \
                    hasattr(w.continuous, "close"):
                w.continuous.close()


def test_concurrent_requests_each_equal_their_run_alone(engines, video_dir):
    """Three questions on one video at once through a plain worker: each
    stream equals the same request alone (the engine lock serializes the
    decode state)."""
    _, teng, tk = engines
    tw = ModelWorker("u", "u", "valley-tiny", teng, tk, no_register=True,
                     num_frames=2, speculative=True)
    app, base = _serve(tw)
    try:
        reqs = [_request(VIDEO.format(q=q), videos=[video_dir])
                for q in ("who?", "where is it?", "what colour?")]
        alone = [_port_chunks(base, r) for r in reqs]
        got = [None] * 3

        def run(i):
            got[i] = _port_chunks(base, reqs[i])

        threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert got == alone
        assert len({a[-1] for a in alone}) == 3
    finally:
        app.shutdown()


@pytest.fixture(scope="module")
def stack(engines):
    """controller + a registered port worker on live ports."""
    _, teng, tk = engines
    ctrl = Controller("shortest_queue")
    ctrl_app = controller_mod.build_app(ctrl)
    ctrl_addr = f"http://localhost:{ctrl_app.start()}"
    worker = ModelWorker(ctrl_addr, "placeholder", "valley-tiny", teng, tk,
                         no_register=True, num_frames=2, max_sessions=2)
    w_app, w_addr = _serve(worker)
    worker.worker_addr = w_addr
    worker.register_to_controller()
    yield {"ctrl": ctrl, "ctrl_addr": ctrl_addr, "worker": worker,
           "worker_addr": w_addr}
    ctrl_app.shutdown()
    w_app.shutdown()


def test_register_and_list_models(stack):
    assert post_json(stack["ctrl_addr"] + "/list_models",
                     {})["models"] == ["valley-tiny"]
    addr = post_json(stack["ctrl_addr"] + "/get_worker_address",
                     {"model": "valley-tiny"})["address"]
    assert addr == stack["worker_addr"]
    assert post_json(stack["ctrl_addr"] + "/get_worker_address",
                     {"model": "nope"})["address"] == ""
    status = post_json(stack["worker_addr"] + "/worker_get_status", {})
    assert status["model_names"] == ["valley-tiny"] and status["speed"] == 1
    agg = post_json(stack["ctrl_addr"] + "/worker_get_status", {})
    assert agg["model_names"] == ["valley-tiny"]


def test_worker_status_stats_counters(stack):
    s0 = post_json(stack["worker_addr"] + "/worker_get_status",
                   {})["stats"]
    list(stream_chunks(stack["worker_addr"] + "/worker_generate_stream",
                       {"prompt": "count me", "temperature": 0.0,
                        "max_new_tokens": 4}))
    s1 = post_json(stack["worker_addr"] + "/worker_get_status",
                   {})["stats"]
    assert s1["requests"] == s0["requests"] + 1
    assert s1["tokens_generated"] > s0["tokens_generated"]
    assert "active_sessions" in s1


def test_controller_proxy_stream_and_error_codes(stack):
    """The proxy streams the worker's chunks; error code 1 for a bad
    request, 2 for no worker, 3 for a dead one."""
    req = _request(TEXT, model="valley-tiny")
    via = list(stream_chunks(stack["ctrl_addr"] + "/worker_generate_stream",
                             req))
    direct = list(stream_chunks(
        stack["worker_addr"] + "/worker_generate_stream", req))
    assert via == direct and via[-1]["error_code"] == 0
    assert via[-1]["text"].startswith(TEXT)
    bad = list(stream_chunks(stack["worker_addr"] + "/worker_generate_stream",
                             {"prompt": "no media token here",
                              "videos": ["/tmp/x.mp4"],
                              "max_new_tokens": 4}))
    assert bad[-1]["error_code"] == 1
    missing = list(stream_chunks(
        stack["ctrl_addr"] + "/worker_generate_stream",
        {"model": "missing-model", "prompt": "x"}))
    assert missing[-1]["error_code"] == 2
    ctrl = Controller("shortest_queue")
    ctrl.register_worker("http://localhost:1", False,   # nothing listens
                         {"model_names": ["dead"], "speed": 1,
                          "queue_length": 0})
    chunks = [json.loads(c.decode().rstrip("\0")) for c in
              ctrl.worker_api_generate_stream({"model": "dead",
                                               "prompt": "x"})]
    assert chunks[-1]["error_code"] == 3
    r = requests.post(stack["ctrl_addr"] + "/nope", json={}, timeout=10)
    assert r.status_code == 404


def test_heartbeat_expiry_and_dispatch_methods():
    ctrl = Controller("shortest_queue")
    ctrl.register_worker("http://fake:1", True,
                         {"model_names": ["m"], "speed": 1,
                          "queue_length": 0})
    assert ctrl.receive_heart_beat("http://fake:1", 3)
    assert ctrl.worker_info["http://fake:1"].queue_length == 3
    assert not ctrl.receive_heart_beat("http://unknown:1", 1)
    ctrl.worker_info["http://fake:1"].last_heart_beat = time.time() - 999
    ctrl.remove_stale_workers_by_expiration()
    assert "http://fake:1" not in ctrl.worker_info

    lot = Controller("lottery")
    for name in ("http://a:1", "http://b:1"):
        lot.register_worker(name, False, {"model_names": ["m"], "speed": 1,
                                          "queue_length": 0})
    assert {lot.get_worker_address("m") for _ in range(20)} <= \
        {"http://a:1", "http://b:1"}
    assert lot.get_worker_address("other") == ""

    sq = Controller("shortest_queue")
    sq.register_worker("http://busy:1", False,
                       {"model_names": ["m"], "speed": 1,
                        "queue_length": 10})
    sq.register_worker("http://idle:1", False,
                       {"model_names": ["m"], "speed": 1,
                        "queue_length": 0})
    assert sq.get_worker_address("m") == "http://idle:1"
    assert sq.worker_info["http://idle:1"].queue_length == 1
    with pytest.raises(ValueError):
        Controller("round_robin")


def test_controller_concurrent_stress():
    ctrl = Controller("shortest_queue")
    errors = []

    def registrar(i):
        try:
            for k in range(50):
                ctrl.register_worker(
                    f"http://w{i}:{k % 5}", False,
                    {"model_names": ["m"], "speed": 1, "queue_length": k})
                ctrl.receive_heart_beat(f"http://w{i}:{k % 5}", k)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    def dispatcher():
        try:
            for _ in range(200):
                ctrl.get_worker_address("m")
                ctrl.list_models()
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=registrar, args=(i,))
               for i in range(4)]
    threads += [threading.Thread(target=dispatcher) for _ in range(2)]
    threads += [threading.Thread(
        target=lambda: [ctrl.remove_stale_workers_by_expiration()
                        for _ in range(50)])]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert ctrl.get_worker_address("m") != ""


MSGS = [{"role": "system", "content": "You are Valley."},
        {"role": "user", "content": "tell me something nice"}]


def test_openai_routes(stack):
    """/v1/models; /v1/chat/completions against the native route, its SSE
    stream, an image part, a bad role (400) and the user field's
    session."""
    base = stack["worker_addr"]
    r = requests.get(f"{base}/v1/models", timeout=30)
    assert r.status_code == 200 and r.json()["data"][0]["id"] == \
        "valley-tiny"
    r = requests.post(f"{base}/v1/chat/completions", timeout=120,
                      json={"messages": MSGS, "temperature": 0.0,
                            "max_tokens": 8})
    assert r.status_code == 200, r.text
    out = r.json()
    content = out["choices"][0]["message"]["content"]
    assert out["choices"][0]["finish_reason"] == "stop"
    assert out["usage"]["total_tokens"] > 0
    prompt = ("You are Valley.\n\n### Human: tell me something nice \n"
              "### Assistent:")
    chunks = list(stream_chunks(f"{base}/worker_generate_stream",
                                {"prompt": prompt, "temperature": 0.0,
                                 "max_new_tokens": 8, "stop": "###"}))
    assert content == chunks[-1]["text"][len(prompt):].strip()

    with requests.post(f"{base}/v1/chat/completions", stream=True,
                       timeout=120,
                       json={"messages": MSGS, "temperature": 0.0,
                             "max_tokens": 8, "stream": True}) as r:
        assert r.headers["Content-Type"].startswith("text/event-stream")
        deltas, done, finish = [], False, None
        for line in r.iter_lines():
            if not line.startswith(b"data: "):
                continue
            payload = line[len(b"data: "):]
            if payload == b"[DONE]":
                done = True
                break
            choice = json.loads(payload)["choices"][0]
            finish = choice["finish_reason"] or finish
            deltas.append(choice["delta"].get("content", ""))
    assert done and finish == "stop"
    assert "".join(deltas).strip() == content

    from PIL import Image

    buf = BytesIO()
    Image.fromarray(np.full((40, 40, 3), 128, np.uint8)).save(buf, "JPEG")
    b64 = base64.b64encode(buf.getvalue()).decode()
    msgs = [{"role": "user", "content": [
        {"type": "text", "text": "describe this"},
        {"type": "image_url",
         "image_url": {"url": f"data:image/jpeg;base64,{b64}"}}]}]
    r = requests.post(f"{base}/v1/chat/completions", timeout=120,
                      json={"messages": msgs, "temperature": 0.0,
                            "max_tokens": 6})
    assert r.status_code == 200, r.text
    r = requests.post(f"{base}/v1/chat/completions", timeout=30,
                      json={"messages": [{"role": "tool", "content": "x"}]})
    assert r.status_code == 400
    assert r.json()["error"]["type"] == "invalid_request_error"
    r = requests.post(f"{base}/v1/chat/completions", timeout=120,
                      json={"messages": MSGS, "temperature": 0.0,
                            "max_tokens": 6, "user": "alice"})
    assert r.status_code == 200 and "alice" in stack["worker"]._sessions

    from valley_tpu_torch.serve.openai_api import _flatten_messages

    payload = base64.b64encode(b"vbytes").decode()
    _, videos, _ = _flatten_messages([{"role": "user", "content": [
        {"type": "video_url",
         "video_url": f"data:video/mp4;base64,{payload}"}]}])
    assert videos == [payload]
    with pytest.raises(ValueError, match="no usable url"):
        _flatten_messages([{"role": "user", "content": [
            {"type": "image_url", "image_url": {}}]}])


def _args(**kw):
    base = dict(model_path="random:tiny", vision_tower=None, lora_path=None,
                quantize=None, quantize_vision=None, kv_cache="bf16",
                fused=False, buckets="128", max_new_tokens=8,
                steps_per_call=4, decode_ramp="off", frame_buckets="off",
                num_frames=2, tensor_parallel=1, raw_pixels=True,
                device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


def test_refusals_name_their_roadmap_items():
    """--tensor-parallel above 1, once refused, serves under torchrun
    (tests/test_torch_tensor_parallel_serve.py): outside a torchrun world
    of its size it is refused with the command line that runs it;
    --quantize-vision and the grouped W4A8 modes, once refused, build their
    engines (their trees against JAX: tests/test_torch_vision_quant.py,
    tests/test_torch_w4a8.py)."""
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2 -m "
                       "valley_tpu_torch.serve.model_worker"):
        worker_mod.load_engine(_args(tensor_parallel=2))
    eng, _ = worker_mod.load_engine(_args(quantize_vision="int8a8"))
    lay = eng.params["vision"]["layers"]
    assert lay["fc1"].dtype == torch.int8 and "fc1_scale_a8" in lay
    # --lora-path merges into a checkpoint's weights (tests/
    # test_torch_train_cli.py), not random ones
    with pytest.raises(ValueError, match="lora-path"):
        worker_mod.load_engine(_args(lora_path="x"))
    eng, _ = worker_mod.load_engine(_args(quantize="int4ga8", fused=True))
    lay = eng.params["llama"]["layers"]
    assert lay["wqkv"].dtype == torch.uint8 and "wqkv_scale_a8" in lay
    args = worker_mod.build_parser().parse_args([])
    assert args.speculative is None and args.buckets == "256,512,1024,2048"
    assert args.steps_per_call == 32 and args.decode_ramp == "2,6"
    assert worker_mod.build_parser().parse_args(
        ["--no-speculative"]).speculative is False


def test_speculative_default_spares_the_pool(engines):
    """--speculative is on by default for stateless requests; a pool
    speculates only when --speculative is given."""
    _, teng, tk = engines
    parser = worker_mod.build_parser()
    for argv, spec, pool_spec in (([], True, False),
                                  (["--speculative"], True, True),
                                  (["--no-speculative"], False, False)):
        args = parser.parse_args(argv + ["--no-register"])
        w = worker_mod.make_worker(args, teng, tk)
        assert (w.spec_decoder is not None) == spec
        args = parser.parse_args(argv + ["--no-register",
                                         "--batch-window-ms", "-1"])
        w = worker_mod.make_worker(args, teng, tk)
        try:
            assert (w.continuous._spec is not None) == pool_spec
        finally:
            w.continuous.close()


def test_speculative_requests_share_one_cache_length(engines, video_dir):
    """SpecDecoder's cache length is its bucket's, whatever a request's
    max_new_tokens: the warm-up and requests of 3, 8 and 16 new tokens
    decode at one length (on the card, one graph key a bucket), and the
    budget's estimate of the decode states counts that length once."""
    from valley_tpu_torch.serve import hbm

    _, teng, tk = engines
    tw = ModelWorker("u", "u", "valley-tiny", teng, tk, no_register=True,
                     num_frames=2, speculative=True, hbm_budget_gb=1.0)
    dec = tw.spec_decoder
    lengths = []
    run = dec._generate

    def recording(prompt, ids, lens, bucket, media, cache_len, *a):
        lengths.append((bucket, cache_len))
        return run(prompt, ids, lens, bucket, media, cache_len, *a)

    dec._generate = recording
    tw.warmup_serving_paths()
    want = (128, dec.cache_len(128))
    assert want[1] == 128 + teng.max_new_tokens + \
        dec.spec.rounds_per_call * (dec.spec.draft_len + 1)
    assert lengths and set(lengths) == {want}
    lengths.clear()
    app, base = _serve(tw)
    try:
        for new in (3, 8, 16):
            req = _request(VIDEO.format(q="what happens?"),
                           videos=[video_dir], max_new_tokens=new)
            chunks = _port_chunks(base, req)
            assert json.loads(chunks[-1][:-1])["error_code"] == 0
    finally:
        app.shutdown()
    assert lengths == [want] * 3
    assert tw.hbm.snapshot()["by"]["decode_states"] == want[1] * \
        hbm.kv_slot_bytes(teng.cfg.text, teng.cache_dtype)


def test_random_full_size_models_load(monkeypatch):
    """random:7b and random:13b build LLaMA-2-7B / 13B with every weight
    0.008 in bf16 and the byte tokenizer (the widths cut here so the CPU
    can hold them)."""
    from valley_tpu_torch.inference import run_valley

    tiny = TC.valley_tiny()
    real_cfg = TC.ValleyConfig
    seen = []
    for name, attr in (("7b", "LLAMA2_7B"), ("13b", "LLAMA2_13B")):
        marker = TC.TextConfig(**{**tiny.text.__dict__,
                                  "rms_norm_eps": 1e-5 + len(seen)})
        monkeypatch.setattr(run_valley.C, attr, marker)

        def small(text, tokens, real=real_cfg):
            seen.append(text)
            return real(text=text, vision=tiny.vision, tokens=tokens)

        monkeypatch.setattr(run_valley.C, "ValleyConfig", small)
        eng, tk = worker_mod.load_engine(_args(
            model_path=f"random:{name}", quantize="int8", fused=True))
        assert seen[-1] is marker and isinstance(tk, ByteFallbackTokenizer)
        assert eng.cfg.tokens == tk.special_tokens()
        assert eng.params["projector"]["w"].dtype == torch.bfloat16
        assert bool((eng.params["projector"]["w"] == 0.008).all())
        assert eng.params["llama"]["layers"]["wqkv"].dtype == torch.int8


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A tiny Valley checkpoint written by the port's exporter in bf16, with
    a WordLevel tokenizer as in tests/test_checkpoint_loading.py (600
    words, so the table grows to hold the markers)."""
    pytest.importorskip("transformers")
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace

    from valley_tpu_torch.models import valley
    from valley_tpu_torch.utils import hf_bridge

    cfg = TC.valley_tiny()
    params = valley.init_params(cfg, torch.Generator().manual_seed(5),
                                torch.float32, "cpu")
    tok = tmp_path_factory.mktemp("tok")
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    vocab.update({f"w{i}": i for i in range(3, 600)})
    wl = Tokenizer(WordLevel(vocab, unk_token="<unk>"))
    wl.pre_tokenizer = Whitespace()
    wl.save(str(tok / "tokenizer.json"))
    (tok / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast", "unk_token": "<unk>",
        "bos_token": "<s>", "eos_token": "</s>", "model_max_length": 512}))
    d = tmp_path_factory.mktemp("port_ckpt")
    hf_bridge.export_valley_checkpoint(cfg, params, str(d),
                                       tokenizer_src=str(tok),
                                       dtype=torch.bfloat16)
    return str(d)


def test_entry_points_serve_a_checkpoint(checkpoint, video_dir, tmp_path,
                                         capsys, monkeypatch):
    """model_worker --model-path, run_valley --model-name,
    run_valley_llamma_v2, run_valley_conv and batch_infer --model-path on
    a checkpoint directory (quantized on load for the worker)."""
    import io
    import sys

    from valley_tpu_torch.inference import (batch_infer, run_valley,
                                            run_valley_conv,
                                            run_valley_llamma_v2)

    eng, tk = worker_mod.load_engine(_args(
        model_path=checkpoint, quantize="int8a8", fused=True,
        kv_cache="int8"))
    assert eng.params["llama"]["layers"]["wqkv"].dtype == torch.int8
    assert eng.cfg.vision == TC.valley_tiny().vision
    w = ModelWorker("u", "u", "tiny", eng, tk, no_register=True,
                    num_frames=2)
    app, base = _serve(w)
    try:
        chunks = list(stream_chunks(
            base + "/worker_generate_stream",
            _request("Human: <video> w5 w6###Assistant:",
                     videos=[video_dir])))
        assert chunks[-1]["error_code"] == 0
    finally:
        app.shutdown()
    common = ["--video-file", video_dir, "--device", "cpu",
              "--max-new-tokens", "3"]
    run_valley.main(["--model-name", checkpoint, *common, "--temperature",
                     "0"])
    run_valley_llamma_v2.main(["--model-name", checkpoint, *common])
    monkeypatch.setattr(sys, "stdin", io.StringIO("w7 w8\nexit\n"))
    run_valley_conv.main(["--model-name", checkpoint, *common])
    capsys.readouterr()
    (tmp_path / "in.jsonl").write_text(json.dumps(
        {"id": "a", "query": "w9", "video": video_dir}) + "\n")
    summary = batch_infer.run_batch(batch_infer.build_parser().parse_args(
        ["--model-path", checkpoint, "--input", str(tmp_path / "in.jsonl"),
         "--output", str(tmp_path / "out.jsonl"), "--device", "cpu",
         "--max-new-tokens", "3", "--buckets", "128", "--rows", "2",
         "--num-frames", "2"]))
    assert summary["ran"] == 1 and summary["errors"] == 0


def test_cli_chat_loop_speculative_matches_plain(engines):
    """The chat REPL's replies, plain and speculative, are the same."""
    from valley_tpu_torch.serve.cli import chat_loop

    _, teng, tk = engines
    teng = Engine(teng.cfg, teng.params, buckets=(512,), max_new_tokens=16,
                  cache_dtype=torch.float32)
    outs = []
    for spec in (False, True):
        lines = iter(["hello there", "and more", ""])
        printed = []
        chat_loop(teng, tk, temperature=0.0, max_new_tokens=6,
                  input_fn=lambda _p: next(lines),
                  print_fn=lambda *a, **k: printed.append(a),
                  speculative=spec)
        outs.append(printed)
    assert outs[0] == outs[1] and len(outs[0]) >= 4
