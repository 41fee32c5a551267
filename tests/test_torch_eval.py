"""The PyTorch port's generate-eval (``train/eval_loop.py``) and its
metrics (``train/metrics.py``) against the JAX package's, on the CPU.

The metrics are the same Python on both sides, so they must agree
exactly.  ``generate_eval`` replays two synthetic conversations (a 2-frame
video over three turns, text over two) through each package's engine on
one JAX init of ``valley_tiny`` (fp32 weights and caches, greedy): the
records and the scores must be equal, which holds because greedy tokens
are identical (tests/test_torch_engine.py holds the engines to that).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from valley_tpu import config as C
from valley_tpu.inference import engine as jengine
from valley_tpu.models import valley as jvalley
from valley_tpu.tokenizer import ByteFallbackTokenizer as JTok
from valley_tpu.train import eval_loop as jeval
from valley_tpu.train import metrics as jmetrics
from valley_tpu_torch import config as TC
from valley_tpu_torch.inference import engine
from valley_tpu_torch.tokenizer import ByteFallbackTokenizer
from valley_tpu_torch.train import eval_loop, metrics
from valley_tpu_torch.weights import from_jax_params

PREDS = ["the cat sat on the mat", "a dog runs in the park today",
         "", "colors change quickly", "One two three four five six"]
REFS = ["the cat is on the mat", "a dog ran in a park", "nothing here",
        "the colors change slowly", "one two three four five six"]


@pytest.mark.parametrize("preds,refs", [
    (PREDS, REFS), (PREDS[:2], REFS[:2]), (["x"], ["y z"]), ([""], [""]),
    (REFS, REFS)], ids=["five", "two", "disjoint", "empty", "identical"])
def test_bleu_and_rouge_match_jax(preds, refs):
    assert metrics.bleu(preds, refs) == jmetrics.bleu(preds, refs)
    assert metrics.bleu(preds, refs, max_n=2) == \
        jmetrics.bleu(preds, refs, max_n=2)
    assert metrics.rouge(preds, refs) == jmetrics.rouge(preds, refs)
    assert metrics.compute_generation_metrics(preds, refs) == \
        jmetrics.compute_generation_metrics(preds, refs)


def test_bleu_and_rouge_values():
    assert metrics.bleu(REFS, REFS) == pytest.approx(1.0)
    r = metrics.rouge(REFS, REFS)
    assert r == {"rouge1": 1.0, "rouge2": 1.0, "rougeL": 1.0}
    assert metrics.bleu(["x"], ["y z"]) < 0.05


def test_jsonl_shards_merge_like_jax(tmp_path):
    recs = [{"id": i, "prediction": p} for i, p in enumerate(PREDS)]
    for mod, name in ((metrics, "port"), (jmetrics, "jax")):
        path = str(tmp_path / f"{name}.jsonl")
        mod.jsonl_write(path, 1, recs[3:])
        mod.jsonl_write(path, 0, recs[:3])
        assert mod.merge_files(path) == recs
        with open(path) as f:
            assert [json.loads(line) for line in f] == recs
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["jax.jsonl", "port.jsonl"]


class Conversations:
    """Two samples as the training dataset holds them: the conversation in
    ``list_data_dict``, the frames in the item's ``image``."""

    def __init__(self, cfg):
        rng = np.random.default_rng(3)
        size = cfg.vision.image_size
        self.list_data_dict = [
            {"id": "v0", "video": "v0.mp4", "conversations": [
                {"from": "human", "value": "<video>\nWhat happens?"},
                {"from": "gpt", "value": "the colors change"},
                {"from": "human", "value": "And then?"},
                {"from": "gpt", "value": "they fade out"},
                {"from": "human", "value": "How long?"},
                {"from": "gpt", "value": "two seconds"}]},
            {"id": "t1", "conversations": [
                {"from": "human", "value": "Name a color."},
                {"from": "gpt", "value": "blue"},
                {"from": "human", "value": "Another?"},
                {"from": "gpt", "value": "red"}]},
        ]
        self.frames = rng.standard_normal((2, 3, size, size)).astype(
            np.float32)

    def __len__(self):
        return len(self.list_data_dict)

    def __getitem__(self, i):
        if "video" in self.list_data_dict[i]:
            return {"image": self.frames}
        return {}


def test_generate_eval_matches_jax(tmp_path):
    jtok, ttok = JTok(), ByteFallbackTokenizer()
    cfg = C.valley_tiny().replace(tokens=jtok.special_tokens())
    tcfg = TC.valley_tiny().replace(tokens=ttok.special_tokens())
    assert dataclasses.astuple(tcfg.tokens) == \
        dataclasses.astuple(cfg.tokens)
    jp = jvalley.init_params(cfg, jax.random.key(4), jnp.float32)
    tp = from_jax_params(jax.device_get(jp), "cpu", torch.float32)
    jeng = jengine.Engine(cfg, jp, buckets=(256, 512), max_new_tokens=8,
                          cache_dtype=jnp.float32, use_flash=False)
    teng = engine.Engine(tcfg, tp, buckets=(256, 512), max_new_tokens=8,
                         cache_dtype=torch.float32)
    data = Conversations(cfg)
    want = jeval.generate_eval(
        jeng, jtok, data, eval_num=5, conv_mode="v1",
        prediction_file=str(tmp_path / "jax.jsonl"),
        gen=jengine.GenerationConfig(max_new_tokens=6, do_sample=False))
    got = eval_loop.generate_eval(
        teng, ttok, data, eval_num=5, conv_mode="v1",
        prediction_file=str(tmp_path / "port.jsonl"),
        gen=engine.GenerationConfig(max_new_tokens=6, do_sample=False))

    def records(name):
        with open(tmp_path / name) as f:
            return [json.loads(line) for line in f]

    jr, tr = records("jax.jsonl"), records("port.jsonl")
    assert len(tr) == 5      # three turns and two
    assert [(r["id"], r["turn"]) for r in tr] == [
        ("v0", 0), ("v0", 1), ("v0", 2), ("t1", 0), ("t1", 1)]
    assert tr == jr
    assert any(r["prediction"] for r in tr)
    assert set(got) == {"bleu", "rouge1", "rouge2", "rougeL"}
    assert got == want
    # eval_num cuts the samples; a single sample's records are its turns
    one = eval_loop.eval_sample(
        teng, ttok, data.list_data_dict[1], None, "v1",
        engine.GenerationConfig(max_new_tokens=6, do_sample=False))
    assert one == tr[3:]
