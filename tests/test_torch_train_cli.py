"""The PyTorch port's training entry points on the CPU, on ``valley_tiny``:
crash-and-resume through its checkpoints, and the
``python -m valley_tpu_torch.train.train`` command line from a corpus on
disk, stage 1 then stage 2 from stage 1's output.  Needs no jax."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from valley_tpu_torch import config as C
from valley_tpu_torch.data.dataset import (DataCollatorForSupervisedDataset,
                                           DataLoader)
from valley_tpu_torch.models import valley
from valley_tpu_torch.train.trainer import TrainConfig, Trainer

ROOT = Path(__file__).resolve().parent.parent


class Rows:
    """12 synthetic rows, alternately a 2-frame video and a single image."""

    def __init__(self, cfg):
        rng = np.random.default_rng(1)
        tok = cfg.tokens
        span = [tok.im_start] + [tok.im_patch] * cfg.num_patches + \
            [tok.im_end] + [tok.vi_start] + [tok.vi_frame] * 2 + [tok.vi_end]
        size = cfg.vision.image_size
        self.items = []
        for i in range(12):
            ids = rng.integers(5, 400, size=30)
            ids[1:1 + len(span)] = span
            labels = ids.copy()
            labels[:15] = -100
            t = 2 if i % 2 == 0 else 1
            self.items.append(dict(input_ids=ids, labels=labels, image=(
                rng.standard_normal((t, 3, size, size)).astype(np.float32))))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


class CrashingLoader:
    """Yields the first ``crash_after`` batches, then raises."""

    def __init__(self, loader, crash_after):
        self.loader, self.crash_after = loader, crash_after

    def __len__(self):
        return len(self.loader)

    def epoch(self, i=0):
        for n, batch in enumerate(self.loader.epoch(i)):
            if n == self.crash_after:
                raise RuntimeError("injected crash")
            yield batch


def _trainer(cfg, out, loader):
    tc = TrainConfig(output_dir=str(out), learning_rate=1e-3,
                     freeze_backbone=True, tune_mm_mlp_adapter=True,
                     per_device_train_batch_size=4, save_steps=1,
                     save_total_limit=1, gradient_checkpointing=True)
    params = valley.init_params(cfg, torch.Generator().manual_seed(0),
                                torch.float32)
    return Trainer(cfg, tc, params, loader)


def _loader(cfg):
    return DataLoader(Rows(cfg), 4,
                      DataCollatorForSupervisedDataset(pad_to_multiple=16),
                      seed=0, num_workers=1)


def test_crash_and_resume_equals_uninterrupted(tmp_path):
    """Train 2 of 3 steps and crash; a fresh trainer resumes from
    checkpoint-2 and takes the third: the parameters equal 3 uninterrupted
    steps bit for bit (same operations in the same order on the CPU)."""
    cfg = C.valley_tiny()
    whole = _trainer(cfg, tmp_path / "whole", _loader(cfg))
    assert whole.train(resume=False) == 3

    crashed = _trainer(cfg, tmp_path / "run", CrashingLoader(_loader(cfg), 2))
    with pytest.raises(RuntimeError, match="injected crash"):
        crashed.train(resume=False)
    assert sorted(os.listdir(tmp_path / "run")) == [
        "checkpoint-2", "metrics.jsonl", "trainer.log"]   # keep = 1

    resumed = _trainer(cfg, tmp_path / "run", _loader(cfg))
    assert resumed.train(resume=True) == 3
    assert resumed.maybe_resume() == 3
    for (name, a), (_, b) in zip(whole.params.named_parameters(),
                                 resumed.params.named_parameters()):
        assert torch.equal(a, b), name
    with open(tmp_path / "run" / "metrics.jsonl") as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2, 3]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    cv2 = pytest.importorskip("cv2")
    root = tmp_path_factory.mktemp("corpus")
    vid_dir = root / "videos" / "webvid"
    vid_dir.mkdir(parents=True)
    w = cv2.VideoWriter(str(vid_dir / "a.mp4"),
                        cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 64))
    for i in range(20):
        w.write(np.full((64, 64, 3), i * 12 % 255, np.uint8))
    w.release()
    text = [{"id": f"t{i}", "conversations": [
        {"from": "human", "value": f"question {i}"},
        {"from": "gpt", "value": f"answer {i}"}]} for i in range(4)]
    vids = [{"id": f"v{i}", "video": "a.mp4", "conversations": [
        {"from": "human", "value": "<video> describe"},
        {"from": "gpt", "value": "colors change"}]} for i in range(4)]
    (root / "d.json").write_text(json.dumps(text))
    (root / "v.json").write_text(json.dumps(vids))
    return root


def _conf(root, name, **kv):
    import yaml

    base = dict(
        model_name_or_path="random:tiny", model_size="tiny",
        data_path=str(root / "d.json"),
        video_data_path=str(root / "v.json"),
        video_folder=str(root / "videos"),
        conv_mode="v1", is_multimodal=True, mm_use_im_start_end=True,
        num_frames=2, num_train_epochs=1, per_device_train_batch_size=2,
        save_steps=0, learning_rate=1e-3, gradient_checkpointing=True,
        bf16=False, model_max_length=256,
        mesh_data=1, mesh_fsdp=-1, mesh_model=1)
    base.update(kv)
    path = root / f"{name}.yaml"
    path.write_text(yaml.safe_dump(base))
    return str(path)


def _cli(conf, *extra):
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    return subprocess.run(
        [sys.executable, "-m", "valley_tpu_torch.train.train", "--conf",
         conf, *extra], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=300)


def test_cli_stage1_then_stage2_on_cpu(corpus):
    root = corpus
    s1 = _conf(root, "s1", output_dir=str(root / "out1"),
               freeze_backbone=True, tune_mm_mlp_adapter=True)
    run = _cli(s1, "--device", "cpu")
    assert run.returncode == 0, run.stderr
    out1 = root / "out1"
    for name in ("final", "valley_config.json", "valley_meta.json",
                 "checkpoint-4", "metrics.jsonl"):
        assert (out1 / name).exists(), name
    with open(out1 / "metrics.jsonl") as f:
        assert len(f.readlines()) == 4     # 8 rows / batch 2

    # stage 2: full finetune starting from stage 1's output, in process
    from valley_tpu_torch.train.train import train
    from valley_tpu_torch.utils import checkpoint as ckpt_lib

    s2 = _conf(root, "s2", output_dir=str(root / "out2"),
               model_name_or_path=str(out1), freeze_backbone=False,
               tune_mm_mlp_adapter=True, learning_rate=1e-4)
    assert train(s2, "cpu") == 4
    first = ckpt_lib.restore_pytree(out1 / "final")
    second = ckpt_lib.restore_pytree(root / "out2" / "final")
    assert set(first) == set(second)
    # stage 2 started from stage 1's weights: the frozen tower is theirs
    assert torch.equal(first["vision.patch_embedding"],
                       second["vision.patch_embedding"])
    assert not torch.equal(first["llama.lm_head"], second["llama.lm_head"])


def test_cli_refuses_what_is_not_ported(corpus, tmp_path):
    """wandb is refused; ``mesh_model: 2`` is ported (under torchrun:
    test_torch_tensor_parallel_train_cli.py), and one process refuses it
    as JAX's create_mesh refuses a mesh larger than its devices."""
    from valley_tpu_torch.train.train import train

    conf = _conf(corpus, "refuse_report_to",
                 output_dir=str(tmp_path / "report_to"), report_to="wandb")
    with pytest.raises(NotImplementedError, match="wandb"):
        train(conf, "cpu")
    conf = _conf(corpus, "refuse_mesh_model",
                 output_dir=str(tmp_path / "mesh_model"), mesh_model=2)
    with pytest.raises(ValueError, match="1 devices not divisible by 2"):
        train(conf, "cpu")
    with pytest.raises(ValueError, match="dropout_rng_impl"):
        train(_conf(corpus, "refuse_rng", output_dir=str(tmp_path / "r"),
                    lora=True, dropout_rng_impl="philox"), "cpu")
    if not torch.cuda.is_available():
        # the default device is the card, with no quiet fallback
        with pytest.raises(RuntimeError, match="--device cpu"):
            train(_conf(corpus, "nocard", output_dir=str(tmp_path / "c")))


@pytest.fixture(scope="module")
def hf_base(tmp_path_factory):
    """A tiny Valley Hugging Face checkpoint (the port's fp32 export of
    random weights) with a 600-word WordLevel tokenizer, as
    tests/test_torch_serve.py writes one."""
    pytest.importorskip("transformers")
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace

    from valley_tpu_torch.utils import hf_bridge

    cfg = C.valley_tiny()
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
    d = tmp_path_factory.mktemp("hf_base")
    hf_bridge.export_valley_checkpoint(cfg, params, str(d),
                                       tokenizer_src=str(tok))
    return d


def test_cli_lora_chain_serves_like_jax(corpus, hf_base, tmp_path,
                                        monkeypatch, capsys):
    """Stage 1 from a Hugging Face checkpoint with ``export_hf``, LoRA
    stage 2 from stage 1's output (adapter snapshots, the generate-eval
    after training), then ``run_valley --model-name <the export>
    --lora-path <stage 2>/final``: the served model's greedy tokens equal
    JAX's ``load_valley_checkpoint`` of the export followed by
    ``merge_lora(load_lora(...))`` of the same adapter arrays."""
    import dataclasses

    import jax.numpy as jnp

    from valley_tpu import config as JC
    from valley_tpu.inference import engine as jengine
    from valley_tpu.train import lora as jlora
    from valley_tpu.utils import hf_bridge as jbridge
    from valley_tpu_torch.inference import run_valley
    from valley_tpu_torch.inference.engine import GenerationConfig
    from valley_tpu_torch.train import train as train_mod
    from valley_tpu_torch.utils import checkpoint as ckpt_lib

    s1 = _conf(corpus, "chain1", output_dir=str(tmp_path / "out1"),
               model_name_or_path=str(hf_base), freeze_backbone=True,
               tune_mm_mlp_adapter=True, export_hf=True)
    run = _cli(s1, "--device", "cpu")
    assert run.returncode == 0, run.stderr
    hf = tmp_path / "out1" / "hf"
    for name in ("config.json", "tokenizer.json", "model.safetensors"):
        assert (hf / name).exists(), name

    out2 = tmp_path / "out2"
    s2 = _conf(corpus, "chain2", output_dir=str(out2),
               model_name_or_path=str(tmp_path / "out1"),
               freeze_backbone=False, tune_mm_mlp_adapter=True, lora=True,
               lora_r=4, lora_alpha=8, lora_lr=2e-3,
               lora_save_strategy="steps", save_steps=2,
               predict_with_generate=True, eval_num=2,
               generation_max_length=8)
    train_mod.main(["--conf", s2, "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "trainable=" in printed                  # print_trainable_params
    meta = json.loads((out2 / "valley_meta.json").read_text())
    assert meta["lora"] is True
    adapter = ckpt_lib.restore_pytree(out2 / "final")
    assert "wq_lora_a" in adapter and "lora_scale" in adapter
    assert all("lora" in k for k in adapter)        # adapter-only
    assert (out2 / "adapter-2").exists() and (out2 / "adapter-4").exists()
    assert any(adapter[k].abs().max() > 0 for k in adapter
               if k.endswith("_lora_b"))            # B moved off zero
    evals = [json.loads(line) for line in
             (out2 / "metrics.jsonl").read_text().splitlines()]
    assert "eval_bleu" in evals[-1] and evals[-1]["step"] == 4
    assert (out2 / "eval_result.jsonl").exists()
    with pytest.raises(ValueError, match=f"lora_path={out2}/final"):
        train_mod.load_framework_checkpoint(str(out2), 256, "cpu",
                                            torch.float32)

    # the entry point on the merged checkpoint
    video = str(corpus / "videos" / "webvid" / "a.mp4")
    run_valley.main(["--model-name", str(hf), "--lora-path",
                     str(out2 / "final"), "--video-file", video,
                     "--device", "cpu", "--max-new-tokens", "4",
                     "--temperature", "0"])
    assert capsys.readouterr().out.endswith("\n")
    engine, tok = run_valley.load_model(str(hf), "cpu", buckets=(64,),
                                        max_new_tokens=8,
                                        lora_path=str(out2 / "final"))
    assert not any("lora" in n for n, _ in engine.params.named_parameters())

    vis = C.valley_tiny().vision
    monkeypatch.setattr(jbridge.C, "VisionConfig",
                        lambda select_layer=-2, **kw: dataclasses.replace(
                            vis, select_layer=select_layer, **kw))
    jcfg, jp, _ = jbridge.load_valley_checkpoint(str(hf), dtype=jnp.float32)
    jp = jlora.merge_lora(jlora.load_lora(
        jp, {k: v.float().numpy() for k, v in adapter.items()}))
    assert isinstance(jcfg, JC.ValleyConfig)
    jeng = jengine.Engine(jcfg, jp, buckets=(64,), max_new_tokens=8,
                          cache_dtype=jnp.float32, use_flash=False)
    ids = tok.encode("w5 w6 w7 w8 w9")
    want = [int(t[0]) for t in jeng.generate_tokens(
        [ids], None, jengine.GenerationConfig(max_new_tokens=8,
                                              do_sample=False),
        eos_ids=[-1])]
    engine.cache_dtype = torch.float32
    got = [int(t[0]) for t in engine.generate_tokens(
        [ids], None, GenerationConfig(max_new_tokens=8, do_sample=False),
        eos_ids=[-1])]
    assert got == want and len(got) == 8


def test_cli_stage2_from_hf_with_eval_steps(corpus, hf_base, tmp_path):
    """Full stage 2 straight from a Hugging Face checkpoint directory,
    with the generate-eval every two updates (``evaluation_strategy:
    steps``) through one engine whose weights are refilled in place."""
    from valley_tpu_torch.train import train as train_mod
    from valley_tpu_torch.utils import checkpoint as ckpt_lib

    out = tmp_path / "out"
    conf = _conf(corpus, "hf_s2", output_dir=str(out),
                 model_name_or_path=str(hf_base), freeze_backbone=False,
                 tune_mm_mlp_adapter=True, learning_rate=1e-4,
                 evaluation_strategy="steps", eval_steps=2, eval_num=2)
    built = []
    real = train_mod._eval_engine

    def counting(*args):
        built.append(args)
        return real(*args)

    train_mod._eval_engine = counting
    try:
        assert train_mod.train(conf, "cpu") == 4
    finally:
        train_mod._eval_engine = real
    assert len(built) == 1                # one engine for both evals
    lines = [json.loads(line) for line in
             (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines if "eval_bleu" in r] == [2, 4]
    final = ckpt_lib.restore_pytree(out / "final")
    assert "llama.layers.wq" in final and not any("lora" in k for k in final)
    assert json.loads((out / "valley_meta.json").read_text())[
        "tokenizer_path"] == str(hf_base)
