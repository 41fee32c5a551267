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
    from valley_tpu_torch.train.train import train

    for key, value in (("lora", True), ("export_hf", True),
                       ("mesh_model", 2), ("offload_optimizer", True),
                       ("evaluation_strategy", "steps")):
        conf = _conf(corpus, f"refuse_{key}",
                     output_dir=str(tmp_path / key), **{key: value})
        with pytest.raises(NotImplementedError):
            train(conf, "cpu")
    hf_dir = tmp_path / "hf"
    hf_dir.mkdir()
    with pytest.raises(NotImplementedError, match="Hugging Face"):
        train(_conf(corpus, "refuse_hf", output_dir=str(tmp_path / "o"),
                    model_name_or_path=str(hf_dir)), "cpu")
    if not torch.cuda.is_available():
        # the default device is the card, with no quiet fallback
        with pytest.raises(RuntimeError, match="--device cpu"):
            train(_conf(corpus, "nocard", output_dir=str(tmp_path / "c")))
