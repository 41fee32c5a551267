"""Generate-eval of the PyTorch port, the counterpart of
``valley_tpu/train/eval_loop.py``: replay multi-turn conversations with
generation and score BLEU/ROUGE(/BERTScore).

For every sample each human turn is fed with the *generated* history and
the model's reply is scored against the gold 'gpt' turn, through the
port's `Engine.generate` (greedy unless the caller's `GenerationConfig`
samples).  Predictions go to per-rank jsonl shards merged on rank 0
(`trainner.py:122-147`); the port runs one rank.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np

from valley_tpu_torch.conversation import conv_templates
from valley_tpu_torch.inference.engine import Engine, GenerationConfig
from valley_tpu_torch.inference.generate import media_replace_token
from valley_tpu_torch.train.metrics import (compute_generation_metrics,
                                            jsonl_write, merge_files)

logger = logging.getLogger(__name__)


def _final_text(engine: Engine, tokenizer, input_ids, images, gen) -> str:
    text = ""
    for text in engine.generate(tokenizer, input_ids, images, gen):
        pass
    return text.strip()


def eval_sample(engine: Engine, tokenizer, sample: dict,
                images: Optional[np.ndarray],
                conv_mode: str = "v1",
                gen: Optional[GenerationConfig] = None) -> List[dict]:
    """Replay one conversation; returns one record per assistant turn
    (id, turn, question, prediction, reference)."""
    gen = gen or GenerationConfig(max_new_tokens=256, do_sample=False)
    conv = conv_templates[conv_mode].copy()
    records = []
    turns = sample["conversations"]
    first_human = True
    for i in range(0, len(turns) - 1, 2):
        human, gold = turns[i], turns[i + 1]
        value = human["value"]
        if first_human and images is not None:
            for marker in ("<video>", "<image>"):
                value = value.replace(
                    marker, media_replace_token(engine.cfg.num_patches,
                                                images.shape[1]))
            first_human = False
        conv.append_message(conv.roles[0], value)
        conv.append_message(conv.roles[1], None)
        input_ids = tokenizer.encode(conv.get_prompt())
        pred = _final_text(engine, tokenizer, input_ids, images, gen)
        conv.messages[-1][-1] = pred
        records.append({
            "id": sample.get("id"),
            "turn": i // 2,
            "question": human["value"],
            "prediction": pred,
            "reference": gold["value"],
        })
    return records


def generate_eval(engine: Engine, tokenizer, dataset,
                  eval_num: int = 400,
                  conv_mode: str = "v1",
                  prediction_file: Optional[str] = None,
                  gen: Optional[GenerationConfig] = None,
                  rank: int = 0, world: int = 1) -> Dict[str, float]:
    """Evaluate up to ``eval_num`` samples of ``dataset`` (the conversation
    from its ``list_data_dict``, the frames from its item's ``image``),
    sharded across ranks; metrics on rank 0.  A sample that fails is
    logged and skipped, as in JAX."""
    n = min(eval_num, len(dataset))
    records: List[dict] = []
    for idx in range(rank, n, world):
        entry = dataset.list_data_dict[idx] if hasattr(
            dataset, "list_data_dict") else dataset[idx]
        images = None
        item = dataset[idx] if hasattr(dataset, "__getitem__") else None
        if isinstance(item, dict) and "image" in item:
            images = item["image"][None]
        try:
            records.extend(eval_sample(engine, tokenizer, entry, images,
                                       conv_mode, gen))
        except Exception as e:
            logger.warning("eval sample %s failed: %s",
                           entry.get("id", idx), e)

    if prediction_file:
        jsonl_write(prediction_file, rank, records)
        if rank == 0 and world == 1:
            records = merge_files(prediction_file)
    if rank != 0:
        return {}
    preds = [r["prediction"] for r in records]
    refs = [r["reference"] for r in records]
    if not preds:
        return {}
    metrics = compute_generation_metrics(preds, refs)
    logger.info("generate-eval over %d replies: %s", len(preds), metrics)
    return metrics
