"""Conversation -> token/label preprocessing.

The PyTorch port's own copy of
``valley_tpu/data/preprocess.py`` (numpy only, no jax), so that the port
imports nothing of the JAX package.

Exact behavioral parity with `valley/util/data_util.py:111-246`, including
the quirks called out in SURVEY §7 that affect trained-model compatibility:

* each piece (header, every sentence) is tokenized *separately*, so each
  piece's length includes the BOS the tokenizer prepends — the reference's
  `_tokenize_fn` (`data_util.py:111-135`) counts non-pad ids the same way;
* the system header is always masked; when ``only_mask_system`` is False
  (every reference recipe sets this — `valley_stage1.yaml:13` — note
  `dataset.py:132` never forwards the flag, so human-turn masking is always
  on in practice) human turns are masked from ``cur_idx+2`` — the "+2"
  offset of `data_util.py:146` is reproduced verbatim;
* `<image>`/`<video>` expand to
  ``<im_start> <im_patch>*P <im_end> <vi_start> <vi_frame>*T <vi_end>``
  (`preprocess_multimodal_multiimage`, `data_util.py:193-216`).
"""

from __future__ import annotations

import copy
from typing import Dict, List, Sequence

import numpy as np

from valley_tpu_torch import conversation as conversation_lib
from valley_tpu_torch.constants import (DEFAULT_IM_END_TOKEN,
                                  DEFAULT_IM_START_TOKEN,
                                  DEFAULT_IMAGE_PATCH_TOKEN,
                                  DEFAULT_IMAGE_TOKEN, DEFAULT_VI_END_TOKEN,
                                  DEFAULT_VI_START_TOKEN,
                                  DEFAULT_VIDEO_FRAME_TOKEN,
                                  DEFAULT_VIDEO_TOKEN, IGNORE_INDEX)

BEGIN_SIGNAL = "### "
END_SIGNAL = "\n"


def _encode(tokenizer, text: str) -> List[int]:
    """Tokenize one string with BOS, truncated to model_max_length."""
    ids = tokenizer.encode(text)
    limit = getattr(tokenizer, "model_max_length", None)
    if limit:
        ids = ids[:limit]
    return list(ids)


def add_speaker_and_signal(header: str, source: Sequence[dict],
                           get_conversation: bool = True) -> str:
    """'### Role: text\n' framing per turn (`data_util.py:150-168`).
    NOTE: mutates ``source`` sentence values like the reference does."""
    conversation = header
    roles = conversation_lib.default_conversation.roles
    for sentence in source:
        from_str = sentence["from"]
        if from_str.lower() == "human":
            from_str = roles[0]
        elif from_str.lower() == "gpt":
            from_str = roles[1]
        else:
            from_str = "unknown"
        sentence["value"] = (BEGIN_SIGNAL + from_str + ": "
                             + sentence["value"] + END_SIGNAL)
        if get_conversation:
            conversation += sentence["value"]
    conversation += BEGIN_SIGNAL
    return conversation


def mask_targets(target: np.ndarray, tokenized_lens: Sequence[int],
                 speakers: Sequence[str], only_mask_system: bool) -> None:
    """In-place label masking (`data_util.py:138-147`)."""
    cur_idx = tokenized_lens[0]
    tokenized_lens = tokenized_lens[1:]
    target[:cur_idx] = IGNORE_INDEX
    if not only_mask_system:
        for tokenized_len, speaker in zip(tokenized_lens, speakers):
            if speaker == "human":
                target[cur_idx + 2:cur_idx + tokenized_len] = IGNORE_INDEX
            cur_idx += tokenized_len


def preprocess(sources: Sequence[Sequence[dict]], tokenizer, conv_mode: str,
               only_mask_system: bool = False) -> Dict[str, List[np.ndarray]]:
    """Conversations -> (input_ids, labels) with human/system masking
    (`data_util.py:219-246`)."""
    conversations = []
    header = ""
    for source in sources:
        header = (f"{conversation_lib.conv_templates[conv_mode].system}\n\n")
        conversations.append(add_speaker_and_signal(header, source))

    input_ids = [np.asarray(_encode(tokenizer, c), np.int64)
                 for c in conversations]
    targets = [ids.copy() for ids in input_ids]
    for target, source in zip(targets, sources):
        tokenized_lens = [len(_encode(tokenizer, header))] + \
            [len(_encode(tokenizer, s["value"])) for s in source]
        speakers = [s["from"] for s in source]
        mask_targets(target, tokenized_lens, speakers, only_mask_system)
    return dict(input_ids=input_ids, labels=targets)


def media_replace_token(image_token_len: int, num_image: int) -> str:
    return (DEFAULT_IM_START_TOKEN
            + DEFAULT_IMAGE_PATCH_TOKEN * image_token_len
            + DEFAULT_IM_END_TOKEN
            + DEFAULT_VI_START_TOKEN
            + DEFAULT_VIDEO_FRAME_TOKEN * num_image
            + DEFAULT_VI_END_TOKEN)


def preprocess_multimodal_multiimage(sources, multimodal_cfg: dict,
                                     cur_token_len: int, num_image: int):
    """Expand <image>/<video> markers (`data_util.py:193-216`)."""
    if not multimodal_cfg.get("is_multimodal", False):
        return sources
    replace_token = None
    if multimodal_cfg.get("use_im_start_end", False):
        replace_token = media_replace_token(cur_token_len, num_image)
    for source in sources:
        for sentence in source:
            if replace_token is not None:
                sentence["value"] = sentence["value"].replace(
                    DEFAULT_IMAGE_TOKEN, replace_token)
                sentence["value"] = sentence["value"].replace(
                    DEFAULT_VIDEO_TOKEN, replace_token)
    return sources


def preprocess_multimodal(sources, multimodal_cfg: dict, cur_token_len: int):
    """Image-only expansion (`data_util.py:171-190`)."""
    if not multimodal_cfg.get("is_multimodal", False):
        return sources
    replace_token = DEFAULT_IMAGE_PATCH_TOKEN * cur_token_len
    if multimodal_cfg.get("use_im_start_end", False):
        replace_token = (DEFAULT_IM_START_TOKEN + replace_token
                         + DEFAULT_IM_END_TOKEN)
    for source in sources:
        for sentence in source:
            sentence["value"] = sentence["value"].replace(
                DEFAULT_IMAGE_TOKEN, replace_token)
    return sources
