"""Offline inference API: prompt building, response cleanup and
`completion()`, the counterparts of ``valley_tpu/inference/generate.py``
(that module imports the JAX engine, so these host functions are written
again here)."""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from valley_tpu_torch.config import ValleyConfig
from valley_tpu_torch.constants import (DEFAULT_IM_END_TOKEN,
                                  DEFAULT_IM_START_TOKEN,
                                  DEFAULT_IMAGE_PATCH_TOKEN,
                                  DEFAULT_NUM_FRAMES,
                                  DEFAULT_VI_END_TOKEN,
                                  DEFAULT_VI_START_TOKEN,
                                  DEFAULT_VIDEO_FRAME_TOKEN)
from valley_tpu_torch.inference.engine import Engine, GenerationConfig


def media_replace_token(num_patches: int = 256,
                        num_frames: int = DEFAULT_NUM_FRAMES) -> str:
    """The expansion of <video>/<image> into marker tokens."""
    return (DEFAULT_IM_START_TOKEN
            + DEFAULT_IMAGE_PATCH_TOKEN * num_patches
            + DEFAULT_IM_END_TOKEN
            + DEFAULT_VI_START_TOKEN
            + DEFAULT_VIDEO_FRAME_TOKEN * num_frames
            + DEFAULT_VI_END_TOKEN)


def build_prompt(messages: Sequence[dict], num_patches: int = 256,
                 num_frames: int = DEFAULT_NUM_FRAMES,
                 require_media: bool = True) -> str:
    """openai-style messages -> '###'-separated Valley prompt.  Accepts
    'assistant' and the reference's 'assistent'; ``require_media=False``
    permits text-only conversations."""
    replace = media_replace_token(num_patches, num_frames)
    parts: List[str] = []
    for m in messages:
        role, content = m["role"], m["content"]
        if role == "system":
            parts.append(content + "\n\n" + "###")
        elif role in ("user", "human"):
            content = content.replace("<video>", replace)
            content = content.replace("<image>", replace)
            parts.append(" Human: " + content + " \n###")
        elif role in ("assistant", "assistent"):
            parts.append(" Assistent: " + content + " \n###")
        else:
            raise ValueError(
                'Role must be "assistant", "user"/"human", or "system", '
                f"got {role!r}")
    prompt = "".join(parts)
    if require_media and DEFAULT_IM_START_TOKEN not in prompt:
        raise ValueError("You need to specify the <video> token in the query")
    return prompt


def process_response(outputs: Sequence[str]) -> List[str]:
    """Strip '###' separators and role prefixes from generations."""
    result = []
    for out in outputs:
        while True:
            cur_len = len(out)
            out = out.strip()
            for pattern in ["###", "Assistant:", "Response:", "Valley:",
                            "Assistent:"]:
                if out.startswith(pattern):
                    out = out[len(pattern):].strip()
            if len(out) == cur_len:
                break
        idx = out.find("###")
        if idx < 0:
            idx = len(out)
        result.append(out[:idx].strip())
    return result


def completion(engine: Engine, tokenizer, video: Optional[str],
               messages: Sequence[dict],
               gen: Optional[GenerationConfig] = None,
               frames: Optional[np.ndarray] = None,
               speculative: bool = False) -> List[str]:
    """One-shot video/image Q&A.  ``video`` is a path decoded by the data
    pipeline; or pass ``frames`` (T, 3, H, W), CLIP-normalised float or raw
    uint8 pixels.  ``speculative`` decodes by n-gram self-speculation
    (`speculative.SpecDecoder`: greedy tokens unchanged, sampling
    distribution-exact)."""
    cfg: ValleyConfig = engine.cfg
    num_frames = frames.shape[0] if frames is not None else DEFAULT_NUM_FRAMES
    prompt = build_prompt(messages, cfg.num_patches, num_frames)
    input_ids = tokenizer.encode(prompt)

    if frames is None:
        if video is None:
            raise ValueError("need a video path or preprocessed frames")
        from valley_tpu_torch.data.video import load_video_tchw

        size = cfg.vision.image_size
        frames = load_video_tchw(video, fixed_frame_number=num_frames,
                                 crop_size=size,
                                 scale_size=max(size * 256 // 224, size))
    gen = gen or GenerationConfig()
    if speculative:
        from valley_tpu_torch.inference.speculative import SpecDecoder

        chunks = SpecDecoder(engine).generate(tokenizer, input_ids,
                                              frames[None], gen)
    else:
        chunks = engine.generate(tokenizer, input_ids, frames[None], gen)
    text = ""
    for text in chunks:
        pass
    return process_response([text])
