"""Tokenizer handling.

The PyTorch port's own copy of ``valley_tpu/tokenizer.py`` (numpy only, no
jax), so that the port imports nothing of the JAX package.

Wraps a HF (sentencepiece) tokenizer as a host-side library — the same
stance as the reference (tokenizers are third-party there too, SURVEY §2.3).
Adds the Valley special tokens and resolves their ids into a
`SpecialTokens` record (reference spreads this across
`train.py:104-120` + `initialize_vision_tokenizer`,
`valley_model.py:354-379`).

Also provides `ByteFallbackTokenizer`, a dependency-free tokenizer with the
same protocol used by tests and CPU smoke paths.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Protocol, Sequence

from valley_tpu_torch.config import SpecialTokens
from valley_tpu_torch.constants import (DEFAULT_BOS_TOKEN, DEFAULT_EOS_TOKEN,
                                  DEFAULT_IM_END_TOKEN,
                                  DEFAULT_IM_START_TOKEN,
                                  DEFAULT_IMAGE_PATCH_TOKEN,
                                  DEFAULT_PAD_TOKEN, DEFAULT_UNK_TOKEN,
                                  DEFAULT_VI_END_TOKEN,
                                  DEFAULT_VI_START_TOKEN,
                                  DEFAULT_VIDEO_FRAME_TOKEN)

SPECIAL_TOKEN_ORDER = [
    # Order reproduces the reference training path: `train.py:117-120` adds
    # the video tokens first, then `initialize_vision_tokenizer`
    # (`valley_model.py:357,360`) adds the image tokens (video dups no-op).
    DEFAULT_VIDEO_FRAME_TOKEN,
    DEFAULT_VI_START_TOKEN,
    DEFAULT_VI_END_TOKEN,
    DEFAULT_IMAGE_PATCH_TOKEN,
    DEFAULT_IM_START_TOKEN,
    DEFAULT_IM_END_TOKEN,
]


class Tokenizer(Protocol):
    def encode(self, text: str) -> List[int]: ...
    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = True) -> str: ...
    def token_to_id(self, token: str) -> int: ...
    @property
    def vocab_size(self) -> int: ...


def load_hf_tokenizer(path: str, model_max_length: int = 2048,
                      add_valley_tokens: bool = True):
    """Load a HF tokenizer and extend it with the Valley special tokens.

    Returns (tokenizer, SpecialTokens).  Ids are *read back* from the
    tokenizer rather than assumed, so checkpoints whose token order differs
    (the inference scripts add them in another order, `run_valley.py:13-18`)
    resolve correctly.
    """
    import transformers

    try:
        tok = transformers.AutoTokenizer.from_pretrained(
            path, model_max_length=model_max_length, padding_side="right",
            use_fast=False)
    except (ValueError, OSError, EnvironmentError):
        # no slow (sentencepiece) files — fall back to a fast tokenizer
        tok = transformers.AutoTokenizer.from_pretrained(
            path, model_max_length=model_max_length, padding_side="right",
            use_fast=True)
    if tok.pad_token is None:
        tok.add_special_tokens({"pad_token": DEFAULT_PAD_TOKEN})
    tok.add_special_tokens({
        "eos_token": DEFAULT_EOS_TOKEN,
        "bos_token": DEFAULT_BOS_TOKEN,
        "unk_token": DEFAULT_UNK_TOKEN,
    })
    if add_valley_tokens:
        tok.add_tokens(SPECIAL_TOKEN_ORDER, special_tokens=True)
    tokens = SpecialTokens(
        im_patch=tok.convert_tokens_to_ids(DEFAULT_IMAGE_PATCH_TOKEN),
        im_start=tok.convert_tokens_to_ids(DEFAULT_IM_START_TOKEN),
        im_end=tok.convert_tokens_to_ids(DEFAULT_IM_END_TOKEN),
        vi_frame=tok.convert_tokens_to_ids(DEFAULT_VIDEO_FRAME_TOKEN),
        vi_start=tok.convert_tokens_to_ids(DEFAULT_VI_START_TOKEN),
        vi_end=tok.convert_tokens_to_ids(DEFAULT_VI_END_TOKEN),
        pad=tok.pad_token_id,
        bos=tok.bos_token_id,
        eos=tok.eos_token_id,
        unk=tok.unk_token_id if tok.unk_token_id is not None else 0,
    )
    return tok, tokens


@dataclasses.dataclass
class ByteFallbackTokenizer:
    """Minimal self-contained tokenizer: bytes + registered special tokens.

    ids: 0=pad, 1=bos, 2=eos, 3..258 = bytes 0..255, then special tokens.
    Used by unit tests and the CPU demo path; NOT a sentencepiece
    replacement for real checkpoints.
    """

    add_bos: bool = True
    model_max_length: int = 2048

    def __post_init__(self):
        self._specials: dict[str, int] = {}
        self._specials_rev: dict[int, str] = {}
        for t in SPECIAL_TOKEN_ORDER:
            self.add_token(t)
        self.pad_token_id, self.bos_token_id, self.eos_token_id = 0, 1, 2
        self.unk_token_id = 0

    def add_token(self, token: str) -> int:
        if token not in self._specials:
            tid = 259 + len(self._specials)
            self._specials[token] = tid
            self._specials_rev[tid] = token
        return self._specials[token]

    @property
    def vocab_size(self) -> int:
        return 259 + len(self._specials)

    def token_to_id(self, token: str) -> int:
        return self._specials.get(token, self.unk_token_id)

    def convert_tokens_to_ids(self, tokens):
        if isinstance(tokens, str):
            return self.token_to_id(tokens)
        return [self.token_to_id(t) for t in tokens]

    def encode(self, text: str, add_bos: Optional[bool] = None) -> List[int]:
        out: List[int] = [1] if (self.add_bos if add_bos is None else add_bos) else []
        i = 0
        # longest-first special token matching
        specials = sorted(self._specials, key=len, reverse=True)
        while i < len(text):
            for sp in specials:
                if text.startswith(sp, i):
                    out.append(self._specials[sp])
                    i += len(sp)
                    break
            else:
                out.extend(3 + b for b in text[i].encode("utf-8"))
                i += 1
        return out

    def __call__(self, texts, padding=None, **_kw):
        if isinstance(texts, str):
            texts = [texts]
        ids = [self.encode(t) for t in texts]
        if padding:
            n = max(len(x) for x in ids)
            ids = [[self.pad_token_id] * (n - len(x)) + x for x in ids]
        return type("Enc", (), {"input_ids": ids})()

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = True) -> str:
        buf = bytearray()
        out = []
        for tid in ids:
            tid = int(tid)
            if 3 <= tid < 259:
                buf.append(tid - 3)
                continue
            if buf:
                out.append(buf.decode("utf-8", errors="replace"))
                buf = bytearray()
            if tid in self._specials_rev and not skip_special_tokens:
                out.append(self._specials_rev[tid])
            elif tid in (0, 1, 2) and not skip_special_tokens:
                out.append(["[PAD]", "<s>", "</s>"][tid])
        if buf:
            out.append(buf.decode("utf-8", errors="replace"))
        return "".join(out)

    def batch_decode(self, batch, skip_special_tokens: bool = True):
        return [self.decode(ids, skip_special_tokens) for ids in batch]

    def special_tokens(self) -> SpecialTokens:
        return SpecialTokens(
            im_patch=self.token_to_id(DEFAULT_IMAGE_PATCH_TOKEN),
            im_start=self.token_to_id(DEFAULT_IM_START_TOKEN),
            im_end=self.token_to_id(DEFAULT_IM_END_TOKEN),
            vi_frame=self.token_to_id(DEFAULT_VIDEO_FRAME_TOKEN),
            vi_start=self.token_to_id(DEFAULT_VI_START_TOKEN),
            vi_end=self.token_to_id(DEFAULT_VI_END_TOKEN),
            pad=0, bos=1, eos=2, unk=0)
