"""Special-token table and tokenizer front (copy of the parts of
kalle_tpu/data/tokens.py the training path uses).

The reference registers 8 audio special tokens on top of Llama-3's 128256
vocab and packs prompts as
`text_ids + [SPEECH_UNDERSTANDING_END, SPEECH_GENERATION_START]`.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

SPECIAL_TOKENS = (
    "<|TEXT_GENERATION_START|>",      # 128256
    "<|TEXT_GENERATION_END|>",        # 128257
    "<|TEXT_UNDERSTANDING_START|>",   # 128258
    "<|TEXT_UNDERSTANDING_END|>",     # 128259
    "<|SPEECH_GENERATION_START|>",    # 128260
    "<|SPEECH_GENERATION_END|>",      # 128261
    "<|SPEECH_UNDERSTANDING_START|>", # 128262
    "<|SPEECH_UNDERSTANDING_END|>",   # 128263
)


@dataclass(frozen=True)
class SpecialIds:
    text_generation_start: int = 128256
    text_generation_end: int = 128257
    text_understanding_start: int = 128258
    text_understanding_end: int = 128259
    speech_generation_start: int = 128260
    speech_generation_end: int = 128261
    speech_understanding_start: int = 128262
    speech_understanding_end: int = 128263

    @staticmethod
    def from_base(base_vocab: int) -> "SpecialIds":
        return SpecialIds(*(base_vocab + i for i in range(8)))


class ByteTokenizer:
    """Byte-level tokenizer for hosts without the Llama tokenizer files:
    ids 0-255 are raw bytes, 256 = pad, specials at base_vocab..base_vocab+7."""

    def __init__(self, base_vocab: int = 257):
        self.base_vocab = base_vocab
        self.pad_token_id = 256
        self.special = SpecialIds.from_base(base_vocab)
        self.vocab_size = base_vocab + 8

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))


class HFTokenizer:
    """A HuggingFace tokenizer read from a local directory only (the
    reference's `tokenizer_path`); adds the 8 special tokens if absent."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self.tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        missing = [t for t in SPECIAL_TOKENS
                   if self.tok.convert_tokens_to_ids(t) in (None, self.tok.unk_token_id)]
        if missing:
            self.tok.add_special_tokens({"additional_special_tokens": list(missing)})
        if self.tok.pad_token_id is None:
            self.tok.pad_token = self.tok.eos_token
        self.pad_token_id = self.tok.pad_token_id
        self.special = SpecialIds(*(self.tok.convert_tokens_to_ids(t) for t in SPECIAL_TOKENS))
        self.vocab_size = len(self.tok)

    def encode(self, text: str) -> List[int]:
        return self.tok.encode(text)


def build_tokenizer(path: Optional[str] = None):
    """The HF tokenizer in the local directory `path`, else the byte one."""
    if path:
        if not os.path.isdir(path):
            raise FileNotFoundError(f"tokenizer_path {path!r} is not a local directory")
        return HFTokenizer(path)
    return ByteTokenizer()


def build_prompt_ids(tokenizer, text: str) -> List[int]:
    """text ids + [SPEECH_UNDERSTANDING_END, SPEECH_GENERATION_START]."""
    sp = tokenizer.special
    return list(tokenizer.encode(text)) + [sp.speech_understanding_end,
                                           sp.speech_generation_start]
