"""Tokenizers (twin of ``clusterfusion_tpu/models/tokenizer.py``): SentencePiece
and HuggingFace backends, imported lazily, and a self-contained byte-level
tokenizer for tests and synthetic models."""

from __future__ import annotations

import os
from typing import List


class Tokenizer:
    """SentencePiece tokenizer with bos/eos/pad ids."""

    def __init__(self, model_path: str):
        from sentencepiece import SentencePieceProcessor  # lazy import
        if not os.path.isfile(model_path):
            raise FileNotFoundError(model_path)
        self.sp_model = SentencePieceProcessor(model_file=model_path)
        self.n_words: int = self.sp_model.vocab_size()
        self.bos_id: int = self.sp_model.bos_id()
        self.eos_id: int = self.sp_model.eos_id()
        self.pad_id: int = self.sp_model.pad_id()

    def encode(self, s: str, bos: bool, eos: bool) -> List[int]:
        t = self.sp_model.encode(s)
        if bos:
            t = [self.bos_id] + t
        if eos:
            t = t + [self.eos_id]
        return t

    def decode(self, t: List[int]) -> str:
        return self.sp_model.decode(t)


class HFTokenizer:
    """Adapter for HuggingFace tokenizers."""

    def __init__(self, path_or_name: str):
        from transformers import AutoTokenizer  # lazy import
        self._tok = AutoTokenizer.from_pretrained(path_or_name)
        self.n_words = self._tok.vocab_size
        self.bos_id = self._tok.bos_token_id
        self.eos_id = self._tok.eos_token_id
        self.pad_id = (self._tok.pad_token_id
                       if self._tok.pad_token_id is not None else -1)

    def encode(self, s: str, bos: bool, eos: bool) -> List[int]:
        t = self._tok.encode(s, add_special_tokens=False)
        if bos and self.bos_id is not None:
            t = [self.bos_id] + t
        if eos and self.eos_id is not None:
            t = t + [self.eos_id]
        return t

    def decode(self, t: List[int]) -> str:
        return self._tok.decode(t)


class ByteTokenizer:
    """256 byte symbols + bos/eos/pad."""

    def __init__(self):
        self.bos_id = 256
        self.eos_id = 257
        self.pad_id = 258
        self.n_words = 259

    def encode(self, s: str, bos: bool, eos: bool) -> List[int]:
        t = list(s.encode("utf-8"))
        if bos:
            t = [self.bos_id] + t
        if eos:
            t = t + [self.eos_id]
        return t

    def decode(self, t: List[int]) -> str:
        return bytes(x for x in t if x < 256).decode("utf-8", errors="replace")


def load_tokenizer(path: str):
    """'bytes' -> ByteTokenizer, a directory -> HF, else SentencePiece."""
    if path == "bytes":
        return ByteTokenizer()
    if os.path.isdir(path):
        return HFTokenizer(path)
    return Tokenizer(path)
