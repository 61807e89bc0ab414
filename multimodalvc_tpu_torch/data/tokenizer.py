"""Tokenizers: the HF LLaMA tokenizer and a self-contained byte fallback.

Port of ``multimodalvc_tpu/data/tokenizer.py``.  ``load_tokenizer`` returns
the HF tokenizer only when ``llm_path`` loads (a local path or a cached
repo, with ``transformers`` installed); otherwise ``CharTokenizer``, the
byte-level stand-in with LLaMA-compatible special-token slots.
"""
from __future__ import annotations

import logging
from typing import List, Optional, Sequence

logger = logging.getLogger(__name__)

INSTRUCTION_TEXT = "Focus on semantics, not voice characteristics"


class CharTokenizer:
    """Byte-level tokenizer with LLaMA-compatible special-token slots."""

    def __init__(self, vocab_size: int = 512):
        self.vocab_size = max(vocab_size, 260)
        self.bos_token_id = 256
        self.eos_token_id = 257
        self.pad_token_id = 258

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        return ([self.bos_token_id] if add_bos else []) + ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        data = bytes(i for i in ids if i < 256)
        return data.decode("utf-8", errors="ignore")

    def __call__(self, text: str):
        return {"input_ids": self.encode(text)}


class HFTokenizer:
    """Adapter over ``transformers.AutoTokenizer`` with LLaMA-3's specials."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self.tok = AutoTokenizer.from_pretrained(path)
        self.bos_token_id = self.tok.bos_token_id
        self.eos_token_id = self.tok.eos_token_id
        pad = self.tok.convert_tokens_to_ids("<|finetune_right_pad_id|>")
        self.pad_token_id = pad if pad is not None and pad >= 0 else self.tok.eos_token_id
        self.vocab_size = len(self.tok)

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        return self.tok(text, add_special_tokens=add_bos)["input_ids"]

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return self.tok.decode(ids, skip_special_tokens=skip_special_tokens)


def load_tokenizer(llm_path: Optional[str]):
    """The HF tokenizer if ``llm_path`` loads, else ``CharTokenizer``."""
    if llm_path:
        try:
            return HFTokenizer(llm_path)
        except Exception as e:  # offline, no transformers, or missing files
            logger.warning("falling back to CharTokenizer (%s)", e)
    return CharTokenizer()
