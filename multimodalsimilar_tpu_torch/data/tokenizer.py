"""Tokenization to fixed-shape [B, S] int arrays.

Copied from ``multimodalsimilar_tpu/data/tokenizer.py``. The char
tokenizer reproduces what BERT's Chinese WordPiece does to CJK titles:
every character is a token. ``from_hf`` wraps a Hugging Face tokenizer
from local files (unlike the JAX package's, it does not download a hub
name); transformers is imported inside it, so the port does not depend
on it. ``backend`` says
which encoder runs: ``"native"`` (the C++ batch packer,
native/fastpack.cpp), ``"python"`` or ``"hf"``.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

SPECIALS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")


def build_char_vocab(corpus: Iterable[str], out_path: Optional[str] = None,
                     min_count: int = 1) -> List[str]:
    """Character vocab (BERT vocab.txt layout: one token per line)."""
    counts: Dict[str, int] = {}
    for line in corpus:
        for ch in line:
            if not ch.isspace():
                counts[ch] = counts.get(ch, 0) + 1
    toks = list(SPECIALS) + sorted(
        c for c, n in counts.items() if n >= min_count)
    if out_path:
        with open(out_path, "w", encoding="utf-8") as f:
            f.write("\n".join(toks) + "\n")
    return toks


class TextTokenizer:
    """BERT-style tokenizer producing numpy {input_ids, attention_mask,
    token_type_ids} with static [B, max_length] shapes."""

    def __init__(self, encode_fn, vocab_size: int, pad_id: int = 0,
                 backend: str = "python"):
        self._encode = encode_fn
        self.vocab_size = vocab_size
        self.pad_id = pad_id
        self.backend = backend

    @classmethod
    def from_hf(cls, name_or_path: str) -> "TextTokenizer":
        """HF ``AutoTokenizer`` at ``name_or_path`` (a directory, or a
        name already in the local HF cache: it never downloads), padded
        and truncated to the static [B, max_length] shape."""
        from transformers import AutoTokenizer
        tok = AutoTokenizer.from_pretrained(name_or_path,
                                            local_files_only=True)

        def encode(texts: Sequence[str], max_length: int):
            out = tok(list(texts), padding="max_length",
                      max_length=max_length, truncation=True,
                      return_tensors="np", return_token_type_ids=True)
            return {k: np.asarray(v, np.int32) for k, v in out.items()}

        return cls(encode, tok.vocab_size, tok.pad_token_id or 0, "hf")

    @classmethod
    def from_vocab(cls, tokens: Sequence[str],
                   use_native: bool = True) -> "TextTokenizer":
        index = {t: i for i, t in enumerate(tokens)}
        pad, unk = index["[PAD]"], index["[UNK]"]
        cls_id, sep = index["[CLS]"], index["[SEP]"]

        if use_native:
            from multimodalsimilar_tpu_torch import native
            if native.available():
                enc = native.NativeCharEncoder(list(tokens), pad, unk,
                                               cls_id, sep)
                return cls(enc.encode_batch, len(tokens), pad, "native")

        def encode(texts: Sequence[str], max_length: int):
            if max_length < 3:      # [CLS] + >=1 char + [SEP]
                raise ValueError(
                    f"max_length must be >= 3, got {max_length}")
            B = len(texts)
            ids = np.full((B, max_length), pad, np.int32)
            mask = np.zeros((B, max_length), np.int32)
            for b, text in enumerate(texts):
                chars = [c for c in text if not c.isspace()]
                chars = chars[: max_length - 2]
                row = ([cls_id] + [index.get(c, unk) for c in chars]
                       + [sep])
                ids[b, : len(row)] = row
                mask[b, : len(row)] = 1
            return {"input_ids": ids, "attention_mask": mask,
                    "token_type_ids": np.zeros_like(ids)}

        return cls(encode, len(tokens), pad, "python")

    @classmethod
    def from_corpus(cls, corpus: Iterable[str],
                    save_vocab_path: Optional[str] = None) -> "TextTokenizer":
        tokens = build_char_vocab(corpus, out_path=save_vocab_path)
        return cls.from_vocab(tokens)

    @classmethod
    def from_vocab_file(cls, path: str) -> "TextTokenizer":
        """Load a vocab.txt written by ``from_corpus(save_vocab_path=...)``
        — the persistence that keeps train-time and serve-time token ids
        identical."""
        with open(path, encoding="utf-8") as f:
            tokens = [line.rstrip("\n") for line in f if line.rstrip("\n")]
        return cls.from_vocab(tokens)

    def with_bos(self, bos_id: int) -> "TextTokenizer":
        """This [CLS] ... [SEP] tokenizer as a decoder's: each row is
        ``bos_id`` and then its tokens, without [SEP], padded on the
        right, so a row holds up to ``max_length - 1`` characters. The
        vocabulary grows to hold ``bos_id``."""
        inner, pad = self._encode, self.pad_id

        def encode(texts: Sequence[str], max_length: int):
            out = inner(texts, max_length + 1)
            ids = np.array(out["input_ids"], np.int32)
            mask = np.array(out["attention_mask"], np.int32)
            rows = np.arange(len(ids))
            sep = mask.sum(axis=1) - 1
            ids[rows, sep] = pad
            mask[rows, sep] = 0
            ids[:, 0] = bos_id
            ids, mask = ids[:, :max_length], mask[:, :max_length]
            return {"input_ids": ids, "attention_mask": mask,
                    "token_type_ids": np.zeros_like(ids)}

        return TextTokenizer(encode, max(self.vocab_size, bos_id + 1), pad,
                             self.backend)

    def __call__(self, texts: Sequence[str], max_length: int = 128
                 ) -> Dict[str, np.ndarray]:
        return self._encode(texts, max_length)
