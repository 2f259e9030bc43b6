"""Host-side tokenization feeding fixed-shape batches (numpy only).

``WordHashTokenizer`` is the dependency-free tokenizer: whitespace+punct
split, stable FNV-1a hash into a fixed vocab.  ``HFTokenizer`` wraps a
HuggingFace tokenizer from a local directory with the same call contract
(it imports ``transformers`` when it is built, so this module imports
without it).  ``TextEncoder`` carries the query/doc asymmetry (max
lengths, prefixes, mask-token augmentation); ``pair_encode_simple`` lays
out cross-encoder pairs.  All give the same ids as
``fusion_tpu.data.tokenization``, so one corpus indexes identically in
either package.
"""

from __future__ import annotations

import functools
import re
from typing import Sequence

import numpy as np

_WORD_RE = re.compile(r"\w+|[^\w\s]", re.UNICODE)


# memoized: a corpus repeats a small vocabulary, and the byte loop below
# dominated the host time of encoding a corpus
@functools.lru_cache(maxsize=1 << 18)
def _fnv1a(token: str) -> int:
    h = 0xCBF29CE484222325
    for b in token.encode("utf-8"):
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


class WordHashTokenizer:
    """Stable hashed word-piece-free tokenizer over a fixed vocab size.

    Special ids: pad=1, cls=0, sep=2, mask=3, unk=4; words hash into
    [5, vocab).
    """

    def __init__(self, vocab_size: int = 32005, lowercase: bool = True):
        self.vocab_size = vocab_size
        self.lowercase = lowercase
        self.pad_token_id = 1
        self.cls_token_id = 0
        self.sep_token_id = 2
        self.mask_token_id = 3
        self.num_special = 5

    def token_ids(self, text: str) -> list[int]:
        if self.lowercase:
            text = text.lower()
        span = self.vocab_size - self.num_special
        return [
            self.num_special + (_fnv1a(t) % span) for t in _WORD_RE.findall(text)
        ]

    def __call__(
        self,
        texts: Sequence[str],
        max_length: int,
        add_special_tokens: bool = True,
        pad_to_max: bool = True,
    ) -> tuple[np.ndarray, np.ndarray]:
        rows = []
        for t in texts:
            ids = self.token_ids(t)
            budget = max_length - (2 if add_special_tokens else 0)
            ids = ids[:budget]
            if add_special_tokens:
                ids = [self.cls_token_id] + ids + [self.sep_token_id]
            rows.append(ids)
        width = max_length if pad_to_max else max((len(r) for r in rows), default=1)
        out = np.full((len(texts), width), self.pad_token_id, dtype=np.int32)
        mask = np.zeros((len(texts), width), dtype=np.int32)
        for i, r in enumerate(rows):
            out[i, : len(r)] = r
            mask[i, : len(r)] = 1
        return out, mask


class HFTokenizer:
    """HuggingFace tokenizer adapter with ``WordHashTokenizer``'s call
    contract: ``__call__`` pads to ``max_length`` (or the longest row) and
    ``pair`` lays out (query, doc) pairs as the tokenizer's own pair
    template does, both truncating, → int32 (ids, mask)."""

    def __init__(self, model_name_or_path: str):
        from transformers import AutoTokenizer

        self.name_or_path = str(model_name_or_path)  # persisted by save()
        self.tok = AutoTokenizer.from_pretrained(model_name_or_path)
        self.pad_token_id = self.tok.pad_token_id
        self.cls_token_id = self.tok.cls_token_id
        self.sep_token_id = self.tok.sep_token_id
        self.mask_token_id = self.tok.mask_token_id
        self.vocab_size = len(self.tok)

    def __call__(
        self,
        texts: Sequence[str],
        max_length: int,
        add_special_tokens: bool = True,
        pad_to_max: bool = True,
    ) -> tuple[np.ndarray, np.ndarray]:
        enc = self.tok(
            list(texts),
            padding="max_length" if pad_to_max else "longest",
            truncation=True,
            max_length=max_length,
            add_special_tokens=add_special_tokens,
            return_attention_mask=True,
            return_tensors="np",
        )
        return enc["input_ids"].astype(np.int32), enc["attention_mask"].astype(np.int32)

    def pair(self, queries: Sequence[str], docs: Sequence[str], max_length: int) -> tuple[np.ndarray, np.ndarray]:
        enc = self.tok(
            list(queries),
            list(docs),
            padding="max_length",
            truncation=True,
            max_length=max_length,
            return_attention_mask=True,
            return_tensors="np",
        )
        return enc["input_ids"].astype(np.int32), enc["attention_mask"].astype(np.int32)


def pair_encode_simple(
    tok: WordHashTokenizer, queries: Sequence[str], docs: Sequence[str], max_length: int
) -> tuple[np.ndarray, np.ndarray]:
    """(query, doc) pair encoding for the hashing tokenizer:
    ``[CLS] q [SEP] d [SEP]``, the query cut to ``max_length // 3`` tokens."""
    ids = np.full((len(queries), max_length), tok.pad_token_id, dtype=np.int32)
    mask = np.zeros((len(queries), max_length), dtype=np.int32)
    for i, (q, d) in enumerate(zip(queries, docs)):
        row = [tok.cls_token_id] + tok.token_ids(q)[: max_length // 3] + [tok.sep_token_id]
        row += tok.token_ids(d)[: max_length - len(row) - 1] + [tok.sep_token_id]
        row = row[:max_length]
        ids[i, : len(row)] = row
        mask[i, : len(row)] = 1
    return ids, mask


class TextEncoder:
    """Tokenization policy shared by the bi-encoder family: max lengths,
    prefixes, and mask-token augmentation to max length."""

    def __init__(
        self,
        tokenizer,
        max_query_length: int = 32,
        max_doc_length: int = 128,
        query_prefix: str | None = None,
        doc_prefix: str | None = None,
        augment_query_to_maxlen: bool = False,
        augment_doc_to_maxlen: bool = False,
        do_lowercase: bool = False,
        add_special_tokens: bool = True,
    ):
        self.tokenizer = tokenizer
        self.max_query_length = max_query_length
        self.max_doc_length = max_doc_length
        self.query_prefix = query_prefix
        self.doc_prefix = doc_prefix
        self.augment_query_to_maxlen = augment_query_to_maxlen
        self.augment_doc_to_maxlen = augment_doc_to_maxlen
        self.do_lowercase = do_lowercase
        self.add_special_tokens = add_special_tokens

    def encode(
        self, texts: Sequence[str], query_mode: bool, pad_to: int | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """Tokenize a batch; ``pad_to`` overrides the static max length
        (used by length-bucketed encoding — always ≤ the mode's max)."""
        prefix = self.query_prefix if query_mode else self.doc_prefix
        if prefix:
            texts = [prefix + t for t in texts]
        if self.do_lowercase:
            texts = [t.lower() for t in texts]
        max_len = self.max_query_length if query_mode else self.max_doc_length
        if pad_to is not None:
            max_len = min(pad_to, max_len)
        ids, mask = self.tokenizer(
            texts, max_length=max_len, add_special_tokens=self.add_special_tokens
        )
        augment = self.augment_query_to_maxlen if query_mode else self.augment_doc_to_maxlen
        if augment:
            # pad → [MASK] with attention on (ColBERT query augmentation)
            pads = ids == self.tokenizer.pad_token_id
            ids = np.where(pads, self.tokenizer.mask_token_id, ids)
            mask = np.where(pads, 1, mask)
        return ids, mask


def tokenizer_config(tokenizer) -> dict:
    """The tokenizer's identity as a checkpoint's config stores it, so that
    ``load`` rebuilds the same tokenization."""
    if hasattr(tokenizer, "name_or_path"):
        return {"kind": "hf", "name_or_path": tokenizer.name_or_path}
    return {
        "kind": "wordhash",
        "vocab_size": tokenizer.vocab_size,
        "lowercase": getattr(tokenizer, "lowercase", True),
    }


def tokenizer_from_config(tok_cfg):
    """Inverse of :func:`tokenizer_config`; None for configs without one."""
    if tok_cfg is None:
        return None
    if tok_cfg.get("kind") == "hf":
        try:
            return HFTokenizer(tok_cfg["name_or_path"])
        except Exception as e:
            raise RuntimeError(
                f"checkpoint was trained with the HF tokenizer {tok_cfg['name_or_path']!r}, which could not be "
                "loaded — pass tokenizer= explicitly (the hash fallback would make token ids meaningless)"
            ) from e
    if tok_cfg.get("kind") == "wordhash":
        return WordHashTokenizer(
            vocab_size=tok_cfg["vocab_size"], lowercase=tok_cfg.get("lowercase", True)
        )
    return None
