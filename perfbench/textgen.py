"""Seeded text: zipf words, fixed length laws, and the hashing tokenizer.

Frozen copies, so that a change to the program cannot move the yardstick:

  * the zipf word law of ``chip_smoke.zipf_corpus`` (words ``t<id>``, word
    ``i`` drawn with probability proportional to 1 / (i + 1));
  * the ids of the port's ``WordHashTokenizer`` (FNV-1a of the lowercased
    word into ``[5, vocab)``; pad 1, cls 0, sep 2, mask 3), written out
    here again so that the reference tokenizes without the program.

Lengths follow a lognormal law, but every seed gets the same multiset of
lengths (the law's quantiles at evenly spaced points), in an order drawn
from the seed: a seed changes which text goes where, never how much work
there is.
"""

from __future__ import annotations

import re
from statistics import NormalDist

import numpy as np

PAD_ID, CLS_ID, SEP_ID, MASK_ID, N_SPECIAL = 1, 0, 2, 3, 5
_WORD_RE = re.compile(r"\w+|[^\w\s]", re.UNICODE)


def zipf_probs(vocab: int) -> np.ndarray:
    p = 1.0 / np.arange(1, vocab + 1)
    return p / p.sum()


def fixed_lengths(n: int, median: float, sigma: float, lo: int, hi: int) -> np.ndarray:
    """The lognormal law's quantiles at (i + 0.5) / n, clipped to [lo, hi]:
    the same n lengths for every seed, in ascending order."""
    nd = NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.clip(np.rint(median * np.exp(sigma * z)), lo, hi).astype(np.int64)


def zipf_texts(rng: np.random.Generator, lengths: np.ndarray, vocab: int):
    """Word ids of texts of the given lengths (flat, with offsets) and the
    texts themselves, ``t<id>`` words joined by spaces."""
    lengths = np.asarray(lengths, np.int64)
    flat = rng.choice(vocab, size=int(lengths.sum()), p=zipf_probs(vocab)).astype(np.int64)
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    words = np.array([f"t{i}" for i in range(vocab)], dtype=object)
    strings = words[flat]
    texts = [" ".join(strings[offsets[i] : offsets[i + 1]]) for i in range(len(lengths))]
    return flat, offsets, texts


def fnv1a(token: str) -> int:
    h = 0xCBF29CE484222325
    for b in token.encode("utf-8"):
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def word_token_table(vocab: int, vocab_size: int) -> np.ndarray:
    """The token id of each word ``t<i>`` under the hashing tokenizer."""
    span = vocab_size - N_SPECIAL
    return np.array([N_SPECIAL + fnv1a(f"t{i}") % span for i in range(vocab)], dtype=np.int64)


def token_ids(text: str, vocab_size: int) -> list[int]:
    """The hashing tokenizer's ids of any text (no special tokens)."""
    span = vocab_size - N_SPECIAL
    return [N_SPECIAL + fnv1a(t) % span for t in _WORD_RE.findall(text.lower())]
