"""The inputs of a hybrid-search cell, made from ``--seed``.

What both the program and the reference receive: the documents' text (for
BM25) and word ids, the query pool, each encoder's weights, and the
corpus-side arrays a deployment would have encoded offline, made on the
device: the ColBERT token index with its length mask, l2-normalized DPR
rows, non-negative sparse SPLADE rows, and the cross-encoder's raw doc
tokens (the hashing tokenizer's ids of each document's first words).

A configuration is one deployment: its model weights and its corpus are
drawn from the configuration's ``world_seed``, and ``--seed`` draws the
traffic: the query pool and, in the loops, its order and arrivals.  With
random weights the neural legs rank nearly the same documents for every
query, so a world drawn per run would hand each run its own fixed set of
documents to rerank, and the rerank's work (their lengths) would swing by
several percent from seed to seed; a fixed world gives every seed the same
documents and sizes, and the queries in its own order.  The host draws from
``numpy.random.default_rng`` and the device from a ``torch.Generator``;
every seed gets the same multiset of query lengths
(``textgen.fixed_lengths``) in its own order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from perfbench import textgen
from perfbench.weights import make_weights

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
CHUNK = 2048  # documents per device draw of the token index


@dataclass
class HybridInputs:
    n_docs: int
    doc_words: np.ndarray  # [N] words per document
    doc_flat: np.ndarray  # word ids of every document, concatenated
    doc_offsets: np.ndarray  # [N + 1]
    doc_texts: list
    query_words: np.ndarray  # [P] words per query of the pool
    query_flat: np.ndarray
    query_offsets: np.ndarray
    query_texts: list
    weights: dict  # model -> {entry: tensor}
    colbert_tokens: torch.Tensor  # [Npad, Ld, D], zero past each doc's length
    colbert_mask: torch.Tensor  # [Npad, Ld] f32
    colbert_lens: np.ndarray  # [N] tokens per document
    dpr_rows: torch.Tensor  # [N, H]
    splade_rows: torch.Tensor  # [N, V]
    ce_doc_tokens: torch.Tensor  # [N, Lce] int16 (uint16 bits)
    ce_doc_mask: torch.Tensor  # [N, Lce] int8
    ce_doc_lens: np.ndarray  # [N] int32


def make_inputs(cfg: dict, traffic: dict, seed: int, device) -> HybridInputs:
    device = torch.device(device)
    enc = cfg["encoder"]
    dtype = DTYPES[enc["dtype"]]
    corpus = cfg["corpus"]
    n, vocab = cfg["n_docs"], corpus["words"]
    world = cfg["world_seed"]
    rng = np.random.default_rng(world)
    gen = torch.Generator(device=device).manual_seed(world)

    doc_words = rng.permutation(textgen.fixed_lengths(n, **corpus["doc_words"]))
    doc_flat, doc_off, doc_texts = textgen.zipf_texts(rng, doc_words, vocab)
    q_rng = np.random.default_rng([seed, 1])
    pool = traffic["query_pool"]
    q_words = q_rng.permutation(textgen.fixed_lengths(pool, **traffic["query_words"]))
    q_flat, q_off, q_texts = textgen.zipf_texts(q_rng, q_words, vocab)

    # one law for every model, unless the configuration names a model's own
    # (``<head>_std``): the draws are the same, only their scale differs
    w = cfg["weights"]
    weights = {
        head: make_weights(enc, head, gen, device, dtype, w.get(f"{head}_std", w["std"]), w["ln_std"],
                           cfg["colbert_dim"])
        for head in ("dense", "splade", "colbert", "cross")
    }

    # ColBERT: unit-norm tokens, [CLS] + words + [SEP] long (cut at Ld), zero past it
    ld, d = cfg["doc_length"], cfg["colbert_dim"]
    n_pad = -(-n // 128) * 128
    cb_lens = np.minimum(doc_words + 2, ld)
    lens_pad = torch.zeros(n_pad, dtype=torch.int64, device=device)
    lens_pad[:n] = torch.as_tensor(cb_lens, device=device)
    mask = (torch.arange(ld, device=device)[None, :] < lens_pad[:, None]).to(torch.float32)
    tokens = torch.empty((n_pad, ld, d), dtype=dtype, device=device)
    for s in range(0, n_pad, CHUNK):
        e = min(s + CHUNK, n_pad)
        x = torch.randn((e - s, ld, d), generator=gen, device=device)
        x = x / x.norm(dim=-1, keepdim=True) * mask[s:e, :, None]
        tokens[s:e] = x.to(dtype)

    h = enc["hidden_size"]
    x = torch.randn((n, h), generator=gen, device=device)
    dpr_rows = (x / x.norm(dim=1, keepdim=True)).to(dtype)

    # SPLADE: each document activates up to ``splade_doc_terms`` vocabulary
    # entries (as many as its words), weights in [0.05, 3)
    v = enc["vocab_size"]
    terms = np.minimum(doc_words, corpus["splade_doc_terms"])
    k = int(terms.max())
    cols = torch.randint(textgen.N_SPECIAL, v, (n, k), generator=gen, device=device)
    vals = torch.rand((n, k), generator=gen, device=device) * 2.95 + 0.05
    vals = vals * (torch.arange(k, device=device)[None, :] < torch.as_tensor(terms, device=device)[:, None])
    # a column drawn twice keeps its first value: adding zeros is exact in
    # any order, so the rows do not depend on the scatter's
    cols, order = torch.sort(cols, dim=1, stable=True)
    vals = torch.gather(vals, 1, order)
    vals[:, 1:] *= cols[:, 1:] != cols[:, :-1]
    splade_rows = torch.zeros((n, v), dtype=dtype, device=device)
    splade_rows.scatter_add_(1, cols, vals.to(dtype))

    # the cross-encoder's raw doc tokens: the hashing tokenizer's ids of the
    # first Lce words (no specials)
    lce = cfg["ce_max_length"] - 36
    table = torch.as_tensor(textgen.word_token_table(vocab, v), device=device)
    flat = torch.as_tensor(doc_flat, device=device)
    starts = torch.as_tensor(doc_off[:-1], device=device)
    ce_lens = np.minimum(doc_words, lce).astype(np.int32)
    col = torch.arange(lce, device=device)[None, :]
    valid = col < torch.as_tensor(ce_lens, device=device)[:, None].long()
    pos = (starts[:, None] + col).clamp(max=flat.shape[0] - 1)
    ids = torch.where(valid, table[flat[pos]], textgen.PAD_ID)
    return HybridInputs(
        n_docs=n, doc_words=doc_words, doc_flat=doc_flat, doc_offsets=doc_off, doc_texts=doc_texts,
        query_words=q_words, query_flat=q_flat, query_offsets=q_off, query_texts=q_texts,
        weights=weights, colbert_tokens=tokens, colbert_mask=mask, colbert_lens=cb_lens,
        dpr_rows=dpr_rows, splade_rows=splade_rows,
        ce_doc_tokens=ids.to(torch.int32).to(torch.int16), ce_doc_mask=valid.to(torch.int8),
        ce_doc_lens=ce_lens,
    )
