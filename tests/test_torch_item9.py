"""The last small functions of the scale slice against the JAX package:
``index/inverted.chunked_impact_search`` (the sort form over the chunked
impact index, f16 and f32 payloads, packed and key + payload sorts),
``ops/mips.chunked_encode_search`` and ``models/biencoder.decode_splade_vector``.

Tolerances: the packed sort orders each doc's run by (doc, impact bits) in
both packages, so its sums are bit-equal; the key + payload sort leaves the
order inside a run to the sort (XLA's is not stable), so those sums agree
within 2e-6 relative (f32 adds of ~10 terms); ids agree position by
position except inside runs of reference scores that tie within that
(``assert_ranked_match``).  ``chunked_encode_search``'s f32 products sum
in another order: scores within 1e-6 of the largest (at least 1);
``decode_splade_vector`` is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import DEVICE, assert_ranked_match

from fusion_tpu.index import inverted as jax_inv
from fusion_tpu.models.biencoder import decode_splade_vector as jax_decode
from fusion_tpu.ops import mips as jax_mips
from fusion_tpu_torch.index import inverted
from fusion_tpu_torch.models.biencoder import decode_splade_vector
from fusion_tpu_torch.ops import mips


@pytest.fixture(scope="module")
def chunked():
    """One chunked index in both packages (4 chunks, one ragged): 9000 docs,
    vocab 120, some (term, chunk) groups past the cap."""
    rng = np.random.default_rng(7)
    n_docs, vocab = 9000, 120
    doc = np.repeat(np.arange(n_docs, dtype=np.int64), 6)
    term = rng.integers(0, vocab, size=doc.size)
    pair = np.unique(term * n_docs + doc)
    term, doc = pair // n_docs, pair % n_docs
    imp = rng.uniform(0.1, 2.0, size=term.size).astype(np.float32)
    kw = dict(vocab_size=vocab, n_docs=n_docs, docs_per_chunk=2560, cap_per_chunk=48, use_native=False)
    want = jax_inv.build_chunked_impact_index(term, doc, imp, **kw)
    got = inverted.build_chunked_impact_index(term, doc, imp, **kw, device=DEVICE)
    q, kq = 6, 8
    qt = rng.integers(0, vocab, size=(q, kq)).astype(np.int32)
    qw = rng.uniform(0.2, 1.5, size=(q, kq)).astype(np.float32)
    qt[0, kq // 2:], qw[0, kq // 2:] = vocab, 0.0  # pad slots
    qt[-1], qw[-1] = vocab, 0.0  # a query of pads only
    return want, got, qt, qw


@pytest.mark.parametrize("bf16_payload, packed_sort", [(True, True), (True, False), (False, True), (False, False)],
                         ids=["f16-packed", "f16-keyval", "f32-packed_ignored", "f32-keyval"])
@pytest.mark.parametrize("k, local_k", [(50, 16), (300, 128), (20000, 4)], ids=["k50", "local_wide", "k_past_n"])
def test_chunked_impact_search_matches_jax(chunked, bf16_payload, packed_sort, k, local_k):
    want_i, got_i, qt, qw = chunked
    w = jax_inv.chunked_impact_search(jnp.asarray(qt), jnp.asarray(qw), want_i, k=k, local_k=local_k,
                                      bf16_payload=bf16_payload, packed_sort=packed_sort)
    g = inverted.chunked_impact_search(torch.from_numpy(qt), torch.from_numpy(qw), got_i, k=k, local_k=local_k,
                                       bf16_payload=bf16_payload, packed_sort=packed_sort)
    assert g.ids.dtype == torch.int32 and g.ids.shape == w.ids.shape
    w_ids, w_sc = np.asarray(w.ids), np.asarray(w.scores)
    g_ids, g_sc = g.ids.numpy(), g.scores.numpy()
    np.testing.assert_array_equal(np.isfinite(g_sc), np.isfinite(w_sc))
    np.testing.assert_array_equal(g_ids[~np.isfinite(g_sc)], -1)
    fin = np.isfinite(w_sc)
    exact = bf16_payload and packed_sort
    if exact:
        np.testing.assert_array_equal(g_sc[fin], w_sc[fin])
    # the depth cut may fall inside a run of ties
    assert_ranked_match(g_ids, np.where(fin, g_sc, -1.0), w_ids, np.where(fin, w_sc, -1.0),
                        atol=0.0 if exact else 2e-6 * float(np.abs(w_sc[fin]).max()), cut_ties=True)


def test_chunked_impact_search_defaults_and_empty_query(chunked):
    want_i, got_i, qt, qw = chunked
    w = jax_inv.chunked_impact_search(jnp.asarray(qt), jnp.asarray(qw), want_i)
    g = inverted.chunked_impact_search(torch.from_numpy(qt), torch.from_numpy(qw), got_i)
    assert g.ids.shape == (qt.shape[0], 1000)
    np.testing.assert_array_equal(g.scores.numpy(), np.asarray(w.scores))
    assert (g.ids.numpy()[-1] == -1).all() and np.isneginf(g.scores.numpy()[-1]).all()


@pytest.mark.parametrize("similarity", ["cos_sim", "dot"])
def test_chunked_encode_search_matches_jax(similarity):
    rng = np.random.default_rng(5)
    corpus = rng.normal(size=(300, 16)).astype(np.float32)
    table = rng.normal(size=(40, 16)).astype(np.float32)  # "query embeddings" looked up by index
    batches = [[0, 1, 2, 3], [4, 5, 6], [7]]
    w = jax_mips.chunked_encode_search(lambda b: jnp.asarray(table[b]), batches, jnp.asarray(corpus), k=25,
                                       similarity=similarity)
    g = mips.chunked_encode_search(lambda b: torch.from_numpy(table[b]), batches, torch.from_numpy(corpus), k=25,
                                   similarity=similarity)
    assert g.ids.shape == (8, 25)
    w_sc = np.asarray(w.scores)
    assert_ranked_match(g.ids.numpy(), g.scores.numpy(), np.asarray(w.ids), w_sc,
                        atol=1e-6 * max(1.0, float(np.abs(w_sc).max())))


class _Tok:
    class tok:  # noqa: N801 - the HF tokenizer's attribute name
        @staticmethod
        def convert_ids_to_tokens(ids):
            return [f"w{i}" for i in ids]


@pytest.mark.parametrize("tokenizer", [None, _Tok()], ids=["ids", "hf_tokens"])
@pytest.mark.parametrize("topk_tokens", [96, 5])
def test_decode_splade_vector_matches_jax(tokenizer, topk_tokens):
    rng = np.random.default_rng(9)
    acts = np.maximum(rng.normal(size=(4, 300)), 0).astype(np.float32) * 0.05
    acts[1] = 0.0  # nothing active
    acts[2, :3] = [0.004, 0.006, 0.5]  # rounds to 0, to 1, to 50
    want = jax_decode(acts, tokenizer, topk_tokens=topk_tokens)
    assert decode_splade_vector(acts, tokenizer, topk_tokens=topk_tokens) == want
    assert decode_splade_vector(torch.from_numpy(acts).to(torch.bfloat16).float(), tokenizer,
                                topk_tokens=topk_tokens) == jax_decode(
        torch.from_numpy(acts).to(torch.bfloat16).float().numpy(), tokenizer, topk_tokens=topk_tokens)
    assert want[1] == {}
