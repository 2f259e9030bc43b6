"""fusion_tpu_torch's monoBERT cross-encoder against the JAX package's.

The JAX model is built at ``EncoderConfig.tiny(vocab_size=512)`` in f32; its
Flax params go through ``convert.crossencoder_state_dict`` into the port.
The same token arrays (and texts) feed both.  Tolerances: the forward
passes at atol 1e-5 (f32 both sides; only the order of sums differs), the
rerank logits at rtol/atol 2e-5 (the JAX package's own bound for chunked
and packed scoring, ``tests/test_serving.py``); the tokenization, the
packing plan and the assembled packed rows are integer-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import DEVICE

from fusion_tpu.data.tokenization import pair_encode_simple as jax_pair_encode
from fusion_tpu.models.crossencoder import CrossEncoder as JaxCrossEncoder
from fusion_tpu.models.crossencoder import CrossEncoderModule as JaxModule
from fusion_tpu.models.crossencoder import PairRerankMixin
from fusion_tpu.models.encoder import Encoder as JaxEncoder
from fusion_tpu.models.encoder import EncoderConfig as JaxConfig
from fusion_tpu_torch.core.ranked import RankedLists
from fusion_tpu_torch.data.tokenization import pair_encode_simple
from fusion_tpu_torch.models import convert
from fusion_tpu_torch.models.crossencoder import CrossEncoder
from fusion_tpu_torch.models.encoder import EncoderConfig

ATOL, RERANK_TOL = 1e-5, 2e-5
DOCS = [
    "le chat noir dort sur le tapis du salon",
    "le chien aboie fort dans le jardin",
    "la voiture rouge roule sur la route",
    "le tribunal rend un jugement important",
    "un contrat de travail est signé",
    "la loi protège les consommateurs",
    "le chat gris mange une souris",
    "les oiseaux chantent dans la forêt",
    "один",  # one token
]
QUERIES = ["chat tapis", "jugement tribunal", "contrat travail"]
HEAD = np.array([[0, 3, 8, -1], [5, 1, 2, 6], [7, 4, 0, -1]], np.int32)


@pytest.fixture(scope="module")
def pair():
    """(JAX cross-encoder, the port's) at max_length 64, same weights."""
    want = JaxCrossEncoder(JaxConfig.tiny(vocab_size=512), max_length=64)
    got = CrossEncoder(
        EncoderConfig.tiny(vocab_size=512), params=convert.crossencoder_state_dict(want.params),
        max_length=64, device=DEVICE,
    )
    return want, got


@pytest.fixture(scope="module")
def tokens(pair):
    """Both packages' corpus and query tokens (docs 24 wide, queries 6)."""
    want, got = pair
    w_doc = want.prepare_corpus_tokens(DOCS, max_doc_tokens=24, return_lens=True)
    g_doc = got.prepare_corpus_tokens(DOCS, max_doc_tokens=24, return_lens=True)
    q_ids, q_mask = want.encode_queries_raw(QUERIES, max_query_tokens=6)
    return w_doc, g_doc, (np.asarray(q_ids), np.asarray(q_mask))


def _packed_rows(rng, n_rows=3, width=40):
    """Hand-made packed rows: pairs of random lengths back to back, segment
    ids per pair, positions restarting at each pair, a padded tail."""
    ids = np.ones((n_rows, width), np.int32)
    mask = np.zeros_like(ids)
    seg = np.zeros_like(ids)
    pos = np.full_like(ids, 1)
    for r in range(n_rows):
        col, p = 0, 1
        while col < width - 6:
            ln = int(rng.integers(3, 12))
            ln = min(ln, width - col)
            ids[r, col : col + ln] = rng.integers(5, 512, size=ln)
            mask[r, col : col + ln] = 1
            seg[r, col : col + ln] = p
            pos[r, col : col + ln] = np.arange(ln) + 2
            col, p = col + ln, p + 1
    return ids, mask, seg, pos


def test_token_layouts_match(pair, tokens):
    want, got = pair
    (w_ids, w_mask, w_lens), (g_ids, g_mask, g_lens), _ = tokens
    assert g_ids.dtype == torch.int16 and g_mask.dtype == torch.int8  # uint16 bits, as JAX's uint16
    np.testing.assert_array_equal(CrossEncoder._token_ids(g_ids).numpy(), np.asarray(w_ids).astype(np.int64))
    np.testing.assert_array_equal(g_mask.numpy(), np.asarray(w_mask))
    np.testing.assert_array_equal(g_lens, w_lens)
    for got_arr, want_arr in zip(got.encode_queries_raw(QUERIES, 6), want.encode_queries_raw(QUERIES, 6)):
        np.testing.assert_array_equal(got_arr, np.asarray(want_arr))
    queries, docs = QUERIES * 3, DOCS[:9]
    for got_arr, want_arr in zip(pair_encode_simple(got.tokenizer, queries, docs, 12),
                                 jax_pair_encode(want.tokenizer, queries, docs, 12)):
        np.testing.assert_array_equal(got_arr, want_arr)


def test_forward_and_packed_forward_match_flax(pair, rng):
    want, got = pair
    ids, mask, seg, pos = _packed_rows(rng)
    t = lambda x: torch.from_numpy(x).long()  # noqa: E731
    with torch.inference_mode():
        # the trunk with caller positions and block-diagonal segments
        hidden = got.module.encoder(t(ids), t(mask), t(pos), t(seg)).numpy()
        logits = got.module(t(ids), t(mask)).numpy()
        rows, cols = np.nonzero((pos == 2) & (mask > 0))  # every pair's CLS slot
        packed = got.module.packed(t(ids), t(mask), t(pos), t(seg), t(rows), t(cols)).numpy()
    enc = {"params": want.params["params"]["encoder"]}
    w_hidden = JaxEncoder(want.cfg).apply(
        enc, jnp.asarray(ids), jnp.asarray(mask), True, position_ids=jnp.asarray(pos), segment_ids=jnp.asarray(seg)
    )
    np.testing.assert_allclose(hidden, np.asarray(w_hidden), atol=ATOL, rtol=0)
    np.testing.assert_allclose(logits, np.asarray(want.module.apply(want.params, ids, mask)), atol=ATOL, rtol=0)
    w_packed = want.module.apply(
        want.params, ids, mask, pos, seg, rows, cols, method=JaxModule.packed
    )
    np.testing.assert_allclose(packed, np.asarray(w_packed), atol=ATOL, rtol=0)
    assert np.isfinite(hidden).all()  # the padded tails stay finite


def _flat_inputs(tokens, torch_side: bool):
    (w_ids, w_mask, _), (g_ids, g_mask, _), (q_ids, q_mask) = tokens
    cand = np.clip(HEAD, 0, len(DOCS) - 1)
    valid = (HEAD >= 0)[..., None]
    if torch_side:
        c = torch.from_numpy(cand).long()
        return (torch.from_numpy(q_ids).long(), torch.from_numpy(q_mask).long(),
                CrossEncoder._token_ids(g_ids[c]), g_mask[c].long() * torch.from_numpy(valid))
    return (jnp.asarray(q_ids), jnp.asarray(q_mask), w_ids[cand].astype(jnp.int32),
            w_mask[cand].astype(jnp.int32) * valid)


@pytest.mark.parametrize("pair_chunk", [64, 2])
def test_rerank_tokens_matches_and_is_chunk_invariant(pair, tokens, pair_chunk):
    want, got = pair
    w = np.asarray(want.rerank_tokens(want.params, *_flat_inputs(tokens, False), pair_chunk=4))
    g = got.rerank_tokens(*_flat_inputs(tokens, True), pair_chunk=pair_chunk).numpy()
    np.testing.assert_allclose(g, w, rtol=RERANK_TOL, atol=RERANK_TOL)
    one = got.rerank_tokens(*_flat_inputs(tokens, True), pair_chunk=64).numpy()
    np.testing.assert_allclose(g, one, rtol=RERANK_TOL, atol=RERANK_TOL)


@pytest.mark.parametrize("width", [256, 300])
def test_pack_pairs_matches(rng, width):
    plen = rng.integers(10, 200, size=400).astype(np.int32)
    for got_arr, want_arr in zip(CrossEncoder.pack_pairs(plen, width), PairRerankMixin.pack_pairs(plen, width)):
        np.testing.assert_array_equal(got_arr, want_arr)
    with pytest.raises(ValueError):
        CrossEncoder.pack_pairs(np.array([width + 1]), width)


@pytest.mark.parametrize("row_width, rpc", [(128, None), (64, 2), (None, None), (48, 1)])
def test_plan_and_assembled_rows_match(pair, tokens, row_width, rpc):
    want, got = pair
    (w_ids, _, w_lens), (g_ids, _, g_lens), (q_ids, q_mask) = tokens
    q_lens = q_mask.sum(axis=1).astype(np.int32)
    args = (HEAD, w_lens, q_lens, 6, 24, len(DOCS))
    w_plan = want.plan_packed(*args, row_width=row_width, rows_per_chunk=rpc)
    g_plan = got.plan_packed(*args, row_width=row_width, rows_per_chunk=rpc)
    for g_arr, w_arr in zip(g_plan, w_plan):
        np.testing.assert_array_equal(g_arr, w_arr)
    desc, _, width, nchunks, rows_per_chunk, _ = w_plan
    assert got._packed_consts == want._packed_consts
    w_rows = want.assemble_packed_rows(
        jnp.asarray(desc), jnp.asarray(q_ids), w_ids[desc[1]].astype(jnp.int32), nchunks * rows_per_chunk,
        width, want._packed_consts,
    )
    g_rows = got.assemble_packed_rows(
        torch.from_numpy(desc), torch.from_numpy(q_ids), CrossEncoder._token_ids(g_ids[torch.from_numpy(desc[1]).long()]),
        nchunks * rows_per_chunk, width, got._packed_consts,
    )
    for g_arr, w_arr in zip(g_rows, w_rows):
        np.testing.assert_array_equal(g_arr.numpy(), np.asarray(w_arr))


@pytest.mark.parametrize("chunk_multiple", [1, 2, 8])
@pytest.mark.parametrize("row_width, rpc", [(48, 1), (64, 2), (None, None)])
def test_plan_chunk_multiple_matches_jax(pair, tokens, row_width, rpc, chunk_multiple):
    """The sharded packed rerank's plan: the chunk count rounded up to a
    multiple of the ranks, so each scores whole chunks; JAX's arrays."""
    want, got = pair
    (_, _, w_lens), _, (_, q_mask) = tokens
    args = (HEAD, w_lens, q_mask.sum(axis=1).astype(np.int32), 6, 24, len(DOCS))
    kw = dict(row_width=row_width, rows_per_chunk=rpc, chunk_multiple=chunk_multiple)
    w_plan, g_plan = want.plan_packed(*args, **kw), got.plan_packed(*args, **kw)
    for g_arr, w_arr in zip(g_plan, w_plan):
        np.testing.assert_array_equal(g_arr, w_arr)
    assert g_plan[3] % chunk_multiple == 0 and g_plan[1].shape[0] == g_plan[3]


@pytest.mark.parametrize("row_width, rpc", [(128, None), (64, 2), (None, None)])
def test_rerank_tokens_packed_matches_jax_and_flat(pair, tokens, row_width, rpc):
    want, got = pair
    (w_ids, w_mask, w_lens), (g_ids, g_mask, g_lens), (q_ids, q_mask) = tokens
    q_lens = q_mask.sum(axis=1).astype(np.int32)
    w = np.asarray(want.rerank_tokens_packed(
        want.params, jnp.asarray(q_ids), jnp.asarray(q_mask), w_ids, w_mask, HEAD, w_lens, q_lens,
        row_width=row_width, rows_per_chunk=rpc,
    ))
    g = got.rerank_tokens_packed(
        torch.from_numpy(q_ids).long(), torch.from_numpy(q_mask).long(), g_ids, g_mask, HEAD, g_lens, q_lens,
        row_width=row_width, rows_per_chunk=rpc,
    ).numpy()
    np.testing.assert_allclose(g, w, rtol=RERANK_TOL, atol=RERANK_TOL)
    flat = got.rerank_tokens(*_flat_inputs(tokens, True), pair_chunk=4).numpy()
    np.testing.assert_allclose(g, flat, rtol=RERANK_TOL, atol=RERANK_TOL)


def test_packed_rows_wider_than_max_position(pair, tokens):
    """Packed positions are bounded by pair length, not row width (tiny
    max_position 66 < row width 128)."""
    _, got = pair
    assert got.cfg.max_position < 128
    _, (g_ids, g_mask, g_lens), (q_ids, q_mask) = tokens
    head = np.array([[0, 1], [2, 3], [4, 5]], np.int32)
    out = got.rerank_tokens_packed(
        torch.from_numpy(q_ids).long(), torch.from_numpy(q_mask).long(), g_ids[:, :16], g_mask[:, :16],
        head, np.minimum(g_lens, 16), q_mask.sum(axis=1), row_width=128,
    )
    assert torch.isfinite(out).all()


def test_predict_rank_and_rerank_match(pair):
    want, got = pair
    pairs = [(q, d) for q in QUERIES for d in DOCS[:5]]
    for apply_sigmoid in (True, False):
        np.testing.assert_allclose(
            got.predict(pairs, batch_size=4, apply_sigmoid=apply_sigmoid),
            want.predict(pairs, batch_size=4, apply_sigmoid=apply_sigmoid), atol=ATOL, rtol=0,
        )
    g_rank, w_rank = got.rank(QUERIES[0], DOCS, top_k=5), want.rank(QUERIES[0], DOCS, top_k=5)
    assert [r["corpus_id"] for r in g_rank] == [r["corpus_id"] for r in w_rank]
    np.testing.assert_allclose([r["score"] for r in g_rank], [r["score"] for r in w_rank], atol=ATOL)
    cand_ids = np.array([[4, 0, 6, -1, 2], [3, 1, 8, 5, 7], [2, 4, -1, -1, 0]], np.int32)
    scores = np.linspace(1.0, 0.0, 5, dtype=np.float32)[None].repeat(3, 0)
    corpus = dict(enumerate(DOCS))
    from fusion_tpu.core.ranked import RankedLists as JaxRanked

    w = want.rerank(QUERIES, JaxRanked(jnp.asarray(cand_ids), jnp.asarray(scores)), corpus, top_k=4)
    g = got.rerank(QUERIES, RankedLists(torch.from_numpy(cand_ids), torch.from_numpy(scores)), corpus, top_k=4)
    np.testing.assert_array_equal(g.ids.numpy(), np.asarray(w.ids))
    np.testing.assert_allclose(g.scores.numpy(), np.asarray(w.scores), atol=ATOL, rtol=0)


def test_unported_views_raise(pair):
    """The views are ported: ``quantized()`` and ``with_attention`` hold the
    same parameters and score as JAX's views (within 1e-3 for int8, where an
    activation one f32 bit off may move a code, and 1e-2 for einsum_bf16,
    the bounds of test_torch_int8_views.py and test_torch_attention_forms.py)."""
    want, got = pair
    pairs = [(q, d) for q in QUERIES for d in DOCS[:4]]
    for view, jax_view, tol in ((got.quantized(), want.quantized(), 1e-3),
                                (got.with_attention("einsum_bf16"), want.with_attention("einsum_bf16"), 1e-2),
                                (got.with_attention("flash"), want.with_attention("flash"), ATOL)):
        assert view.module.head.classifier.weight.data_ptr() == got.module.head.classifier.weight.data_ptr()
        np.testing.assert_allclose(view.predict(pairs, apply_sigmoid=False),
                                   jax_view.predict(pairs, apply_sigmoid=False), atol=tol, rtol=0)
    assert got.with_attention("einsum") is got
