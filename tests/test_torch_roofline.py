"""The port's hybrid roofline program (``fusion_tpu_torch.tools.
probe_hybrid_roofline``) against the JAX program of
``scripts/probe_hybrid_roofline.py``, assembled here from the same public
functions (``_impact_search``, ``dense_search``, ``maxsim_search_tm``,
``Aggregator.fuse``), on one numpy world at tiny width with the JAX models'
weights converted, on the CPU: each leg of the plain variant equals JAX's
under ``assert_ranked_match``'s tie rule, JAX's ``Aggregator.fuse`` of the
port's legs is the port's fused list, and the fused lists of the two
programs overlap; the stacked trunk's encodings and fused ids equal the
plain ones.

Tolerances: the query encodings within 1e-5; BM25 at 1e-5 (f32 sums); the
legs that round an f32 query to bf16 (DPR, SPLADE, ColBERT) at 2^-8 of their
largest score, since an ulp of difference in the f32 query flips some of
those roundings, with near-ties compared as sets (also across the depth
cut); a reordered near-tie moves RRF ranks, so the fused lists are held to
JAX's fusion of the port's own legs (ids equal, scores within 1e-6) and to
JAX's program by top-k overlap >= 0.9.  The stacked trunk's encodings
within 1e-5 of the plain forwards (the mapped product may sum in another
order than ``linear``), its fused ids equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import DEVICE, assert_ranked_match

from fusion_tpu.core.ranked import RankedLists as JaxRankedLists
from fusion_tpu.fusion.aggregator import Aggregator as JaxAggregator
from fusion_tpu.index.inverted import _impact_search
from fusion_tpu.models.biencoder import BiEncoder as JaxBiEncoder
from fusion_tpu.models.bm25 import BM25Index as JaxBM25
from fusion_tpu.models.colbert import ColBERT as JaxColBERT
from fusion_tpu.models.encoder import EncoderConfig as JaxConfig
from fusion_tpu.ops.maxsim import maxsim_search_tm as jax_maxsim_search_tm
from fusion_tpu.ops.maxsim import prepare_token_corpus as jax_prepare
from fusion_tpu.ops.mips import dense_search as jax_dense_search
from fusion_tpu_torch.models import convert
from fusion_tpu_torch.models.biencoder import BiEncoder
from fusion_tpu_torch.models.bm25 import BM25Index
from fusion_tpu_torch.models.colbert import ColBERT
from fusion_tpu_torch.models.encoder import EncoderConfig
from fusion_tpu_torch.tools import probe_hybrid_roofline as roof

N, B, TOPK, V = 600, 8, 40, 1024
LQ, LD, DIM = roof.LQ, 16, 16


@pytest.fixture(scope="module")
def worlds():
    docs, rng = roof.zipf_docs(N)
    queries = roof.zipf_queries(rng, B)
    jcfg, tcfg = JaxConfig.tiny(vocab_size=V), EncoderConfig.tiny(vocab_size=V)
    kw = dict(max_query_length=LQ, max_doc_length=LD)
    jd = JaxBiEncoder(jcfg, head="dense", **kw)
    js = JaxBiEncoder(jcfg, head="splade", **kw)
    jc = JaxColBERT(jcfg, dim=DIM, **kw)
    tkw = dict(device=DEVICE, **kw)
    dense = BiEncoder(tcfg, params=convert.encoder_state_dict(jd.params), head="dense", **tkw)
    splade = BiEncoder(tcfg, params=convert.encoder_with_mlm_state_dict(js.params), head="splade", **tkw)
    colbert = ColBERT(tcfg, params=convert.colbert_state_dict(jc.params), dim=DIM, **tkw)

    g = np.random.default_rng(7)
    d_corpus = g.standard_normal((N, jcfg.hidden_size)).astype(np.float32)
    s_corpus = g.standard_normal((N, V)).astype(np.float32)
    n_pad = -(-N // 128) * 128
    c_tokens = g.standard_normal((n_pad, LD, DIM)).astype(np.float32)
    c_mask = (np.arange(n_pad) < N)[:, None].repeat(LD, 1).astype(np.float32)

    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    world = roof.make_world(BM25Index.build(docs, k1=2.5, b=0.2, device=DEVICE), dense, splade, colbert,
                            bf(d_corpus), bf(s_corpus), bf(c_tokens), torch.from_numpy(c_mask), topk=TOPK)
    jbm25 = JaxBM25.build(docs, k1=2.5, b=0.2)
    jax_side = dict(models=(jd, js, jc), bm25=jbm25, impact=jbm25.to_impact_index(cap=1024),
                    d_corpus=jnp.asarray(d_corpus).astype(jnp.bfloat16),
                    s_corpus=jnp.asarray(s_corpus).astype(jnp.bfloat16),
                    c=jax_prepare(jnp.asarray(c_tokens).astype(jnp.bfloat16), jnp.asarray(c_mask)))
    return world, jax_side, queries


def _jax_legs(jax_side, queries):
    """The legs of the script's plain ``hybrid`` program on the JAX package,
    and its query encodings."""
    jd, js, jc = jax_side["models"]
    q_terms, q_weights = jax_side["bm25"].encode_queries(queries, max_terms=8)
    q_ids, q_mask = jd.text_encoder.encode(queries, query_mode=True)
    q_ids, q_mask = jnp.asarray(q_ids), jnp.asarray(q_mask)
    q_dense = jd.embed_tokens(jd.params, q_ids, q_mask)
    q_splade = js.embed_tokens(js.params, q_ids, q_mask)
    q_tok = jc.embed_tokens(jc.params, q_ids, q_mask)
    imp = jax_side["impact"]
    c_tm, c_valid = jax_side["c"]
    legs = {
        "bm25": _impact_search(q_terms, q_weights, imp.post_doc, imp.post_impact, N, TOPK),
        "dpr": jax_dense_search(q_dense.astype(jnp.bfloat16), jax_side["d_corpus"], k=TOPK, similarity="cos_sim"),
        "splade": jax_dense_search(q_splade.astype(jnp.bfloat16), jax_side["s_corpus"], k=TOPK,
                                   similarity="dot_score"),
        "colbert": jax_maxsim_search_tm(q_tok.astype(jnp.bfloat16), q_mask.astype(jnp.float32), c_tm, c_valid,
                                        k=TOPK, use_pallas=False),
    }
    return legs, (np.asarray(q_dense), np.asarray(q_splade), np.asarray(q_tok))


def test_plain_program_matches_the_jax_program(worlds):
    world, jax_side, queries = worlds
    want_legs, want_enc = _jax_legs(jax_side, queries)
    inputs = roof.query_inputs(world, queries)
    encode = lambda i, m: roof.plain_encode(world, i, m)  # noqa: E731
    for g, w in zip(encode(inputs[0], inputs[1]), want_enc):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-5)

    got_legs = roof.legs(world, encode, *inputs)
    for name, want in want_legs.items():
        w_ids, w_scores = np.asarray(want.ids), np.asarray(want.scores)
        bf16 = name != "bm25"
        atol = 2.0**-8 * max(1.0, float(np.abs(w_scores).max())) if bf16 else 1e-5
        assert_ranked_match(got_legs[name].ids.numpy(), got_legs[name].scores.numpy(), w_ids, w_scores,
                            atol=atol, cut_ties=bf16)

    ids, scores = roof.hybrid(world, encode, *inputs)
    port_legs = {k: JaxRankedLists(jnp.asarray(v.ids.numpy()), jnp.asarray(v.scores.numpy()))
                 for k, v in got_legs.items()}
    fused_of_port_legs = JaxAggregator.fuse(port_legs, method="rrf", return_topk=TOPK)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(fused_of_port_legs.ids))
    np.testing.assert_allclose(scores.numpy(), np.asarray(fused_of_port_legs.scores), atol=1e-6, rtol=0)
    want_fused = JaxAggregator.fuse(want_legs, method="rrf", return_topk=TOPK)
    assert roof.overlap_at(ids.numpy(), np.asarray(want_fused.ids), TOPK) >= 0.9


def test_stacked_trunk_equals_the_plain_forwards(worlds):
    world, _, queries = worlds
    inputs = roof.query_inputs(world, queries)
    stack = roof.stacked_trunk(world)
    plain = roof.plain_encode(world, inputs[0], inputs[1])
    stacked = roof.stacked_encode(world, stack, inputs[0], inputs[1])
    for g, w in zip(stacked, plain):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=1e-5)
    ids_plain, _ = roof.hybrid(world, lambda i, m: roof.plain_encode(world, i, m), *inputs)
    ids_stacked, _ = roof.hybrid(world, lambda i, m: roof.stacked_encode(world, stack, i, m), *inputs)
    np.testing.assert_array_equal(ids_stacked.numpy(), ids_plain.numpy())


def test_sweep_rows_and_best_line(worlds):
    world, _, _ = worlds
    lines = []
    rows = roof.sweep(world, np.random.default_rng(1), [4, 8], groups=1, per=1, emit=lines.append)
    assert [(r["variant"], r["batch"]) for r in rows] == [("plain", 4), ("stacked", 4), ("plain", 8), ("stacked", 8)]
    assert len(lines) == 4
    for r in rows:
        assert r["ms_per_batch"] > 0 and r["queries_per_s"] > 0 and r["flops"] > 0 and 0 <= r["mfu"] < 1
        if r["variant"] == "stacked":
            assert r["ids_equal_plain"] is True
    best = roof.best_record(rows, world.n_docs, world.topk)
    assert best["metric"] == "hybrid_roofline_best"
    assert best["value"] == max(r["queries_per_s"] for r in rows)


def test_k1_flops_and_the_card_default(monkeypatch):
    world = roof.World(None, None, None, None, None, None, None, torch.empty(128, 256, 64), None, 256, 10)
    assert roof.k1_flops(world, 4) == 2.0 * 4 * roof.LQ * 256 * 128 * 64
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        roof.build_world(roof.parse_args(["--n_docs", "64", "--tiny"]))
