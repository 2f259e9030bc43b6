"""The port's streaming segmented searcher (``fusion_tpu_torch/segmented.py``).

Two kinds of checks:

  * the five unsharded cases of ``tests/test_segmented.py`` on the port with
    tiny models: a searcher that started from corpus A and added corpus B
    ranks as one ``HybridSearcher`` built over A∪B (the first id equal, the
    top 8 overlapping in all but one boundary swap of RRF ties, scores of
    agreeing ids within rtol 2e-3 / atol 2e-4, the JAX test's bounds; BM25
    alone within rtol 1e-5, idf being global), deletes tombstone, compact
    folds the segments, and a deleted id comes back only after compact;
  * the port against the JAX package's ``SegmentedHybridSearcher`` on the
    same corpus A + delta B with models converted from the JAX package's
    Flax params: the per-system merged lists (scores within 1e-6 absolute,
    the serving tests' bound), the fused lists (RRF, so equal ranks give
    equal scores: within 1e-6) and the flat-reranked head (logits through
    the sigmoid within rtol 1e-4 / atol 1e-5, the rerank tests' bound), ids
    compared as sets inside runs of scores that tie within the bound; after
    an add, after a delete and after compact.

Sharded segments (``mesh=``), in a pod of two port processes joined over
gloo (``tests/torch_pod.py``): ``tests/test_segmented.py``'s two sharded
cases on the port (add, delete, compact against a sharded rebuild of the
union: the same top 1, the top 8 overlapping in all but one RRF tie swap,
agreeing ids' scores within rtol 2e-3 / atol 2e-4; the compressed ColBERT
leg sharded against unsharded over the same segments: the same ids, scores
within 1e-3), and the port's sharded segmented searcher against JAX's over
an index = 2 mesh after the add, the delete and compact (see
``test_sharded_segmented_matches_jax``).

Besides: the merge's tie order against ``lax.top_k``, ``mesh=`` on a mesh of
one rank (the sharded searcher in each segment) and a mesh on another device
than the build's refused, and ``/healthz`` of a segmented searcher served by
``SearchServer``."""

import json
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_segmented import QUERIES, _corpus
from torch_parity import DEVICE, assert_ranked_match

from fusion_tpu import segmented as jax_segmented
from fusion_tpu.core.ranked import RankedLists as JaxRanked
from fusion_tpu.data.preprocessor import TextPreprocessor
from fusion_tpu.models.biencoder import BiEncoder as JaxBiEncoder
from fusion_tpu.models.colbert import ColBERT as JaxColBERT
from fusion_tpu.models.crossencoder import CrossEncoder as JaxCrossEncoder
from fusion_tpu.models.encoder import EncoderConfig as JaxConfig
from fusion_tpu_torch import segmented
from fusion_tpu_torch.core.ranked import RankedLists
from fusion_tpu_torch.models import convert
from fusion_tpu_torch.models.biencoder import BiEncoder
from fusion_tpu_torch.models.colbert import ColBERT
from fusion_tpu_torch.models.crossencoder import CrossEncoder
from fusion_tpu_torch.models.encoder import EncoderConfig
from fusion_tpu_torch.segmented import SegmentedHybridSearcher
from fusion_tpu_torch.serving import HybridSearcher

LEG_ATOL = 1e-6
# five queries at batch 4: the second batch is a padded tail
SEARCH_QUERIES = QUERIES + ["loi consommateur voiture", "fromage pain livre"]


@pytest.fixture(scope="module")
def prep():
    return TextPreprocessor(spacy_model=None)


@pytest.fixture(scope="module")
def models():
    cfg = EncoderConfig.tiny(vocab_size=512)
    kw = dict(max_query_length=8, max_doc_length=16, device=DEVICE)
    return dict(
        dense_model=BiEncoder(cfg, head="dense", **kw),
        splade_model=BiEncoder(cfg, head="splade", **kw),
        colbert_model=ColBERT(cfg, dim=16, **kw),
        cross_encoder=CrossEncoder(EncoderConfig.tiny(vocab_size=512), max_length=32, device=DEVICE),
    )


def _common_kwargs(models, prep):
    return dict(
        **models,
        rerank_depth=4,
        batch_size=4,
        topk=8,
        bm25_preprocess=lambda t: prep.preprocess(list(t)),
        int8_corpus=True,
        ce_max_doc_tokens=24,
        device=DEVICE,
    )


def _bm25(prep, corpus):
    return prep.preprocess(list(corpus.values()))


# ----------------------------------------------------------------------
# tests/test_segmented.py's unsharded cases, on the port
# ----------------------------------------------------------------------
def test_add_documents_matches_full_rebuild(models, prep):
    a, b = _corpus(14, seed=3, base_id=100), _corpus(10, seed=4, base_id=500)
    union = {**a, **b}
    kwargs = _common_kwargs(models, prep)
    full = HybridSearcher.build(union, bm25_docs=_bm25(prep, union), **kwargs)
    seg = SegmentedHybridSearcher(a, bm25_docs=_bm25(prep, a), **kwargs)
    seg.add_documents(b, bm25_docs=_bm25(prep, b))
    assert len(seg.segments) == 2
    assert seg.active_systems == ["bm25", "dpr", "splade", "colbert", "monobert"]
    assert set(seg.build_seconds) == {"bm25", "segment"}

    want, _ = full.search(QUERIES, batch_size=4)
    got, ms = seg.search(QUERIES, batch_size=4)
    assert ms > 0 and got.ids.dtype == torch.int32 and got.ids.device.type == "cpu"
    w_ids, g_ids = want.ids.numpy(), got.ids.numpy()
    w_sc, g_sc = want.scores.numpy(), got.scores.numpy()
    assert g_ids.shape == w_ids.shape
    for qi in range(len(QUERIES)):
        assert g_ids[qi, 0] == w_ids[qi, 0], (qi, g_ids[qi], w_ids[qi])
        # RRF orders score ties arbitrarily, and the two paths sort ties
        # differently: one boundary swap allowed
        assert len(set(g_ids[qi].tolist()) & set(w_ids[qi].tolist())) >= g_ids.shape[1] - 1
        agree = (g_ids[qi] == w_ids[qi]) & np.isfinite(w_sc[qi])
        np.testing.assert_allclose(g_sc[qi][agree], w_sc[qi][agree], rtol=2e-3, atol=2e-4)


def test_bm25_idf_is_global_after_add(prep):
    """Lexical-only: scores equal the full rebuild's (global df / N)."""
    a, b = _corpus(12, seed=5, base_id=0), _corpus(12, seed=6, base_id=200)
    union = {**a, **b}
    kwargs = dict(topk=8, bm25_preprocess=lambda t: prep.preprocess(list(t)), device=DEVICE)
    full = HybridSearcher.build(union, bm25_docs=_bm25(prep, union), **kwargs)
    seg = SegmentedHybridSearcher(a, bm25_docs=_bm25(prep, a), **kwargs)
    seg.add_documents(b, bm25_docs=_bm25(prep, b))
    assert seg.segments == [] and seg.active_systems == ["bm25"]
    want, _ = full.search(QUERIES, batch_size=4)
    got, _ = seg.search(QUERIES, batch_size=4)
    w_sc, g_sc = want.scores.numpy(), got.scores.numpy()
    w_ids, g_ids = want.ids.numpy(), got.ids.numpy()
    for qi in range(len(QUERIES)):
        f = np.isfinite(w_sc[qi])
        np.testing.assert_array_equal(np.isfinite(g_sc[qi]), f)
        np.testing.assert_allclose(np.sort(g_sc[qi][f]), np.sort(w_sc[qi][f]), rtol=1e-5)
        assert set(g_ids[qi][f].tolist()) == set(w_ids[qi][f].tolist())


def test_duplicate_ids_rejected_and_compact(models, prep):
    a = _corpus(8, seed=7, base_id=0)
    seg = SegmentedHybridSearcher(a, bm25_docs=_bm25(prep, a), **_common_kwargs(models, prep))
    with pytest.raises(ValueError, match="already indexed|still present"):
        seg.add_documents(a, bm25_docs=_bm25(prep, a))
    b = _corpus(6, seed=8, base_id=300)
    with pytest.raises(ValueError, match="bm25_docs"):
        seg.add_documents(b)
    seg.add_documents(b, bm25_docs=_bm25(prep, b))
    before, _ = seg.search(QUERIES, batch_size=4)
    seg.compact()
    assert len(seg.segments) == 1
    after, _ = seg.search(QUERIES, batch_size=4)
    b_ids, a_ids = before.ids.numpy(), after.ids.numpy()
    for qi in range(len(QUERIES)):
        assert set(b_ids[qi].tolist()) == set(a_ids[qi].tolist())
        assert b_ids[qi, 0] == a_ids[qi, 0]


def test_delete_documents_tombstones_and_compact(models, prep):
    a, b = _corpus(14, seed=3, base_id=100), _corpus(10, seed=4, base_id=500)
    seg = SegmentedHybridSearcher(a, bm25_docs=_bm25(prep, a), **_common_kwargs(models, prep))
    seg.add_documents(b, bm25_docs=_bm25(prep, b))
    before, _ = seg.search(QUERIES, batch_size=4)
    victims = {int(before.ids[qi, 0]) for qi in range(len(QUERIES))}
    with pytest.raises(ValueError, match="unknown"):
        seg.delete_documents([999999])
    seg.delete_documents(victims)
    assert seg.n_docs == 24 - len(victims)
    after, _ = seg.search(QUERIES, batch_size=4)
    a_ids, a_sc = after.ids.numpy(), after.scores.numpy()
    for qi in range(len(QUERIES)):
        returned = set(a_ids[qi][np.isfinite(a_sc[qi])].tolist())
        assert not (returned & victims) and returned
        row = a_sc[qi][np.isfinite(a_sc[qi])]
        assert np.all(np.diff(row) <= 1e-6)  # rows stay descending
    seg.compact()
    assert len(seg.segments) == 1 and not seg._tombstones
    assert seg.n_docs == 24 - len(victims)
    compacted, _ = seg.search(QUERIES, batch_size=4)
    c_ids, c_sc = compacted.ids.numpy(), compacted.scores.numpy()
    for qi in range(len(QUERIES)):
        got = set(c_ids[qi][np.isfinite(c_sc[qi])].tolist())
        assert not (got & victims)
        want = set(a_ids[qi][np.isfinite(a_sc[qi])].tolist())
        assert len(got & want) >= len(want) - 1, (qi, got, want)


def test_readd_after_delete_requires_compact(models, prep):
    a = _corpus(10, seed=9, base_id=0)
    seg = SegmentedHybridSearcher(a, bm25_docs=_bm25(prep, a), **_common_kwargs(models, prep))
    victim = next(iter(a))
    seg.delete_documents([victim])
    with pytest.raises(ValueError, match="compact"):
        seg.add_documents({victim: a[victim]}, bm25_docs=prep.preprocess([a[victim]]))
    seg.compact()
    seg.add_documents({victim: a[victim]}, bm25_docs=prep.preprocess([a[victim]]))
    assert victim not in seg._tombstones and seg.n_docs == 10
    r, _ = seg.search([a[victim]], batch_size=4)
    ids, scores = r.ids.numpy()[0], r.scores.numpy()[0]
    assert victim in set(ids[np.isfinite(scores)].tolist())


def test_neural_only_n_docs_and_deletes(models):
    """Without BM25 the logical count is the segments' rows less the
    tombstones, and a tombstoned id cannot be deleted twice."""
    a, b = _corpus(6, seed=1, base_id=0), _corpus(4, seed=2, base_id=50)
    seg = SegmentedHybridSearcher(a, dense_model=models["dense_model"], batch_size=4, topk=5, device=DEVICE)
    seg.add_documents(b)
    assert seg.n_docs == 10 and seg.active_systems == ["dpr"]
    seg.delete_documents([0, 50])
    assert seg.n_docs == 8
    with pytest.raises(ValueError, match="unknown"):
        seg.delete_documents([0])
    r, _ = seg.search(QUERIES, batch_size=4)
    assert not ({0, 50} & set(r.ids.numpy().ravel().tolist()))


# ----------------------------------------------------------------------
# the port against the JAX package
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def pair():
    """The JAX and the port's segmented searchers over corpus A (built with
    converted weights), before any update: every leg, a flat rerank of the
    fused top 4."""
    jcfg, tcfg = JaxConfig.tiny(vocab_size=512), EncoderConfig.tiny(vocab_size=512)
    kw = dict(max_query_length=8, max_doc_length=16)
    jd, js = JaxBiEncoder(jcfg, head="dense", **kw), JaxBiEncoder(jcfg, head="splade", **kw)
    jc, jce = JaxColBERT(jcfg, dim=16, **kw), JaxCrossEncoder(jcfg, max_length=32)
    ported = dict(
        dense_model=BiEncoder(tcfg, params=convert.encoder_state_dict(jd.params), head="dense", device=DEVICE, **kw),
        splade_model=BiEncoder(tcfg, params=convert.encoder_with_mlm_state_dict(js.params), head="splade",
                               device=DEVICE, **kw),
        colbert_model=ColBERT(tcfg, params=convert.colbert_state_dict(jc.params), dim=16, device=DEVICE, **kw),
        cross_encoder=CrossEncoder(tcfg, params=convert.crossencoder_state_dict(jce.params), max_length=32,
                                   device=DEVICE),
    )
    prep = TextPreprocessor(spacy_model=None)
    common = dict(rerank_depth=4, batch_size=4, topk=8, ce_max_doc_tokens=24,
                  bm25_preprocess=lambda t: prep.preprocess(list(t)))
    a = _corpus(14, seed=3, base_id=100)
    want = jax_segmented.SegmentedHybridSearcher(
        a, bm25_docs=_bm25(prep, a), dense_model=jd, splade_model=js, colbert_model=jc, cross_encoder=jce, **common)
    got = SegmentedHybridSearcher(a, bm25_docs=_bm25(prep, a), **ported, **common, device=DEVICE)
    return want, got, prep


def _merged(searcher, module, **kw):
    """Each system's merged list as ``_search_locked`` forms it."""
    per = {}
    sources = ([searcher.bm25_searcher] if searcher.bm25_searcher is not None else []) + searcher.segments
    for s in sources:
        for name, r in s.search_systems(SEARCH_QUERIES, batch_size=4, **kw).items():
            per.setdefault(name, []).append(r)
    return {n: searcher._strip_tombstones(module._merge_ranked(p, searcher.topk)) for n, p in per.items()}


def _fused(searcher, **kw):
    ce, searcher.cross_encoder = searcher.cross_encoder, None
    try:
        return searcher.search(SEARCH_QUERIES, batch_size=4, **kw)[0]
    finally:
        searcher.cross_encoder = ce


def _assert_matches_jax(want_s, got_s):
    assert got_s.active_systems == want_s.active_systems
    assert got_s.n_docs == want_s.n_docs and len(got_s.segments) == len(want_s.segments)
    want_m, got_m = _merged(want_s, jax_segmented, use_pallas=False), _merged(got_s, segmented)
    assert set(got_m) == set(want_m) == {"bm25", "dpr", "splade", "colbert"}
    for name in want_m:
        assert_ranked_match(got_m[name].ids, got_m[name].scores, want_m[name].ids, want_m[name].scores,
                            atol=LEG_ATOL, cut_ties=True)
    want_f, got_f = _fused(want_s, use_pallas=False), _fused(got_s)
    assert_ranked_match(got_f.ids, got_f.scores, want_f.ids, want_f.scores, atol=LEG_ATOL, cut_ties=True)
    want, _ = want_s.search(SEARCH_QUERIES, batch_size=4, use_pallas=False)
    got, _ = got_s.search(SEARCH_QUERIES, batch_size=4)
    w_sc, g_sc = np.asarray(want.scores), got.scores.numpy()
    np.testing.assert_allclose(g_sc, w_sc, rtol=1e-4, atol=1e-5)
    assert_ranked_match(got.ids, g_sc, want.ids, w_sc, atol=1e-5 + 1e-4 * float(np.abs(w_sc).max()), cut_ties=True)
    for qi in range(len(SEARCH_QUERIES)):  # the reranked head is a permutation of the fused head
        assert set(got.ids.numpy()[qi, :4]) == set(got_f.ids.numpy()[qi, :4])


def test_add_delete_compact_match_jax(pair):
    want_s, got_s, prep = pair
    _assert_matches_jax(want_s, got_s)  # one segment
    b = _corpus(10, seed=4, base_id=500)
    for s in (want_s, got_s):
        s.add_documents(b, bm25_docs=_bm25(prep, b))
    _assert_matches_jax(want_s, got_s)  # two segments
    victims = [int(x) for x in np.asarray(got_s.search(SEARCH_QUERIES, batch_size=4)[0].ids)[:3, 0]] + [505]
    for s in (want_s, got_s):
        s.delete_documents(victims)
    assert got_s._tombstones == want_s._tombstones == set(victims)
    _assert_matches_jax(want_s, got_s)  # tombstoned
    for s in (want_s, got_s):
        s.compact()
    _assert_matches_jax(want_s, got_s)  # one segment again, rows reclaimed
    assert got_s._ce_len == want_s._ce_len == 24


def test_merge_tie_order_matches_lax_top_k():
    """Equal scores keep the lower position — the earlier part first — as
    ``lax.top_k`` orders them; short parts pad with (-1, -inf)."""
    ids = [np.array([[1, 2, 3], [4, 5, -1]], np.int32), np.array([[7, 8], [9, 10]], np.int32),
           np.array([[11], [12]], np.int32)]
    scores = [np.array([[0.5, 0.5, 0.2], [0.9, 0.1, -np.inf]], np.float32),
              np.array([[0.5, 0.2], [0.9, 0.1]], np.float32), np.array([[0.5], [0.1]], np.float32)]
    for k in (4, 6, 9):
        want = jax_segmented._merge_ranked([JaxRanked(jnp.asarray(i), jnp.asarray(s)) for i, s in zip(ids, scores)], k)
        got = segmented._merge_ranked([RankedLists(torch.from_numpy(i), torch.from_numpy(s))
                                       for i, s in zip(ids, scores)], k)
        np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
        np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
        assert got.ids.dtype == torch.int32
    one = RankedLists(torch.from_numpy(ids[1]), torch.from_numpy(scores[1]))
    padded = segmented._merge_ranked([one], 3)
    np.testing.assert_array_equal(padded.ids.numpy(), [[7, 8, -1], [9, 10, -1]])
    assert segmented._merge_ranked([one], 2) is one


def test_mesh_raises_with_item_18(models, prep):
    """``mesh=`` raised (naming item 18) until the sharded segments were
    ported: on a mesh of one rank every segment and the BM25 index are now
    sharded searchers that rank as the unsharded ones do; a mesh whose rank
    lives on another device than the build's raises."""
    from fusion_tpu_torch.parallel.sharding import make_mesh
    from fusion_tpu_torch.serving_sharded import ShardedHybridSearcher

    a, b = _corpus(8, seed=7, base_id=0), _corpus(6, seed=8, base_id=300)
    # scale mode: the sharded BM25 leg is the impact index, as here
    kwargs = {k: v for k, v in _common_kwargs(models, prep).items() if k != "colbert_model"}
    kwargs.update(scale_mode=True, impact_cap=64)
    mesh = make_mesh(index=1, devices=[DEVICE])
    seg = SegmentedHybridSearcher(a, bm25_docs=_bm25(prep, a), mesh=mesh, **kwargs)
    plain = SegmentedHybridSearcher(a, bm25_docs=_bm25(prep, a), **kwargs)
    for s in (seg, plain):
        s.add_documents(b, bm25_docs=_bm25(prep, b))
    assert all(isinstance(x, ShardedHybridSearcher) for x in [seg.bm25_searcher, *seg.segments])
    (want, _), (got, _) = plain.search(QUERIES, batch_size=4), seg.search(QUERIES, batch_size=4)
    assert torch.equal(got.ids, want.ids) and torch.equal(got.scores, want.scores)
    meta = make_mesh(index=1, devices=["meta"])
    with pytest.raises(ValueError, match="mesh's rank"):
        SegmentedHybridSearcher({0: "chat"}, dense_model=models["dense_model"], mesh=meta, device=DEVICE)


def test_healthz_serves_a_segmented_searcher(models, prep):
    """``/healthz`` reports ``n_docs`` after each update; searches go on."""
    from fusion_tpu_torch.server import SearchServer

    a = _corpus(12, seed=21, base_id=0)
    seg = SegmentedHybridSearcher(a, bm25_docs=_bm25(prep, a), dense_model=models["dense_model"], topk=5,
                                  batch_size=4, bm25_preprocess=lambda t: prep.preprocess(list(t)), device=DEVICE)
    srv = SearchServer(seg, host="127.0.0.1", port=0, max_batch=4, max_wait_ms=2.0)
    srv.start()
    host, port = srv.address
    base = f"http://{host}:{port}"

    def health():
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            return json.loads(r.read())

    def search(q):
        req = urllib.request.Request(f"{base}/search", data=json.dumps({"queries": [q], "topk": 3}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())["results"][0]

    try:
        assert health() == {"ok": True, "systems": ["bm25", "dpr"], "corpus_docs": 12}
        b = _corpus(5, seed=22, base_id=100)
        seg.add_documents(b, bm25_docs=_bm25(prep, b))
        assert health()["corpus_docs"] == 17
        top = search(QUERIES[0])["ids"][0]
        seg.delete_documents([top])
        assert health()["corpus_docs"] == 16
        assert top not in search(QUERIES[0])["ids"]
    finally:
        srv.stop()


# ----------------------------------------------------------------------
# sharded segments in a pod of two processes, and against JAX's
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def sharded_pod(tmp_path_factory):
    """The pod's sharded segmented searchers (weights converted from the
    JAX models) and JAX's over an index = 2 mesh, computed while the pod
    runs: (per-rank reports, JAX's lists after the add, delete, compact)."""
    import jax
    from torch_pod import start_pod

    from fusion_tpu.parallel.sharding import make_mesh as jax_make_mesh

    jcfg = JaxConfig.tiny(vocab_size=512)
    kw = dict(max_query_length=8, max_doc_length=16)
    jd, js = JaxBiEncoder(jcfg, head="dense", **kw), JaxBiEncoder(jcfg, head="splade", **kw)
    jc, jce = JaxColBERT(jcfg, dim=16, **kw), JaxCrossEncoder(jcfg, max_length=32)
    a, b = _corpus(14, seed=3, base_id=100), _corpus(10, seed=4, base_id=500)
    payload = {
        "models": {"dense": convert.encoder_state_dict(jd.params),
                   "splade": convert.encoder_with_mlm_state_dict(js.params),
                   "colbert": convert.colbert_state_dict(jc.params),
                   "ce": convert.crossencoder_state_dict(jce.params)},
        "queries": SEARCH_QUERIES, "seg_a": a, "seg_b": b,
        "seg_c": _corpus(12, seed=11, base_id=0), "seg_d": _corpus(8, seed=12, base_id=300),
    }
    d = tmp_path_factory.mktemp("segmented_pod")
    torch.save(payload, d / "payload.pt")
    pod = start_pod(d, "segmented", timeout=300)

    prep = TextPreprocessor(spacy_model=None)
    mesh = jax_make_mesh(data=1, model=1, index=2, devices=jax.devices()[:2])
    seg = jax_segmented.SegmentedHybridSearcher(
        a, bm25_docs=_bm25(prep, a), mesh=mesh, dense_model=jd, splade_model=js, cross_encoder=jce,
        rerank_depth=4, batch_size=4, topk=8, bm25_preprocess=lambda t: prep.preprocess(list(t)),
        int8_corpus=True, ce_max_doc_tokens=24,
    )
    want = {}

    def lists():
        r, _ = seg.search(SEARCH_QUERIES, batch_size=4, use_pallas=False)
        return {"ids": np.asarray(r.ids), "scores": np.asarray(r.scores)}

    seg.add_documents(b, bm25_docs=_bm25(prep, b))
    want["two_segments"] = (lists(), _merged(seg, jax_segmented, use_pallas=False))
    seg.delete_documents(sorted(b)[:3])
    want["tombstoned"] = (lists(), _merged(seg, jax_segmented, use_pallas=False))
    seg.compact()
    want["compacted"] = (lists(), _merged(seg, jax_segmented, use_pallas=False))
    return pod.results(), want


def test_sharded_segmented_add_delete_compact_matches_full_rebuild(sharded_pod):
    """``tests/test_segmented.py``'s sharded case on the port, two ranks."""
    ranks, _ = sharded_pod
    for report in ranks:
        assert report["two_segments"]["n"] == 2
        assert report["two_segments"]["systems"] == ["bm25", "dpr", "splade", "monobert"]
        assert report["compacted"]["n"] == 1 and report["compacted"]["tombstones"] == []
        want, got = report["rebuild"], report["compacted"]["search"]
        w_ids, g_ids, w_sc, g_sc = want["ids"], got["ids"], want["scores"], got["scores"]
        for qi in range(len(SEARCH_QUERIES)):
            assert g_ids[qi, 0] == w_ids[qi, 0], (qi, g_ids[qi], w_ids[qi])
            assert len(set(g_ids[qi].tolist()) & set(w_ids[qi].tolist())) >= g_ids.shape[1] - 1
            agree = (g_ids[qi] == w_ids[qi]) & np.isfinite(w_sc[qi])
            np.testing.assert_allclose(g_sc[qi][agree], w_sc[qi][agree], rtol=2e-3, atol=2e-4)
        assert not set(report["victims"]) & set(report["tombstoned"]["search"]["ids"].ravel().tolist())
    for key in ("two_segments", "compacted"):
        np.testing.assert_array_equal(ranks[0][key]["search"]["ids"], ranks[1][key]["search"]["ids"])


def test_sharded_segmented_colbert_leg_matches_unsharded(sharded_pod):
    ranks, _ = sharded_pod
    for report in ranks:
        assert report["colbert"]["systems"] == ["colbert"]
        want, got = report["colbert"]["plain"], report["colbert"]["sharded"]
        for qi in range(len(SEARCH_QUERIES)):
            f = np.isfinite(want["scores"][qi]) & np.isfinite(got["scores"][qi])
            assert set(got["ids"][qi][f].tolist()) == set(want["ids"][qi][f].tolist()), qi
            np.testing.assert_allclose(np.sort(got["scores"][qi][f]), np.sort(want["scores"][qi][f]),
                                       rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("step", ["two_segments", "tombstoned", "compacted"])
def test_sharded_segmented_matches_jax(sharded_pod, step):
    """Each system's merged list within its leg's bound (BM25 1e-5; the
    sharded int8 DPR and SPLADE legs round an f32 query to bf16: 2^-8), ids
    equal but inside runs of tied scores; the reranked lists as JAX's own
    sharded segment test holds them (a near-tie swap in a leg moves an RRF
    score by a rank): the same top 1, the same reranked head, all but one of
    the top 8."""
    ranks, want_all = sharded_pod
    want, want_legs = want_all[step]
    got, got_legs = ranks[0][step]["search"], ranks[0][step]["legs"]
    assert set(got_legs) == set(want_legs) == {"bm25", "dpr", "splade"}
    for name, w in want_legs.items():
        assert_ranked_match(got_legs[name]["ids"], got_legs[name]["scores"], w.ids, w.scores,
                            atol=1e-5 if name == "bm25" else 2.0**-8, cut_ties=True)
    w_ids, g_ids = want["ids"], got["ids"]
    for qi in range(len(SEARCH_QUERIES)):
        assert g_ids[qi, 0] == w_ids[qi, 0]
        assert set(g_ids[qi, :4]) == set(w_ids[qi, :4])
        assert len(set(g_ids[qi].tolist()) & set(w_ids[qi].tolist())) >= g_ids.shape[1] - 1

