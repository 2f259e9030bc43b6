"""The program's spans and counters in ``HybridSearcher.search`` over a tiny
CPU searcher with all four legs and the rerank: the span keys and their
nesting, host-only spans that create no tensor, the rerank counters against
the plan they count, and nothing recorded while tracing is off."""

import numpy as np
import pytest
from torch.utils._python_dispatch import TorchDispatchMode

from fusion_tpu_torch.models.biencoder import BiEncoder
from fusion_tpu_torch.models.colbert import ColBERT
from fusion_tpu_torch.models.crossencoder import CrossEncoder
from fusion_tpu_torch.models.encoder import EncoderConfig
from fusion_tpu_torch.serving import HybridSearcher
from fusion_tpu_torch.utils import profiling

WORDS = "chat chien tribunal jugement contrat travail loi route jardin tapis".split()
CORPUS = {100 + i: " ".join(WORDS[(i + j) % len(WORDS)] for j in range(3 + i % 6)) for i in range(16)}
# five queries at batch 4: two batches, the second a padded tail
QUERIES = ["chat tapis", "loi route travail", "jardin", "contrat tribunal jugement", "chien"]
# each span and the span it runs in (None: none)
NESTING = {
    "prepare": None,
    "tokenize.bm25": "prepare",
    "tokenize.dpr": "prepare",
    "tokenize.splade": "prepare",
    "tokenize.colbert": "prepare",
    "tokenize.rerank": "prepare",
    "leg.bm25": None,
    "leg.dpr": None,
    "encoder.dpr": "leg.dpr",
    "leg.splade": None,
    "encoder.splade": "leg.splade",
    "leg.colbert": None,
    "encoder.colbert": "leg.colbert",
    "fuse": None,
    "rerank": None,
    "rerank.plan": "rerank",
    "search.fetch": None,
}
HOST_ONLY = ("tokenize.", "rerank.plan")
COUNTERS = ("rerank.rows", "rerank.row_tokens", "rerank.row_slots", "rerank.attn_pairs", "rerank.attn_slots")
# the packed rows' attention calls by path: on the CPU the einsum chain
PACKED_CALLS = "attention.packed_einsum"


@pytest.fixture(scope="module")
def models():
    cfg = EncoderConfig.tiny(vocab_size=512)
    kw = dict(max_query_length=8, max_doc_length=16, device="cpu")
    return dict(dense_model=BiEncoder(cfg, head="dense", **kw), splade_model=BiEncoder(cfg, head="splade", **kw),
                colbert_model=ColBERT(cfg, dim=16, **kw),
                cross_encoder=CrossEncoder(cfg, max_length=48, device="cpu"))


def _searcher(models, **rerank):
    return HybridSearcher.build(CORPUS, bm25_docs=list(CORPUS.values()), rerank_depth=6, topk=8, batch_size=4,
                                device="cpu", **models, **rerank)


@pytest.fixture
def traced():
    profiling.reset()
    yield
    profiling.reset()


def test_search_emits_the_layer_spans_with_their_nesting(models, traced):
    searcher = _searcher(models)
    assert searcher.rerank_packed
    searcher.search(QUERIES, batch_size=4)
    assert profiling.snapshot()["events"] == []  # off: nothing recorded
    with profiling.tracing():
        searcher.search(QUERIES, batch_size=4)
    snap = profiling.snapshot()
    events = snap["events"]
    assert set(snap["spans"]) == set(NESTING)
    for name, _, _, _, parent in events:
        assert (events[parent][0] if parent >= 0 else None) == NESTING[name], name
    calls = {name: s["calls"] for name, s in snap["spans"].items()}
    # two batches; search.fetch reads each back, then joins them
    assert calls == {name: 3 if name == "search.fetch" else 2 for name in NESTING}
    assert set(snap["counters"]) == {*COUNTERS, PACKED_CALLS}


class _Creations(TorchDispatchMode):
    """The innermost program span of every tensor operation."""

    def __init__(self):
        super().__init__()
        self.spans = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.spans.append(profiling.current())
        return func(*args, **(kwargs or {}))


def test_host_only_spans_create_no_tensor(models, traced):
    """No operation, and so no tensor on the searcher's device, inside a
    ``tokenize.*`` or ``rerank.plan`` span: a span nested in a layer span
    leaves that layer its device work."""
    searcher = _searcher(models)
    with profiling.tracing(), _Creations() as mode:
        searcher.search(QUERIES, batch_size=4)
    seen = set(mode.spans)
    assert {"prepare", "encoder.dpr", "leg.bm25", "rerank"} <= seen  # the mode sees the searcher's operations
    assert not [s for s in seen if s is not None and s.startswith(HOST_ONLY)], seen
    assert {"tokenize.dpr", "rerank.plan"} <= set(profiling.snapshot()["spans"])


def _expected(plen_rows):
    """The counters of (pair lengths, scored rows, row width) per call."""
    out = dict.fromkeys(COUNTERS, 0)
    for plen, rows, width in plen_rows:
        plen = np.asarray(plen, np.int64)
        out["rerank.rows"] += rows
        out["rerank.row_tokens"] += int(plen.sum())
        out["rerank.row_slots"] += rows * width
        out["rerank.attn_pairs"] += int((plen * plen).sum())
        out["rerank.attn_slots"] += rows * width * width
    return out


@pytest.mark.parametrize("form", ["packed", "bucketed", "flat"])
def test_rerank_counters_equal_the_plan(models, traced, monkeypatch, form):
    """Packed: recomputed from ``plan_packed``'s ``desc`` (the rows that hold
    a pair, each pair's specials, query and doc tokens), and one attention
    call a layer for each chunk of rows scored.  Bucketed and flat: one pair
    a row, from the attention masks the stage scores, and no packed
    attention call."""
    rerank = {"packed": dict(rerank_row_width=128), "bucketed": dict(rerank_buckets=(8, 16), rerank_packed=False),
              "flat": dict(rerank_packed=False)}[form]
    searcher = _searcher(models, **rerank)
    ce, seen, chunks = searcher.cross_encoder, [], []
    plan, score = ce.plan_packed, ce._score_pairs_chunked

    def plan_spy(*a, **kw):
        out = plan(*a, **kw)
        desc, width = out[0], out[2]
        seen.append((ce.PAIR_SPECIALS + desc[4] + desc[5], int(desc[2].max()) + 1, width))
        chunks.append(-(-seen[-1][1] // out[4]))
        return out

    def score_spy(ids, mask, pair_chunk):
        seen.append((mask.sum(dim=1).numpy(), ids.shape[0], ids.shape[1]))
        return score(ids, mask, pair_chunk)

    monkeypatch.setattr(ce, "plan_packed", plan_spy)
    monkeypatch.setattr(ce, "_score_pairs_chunked", score_spy)
    with profiling.tracing():
        searcher.search(QUERIES, batch_size=4)
    got = profiling.snapshot()["counters"]
    want = _expected(seen)
    if form == "packed":
        want[PACKED_CALLS] = ce.cfg.num_layers * sum(chunks)
    assert len(seen) >= 2 and got == want
    assert 0 < got["rerank.row_tokens"] <= got["rerank.row_slots"]
    assert 0 < got["rerank.attn_pairs"] <= got["rerank.attn_slots"]
    if form == "packed":  # 2 batches x 4 queries x 6 candidates, each pair in one row
        assert sum(len(p) for p, _, _ in seen) == 2 * 4 * 6
    assert all(type(v) is int for v in got.values())  # device counts are read by snapshot()
