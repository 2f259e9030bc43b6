"""Corpus-scale serving walkthrough: the mMARCO-size index forms on a small
corpus.

The counterpart of ``examples/scale_serving.py``:

  * BM25 → the term-major impact-ordered inverted index (sort-merge scoring);
  * SPLADE → the same impact form, the query pruned to its top 64 terms on
    the device (from 1M docs, ``splade_impl='auto'`` takes the chunked
    index scored by the scatter kernel instead);
  * ColBERT → the residual-compressed index and PLAID's search (centroid
    probe → candidates → centroid-only prune → exact decompressed rescore,
    whose candidate rows the row-gather kernel fetches on the card).

The searcher is saved, loaded into a fresh one, and must rank identically.

    python -m fusion_tpu_torch.examples.scale_serving              # on the card
    python -m fusion_tpu_torch.examples.scale_serving --device cpu
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np

TOPICS = ["contrat", "tribunal", "travail", "famille", "impôt", "bail", "vente", "assurance"]
QUERIES = ["contrat de travail", "décision du tribunal", "impôt sur la vente"]


def build_corpus(n: int = 256) -> dict[int, str]:
    rng = np.random.default_rng(0)
    return {
        i: f"article sur le {TOPICS[i % len(TOPICS)]} numéro {i} "
        + " ".join(rng.choice(["loi", "droit", "code", "juge", "partie", "clause"], 6))
        for i in range(n)
    }


def build_models(device) -> dict:
    from fusion_tpu_torch import BiEncoder, ColBERT, EncoderConfig

    cfg = EncoderConfig.tiny(vocab_size=2048)
    kw = dict(max_query_length=16, max_doc_length=32, device=device)
    return {"splade": BiEncoder(cfg, head="splade", **kw), "colbert": ColBERT(cfg, dim=16, **kw)}


def main(device="cuda", models: dict | None = None) -> dict:
    """Run the walkthrough on ``device``; returns what it printed.  ``models``
    (``splade``, ``colbert``) replaces the seeded models."""
    from fusion_tpu_torch import HybridSearcher
    from fusion_tpu_torch.core.device import resolve_device
    from fusion_tpu_torch.data.preprocessor import TextPreprocessor

    device = resolve_device(device)
    models = models or build_models(device)
    splade, colbert = models["splade"], models["colbert"]
    corpus = build_corpus()
    prep = TextPreprocessor(spacy_model=None)

    searcher = HybridSearcher.build(
        corpus,
        bm25_docs=prep.preprocess(list(corpus.values())),
        splade_model=splade,
        colbert_model=colbert,
        scale_mode=True,  # impact-ordered BM25 + SPLADE indexes
        impact_cap=256,
        splade_query_terms=64,
        colbert_compressed=True,
        colbert_plaid=True,  # PLAID two-stage ColBERT
        plaid_nprobe=8,
        plaid_ncand=128,
        ivf_cap=64,
        batch_size=16,
        topk=32,
        bm25_preprocess=lambda t: prep.preprocess(list(t)),
        device=device,
    )
    impact = searcher.bm25_impact_index
    print("systems:", searcher.active_systems)
    print("bm25 impact index:", tuple(impact.post_doc.shape), f"{impact.nbytes() / 1e6:.1f} MB")
    print("ivf:", tuple(searcher.colbert_ivf.ivf_doc.shape))

    ranked, ms = searcher.search(QUERIES, batch_size=16)
    ids = ranked.id_lists()
    for q, top in zip(QUERIES, ids):
        print(f"  {q!r} -> top docs {top[:5]}")
    print(f"latency: {ms:.1f} ms/query ({device.type})")

    # the searcher persists and reloads in the same forms
    with tempfile.TemporaryDirectory() as d:
        searcher.save_indexes(d)
        loaded = HybridSearcher(
            corpus_ids=np.array([]), splade_model=splade, colbert_model=colbert,
            splade_query_terms=64, plaid_nprobe=8, plaid_ncand=128,
            bm25_preprocess=lambda t: prep.preprocess(list(t)), device=device,
        ).load_indexes(d)
        loaded.topk = 32
        reloaded, _ = loaded.search(QUERIES, batch_size=16)
    if not np.array_equal(reloaded.ids.cpu().numpy(), ranked.ids.cpu().numpy()):
        raise AssertionError("the reloaded searcher ranks otherwise than the one it was saved from")
    print("persistence round-trip: identical rankings")
    return {
        "systems": list(searcher.active_systems),
        "bm25_impact_shape": tuple(impact.post_doc.shape),
        "ivf_shape": tuple(searcher.colbert_ivf.ivf_doc.shape),
        "ranked": ranked,
        "ms_per_query": ms,
        "reloaded": reloaded,
        "searcher": searcher,
    }


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap.parse_args(argv)


if __name__ == "__main__":
    main(parse_args().device)
