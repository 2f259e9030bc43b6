"""End-to-end walkthrough: the full reference workflow on a tiny corpus.

The counterpart of ``examples/quickstart.py``: train a dense bi-encoder
(MNRL, 30 steps), build a four-system ``HybridSearcher`` (BM25, DPR, SPLADE,
ColBERT; on the card its ColBERT leg runs the MaxSim kernel), search, rerank
BM25's candidates with a monoBERT cross-encoder and evaluate, against an
in-memory corpus.

    python -m fusion_tpu_torch.examples.quickstart              # on the card
    python -m fusion_tpu_torch.examples.quickstart --device cpu
"""

from __future__ import annotations

import argparse

CORPUS = {
    101: "le chat noir dort sur le tapis du salon",
    202: "le chien aboie fort dans le jardin public",
    303: "la voiture rouge roule vite sur la route",
    404: "le tribunal rend un jugement important cette semaine",
    505: "un contrat de travail est signé entre les parties",
    606: "la loi protège les droits des consommateurs",
    707: "le chat gris mange une souris dans la cuisine",
    808: "les oiseaux chantent le matin dans la forêt",
}
TRAIN_QUERIES = {1: "chat qui dort", 2: "jugement du tribunal", 3: "contrat signé"}
TRAIN_QRELS = {1: [101], 2: [404], 3: [505]}
DEV_QUERIES = ["chat tapis salon", "tribunal jugement", "contrat de travail"]
DEV_LABELS = [[101, 707], [404], [505]]


def build_models(device) -> dict:
    """The four tiny untrained models (the dense one is trained by ``main``)."""
    from fusion_tpu_torch import BiEncoder, ColBERT, CrossEncoder, EncoderConfig

    cfg = EncoderConfig.tiny(vocab_size=1024)
    kw = dict(max_query_length=8, max_doc_length=16, device=device)
    return {
        "dense": BiEncoder(cfg, head="dense", **kw),
        "splade": BiEncoder(cfg, head="splade", **kw),
        "colbert": ColBERT(cfg, dim=16, **kw),
        "ce": CrossEncoder(cfg, max_length=24, device=device),
    }


def main(device="cuda", models: dict | None = None) -> dict:
    """Run the walkthrough on ``device``; returns what it printed.  ``models``
    (``dense``, ``splade``, ``colbert``, ``ce``) replaces the seeded models,
    so a caller can start from given weights; the dense one is trained in
    place."""
    from fusion_tpu_torch import HybridPipeline, HybridSearcher
    from fusion_tpu_torch.core.device import resolve_device
    from fusion_tpu_torch.data.datasets import TripletSampler, batch_iterator, collate_biencoder
    from fusion_tpu_torch.data.preprocessor import TextPreprocessor
    from fusion_tpu_torch.eval.metrics import Metrics
    from fusion_tpu_torch.train.trainer import FitConfig, fit, init_train_state, make_biencoder_train_step

    device = resolve_device(device)
    models = models or build_models(device)
    dense, splade, colbert, ce = (models[k] for k in ("dense", "splade", "colbert", "ce"))

    # -- train the dense bi-encoder (MNRL) ------------------------------
    sampler = TripletSampler(CORPUS, TRAIN_QUERIES, TRAIN_QRELS, negs_per_query=1, seed=0)
    fit_cfg = FitConfig(steps=30, batch_size=3, learning_rate=3e-4, scheduler="constant")
    state, tx, schedule = init_train_state(dense, fit_cfg)
    step = make_biencoder_train_step(dense, tx, {"name": "MNRLoss"}, None, fit_cfg.steps)
    batches = batch_iterator(sampler.epochs(), lambda s: collate_biencoder(dense.text_encoder, s, 1), 3)
    fit(dense, step, batches, fit_cfg, schedule=schedule, state=state)
    print("dense bi-encoder trained")

    # -- serve: all four systems in one search per batch ----------------
    prep = TextPreprocessor(spacy_model=None)
    searcher = HybridSearcher.build(
        CORPUS,
        bm25_docs=prep.preprocess(list(CORPUS.values())),
        dense_model=dense,
        splade_model=splade,
        colbert_model=colbert,
        batch_size=4,
        topk=8,
        fusion_method="rrf",
        bm25_preprocess=lambda t: prep.preprocess(list(t)),
        device=device,
    )
    fused, ms_per_query = searcher.search(DEV_QUERIES, batch_size=4)
    print(f"hybrid search: {ms_per_query:.1f} ms/query")

    # -- rerank + evaluate ----------------------------------------------
    pipeline = HybridPipeline(CORPUS, device=device)
    candidates = pipeline.bm25_search(DEV_QUERIES, return_topk=8).ranked
    reranked = pipeline.cross_encoder_search(DEV_QUERIES, candidates, ce, return_topk=5).ranked
    scores = pipeline.evaluate(reranked, DEV_LABELS)
    shown = {k: round(v, 3) for k, v in scores.items() if k in ("recall@5", "mrr@10")}
    print(shown)

    fused_recall = Metrics(recall_at_k=[5]).compute_all_metrics(DEV_LABELS, fused.id_lists())["recall@5"]
    print("fused recall@5:", round(fused_recall, 3))
    return {
        "ms_per_query": ms_per_query,
        "fused": fused,
        "candidates": candidates,
        "reranked": reranked,
        "metrics": scores,
        "shown": shown,
        "fused_recall@5": fused_recall,
    }


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap.parse_args(argv)


if __name__ == "__main__":
    main(parse_args().device)
