"""Retrieval-quality study of int8 query encoders (``BiEncoder.quantized``).

The counterpart of ``scripts/int8_encoder_study.py``.  ``serve
--encoders_int8`` runs the query-side trunks on dynamic int8 codes
(``torch._int_mm`` on the card) against the f32-encoded corpus.  This study
measures what that pairing does to retrieval on a trained model: a dense
bi-encoder is MNRL-trained on the planted-topic corpus of
``tools/cascade_study.py``, every query is searched with the f32 and the
int8 encoder, and the ranked lists are compared (top-k overlap, top-1
agreement, MRR, gold-rank changes).  The SPLADE head is untrained, so only
its activation correlation is reported.

The world is the script's, bit for bit (``cascade_study.build_world``);
``train_dense`` is the script's recipe through the port's ``fit``;
``measure`` takes the trained dense model and a SPLADE model, so the same
measurement runs on weights from either package.  ``--shape base`` is
CamemBERT-base depth / width (12 layers × 768), which converges on the card.

Runs on the card by default (``--device cpu`` for the CPU); prints one JSON
line (the script's keys), ``--out`` also writes it.

    python -m fusion_tpu_torch.tools.int8_encoder_study [--shape base --steps 2000]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n_topics", type=int, default=64)
    ap.add_argument("--docs_per_topic", type=int, default=6)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--out", default=None, help="also write the JSON record to this file")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--shape", choices=("tiny", "base"), default="tiny",
                    help="'base' = CamemBERT-base depth / width (12L x 768, 12 heads, FFN 3072)")
    ap.add_argument("--lr", type=float, default=None,
                    help="learning rate (default: 1e-3 tiny, 3e-4 base; a 12-layer trunk from scratch "
                         "diverges at 1e-3)")
    ap.add_argument("--scheduler", default=None,
                    help="schedule (default: constant tiny, linear with 4%% warm-up base)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def model_config(shape: str):
    from fusion_tpu_torch.models.encoder import EncoderConfig

    if shape == "base":
        return EncoderConfig.tiny(vocab_size=4096, hidden_size=768, num_layers=12, num_heads=12,
                                  intermediate_size=3072, max_position=128)
    return EncoderConfig.tiny(vocab_size=4096, hidden_size=64, num_heads=4, intermediate_size=128, max_position=128)


def build_world(n_topics: int, docs_per_topic: int):
    """(corpus texts, doc topic, topic queries, qrels by topic)."""
    from fusion_tpu_torch.tools.cascade_study import build_world as planted

    rng = np.random.default_rng(42)
    corpus_list, doc_topic, _, queries = planted(rng, n_topics, docs_per_topic, doc_words=24, sig_words=3,
                                                 positions={"mid": 10})
    qrels = {t: np.flatnonzero(doc_topic == t).tolist() for t in range(n_topics)}
    return corpus_list, doc_topic, queries, qrels


def fit_config(args: argparse.Namespace):
    from fusion_tpu_torch.train.trainer import FitConfig

    base = args.shape == "base"
    return FitConfig(
        steps=args.steps, batch_size=args.batch,
        learning_rate=args.lr if args.lr is not None else (3e-4 if base else 1e-3),
        scheduler=args.scheduler or ("linear" if base else "constant"),
        warmup_ratio=0.04,
        log_every_n_steps=max(1, args.steps // 20),
        log_callback=lambda e, spe, step, lr, v, name: print(f"# step {step} {name}={v:.4f} lr={lr:.2e}",
                                                              file=sys.stderr, flush=True),
    )


def train_dense(dense, corpus_list, queries, qrels, fit_cfg) -> None:
    """MNRL-train ``dense`` on (topic query, one of its docs) triplets with
    one sampled negative, through ``fit``."""
    from fusion_tpu_torch.data.datasets import TripletSampler, batch_iterator, collate_biencoder
    from fusion_tpu_torch.train.trainer import fit, init_train_state, make_biencoder_train_step

    state, tx, schedule = init_train_state(dense, fit_cfg)
    step = make_biencoder_train_step(dense, tx, {"name": "MNRLoss"}, None, fit_cfg.steps)
    sampler = TripletSampler(dict(enumerate(corpus_list)), dict(enumerate(queries)), qrels, negs_per_query=1,
                             seed=0)
    batches = batch_iterator(sampler.epochs(), lambda s: collate_biencoder(dense.text_encoder, s, 1),
                             fit_cfg.batch_size)
    fit(dense, step, batches, fit_cfg, schedule=schedule, state=state)


def measure(dense, splade, corpus_list, queries, qrels, k: int) -> dict:
    """f32 vs int8 query encoders against the f32-encoded corpus: the
    record's ``value`` (mean top-k overlap), ``dense`` and
    ``splade_activation_corr``."""
    from fusion_tpu_torch.ops.mips import dense_search

    corpus_emb = dense.encode(corpus_list, query_mode=False, batch_size=64)
    dense8 = dense.quantized()

    def search_ids(model) -> np.ndarray:
        q_emb = model.encode(queries, query_mode=True, batch_size=64)
        return dense_search(q_emb, corpus_emb, k=k, similarity=model.similarity).ids.cpu().numpy()

    i32, i8 = search_ids(dense), search_ids(dense8)
    overlap = np.mean([len(set(i32[q].tolist()) & set(i8[q].tolist())) / k for q in range(len(queries))])

    def gold_rank(ids):
        return np.array([int(np.where(np.isin(ids[t], qrels[t]))[0][0]) if np.isin(ids[t], qrels[t]).any() else k
                         for t in range(len(queries))])

    def mrr(g):  # MRR@k: a gold doc absent from the top-k contributes 0
        return round(float(np.mean(np.where(g < k, 1.0 / (g + 1), 0.0))), 4)

    g32, g8 = gold_rank(i32), gold_rank(i8)
    s = splade.encode(queries[:8], query_mode=True).cpu().numpy()
    s8 = splade.quantized().encode(queries[:8], query_mode=True).cpu().numpy()
    return {
        "value": round(float(overlap), 4),
        "dense": {
            "top1_agreement": round(float(np.mean(i32[:, 0] == i8[:, 0])), 4),
            "mrr_f32": mrr(g32), "mrr_int8": mrr(g8),
            "gold_rank_changed_queries": int(np.sum(g32 != g8)),
        },
        "splade_activation_corr": round(float(np.corrcoef(s.ravel(), s8.ravel())[0, 1]), 5),
    }


def run(args: argparse.Namespace, train=train_dense, splade=None) -> dict:
    """Build, train (``train(dense, corpus, queries, qrels, fit_cfg)``) and
    measure; ``splade`` replaces the freshly seeded SPLADE model."""
    from fusion_tpu_torch.core.device import resolve_device
    from fusion_tpu_torch.models.biencoder import BiEncoder

    device = resolve_device(args.device)
    corpus_list, _, queries, qrels = build_world(args.n_topics, args.docs_per_topic)
    cfg = model_config(args.shape)
    fit_cfg = fit_config(args)
    dense = BiEncoder(cfg, head="dense", max_query_length=8, max_doc_length=32, device=device,
                      param_dtype=torch.float32)
    train(dense, corpus_list, queries, qrels, fit_cfg)
    print("# dense bi-encoder trained", file=sys.stderr, flush=True)
    if splade is None:
        splade = BiEncoder(cfg, head="splade", max_query_length=8, max_doc_length=32, device=device)
    m = measure(dense, splade, corpus_list, queries, qrels, args.k)
    return {
        "metric": "int8_query_encoder_overlap",
        "value": m["value"],
        "unit": f"mean_top{args.k}_overlap",
        "setup": {
            "n_topics": args.n_topics, "docs": len(corpus_list),
            "train_steps": args.steps, "shape": args.shape,
            "platform": device.type,
            "lr": fit_cfg.learning_rate, "scheduler": fit_cfg.scheduler,
            "model": "CamemBERT-base depth/width (12L x 768)" if args.shape == "base" else "tiny (2L x 64)",
            "pairing": "f32-encoded corpus, int8 query trunk (serve --encoders_int8)",
        },
        "dense": m["dense"],
        "splade_activation_corr": m["splade_activation_corr"],
    }


def main(argv=None) -> dict:
    args = parse_args(argv)
    result = run(args)
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
