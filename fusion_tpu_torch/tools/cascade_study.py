"""Quality study of the two-stage cascade rerank (``rerank_tokens_cascade``).

The counterpart of ``scripts/cascade_study.py``.  The cascade trades rerank
FLOPs (~stage1/Ld + keep/K of the flat stage) against one failure mode: a
relevant doc is lost only if its evidence sits past the stage-1 truncation
and its prefix scores below the stage-1 cut.  This study measures that trade
with planted evidence position: a tiny cross-encoder is BCE-trained to
detect query-topic terms inside docs, and each relevant doc carries its
topic terms at a controlled depth (early prefix / middle / late tail).  The
flat full-width rerank is compared with the cascade over a (keep,
stage1_tokens) grid, the quality split by evidence position.

Expected: evidence within the stage-1 width → cascade == flat; evidence past
it → quality tracks how much prefix signal the stage-1 cut can use.  So
pick stage1_tokens ≥ the corpus' typical evidence depth, and treat keep as
the margin for prefix-weak positives.

The world (``build_world``) is the script's, bit for bit; ``train_ce``
trains the port's cross-encoder with the script's recipe (optax's AdamW
defaults: weight decay 1e-4, eps 1e-8, constant lr, dropout seed 0);
``measure`` scores a trained model, so the same measurement runs on weights
trained by either package.  ``--int8`` also scores the int8-trunk view
(``torch._int_mm`` on the card) against the f32 flat rerank.

Runs on the card by default (``--device cpu`` for the CPU); prints one JSON
line (the script's keys), ``--out`` also writes it.

    python -m fusion_tpu_torch.tools.cascade_study [--shape base --steps 300] [--int8]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

# word offsets of the planted signature; the hash tokenizer is one token a
# word, so stage-1 token widths map 1:1 onto these depths
POSITIONS = {"early": 1, "middle": 18, "late": 38}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n_topics", type=int, default=64)
    ap.add_argument("--docs_per_topic", type=int, default=6)
    ap.add_argument("--doc_words", type=int, default=44)
    ap.add_argument("--candidates", type=int, default=32)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--out", default=None, help="also write the JSON record to this file")
    ap.add_argument("--int8", action="store_true",
                    help="also measure the int8-trunk serving view (CrossEncoder.quantized) against the f32 "
                         "flat rerank on the trained model")
    ap.add_argument("--shape", choices=("tiny", "base"), default="tiny",
                    help="'base' trains the CE at CamemBERT-base depth / width (12 layers x 768, 12 heads, "
                         "FFN 3072; vocab stays 4096, the hash tokenizer's world)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def build_world(rng, n_topics: int, docs_per_topic: int, doc_words: int,
                sig_words: int, positions: dict[str, int]):
    """Corpus with one topic signature per doc at a controlled word depth.

    positions: name -> word offset at which the topic's ``sig_words``
    signature terms are planted (contiguous run). Returns (corpus list,
    doc_topic, doc_pos_name, topic_queries)."""
    filler = [f"mot{i:04d}" for i in range(600)]
    topics = [[f"sujet{t:02d}x{j}" for j in range(sig_words)]
              for t in range(n_topics)]
    pos_names = list(positions)
    corpus, doc_topic, doc_pos = [], [], []
    for t in range(n_topics):
        for d in range(docs_per_topic):
            words = list(rng.choice(filler, size=doc_words, replace=False))
            name = pos_names[(t * docs_per_topic + d) % len(pos_names)]
            off = positions[name]
            words[off : off + sig_words] = topics[t]
            corpus.append(" ".join(words))
            doc_topic.append(t)
            doc_pos.append(name)
    queries = [" ".join(topics[t]) for t in range(n_topics)]
    return corpus, np.array(doc_topic), np.array(doc_pos), queries



def model_config(shape: str):
    """The study's cross-encoder config: enough capacity to learn token
    matching (the 32-wide tiny config plateaus at chance on this task)."""
    from fusion_tpu_torch.models.encoder import EncoderConfig

    if shape == "base":
        return EncoderConfig.tiny(vocab_size=4096, hidden_size=768, num_layers=12, num_heads=12,
                                  intermediate_size=3072, max_position=128)
    return EncoderConfig.tiny(vocab_size=4096, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
                              max_position=128)


def train_ce(ce, corpus, doc_topic, queries, steps: int, batch: int, rng, lr: float = 1e-3) -> float:
    """BCE-train the cross-encoder to detect query terms inside the doc:
    each pair a random topic's query with one of its docs (label 1) or
    another topic's (label 0), drawn from ``rng``; the final loss."""
    from fusion_tpu_torch.train.optim import adamw
    from fusion_tpu_torch.train.trainer import FitConfig, init_train_state, make_crossencoder_train_step

    state, _, _ = init_train_state(ce, FitConfig(learning_rate=lr, scheduler="constant"))
    tx = adamw(lr, weight_decay=1e-4, eps=1e-8)  # optax.adamw's defaults
    state = state._replace(opt_state=tx.init(state.opt_state.mu))
    step_fn = make_crossencoder_train_step(ce, tx, dropout_seed=0)
    n_topics = len(queries)
    loss = float("nan")
    for s in range(steps):
        qs, ds, labels = [], [], []
        for _ in range(batch):
            t = int(rng.integers(n_topics))
            if rng.random() < 0.5:
                di, lab = int(rng.choice(np.flatnonzero(doc_topic == t))), 1.0
            else:
                di, lab = int(rng.choice(np.flatnonzero(doc_topic != t))), 0.0
            qs.append(queries[t])
            ds.append(corpus[di])
            labels.append(lab)
        ids, mask = ce._encode_pairs(qs, ds)
        state, metrics = step_fn(state, {
            "pair_ids": torch.as_tensor(np.asarray(ids, np.int64), device=ce.device),
            "pair_mask": torch.as_tensor(np.asarray(mask, np.int64), device=ce.device),
            "labels": torch.as_tensor(np.asarray(labels, np.float32), device=ce.device),
        })
        if s % 50 == 0 or s == steps - 1:
            loss = float(metrics["loss"])
            print(f"# train step {s}: bce {loss:.4f}", file=sys.stderr, flush=True)
    return loss


def candidates(rng, doc_topic, doc_pos, n_topics: int, k: int):
    """Per topic: one gold doc and ``k`` - 1 distractors in a random order →
    (candidate doc ids [T, k], the gold slot, the gold's evidence position)."""
    cand, gold_slot, gold_pos = [], [], []
    for t in range(n_topics):
        gold = int(rng.choice(np.flatnonzero(doc_topic == t)))
        others = np.flatnonzero(doc_topic != t)
        row = [gold] + list(rng.choice(others, size=k - 1, replace=False))
        order = rng.permutation(k)
        row = [row[i] for i in order]
        cand.append(row)
        gold_slot.append(row.index(gold))
        gold_pos.append(doc_pos[gold])
    return np.asarray(cand, np.int64), np.asarray(gold_slot), np.asarray(gold_pos)


def gold_metrics(logits: np.ndarray, gold_slot: np.ndarray, gold_pos: np.ndarray) -> dict:
    """Rank of the gold doc within its candidates, split by the planted
    evidence depth: n, MRR, recall@1, recall@5."""
    ranks = np.array([int(np.sum(logits[q] > logits[q, gold_slot[q]])) for q in range(len(gold_slot))])
    out = {}
    for name in ["all", *POSITIONS]:
        sel = np.ones(len(ranks), bool) if name == "all" else gold_pos == name
        r = ranks[sel]
        out[name] = {
            "n": int(sel.sum()),
            "mrr": round(float(np.mean(1.0 / (r + 1))), 4),
            "recall@1": round(float(np.mean(r == 0)), 4),
            "recall@5": round(float(np.mean(r < 5)), 4),
        }
    return out


def measure(ce, corpus, doc_topic, doc_pos, queries, rng, k: int, doc_words: int, int8: bool = False) -> dict:
    """The flat rerank, the int8 view (``int8``) and the cascade grid over
    one candidate set per topic drawn from ``rng``: the record's ``flat``,
    ``int8_flat`` and ``cascade_grid``."""
    ld = doc_words + 4
    d_ids, d_mask = ce.prepare_corpus_tokens(corpus, max_doc_tokens=ld)
    q_ids, q_mask = ce.encode_queries_raw(queries, max_query_tokens=4)
    q_ids = torch.as_tensor(np.asarray(q_ids, np.int64), device=ce.device)
    q_mask = torch.as_tensor(np.asarray(q_mask, np.int64), device=ce.device)
    cand, gold_slot, gold_pos = candidates(rng, doc_topic, doc_pos, len(queries), k)
    cand_t = torch.as_tensor(cand, device=ce.device)
    di = ce._token_ids(d_ids)[cand_t]
    dm = d_mask[cand_t].to(torch.int64)

    def scores(model, **cascade) -> np.ndarray:
        if cascade:
            return model.rerank_tokens_cascade(q_ids, q_mask, di, dm, pair_chunk=256, **cascade).cpu().numpy()
        return model.rerank_tokens(q_ids, q_mask, di, dm, pair_chunk=256).cpu().numpy()

    flat = scores(ce)
    out = {"flat": gold_metrics(flat, gold_slot, gold_pos), "int8_flat": None, "cascade_grid": []}
    print(f"# flat rerank: {json.dumps(out['flat']['all'])}", file=sys.stderr, flush=True)
    if int8:
        s8 = scores(ce.quantized())
        out["int8_flat"] = gold_metrics(s8, gold_slot, gold_pos)
        out["int8_flat"]["score_corr_vs_f32"] = round(float(np.corrcoef(flat.ravel(), s8.ravel())[0, 1]), 5)
    for stage1 in (8, 16, 24, ld):
        for keep in (4, 8, 16):
            m = gold_metrics(scores(ce, keep=keep, stage1_tokens=stage1), gold_slot, gold_pos)
            flops = round(min(stage1, ld) / ld + keep / k, 3)
            out["cascade_grid"].append({"keep": keep, "stage1_tokens": stage1, "flops_vs_flat": flops, "metrics": m})
            print(f"# cascade keep={keep} stage1={stage1} (~{flops:.2f}x flat): mrr {m['all']['mrr']} "
                  f"(early {m['early']['mrr']} middle {m['middle']['mrr']} late {m['late']['mrr']})",
                  file=sys.stderr, flush=True)
    return out


def run(args: argparse.Namespace, train=train_ce) -> dict:
    """Build the world, train (``train(ce, corpus, doc_topic, queries,
    steps, batch, rng)`` → final loss) and measure: the JSON record."""
    from fusion_tpu_torch.core.device import resolve_device
    from fusion_tpu_torch.models.crossencoder import CrossEncoder

    device = resolve_device(args.device)
    rng = np.random.default_rng(42)
    corpus, doc_topic, doc_pos, queries = build_world(rng, args.n_topics, args.docs_per_topic, args.doc_words,
                                                      sig_words=3, positions=POSITIONS)
    ce = CrossEncoder(model_config(args.shape), max_length=96, device=device, param_dtype=torch.float32)
    final_loss = train(ce, corpus, doc_topic, queries, args.steps, args.batch, rng)
    m = measure(ce, corpus, doc_topic, doc_pos, queries, rng, args.candidates, args.doc_words, args.int8)
    return {
        "metric": "cascade_rerank_quality_study",
        "value": m["flat"]["all"]["mrr"],
        "unit": "flat_mrr",
        "setup": {
            "n_topics": args.n_topics, "docs_per_topic": args.docs_per_topic,
            "doc_tokens": args.doc_words + 4, "candidates_per_query": args.candidates,
            "evidence_positions_tokens": POSITIONS,
            "train_steps": args.steps, "final_bce": round(final_loss, 4),
            "model": (
                "CamemBERT-base-shaped CE (12L x 768, vocab 4096), "
                if args.shape == "base" else
                "tiny CE (EncoderConfig.tiny, vocab 4096), "
            ) + "planted-topic synthetic corpus",
            "device": device.type,
        },
        **m,
        "reading": (
            "cascade matches flat wherever the planted evidence depth <= "
            "stage1_tokens; quality collapses for evidence past the "
            "truncation exactly as predicted — set stage1_tokens >= the "
            "corpus' typical evidence depth and keep >= the expected "
            "number of prefix-weak positives per query"
        ),
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
