"""Sweep the single-device hybrid retrieval program over query batches.

The counterpart of ``scripts/probe_hybrid_roofline.py``.  It asks two
questions of the retrieval program (no rerank) on one card:

  1. Does the query batch underfill the card?  The dense and SPLADE search
     products have M = B rows and the per-batch host dispatch amortizes
     with B: sweep B ∈ {32, 64, 128, 256} for ms a batch, queries/s and MFU.
  2. Do three sequential trunk forwards serialize small operations?  The
     three query encoders share one architecture, so their trunks can run
     as one batched forward (``stacked_trunk``: the trunk module's own
     forward ``vmap``-ed over the three trunks' stacked parameters, as the
     script maps its ``apply``), the heads after it: the ``stacked``
     variant, checked against the ``plain`` one (the same fused ids, else
     their top-100 overlap).

The world is ``bench.py``'s: N 27,940 zipf docs (BM25 k1 2.5, b 0.2, the
impact-ordered index at cap 1,024: ``impact_search``), CamemBERT-base
encoders in bf16 (seeded random weights), Lq 32, random bf16 dense
[N, 768] and SPLADE [N, 32,005] corpora and a [N, 128, 128] ColBERT token
corpus (prepared token-major: ``maxsim_search_tm``, K1 on the card), top
1,000, RRF over the four legs.

Times are CUDA events around groups of calls (``time_groups``: the least
per-call time over the groups, each group's beside it), without the
script's subtraction of a single call's round trip.  MFU is
``utils/profiling.mfu_report`` against the H100's bf16 peak, K1's
FLOPs added by hand (the counter does not see a kernel launched through
ctypes).  One JSON line per row, then the ``hybrid_roofline_best`` line.

    python -m fusion_tpu_torch.tools.probe_hybrid_roofline [--batches 32,64,128,256]
CPU smoke: --device cpu --tiny --n_docs 512 --topk 16 --batches 4,8
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

LQ, LD_TOK, DIM, VOCAB_N = 32, 128, 128, 30_000


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default="32,64,128,256")
    ap.add_argument("--n_docs", type=int, default=27_940)
    ap.add_argument("--topk", type=int, default=1000)
    ap.add_argument("--tiny", action="store_true", help="EncoderConfig.tiny(vocab_size=1024) encoders")
    ap.add_argument("--skip_stacked", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (the measurement) or cpu (smoke sizes)")
    return ap.parse_args(argv)


def zipf_docs(n: int, seed: int = 42) -> tuple[list[str], np.random.Generator]:
    """``bench.py``'s lexical corpus (40-160 zipf words ``t<id>`` a doc over
    30,000) and the generator, which goes on to draw the queries."""
    rng = np.random.default_rng(seed)
    p = zipf_p()
    lens = rng.integers(40, 160, size=n)
    return [" ".join(f"t{t}" for t in rng.choice(VOCAB_N, size=length, p=p)) for length in lens], rng


def zipf_p() -> np.ndarray:
    p = 1.0 / np.arange(1, VOCAB_N + 1)
    return p / p.sum()


def zipf_queries(rng: np.random.Generator, b: int) -> list[str]:
    p = zipf_p()
    return [" ".join(f"t{t}" for t in rng.choice(VOCAB_N, size=6, p=p)) for _ in range(b)]


@dataclasses.dataclass
class World:
    """The program's inputs that do not change with the batch."""

    bm25: object
    impact_index: object
    dense: object
    splade: object
    colbert: object
    d_corpus: torch.Tensor  # [N, H]
    s_corpus: torch.Tensor  # [N, V]
    c_tm: torch.Tensor  # [Ld, N, D] prepared
    c_valid: torch.Tensor  # [N]
    n_docs: int
    topk: int


def random_corpora(n: int, hidden: int, vocab: int, device, seed: int = 0):
    """bf16 gaussian dense [n, hidden] and SPLADE [n, vocab] corpora and a
    [n padded to 128, 128, 128] token corpus (pad docs masked), drawn from
    one seeded generator on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    d_corpus = torch.randn(n, hidden, device=device, generator=gen).to(torch.bfloat16)
    s_corpus = torch.empty((n, vocab), dtype=torch.bfloat16, device=device)
    for s in range(0, n, 4096):  # in row steps: the f32 draw of the whole [n, vocab] is 3.6 GB
        m = min(4096, n - s)
        s_corpus[s : s + m] = torch.randn(m, vocab, device=device, generator=gen).to(torch.bfloat16)
    n_pad = -(-n // 128) * 128
    c_tokens = torch.randn(n_pad, LD_TOK, DIM, device=device, generator=gen).to(torch.bfloat16)
    c_mask = (torch.arange(n_pad, device=device) < n)[:, None].expand(n_pad, LD_TOK).to(torch.float32)
    return d_corpus, s_corpus, c_tokens, c_mask


def make_world(bm25, dense, splade, colbert, d_corpus, s_corpus, c_tokens, c_mask, topk: int,
               impact_cap: int = 1024) -> World:
    from fusion_tpu_torch.ops.maxsim import prepare_token_corpus

    c_tm, c_valid = prepare_token_corpus(c_tokens, c_mask)
    return World(bm25, bm25.to_impact_index(cap=impact_cap), dense, splade, colbert, d_corpus, s_corpus, c_tm,
                 c_valid, bm25.n_docs, topk)


def build_world(args: argparse.Namespace, docs=None, models=None) -> tuple[World, np.random.Generator]:
    """``args``' world on ``args.device`` and the generator of the queries.
    ``docs`` and ``models`` (dense, splade, colbert) built by the caller are
    taken as they are."""
    from fusion_tpu_torch.core.device import resolve_device
    from fusion_tpu_torch.models.biencoder import BiEncoder
    from fusion_tpu_torch.models.bm25 import BM25Index
    from fusion_tpu_torch.models.colbert import ColBERT
    from fusion_tpu_torch.models.encoder import EncoderConfig

    device = resolve_device(args.device)
    if docs is None:
        docs, rng = zipf_docs(args.n_docs)
    else:
        rng = np.random.default_rng(43)
    bm25 = BM25Index.build(docs, k1=2.5, b=0.2, device=device)
    if models is None:
        cfg = EncoderConfig.tiny(vocab_size=1024) if args.tiny else EncoderConfig(dropout=0.0, dtype=torch.bfloat16)
        kw = dict(max_query_length=LQ, max_doc_length=128, device=device)
        models = (BiEncoder(cfg, head="dense", seed=1, **kw), BiEncoder(cfg, head="splade", seed=2, **kw),
                  ColBERT(cfg, dim=DIM, max_query_length=LQ, max_doc_length=LD_TOK, seed=3, device=device))
    dense, splade, colbert = models
    corpora = random_corpora(len(docs), dense.cfg.hidden_size, dense.cfg.vocab_size, device)
    return make_world(bm25, dense, splade, colbert, *corpora, topk=min(args.topk, len(docs))), rng


# ----------------------------------------------------------------------
# the query encoders: plain (three forwards) and stacked (one)
# ----------------------------------------------------------------------
def stacked_trunk(world: World):
    """The three query trunks as one forward, as the JAX script's ``vmap``
    of the trunk's ``apply`` over its stacked parameters: their parameters
    stacked (``torch.func.stack_module_state``) and the trunk module's own
    forward mapped over them (``vmap(functional_call)``) → ``fn(input_ids,
    attention_mask)`` giving hidden [3, B, L, H].  The attention form must
    be one of PyTorch operations: ``vmap`` cannot map a launch of the
    ``flash`` kernel."""
    import copy

    from torch.func import functional_call, stack_module_state, vmap

    trunks = [world.dense.module, world.splade.module.encoder, world.colbert.module.encoder]
    if trunks[0].cfg.attention_impl == "flash":
        raise ValueError("the stacked trunk maps the einsum attention forms only, not 'flash'")
    params, buffers = stack_module_state(trunks)
    base = copy.deepcopy(trunks[0]).to("meta")
    forward = vmap(lambda p, b, ids, mask: functional_call(base, (p, b), (ids, mask)), in_dims=(0, 0, None, None))
    return lambda input_ids, attention_mask: forward(params, buffers, input_ids, attention_mask)


def plain_encode(world: World, q_ids, q_mask):
    return (world.dense.embed_tokens(q_ids, q_mask), world.splade.embed_tokens(q_ids, q_mask),
            world.colbert.embed_tokens(q_ids, q_mask))


@torch.inference_mode()
def stacked_encode(world: World, stack, q_ids, q_mask):
    """The three query encoders through one trunk forward, then each head
    as its model applies it."""
    from fusion_tpu_torch.models import heads

    hidden = stack(q_ids, q_mask)
    q_dense = heads.pool(hidden[0], q_mask, world.dense.pooling)
    logits = world.splade.module.mlm(hidden[1])
    q_splade = heads.splade_activation(logits, q_mask, world.splade.pooling)
    q_tok = world.colbert.module.colbert(hidden[2], q_mask)
    return q_dense, q_splade, q_tok


@torch.inference_mode()
def legs(world: World, encode, q_ids, q_mask, q_terms, q_weights) -> dict:
    """The four legs' ranked lists, the queries encoded by ``encode``."""
    from fusion_tpu_torch.index.inverted import impact_search
    from fusion_tpu_torch.ops.maxsim import maxsim_search_tm
    from fusion_tpu_torch.ops.mips import dense_search

    q_dense, q_splade, q_tok = encode(q_ids, q_mask)
    topk = world.topk
    q_tok = q_tok.to(torch.bfloat16) if world.c_tm.is_cuda else q_tok
    return {
        "bm25": impact_search(q_terms, q_weights, world.impact_index, k=topk),
        "dpr": dense_search(q_dense.to(torch.bfloat16), world.d_corpus, k=topk, similarity="cos_sim"),
        "splade": dense_search(q_splade.to(torch.bfloat16), world.s_corpus, k=topk, similarity="dot_score"),
        "colbert": maxsim_search_tm(q_tok, q_mask.to(torch.float32), world.c_tm, world.c_valid, k=topk),
    }


@torch.inference_mode()
def hybrid(world: World, encode, q_ids, q_mask, q_terms, q_weights):
    """The four legs and their RRF fusion: (fused ids, fused scores)."""
    from fusion_tpu_torch.fusion.aggregator import Aggregator

    fused = Aggregator.fuse(legs(world, encode, q_ids, q_mask, q_terms, q_weights), method="rrf",
                            return_topk=world.topk)
    return fused.ids, fused.scores


def query_inputs(world: World, queries: list[str]):
    """(query token ids, mask, BM25 term ids, term weights) on the world's
    device."""
    from fusion_tpu_torch.models.encoder import token_tensors

    q_terms, q_weights = world.bm25.encode_queries(queries, max_terms=8)
    ids, mask = world.dense.text_encoder.encode(queries, query_mode=True)
    q_ids, q_mask = token_tensors(ids, mask, world.d_corpus.device)
    return q_ids, q_mask, q_terms, q_weights


def k1_flops(world: World, b: int) -> float:
    """K1's FLOPs for a batch: 2 · (B·Lq) · (N·Ld) · D."""
    ld, n, d = world.c_tm.shape
    return 2.0 * b * LQ * n * ld * d


def time_groups(fn, device, groups: int = 4, per: int = 6) -> tuple[float, list[float]]:
    """(least ms a call over ``groups`` groups of ``per`` calls, each
    group's ms a call): CUDA events on the card, the host clock on the CPU."""
    out = []
    for _ in range(groups):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(per):
                fn()
            end.record()
            torch.cuda.synchronize(device)
            out.append(start.elapsed_time(end) / per)
        else:
            t0 = time.perf_counter()
            for _ in range(per):
                fn()
            out.append((time.perf_counter() - t0) * 1000 / per)
    return min(out), out


def overlap_at(a: np.ndarray, b: np.ndarray, k: int = 100) -> float:
    return float(np.mean([len(set(a[q, :k].tolist()) & set(b[q, :k].tolist())) / k for q in range(a.shape[0])]))


def sweep(world: World, rng: np.random.Generator, batches, variants=("plain", "stacked"), groups: int = 4,
          per: int = 6, emit=print) -> list[dict]:
    """Every (batch, variant) row; ``emit`` gets each row's JSON line."""
    from fusion_tpu_torch.utils.profiling import mfu_report

    device = world.d_corpus.device
    stack = stacked_trunk(world) if "stacked" in variants else None
    encoders = {"plain": lambda i, m: plain_encode(world, i, m),
                "stacked": lambda i, m: stacked_encode(world, stack, i, m)}
    rows = []
    for b in batches:
        inputs = query_inputs(world, zipf_queries(rng, b))
        plain_ids = None
        for variant in variants:
            encode = encoders[variant]

            def fn(encode=encode):
                return hybrid(world, encode, *inputs)

            t0 = time.perf_counter()
            ids = fn()[0].cpu().numpy()
            first_s = time.perf_counter() - t0
            row = {"variant": variant, "batch": b}
            if variant == "plain":
                plain_ids = ids
            elif plain_ids is not None:
                row["ids_equal_plain"] = bool(np.array_equal(ids, plain_ids))
                if not row["ids_equal_plain"]:
                    row["overlap@100_vs_plain"] = round(overlap_at(ids, plain_ids), 4)
            ms, spread = time_groups(fn, device, groups, per)
            row.update({"ms_per_batch": round(ms, 3), "queries_per_s": round(b / ms * 1000, 1),
                        "group_spread_ms": [round(x, 3) for x in spread], "first_call_s": round(first_s, 3)})
            row.update(mfu_report(fn, (), ms / 1000, hand_flops=k1_flops(world, b) if device.type == "cuda" else 0.0))
            emit(json.dumps(row))
            rows.append(row)
    return rows


def best_record(rows: list[dict], n_docs: int, topk: int) -> dict:
    best = max(rows, key=lambda r: r["queries_per_s"])
    return {"metric": "hybrid_roofline_best", "value": best["queries_per_s"], "unit": "queries/s",
            "detail": {"rows": rows, "best": best, "n_docs": n_docs, "topk": topk}}


def main(argv=None) -> dict:
    args = parse_args(argv)
    world, rng = build_world(args)
    variants = ("plain",) if args.skip_stacked else ("plain", "stacked")
    rows = sweep(world, rng, [int(b) for b in args.batches.split(",")], variants,
                 emit=lambda line: print(line, flush=True))
    record = best_record(rows, world.n_docs, world.topk)
    print(json.dumps(record), flush=True)
    sys.stdout.flush()
    return record


if __name__ == "__main__":
    main()
