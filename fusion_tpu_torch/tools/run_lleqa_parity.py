"""The LLeQA quality harness: the five systems, fusion and the rerank, gated.

The counterpart of ``scripts/run_lleqa_parity.py``: on LLeQA records (a
``--fixture`` JSON file of raw records) and saved checkpoints it runs

  * BM25 (k1 2.5, b 0.2, the French preprocessing),
  * DPR and SPLADE (``HybridPipeline.single_vector_search``),
  * ColBERT (``multi_vector_search`` over the prepared token-major corpus:
    the MaxSim kernel K1 on the card),
  * the fusion of the four (NSF over percentile ranks by default),
  * the monoBERT rerank of the fused lists (with ``--monobert_path``),

evaluates each with ``eval/metrics.Metrics`` and writes
``performance_hybrid_lleqa_<split>.json`` under ``--out_dir``.  When the
``--targets`` file exists, every ``{system: {metric: points}}`` entry in it
must be met within ``--tolerance`` points; a miss exits 1.

Records come only from ``--fixture``: without it the loader raises (the
dataset is not fetched).  A system without a checkpoint starts from the
local HuggingFace directory ``--encoder`` (zero-shot, not comparable with
trained numbers); nothing is downloaded.

The harness runs on one card; ``--device cpu`` runs it on the CPU.
``--dtype bfloat16`` computes the loaded models in bf16 (the default f32 is
the reference's).  The pieces are plain functions (``load_data``,
``load_models``, ``evaluate_systems``, ``gate_failures``) so a caller can
run the systems once and gate the report against several target files.

    python -m fusion_tpu_torch.tools.run_lleqa_parity --fixture lleqa.json \\
        --dpr_path DIR --splade_path DIR --colbert_path DIR --monobert_path DIR \\
        [--targets parity_targets.json] [--out_dir output/lleqa_parity]

parity_targets.json format:
  {"bm25": {"recall@100": 54.3, "ndcg@10": ...}, "dpr": {...},
   "splade": {...}, "colbert": {...}, "fused": {...}, "reranked": {...}}
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def log(msg: str) -> None:
    print(f"[lleqa-parity] {msg}", file=sys.stderr, flush=True)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fixture", default=None, help="raw LLeQA records JSON")
    ap.add_argument("--split", default="dev", choices=["dev", "test"])
    ap.add_argument("--encoder", default="camembert-base",
                    help="local HuggingFace checkpoint directory for the systems without a checkpoint")
    ap.add_argument("--dpr_path", default=None)
    ap.add_argument("--splade_path", default=None)
    ap.add_argument("--colbert_path", default=None)
    ap.add_argument("--monobert_path", default=None)
    ap.add_argument("--fusion", default="nsf", choices=["nsf", "rrf", "bcf"])
    ap.add_argument("--normalization", default="percentile-rank")
    ap.add_argument("--rerank_depth", type=int, default=100)
    ap.add_argument("--targets", default="parity_targets.json")
    ap.add_argument("--out_dir", default="output/lleqa_parity")
    ap.add_argument("--tolerance", type=float, default=1.5)
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES),
                    help="compute dtype of the loaded models")
    return ap.parse_args(argv)


def load_data(fixture: str | None):
    """The LLeQA records of ``fixture`` as ``RetrievalData``; without a
    fixture the loader raises (the hub is not reached)."""
    from fusion_tpu_torch.data.lleqa import LLeQALoader

    raw = None
    if fixture:
        with open(fixture) as f:
            raw = json.load(f)
    return LLeQALoader(raw=raw).load()


def _local_encoder(encoder: str, system: str) -> str:
    if not os.path.isdir(encoder):
        raise FileNotFoundError(
            f"no {system} checkpoint was given and --encoder {encoder!r} is not a local directory: "
            "pass the checkpoint, or a local HuggingFace checkpoint directory (nothing is downloaded)"
        )
    log(f"WARNING: no {system} checkpoint — zero-shot {encoder} (NOT comparable to the paper's trained numbers)")
    return encoder


def load_models(args: argparse.Namespace, device) -> dict:
    """The DPR, SPLADE, ColBERT and (with ``--monobert_path``) monoBERT
    models on ``device``: each from its checkpoint, else from the local
    HuggingFace directory ``--encoder``."""
    from fusion_tpu_torch.models.biencoder import BiEncoder
    from fusion_tpu_torch.models.colbert import ColBERT
    from fusion_tpu_torch.models.crossencoder import CrossEncoder

    dtype = DTYPES[args.dtype]
    models = {}
    for name, head, path in (("dpr", "dense", args.dpr_path), ("splade", "splade", args.splade_path)):
        if path:
            models[name] = BiEncoder.load(path, device=device, dtype=dtype)
        else:
            models[name] = BiEncoder.from_pretrained_hf(
                _local_encoder(args.encoder, name), head=head, dtype=dtype, max_query_length=64,
                max_doc_length=512, device=device)
    if args.colbert_path:
        models["colbert"] = ColBERT.load(args.colbert_path, device=device, dtype=dtype)
    else:
        models["colbert"] = ColBERT.from_pretrained_hf(
            _local_encoder(args.encoder, "colbert"), dim=128, dtype=dtype, max_query_length=64, max_doc_length=512,
            device=device)
    models["monobert"] = (
        CrossEncoder.load(args.monobert_path, device=device, dtype=dtype) if args.monobert_path else None
    )
    return models


def _synced(device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def split_queries(data, split: str) -> tuple[list[str], list]:
    """(the queries of ``data``'s ``split``, their gold article ids)."""
    qids = list(data.queries[split].keys())
    return [data.queries[split][q] for q in qids], [data.qrels[split].get(q, []) for q in qids]


def system_metrics(pipeline, labels, ranked) -> dict:
    """The report's metrics of ``ranked`` (internal ids) against ``labels``."""
    from fusion_tpu_torch.eval.metrics import Metrics

    metrics = Metrics(
        recall_at_k=(5, 10, 20, 50, 100, 200, 500, 1000),
        map_at_k=(10, 100), mrr_at_k=(10, 100), ndcg_at_k=(10, 100),
        accuracy_at_k=(1,),
    )
    return metrics.compute_all_metrics(labels, pipeline.to_external_ids(ranked))


def fuse_systems(pipeline, results: dict, fusion: str, normalization: str, topk: int):
    """``results``' lists fused by ``fusion`` (NSF weighs the systems equally
    unless tuned weights are given), the percentile distributions drawn from
    the lists' own scores."""
    from fusion_tpu_torch.fusion.aggregator import build_percentile_distribution

    distributions = None
    if normalization in ("percentile-rank", "normal-curve-equivalent"):
        distributions = {
            name: build_percentile_distribution(rl.scores.cpu().numpy(), num_points=10_000)
            for name, rl in results.items()
        }
    return pipeline.fuse(results, method=fusion, normalization=normalization,
                         percentile_distributions=distributions, return_topk=topk)


def evaluate_systems(data, split: str, models: dict, fusion: str = "nsf", normalization: str = "percentile-rank",
                     rerank_depth: int = 100, batch_size: int = 64, device="cuda") -> tuple[dict, dict]:
    """Run every system over ``data``'s ``split`` queries: (the report, with
    ``seconds`` per system; the ranked lists per system, internal ids)."""
    from fusion_tpu_torch.data.preprocessor import TextPreprocessor
    from fusion_tpu_torch.hybrid import HybridPipeline

    pipeline = HybridPipeline(data.corpus, device=device)
    device = pipeline.device
    queries, labels = split_queries(data, split)
    topk = min(1000, len(data.corpus))
    log(f"corpus={len(data.corpus)} queries[{split}]={len(queries)}")

    def evaluate(ranked):
        return system_metrics(pipeline, labels, ranked)

    report: dict = {"split": split, "corpus_size": len(data.corpus), "num_queries": len(queries), "systems": {}}
    results: dict = {}
    seconds: dict = {}

    # BM25 at the tuned LLeQA constants, with the French preprocessing
    t0 = _synced(device)
    out = pipeline.bm25_search(queries, k1=2.5, b=0.2, return_topk=topk, do_preprocessing=True)
    results["bm25"] = out.ranked
    seconds["bm25"] = _synced(device) - t0
    report["systems"]["bm25"] = evaluate(out.ranked)
    report["systems"]["bm25"]["preprocessor"] = "spacy" if TextPreprocessor().nlp is not None else "fallback"
    log(f"bm25 done in {seconds['bm25']:.1f}s recall@100={report['systems']['bm25'].get('recall@100'):.4f}")

    for name in ("dpr", "splade"):
        t0 = _synced(device)
        out = pipeline.single_vector_search(queries, models[name], return_topk=topk, batch_size=batch_size)
        results[name] = out.ranked
        seconds[name] = _synced(device) - t0
        report["systems"][name] = evaluate(out.ranked)
        log(f"{name} done in {seconds[name]:.1f}s recall@100={report['systems'][name].get('recall@100'):.4f}")

    # the prepared token-major branch: K1 on the card, its plain version on
    # the CPU
    t0 = _synced(device)
    out = pipeline.multi_vector_search(queries, models["colbert"], return_topk=topk, batch_size=batch_size,
                                       use_pallas=True)
    results["colbert"] = out.ranked
    seconds["colbert"] = _synced(device) - t0
    report["systems"]["colbert"] = evaluate(out.ranked)
    log(f"colbert done in {seconds['colbert']:.1f}s")

    t0 = _synced(device)
    fused = fuse_systems(pipeline, results, fusion, normalization, topk)
    results["fused"] = fused
    seconds["fused"] = _synced(device) - t0
    report["systems"]["fused"] = evaluate(fused)
    log(f"fused recall@100={report['systems']['fused'].get('recall@100'):.4f}")

    if models.get("monobert") is not None:
        t0 = _synced(device)
        depth = min(rerank_depth, topk)
        out = pipeline.cross_encoder_search(queries, fused, models["monobert"], return_topk=depth)
        results["reranked"] = out.ranked
        seconds["reranked"] = _synced(device) - t0
        report["systems"]["reranked"] = evaluate(out.ranked)
        log(f"reranked done in {seconds['reranked']:.1f}s")
    report["seconds"] = {k: round(v, 3) for k, v in seconds.items()}
    return report, results


def write_report(report: dict, out_dir: str, split: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"performance_hybrid_lleqa_{split}.json")
    with open(out_path, "w") as f:
        json.dump(report, f, indent=2, default=float)
    log(f"wrote {out_path}")
    return out_path


def gate_failures(report: dict, targets: dict, tolerance: float) -> list[str]:
    """Each target ``{system: {metric: points}}`` the report misses by more
    than ``tolerance`` points (a metric ≤ 1 is read as a fraction)."""
    failures = []
    for system, wants in targets.items():
        got = report["systems"].get(system, {})
        for metric_name, want in wants.items():
            have = got.get(metric_name)
            if have is None:
                failures.append(f"{system}.{metric_name}: missing")
                continue
            have_pts = have * 100 if have <= 1.0 else have
            if abs(have_pts - want) > tolerance:
                failures.append(f"{system}.{metric_name}: got {have_pts:.2f}, want {want:.2f} ±{tolerance}")
    return failures


def apply_gate(report: dict, targets_path: str, tolerance: float) -> None:
    """Gate ``report`` against the targets file, if it exists: a miss logs
    the failures and exits 1."""
    if not os.path.exists(targets_path):
        log(f"no {targets_path} — report written, no gate applied (fill targets from arXiv:2409.01357 tables)")
        return
    with open(targets_path) as f:
        failures = gate_failures(report, json.load(f), tolerance)
    if failures:
        log("PARITY FAIL:\n  " + "\n  ".join(failures))
        sys.exit(1)
    log(f"PARITY OK vs {targets_path}")


def main(argv=None) -> dict:
    from fusion_tpu_torch.core.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    data = load_data(args.fixture)
    models = load_models(args, device)
    report, _ = evaluate_systems(data, args.split, models, fusion=args.fusion, normalization=args.normalization,
                                 rerank_depth=args.rerank_depth, batch_size=args.batch_size, device=device)
    write_report(report, args.out_dir, args.split)
    apply_gate(report, args.targets, args.tolerance)
    return report


if __name__ == "__main__":
    main()
