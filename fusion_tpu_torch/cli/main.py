"""Command-line entry points of the port (``fusion-tpu-torch``,
``python -m fusion_tpu_torch.cli.main``), with the JAX package's CLI's
commands and flags:

  fusion-tpu-torch bm25     --task {evaluate,tune,negatives}
  fusion-tpu-torch dpr      --task {train,test}
  fusion-tpu-torch splade   --task {train,test} [--splade_variant ...]
  fusion-tpu-torch colbert  --task {train,index,search,test} [--colbert_loss ...]
  fusion-tpu-torch monobert --task {train,test} [--neg_per_pos N] [--backbone {bert,t5}]
  fusion-tpu-torch hybrid   [--run_bm25 --run_dpr --run_splade --run_colbert
                             --run_monobert] [--fusion ...] [--normalization ...]
  fusion-tpu-torch serve    --task {build,search} --index_dir DIR [--http_port N]

Data comes from a ``--fixture`` JSON file: LLeQA's record layout
({"corpus": [...], "questions": {...}, "negatives": {...}}) by default, or
with ``--dataset mmarco-<lang>`` / ``mrtydi-<lang>`` the mMARCO raw schema
({"corpus": {pid: text}, "train_queries", "train_qrels", "dev_queries",
"dev_qrels", "negatives"}).  One flag is new:
``--device`` (default ``cuda``; the commands raise without a card unless
given ``--device cpu``).  Models load from ``--*_path`` checkpoints (either
package's) and compute in the ``--bf16`` dtype (f32 with ``--no_bf16`` or
``--tiny``); without a path a model is built untrained from its seed.
Training keeps f32 master weights and computes in that dtype, with each
layer recomputed in the backward pass unless ``--no_remat``, and is
data-parallel by default, as the JAX CLI's: the ``data`` axis takes the
largest divisor of the batch that is at most the number of ranks
(``_training_mesh``).  Under torchrun's environment (``torchrun
--nproc_per_node N -m fusion_tpu_torch.cli.main ...``) each process joins
the group through ``parallel.multihost.initialize_multihost`` (NCCL on
``cuda:{LOCAL_RANK}``, gloo with ``--device cpu``); a plain process that
sees several cards spawns one NCCL rank per card it uses and waits for them;
``--no_data_parallel`` keeps one card.  Rank 0 logs and writes ``final/``.
``--attention_impl`` picks the encoders' attention form (``einsum``,
``einsum_bf16``, ``flash``; ``--tiny`` keeps the tiny config's, as the JAX
CLI does); ``serve`` adds ``--ce_attention`` (default
``einsum_bf16``, the JAX CLI's), ``--encoders_attention``, ``--ce_int8``,
``--encoders_int8``, ``--rerank_buckets`` and ``--rerank_cascade``;
``monobert --backbone t5`` builds a T5 cross-encoder, and a checkpoint's
``model_type`` picks the backbone it loads as.

The datasets' network sources (the HF hub, ir_datasets) are not ported:
without ``--fixture`` a loader raises.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

from fusion_tpu_torch.core.device import resolve_device


def _read_fixture(args):
    if not args.fixture:
        return None
    with open(args.fixture) as f:
        return json.load(f)


def _load_lleqa(args):
    """Dataset loader dispatch: LLeQA (the default), mmarco-<lang> or
    mrtydi-<lang>, each from the ``--fixture`` records; every loader has
    load() / biencoder_sampler() / crossencoder_pairs() / hard_negatives(),
    so every command runs on each dataset."""
    if args.dataset.startswith("mmarco"):
        from fusion_tpu_torch.data.mmarco import MmarcoLoader

        lang = args.dataset.split("-")[-1] if "-" in args.dataset else "fr"
        return MmarcoLoader(lang=lang, raw=_read_fixture(args))
    if args.dataset.startswith("mrtydi"):
        from fusion_tpu_torch.data.mrtydi import MrTyDiLoader

        lang = args.dataset.split("-")[-1] if "-" in args.dataset else "en"
        return MrTyDiLoader(lang=lang, raw=_read_fixture(args))
    from fusion_tpu_torch.data.lleqa import LLeQALoader

    raw = _read_fixture(args)
    if raw is None:
        return LLeQALoader()  # raises: the hub loader is not ported
    neg = raw.get("negatives")
    if neg:
        neg = {int(k): v for k, v in neg.items()}
    return LLeQALoader.from_records(raw["corpus"], raw["questions"], neg)


def _encoder_config(args):
    from fusion_tpu_torch.models.encoder import EncoderConfig

    if args.tiny:
        return EncoderConfig.tiny(vocab_size=2048)
    # remat: at base width the activations of a training step without it
    # outgrow the card at the presets' batches
    return EncoderConfig(
        dtype=torch.bfloat16 if args.bf16 else torch.float32, remat=not args.no_remat,
        attention_impl=args.attention_impl,
    )


def _load_model(cls, path: str, args):
    """A checkpoint on ``--device``, computing in the CLI's encoder dtype."""
    return cls.load(path, device=args.device, dtype=_encoder_config(args).dtype)


def _crossencoder_class(path: str):
    """The cross-encoder class of a checkpoint, by its ``model_type``."""
    from fusion_tpu_torch.models import checkpoint
    from fusion_tpu_torch.models.crossencoder import CrossEncoder
    from fusion_tpu_torch.models.t5 import T5CrossEncoder

    return T5CrossEncoder if checkpoint.read_config(path).get("model_type") == "t5_crossencoder" else CrossEncoder


def _load_crossencoder(path: str, args):
    """A cross-encoder checkpoint of either backbone (BERT-style or T5)."""
    return _load_model(_crossencoder_class(path), path, args)


def cmd_bm25(args):
    from fusion_tpu_torch.cli.presets import BM25_PRESETS, BM25_TUNING_GRID
    from fusion_tpu_torch.eval.metrics import Metrics
    from fusion_tpu_torch.hybrid import HybridPipeline, run_evaluation
    from fusion_tpu_torch.utils.common import convert_colbert_results_to_negatives
    from fusion_tpu_torch.utils.loggers import write_metrics_csv

    data = _load_lleqa(args).load()
    pipeline = HybridPipeline(data.corpus, device=args.device)
    preset = BM25_PRESETS.get(args.dataset.split("-")[0], BM25_PRESETS["lleqa"])
    k1 = args.k1 if args.k1 is not None else preset.k1
    b = args.b if args.b is not None else preset.b
    split = "train" if args.task == "negatives" else ("dev" if args.task == "tune" else args.split)
    qids, queries, labels = data.split(split)

    os.makedirs(args.output_dir, exist_ok=True)
    if args.task == "tune":
        evaluator = Metrics(recall_at_k=[10, 100, 200, 500, 1000])
        rows = []
        for k1_v in BM25_TUNING_GRID["k1"]:
            for b_v in BM25_TUNING_GRID["b"]:
                res = pipeline.bm25_search(
                    queries, do_preprocessing=args.do_preprocessing, k1=k1_v, b=b_v, return_topk=1000
                )
                scores = evaluator.compute_all_metrics(labels, pipeline.to_external_ids(res.ranked))
                rows.append({"k1": k1_v, "b": b_v, **scores})
        write_metrics_csv(os.path.join(args.output_dir, "bm25_tuning_results.csv"), rows)
        best = max(rows, key=lambda r: r["recall@100"])
        try:
            from fusion_tpu_torch.utils.loggers import write_tuning_heatmap

            write_tuning_heatmap(os.path.join(args.output_dir, "bm25_tuning_heatmap.pdf"), rows)
        except ImportError as e:  # no matplotlib: the CSV is the artifact
            print(f"# heatmap skipped: {e}", file=sys.stderr)
        print(json.dumps({"best": best}))
        return

    res = pipeline.bm25_search(queries, do_preprocessing=args.do_preprocessing, k1=k1, b=b, return_topk=1000)
    preds_ext = pipeline.to_external_ids(res.ranked)

    if args.task == "negatives":
        negatives = convert_colbert_results_to_negatives(
            dict(zip(qids, preds_ext)), dict(zip(qids, labels)), args.num_negatives
        )
        with open(os.path.join(args.output_dir, "negatives_bm25.json"), "w") as f:
            json.dump(dict(sorted(negatives.items())), f, indent=2)
        print(json.dumps({"num_queries": len(negatives)}))
        return

    scores = run_evaluation(preds_ext, labels, print2console=True)
    scores["latency (ms/query)"] = res.latency_ms_per_query
    with open(os.path.join(args.output_dir, f"performance_bm25_{args.dataset}_{split}.json"), "w") as f:
        json.dump(scores, f, indent=2)


# ----------------------------------------------------------------------
# training commands
# ----------------------------------------------------------------------
def _data_ranks(batch_size: int, n: int) -> int:
    """The size of the ``data`` axis: the largest divisor of ``batch_size``
    that is at most ``n`` (a tiny batch on many cards trains on fewer; batch
    24 on 16 cards takes 12, not gcd's 8)."""
    return max((k for k in range(1, min(batch_size, n) + 1) if batch_size % k == 0), default=1)


def _training_mesh(args, batch_size: int):
    """``(mesh, batch_size)`` of a training run: a data-parallel mesh over
    the ranks of the process group (joined from torchrun's environment by
    ``main``), or ``None`` on one device.  Every rank is given the global
    batch and keeps its rows, so the batch must split over the ranks: a
    group whose size is not a divisor of the batch raises (run it with
    ``--nproc_per_node`` at ``_data_ranks``)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return None, batch_size
    from fusion_tpu_torch.parallel.multihost import is_primary_host
    from fusion_tpu_torch.parallel.sharding import make_mesh

    world = dist.get_world_size()
    if _data_ranks(batch_size, world) != world:
        raise ValueError(
            f"batch {batch_size} does not split over {world} ranks: run {_data_ranks(batch_size, world)} ranks")
    if is_primary_host():
        print(f"[train] data-parallel over {world} ranks (batch {batch_size})")
    return make_mesh(data=world), batch_size


def _train_samples(args, loader):
    """The training samples of the command ``args`` names: the
    cross-encoder's pairs, or the bi-encoders' and ColBERT's sampler."""
    if args.command == "monobert":
        return loader.crossencoder_pairs(neg_per_pos=args.neg_per_pos, seed=args.seed)
    return loader.biencoder_sampler(negs_per_query=args.negs_per_query, seed=args.seed)


def _train_batch_size(args, samples) -> int:
    """The global batch of the training command ``args`` names over
    ``samples``: ``--train_batch_size``, else the preset's, at most the
    samples (and at least 2).  Each command and ``_start_training`` (which
    picks the number of ranks to spawn from it) take it from here."""
    from fusion_tpu_torch.cli.presets import train_preset

    return args.train_batch_size or min(train_preset(args.command, args.dataset).batch_size, max(len(samples), 2))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn_ranks(argv: list[str], ranks: int) -> None:
    """Run this command as ``ranks`` NCCL ranks, one process per card
    (``cuda:0`` ... ``cuda:{ranks-1}``), under torchrun's environment
    variables; wait for them and raise if one failed."""
    port = str(_free_port())
    procs = []
    for rank in range(ranks):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=port, RANK=str(rank), WORLD_SIZE=str(ranks),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(ranks))
        procs.append(subprocess.Popen([sys.executable, "-m", "fusion_tpu_torch.cli.main", *argv], env=env))
    codes = [p.wait() for p in procs]
    if any(codes):
        raise SystemExit(f"data-parallel training failed: exit codes {codes} of ranks 0..{ranks - 1}")


def _start_training(args, argv: list[str]) -> bool:
    """Before a training command: under torchrun's environment, join the
    process group (NCCL on this rank's card, gloo on the CPU) → False; as a
    plain process with several visible cards and ``--data_parallel``, spawn
    the ranks, which train → True (nothing left to do here); else train on
    one device, saying so when cards were left idle → False."""
    from fusion_tpu_torch.parallel.multihost import initialize_multihost

    cuda = resolve_device(args.device).type == "cuda"
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        if not args.data_parallel:
            raise SystemExit("--no_data_parallel trains on one device: run it without torchrun")
        if cuda:
            initialize_multihost(backend="nccl")
            args.device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
        else:
            initialize_multihost(backend="gloo", device="cpu")
        return False
    cards = torch.cuda.device_count() if cuda else 0
    if cards > 1 and args.data_parallel:
        batch = _train_batch_size(args, _train_samples(args, _load_lleqa(args)))
        ranks = _data_ranks(batch, cards)
        if ranks > 1:
            print(f"[train] spawning {ranks} data-parallel ranks, one per card (batch {batch})")
            _spawn_ranks(argv, ranks)
            return True
        print(f"[train] batch {batch} does not split over the {cards} cards: training on one")
    elif cards > 1:
        print(f"[train] --no_data_parallel: training on {args.device} alone of {cards} cards")
    return False


def _train_and_save(model, step_fn, state, batches, cfg, schedule, args, record: dict):
    """``fit``, then rank 0 writes ``final/`` (whole parameters) and prints
    ``record``."""
    from fusion_tpu_torch.parallel.multihost import is_primary_host
    from fusion_tpu_torch.train.trainer import fit, whole_parameters

    fit(model, step_fn, batches, cfg, schedule=schedule, state=state)
    with whole_parameters(model, getattr(step_fn, "mesh", None)):
        if is_primary_host():
            model.save(os.path.join(args.output_dir, "final"))
            print(json.dumps(record))
    return model


def _fit_config(args, preset, steps: int, batch_size: int, **kw):
    from fusion_tpu_torch.train.trainer import FitConfig

    return FitConfig(
        steps=steps, batch_size=batch_size, optimizer_name=args.optimizer,
        learning_rate=args.lr or preset.learning_rate, scheduler=preset.scheduler,
        # a preset's warmup in steps rides the ratio
        warmup_ratio=(preset.warmup_steps / steps) if preset.warmup_steps else preset.warmup_ratio,
        seed=args.seed, freeze_layers_except_last_n=args.freeze_layers_except_last_n, **kw,
    )


def _make_biencoder(args, head: str, train: bool):
    from fusion_tpu_torch.cli.presets import train_preset
    from fusion_tpu_torch.models.biencoder import BiEncoder

    preset = train_preset("dpr" if head == "dense" else "splade", args.dataset)
    # the head's default pooling for every SPLADE variant, as the JAX CLI
    model = BiEncoder(
        _encoder_config(args), head=head,
        # --tiny: 64 tokens each, within the tiny encoder's positions (the JAX
        # CLI pads docs to 128, past them, where JAX clamps the position ids)
        max_query_length=min(preset.max_query_length, 64 if args.tiny else 10_000),
        max_doc_length=min(preset.max_doc_length, 64 if args.tiny else 10_000),
        seed=args.seed, device=args.device, param_dtype=torch.float32 if train else None,
    )
    return model, preset


def _train_biencoder(args, model, preset, rank_loss, reg_loss):
    from fusion_tpu_torch.data.datasets import Batches, collate_biencoder
    from fusion_tpu_torch.train.trainer import init_train_state, make_biencoder_train_step
    from fusion_tpu_torch.utils.loggers import WandbLogger

    sampler = _train_samples(args, _load_lleqa(args))
    steps = args.steps or preset.steps or (
        (preset.epochs or 1) * max(len(sampler) // min(preset.batch_size, len(sampler)), 1))
    batch_size = _train_batch_size(args, sampler)
    logger = WandbLogger(args.dataset, f"{args.model_name}-{args.seed}", log_dir=os.path.join(args.output_dir, "logs"))
    cfg = _fit_config(
        args, preset, steps, batch_size, log_every_n_steps=args.log_every, log_callback=logger.log_training,
        ckpt_path=os.path.join(args.output_dir, "checkpoints"), ckpt_save_steps=args.ckpt_save_steps,
    )
    state, tx, schedule = init_train_state(model, cfg)
    mesh, batch_size = _training_mesh(args, batch_size)
    step_fn = make_biencoder_train_step(model, tx, rank_loss, reg_loss, total_steps=steps, mesh=mesh)
    if mesh is not None:
        state = step_fn.place_state(state)
    batches = Batches(
        sampler.epochs, lambda s: collate_biencoder(model.text_encoder, s, args.negs_per_query), batch_size)
    return _train_and_save(model, step_fn, state, batches, cfg, schedule, args,
                           {"trained_steps": steps, "saved": os.path.join(args.output_dir, "final")})


def _test_biencoder(args, model):
    from fusion_tpu_torch.eval.evaluators import InformationRetrievalEvaluator

    data = _load_lleqa(args).load()
    ks = [k for k in (5, 10, 20, 50, 100, 200, 500, 1000) if k <= len(data.corpus)]
    ev = InformationRetrievalEvaluator(
        data.queries[args.split], data.corpus, data.qrels[args.split], recall_at_k=ks, map_at_k=[10, 100],
        mrr_at_k=[10, 100], ndcg_at_k=[10, 100], batch_size=args.batch_size,
    )
    ev(model, output_path=args.output_dir)
    print(json.dumps(ev.last_scores, default=float))


def _seed_loop(args, train_one):
    """One training run per ``--seeds`` entry, each into ``seed<N>/`` (the
    output dir itself for a single seed); returns the last run's model."""
    seeds = [int(s) for s in args.seeds.split(",")] if args.seeds else [args.seed]
    base_dir = args.output_dir
    for seed in seeds:
        args.seed = seed
        args.output_dir = os.path.join(base_dir, f"seed{seed}") if len(seeds) > 1 else base_dir
        model = train_one()
    args.output_dir = base_dir
    return model


def _biencoder_command(args, head: str, rank_loss: dict, reg_loss: dict | None):
    from fusion_tpu_torch.models.biencoder import BiEncoder

    if args.task == "train":

        def one():
            model, preset = _make_biencoder(args, head, train=True)
            return _train_biencoder(args, model, preset, rank_loss, reg_loss)

        return _seed_loop(args, one)
    model = _load_model(BiEncoder, args.model_path, args) if args.model_path else _make_biencoder(args, head, False)[0]
    _test_biencoder(args, model)


def cmd_dpr(args):
    return _biencoder_command(args, "dense", {"name": "MNRLoss", "scale": 20.0}, None)


def cmd_splade(args):
    from fusion_tpu_torch.models.biencoder import SPLADE_PRESETS

    variant = SPLADE_PRESETS[args.splade_variant]
    return _biencoder_command(args, "splade", variant["rank_loss"], variant["reg_loss"])


def cmd_colbert(args):
    from fusion_tpu_torch.cli.presets import train_preset
    from fusion_tpu_torch.index.compression import CompressedTokenIndex
    from fusion_tpu_torch.models.colbert import ColBERT, TokenIndex

    preset = train_preset("colbert", args.dataset)
    train = args.task == "train"
    if args.model_path:
        model = _load_model(ColBERT, args.model_path, args) if not train else ColBERT.load(
            args.model_path, device=args.device, dtype=_encoder_config(args).dtype, param_dtype=torch.float32)
    else:
        model = ColBERT(
            _encoder_config(args), dim=16 if args.tiny else preset.extra.get("dim", 128),
            max_query_length=min(preset.max_query_length, 32 if args.tiny else 10_000),
            max_doc_length=min(preset.max_doc_length, 64 if args.tiny else 10_000),
            seed=args.seed, device=args.device, param_dtype=torch.float32 if train else None,
        )
    loader = _load_lleqa(args)
    data = loader.load()
    index_dir = os.path.join(args.output_dir, "index")

    if train:
        from fusion_tpu_torch.data.datasets import Batches, collate_biencoder
        from fusion_tpu_torch.train.trainer import init_train_state, make_colbert_train_step

        sampler = _train_samples(args, loader)
        steps = args.steps or 100
        batch_size = _train_batch_size(args, sampler)
        cfg = _fit_config(args, preset, steps, batch_size, weight_decay=preset.weight_decay)
        state, tx, schedule = init_train_state(model, cfg)
        mesh, batch_size = _training_mesh(args, batch_size)
        step_fn = make_colbert_train_step(model, tx, loss_name=args.colbert_loss, mesh=mesh)
        if mesh is not None:
            state = step_fn.place_state(state)

        def collate(samples):
            b = collate_biencoder(model.text_encoder, samples, args.negs_per_query)
            for k in ("query_mask", "pos_mask", "neg_mask"):
                b[k] = b[k].astype(np.float32)
            return b

        return _train_and_save(model, step_fn, state, Batches(sampler.epochs, collate, batch_size), cfg, schedule,
                               args, {"trained_steps": steps})

    if args.task == "index":
        docs = list(data.corpus.values())
        if args.compressed:
            index = model.index_compressed(docs, batch_size=args.batch_size, nbits=args.nbits,
                                           kmeans_iters=args.kmeans_niters)
        else:
            index = model.index(docs, batch_size=args.batch_size)
        index.save(index_dir)
        print(json.dumps({"indexed_docs": len(data.corpus), "dir": index_dir, "compressed": bool(args.compressed)}))
        return

    # search and test reuse a saved index, or build one
    if os.path.exists(os.path.join(index_dir, "compressed_index.npz")):
        index = CompressedTokenIndex.load(index_dir, device=args.device)
    elif os.path.exists(os.path.join(index_dir, "token_index.npz")):
        index = TokenIndex.load(index_dir, device=args.device)
    else:
        index = model.index(list(data.corpus.values()), batch_size=args.batch_size)
    qids, queries, labels = data.split(args.split)
    # the token-major search (K1) on the card, the doc-major reference on the CPU
    ranked = model.search(queries, index, k=min(1000, len(data.corpus)), batch_size=args.batch_size,
                          use_pallas=torch.device(args.device).type == "cuda")
    from fusion_tpu_torch.hybrid import run_evaluation

    preds = ranked.remap_ids(np.asarray(list(data.corpus.keys()))).id_lists()
    os.makedirs(args.output_dir, exist_ok=True)
    if args.task == "test":
        scores = run_evaluation(preds, labels, print2console=True)
        with open(os.path.join(args.output_dir, "performance_colbert.json"), "w") as f:
            json.dump(scores, f, indent=2, default=float)
    else:
        with open(os.path.join(args.output_dir, "ranking.json"), "w") as f:
            json.dump({str(q): p[:100] for q, p in zip(qids, preds)}, f)
        print(json.dumps({"searched": len(queries)}))


def cmd_monobert(args):
    from fusion_tpu_torch.cli.presets import train_preset
    from fusion_tpu_torch.models.crossencoder import CrossEncoder

    preset = train_preset("monobert", args.dataset)
    train = args.task == "train"
    cfg = _encoder_config(args)
    max_len = 32 if args.tiny else preset.max_doc_length
    param_dtype = torch.float32 if train else None
    if args.model_path:
        model = _load_crossencoder(args.model_path, args) if not train else _crossencoder_class(args.model_path).load(
            args.model_path, device=args.device, dtype=cfg.dtype, param_dtype=torch.float32)
    elif args.backbone == "t5":
        # the JAX CLI's T5: the tiny config, or the base widths at the
        # encoder's vocabulary, in its default (f32) dtype
        from fusion_tpu_torch.models.t5 import T5Config, T5CrossEncoder

        t5cfg = T5Config.tiny() if args.tiny else T5Config(vocab_size=cfg.vocab_size)
        model = T5CrossEncoder(t5cfg, max_length=max_len, seed=args.seed, device=args.device, param_dtype=param_dtype)
    else:
        model = CrossEncoder(cfg, max_length=max_len, seed=args.seed, device=args.device, param_dtype=param_dtype)
    loader = _load_lleqa(args)
    data = loader.load()

    if train:
        from fusion_tpu_torch.data.datasets import Batches, collate_crossencoder
        from fusion_tpu_torch.train.trainer import init_train_state, make_crossencoder_train_step

        pairs = _train_samples(args, loader)
        steps = args.steps or max(len(pairs) // 4, 1)
        batch_size = _train_batch_size(args, pairs)
        cfg = _fit_config(args, preset, steps, batch_size, weight_decay=preset.weight_decay)
        state, tx, schedule = init_train_state(model, cfg)
        mesh, batch_size = _training_mesh(args, batch_size)
        step_fn = make_crossencoder_train_step(model, tx, mesh=mesh)
        if mesh is not None:
            state = step_fn.place_state(state)

        def sample_stream():
            while True:
                yield from pairs

        batches = Batches(
            sample_stream,
            lambda s: collate_crossencoder(model.tokenizer, [(q, d) for q, d, _ in s], [lab for _, _, lab in s],
                                           model.max_length),
            batch_size,
        )
        return _train_and_save(model, step_fn, state, batches, cfg, schedule, args, {"trained_steps": steps})

    from fusion_tpu_torch.eval.evaluators import RerankingEvaluator

    samples = []
    rng = np.random.default_rng(args.seed)
    all_ids = list(data.corpus.keys())
    for qid, text in data.queries[args.split].items():
        gold = data.qrels[args.split].get(qid, [])
        pos = [data.corpus[p] for p in gold if p in data.corpus]
        neg_ids = rng.choice(all_ids, size=min(10, len(all_ids)), replace=False)
        neg = [data.corpus[n] for n in neg_ids if n not in gold]
        if pos:
            samples.append({"query": text, "positive": pos, "negative": neg})
    ev = RerankingEvaluator(samples, batch_size=args.batch_size)
    ev(model, output_path=args.output_dir)
    print(json.dumps(ev.last_scores, default=float))


def cmd_hybrid(args):
    from fusion_tpu_torch.cli.presets import BM25_PRESETS
    from fusion_tpu_torch.fusion.aggregator import build_percentile_distribution, tune_fusion_weights
    from fusion_tpu_torch.hybrid import HybridPipeline
    from fusion_tpu_torch.models.biencoder import BiEncoder
    from fusion_tpu_torch.models.colbert import ColBERT
    from fusion_tpu_torch.models.crossencoder import CrossEncoder

    data = _load_lleqa(args).load()
    pipeline = HybridPipeline(data.corpus, device=args.device)
    qids, queries, labels = data.split(args.split)
    # the score-distribution analysis pools every doc's score per system,
    # so retrieval then runs to the corpus's depth
    topk = len(data.corpus) if args.analyze_score_distributions else min(1000, len(data.corpus))
    bp = BM25_PRESETS["lleqa"]
    cfg = _encoder_config(args)
    dev = args.device
    results = {}
    if args.run_bm25:
        results["bm25"] = pipeline.bm25_search(queries, k1=bp.k1, b=bp.b, return_topk=topk).ranked
    if args.run_dpr:
        model = _load_model(BiEncoder, args.dpr_path, args) if args.dpr_path else BiEncoder(
            cfg, head="dense", max_query_length=32, max_doc_length=128, device=dev
        )
        results["dpr"] = pipeline.single_vector_search(queries, model, return_topk=topk).ranked
    if args.run_splade:
        model = _load_model(BiEncoder, args.splade_path, args) if args.splade_path else BiEncoder(
            cfg, head="splade", max_query_length=32, max_doc_length=128, device=dev
        )
        results["splade"] = pipeline.single_vector_search(queries, model, return_topk=topk).ranked
    if args.run_colbert:
        model = _load_model(ColBERT, args.colbert_path, args) if args.colbert_path else ColBERT(
            cfg, dim=16 if args.tiny else 128, max_query_length=32, max_doc_length=64, device=dev
        )
        results["colbert"] = pipeline.multi_vector_search(queries, model, return_topk=topk).ranked
    if not results:
        raise SystemExit("enable at least one retrieval system (--run_bm25, --run_dpr, ...)")

    os.makedirs(args.output_dir, exist_ok=True)
    if args.analyze_score_distributions:
        out = pipeline.analyze_score_distributions(
            results, labels=labels, normalization=args.normalization, output_dir=args.output_dir, seed=args.seed
        )
        print(json.dumps({
            "systems": list(out["all_scores"].keys()),
            "distribution_sizes": sorted(out["distributions"].keys()),
            "labeled_rows": len(out["labeled"]),
        }))
        return

    distributions = None
    if args.normalization in ("percentile-rank", "normal-curve-equivalent"):
        distributions = {
            name: build_percentile_distribution(rl.scores.cpu().numpy(), num_points=10_000)
            for name, rl in results.items()
        }

    if args.tune_linear_fusion_weight:
        from fusion_tpu_torch.eval.metrics import Metrics
        from fusion_tpu_torch.utils.loggers import write_metrics_csv

        ev = Metrics(recall_at_k=[10, 100, 500])
        best, rows = tune_fusion_weights(
            results, labels,
            evaluate=lambda fused: ev.compute_all_metrics(labels, pipeline.to_external_ids(fused)),
            normalization=args.normalization or "min-max",
            percentile_distributions=distributions,
            step=args.weight_step,
            select_by="recall@100",
        )
        write_metrics_csv(os.path.join(args.output_dir, f"nsf_{args.normalization}_tuning.csv"), rows)
        print(json.dumps({"best_weights": best}))
        return

    fused = pipeline.fuse(
        results, method=args.fusion, normalization=args.normalization,
        percentile_distributions=distributions, return_topk=topk,
    )
    if args.run_monobert:
        ce = _load_crossencoder(args.monobert_path, args) if args.monobert_path else CrossEncoder(
            cfg, max_length=32 if args.tiny else 256, device=dev
        )
        fused = pipeline.cross_encoder_search(queries, fused, ce, return_topk=min(args.rerank_depth, topk)).ranked

    scores = pipeline.evaluate(fused, labels, print2console=True)
    with open(os.path.join(args.output_dir, "performance_hybrid.json"), "w") as f:
        json.dump(scores, f, indent=2, default=float)


def cmd_serve(args):
    """Build or serve a persistent HybridSearcher.

    build:  encode every requested index once and save it to --index_dir
    search: load --index_dir and answer queries (--queries_file, one per
            line, or the dataset split) into a ranking TSV, or serve them
            over HTTP with --http_port
    """
    from fusion_tpu_torch.data.preprocessor import TextPreprocessor
    from fusion_tpu_torch.models.biencoder import BiEncoder
    from fusion_tpu_torch.models.colbert import ColBERT
    from fusion_tpu_torch.models.crossencoder import CrossEncoder
    from fusion_tpu_torch.serving import HybridSearcher
    from fusion_tpu_torch.utils.rankingio import write_ranking_tsv

    cfg = _encoder_config(args)
    dev = args.device
    lengths = dict(max_query_length=32 if args.tiny else 64, max_doc_length=64 if args.tiny else 256)
    dense = (_load_model(BiEncoder, args.dpr_path, args) if args.dpr_path
             else BiEncoder(cfg, head="dense", device=dev, **lengths)) if args.run_dpr else None
    splade = (_load_model(BiEncoder, args.splade_path, args) if args.splade_path
              else BiEncoder(cfg, head="splade", device=dev, **lengths)) if args.run_splade else None
    colbert = (_load_model(ColBERT, args.colbert_path, args) if args.colbert_path
               else ColBERT(cfg, dim=16 if args.tiny else 128, device=dev, **lengths)) if args.run_colbert else None
    ce = (_load_crossencoder(args.monobert_path, args) if args.monobert_path
          else CrossEncoder(cfg, max_length=32 if args.tiny else 256, device=dev)) if args.run_monobert else None
    if ce is not None and args.ce_attention and hasattr(ce, "with_attention"):
        ce = ce.with_attention(args.ce_attention)
    if ce is not None and args.ce_int8:
        if not hasattr(ce, "quantized"):
            raise SystemExit("--ce_int8 requires a BERT-style cross-encoder checkpoint")
        ce = ce.quantized()
    rerank_buckets = tuple(args.rerank_buckets) if args.rerank_buckets else None
    rerank_cascade = tuple(args.rerank_cascade) if args.rerank_cascade else None
    # packed is the rerank stage unless another was asked for, or --no-rerank_packed
    rerank_packed = args.rerank_packed
    if rerank_packed is None:
        rerank_packed = rerank_buckets is None and rerank_cascade is None
    common = dict(
        dense_model=dense, splade_model=splade, colbert_model=colbert, cross_encoder=ce,
        rerank_depth=args.rerank_depth, fusion_method=args.fusion, plaid_nprobe=args.plaid_nprobe,
        plaid_ncand=args.plaid_ncand, plaid_ncand_rescore=args.plaid_ncand_rescore or None,
        plaid_rescore_impl=args.plaid_rescore_impl, dense_impl=args.dense_impl,
        splade_query_terms=args.splade_query_terms, rerank_packed=rerank_packed,
        rerank_row_width=args.rerank_row_width or None, rerank_buckets=rerank_buckets,
        rerank_cascade=rerank_cascade,
    )
    prep = TextPreprocessor(spacy_model=None) if args.run_bm25 else None

    os.makedirs(args.output_dir, exist_ok=True)
    if args.task == "build":
        from fusion_tpu_torch.cli.presets import BM25_PRESETS

        data = _load_lleqa(args).load()
        bp = BM25_PRESETS["lleqa"]
        docs = list(data.corpus.values())
        searcher = HybridSearcher.build(
            data.corpus,
            bm25_docs=prep.preprocess(docs) if prep else None,
            colbert_compressed=args.compressed or args.colbert_plaid,
            batch_size=args.batch_size, k1=bp.k1, b=bp.b, topk=min(1000, len(data.corpus)),
            bm25_preprocess=(lambda t: prep.preprocess(list(t))) if prep else None,
            int8_corpus=args.int8_corpus, scale_mode=args.scale_mode, colbert_plaid=args.colbert_plaid,
            impact_cap=args.impact_cap, splade_impl=args.splade_impl,
            splade_rescore_depth=None if args.splade_rescore_depth < 0 else args.splade_rescore_depth,
            ivf_cap=args.ivf_cap, encoders_int8=args.encoders_int8, device=dev, **common,
        )
        searcher.save_indexes(args.index_dir)
        print(json.dumps({
            "index_dir": args.index_dir, "systems": searcher.active_systems, "corpus_docs": len(data.corpus),
        }))
        return searcher

    searcher = HybridSearcher(
        corpus_ids=np.array([]), normalization=args.normalization,
        splade_rescore_depth=max(args.splade_rescore_depth, 0), device=dev, **common,
    ).load_indexes(args.index_dir, int8_corpus=args.int8_corpus)
    if args.encoders_int8:
        searcher.quantize_encoders()
    if args.encoders_attention:
        searcher.set_encoder_attention(args.encoders_attention)
    if prep is not None:
        searcher.bm25_preprocess = lambda t: prep.preprocess(list(t))
    if args.http_port:
        from fusion_tpu_torch.server import serve_forever

        serve_forever(searcher, host=args.http_host, port=args.http_port, max_batch=args.batch_size)
        return searcher
    if args.queries_file:
        with open(args.queries_file) as f:
            queries = [line.strip() for line in f if line.strip()]
        qids = list(range(len(queries)))
    else:
        qids, queries, _ = _load_lleqa(args).load().split(args.split)
    ranked, ms_per_query = searcher.search(queries, batch_size=args.batch_size)
    out_tsv = os.path.join(args.output_dir, "serve_ranking.tsv")
    write_ranking_tsv(out_tsv, ranked, qids)
    print(json.dumps({
        "num_queries": len(queries), "ms_per_query": round(ms_per_query, 3),
        "systems": searcher.active_systems, "ranking_tsv": out_tsv,
    }))
    return searcher


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fusion-tpu-torch", description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp):
        sp.add_argument("--dataset", default="lleqa")
        sp.add_argument("--split", default="dev", choices=["train", "dev", "test"])
        sp.add_argument("--fixture", default=None, help="offline dataset JSON")
        sp.add_argument("--output_dir", default="output")
        sp.add_argument("--seed", type=int, default=42)
        sp.add_argument("--tiny", action="store_true", help="tiny encoder for smoke tests")
        sp.add_argument("--device", default="cuda",
                        help="torch device of every model and index (default: the card; 'cpu' to run "
                             "without one)")
        sp.add_argument("--bf16", action="store_true", default=True)
        sp.add_argument("--no_bf16", dest="bf16", action="store_false", help="full-f32 run")
        sp.add_argument("--no_remat", action="store_true",
                        help="training: keep every layer's activations instead of recomputing them")
        sp.add_argument("--attention_impl", default="einsum", choices=["einsum", "einsum_bf16", "flash"],
                        help="einsum_bf16 = bf16-stored attention logits (~0.4%% softmax error); flash = "
                             "the masked-attention kernel (inference; with dropout it trains as einsum)")
        sp.add_argument("--batch_size", type=int, default=32)
        sp.add_argument("--train_batch_size", type=int, default=None)
        sp.add_argument("--model_path", default=None)
        sp.add_argument("--steps", type=int, default=None)
        sp.add_argument("--lr", type=float, default=None)
        sp.add_argument("--optimizer", default="AdamW", choices=["AdamW", "Adafactor", "Shampoo"])
        sp.add_argument("--negs_per_query", type=int, default=1)
        sp.add_argument("--log_every", type=int, default=10)
        sp.add_argument("--ckpt_save_steps", type=int, default=None)
        sp.add_argument("--seeds", default=None, help="comma list for multi-seed reruns")
        sp.add_argument("--freeze_layers_except_last_n", type=int, default=None)
        sp.add_argument("--no_data_parallel", dest="data_parallel", action="store_false", default=True)

    sp = sub.add_parser("bm25")
    common(sp)
    sp.add_argument("--task", default="evaluate", choices=["evaluate", "tune", "negatives"])
    sp.add_argument("--k1", type=float, default=None)
    sp.add_argument("--b", type=float, default=None)
    sp.add_argument("--do_preprocessing", action="store_true", default=False)
    sp.add_argument("--num_negatives", type=int, default=10)
    sp.set_defaults(fn=cmd_bm25)

    for name, tasks, fn in (("dpr", ["train", "test"], cmd_dpr), ("splade", ["train", "test"], cmd_splade),
                            ("colbert", ["train", "index", "search", "test"], cmd_colbert),
                            ("monobert", ["train", "test"], cmd_monobert)):
        sp = sub.add_parser(name)
        common(sp)
        sp.add_argument("--task", default="test", choices=tasks)
        if name == "splade":
            sp.add_argument("--splade_variant", default="spladev2", choices=[
                "spladev1", "spladev2", "spladeplus", "spladeplus_ensemble", "spladeeff", "spladev3",
            ])
        if name == "colbert":
            sp.add_argument("--colbert_loss", default="ce", choices=["ce", "kld"])
            sp.add_argument("--compressed", action="store_true")
            sp.add_argument("--nbits", type=int, default=2)
            sp.add_argument("--kmeans_niters", type=int, default=4)
        if name == "monobert":
            sp.add_argument("--neg_per_pos", type=int, default=4)
            sp.add_argument("--backbone", default="bert", choices=["bert", "t5"],
                            help="cross-encoder trunk; t5 builds a monoT5-style encoder-classifier")
        sp.set_defaults(fn=fn)

    sp = sub.add_parser("hybrid")
    common(sp)
    for flag in ("--run_bm25", "--run_dpr", "--run_splade", "--run_colbert", "--run_monobert"):
        sp.add_argument(flag, action="store_true")
    sp.add_argument("--fusion", default="rrf", choices=["bcf", "rrf", "nsf"])
    sp.add_argument("--normalization", default=None, choices=[
        None, "none", "min-max", "z-score", "arctan", "percentile-rank", "normal-curve-equivalent",
    ])
    sp.add_argument("--tune_linear_fusion_weight", action="store_true")
    sp.add_argument("--analyze_score_distributions", action="store_true")
    sp.add_argument("--weight_step", type=float, default=0.05)
    for flag in ("--dpr_path", "--splade_path", "--colbert_path", "--monobert_path"):
        sp.add_argument(flag, default=None)
    sp.add_argument("--rerank_depth", type=int, default=100,
                    help="candidates passed to the monoBERT reranker (paper setup: 100)")
    sp.set_defaults(fn=cmd_hybrid)

    sp = sub.add_parser("serve", help="build / query the persistent HybridSearcher")
    common(sp)
    sp.add_argument("--task", default="search", choices=["build", "search"])
    sp.add_argument("--index_dir", required=True)
    sp.add_argument("--queries_file", default=None)
    sp.add_argument("--http_port", type=int, default=0,
                    help="serve over HTTP with dynamic batching (fusion_tpu_torch/server.py)")
    sp.add_argument("--http_host", default="0.0.0.0")
    for flag in ("--run_bm25", "--run_dpr", "--run_splade", "--run_colbert", "--run_monobert"):
        sp.add_argument(flag, action="store_true")
    sp.add_argument("--fusion", default="rrf", choices=["bcf", "rrf", "nsf"])
    sp.add_argument("--normalization", default=None,
                    choices=["min-max", "z-score", "arctan", "percentile-rank", "normal-curve-equivalent"],
                    help="nsf score normalization; percentile / NCE read the quantile tables saved in the "
                         "index dir")
    for flag in ("--dpr_path", "--splade_path", "--colbert_path", "--monobert_path"):
        sp.add_argument(flag, default=None)
    sp.add_argument("--rerank_depth", type=int, default=100)
    sp.add_argument("--compressed", action="store_true")
    sp.add_argument("--int8_corpus", action="store_true")
    sp.add_argument("--scale_mode", action="store_true",
                    help="impact-ordered BM25/SPLADE indexes (mMARCO-scale forms)")
    sp.add_argument("--colbert_plaid", action="store_true", help="PLAID ColBERT (implies --compressed)")
    sp.add_argument("--plaid_nprobe", type=int, default=4)
    sp.add_argument("--plaid_ncand", type=int, default=1024)
    sp.add_argument("--ivf_cap", type=int, default=1024)
    sp.add_argument("--dense_impl", choices=["auto", "exact", "fused"], default="auto",
                    help="int8 dense leg: exact blockwise search or the binned kernel (auto: the kernel "
                         "on the card at >= 2^20 docs)")
    sp.add_argument("--impact_cap", type=int, default=4096)
    sp.add_argument("--splade_query_terms", type=int, default=64)
    sp.add_argument("--splade_impl", choices=["auto", "impact", "scatter"], default="auto")
    sp.add_argument("--splade_rescore_depth", type=int, default=-1,
                    help="-1 = auto (512 in scale mode), 0 = off")
    sp.add_argument("--plaid_ncand_rescore", type=int, default=0)
    sp.add_argument("--plaid_rescore_impl", choices=["gather", "factored"], default="gather")
    sp.add_argument("--plaid_gather_impl", choices=["xla", "pallas"], default="xla",
                    help="no effect in the port: the candidate-row gather is the Hopper kernel on the "
                         "card and the plain gather on the CPU")
    sp.add_argument("--rerank_buckets", type=int, nargs="*", default=None,
                    help="doc-width ladder of the length-bucketed rerank stage (e.g. 94 222)")
    sp.add_argument("--rerank_cascade", type=int, nargs=2, default=None, metavar=("KEEP", "STAGE1_TOKENS"),
                    help="two-stage flat rerank: all candidates with docs cut to STAGE1_TOKENS, the top KEEP "
                         "at full width; STAGE1_TOKENS=0 resolves to the corpus p90 token length")
    sp.add_argument("--rerank_packed", action=argparse.BooleanOptionalAction, default=None,
                    help="sequence-packed rerank (the default unless --rerank_buckets / --rerank_cascade); "
                         "--no-rerank_packed serves the flat stage")
    sp.add_argument("--rerank_row_width", type=int, default=None)
    sp.add_argument("--ce_attention", default="einsum_bf16", choices=["einsum", "einsum_bf16", "flash"],
                    help="the rerank stage's attention form (the JAX CLI's default, einsum_bf16)")
    sp.add_argument("--ce_int8", action="store_true",
                    help="serve the rerank stage with dynamic int8 trunk matmuls")
    sp.add_argument("--encoders_int8", action="store_true",
                    help="serve the query encoders with dynamic int8 trunk matmuls (the index keeps its "
                         "full-precision encoding)")
    sp.add_argument("--encoders_attention", default=None, choices=["einsum", "einsum_bf16", "flash"],
                    help="serve the query encoders with this attention form (default: each model's own)")
    sp.set_defaults(fn=cmd_serve)
    return p


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args, unknown = build_parser().parse_known_args(argv)
    if unknown:
        print(f"# WARNING: ignoring unknown arguments: {unknown}", file=sys.stderr)
    args.model_name = args.command
    if getattr(args, "task", None) == "train" and _start_training(args, argv):
        return None
    return args.fn(args)


if __name__ == "__main__":
    main()
