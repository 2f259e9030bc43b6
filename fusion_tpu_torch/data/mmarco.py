"""mMARCO (multilingual MS MARCO) data layer, from local record files.

14 languages; three training-sample formats (triplet / tuple /
tuple_with_scores); original BM25 triples or hard negatives mined by 13
systems under a cross-encoder score-margin filter; JSONL sample caches under
the reference's file names.  ``MmarcoReader`` consumes iterables of plain
dicts (or the reference's dump files through the streaming readers), so the
sampling runs offline on any corpus dump; its draws are Python ``random``'s,
equal to the JAX package's for the same records and seed.  ``MmarcoLoader``
serves the CLI from a raw fixture; the network source (ir_datasets) is not
ported, so a loader without one raises.
"""

from __future__ import annotations

import gzip
import json
import os
import random
from typing import Iterable, Mapping, Sequence

from fusion_tpu_torch.data.datasets import RetrievalData

MMARCO_LANGUAGES: dict[str, tuple[str, str]] = {
    "ar": ("arabic", "ar_AR"),
    "de": ("german", "de_DE"),
    "en": ("english", "en_XX"),
    "es": ("spanish", "es_XX"),
    "fr": ("french", "fr_XX"),
    "hi": ("hindi", "hi_IN"),
    "id": ("indonesian", "id_ID"),
    "it": ("italian", "it_IT"),
    "ja": ("japanese", "ja_XX"),
    "nl": ("dutch", "nl_XX"),
    "pt": ("portuguese", "pt_XX"),
    "ru": ("russian", "ru_RU"),
    "vi": ("vietnamese", "vi_VN"),
    "zh": ("chinese", "zh_CN"),
}

# mining systems of sentence-transformers/msmarco-hard-negatives
# (splade/mmarco.py:62-77)
NEGATIVE_MINING_SYSTEMS = (
    "bm25",
    "msmarco-distilbert-base-tas-b",
    "msmarco-distilbert-base-v3",
    "msmarco-MiniLM-L-6-v3",
    "distilbert-margin_mse-cls-dot-v2",
    "distilbert-margin_mse-cls-dot-v1",
    "distilbert-margin_mse-mean-dot-v1",
    "mpnet-margin_mse-mean-v1",
    "co-condenser-margin_mse-cls-v1",
    "distilbert-margin_mse-mnrl-mean-v1",
    "distilbert-margin_mse-sym_mnrl-mean-v1",
    "distilbert-margin_mse-sym_mnrl-mean-v2",
    "co-condenser-margin_mse-sym_mnrl-mean-v1",
)

SAMPLE_FORMATS = ("triplet", "tuple", "tuple_with_scores")


def training_cache_filename(
    lang: str,
    sample_format: str,
    negs_type: str,
    negs_per_query: int,
    negs_mining_systems: Sequence[str] | str = "all",
    max_examples: int = 0,
) -> str:
    """Deterministic cache name (splade/mmarco.py:246-261 convention)."""
    systems = (
        "all"
        if negs_mining_systems == "all" or len(negs_mining_systems) == len(NEGATIVE_MINING_SYSTEMS)
        else f"{len(negs_mining_systems)}systems"
    )
    return (
        f"mmarco-{lang}.train.{sample_format}.{negs_type}-negs.{negs_per_query}perq."
        f"{systems}.{max_examples}.jsonl"
    )


def read_hard_negative_records(path: str) -> Iterable[Mapping]:
    """Stream the msmarco-hard-negatives dump (the reference's source file
    ``msmarco-hard-negatives.jsonl.gz`` from the sentence-transformers HF
    dataset, splade/mmarco.py:169-196): one JSON object per line shaped
    ``{"qid": int, "pos": [pid, ...], "neg": {system: [pid, ...], ...}}``.
    Accepts plain ``.jsonl`` or ``.jsonl.gz``; yields dicts lazily so the
    ~12 GB dump never sits in memory."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def read_ce_scores(path: str) -> dict[int, dict[int, float]]:
    """Load the cross-encoder score dump (the reference's
    ``cross-encoder-ms-marco-MiniLM-L-6-v2-scores.pkl.gz``,
    splade/mmarco.py:158-167): a pickled ``{qid: {pid: score}}`` dict,
    optionally gzip-compressed. Keys are coerced to int."""
    import pickle

    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = pickle.load(f)
    return {int(q): {int(p): float(s) for p, s in d.items()} for q, d in raw.items()}


def read_triples(path: str) -> Iterable[Sequence[int]]:
    """Stream original BM25 triples (``qidpidtriples.train.full.2.tsv.gz``,
    the reference's negs_type='original' source, splade/mmarco.py:136-156):
    tab-separated ``qid\\tpos_pid\\tneg_pid`` rows, optionally gzipped."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) >= 3:
                yield (int(parts[0]), int(parts[1]), int(parts[2]))


class MmarcoReader:
    """Sample mMARCO training data in any of the three formats.

    ``hard_negative_records`` iterates dicts shaped like the
    msmarco-hard-negatives dump (splade/mmarco.py:191-196):
      {"qid": int, "pos": [pid, ...], "neg": {system: [pid, ...], ...}}
    ``ce_scores`` maps qid -> {pid: cross-encoder score}.
    """

    def __init__(
        self,
        lang: str,
        corpus: Mapping[int, str],
        train_queries: Mapping[int, str],
        max_train_examples: int = 502_939,
        training_sample_format: str = "triplet",
        negs_type: str = "original",
        negs_mining_systems: str | Sequence[str] = "all",
        negs_per_query: int = 1,
        ce_score_margin: float = 3.0,
        cache_dir: str | None = None,
    ):
        assert lang in MMARCO_LANGUAGES, f"unsupported language {lang!r}"
        assert training_sample_format in SAMPLE_FORMATS
        assert negs_type in ("original", "hard")
        if negs_mining_systems != "all":
            systems = (
                negs_mining_systems.split(",")
                if isinstance(negs_mining_systems, str)
                else list(negs_mining_systems)
            )
            unknown = [s for s in systems if s not in NEGATIVE_MINING_SYSTEMS]
            assert not unknown, f"unsupported mining systems: {unknown}"
            self.negs_mining_systems = systems
        else:
            self.negs_mining_systems = list(NEGATIVE_MINING_SYSTEMS)
        if training_sample_format == "tuple_with_scores":
            assert negs_type == "hard", "scored tuples need hard-negative CE scores"
        self.lang = lang
        self.corpus = corpus
        self.train_queries = train_queries
        self.max_train_examples = max_train_examples
        self.training_sample_format = training_sample_format
        self.negs_type = negs_type
        self.negs_per_query = negs_per_query
        self.ce_score_margin = ce_score_margin
        self.cache_dir = cache_dir

    # ------------------------------------------------------------------
    def sample_from_hard_negatives(
        self,
        hard_negative_records: Iterable[Mapping],
        ce_scores: Mapping[int, Mapping[int, float]],
    ) -> list:
        """Reference sampling recipe (splade/mmarco.py:186-235):

        per record, the CE threshold is (min positive CE score − margin);
        negatives pooled over the selected mining systems are kept only
        below the threshold; exactly ``negs_per_query`` must survive.  The
        reference re-passes over the dump (``fIn.seek(0)``) until
        ``max_train_examples`` are collected, re-seeding ONE rng with the
        current example count at each pass start (``random.seed(num)``) —
        a single filtered pass would silently undersample.
        """
        # multi-pass needs re-iteration; materialize one-shot iterators
        # (the file readers stream — the reference re-seeks the file)
        if iter(hard_negative_records) is hard_negative_records:
            hard_negative_records = list(hard_negative_records)
        samples: list = []
        num = 0
        while num < self.max_train_examples:
            pass_start = num
            rng = random.Random(num)  # per-pass seed (splade/mmarco.py:190)
            for data in hard_negative_records:
                qid, pos_pids = int(data["qid"]), list(data["pos"])
                if not pos_pids or qid not in self.train_queries:
                    continue
                scores = ce_scores.get(qid, {})
                try:
                    threshold = min(scores[p] for p in pos_pids) - self.ce_score_margin
                except KeyError:
                    continue
                pos_pid = rng.choice(pos_pids)
                pool: list[int] = []
                for system in self.negs_mining_systems:
                    pool.extend(data.get("neg", {}).get(system, []))
                filtered = [
                    p for p in dict.fromkeys(pool) if scores.get(p, 1e9) <= threshold
                ]
                neg_pids = rng.sample(filtered, min(self.negs_per_query, len(filtered)))
                if len(neg_pids) != self.negs_per_query:
                    continue
                query = self.train_queries[qid]
                pos = self.corpus[pos_pid]
                negs = [self.corpus[p] for p in neg_pids]
                if self.training_sample_format == "triplet":
                    samples.append([query, pos, negs[0]])
                elif self.training_sample_format == "tuple":
                    samples.append([query, pos, *negs])
                else:
                    samples.append(
                        [query, (pos, scores[pos_pid])]
                        + [(n, scores[p]) for n, p in zip(negs, neg_pids)]
                    )
                num += 1
                if num >= self.max_train_examples:
                    break
            if num == pass_start:  # nothing qualifies — avoid spinning
                break
        return samples

    def sample_from_triples(self, triples: Iterable[Sequence[int]]) -> list:
        """Original BM25 triples (qid, pos_pid, neg_pid) → samples."""
        samples = []
        for row in triples:
            if len(samples) >= self.max_train_examples:
                break
            qid, pos_pid, neg_pid = (int(x) for x in row[:3])
            if qid not in self.train_queries:
                continue
            try:
                samples.append(
                    [self.train_queries[qid], self.corpus[pos_pid], self.corpus[neg_pid]]
                )
            except KeyError:
                continue
        return samples

    # ------------------------------------------------------------------
    def cache_path(self) -> str | None:
        if self.cache_dir is None:
            return None
        return os.path.join(
            self.cache_dir,
            training_cache_filename(
                self.lang,
                self.training_sample_format,
                self.negs_type,
                self.negs_per_query,
                self.negs_mining_systems,
                self.max_train_examples,
            ),
        )

    def write_cache(self, samples: list) -> str | None:
        path = self.cache_path()
        if path is None:
            return None
        os.makedirs(self.cache_dir, exist_ok=True)
        with open(path, "w") as f:
            for s in samples:
                f.write(json.dumps(s) + "\n")
        return path

    def read_cache(self) -> list | None:
        path = self.cache_path()
        if path is None or not os.path.exists(path):
            return None
        out = []
        with open(path) as f:
            for line in f:
                row = json.loads(line)
                if self.training_sample_format == "tuple_with_scores":
                    row = [row[0]] + [tuple(x) for x in row[1:]]
                out.append(row)
        return out

    def load(
        self,
        hard_negative_records: Iterable[Mapping] | None = None,
        ce_scores: Mapping[int, Mapping[int, float]] | None = None,
        triples: Iterable[Sequence[int]] | None = None,
        dev_queries: Mapping[int, str] | None = None,
        dev_qrels: Mapping[int, list[int]] | None = None,
        hard_negatives_path: str | None = None,
        ce_scores_path: str | None = None,
        triples_path: str | None = None,
    ) -> RetrievalData:
        """Build the training set. Record sources are either injected
        iterables/mappings or FILE PATHS to the reference's actual dumps
        (msmarco-hard-negatives.jsonl[.gz], CE-scores .pkl[.gz],
        qidpidtriples .tsv[.gz]) — e.g. a local HF-hub cache; the streaming
        readers above parse them."""
        if hard_negative_records is None and hard_negatives_path is not None:
            hard_negative_records = read_hard_negative_records(hard_negatives_path)
        if ce_scores is None and ce_scores_path is not None:
            ce_scores = read_ce_scores(ce_scores_path)
        if triples is None and triples_path is not None:
            triples = read_triples(triples_path)
        cached = self.read_cache()
        if cached is not None:
            train = cached
        elif self.negs_type == "hard":
            assert hard_negative_records is not None and ce_scores is not None, (
                "hard-negative sampling needs records + CE scores (pass "
                "iterables or hard_negatives_path/ce_scores_path file dumps)"
            )
            train = self.sample_from_hard_negatives(hard_negative_records, ce_scores)
            self.write_cache(train)
        else:
            assert triples is not None, (
                "original-negative sampling needs triples (pass an iterable "
                "or triples_path)"
            )
            train = self.sample_from_triples(triples)
            self.write_cache(train)
        return RetrievalData(
            corpus=dict(self.corpus),
            queries={"dev": dict(dev_queries or {})},
            qrels={"dev": {k: list(v) for k, v in (dev_qrels or {}).items()}},
            train_samples=train,
        )


class MmarcoLoader:
    """CLI-facing mMARCO loader with the same surface as ``LLeQALoader``.

    ``raw`` fixture schema (all ids ints; JSON string keys are coerced):
      {"corpus": {pid: text}, "train_queries": {qid: text},
       "train_qrels": {qid: [pid]}, "dev_queries": {...}, "dev_qrels": {...},
       "negatives": {qid: [pid, ...]}  (optional hard-negative pools)}
    Without a fixture it raises: the network source (ir_datasets) is not
    ported.
    """

    def __init__(self, lang: str = "fr", raw: dict | None = None):
        assert lang in MMARCO_LANGUAGES
        self.lang = lang
        if raw is None:
            raise NotImplementedError(
                "loading mMARCO from ir_datasets (a network source) is not ported to fusion_tpu_torch: "
                "pass the records (MmarcoLoader(raw=...), or the CLI's --fixture JSON file)"
            )
        self.raw = raw

    @staticmethod
    def _int_keys(d):
        return {int(k): v for k, v in (d or {}).items()}

    def corpus(self) -> dict[int, str]:
        return self._int_keys(self.raw["corpus"])

    def hard_negatives(self) -> dict[int, list[int]]:
        return {
            qid: [int(p) for p in pids]
            for qid, pids in self._int_keys(self.raw.get("negatives")).items()
        }

    def load(self) -> RetrievalData:
        queries = {
            "train": self._int_keys(self.raw.get("train_queries")),
            "dev": self._int_keys(self.raw.get("dev_queries")),
            "test": {},
        }
        qrels = {
            "train": {
                int(q): [int(p) for p in pids]
                for q, pids in self._int_keys(self.raw.get("train_qrels")).items()
            },
            "dev": {
                int(q): [int(p) for p in pids]
                for q, pids in self._int_keys(self.raw.get("dev_qrels")).items()
            },
            "test": {},
        }
        return RetrievalData(corpus=self.corpus(), queries=queries, qrels=qrels)

    def biencoder_sampler(self, negs_per_query: int = 1, seed: int = 42):
        from fusion_tpu_torch.data.datasets import TripletSampler

        data = self.load()
        return TripletSampler(
            corpus=data.corpus,
            queries=data.queries["train"],
            qrels=data.qrels["train"],
            hard_negatives=self.hard_negatives(),
            negs_per_query=negs_per_query,
            seed=seed,
        )

    def crossencoder_pairs(self, neg_per_pos: int = 4, seed: int = 42):
        from fusion_tpu_torch.data.datasets import crossencoder_pairs

        data = self.load()
        return crossencoder_pairs(
            corpus=data.corpus,
            queries=data.queries["train"],
            qrels=data.qrels["train"],
            negatives=self.hard_negatives(),
            neg_per_pos=neg_per_pos,
            seed=seed,
        )

