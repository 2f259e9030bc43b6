"""Dataset containers, training samplers and batch collation.

``RetrievalData`` is what every loader's ``load()`` returns: the corpus and
the per-split queries and qrels.  The samplers (``TripletSampler``,
``crossencoder_pairs``) and the collation into train-step batches are
``fusion_tpu/data/datasets.py``'s, numpy and ``random`` only: the same
``random.Random(seed)`` draws give the same samples as the JAX package's.

Sample formats:
  1. triplet              [query, pos, neg]
  2. tuple                [query, pos, neg1, ..., negN]
  3. tuple_with_scores    [query, (pos, score), (neg1, score), ...]
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Callable, Iterable, Iterator, Mapping, Sequence

import numpy as np


@dataclass
class RetrievalData:
    """Corpus + per-split queries and qrels."""

    corpus: dict[int, str]
    queries: dict[str, dict[int, str]] = field(default_factory=dict)  # split -> qid -> text
    qrels: dict[str, dict[int, list[int]]] = field(default_factory=dict)  # split -> qid -> [pid]
    train_samples: list | None = None  # raw training samples

    def split(self, name: str) -> tuple[list[int], list[str], list[list[int]]]:
        """(qids, query texts, gold pid lists) of one split, in qid order of
        insertion."""
        qids = list(self.queries.get(name, {}).keys())
        texts = [self.queries[name][q] for q in qids]
        labels = [self.qrels.get(name, {}).get(q, []) for q in qids]
        return qids, texts, labels


class TripletSampler:
    """Rotating (query, pos, neg...) sampler over qrels + negative pools.

    Reproduces the reference's rotation: each time a query is drawn, its
    next hard negative is taken from the front of its pool and re-appended
    (lleqa.py:71-73). Pairs are the exploded (qid, pos) relation, shuffled
    with a fixed seed (lleqa.py:90-100).
    """

    def __init__(
        self,
        corpus: Mapping[int, str],
        queries: Mapping[int, str],
        qrels: Mapping[int, Sequence[int]],
        hard_negatives: Mapping[int, Sequence[int]] | None = None,
        negs_per_query: int = 1,
        seed: int = 42,
    ):
        self.corpus = corpus
        self.queries = queries
        self.negs_per_query = negs_per_query
        self.pairs = [(qid, pid) for qid, pids in qrels.items() for pid in pids]
        rng = random.Random(seed)
        rng.shuffle(self.pairs)
        self.rng = rng
        self.negatives = {
            qid: list(negs) for qid, negs in (hard_negatives or {}).items()
        }
        self.all_ids = list(corpus.keys())
        self.qrels = {qid: set(pids) for qid, pids in qrels.items()}

    def __len__(self) -> int:
        return len(self.pairs)

    def _next_negatives(self, qid: int) -> list[int]:
        pool = self.negatives.get(qid)
        out = []
        if pool:
            for _ in range(min(self.negs_per_query, len(pool))):
                nid = pool.pop(0)
                pool.append(nid)
                out.append(nid)
        if len(out) < self.negs_per_query:
            # random non-positive fallback; precomputing the pool keeps this
            # bounded even when a query's positives cover the whole corpus
            non_pos = [i for i in self.all_ids if i not in self.qrels.get(qid, ())]
            if not non_pos:
                raise ValueError(
                    f"query {qid}: every corpus doc is a positive — cannot "
                    "sample negatives"
                )
            while len(out) < self.negs_per_query:
                out.append(self.rng.choice(non_pos))
        return out

    def samples(self) -> Iterator[list]:
        for qid, pid in self.pairs:
            negs = self._next_negatives(qid)
            yield [self.queries[qid], self.corpus[pid], *[self.corpus[n] for n in negs]]

    def epochs(self, n: int | None = None) -> Iterator[list]:
        e = 0
        while n is None or e < n:
            yield from self.samples()
            e += 1


def collate_biencoder(text_encoder, samples: Sequence[Sequence], negs_per_query: int = 1) -> dict:
    """Tokenize a batch of training samples into the train-step dict.

    Accepts all three sample formats; (text, score) pairs produce teacher
    scores for distillation losses (base.py:106-140 semantics: one positive
    plus ``negs_per_query`` negatives per sample).
    """
    queries, positives, negatives = [], [], []
    pos_scores, neg_scores = [], []
    for sample in samples:
        query, *passages = sample
        passages = passages[: 1 + negs_per_query]
        if passages and isinstance(passages[0], (tuple, list)):
            texts = [p[0] for p in passages]
            scores = [float(p[1]) for p in passages]
            pos_scores.append(scores[0])
            neg_scores.extend(scores[1:])
        else:
            texts = list(passages)
        queries.append(query)
        positives.append(texts[0])
        negatives.extend(texts[1:])

    q_ids, q_mask = text_encoder.encode(queries, query_mode=True)
    p_ids, p_mask = text_encoder.encode(positives, query_mode=False)
    n_ids, n_mask = text_encoder.encode(negatives, query_mode=False)
    batch = {
        "query_ids": q_ids, "query_mask": q_mask,
        "pos_ids": p_ids, "pos_mask": p_mask,
        "neg_ids": n_ids, "neg_mask": n_mask,
    }
    if pos_scores:
        batch["teacher_pos"] = np.asarray(pos_scores, dtype=np.float32)
        batch["teacher_neg"] = np.asarray(neg_scores, dtype=np.float32)
    return batch


def collate_crossencoder(tokenizer, pairs: Sequence[tuple[str, str]], labels: Sequence[float], max_length: int = 256) -> dict:
    """(query, doc, label) batch for pointwise BCE training."""
    from fusion_tpu_torch.data.tokenization import pair_encode_simple

    queries = [q for q, _ in pairs]
    docs = [d for _, d in pairs]
    if hasattr(tokenizer, "pair"):
        ids, mask = tokenizer.pair(queries, docs, max_length)
    else:
        ids, mask = pair_encode_simple(tokenizer, queries, docs, max_length)
    return {
        "pair_ids": ids,
        "pair_mask": mask,
        "labels": np.asarray(labels, dtype=np.float32),
    }


def batch_iterator(sample_iter, collate_fn, batch_size: int, drop_last: bool = True):
    """Group a sample stream into collated fixed-size batches.

    ``drop_last=True`` mirrors the reference skipping short final batches
    (splade.py:224-225: "avoid the last batch having too much importance").
    """
    buf = []
    for sample in sample_iter:
        buf.append(sample)
        if len(buf) == batch_size:
            yield collate_fn(buf)
            buf = []
    if buf and not drop_last:
        yield collate_fn(buf)


class Batches:
    """``batch_iterator`` as a re-iterable: each ``iter()`` starts a fresh
    pass over ``make_samples()``.  The trainer re-iterates such an input when
    it runs dry and caches none of it, so training over an endless sample
    stream (``TripletSampler.epochs``) holds no batches on the host."""

    def __init__(self, make_samples: Callable[[], Iterable], collate_fn, batch_size: int):
        self.make_samples, self.collate_fn, self.batch_size = make_samples, collate_fn, batch_size

    def __iter__(self):
        return batch_iterator(self.make_samples(), self.collate_fn, self.batch_size)


def crossencoder_pairs(
    corpus: Mapping[int, str],
    queries: Mapping[int, str],
    qrels: Mapping[int, Sequence[int]],
    negatives: Mapping[int, Sequence[int]] | None = None,
    neg_per_pos: int = 4,
    seed: int = 42,
) -> list[tuple[str, str, float]]:
    """Binary (query, passage, label) pairs with a pos:neg ratio
    (reference LLeQACrossencoderLoader / MmarcoCrossencoderLoader shape)."""
    rng = random.Random(seed)
    all_ids = list(corpus.keys())
    out = []
    for qid, pids in qrels.items():
        q = queries[qid]
        pos_set = set(pids)
        pool = list(negatives.get(qid, [])) if negatives else []
        non_pos = None
        for pid in pids:
            out.append((q, corpus[pid], 1.0))
            for _ in range(neg_per_pos):
                if pool:
                    nid = pool.pop(0)
                    pool.append(nid)
                else:
                    if non_pos is None:  # bounded fallback (see _next_negatives)
                        non_pos = [i for i in all_ids if i not in pos_set]
                    if not non_pos:
                        continue
                    nid = rng.choice(non_pos)
                out.append((q, corpus[nid], 0.0))
    rng.shuffle(out)
    return out
