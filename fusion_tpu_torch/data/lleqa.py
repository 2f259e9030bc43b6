"""LLeQA (Long-form Legal Question Answering, French) records →
``RetrievalData``.

The loader takes raw records (``from_records``): the corpus as
``{"id", "article", "description"}`` rows, the questions per split as
``{"id", "question", "article_ids"}`` rows, and optional hard negatives
per question id.  The CLI reads them from a ``--fixture`` JSON file
``{"corpus": [...], "questions": {...}, "negatives": {...}}``.  Fetching the
dataset from the HuggingFace hub is not ported (the card's machine has no
network and no ``datasets``): ``LLeQALoader()`` without records raises.
``biencoder_sampler`` and ``crossencoder_pairs`` feed training,
``export_colbert_files`` writes colbert-ai's file interface.
"""

from __future__ import annotations

import json
import os
from typing import Mapping, Sequence

from fusion_tpu_torch.data.datasets import RetrievalData, TripletSampler, crossencoder_pairs

SPLITS = ("train", "dev", "test")


class LLeQALoader:
    """Shape LLeQA records for retrieval."""

    def __init__(self, raw: dict | None = None, add_doc_title: bool = False, negatives_system: str = "bm25"):
        if raw is None:
            raise NotImplementedError(
                "loading LLeQA from the HuggingFace hub is not ported to fusion_tpu_torch: pass the "
                "records (LLeQALoader.from_records, or the CLI's --fixture JSON file)"
            )
        self.raw = raw
        self.add_doc_title = add_doc_title
        self.negatives_system = negatives_system

    @classmethod
    def from_records(
        cls,
        corpus: Sequence[dict],
        questions: Mapping[str, Sequence[dict]],
        negatives: Mapping[int, Mapping[str, Sequence[int]]] | None = None,
        **kw,
    ) -> "LLeQALoader":
        return cls(raw={"corpus": list(corpus), "questions": dict(questions), "negatives": negatives}, **kw)

    def corpus(self) -> dict[int, str]:
        """pid → article text (``description | article`` with
        ``add_doc_title``)."""
        out = {}
        for r in self.raw["corpus"]:
            text = r["article"] or ""
            if self.add_doc_title and r.get("description"):
                text = f"{r['description']} | {text}"
            out[int(r["id"])] = text
        return out

    def hard_negatives(self) -> dict[int, list[int]]:
        """qid → the negatives of ``negatives_system``."""
        negs = self.raw.get("negatives") or {}
        return {int(qid): list(v.get(self.negatives_system, [])) for qid, v in negs.items()}

    def load(self, synthetic: bool = False) -> RetrievalData:
        """The corpus with each split's queries and qrels.  Synthetic
        questions are dropped unless ``synthetic``; a dev or test question
        whose text is also a train question's removes every such train
        question from the train split."""
        queries: dict[str, dict[int, str]] = {}
        qrels: dict[str, dict[int, list[int]]] = {}
        seen_train = set()
        for split in SPLITS:
            queries[split], qrels[split] = {}, {}
            for r in self.raw["questions"].get(split, []):
                if not synthetic and r.get("synthetic"):
                    continue
                qid, text = int(r["id"]), str(r["question"])
                if split == "train":
                    seen_train.add(text)
                elif text in seen_train:
                    for dup in [q for q, t in queries["train"].items() if t == text]:
                        qrels["train"].pop(dup, None)
                        queries["train"].pop(dup, None)
                queries[split][qid] = text
                qrels[split][qid] = [int(p) for p in r["article_ids"]]
        return RetrievalData(corpus=self.corpus(), queries=queries, qrels=qrels)

    def biencoder_sampler(self, negs_per_query: int = 1, seed: int = 42) -> TripletSampler:
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
        data = self.load()
        return crossencoder_pairs(
            corpus=data.corpus,
            queries=data.queries["train"],
            qrels=data.qrels["train"],
            negatives=self.hard_negatives(),
            neg_per_pos=neg_per_pos,
            seed=seed,
        )

    def export_colbert_files(self, out_dir: str) -> dict[str, str]:
        """ColBERT's file interface: collection.tsv / queries per split /
        training triples, with contiguous 0-based ids (lleqa.py:241-345)."""
        os.makedirs(out_dir, exist_ok=True)
        data = self.load()
        pid_map = {pid: i for i, pid in enumerate(data.corpus.keys())}
        paths = {"collection": os.path.join(out_dir, "collection.tsv")}
        with open(paths["collection"], "w") as f:
            for pid, text in data.corpus.items():
                f.write(f"{pid_map[pid]}\t{text.replace(chr(9), ' ').replace(chr(10), ' ')}\n")
        negs = self.hard_negatives()
        for split in SPLITS:
            qpath = os.path.join(out_dir, f"queries.{split}.tsv")
            paths[f"queries.{split}"] = qpath
            qid_map = {qid: i for i, qid in enumerate(data.queries[split].keys())}
            with open(qpath, "w") as f:
                for qid, text in data.queries[split].items():
                    f.write(f"{qid_map[qid]}\t{text.replace(chr(9), ' ')}\n")
            if split == "train":
                tpath = os.path.join(out_dir, "triples.train.jsonl")
                paths["triples.train"] = tpath
                with open(tpath, "w") as f:
                    for qid, pids in data.qrels["train"].items():
                        pool = negs.get(qid, [])
                        for j, pid in enumerate(pids):
                            if pid not in pid_map:
                                continue
                            neg = pool[j % len(pool)] if pool else None
                            if neg is None or neg not in pid_map:
                                continue
                            f.write(json.dumps([qid_map[qid], pid_map[pid], pid_map[neg]]) + "\n")
        paths["qrels"] = os.path.join(out_dir, "qrels.json")
        with open(paths["qrels"], "w") as f:
            json.dump({s: {str(k): v for k, v in data.qrels[s].items()} for s in SPLITS}, f)
        return paths
