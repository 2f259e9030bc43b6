"""Dataset containers.

``RetrievalData`` is what every loader's ``load()`` returns: the corpus and
the per-split queries and qrels.  (The training samplers and collation wait
for the training slice of the port.)
"""

from __future__ import annotations

from dataclasses import dataclass, field


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
