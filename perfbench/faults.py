"""Faults planted in the timed path, to show that the check catches them.

Each is a context manager that patches one method of the program's
searcher class so that an answer is altered where it is produced: the
first and the last entries of every row trade places (ids move, scores
stay), in one leg's list, in the fused list, or in the reranked head.
Used by ``perfbench.control --faults`` on the card and by the CPU tests.
"""

from __future__ import annotations

from contextlib import contextmanager


def _swapped(ranked, last: int | None = None):
    from fusion_tpu_torch.core.ranked import RankedLists

    ids = ranked.ids.clone()
    j = ids.shape[1] - 1 if last is None else last - 1
    ids[:, 0], ids[:, j] = ranked.ids[:, j], ranked.ids[:, 0]
    return RankedLists(ids, ranked.scores)


@contextmanager
def planted(name: str):
    from fusion_tpu_torch.serving import HybridSearcher

    method = {"colbert_answer": "_colbert_leg", "fused_answer": "_fuse", "head_answer": "_rerank"}[name]
    orig = getattr(HybridSearcher, method)

    def broken(self, *a, **kw):
        out = orig(self, *a, **kw)
        return _swapped(out, self.rerank_depth if name == "head_answer" else None)

    setattr(HybridSearcher, method, broken)
    try:
        yield
    finally:
        setattr(HybridSearcher, method, orig)
