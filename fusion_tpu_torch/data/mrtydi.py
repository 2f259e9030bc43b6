"""Mr. TyDi (typologically diverse multilingual retrieval) data layer.

``MrTyDiLoader`` has ``MmarcoLoader``'s surface (``load``,
``biencoder_sampler``, ``crossencoder_pairs``, ``hard_negatives``) and its
raw fixture schema, so every CLI command runs on Mr. TyDi splits.  The
network source (the castorini/mr-tydi HF datasets) is not ported, so a
loader without a fixture raises.
"""

from __future__ import annotations

MRTYDI_LANGUAGES = {
    "ar": "arabic",
    "bn": "bengali",
    "en": "english",
    "fi": "finnish",
    "id": "indonesian",
    "ja": "japanese",
    "ko": "korean",
    "ru": "russian",
    "sw": "swahili",
    "te": "telugu",
    "th": "thai",
}


class MrTyDiLoader:
    """Same raw-fixture schema as ``MmarcoLoader``:
    {"corpus": {pid: text}, "train_queries": {...}, "train_qrels": {...},
     "dev_queries": {...}, "dev_qrels": {...}, "negatives": {qid: [pid]}}.
    """

    def __init__(self, lang: str = "en", raw: dict | None = None):
        assert lang in MRTYDI_LANGUAGES, (
            f"unsupported language {lang!r}; expected one of {sorted(MRTYDI_LANGUAGES)}"
        )
        self.lang = lang
        if raw is None:
            raise NotImplementedError(
                "loading Mr. TyDi from the HuggingFace hub (a network source) is not ported to "
                "fusion_tpu_torch: pass the records (MrTyDiLoader(raw=...), or the CLI's --fixture JSON file)"
            )
        self.raw = raw

    # identical record plumbing as mMARCO — reuse it
    def _delegate(self):
        from fusion_tpu_torch.data.mmarco import MmarcoLoader

        d = MmarcoLoader.__new__(MmarcoLoader)
        d.lang = "en"  # only used for cache naming in mmarco
        d.raw = self.raw
        return d

    def corpus(self):
        return self._delegate().corpus()

    def hard_negatives(self):
        return self._delegate().hard_negatives()

    def load(self):
        return self._delegate().load()

    def biencoder_sampler(self, negs_per_query: int = 1, seed: int = 42):
        return self._delegate().biencoder_sampler(negs_per_query, seed)

    def crossencoder_pairs(self, neg_per_pos: int = 4, seed: int = 42):
        return self._delegate().crossencoder_pairs(neg_per_pos, seed)

