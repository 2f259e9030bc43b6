"""Host-side text preprocessing for lexical (BM25) retrieval, the same
pipeline as ``fusion_tpu/data/preprocessor.py``: spaCy's
``fr_core_news_md`` (lowercase, strip punctuation, numbers and stopwords,
lemmatize) when it is installed, otherwise


  * a self-contained French pipeline: regex word
    tokenization, a French stopword list, digit filtering, and the NLTK
    French Snowball stemmer when nltk is importable (a stemmer conflates
    inflection families the way BM25 needs even though its output is not
    a human-readable lemma), else a light suffix-stripping lemmatizer.
    Plain Snowball systematically fails to conflate -ent/-ons verb forms,
    -aux/-eaux plurals, and is not idempotent (loyers→loyer→loi), so the
    fallback wraps it in ``_conflate``: plural normalization + verb-ending
    strip + stem, iterated to a fixpoint.  Measured on planted French
    morphology (scripts/preprocessor_study.py / PREPROC_STUDY_r03.json)
    this lifts form-conflation accuracy from 0.84 (raw Snowball) to 1.00
    on the inventory, with no new cross-family merges.

The choice among spaCy, nltk's stemmer and the light lemma is made as in the
JAX package, so both give the same tokens on one machine.  Output: one
whitespace-joined token string per input text, consumed by
``BM25Index.build``.
"""

from __future__ import annotations

import functools
import re
from typing import Iterable, Sequence

# Core French stopwords (subset of spaCy's fr stop list — function words only,
# no content words, so recall differences vs spaCy stay small).
FRENCH_STOPWORDS = frozenset(
    """
a à â afin ai aie aient aies ait alors as au aucun aucune aujourd aujourd'hui
auquel aura aurai auraient aurais aurait auras aurez auriez aurions aurons
auront aussi autre autres aux auxquelles auxquels avaient avais avait avant
avec avez aviez avions avoir avons ayant ayez ayons c ç ça car ce ceci cela
celle celles celui cependant ces cet cette ceux chaque chez ci comme comment
d dans de dedans dehors depuis des desquelles desquels dessous dessus deux
devant doit donc dont du duquel e elle elles en encore entre envers es est
et étaient étais était étant été êtes étiez étions être eu eue eues eurent
eus eut eux fait faites fois font fut hors il ils j je jusqu jusque l la
laquelle le lequel les lesquelles lesquels leur leurs lors lorsque lui m ma
mais me même mêmes mes moi moins mon n ne ni nos notre nous on ont or ou où
par parce parmi pas pendant peu peut plupart pour pourquoi qu quand que quel
quelle quelles quels qui quoi s sa sans se sera serai seraient serais serait
seras serez seriez serions serons seront ses si sien son sont sous soyez
soyons suis sur t ta te tel telle telles tels tes toi ton toujours tous tout
toute toutes très tu un une vers via vos votre vous y
""".split()
)

_WORD_RE = re.compile(r"[a-zàâäéèêëîïôöùûüÿçœæ]+(?:'[a-zàâäéèêëîïôöùûüÿçœæ]+)?", re.IGNORECASE)
_HAS_DIGIT_RE = re.compile(r".*\d+")

# Light French suffix lemmatization, longest-match first. Intentionally
# conservative: only high-frequency inflection suffixes.
_SUFFIX_RULES = (
    ("issements", "issement"),
    ("issement", "issement"),
    ("atrices", "ateur"),
    ("atrice", "ateur"),
    ("ateurs", "ateur"),
    ("ements", "ement"),
    ("issent", "ir"),
    ("ements", "ement"),
    ("ations", "ation"),
    ("ation", "ation"),
    ("euses", "eux"),
    ("euse", "eux"),
    ("ives", "if"),
    ("ive", "if"),
    ("aux", "al"),
    ("ales", "al"),
    ("ale", "al"),
    ("ées", "é"),
    ("ée", "é"),
    ("és", "é"),
    ("ments", "ment"),
    ("s", ""),
)


def _light_lemma(token: str) -> str:
    if len(token) <= 3:
        return token
    for suffix, repl in _SUFFIX_RULES:
        if token.endswith(suffix) and len(token) - len(suffix) + len(repl) >= 3:
            return token[: -len(suffix)] + repl
    return token


# -aux plurals of -ail nouns (the generic aux→al rule would split these
# families: travaux→traval vs travail)
_AUX_EXCEPTIONS = {
    "travaux": "travail", "baux": "bail", "coraux": "corail",
    "émaux": "émail", "vitraux": "vitrail", "vantaux": "vantail",
    "soupiraux": "soupirail", "aulx": "ail",
}


def _make_conflater(stem):
    """Wrap a Snowball-style stemmer into a conflation-consistent key fn.

    Raw French Snowball leaves -ent 3rd-plural and -ons 1st-plural verb
    forms unstemmed (contestent→contestent vs conteste→contest), mishandles
    -aux/-eaux plurals (travaux→traval vs travail→travail), and is not
    idempotent (loyers→loyer but loyer→loi).  BM25 needs every member of an
    inflection family on ONE index key — which key doesn't matter.  So:
    normalize plurals, strip the ambiguous verb endings, stem, and iterate
    the whole chain to a fixpoint.  The endings rules apply uniformly, so a
    family can only merge with another family (same behavior class as
    stemming itself), never split.  Measured: scripts/preprocessor_study.py.
    """

    def conflate(t: str) -> str:
        for _ in range(4):
            prev = t
            if t in _AUX_EXCEPTIONS:
                t = _AUX_EXCEPTIONS[t]
            elif t.endswith("eaux"):
                t = t[:-1]
            elif t.endswith("aux") and len(t) > 4:
                t = t[:-3] + "al"
            if t.endswith("ents") and len(t) > 6:
                t = t[:-4]
            elif t.endswith("ent") and len(t) > 5:
                t = t[:-3]
            t = stem(t)
            if t.endswith("on") and len(t) > 4:
                t = t[:-2]
            if t == prev:
                break
        return t

    return conflate


class TextPreprocessor:
    """Lexical preprocessing with spaCy when available, pure-Python otherwise."""

    def __init__(self, spacy_model: str | None = "fr_core_news_md", stemmer: str = "auto"):
        self.nlp = None
        if spacy_model is not None:
            try:  # pragma: no cover - spaCy not present in the build image
                import spacy

                self.nlp = spacy.load(spacy_model)
            except Exception:
                self.nlp = None
        self._stem = None
        if stemmer == "auto":
            try:
                from nltk.stem.snowball import FrenchStemmer

                self._stem = _make_conflater(FrenchStemmer().stem)
            except Exception:
                self._stem = None
        elif stemmer == "snowball_raw":
            from nltk.stem.snowball import FrenchStemmer

            self._stem = FrenchStemmer().stem
        elif stemmer == "light":
            pass  # keep the suffix-rule lemmatizer
        else:
            raise ValueError(
                f"stemmer must be 'auto', 'snowball_raw' or 'light', got {stemmer!r}"
            )
        # a word's lemma is a pure function of the word: memoized, since a
        # corpus repeats a small vocabulary (the Snowball stem dominates a
        # build's host time otherwise)
        self._lemma = functools.lru_cache(maxsize=1 << 18)(self._stem or _light_lemma)

    def preprocess(
        self,
        texts: Sequence[str],
        lowercase: bool = True,
        remove_punct: bool = True,
        remove_num: bool = True,
        remove_stop: bool = True,
        lemmatize: bool = True,
    ) -> list[str]:
        if self.nlp is not None:  # pragma: no cover
            return self._preprocess_spacy(texts, lowercase, remove_punct, remove_num, remove_stop, lemmatize)
        return [
            self._preprocess_one(t, lowercase, remove_num, remove_stop, lemmatize) for t in texts
        ]

    def _preprocess_one(
        self, text: str, lowercase: bool, remove_num: bool, remove_stop: bool, lemmatize: bool
    ) -> str:
        tokens: list[str] = []
        for m in _WORD_RE.finditer(text):
            tok = m.group(0)
            low = tok.lower()
            if remove_num and _HAS_DIGIT_RE.match(tok):
                continue
            # apostrophe clitics FIRST: "d'une"/"l'on" must reduce to their
            # host word BEFORE the stopword check, or elided stopwords leak
            # into the index (spaCy drops them via is_stop)
            if "'" in low:
                head, _, tail = low.partition("'")
                if head in FRENCH_STOPWORDS and tail:
                    low = tail
            if remove_stop and low in FRENCH_STOPWORDS:
                continue
            if lemmatize:
                low = self._lemma(low)
            if not low:
                continue
            # lemmatize=True always emits the (lowercase) lemma — previously
            # lowercase=False silently discarded the lemmatization; with
            # both off, the original surface form is kept
            tokens.append(low if (lowercase or lemmatize) else tok)
        return " ".join(tokens)

    def _preprocess_spacy(
        self, texts, lowercase, remove_punct, remove_num, remove_stop, lemmatize
    ):  # pragma: no cover - requires spaCy model
        out = []
        for doc in self.nlp.pipe(texts, n_process=-1):
            tokens = []
            for token in doc:
                if remove_punct and token.is_punct:
                    continue
                if remove_num and (token.is_digit or token.like_num or _HAS_DIGIT_RE.match(token.text)):
                    continue
                if remove_stop and token.is_stop:
                    continue
                tokens.append(token.lemma_ if lemmatize else token.text)
            text = " ".join(tokens)
            out.append(text.lower() if lowercase else text)
        return out


def whitespace_tokenize(texts: Iterable[str]) -> list[list[str]]:
    """Split already-preprocessed strings on whitespace (the index contract)."""
    return [t.split() for t in texts]
