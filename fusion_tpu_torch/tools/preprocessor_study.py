"""Preprocessor risk study: the BM25 recall cost of the fallback lemmatizer.

The counterpart of ``scripts/preprocessor_study.py``.  The reference
preprocesses BM25 text with spaCy ``fr_core_news_md`` lemmatization;
without a spaCy model ``TextPreprocessor`` falls back to a light suffix
lemmatizer (or Snowball with conflation rules).  This study measures the
BM25-recall risk of that fallback on synthetic French morphology with
planted relevance:

  * an inventory of French-like lemmas in three morphology classes (nouns,
    adjectives, -er verbs) with real inflection paradigms;
  * documents = bags of inflected surface forms (zipf lemma sampling);
  * queries = lemmas of one planted target doc rendered with a different
    inflection than the doc used (the worst case for lexical matching);
  * five pipelines scored with the same ``BM25Index`` (k1 2.5, b 0.2, the
    [V+1, N] impact matrix on the device): none (lowercase + stopwords),
    fallback (Snowball + conflation), fallback_light, fallback_snowball_raw,
    and oracle (perfect form→lemma conflation, what spaCy approximates).

Recall@k of the planted doc under ``oracle`` minus under ``fallback`` is the
risk bound; ``none`` anchors how much lemmatization matters at all.  On a
machine without nltk, ``fallback`` is the light lemmatizer (as the port's
BM25 preprocessing there), ``fallback_snowball_raw`` is not run, and the
record says so (``fallback_stemmer``).  The
inventory and the world (``build_inventory``, ``build_world``) are the
script's, bit for bit; ``measure`` scores them.

Prints one JSON line (the script's keys); ``--out`` also writes it (the
script always wrote PREPROC_STUDY_r03.json; this tool writes nothing unless
asked).

    python -m fusion_tpu_torch.tools.preprocessor_study [--out FILE]
CPU: add --device cpu
"""

from __future__ import annotations

import argparse
import json

import numpy as np

# ---------------------------------------------------------------------------
# Morphology inventory: real French stems × real paradigms.
# ---------------------------------------------------------------------------

NOUN_STEMS = [
    "format", "inform", "administr", "constitu", "déclar", "évalu", "install",
    "consult", "négoci", "particip", "réclam", "résili", "indemnis", "cotis",
    "immatricul", "autoris", "notific", "public", "délibér", "conciliat",
]
NOUN_SUFFIXES = ["ation", "ateur", "ement"]

PLAIN_NOUNS = [
    "contrat", "tribunal", "journal", "travail", "bail", "château", "bureau",
    "niveau", "réseau", "gâteau", "cheval", "canal", "signal", "capital",
    "hôpital", "conseil", "document", "jugement", "règlement", "paiement",
    "licenciement", "remboursement", "loyer", "dommage", "préjudice",
    "procédure", "audience", "créance", "garantie", "assurance", "amende",
    "peine", "recours", "appel", "litige", "saisie", "hypothèque", "caution",
    "servitude", "usufruit", "succession", "héritage", "donation", "clause",
    "obligation", "responsabilité", "propriété", "indivision", "copropriété",
    "prescription",
]

ADJECTIVES = [
    "légal", "pénal", "fiscal", "social", "commercial", "médical", "amical",
    "national", "régional", "principal", "dangereux", "sérieux", "nombreux",
    "heureux", "coûteux", "litigieux", "contentieux", "abusif", "attributif",
    "exécutif", "locatif", "successif", "définitif", "administratif",
    "décisif", "grand", "petit", "fort", "certain", "prochain",
]

ER_VERBS = [
    "résilier", "contester", "réclamer", "indemniser", "licencier", "louer",
    "rembourser", "saisir_er", "condamner", "notifier", "déclarer", "estimer",
    "attaquer", "plaider", "constater", "motiver", "homologuer", "liquider",
    "prononcer", "infliger", "réparer", "garantir_er", "signer", "annuler",
    "renouveler", "facturer", "percevoir_er", "verser", "occuper", "expulser",
]

FILLER_STOPWORDS = (
    "le la les un une des de du au aux et ou mais donc car pour par sur dans "
    "avec sans sous est sont avait être avoir que qui ne pas plus très"
).split()


def noun_forms(lemma: str) -> list[str]:
    """lemma + plural (French pluralization rules)."""
    if lemma.endswith("al"):
        return [lemma, lemma[:-2] + "aux"]
    if lemma.endswith("ail"):
        return [lemma, lemma[:-3] + "aux"]
    if lemma.endswith("eau"):
        return [lemma, lemma + "x"]
    if lemma.endswith(("s", "x", "z")):
        return [lemma]
    return [lemma, lemma + "s"]


def adj_forms(lemma: str) -> list[str]:
    if lemma.endswith("eux"):
        return [lemma, lemma[:-1] + "se", lemma[:-1] + "ses"]
    if lemma.endswith("if"):
        return [lemma, lemma + "s", lemma[:-1] + "ve", lemma[:-1] + "ves"]
    if lemma.endswith("al"):
        return [lemma, lemma[:-2] + "aux", lemma + "e", lemma + "es"]
    return [lemma, lemma + "e", lemma + "s", lemma + "es"]


def verb_forms(lemma: str) -> list[str]:
    stem = lemma[:-2].replace("_er", "")
    return [
        stem + "er", stem + "e", stem + "es", stem + "ons", stem + "ez",
        stem + "ent", stem + "ait", stem + "aient", stem + "é", stem + "ée",
        stem + "és", stem + "ées", stem + "ant", stem + "era",
    ]


def build_inventory() -> list[list[str]]:
    """Each entry: list of surface forms of one lemma (entry[0] = lemma).

    Derivational families (formation vs formateur — distinct lemmas on one
    stem, which aggressive stemmers merge) are kept to a REALISTIC minority:
    one suffix per stem, plus a 6-stem probe carrying two suffixes each.  A
    first draft gave every stem all three suffixes, which put 35 % of the
    zipf head in cross-derivational minimal pairs and made any stemmer look
    catastrophically over-conflating — an artifact, not French."""
    inv: list[list[str]] = []
    for i, stem in enumerate(NOUN_STEMS):
        inv.append(noun_forms(stem + NOUN_SUFFIXES[i % len(NOUN_SUFFIXES)]))
        if i < 6:  # derivational-collision probe: a second distinct lemma
            inv.append(noun_forms(stem + NOUN_SUFFIXES[(i + 1) % len(NOUN_SUFFIXES)]))
    for n in PLAIN_NOUNS:
        inv.append(noun_forms(n))
    for a in ADJECTIVES:
        inv.append(adj_forms(a))
    for v in ER_VERBS:
        inv.append(verb_forms(v))
    # dedupe surface collisions across lemmas (keep first owner)
    seen: set[str] = set()
    out = []
    for forms in inv:
        forms = [f for f in forms if f not in seen]
        if len(forms) >= 2:
            seen.update(forms)
            out.append(forms)
    return out



def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--out", default=None, help="also write the JSON record to this file")
    return ap.parse_args(argv)


LEMMAS_PER_DOC, QUERY_TERMS = 12, 4


def build_world(rng: np.random.Generator, n_docs: int = 20_000, n_queries: int = 500) -> dict:
    """The shuffled inventory, the docs (12 zipf^0.8 lemmas a doc, each in
    one of its forms, two stopwords after each) and the queries (4 of the
    target doc's lemmas, each in a form the doc does not use)."""
    inventory = build_inventory()
    rng.shuffle(inventory)  # decouple zipf popularity from morphology class
    n_lemmas = len(inventory)
    pop = 1.0 / (np.arange(n_lemmas) + 1) ** 0.8
    pop /= pop.sum()

    doc_lemmas, docs_raw = [], []
    for _ in range(n_docs):
        li = rng.choice(n_lemmas, size=LEMMAS_PER_DOC, replace=False, p=pop)
        forms_used = {}
        words: list[str] = []
        for lemma in li:
            forms = inventory[lemma]
            fi = int(rng.integers(len(forms)))
            forms_used[int(lemma)] = fi
            words.append(forms[fi])
            words.extend(rng.choice(FILLER_STOPWORDS, size=2))
        rng.shuffle(words)
        doc_lemmas.append(forms_used)
        docs_raw.append(" ".join(words))

    queries_raw, q_target = [], []
    for _ in range(n_queries):
        di = int(rng.integers(n_docs))
        q_target.append(di)
        lemmas = list(doc_lemmas[di].items())
        rng.shuffle(lemmas)
        words = []
        for lemma, doc_fi in lemmas[:QUERY_TERMS]:
            forms = inventory[lemma]
            other = [i for i in range(len(forms)) if i != doc_fi]
            fi = int(rng.choice(other)) if other else doc_fi
            words.append(forms[fi])
        queries_raw.append(" ".join(words))
    return {"inventory": inventory, "docs": docs_raw, "queries": queries_raw, "q_target": q_target}


def measure(world: dict, device) -> dict:
    """Conflation accuracy of each fallback and BM25 recall@10 / @100 and
    MRR@10 of the planted doc under each pipeline: the JSON record."""
    from fusion_tpu_torch.data.preprocessor import TextPreprocessor
    from fusion_tpu_torch.models.bm25 import BM25Index

    inventory, docs_raw, queries_raw = world["inventory"], world["docs"], world["queries"]
    form_to_lemma = {f: forms[0] for forms in inventory for f in forms}
    pre = TextPreprocessor(spacy_model=None)  # Snowball + conflation rules (without nltk: light)
    pre_light = TextPreprocessor(spacy_model=None, stemmer="light")
    try:
        pre_raw = TextPreprocessor(spacy_model=None, stemmer="snowball_raw")
    except ImportError:  # no nltk on this machine: the raw Snowball pipeline is not run
        pre_raw = None

    def oracle_preprocess(texts):
        base = pre.preprocess(texts, lemmatize=False)
        return [" ".join(form_to_lemma.get(t, t) for t in s.split()) for s in base]

    pipelines = {
        "none": lambda ts: pre.preprocess(ts, lemmatize=False),
        "fallback_light": lambda ts: pre_light.preprocess(ts, lemmatize=True),
        "fallback_snowball_raw": lambda ts: pre_raw.preprocess(ts, lemmatize=True),
        "fallback": lambda ts: pre.preprocess(ts, lemmatize=True),
        "oracle": oracle_preprocess,
    }
    if pre_raw is None:
        del pipelines["fallback_snowball_raw"]

    # token-level conflation: the share of surface forms whose fallback
    # lemma is their true lemma's (query and doc forms meet in one term)
    all_forms = [(f, forms[0]) for forms in inventory for f in forms]
    conflation = {}
    for pname, p in (("fallback", pre), ("fallback_snowball_raw", pre_raw), ("fallback_light", pre_light)):
        if p is None:
            continue
        fb = {s: p.preprocess([s], lemmatize=True)[0] for s in {x for pair in all_forms for x in pair}}
        conflated = sum(1 for f, lemma in all_forms if fb[f] and fb[f] == fb[lemma])
        conflation[pname] = round(conflated / len(all_forms), 4)

    results = {}
    tgt = np.asarray(world["q_target"])[:, None]
    for name, fn in pipelines.items():
        index = BM25Index.build(fn(docs_raw), k1=2.5, b=0.2, device=device)
        ids = index.search_dense(fn(queries_raw), index.build_dense_impacts(), top_k=100).ids.cpu().numpy()
        hit10 = (ids[:, :10] == tgt).any(1)
        results[name] = {
            "recall@10": round(float(np.mean(hit10)), 4),
            "recall@100": round(float(np.mean((ids == tgt).any(1))), 4),
            "mrr@10": round(float(np.mean(np.where(hit10, 1.0 / (np.argmax(ids[:, :10] == tgt, 1) + 1), 0.0))), 4),
            "vocab_size": index.vocab_size,
        }

    return {
        "study": "preprocessor_fallback_vs_oracle_lemmatization",
        "corpus_docs": len(docs_raw),
        "queries": len(queries_raw),
        "lemmas": len(inventory),
        "query_forms_forced_mismatched": True,
        "form_conflation_accuracy": conflation,
        "pipelines": results,
        "risk_bound_recall@10": round(results["oracle"]["recall@10"] - results["fallback"]["recall@10"], 4),
        # what "fallback" ran: Snowball with the conflation rules, or the
        # light suffix lemmatizer where nltk is not installed
        "fallback_stemmer": "snowball_conflation" if pre._stem is not None else "light",
        "note": (
            "Worst-case morphology: every query term is an inflection the "
            "target doc does NOT contain, so recall is driven entirely by "
            "lemma conflation. Real queries repeat document surface forms "
            "far more often; treat the oracle-fallback delta as an upper "
            "bound on the BM25 recall risk of shipping without spaCy."
        ),
    }


def main(argv=None) -> dict:
    from fusion_tpu_torch.core.device import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device)
    out = measure(build_world(np.random.default_rng(42)), device)
    line = json.dumps(out, ensure_ascii=False)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(json.dumps(out, indent=2, ensure_ascii=False) + "\n")
    return out


if __name__ == "__main__":
    main()
