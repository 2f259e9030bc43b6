"""Streaming serving: online index updates behind the HTTP front door.

The counterpart of ``examples/streaming_serving.py``:

  1. build a hybrid searcher (BM25 + an int8-corpus DPR leg) over an initial
     corpus,
  2. serve it over HTTP with dynamic batching (``server.py``),
  3. add and delete documents while serving (``segmented.py``: only the
     delta is encoded; BM25 is rebuilt over the whole corpus, so idf stays
     exact),
  4. compact the segments.

    python -m fusion_tpu_torch.examples.streaming_serving              # on the card
    python -m fusion_tpu_torch.examples.streaming_serving --device cpu
"""

from __future__ import annotations

import argparse
import json
import urllib.request

import numpy as np

WORDS = (
    "chat chien tribunal jugement contrat travail loi consommateur "
    "voiture route oiseau foret tapis salon jardin souris fromage pain"
).split()
QUERY = "chat tapis salon"


def build_models(device) -> dict:
    from fusion_tpu_torch import BiEncoder, EncoderConfig

    return {"dense": BiEncoder(EncoderConfig.tiny(vocab_size=1024), head="dense", max_query_length=8,
                               max_doc_length=16, device=device)}


def main(device="cuda", models: dict | None = None) -> dict:
    """Run the walkthrough on ``device``; returns what it printed (each
    answer of the server, its health and stats).  ``models`` (``dense``)
    replaces the seeded model."""
    from fusion_tpu_torch import SearchServer, SegmentedHybridSearcher
    from fusion_tpu_torch.core.device import resolve_device
    from fusion_tpu_torch.data.preprocessor import TextPreprocessor

    device = resolve_device(device)
    models = models or build_models(device)
    rng = np.random.default_rng(0)

    def make_corpus(n, base_id):
        return {base_id + i: " ".join(rng.choice(WORDS, size=6, replace=False)) for i in range(n)}

    prep = TextPreprocessor(spacy_model=None)
    corpus = make_corpus(40, base_id=0)
    searcher = SegmentedHybridSearcher(
        corpus,
        bm25_docs=prep.preprocess(list(corpus.values())),
        dense_model=models["dense"],
        topk=10,
        batch_size=8,
        bm25_preprocess=lambda t: prep.preprocess(list(t)),
        int8_corpus=True,
        device=device,
    )
    print(f"built: systems={searcher.active_systems} docs={searcher.n_docs}")

    srv = SearchServer(searcher, port=0, max_batch=8, max_wait_ms=5.0)
    srv.start()
    host, port = srv.address
    base = f"http://{host}:{port}"

    def query(q):
        req = urllib.request.Request(
            f"{base}/search",
            data=json.dumps({"queries": [q], "topk": 3}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())["results"][0]

    answers = {}
    try:
        answers["before_add"] = query(QUERY)
        print("before add:", answers["before_add"])

        # online update: only these 10 docs get encoded
        delta = make_corpus(10, base_id=1000)
        searcher.add_documents(delta, bm25_docs=prep.preprocess(list(delta.values())))
        answers["after_add"] = query(QUERY)
        print(f"after add (+10 docs, segments={len(searcher.segments)}):", answers["after_add"])

        searcher.delete_documents([answers["after_add"]["ids"][0]])
        answers["after_delete"] = query(QUERY)
        print("after deleting the top hit:", answers["after_delete"])

        searcher.compact()
        answers["after_compact"] = query(QUERY)
        print(f"after compact (segments={len(searcher.segments)}):", answers["after_compact"])

        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        srv.stop()
    print("healthz:", health)
    print(f"stats: {stats['requests']} requests, {stats['batches']} device batches")
    return {"answers": answers, "healthz": health, "stats": stats, "systems": list(searcher.active_systems)}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap.parse_args(argv)


if __name__ == "__main__":
    main(parse_args().device)
