"""Walkthroughs of the port's public API, each a module with a ``main``:
``quickstart`` (train, build, search, rerank, evaluate), ``scale_serving``
(the corpus-scale index forms, persisted and reloaded) and
``streaming_serving`` (online updates behind the HTTP server).

    python -m fusion_tpu_torch.examples.quickstart [--device cpu]
"""
