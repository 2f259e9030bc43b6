from fusion_tpu_torch._lazy import lazy_exports

__getattr__, __all__ = lazy_exports(__name__, {
    "CompressedTokenIndex": "compression",
    "kmeans": "compression",
    "compress_token_index": "compression",
    "maxsim_search_compressed": "compression",
    "ImpactIndex": "inverted",
    "activations_to_query_terms": "inverted",
    "build_impact_index": "inverted",
    "impact_search": "inverted",
    "sparse_to_impact_index": "inverted",
})
