from fusion_tpu_torch._lazy import lazy_exports

__getattr__, __all__ = lazy_exports(__name__, {
    "Aggregator": "aggregator",
    "build_percentile_distribution": "aggregator",
    "tune_fusion_weights": "aggregator",
})
