from fusion_tpu_torch._lazy import lazy_exports

__getattr__, __all__ = lazy_exports(__name__, {"Metrics": "metrics", "compute_precision_recall_f1": "metrics"})
