from fusion_tpu_torch._lazy import lazy_exports

__getattr__, __all__ = lazy_exports(__name__, {
    "catchtime": "common",
    "count_parameters": "common",
    "estimate_flops": "common",
    "log_step": "common",
    "set_seed": "common",
    "JSONLLogger": "loggers",
    "LoggingHandler": "loggers",
    "WandbLogger": "loggers",
})
