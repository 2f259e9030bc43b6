from fusion_tpu_torch.parallel.sharding import (
    make_mesh,
    encoder_param_spec,
    shard_params,
    DATA_AXIS,
    MODEL_AXIS,
    INDEX_AXIS,
)

__all__ = [
    "make_mesh",
    "encoder_param_spec",
    "shard_params",
    "DATA_AXIS",
    "MODEL_AXIS",
    "INDEX_AXIS",
]
