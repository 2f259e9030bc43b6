"""Model checkpoints in the JAX package's format.

A checkpoint directory holds ``config_fusion_tpu.json`` (the model's
options, its tokenizer's identity, the encoder config without its dtype,
and a version stamp) and ``params.msgpack``: the Flax parameter tree as
``flax.serialization.to_bytes`` writes it, read and written here by
``utils/flax_msgpack.py``.  A checkpoint written by either package loads in
the other; ``BiEncoder``, ``ColBERT`` and ``CrossEncoder`` build their
``save`` / ``load`` on these helpers.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

import torch

from fusion_tpu_torch.models.encoder import EncoderConfig, migrate_pre_qkv_params
from fusion_tpu_torch.utils import flax_msgpack

CONFIG_FILENAME = "config_fusion_tpu.json"
PARAMS_FILENAME = "params.msgpack"


def encoder_config_dict(cfg) -> dict:
    """The ``encoder`` entry of a config (an ``EncoderConfig`` or a
    ``T5Config``): every field but the dtype (a loaded model computes in
    the dtype its loader asks for), the attention form and ``quantize``
    included."""
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "dtype"}


def encoder_config_from_dict(entry: dict, dtype: torch.dtype = torch.float32):
    """A config's ``encoder`` entry → the port's ``EncoderConfig``, or an
    ``XmodConfig`` for an X-MOD trunk (the entry names its ``languages``),
    its ``attention_impl`` and ``quantize`` honoured."""
    if "languages" in entry:
        from fusion_tpu_torch.models.xmod import XmodConfig

        return XmodConfig(**{**entry, "languages": tuple(entry["languages"])}, dtype=dtype)
    return EncoderConfig(**entry, dtype=dtype)


def version_stamp() -> dict:
    import fusion_tpu_torch

    return {"fusion_tpu_torch": fusion_tpu_torch.__version__, "torch": torch.__version__}


def write(path: str, config: dict, params_tree: dict) -> None:
    """Write ``config`` (with the version stamp) and the Flax tree, wrapped
    as flax's variables dict ``{"params": tree}``."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, CONFIG_FILENAME), "w") as f:
        json.dump({**config, "__version__": version_stamp()}, f, indent=2)
    with open(os.path.join(path, PARAMS_FILENAME), "wb") as f:
        f.write(flax_msgpack.packb({"params": params_tree}))


def save_step(model, ckpt_dir: str, step: int, save_total_limit: int = 3) -> None:
    """``model.save`` into ``ckpt_dir/<step>``, then delete the oldest step
    directories beyond ``save_total_limit`` (0 keeps all)."""
    model.save(os.path.join(ckpt_dir, str(step)))
    existing = sorted(int(d) for d in os.listdir(ckpt_dir) if d.isdigit())
    while save_total_limit and len(existing) > save_total_limit:
        shutil.rmtree(os.path.join(ckpt_dir, str(existing.pop(0))))


def read_config(path: str) -> dict:
    with open(os.path.join(path, CONFIG_FILENAME)) as f:
        return json.load(f)


def read_params(path: str) -> dict:
    """The checkpoint's variables dict, pre-fusion attention layouts
    migrated to the fused qkv form."""
    with open(os.path.join(path, PARAMS_FILENAME), "rb") as f:
        return migrate_pre_qkv_params(flax_msgpack.unpackb(f.read()))
