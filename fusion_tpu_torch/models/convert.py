"""Flax parameter trees (numpy leaves) → state dicts of the port's modules,
and the JAX package's compressed ColBERT index (as numpy arrays) → the
port's index objects.

Layouts that differ between the two packages:
  * a Flax ``Dense`` kernel is ``[in, out]``, the transpose of
    ``nn.Linear.weight``;
  * the fused qkv kernel is ``[H, 3, heads, hd]`` with bias ``[3, heads, hd]``;
    the port's ``qkv`` Linear orders its outputs the same way, flattened;
  * the attention ``out`` kernel is ``[heads, hd, H]``;
  * ``Embed.embedding`` and LayerNorm ``scale``/``bias`` map to
    ``weight``/``bias``.

The functions take either a full variables dict (``{"params": ...}``) or the
bare parameter tree, and return f32 CPU tensors; ``load_state_dict`` casts
them to each module's dtype and device.  ``flax_layouts`` is the inverse
mapping, one parameter at a time, as views of tensors: training reads
gradients, the optimizer's decay mask and the freeze labels through it,
``flax_tree`` nests it into the Flax tree that a checkpoint saves, and
``state_dict_from_flax`` reads a tree back through it (T5's modules load
that way).
"""

from __future__ import annotations

from typing import Callable, Mapping, NamedTuple

import numpy as np
import torch
from torch import nn

from fusion_tpu_torch.core.device import resolve_device


def _array(x, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=dtype))


def _tree(variables: Mapping) -> Mapping:
    return variables["params"] if "params" in variables else variables


def _t(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):  # a bfloat16 leaf of a msgpack checkpoint
        return x.detach().to(torch.float32).cpu().clone()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _dense(tree: Mapping, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _t(tree["kernel"]).T.contiguous()
    if "bias" in tree:
        out[f"{prefix}.bias"] = _t(tree["bias"])


def _ln(tree: Mapping, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _t(tree["scale"])
    out[f"{prefix}.bias"] = _t(tree["bias"])


def encoder_state_dict(variables: Mapping, prefix: str = "") -> dict[str, torch.Tensor]:
    """Flax ``Encoder`` params → ``Encoder`` state dict (keys under ``prefix``)."""
    tree = _tree(variables)
    out: dict[str, torch.Tensor] = {}
    emb = tree["embeddings"]
    for name in ("word", "position", "token_type"):
        out[f"{prefix}embeddings.{name}.weight"] = _t(emb[name]["embedding"])
    _ln(emb["ln"], f"{prefix}embeddings.ln", out)
    i = 0
    while f"layer_{i}" in tree:
        lt, lp = tree[f"layer_{i}"], f"{prefix}layers.{i}"
        qkv = lt["attention"]["qkv"]
        h = qkv["kernel"].shape[0]
        out[f"{lp}.attention.qkv.weight"] = _t(qkv["kernel"]).reshape(h, -1).T.contiguous()
        out[f"{lp}.attention.qkv.bias"] = _t(qkv["bias"]).reshape(-1)
        o = lt["attention"]["out"]
        out[f"{lp}.attention.out.weight"] = _t(o["kernel"]).reshape(-1, h).T.contiguous()
        out[f"{lp}.attention.out.bias"] = _t(o["bias"])
        _ln(lt["attn_ln"], f"{lp}.attn_ln", out)
        _dense(lt["ffn_in"], f"{lp}.ffn_in", out)
        _dense(lt["ffn_out"], f"{lp}.ffn_out", out)
        _ln(lt["ffn_ln"], f"{lp}.ffn_ln", out)
        i += 1
    return out


def encoder_with_mlm_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """Flax ``EncoderWithMLM`` params → ``EncoderWithMLM`` state dict."""
    tree = _tree(variables)
    out = encoder_state_dict(tree["encoder"], prefix="encoder.")
    mlm = tree["mlm"]
    _dense(mlm["transform"], "mlm.transform", out)
    _ln(mlm["ln"], "mlm.ln", out)
    _dense(mlm["decoder"], "mlm.decoder", out)
    return out


def colbert_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """Flax ``ColBERTModule`` params → ``ColBERTModule`` state dict."""
    tree = _tree(variables)
    out = encoder_state_dict(tree["encoder"], prefix="encoder.")
    _dense(tree["colbert"]["proj"], "colbert.proj", out)
    return out


def crossencoder_state_dict(variables: Mapping) -> dict[str, torch.Tensor]:
    """Flax ``CrossEncoderModule`` params (``{"encoder", "head"}``) →
    ``CrossEncoderModule`` state dict."""
    tree = _tree(variables)
    out = encoder_state_dict(tree["encoder"], prefix="encoder.")
    _dense(tree["head"]["pooler"], "head.pooler", out)
    _dense(tree["head"]["classifier"], "head.classifier", out)
    return out


class FlaxLayout(NamedTuple):
    """One parameter's place in the Flax tree: its path, and its tensor
    (or gradient) viewed in the Flax layout and back."""

    path: tuple[str, ...]
    to_flax: Callable[[torch.Tensor], torch.Tensor]
    from_flax: Callable[[torch.Tensor], torch.Tensor]


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def _transpose(t: torch.Tensor) -> torch.Tensor:
    return t.T


# module lists and the Flax scope names of their members
_INDEXED = {"layers": "layer", "blocks": "block"}


def flax_layouts(module: nn.Module, num_heads: int) -> dict[str, FlaxLayout]:
    """Parameter name → its ``FlaxLayout`` in ``module`` (an ``Encoder``,
    ``EncoderWithMLM``, ``ColBERTModule``, ``CrossEncoderModule`` or
    ``T5EncoderForSequenceClassification``): ``layers.i`` is ``layer_i``
    and ``blocks.i`` ``block_i``; a Linear weight is the transposed
    ``kernel`` (the fused qkv ``[H, 3, heads, hd]``, the attention out
    ``[heads, hd, H]``), an Embedding's weight its ``embedding``, a
    LayerNorm's or RMSNorm's weight its ``scale``; any other parameter (T5's
    ``relative_attention_bias``) keeps its name and layout.  The views take
    the head dim from the hidden width, which tensor parallelism never
    splits, so they also read a rank's slice of the heads
    (``parallel/sharding.shard_module``)."""
    owners = dict(module.named_modules())
    out = {}
    for name, param in module.named_parameters():
        *mod_path, leaf = name.split(".")
        owner = owners[".".join(mod_path)]
        keys, i = [], 0
        while i < len(mod_path):
            if mod_path[i] in _INDEXED:
                keys.append(f"{_INDEXED[mod_path[i]]}_{mod_path[i + 1]}")
                i += 2
            else:
                keys.append(mod_path[i])
                i += 1
        to_flax, from_flax = _same, _same
        if leaf == "weight" and isinstance(owner, nn.Embedding):
            leaf = "embedding"
        elif leaf == "weight" and isinstance(owner, nn.Linear):
            leaf = "kernel"
            if mod_path[-2:] == ["attention", "qkv"]:
                hd = param.shape[1] // num_heads
                to_flax = lambda t, hd=hd: t.T.reshape(t.shape[1], 3, -1, hd)  # noqa: E731
                from_flax = lambda t: t.reshape(t.shape[0], -1).T  # noqa: E731
            elif mod_path[-2:] == ["attention", "out"]:
                hd = param.shape[0] // num_heads
                to_flax = lambda t, hd=hd: t.T.reshape(-1, hd, t.shape[0])  # noqa: E731
                from_flax = lambda t: t.reshape(-1, t.shape[-1]).T  # noqa: E731
            else:
                to_flax, from_flax = _transpose, _transpose
        elif leaf == "weight":  # LayerNorm
            leaf = "scale"
        elif leaf == "bias" and mod_path[-2:] == ["attention", "qkv"]:
            hd = owner.weight.shape[1] // num_heads
            to_flax = lambda t, hd=hd: t.reshape(3, -1, hd)  # noqa: E731
            from_flax = lambda t: t.reshape(-1)  # noqa: E731
        out[name] = FlaxLayout(tuple(keys) + (leaf,), to_flax, from_flax)
    return out


def flax_tree(module: nn.Module, num_heads: int, tensors: Mapping) -> dict:
    """``tensors`` keyed by ``module``'s parameter names (its state dict, or
    its gradients) → the JAX model's Flax tree, with f32 numpy leaves and
    sorted keys, built leaf by leaf through ``flax_layouts``: the tree that
    ``flax.serialization`` writes for the JAX package's model, so a
    checkpoint saved by the port loads there."""
    tree: dict = {}
    for name, layout in flax_layouts(module, num_heads).items():
        node = tree
        for key in layout.path[:-1]:
            node = node.setdefault(key, {})
        leaf = layout.to_flax(tensors[name].detach()).to(torch.float32).cpu()
        node[layout.path[-1]] = np.ascontiguousarray(leaf.numpy())
    return _sorted(tree)


def state_dict_from_flax(module: nn.Module, num_heads: int, variables: Mapping) -> dict[str, torch.Tensor]:
    """A Flax tree (or variables dict) → ``module``'s state dict, read leaf
    by leaf through ``flax_layouts``: the inverse of ``flax_tree``."""
    tree = _tree(variables)
    out = {}
    for name, layout in flax_layouts(module, num_heads).items():
        node = tree
        for key in layout.path:
            node = node[key]
        out[name] = layout.from_flax(_t(node)).contiguous()
    return out


def state_dict_of(build: Callable[[], nn.Module], num_heads: int, variables: Mapping) -> dict[str, torch.Tensor]:
    """A Flax tree → the state dict of the module ``build()`` makes (built on
    the meta device: no weights are allocated), read through
    ``flax_layouts`` (the X-MOD trunks load that way)."""
    with torch.device("meta"):
        module = build()
    return state_dict_from_flax(module, num_heads, variables)


def t5_crossencoder_state_dict(variables: Mapping, cfg) -> dict[str, torch.Tensor]:
    """Flax ``T5EncoderForSequenceClassification`` params (``{"encoder",
    "head_dense", "head_out"}``) → the port's module's state dict for the
    ``T5Config`` ``cfg``."""
    from fusion_tpu_torch.models.t5 import T5EncoderForSequenceClassification

    with torch.device("meta"):
        module = T5EncoderForSequenceClassification(cfg)
    return state_dict_from_flax(module, cfg.num_heads, variables)


def _sorted(tree: dict) -> dict:
    return {k: _sorted(v) if isinstance(v, dict) else v for k, v in sorted(tree.items())}


def plaid_index_from_arrays(
    centroids, centroid_ids, codes, mask, bucket_weights, nbits: int,
    ivf_doc=None, n_docs: int | None = None, cap: int | None = None, device="cuda",
):
    """The JAX package's ``CompressedTokenIndex`` arrays (and, with
    ``ivf_doc``, its ``IVFIndex``), given as numpy arrays → the port's
    ``(CompressedTokenIndex, IVFIndex | None)`` on ``device``, so both
    packages search one index.  The mask keeps its dtype (f32 or u8)."""
    from fusion_tpu_torch.index.compression import CompressedTokenIndex
    from fusion_tpu_torch.index.plaid import IVFIndex

    device = resolve_device(device)
    index = CompressedTokenIndex(
        centroids=_array(centroids, np.float32).to(device),
        centroid_ids=_array(centroid_ids, np.int32).to(device),
        codes=_array(codes, np.uint8).to(device),
        mask=_array(mask).to(device),
        bucket_weights=_array(bucket_weights, np.float32).to(device),
        nbits=int(nbits),
    )
    ivf = None
    if ivf_doc is not None:
        ivf = IVFIndex(_array(ivf_doc, np.int32).to(device), n_docs=int(n_docs), cap=int(cap))
    return index, ivf
