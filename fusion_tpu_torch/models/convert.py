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
them to each module's dtype and device.  The ``*_flax_tree`` functions are
their inverses: a module's state dict → the Flax tree (f32 numpy leaves) that
``flax.serialization`` writes for the JAX package's model, so a checkpoint
saved by the port loads there.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

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


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.float32).cpu().numpy()


def _dense_tree(sd: Mapping, prefix: str) -> dict:
    out = {"kernel": np.ascontiguousarray(_np(sd[f"{prefix}.weight"]).T)}
    if f"{prefix}.bias" in sd:
        out["bias"] = _np(sd[f"{prefix}.bias"])
    return out


def _ln_tree(sd: Mapping, prefix: str) -> dict:
    return {"bias": _np(sd[f"{prefix}.bias"]), "scale": _np(sd[f"{prefix}.weight"])}


def encoder_flax_tree(sd: Mapping, num_heads: int, prefix: str = "") -> dict:
    """``Encoder`` state dict (keys under ``prefix``) → Flax ``Encoder`` params."""
    emb = {"ln": _ln_tree(sd, f"{prefix}embeddings.ln")}
    for name in ("position", "token_type", "word"):
        emb[name] = {"embedding": _np(sd[f"{prefix}embeddings.{name}.weight"])}
    tree = {"embeddings": emb}
    i = 0
    while f"{prefix}layers.{i}.attention.qkv.weight" in sd:
        lp = f"{prefix}layers.{i}"
        qkv_w = _np(sd[f"{lp}.attention.qkv.weight"])  # [3·H, H]
        h = qkv_w.shape[1]
        hd = h // num_heads
        out_w = _np(sd[f"{lp}.attention.out.weight"])  # [H, H]
        tree[f"layer_{i}"] = {
            "attention": {
                "out": {
                    "bias": _np(sd[f"{lp}.attention.out.bias"]),
                    "kernel": np.ascontiguousarray(out_w.T.reshape(num_heads, hd, h)),
                },
                "qkv": {
                    "bias": _np(sd[f"{lp}.attention.qkv.bias"]).reshape(3, num_heads, hd),
                    "kernel": np.ascontiguousarray(qkv_w.T.reshape(h, 3, num_heads, hd)),
                },
            },
            "attn_ln": _ln_tree(sd, f"{lp}.attn_ln"),
            "ffn_in": _dense_tree(sd, f"{lp}.ffn_in"),
            "ffn_ln": _ln_tree(sd, f"{lp}.ffn_ln"),
            "ffn_out": _dense_tree(sd, f"{lp}.ffn_out"),
        }
        i += 1
    return tree


def encoder_with_mlm_flax_tree(sd: Mapping, num_heads: int) -> dict:
    """``EncoderWithMLM`` state dict → Flax ``EncoderWithMLM`` params."""
    return {
        "encoder": encoder_flax_tree(sd, num_heads, prefix="encoder."),
        "mlm": {
            "decoder": _dense_tree(sd, "mlm.decoder"),
            "ln": _ln_tree(sd, "mlm.ln"),
            "transform": _dense_tree(sd, "mlm.transform"),
        },
    }


def colbert_flax_tree(sd: Mapping, num_heads: int) -> dict:
    """``ColBERTModule`` state dict → Flax ``ColBERTModule`` params."""
    return {
        "colbert": {"proj": _dense_tree(sd, "colbert.proj")},
        "encoder": encoder_flax_tree(sd, num_heads, prefix="encoder."),
    }


def crossencoder_flax_tree(sd: Mapping, num_heads: int) -> dict:
    """``CrossEncoderModule`` state dict → Flax ``CrossEncoderModule`` params."""
    return {
        "encoder": encoder_flax_tree(sd, num_heads, prefix="encoder."),
        "head": {"classifier": _dense_tree(sd, "head.classifier"), "pooler": _dense_tree(sd, "head.pooler")},
    }


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
