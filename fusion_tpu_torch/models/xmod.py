"""X-MOD (cross-lingual modular) encoder trunk, in PyTorch.

The same trunk as ``fusion_tpu/models/xmod.py``: the encoder's embeddings
and ``SelfAttention`` (so its ``flash`` form trains through the attention
kernels), and per-language bottleneck adapters held STACKED
(``[n_langs, ...]`` leading axis, f32) and picked by a language index, so one
module serves every language.  The contract is HF ``XmodModel`` with the
facebook/xmod-base flags (pre_norm=False, ln_before_adapter=True,
adapter_reuse_layer_norm=True, adapter_layer_norm=False):

    x   = LN_attn(x + attn(x))                     # post-norm attention
    r   = x + FFN(x)                               # residual without LN
    y   = LN_ffn(r)                                # reused LN before adapter
    out = LN_ffn(y + adapter_lang(y))              # bottleneck adapter

The language is an attribute of the trunk (``XmodEncoder.lang_idx``), which
the models' ``set_language`` pins, so ``XmodEncoder`` is called as
``Encoder`` is.  Under ``quantize="int8"`` the trunk's linear layers run on
int8 codes and the adapters stay in their f32 parameters, cast to the
compute dtype.  ``load_hf_xmod_params`` maps an HF X-MOD checkpoint
directory (read without ``transformers``), optionally subsetting the
adapters to the languages served; ``xmod_finetune_labels`` gives the
fine-tuning recipe's freeze labels (embeddings and adapters frozen).

Under ``model > 1`` (``parallel/sharding.shard_module``) the trunk runs
Megatron-parallel as the encoder's does: attention by heads, the FFN by its
inner dimension, the MLM decoder by vocabulary.  JAX's rules match none of
the adapters' or layer norms' paths, so they stay whole on every ``model``
rank, and the step averages their gradients over ``model``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from fusion_tpu_torch.models.encoder import (
    ATTENTION_IMPLS,
    SITE_ATTN_OUT,
    SITE_FFN_OUT,
    DropoutKey,
    Embeddings,
    LayerNorm,
    Linear,
    MLMHead,
    SelfAttention,
    dropout,
    hf_mlm_tree,
    hf_model_prefix,
    hf_trunk_tree,
    hf_value,
    row_parallel,
    trunk_linear,
)
from fusion_tpu_torch.parallel.sharding import copy_to_model

SITE_ADAPTER = 4  # the adapter output's dropout site (after the encoder's four)


@dataclasses.dataclass(frozen=True)
class XmodConfig:
    vocab_size: int = 250_002
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 514
    type_vocab_size: int = 1
    pad_token_id: int = 1
    mask_token_id: int = 250_001
    layer_norm_eps: float = 1e-5
    position_offset: int = 2
    dropout: float = 0.1
    dtype: torch.dtype = torch.float32
    remat: bool = False
    # see EncoderConfig.attention_impl
    attention_impl: str = "einsum"
    # None | 'int8': the trunk's linear layers on int8 codes (serving only);
    # the adapters stay in their f32 parameters
    quantize: str | None = None
    # X-MOD specifics (facebook/xmod-base defaults)
    languages: tuple[str, ...] = ("en_XX",)
    adapter_reduction_factor: int = 2
    ln_before_adapter: bool = True
    adapter_reuse_layer_norm: bool = True
    adapter_layer_norm: bool = False

    def __post_init__(self):
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl must be one of {ATTENTION_IMPLS}, got {self.attention_impl!r}")
        if self.quantize not in (None, "int8"):
            raise ValueError(f"quantize must be None or 'int8', got {self.quantize!r}")
        object.__setattr__(self, "languages", tuple(self.languages))

    @property
    def bottleneck_size(self) -> int:
        return self.hidden_size // self.adapter_reduction_factor

    def lang_index(self, lang: str) -> int:
        """'fr' or 'fr_XX' → adapter index."""
        from fusion_tpu_torch.utils.xmod import xmod_language_code

        return self.languages.index(xmod_language_code(lang))

    @classmethod
    def tiny(cls, vocab_size: int = 128, languages=("fr_XX", "en_XX"), **kw) -> "XmodConfig":
        defaults = dict(
            vocab_size=vocab_size, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position=66, pad_token_id=1,
            mask_token_id=vocab_size - 1, dropout=0.0, languages=tuple(languages),
        )
        defaults.update(kw)
        return cls(**defaults)


def is_xmod(cfg) -> bool:
    return isinstance(cfg, XmodConfig)


class StackedAdapters(nn.Module):
    """Per-language bottleneck adapters as stacked f32 parameters
    ``[n_langs, ...]``: ``gelu(x · down + b) · up + b`` of the language
    picked, computed in ``x``'s dtype."""

    def __init__(self, cfg: XmodConfig):
        super().__init__()
        nl, h, b = len(cfg.languages), cfg.hidden_size, cfg.bottleneck_size
        self.down_kernel = nn.Parameter(torch.zeros(nl, h, b))
        self.down_bias = nn.Parameter(torch.zeros(nl, b))
        self.up_kernel = nn.Parameter(torch.zeros(nl, b, h))
        self.up_bias = nn.Parameter(torch.zeros(nl, h))

    def reset_parameters_from(self, gen: torch.Generator) -> None:
        """Seeded init (``init_weights``): normal kernels of std
        1/sqrt(fan_in), zero biases."""
        with torch.no_grad():
            for k in (self.down_kernel, self.up_kernel):
                k.copy_(torch.randn(k.shape, generator=gen) / math.sqrt(k.shape[1]))
            self.down_bias.zero_()
            self.up_bias.zero_()

    def forward(self, x: torch.Tensor, lang_idx: int) -> torch.Tensor:
        dt = x.dtype
        mid = F.gelu(x @ self.down_kernel[lang_idx].to(dt) + self.down_bias[lang_idx].to(dt), approximate="none")
        return mid @ self.up_kernel[lang_idx].to(dt) + self.up_bias[lang_idx].to(dt)


class XmodLayer(nn.Module):
    # under model > 1 (parallel/sharding.shard_module): ffn_in column-parallel,
    # ffn_out row-parallel, as TransformerLayer's; the adapters and the layer
    # norms stay whole on every model rank
    tp_mesh = None

    def __init__(self, cfg: XmodConfig, index: int = 0):
        super().__init__()
        self.cfg = cfg
        self.index = index
        self.attention = SelfAttention(cfg)
        self.attn_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.ffn_in = Linear(cfg.hidden_size, cfg.intermediate_size)
        self.ffn_out = Linear(cfg.intermediate_size, cfg.hidden_size)
        # HF XmodLayer (post-norm): the shared output LayerNorm runs before
        # the adapter (when reused) and again on its output
        self.ffn_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        if cfg.adapter_layer_norm:
            self.adapter_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.adapters = StackedAdapters(cfg)

    def forward(self, x, attention_mask, lang_idx: int, drop: DropoutKey | None = None):
        c, i = self.cfg, self.index
        attn = self.attention(x, attention_mask, None, drop, i)
        x = self.attn_ln(x + dropout(attn, c.dropout, drop, i, SITE_ATTN_OUT)).to(c.dtype)
        inner = F.gelu(trunk_linear(self.ffn_in, copy_to_model(x, self.tp_mesh), c), approximate="none")
        h = row_parallel(self.ffn_out, inner, c, self.tp_mesh)
        r = x + dropout(h, c.dropout, drop, i, SITE_FFN_OUT)
        if c.adapter_layer_norm:
            y = self.adapter_ln(r).to(c.dtype)
        elif c.adapter_reuse_layer_norm:
            y = self.ffn_ln(r).to(c.dtype)
        else:
            y = r
        residual = y if c.ln_before_adapter else r
        a = dropout(self.adapters(y, lang_idx), c.dropout, drop, i, SITE_ADAPTER)
        return self.ffn_ln(residual + a).to(c.dtype)


class XmodEncoder(nn.Module):
    """Embeddings + N X-MOD layers → last hidden states, through the adapter
    ``lang_idx`` (an attribute: ``XmodConfig.lang_index`` resolves codes)."""

    def __init__(self, cfg: XmodConfig):
        super().__init__()
        self.cfg = cfg
        self.lang_idx = 0
        self.embeddings = Embeddings(cfg)
        self.layers = nn.ModuleList(XmodLayer(cfg, i) for i in range(cfg.num_layers))

    def forward(self, input_ids, attention_mask, drop: DropoutKey | None = None) -> torch.Tensor:
        x = self.embeddings(input_ids, None, drop)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                x = checkpoint(layer, x, attention_mask, self.lang_idx, drop, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = layer(x, attention_mask, self.lang_idx, drop)
        return x


class XmodEncoderWithMLM(nn.Module):
    """X-MOD trunk + MLM head, returning (hidden, logits): the multilingual
    SPLADE trunk (``EncoderWithMLM``'s contract)."""

    def __init__(self, cfg: XmodConfig):
        super().__init__()
        self.encoder = XmodEncoder(cfg)
        self.mlm = MLMHead(cfg)

    def forward(self, input_ids, attention_mask, drop: DropoutKey | None = None):
        hidden = self.encoder(input_ids, attention_mask, drop=drop)
        return hidden, self.mlm(hidden)


def set_module_language(module: nn.Module, lang_idx: int) -> None:
    """Route every X-MOD trunk inside ``module`` through adapter ``lang_idx``."""
    for m in module.modules():
        if isinstance(m, XmodEncoder):
            m.lang_idx = lang_idx


# ----------------------------------------------------------------------
# fine-tuning recipe: freeze embeddings + adapters, train the shared body
# ----------------------------------------------------------------------
def xmod_finetune_labels(paths) -> dict:
    """JAX path → 'train' / 'freeze', the X-MOD paper's recipe: the
    embeddings and the language adapters freeze, the shared body and the
    heads train (``trainer.freeze_labels``' form)."""
    frozen = ("adapters", "embeddings", "adapter_ln")
    return {p: "freeze" if any(str(k) in frozen for k in p) else "train" for p in paths}


# ----------------------------------------------------------------------
# HF checkpoint import
# ----------------------------------------------------------------------
def load_hf_xmod_params(
    model_name_or_path: str,
    languages: tuple[str, ...] | list[str] | None = None,
    dtype: torch.dtype = torch.float32,
    with_mlm: bool = False,
) -> tuple[XmodConfig, dict]:
    """An HF X-MOD checkpoint directory → ``(XmodConfig, {"params": tree})``:
    the JAX package's Flax tree (f32 numpy leaves), read without
    ``transformers``.  ``languages`` subsets the adapters (their order is
    the stacked index; default: every adapter the checkpoint carries).
    ``with_mlm`` also maps the LM head (an ``XmodForMaskedLM`` checkpoint):
    the tree is then ``{encoder, mlm}``, else the trunk at the top.  Dropout
    is 0, as the JAX loader sets it."""
    from fusion_tpu_torch.utils import hf_weights

    hf = hf_weights.read_config(model_name_or_path)
    sd = hf_weights.load_state_dict(model_name_or_path)
    if hf.get("pre_norm", False):
        raise ValueError("pre-norm X-MOD is not supported")
    hf_langs = list(hf["languages"])
    langs = list(languages) if languages is not None else hf_langs
    missing = [lang for lang in langs if lang not in hf_langs]
    if missing:
        raise ValueError(f"checkpoint has no adapters for {missing}")
    vocab = hf["vocab_size"]
    cfg = XmodConfig(
        vocab_size=vocab,
        hidden_size=hf["hidden_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        intermediate_size=hf["intermediate_size"],
        max_position=hf["max_position_embeddings"],
        type_vocab_size=hf.get("type_vocab_size", 2),
        pad_token_id=hf["pad_token_id"] if hf.get("pad_token_id") is not None else 1,
        mask_token_id=hf.get("mask_token_id") or vocab - 1,
        layer_norm_eps=hf.get("layer_norm_eps", 1e-12),
        dropout=0.0,
        dtype=dtype,
        languages=tuple(langs),
        adapter_reduction_factor=int(hf.get("adapter_reduction_factor", 2)),
        ln_before_adapter=bool(hf.get("ln_before_adapter", True)),
        adapter_reuse_layer_norm=bool(hf.get("adapter_reuse_layer_norm", True)),
        adapter_layer_norm=bool(hf.get("adapter_layer_norm", False)),
    )
    prefix = hf_model_prefix(sd)

    def g(key):
        return hf_value(sd, prefix + key)

    tree = hf_trunk_tree(g, cfg.hidden_size, cfg.num_heads, cfg.num_layers)
    for i in range(cfg.num_layers):
        ap = f"encoder.layer.{i}.output"
        tree[f"layer_{i}"]["adapters"] = {
            "down_kernel": np.stack([g(f"{ap}.adapter_modules.{lang}.dense1.weight").T for lang in langs]),
            "down_bias": np.stack([g(f"{ap}.adapter_modules.{lang}.dense1.bias") for lang in langs]),
            "up_kernel": np.stack([g(f"{ap}.adapter_modules.{lang}.dense2.weight").T for lang in langs]),
            "up_bias": np.stack([g(f"{ap}.adapter_modules.{lang}.dense2.bias") for lang in langs]),
        }
        if cfg.adapter_layer_norm:
            tree[f"layer_{i}"]["adapter_ln"] = {"scale": g(f"{ap}.adapter_layer_norm.weight"),
                                                "bias": g(f"{ap}.adapter_layer_norm.bias")}
    if with_mlm:
        if "lm_head.dense.weight" not in sd:
            raise ValueError(f"{model_name_or_path} holds no masked-LM head (an XmodForMaskedLM checkpoint)")
        tree = {"encoder": tree, "mlm": hf_mlm_tree(sd, tree["embeddings"]["word"]["embedding"], roberta=True)}
    return cfg, {"params": tree}
