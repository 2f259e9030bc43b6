"""Encoder-only (m)T5 for sequence classification and reranking, in PyTorch.

The same model as ``fusion_tpu/models/t5.py``, layer for layer: RMSNorm,
bias-free projections, unscaled attention whose logits are formed in the
compute dtype and only then cast to f32, one bucketed relative-position bias
computed in block 0 and shared by every block, and the ReLU FFN (T5 v1.0) or
the gated tanh-GELU one (v1.1 / mT5, ``mt5_config``).  The encoder pools
(first / mean / max over the attended tokens) into a dense → tanh → f32
classification head.

``T5CrossEncoder`` is the monoT5-style reranker on the shared
``PairRerankMixin``: its device pairs are laid out ``[q | EOS | d]`` (one
special slot, no CLS), the relative bias reads positions that count attended
slots (so the query's mid-sequence pads do not stretch distances), and its
packed rows restart positions at each pair and pool each pair over its own
span.  It serves as a ``HybridSearcher`` cross-encoder as ``CrossEncoder``
does, and ``save`` / ``load`` read and write the JAX package's
``t5_crossencoder`` checkpoints.

``relative_position_bucket`` takes the bucket of every distance from a table
computed once on the host in f32, in the JAX package's order of operations,
so a device's own ``log`` cannot move a distance across a bucket edge.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fusion_tpu_torch.core.device import resolve_device
from fusion_tpu_torch.data.tokenization import WordHashTokenizer, tokenizer_config, tokenizer_from_config
from fusion_tpu_torch.models import checkpoint, convert
from fusion_tpu_torch.models.crossencoder import PairRerankMixin, assemble_pair_rows
from fusion_tpu_torch.models.encoder import (
    SITE_ATTN_OUT,
    DropoutKey,
    Linear,
    QuantizedView,
    dropout,
    hf_value,
    init_weights,
    place,
    trunk_linear,
)


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 2048
    num_layers: int = 6
    num_heads: int = 8
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    gated_ffn: bool = False  # True for t5-v1.1 / mT5
    num_labels: int = 1
    pooling_mode: str = "mean"  # 'first' | 'mean' | 'max'
    dropout: float = 0.0  # the head's, train-time only
    dtype: torch.dtype = torch.float32
    # None, or 'int8': the trunk's linear layers on dynamic int8 codes, as
    # EncoderConfig.quantize
    quantize: str | None = None

    @classmethod
    def tiny(cls, **kw) -> "T5Config":
        defaults = dict(vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4)
        defaults.update(kw)
        return cls(**defaults)


def mt5_config(**kw) -> T5Config:
    """mT5 / T5 v1.1: the same architecture with the gated FFN."""
    kw.setdefault("gated_ffn", True)
    return T5Config(**kw)


class RMSNorm(nn.Module):
    """T5's scale-only norm: the f32 root mean square, cast back to the
    input's dtype, times the f32 scale (so the output is f32)."""

    def __init__(self, size: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(size))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.float().square().mean(dim=-1, keepdim=True)
        return (x.float() * torch.rsqrt(var + self.eps)).to(x.dtype) * self.weight


@functools.lru_cache(maxsize=None)
def _bucket_table(num_buckets: int, max_distance: int) -> torch.Tensor:
    """Bucket offset of every distance 0..max_distance, in f32 on the host in
    JAX's order: ``max_exact + int(log(n / max_exact + 1e-9) / log(max_distance
    / max_exact) * (half - max_exact))``, capped at ``half - 1``; exact below
    ``max_exact``.  Every farther distance takes the last entry (``half - 1``)."""
    half = num_buckets // 2
    max_exact = half // 2
    n = torch.arange(max_distance + 1, dtype=torch.int32)
    large = max_exact + (
        torch.log(n.float() / max_exact + 1e-9)
        / np.float32(np.log(max_distance / max_exact))
        * (half - max_exact)
    ).to(torch.int32)
    return torch.where(n < max_exact, n, torch.clamp(large, max=half - 1)).to(torch.int64)


def relative_position_bucket(
    relative_position: torch.Tensor, num_buckets: int = 32, max_distance: int = 128
) -> torch.Tensor:
    """T5's bidirectional relative-position bucketing (positive distances
    take the upper half of the buckets)."""
    table = _bucket_table(num_buckets, max_distance).to(relative_position.device)
    ret = (relative_position > 0).to(torch.int64) * (num_buckets // 2)
    return ret + table[relative_position.abs().clamp(max=max_distance).long()]


class T5SelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool = False):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.d_kv
        self.q = Linear(cfg.d_model, inner, bias=False)
        self.k = Linear(cfg.d_model, inner, bias=False)
        self.v = Linear(cfg.d_model, inner, bias=False)
        self.o = Linear(inner, cfg.d_model, bias=False)
        self.has_relative_bias = has_relative_bias
        if has_relative_bias:
            self.relative_attention_bias = nn.Parameter(
                torch.zeros(cfg.relative_attention_num_buckets, cfg.num_heads)
            )

    def forward(self, x, attention_mask, position_bias=None, position_ids=None, segment_ids=None):
        c = self.cfg
        x = x.to(c.dtype)
        b, t, _ = x.shape
        q, k, v = (trunk_linear(lin, x, c).view(b, t, c.num_heads, c.d_kv) for lin in (self.q, self.k, self.v))
        # unscaled, formed in the compute dtype, then cast to f32
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
        if self.has_relative_bias:
            # positions count attended slots (mid-sequence pads do not
            # stretch distances); packed rows pass per-pair positions
            if position_ids is None:
                pos = torch.cumsum(attention_mask.long(), dim=-1) - 1
            else:
                pos = position_ids.long()
            rel = pos[:, None, :] - pos[:, :, None]  # [B, T, T]: key - query
            buckets = relative_position_bucket(
                rel, c.relative_attention_num_buckets, c.relative_attention_max_distance
            )
            position_bias = self.relative_attention_bias[buckets].permute(0, 3, 1, 2)  # [B, H, T, T]
        if position_bias is not None:
            logits = logits + position_bias.float()
        allowed = attention_mask[:, None, None, :] > 0
        if segment_ids is not None:  # block-diagonal: packed pairs never attend across
            allowed = allowed & (segment_ids[:, None, None, :] == segment_ids[:, None, :, None])
        logits = logits + torch.where(allowed, 0.0, -1e9)
        probs = torch.softmax(logits, dim=-1).to(c.dtype)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, t, c.num_heads * c.d_kv)
        return trunk_linear(self.o, ctx, c), position_bias


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool = False):
        super().__init__()
        self.cfg = cfg
        self.attn_norm = RMSNorm(cfg.d_model, cfg.layer_norm_eps)
        self.attention = T5SelfAttention(cfg, has_relative_bias)
        self.ffn_norm = RMSNorm(cfg.d_model, cfg.layer_norm_eps)
        if cfg.gated_ffn:
            self.wi_0 = Linear(cfg.d_model, cfg.d_ff, bias=False)
            self.wi_1 = Linear(cfg.d_model, cfg.d_ff, bias=False)
        else:
            self.wi = Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, x, attention_mask, position_bias=None, position_ids=None, segment_ids=None):
        c = self.cfg
        attn, position_bias = self.attention(
            self.attn_norm(x), attention_mask, position_bias, position_ids, segment_ids
        )
        x = x + attn
        h = self.ffn_norm(x).to(c.dtype)
        if c.gated_ffn:
            h = F.gelu(trunk_linear(self.wi_0, h, c), approximate="tanh") * trunk_linear(self.wi_1, h, c)
        else:
            h = F.relu(trunk_linear(self.wi, h, c))
        return x + trunk_linear(self.wo, h, c), position_bias


class T5Encoder(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.blocks = nn.ModuleList(T5Block(cfg, has_relative_bias=(i == 0)) for i in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.layer_norm_eps)

    def forward(self, input_ids, attention_mask, position_ids=None, segment_ids=None) -> torch.Tensor:
        x = self.embed(input_ids).to(self.cfg.dtype)
        position_bias = None
        for block in self.blocks:
            x, position_bias = block(x, attention_mask, position_bias, position_ids, segment_ids)
        return self.final_norm(x)


def pool_tokens(hidden: torch.Tensor, attention_mask: torch.Tensor, mode: str) -> torch.Tensor:
    """first / mean / max pooling over the attended tokens."""
    m = attention_mask[..., None].to(hidden.dtype)
    if mode == "first":
        return hidden[:, 0, :]
    if mode == "max":
        return torch.where(m > 0, hidden, -1e9).max(dim=1).values
    if mode == "mean":
        return (hidden * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1e-7)
    raise ValueError(f"unknown pooling mode {mode!r}")


class T5EncoderForSequenceClassification(nn.Module):
    """Encoder → pool → dense, tanh (compute dtype) → f32 ``head_out``."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.encoder = T5Encoder(cfg)
        self.head_dense = Linear(cfg.d_model, cfg.d_model)
        self.head_out = Linear(cfg.d_model, cfg.num_labels)
        self.head_out.keep_f32 = True

    def _head(self, pooled: torch.Tensor, drop: DropoutKey | None) -> torch.Tensor:
        c = self.cfg
        h = torch.tanh(self.head_dense(pooled.to(c.dtype)))
        h = dropout(h, c.dropout, drop, c.num_layers, SITE_ATTN_OUT)
        return self.head_out(h.float())

    def forward(self, input_ids, attention_mask, drop: DropoutKey | None = None) -> torch.Tensor:
        hidden = self.encoder(input_ids, attention_mask)
        return self._head(pool_tokens(hidden, attention_mask, self.cfg.pooling_mode), drop)

    def packed(self, input_ids, attention_mask, position_ids, segment_ids, gather_row, gather_col):
        """Packed-row scoring: block-diagonal segment attention, per-pair
        positions (the relative bias sees only their differences), and each
        pair pooled over its own span — the row ``gather_row[p]`` and the
        segment id at its start slot ``gather_col[p]``.  Filler entries
        point at (0, 0); their logits land in the caller's spill slot."""
        hidden = self.encoder(input_ids, attention_mask, position_ids, segment_ids)  # [R, W, H]
        mode = self.cfg.pooling_mode
        if mode == "first":
            return self._head(hidden[gather_row, gather_col], None)
        segval = segment_ids[gather_row, gather_col]
        pairmask = (segment_ids[gather_row] == segval[:, None]) & (attention_mask[gather_row] > 0)  # [P, W]
        hrow = hidden[gather_row]
        if mode == "mean":
            m = pairmask[..., None].to(hidden.dtype)
            pooled = (hrow * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1e-7)
        elif mode == "max":
            pooled = torch.where(pairmask[..., None], hrow, -1e9).max(dim=1).values
        else:
            raise ValueError(f"unknown pooling mode {mode!r}")
        return self._head(pooled, None)


class T5CrossEncoder(QuantizedView, PairRerankMixin):
    """monoT5-style pointwise reranker over (query, doc) pairs, on an
    explicit ``device``."""

    PAIR_SPECIALS = 1  # [q | EOS | d]

    def __init__(
        self,
        cfg: T5Config,
        params: Mapping[str, torch.Tensor] | None = None,
        tokenizer=None,
        max_length: int = 256,
        seed: int = 0,
        device="cuda",
        param_dtype: torch.dtype | None = None,
    ):
        self.cfg = cfg
        self.max_length = max_length
        self.device = resolve_device(device)
        self.module = self._build_module(cfg)
        if params is None:
            init_weights(self.module, seed)
            bias = self.module.encoder.blocks[0].attention.relative_attention_bias
            with torch.no_grad():  # normal(1.0), as the JAX package's init
                bias.copy_(torch.randn(bias.shape, generator=torch.Generator().manual_seed(seed)))
        else:
            self.module.load_state_dict(params)
        place(self.module, cfg.dtype, self.device, param_dtype)
        self.tokenizer = tokenizer or WordHashTokenizer(vocab_size=cfg.vocab_size)

    @staticmethod
    def _build_module(cfg: T5Config) -> T5EncoderForSequenceClassification:
        return T5EncoderForSequenceClassification(cfg)

    @property
    def _sep_id(self) -> int:
        sep = getattr(self.tokenizer, "sep_token_id", None)
        return getattr(self.tokenizer, "eos_token_id", 1) if sep is None else sep

    def _pair_layout(self, q_ids, q_mask, d_ids, d_mask):
        """[n, Lq] + [n, Ld] → pair tokens [n, 1 + Lq + Ld] laid out
        ``[q | EOS | d]``, unattended slots holding the pad id."""
        n = q_ids.shape[0]
        col = lambda v: torch.full((n, 1), v, dtype=torch.int64, device=q_ids.device)  # noqa: E731
        ids = torch.cat([q_ids.long(), col(self._sep_id), d_ids.long()], dim=-1)
        mask = torch.cat([q_mask.long(), col(1), d_mask.long()], dim=-1)
        return torch.where(mask > 0, ids, self.tokenizer.pad_token_id), mask

    # -- scoring --------------------------------------------------------
    @torch.inference_mode()
    def score_tokens(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """Pair tokens [B, L] → f32 logits [B]."""
        return self.module(input_ids, attention_mask)[..., 0]

    def score_tokens_train(
        self, input_ids: torch.Tensor, attention_mask: torch.Tensor, drop: DropoutKey | None = None
    ) -> torch.Tensor:
        """The train-mode forward under autograd (the head's dropout drawn
        from ``drop``)."""
        return self.module(input_ids, attention_mask, drop)[..., 0]

    @torch.inference_mode()
    def packed_score_tokens(self, input_ids, attention_mask, position_ids, segment_ids, gather_row, gather_col):
        """Packed rows [R, W] → f32 logits [P] of the pairs starting at
        (gather_row, gather_col)."""
        return self.module.packed(
            input_ids, attention_mask, position_ids, segment_ids, gather_row, gather_col
        )[..., 0]

    # -- packed rows: [q | EOS | d], positions from 0 per pair -------------
    @property
    def _packed_consts(self) -> tuple:
        return (self._sep_id, self.tokenizer.pad_token_id)

    @staticmethod
    def assemble_packed_rows(desc, q_ids, drows, R: int, W: int, consts):
        """``CrossEncoder.assemble_packed_rows`` for T5's layout: pairs laid
        out ``[q | EOS | d]`` and positions restarting at 0 per pair."""
        sep_id, pad_id = consts
        return assemble_pair_rows(desc, q_ids, drows, R, W, None, sep_id, pad_id, pos_start=0, pos_pad=0)

    # -- persistence (the JAX package's t5_crossencoder format) -----------
    def save(self, path: str) -> None:
        config = {
            "model_type": "t5_crossencoder",
            "max_length": self.max_length,
            "tokenizer": tokenizer_config(self.tokenizer),
            "encoder": checkpoint.encoder_config_dict(self.cfg),
        }
        checkpoint.write(path, config, self.flax_tree(self.module.state_dict()))

    def flax_tree(self, tensors) -> dict:
        """A state dict (or gradients keyed like it) → the JAX model's tree."""
        return convert.flax_tree(self.module, self.cfg.num_heads, tensors)

    @classmethod
    def load(
        cls, path: str, tokenizer=None, device="cuda", dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype | None = None,
    ) -> "T5CrossEncoder":
        """Load a ``t5_crossencoder`` checkpoint written by either package,
        computing in ``dtype`` on ``device``."""
        config = checkpoint.read_config(path)
        if config.get("model_type") != "t5_crossencoder":
            raise ValueError(
                f"{path} holds a {config.get('model_type')!r} checkpoint, not a t5_crossencoder "
                "(use CrossEncoder.load)"
            )
        if tokenizer is None:
            tokenizer = tokenizer_from_config(config.get("tokenizer"))
        cfg = T5Config(**config["encoder"], dtype=dtype)
        return cls(
            cfg,
            params=convert.t5_crossencoder_state_dict(checkpoint.read_params(path), cfg),
            tokenizer=tokenizer,
            max_length=config["max_length"],
            device=device,
            param_dtype=param_dtype,
        )


def load_hf_t5_encoder_params(model_name_or_path: str, pooling_mode: str = "mean", num_labels: int = 1,
                              seed: int = 0) -> tuple[T5Config, dict]:
    """A local HF (m)T5 checkpoint directory → ``(T5Config, {"params":
    tree})``: the JAX package's Flax tree (f32 numpy leaves) of
    ``T5EncoderForSequenceClassification``, which
    ``convert.t5_crossencoder_state_dict`` maps onto the port's module.  Read
    by ``utils/hf_weights.py`` without ``transformers``; only the encoder's
    weights are taken (a full encoder-decoder checkpoint serves too).  The
    classification head is freshly initialized from ``seed`` (the JAX loader
    draws it from its own PRNG)."""
    from fusion_tpu_torch.utils import hf_weights

    hf = hf_weights.read_config(model_name_or_path)
    sd = hf_weights.load_state_dict(model_name_or_path)
    cfg = T5Config(
        vocab_size=hf["vocab_size"],
        d_model=hf["d_model"],
        d_kv=hf["d_kv"],
        d_ff=hf["d_ff"],
        num_layers=hf["num_layers"],
        num_heads=hf["num_heads"],
        relative_attention_num_buckets=hf.get("relative_attention_num_buckets", 32),
        relative_attention_max_distance=hf.get("relative_attention_max_distance", 128),
        gated_ffn=hf.get("feed_forward_proj", "relu").startswith("gated"),
        pooling_mode=pooling_mode,
        num_labels=num_labels,
    )

    def g(*keys):
        return hf_value(sd, *keys)

    enc: dict = {"embed": {"embedding": g("shared.weight", "encoder.embed_tokens.weight")}}
    for i in range(cfg.num_layers):
        p = f"encoder.block.{i}.layer"
        blk = {
            "attn_norm": {"scale": g(f"{p}.0.layer_norm.weight")},
            "attention": {n: {"kernel": g(f"{p}.0.SelfAttention.{n}.weight").T} for n in ("q", "k", "v", "o")},
            "ffn_norm": {"scale": g(f"{p}.1.layer_norm.weight")},
        }
        if i == 0:
            blk["attention"]["relative_attention_bias"] = g(f"{p}.0.SelfAttention.relative_attention_bias.weight")
        ffn = ("wi_0", "wi_1", "wo") if cfg.gated_ffn else ("wi", "wo")
        for n in ffn:
            blk[n] = {"kernel": g(f"{p}.1.DenseReluDense.{n}.weight").T}
        enc[f"block_{i}"] = blk
    enc["final_norm"] = {"scale": g("encoder.final_layer_norm.weight")}

    module = T5EncoderForSequenceClassification(cfg)
    init_weights(module, seed)
    fresh = convert.flax_tree(module, cfg.num_heads, module.state_dict())
    return cfg, {"params": {**fresh, "encoder": enc}}
