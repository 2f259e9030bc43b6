"""Transformer encoder trunk (CamemBERT/RoBERTa-compatible), in PyTorch.

The same trunk as ``fusion_tpu/models/encoder.py``, layer for layer:

  * the compute dtype is ``cfg.dtype`` (bf16 on the card): linear and
    embedding weights are held in it, LayerNorm weights stay f32 and every
    LayerNorm runs in f32 before casting back;
  * attention logits are accumulated and soft-maxed in f32, and padding is an
    additive -1e9 bias, so a row with no attended key softmaxes uniformly
    instead of giving NaN;
  * positions count non-pad ids (RoBERTa scheme, offset past the pad index),
    read from the ids and not from the attention mask, unless the caller
    passes ``position_ids`` (the packed rerank restarts them per pair);
  * ``segment_ids`` (packed rows) make the allowed mask block-diagonal
    ``[B, 1, L, L]``: a token attends only to tokens of its own segment, and
    the −1e9 bias keeps an all-pad row finite as before;
  * GELU is exact.

The port serves inference only: modules are built in eval mode and the
forward passes run under ``torch.inference_mode`` in the models that use
them.  ``models/convert.py`` maps a Flax parameter tree onto these modules.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fusion_tpu_torch.core.device import resolve_device


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 32005
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 514
    type_vocab_size: int = 1
    pad_token_id: int = 1
    mask_token_id: int = 32004
    layer_norm_eps: float = 1e-5
    # RoBERTa-style position ids start at pad_token_id + 1; 0 = BERT absolute
    position_offset: int = 2
    # train-time only: the port runs inference, where dropout is the identity
    dropout: float = 0.1
    dtype: torch.dtype = torch.float32

    @classmethod
    def tiny(cls, vocab_size: int = 128, **kw) -> "EncoderConfig":
        """Small config for tests/dry-runs."""
        defaults = dict(
            vocab_size=vocab_size,
            hidden_size=32,
            num_layers=2,
            num_heads=4,
            intermediate_size=64,
            max_position=66,
            pad_token_id=1,
            mask_token_id=vocab_size - 1,
            dropout=0.0,
        )
        defaults.update(kw)
        return cls(**defaults)


def roberta_position_ids(input_ids: torch.Tensor, pad_token_id: int) -> torch.Tensor:
    """Positions count non-pad tokens, offset past the pad index."""
    mask = (input_ids != pad_token_id).to(torch.int64)
    return torch.cumsum(mask, dim=-1) * mask + pad_token_id


class LayerNorm(nn.Module):
    """LayerNorm with f32 weights that normalizes in f32 (the caller casts)."""

    def __init__(self, size: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(size))
        self.bias = nn.Parameter(torch.zeros(size))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias, self.eps)


class Embeddings(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.word = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position = nn.Embedding(cfg.max_position, cfg.hidden_size)
        self.token_type = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size)
        self.ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor, position_ids: torch.Tensor | None = None) -> torch.Tensor:
        c = self.cfg
        if position_ids is not None:
            pos_ids = position_ids
        elif c.position_offset:
            pos_ids = roberta_position_ids(input_ids, c.pad_token_id)
        else:
            pos_ids = torch.arange(input_ids.shape[-1], device=input_ids.device).expand_as(
                input_ids
            )
        x = (
            self.word(input_ids)
            + self.position(pos_ids)
            + self.token_type(torch.zeros_like(input_ids))
        )
        return self.ln(x).to(c.dtype)


class SelfAttention(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        # fused QKV: output features ordered [3, heads, head_dim]
        self.qkv = nn.Linear(cfg.hidden_size, 3 * cfg.hidden_size)
        self.out = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(
        self, x: torch.Tensor, attention_mask: torch.Tensor, segment_ids: torch.Tensor | None = None
    ) -> torch.Tensor:
        c = self.cfg
        b, length, h = x.shape
        head_dim = h // c.num_heads
        qkv = self.qkv(x).view(b, length, 3, c.num_heads, head_dim)
        q, k, v = qkv.unbind(dim=2)  # [B, L, heads, hd]
        # f32 logits from the compute-dtype projections, as the JAX einsum
        # with preferred_element_type=f32 gives them
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(head_dim)
        if segment_ids is None:
            allowed = attention_mask[:, None, None, :] > 0
        else:  # block-diagonal: pairs packed into one row never attend across
            allowed = (
                (segment_ids[:, None, :] == segment_ids[:, :, None]) & (attention_mask[:, None, :] > 0)
            )[:, None]
        bias = torch.where(allowed, 0.0, -1e9).to(torch.float32)
        probs = torch.softmax(logits + bias, dim=-1).to(c.dtype)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return self.out(ctx.reshape(b, length, h))


class TransformerLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.attention = SelfAttention(cfg)
        self.attn_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.ffn_in = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.ffn_out = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.ffn_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(
        self, x: torch.Tensor, attention_mask: torch.Tensor, segment_ids: torch.Tensor | None = None
    ) -> torch.Tensor:
        dtype = self.cfg.dtype
        x = self.attn_ln(x + self.attention(x, attention_mask, segment_ids)).to(dtype)
        h = self.ffn_out(F.gelu(self.ffn_in(x), approximate="none"))
        return self.ffn_ln(x + h).to(dtype)


class Encoder(nn.Module):
    """Embedding + N transformer layers → last hidden states."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = Embeddings(cfg)
        self.layers = nn.ModuleList(TransformerLayer(cfg) for _ in range(cfg.num_layers))

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        position_ids: torch.Tensor | None = None,
        segment_ids: torch.Tensor | None = None,
    ) -> torch.Tensor:
        x = self.embeddings(input_ids, position_ids)
        for layer in self.layers:
            x = layer(x, attention_mask, segment_ids)
        return x


class MLMHead(nn.Module):
    """Masked-LM head: dense → gelu → LN → vocab projection (SPLADE input)."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.transform = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.decoder = nn.Linear(cfg.hidden_size, cfg.vocab_size)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        h = F.gelu(self.transform(hidden), approximate="none")
        return self.decoder(self.ln(h).to(self.cfg.dtype))


class EncoderWithMLM(nn.Module):
    """Encoder trunk + MLM head, returning (hidden, logits)."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.encoder = Encoder(cfg)
        self.mlm = MLMHead(cfg)

    def forward(
        self, input_ids: torch.Tensor, attention_mask: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        hidden = self.encoder(input_ids, attention_mask)
        return hidden, self.mlm(hidden)


def token_tensors(ids: np.ndarray, mask: np.ndarray, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Host token arrays → (int64 ids, int32 mask) on ``device``."""
    return (
        torch.as_tensor(np.asarray(ids, dtype=np.int64), device=device),
        torch.as_tensor(np.asarray(mask, dtype=np.int32), device=device),
    )


def init_weights(module: nn.Module, seed: int) -> None:
    """Seeded random init on the host (normal(0, 0.02) weights, zero biases,
    unit LayerNorm), so a seed gives the same weights on any device."""
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Embedding)):
            with torch.no_grad():
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * 0.02)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()


def place(module: nn.Module, dtype: torch.dtype, device) -> nn.Module:
    """Move to ``device`` in eval mode; linear and embedding weights take the
    compute dtype, LayerNorm weights stay f32, and so does a layer marked
    ``keep_f32`` (the cross-encoder's classifier)."""
    module.to(device).eval()
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Embedding)) and not getattr(m, "keep_f32", False):
            m.to(dtype)
    return module


def init_encoder_params(
    cfg: EncoderConfig, seed: int = 0, with_mlm: bool = True, device="cuda"
) -> nn.Module:
    """Random-init encoder (with the MLM head when ``with_mlm``) on ``device``."""
    model = EncoderWithMLM(cfg) if with_mlm else Encoder(cfg)
    init_weights(model, seed)
    return place(model, cfg.dtype, resolve_device(device))
