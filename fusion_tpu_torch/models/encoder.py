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
  * GELU is exact;
  * every linear layer and embedding computes in its input's (the compute)
    dtype: weights placed in that dtype serve as they are, f32 master
    weights (training, ``place(..., param_dtype=torch.float32)``) are cast
    per use, as flax's ``param_dtype`` f32 / ``dtype`` bf16 modules do, and
    their gradients reach the optimizer in f32.

Serving runs the forward under ``torch.inference_mode`` in the models that
use these modules.  Training passes a ``DropoutKey`` (dropout at the JAX
package's four einsum-attention sites, each mask drawn from a generator
seeded by ``(seed, step, stream, layer, site)``) and, with ``cfg.remat``,
recomputes each layer in the backward pass (``torch.utils.checkpoint``):
the recompute reseeds the same generators, so it draws the masks of the
first forward.  ``models/convert.py`` maps a Flax parameter tree onto these
modules.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

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
    # train-time only: a forward without a DropoutKey applies none
    dropout: float = 0.1
    dtype: torch.dtype = torch.float32
    # recompute each transformer layer in the backward pass (train-time:
    # trades a forward's FLOPs for activation memory)
    remat: bool = False

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


# dropout sites of the einsum attention, as in fusion_tpu/models/encoder.py
SITE_EMBEDDINGS, SITE_ATTN_PROBS, SITE_ATTN_OUT, SITE_FFN_OUT = range(4)


@dataclasses.dataclass(frozen=True)
class DropoutKey:
    """Where a train-mode forward draws its dropout masks: one generator per
    ``(seed, step, stream, layer, site)``, so a resumed run and a remat
    recompute draw the masks they drew before.  ``stream`` tells apart the
    forwards of one step (query, positive and negative batches)."""

    seed: int
    step: int
    stream: int = 0

    def generator(self, device, layer: int, site: int) -> torch.Generator:
        entropy = [self.seed, self.step, self.stream, layer + 1, site]
        state = np.random.SeedSequence(entropy).generate_state(2, np.uint64)[0]
        return torch.Generator(device=device).manual_seed(int(state) & ((1 << 63) - 1))


def dropout(x: torch.Tensor, rate: float, key: DropoutKey | None, layer: int, site: int) -> torch.Tensor:
    """flax's ``nn.Dropout``: keep with probability ``1 - rate`` and scale the
    kept values by ``1 / (1 - rate)``, in ``x``'s dtype; the identity
    without a key or at rate 0."""
    if key is None or rate == 0.0:
        return x
    u = torch.rand(x.shape, generator=key.generator(x.device, layer, site), device=x.device)
    return torch.where(u >= rate, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class Linear(nn.Linear):
    """``nn.Linear`` computing in its input's dtype (a no-op cast when the
    weights are already in it)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


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

    def forward(
        self, input_ids: torch.Tensor, position_ids: torch.Tensor | None = None, drop: DropoutKey | None = None
    ) -> torch.Tensor:
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
            self.word(input_ids).to(c.dtype)
            + self.position(pos_ids).to(c.dtype)
            + self.token_type(torch.zeros_like(input_ids)).to(c.dtype)
        )
        return dropout(self.ln(x), c.dropout, drop, -1, SITE_EMBEDDINGS).to(c.dtype)


class SelfAttention(nn.Module):
    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        # fused QKV: output features ordered [3, heads, head_dim]
        self.qkv = Linear(cfg.hidden_size, 3 * cfg.hidden_size)
        self.out = Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(
        self,
        x: torch.Tensor,
        attention_mask: torch.Tensor,
        segment_ids: torch.Tensor | None = None,
        drop: DropoutKey | None = None,
        layer: int = 0,
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
        probs = dropout(probs, c.dropout, drop, layer, SITE_ATTN_PROBS)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return self.out(ctx.reshape(b, length, h))


class TransformerLayer(nn.Module):
    def __init__(self, cfg: EncoderConfig, index: int = 0):
        super().__init__()
        self.cfg = cfg
        self.index = index  # the layer's place in its trunk: part of its dropout seeds
        self.attention = SelfAttention(cfg)
        self.attn_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.ffn_in = Linear(cfg.hidden_size, cfg.intermediate_size)
        self.ffn_out = Linear(cfg.intermediate_size, cfg.hidden_size)
        self.ffn_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(
        self,
        x: torch.Tensor,
        attention_mask: torch.Tensor,
        segment_ids: torch.Tensor | None = None,
        drop: DropoutKey | None = None,
    ) -> torch.Tensor:
        c, i = self.cfg, self.index
        attn = self.attention(x, attention_mask, segment_ids, drop, i)
        x = self.attn_ln(x + dropout(attn, c.dropout, drop, i, SITE_ATTN_OUT)).to(c.dtype)
        h = self.ffn_out(F.gelu(self.ffn_in(x), approximate="none"))
        return self.ffn_ln(x + dropout(h, c.dropout, drop, i, SITE_FFN_OUT)).to(c.dtype)


class Encoder(nn.Module):
    """Embedding + N transformer layers → last hidden states."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = Embeddings(cfg)
        self.layers = nn.ModuleList(TransformerLayer(cfg, i) for i in range(cfg.num_layers))

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        position_ids: torch.Tensor | None = None,
        segment_ids: torch.Tensor | None = None,
        drop: DropoutKey | None = None,
    ) -> torch.Tensor:
        x = self.embeddings(input_ids, position_ids, drop)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:  # the masks come from seeded generators, not the global RNG state
                x = checkpoint(layer, x, attention_mask, segment_ids, drop, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = layer(x, attention_mask, segment_ids, drop)
        return x


class MLMHead(nn.Module):
    """Masked-LM head: dense → gelu → LN → vocab projection (SPLADE input)."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.transform = Linear(cfg.hidden_size, cfg.hidden_size)
        self.ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.decoder = Linear(cfg.hidden_size, cfg.vocab_size)

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
        self, input_ids: torch.Tensor, attention_mask: torch.Tensor, drop: DropoutKey | None = None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        hidden = self.encoder(input_ids, attention_mask, drop=drop)
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


def place(module: nn.Module, dtype: torch.dtype, device, param_dtype: torch.dtype | None = None) -> nn.Module:
    """Move to ``device`` in eval mode; linear and embedding weights take
    ``param_dtype`` (default: the compute dtype, the serving placement; f32
    for training's master weights), LayerNorm weights stay f32, and so does
    a layer marked ``keep_f32`` (the cross-encoder's classifier)."""
    module.to(device).eval()
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Embedding)) and not getattr(m, "keep_f32", False):
            m.to(param_dtype or dtype)
    return module


def init_encoder_params(
    cfg: EncoderConfig, seed: int = 0, with_mlm: bool = True, device="cuda"
) -> nn.Module:
    """Random-init encoder (with the MLM head when ``with_mlm``) on ``device``."""
    model = EncoderWithMLM(cfg) if with_mlm else Encoder(cfg)
    init_weights(model, seed)
    return place(model, cfg.dtype, resolve_device(device))
