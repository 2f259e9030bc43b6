"""Transformer encoder trunk (CamemBERT/RoBERTa-compatible), in PyTorch.

The same trunk as ``fusion_tpu/models/encoder.py``, layer for layer:

  * the compute dtype is ``cfg.dtype`` (bf16 on the card): linear and
    embedding weights are held in it, LayerNorm weights stay f32 and every
    LayerNorm runs in f32 before casting back;
  * attention (``cfg.attention_impl``) takes JAX's three forms: ``einsum``
    accumulates and soft-maxes the logits in f32; ``einsum_bf16`` stores the
    f32-accumulated logits as bf16 and scales and biases them in bf16 before
    the f32 softmax; ``flash`` is ``ops/attention.masked_attention``, the
    hand-written kernels on the card (the forward, and under a gradient its
    residual mode and the backward kernels, through ``MaskedAttention``)
    and the ``einsum`` form's arithmetic on the CPU.  Padding is an additive -1e9 bias in every form,
    so a row with no attended key softmaxes uniformly instead of giving NaN.
    Packed rows (``segment_ids`` given) under ``einsum`` take that path too,
    where the call shows the kernel's bf16 body computes the same arithmetic
    (``packed_on_kernel``: bf16 ``q`` on the card, no gradient needed, no
    active dropout, head dim 64): it skips the key tiles between pairs and
    builds no ``[B, heads, L, L]`` tensor.  ``einsum_bf16``, f32 forwards,
    rows without segments, training and the CPU keep their form's path.  Under
    ``utils/profiling.tracing()`` each packed call counts
    ``attention.packed_kernel`` or ``attention.packed_einsum`` by the path it
    took;
  * positions count non-pad ids (RoBERTa scheme, offset past the pad index),
    read from the ids and not from the attention mask, unless the caller
    passes ``position_ids`` (the packed rerank restarts them per pair);
  * ``segment_ids`` (packed rows) make the allowed mask block-diagonal
    ``[B, 1, L, L]``: a token attends only to tokens of its own segment, and
    the −1e9 bias keeps an all-pad row finite as before;
  * GELU is exact;
  * ``cfg.quantize == "int8"`` runs the trunk's linear layers (qkv, out,
    ffn_in, ffn_out) as JAX's ``int8_dot_general`` does: per-row absmax
    codes of both operands, an int8 product accumulated in int32
    (``torch._int_mm``), an f32 rescale.  Inference only;
  * every linear layer and embedding computes in its input's (the compute)
    dtype: weights placed in that dtype serve as they are, f32 master
    weights (training, ``place(..., param_dtype=torch.float32)``) are cast
    per use, as flax's ``param_dtype`` f32 / ``dtype`` bf16 modules do, and
    their gradients reach the optimizer in f32.

Under tensor parallelism (``parallel/sharding.shard_module`` gives the
modules their ``tp_mesh``) the layers run Megatron's split: the fused qkv
holds this rank's heads and ``ffn_in`` this rank's inner columns, each
behind ``copy_to_model``; ``out`` and ``ffn_out`` are row-parallel, their
products summed over ``model`` before the replicated bias is added once;
the MLM decoder holds this rank's vocabulary columns.

Serving runs the forward under ``torch.inference_mode`` in the models that
use these modules.  Training passes a ``DropoutKey`` (dropout at the JAX
package's four einsum-attention sites, each mask drawn from a generator
seeded by ``(seed, step, stream, layer, site)``) and, with ``cfg.remat``,
recomputes each layer in the backward pass (``torch.utils.checkpoint``):
the recompute reseeds the same generators, so it draws the masks of the
first forward.  ``models/convert.py`` maps a Flax parameter tree onto these
modules, and ``config_view`` rebuilds a model's module under another config
(the models' ``with_attention`` / ``quantized``) holding the same
parameters.

One difference from the JAX package is stated: its ``flash`` runs the Pallas
kernel only on a TPU and at a sequence length that is a multiple of 128, and
falls back to ``einsum`` otherwise.  Those two are TPU tiling rules, so the
port's ``flash`` runs at any length on any device (a ragged edge tile in the
kernels); with active dropout it computes the ``einsum`` form, as JAX's
does.  Its kernels on the card take a head dim of 64.  Without dropout a
gradient through ``flash`` runs the forward kernel in residual mode and the
backward kernels (dK/dV and dQ, as JAX's Pallas backward), and the q, k, v
gradients reach the fused qkv projection as one contiguous buffer
(``ops/attention.split_qkv``); under remat the recompute runs the forward
kernel once more.
"""

from __future__ import annotations

import copy
import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from fusion_tpu_torch.core.device import resolve_device
from fusion_tpu_torch.ops.attention import (
    HEAD_DIM,
    allowed_keys,
    kernel_masks,
    masked_attention,
    split_qkv,
)
from fusion_tpu_torch.parallel.sharding import copy_to_model, reduce_from_model
from fusion_tpu_torch.utils.profiling import count


ATTENTION_IMPLS = ("einsum", "einsum_bf16", "flash")


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
    # 'einsum' (f32 logits), 'einsum_bf16' (bf16-stored logits, ~0.4 %
    # softmax error) or 'flash' (the masked-attention kernel)
    attention_impl: str = "einsum"
    # None, or 'int8': the trunk's linear layers on dynamic int8 codes
    # (serving only: round() has no gradient)
    quantize: str | None = None

    def __post_init__(self):
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl must be one of {ATTENTION_IMPLS}, got {self.attention_impl!r}")
        if self.quantize not in (None, "int8"):
            raise ValueError(f"quantize must be None or 'int8', got {self.quantize!r}")

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

    @classmethod
    def camembert_base(cls, **kw) -> "EncoderConfig":
        """CamemBERT-base (the defaults), with ``kw`` changed."""
        return cls(**kw)


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
    forwards of one step (query, positive and negative batches).

    ``data`` and ``model`` are this rank's (coordinate, size) on the mesh
    axes of a parallel step: a mask is drawn at the global shape (every
    rank's rows; every head for the attention probabilities) and the rank
    keeps its own rows and heads, so a parallel step draws the masks of the
    one-device step over the global batch."""

    seed: int
    step: int
    stream: int = 0
    data: tuple[int, int] = (0, 1)
    model: tuple[int, int] = (0, 1)

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
    shape, (row, rows), (head, heads) = list(x.shape), key.data, key.model
    heads = heads if site == SITE_ATTN_PROBS else 1  # only the probabilities [B, heads, L, L] split by heads
    shape[0] *= rows
    if heads > 1:
        shape[1] *= heads
    u = torch.rand(shape, generator=key.generator(x.device, layer, site), device=x.device)
    u = u.narrow(0, row * x.shape[0], x.shape[0])
    if heads > 1:
        u = u.narrow(1, head * x.shape[1], x.shape[1])
    return torch.where(u >= rate, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class Linear(nn.Linear):
    """``nn.Linear`` computing in its input's dtype (a no-op cast when the
    weights are already in it)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


def int8_codes(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 codes of each row of ``x`` [..., K]: the row's absmax
    (in f32, floored at 1e-12) and ``round(x / absmax * 127)``, in JAX's
    order of operations, so the codes equal ``int8_dot_general``'s bit for
    bit → (codes int8 [..., K], absmax f32 [..., 1])."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12)
    return torch.round(xf / scale * 127.0).to(torch.int8), scale


# cuBLAS's int8 product (torch._int_mm) takes more than 16 rows: fewer are
# padded with zero rows, whose products are dropped
_INT_MM_MIN_ROWS = 17


def int8_linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    """``x @ weight.T + bias`` as JAX's ``int8_dot_general`` computes it:
    per-row codes of ``x`` and per-output-row codes of ``weight`` (both in
    ``x``'s dtype first, as flax promotes them), an int8 × int8 product
    accumulated in int32, and an f32 rescale by ``s_x · s_w / 127²``, cast
    to ``x``'s dtype before the bias is added."""
    k = x.shape[-1]
    xq, xs = int8_codes(x.reshape(-1, k))
    wq, ws = int8_codes(weight.to(x.dtype))
    rows = xq.shape[0]
    if rows < _INT_MM_MIN_ROWS:
        xq = F.pad(xq, (0, 0, 0, _INT_MM_MIN_ROWS - rows))
    acc = torch._int_mm(xq, wq.T)[:rows]
    out = (acc.float() * (xs * ws.view(1, -1) / (127.0 * 127.0))).to(x.dtype)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out.view(*x.shape[:-1], weight.shape[0])


def trunk_linear(layer: nn.Linear, x: torch.Tensor, cfg) -> torch.Tensor:
    """A trunk linear layer under ``cfg.quantize``: the int8 product, or the
    layer's own forward."""
    if cfg.quantize == "int8":
        return int8_linear(x, layer.weight, layer.bias)
    return layer(x)


def packed_on_kernel(q, k, v, cfg, drop: DropoutKey | None) -> bool:
    """Whether packed rows' attention (``segment_ids`` given) in the
    ``einsum`` form goes to ``masked_attention`` as the ``flash`` form's
    does, from what the call shows it computes there: the kernel's bf16 body
    (f32 logits of the bf16 q, k, the f32 -1e9 bias, an f32 softmax, P in
    bf16), with ``q`` on the card, no gradient needed, no active dropout and
    a head dim of 64.  The kernel skips the key tiles between pairs, where
    the ``einsum`` chain builds and passes over every row's ``[heads, L,
    L]`` f32 logits six times."""
    return (
        cfg.attention_impl == "einsum"
        and q.is_cuda
        and q.dtype == torch.bfloat16
        and q.shape[-1] == HEAD_DIM
        and (drop is None or cfg.dropout == 0.0)
        and not (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)))
    )


def attention(
    q, k, v, attention_mask: torch.Tensor, segment_ids: torch.Tensor | None, cfg,
    drop: DropoutKey | None = None, layer: int = 0,
) -> torch.Tensor:
    """Scaled dot-product attention of ``q``, ``k``, ``v`` [B, L, heads, hd]
    in the form ``cfg.attention_impl`` names, over the keys ``allowed_keys``
    gives for ``attention_mask`` and ``segment_ids`` → context [B, L, heads,
    hd].  Dropout (site ``SITE_ATTN_PROBS`` of ``layer``) falls on the
    probabilities; ``flash`` with active dropout computes the ``einsum``
    form.  ``flash`` runs ``masked_attention``, and so do packed ``einsum``
    rows where ``packed_on_kernel`` says so; under tracing each packed call
    counts ``attention.packed_kernel`` or ``attention.packed_einsum`` by
    the path it took."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    impl = cfg.attention_impl
    flash = impl == "flash" and (drop is None or cfg.dropout == 0.0)
    if segment_ids is not None:
        flash = flash or packed_on_kernel(q, k, v, cfg, drop)
        count("attention.packed_kernel" if flash and q.is_cuda else "attention.packed_einsum")
    if flash:
        return masked_attention(q, k, v, attention_mask, segment_ids, scale)
    allowed = allowed_keys(attention_mask, segment_ids)
    if impl == "einsum_bf16":
        # stored as bf16 after an f32 accumulation (a bf16 product's own
        # output), then scaled and biased in bf16
        if q.dtype == torch.bfloat16:
            logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        else:
            logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()).to(torch.bfloat16)
        bias = torch.where(allowed, 0.0, -1e9).to(torch.bfloat16)
        z = logits * scale + bias
        # softmax of a bf16 input computes in f32 and rounds once to bf16:
        # the f32 softmax cast to a bf16 cfg.dtype, without its f32 buffer
        if cfg.dtype == torch.bfloat16:
            probs = torch.softmax(z, dim=-1)
        else:
            probs = torch.softmax(z.float(), dim=-1).to(cfg.dtype)
    else:
        # f32 logits from the compute-dtype projections, as the JAX einsum
        # with preferred_element_type=f32 gives them
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
        bias = torch.where(allowed, 0.0, -1e9).to(torch.float32)
        probs = torch.softmax(logits + bias, dim=-1).to(cfg.dtype)
    probs = dropout(probs, cfg.dropout, drop, layer, SITE_ATTN_PROBS)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


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


def row_parallel(layer: nn.Linear, x: torch.Tensor, cfg, mesh) -> torch.Tensor:
    """A row-parallel linear layer under ``model > 1``: this rank's part of
    the product, summed over ``model``, then the (replicated) bias added once;
    the layer itself on one rank."""
    if mesh is None:
        return trunk_linear(layer, x, cfg)
    out = reduce_from_model(F.linear(x, layer.weight.to(x.dtype)), mesh)
    return out + layer.bias.to(x.dtype)


class SelfAttention(nn.Module):
    # the mesh of tensor parallelism (parallel/sharding.shard_module): the
    # fused qkv holds this rank's heads, ``out`` is row-parallel
    tp_mesh = None

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
        hd = h // c.num_heads
        heads = self.qkv.weight.shape[0] // (3 * hd)  # this rank's heads
        qkv = trunk_linear(self.qkv, copy_to_model(x, self.tp_mesh), c).view(b, length, 3, heads, hd)
        q, k, v = split_qkv(qkv)  # [B, L, heads, hd]
        # segments make the allowed keys block-diagonal: pairs packed into
        # one row never attend across
        ctx = attention(q, k, v, attention_mask, segment_ids, c, drop, layer)
        return row_parallel(self.out, ctx.reshape(b, length, heads * hd), c, self.tp_mesh)


class TransformerLayer(nn.Module):
    tp_mesh = None  # ffn_in column-parallel, ffn_out row-parallel under model > 1

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
        inner = F.gelu(trunk_linear(self.ffn_in, copy_to_model(x, self.tp_mesh), c), approximate="none")
        h = row_parallel(self.ffn_out, inner, c, self.tp_mesh)
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
        if segment_ids is not None:  # packed rows: the kernel's masks, made once for every layer
            attention_mask, segment_ids = kernel_masks(attention_mask, segment_ids)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:  # the masks come from seeded generators, not the global RNG state
                x = checkpoint(layer, x, attention_mask, segment_ids, drop, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = layer(x, attention_mask, segment_ids, drop)
        return x


class MLMHead(nn.Module):
    """Masked-LM head: dense → gelu → LN → vocab projection (SPLADE input).
    Under ``model > 1`` the decoder is column-parallel: the logits are this
    rank's vocabulary columns."""

    tp_mesh = None

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.transform = Linear(cfg.hidden_size, cfg.hidden_size)
        self.ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.decoder = Linear(cfg.hidden_size, cfg.vocab_size)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        h = F.gelu(self.transform(hidden), approximate="none")
        return self.decoder(copy_to_model(self.ln(h).to(self.cfg.dtype), self.tp_mesh))


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
        elif hasattr(m, "reset_parameters_from"):  # X-MOD's stacked adapters
            m.reset_parameters_from(gen)


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


def config_view(model, build, **changes):
    """A shallow copy of ``model`` whose ``cfg`` takes ``changes`` and whose
    ``module`` is ``build(cfg)`` holding the original's parameter tensors
    themselves, not copies (built on the meta device, so no weights are
    allocated): the models' serving views."""
    out = copy.copy(model)
    out.cfg = dataclasses.replace(model.cfg, **changes)
    with torch.device("meta"):
        out.module = build(out.cfg)
    out.module.load_state_dict(model.module.state_dict(), assign=True)
    out.module.train(model.module.training)
    for old, new in zip(model.module.modules(), out.module.modules()):
        if hasattr(old, "lang_idx"):  # an X-MOD trunk keeps its pinned language
            new.lang_idx = old.lang_idx
    return out


class QuantizedView:
    """``quantized`` for a model with ``cfg``, ``module`` and
    ``_build_module(cfg)``: a view that shares the model's parameters and
    tokenizer."""

    def quantized(self, mode: str = "int8"):
        """Serving view whose trunk linear layers run on dynamic int8 codes
        (``int8_linear``); inference only."""
        return config_view(self, self._build_module, quantize=mode)


class EncoderViews(QuantizedView):
    """``quantized`` and ``with_attention`` views (see ``QuantizedView``)."""

    def with_attention(self, impl: str):
        """Serving view with another attention form (``einsum``,
        ``einsum_bf16`` or ``flash``); the model itself if it has it."""
        if impl == self.cfg.attention_impl:
            return self
        return config_view(self, self._build_module, attention_impl=impl)


def init_encoder_params(
    cfg: EncoderConfig, seed: int = 0, with_mlm: bool = True, device="cuda"
) -> nn.Module:
    """Random-init encoder (with the MLM head when ``with_mlm``) on ``device``."""
    model = EncoderWithMLM(cfg) if with_mlm else Encoder(cfg)
    init_weights(model, seed)
    return place(model, cfg.dtype, resolve_device(device))


# ----------------------------------------------------------------------
# HF checkpoint import (host side, without transformers) and old layouts
# ----------------------------------------------------------------------
def hf_value(sd: dict, *keys: str) -> np.ndarray:
    """The first of ``keys`` that ``sd`` holds, as f32 numpy (tied weights
    are saved under one of their names)."""
    for key in keys:
        if key in sd:
            return sd[key].detach().to(torch.float32).cpu().numpy()
    raise KeyError(f"the checkpoint holds none of {keys}")


def hf_trunk_tree(g, h: int, heads: int, num_layers: int) -> dict:
    """The Flax ``Encoder`` tree of an HF BERT-family trunk whose f32 weight
    of name ``key`` (without the model prefix) is ``g(key)``: embeddings, and
    per layer the separate q / k / v projections stacked into the fused
    ``[H, 3, heads, hd]`` kernel (axis 1 = q, k, v)."""
    hd = h // heads

    def qkv(lp):
        names = ("query", "key", "value")
        kernels = [g(f"{lp}.attention.self.{n}.weight").T.reshape(h, heads, hd) for n in names]
        biases = [g(f"{lp}.attention.self.{n}.bias").reshape(heads, hd) for n in names]
        return {"kernel": np.stack(kernels, axis=1), "bias": np.stack(biases, axis=0)}

    def ln(prefix):
        return {"scale": g(f"{prefix}.weight"), "bias": g(f"{prefix}.bias")}

    tree: dict = {"embeddings": {
        "word": {"embedding": g("embeddings.word_embeddings.weight")},
        "position": {"embedding": g("embeddings.position_embeddings.weight")},
        "token_type": {"embedding": g("embeddings.token_type_embeddings.weight")},
        "ln": ln("embeddings.LayerNorm"),
    }}
    for i in range(num_layers):
        lp = f"encoder.layer.{i}"
        tree[f"layer_{i}"] = {
            "attention": {
                "qkv": qkv(lp),
                "out": {"kernel": g(f"{lp}.attention.output.dense.weight").T.reshape(heads, hd, h),
                        "bias": g(f"{lp}.attention.output.dense.bias")},
            },
            "attn_ln": ln(f"{lp}.attention.output.LayerNorm"),
            "ffn_in": {"kernel": g(f"{lp}.intermediate.dense.weight").T, "bias": g(f"{lp}.intermediate.dense.bias")},
            "ffn_out": {"kernel": g(f"{lp}.output.dense.weight").T, "bias": g(f"{lp}.output.dense.bias")},
            "ffn_ln": ln(f"{lp}.output.LayerNorm"),
        }
    return tree


def hf_mlm_tree(sd: dict, word_embeddings: np.ndarray, roberta: bool) -> dict:
    """The Flax ``MLMHead`` tree of an HF masked-LM head (``lm_head.*`` or
    BERT's ``cls.predictions.*``); the decoder is tied to the word
    embeddings."""
    if roberta:
        return {
            "transform": {"kernel": hf_value(sd, "lm_head.dense.weight").T, "bias": hf_value(sd, "lm_head.dense.bias")},
            "ln": {"scale": hf_value(sd, "lm_head.layer_norm.weight"), "bias": hf_value(sd, "lm_head.layer_norm.bias")},
            "decoder": {"kernel": word_embeddings.T, "bias": hf_value(sd, "lm_head.bias", "lm_head.decoder.bias")},
        }
    head = "cls.predictions"
    return {
        "transform": {"kernel": hf_value(sd, f"{head}.transform.dense.weight").T,
                      "bias": hf_value(sd, f"{head}.transform.dense.bias")},
        "ln": {"scale": hf_value(sd, f"{head}.transform.LayerNorm.weight"),
               "bias": hf_value(sd, f"{head}.transform.LayerNorm.bias")},
        "decoder": {"kernel": word_embeddings.T, "bias": hf_value(sd, f"{head}.bias", f"{head}.decoder.bias")},
    }


def hf_model_prefix(sd: dict) -> str:
    """The name prefix of a checkpoint's trunk: ``roberta.`` or ``bert.``
    for a task model (masked LM), none for a bare trunk."""
    for prefix in ("roberta.", "bert."):
        if any(k.startswith(prefix) for k in sd):
            return prefix
    return ""


def load_hf_encoder_params(model_name_or_path: str, dtype: torch.dtype = torch.float32) -> tuple[EncoderConfig, dict]:
    """An HF masked-LM checkpoint directory → ``(EncoderConfig, {"params":
    {"encoder", "mlm"}})``: the JAX package's Flax tree (f32 numpy leaves),
    which ``models/convert.py`` maps onto the port's modules.  The
    roberta / camembert / xlm-roberta and the bert naming schemes (a bert
    ``model_type`` takes absolute positions, ``position_offset=0``), task
    checkpoints (``roberta.`` / ``bert.`` names) and bare trunks; dropout is
    0, as the JAX loader sets it.  Read by ``utils/hf_weights.py``: no
    ``transformers``, no hub.  A trunk without an LM head gives no ``mlm``
    subtree (the JAX loader, through ``AutoModelForMaskedLM``, draws one
    at random)."""
    from fusion_tpu_torch.utils import hf_weights

    hf = hf_weights.read_config(model_name_or_path)
    sd = hf_weights.load_state_dict(model_name_or_path)
    roberta = hf.get("model_type", "roberta") != "bert"
    prefix = hf_model_prefix(sd)
    vocab = hf["vocab_size"]
    cfg = EncoderConfig(
        vocab_size=vocab,
        hidden_size=hf["hidden_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        intermediate_size=hf["intermediate_size"],
        max_position=hf["max_position_embeddings"],
        type_vocab_size=hf.get("type_vocab_size", 2),  # the HF configs' defaults where a key is missing
        pad_token_id=hf["pad_token_id"] if hf.get("pad_token_id") is not None else 1,
        mask_token_id=hf.get("mask_token_id") or vocab - 1,
        layer_norm_eps=hf.get("layer_norm_eps", 1e-12),
        position_offset=2 if roberta else 0,
        dropout=0.0,
        dtype=dtype,
    )
    encoder = hf_trunk_tree(lambda key: hf_value(sd, prefix + key), cfg.hidden_size, cfg.num_heads, cfg.num_layers)
    params = {"encoder": encoder}
    head_keys = ("lm_head.dense.weight",) if roberta else ("cls.predictions.transform.dense.weight",)
    if head_keys[0] in sd:
        params["mlm"] = hf_mlm_tree(sd, encoder["embeddings"]["word"]["embedding"], roberta)
    return cfg, {"params": params}


def migrate_pre_qkv_params(tree):
    """Convert a param tree with separate attention query/key/value
    projections to the fused layout (qkv kernel ``[H, 3, heads, hd]``), so
    checkpoints saved before the fusion load unchanged.  No-op on fused
    trees."""

    def host(x) -> np.ndarray:
        return x.to(torch.float32).numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    def convert(d):
        if not isinstance(d, dict):
            return d
        if "attention" in d and isinstance(d["attention"], dict) and "query" in d["attention"]:
            att = dict(d["attention"])
            qkv = {
                "kernel": np.stack([host(att[n]["kernel"]) for n in ("query", "key", "value")], axis=1),
                "bias": np.stack([host(att[n]["bias"]) for n in ("query", "key", "value")], axis=0),
            }
            for n in ("query", "key", "value"):
                att.pop(n)
            att["qkv"] = qkv
            d = {**d, "attention": att}
        return {k: convert(v) for k, v in d.items()}

    return convert(tree)


def restore_params_bytes(target: nn.Module, blob: bytes) -> nn.Module:
    """flax ``from_bytes`` with pre-QKV checkpoint migration: the Flax
    msgpack ``blob`` (a model's variables as ``flax.serialization.to_bytes``
    writes them) loaded into the parameters of ``target`` (an encoder
    module, or a model's module around one), which it returns."""
    from fusion_tpu_torch.models import convert
    from fusion_tpu_torch.utils import flax_msgpack

    raw = migrate_pre_qkv_params(flax_msgpack.unpackb(blob))
    heads = next(m.cfg.num_heads for m in target.modules() if hasattr(getattr(m, "cfg", None), "num_heads"))
    target.load_state_dict(convert.state_dict_from_flax(target, heads, raw))
    return target
