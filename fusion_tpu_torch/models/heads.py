"""Retrieval heads over the shared encoder trunk.

  * ``pool``              — mean/max/cls sentence pooling (DPR)
  * ``splade_activation`` — log1p(relu(logits)) masked, max- or sum-pooled
  * ``prune_topk``        — keep the top-k activations per row
  * ``ColBERTHead``       — per-token projection + L2 norm (late interaction)
  * ``CrossEncoderHead``  — CLS → pooler dense → tanh → f32 classifier logit
                            (monoBERT)
  * ``pairwise_similarity`` / ``batchwise_similarity`` — the training
                            losses' row-aligned and all-pairs scores

Each computes in the dtype of its input, as ``fusion_tpu/models/heads.py``.
"""

from __future__ import annotations

import torch
from torch import nn

from fusion_tpu_torch.core.ranked import stable_topk
from fusion_tpu_torch.models.encoder import Linear

SIMILARITIES = ("cos_sim", "dot_score")


def pool(hidden: torch.Tensor, attention_mask: torch.Tensor, mode: str = "mean") -> torch.Tensor:
    """Sentence embedding from token states. hidden [B,T,H], mask [B,T]."""
    m = attention_mask[..., None].to(hidden.dtype)
    if mode == "mean":
        return (hidden * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1e-9)
    if mode == "max":
        neg = torch.finfo(hidden.dtype).min
        return torch.where(m > 0, hidden, neg).amax(dim=1)
    if mode == "cls":
        return hidden[:, 0, :]
    raise ValueError(f"unknown pooling mode {mode!r}")


def splade_activation(
    logits: torch.Tensor, attention_mask: torch.Tensor, pooling: str = "max"
) -> torch.Tensor:
    """MLM logits [B,T,V] → sparse lexical vector [B,V]: mask, relu, log1p,
    then max ('max', SPLADEv2+) or sum ('sum', SPLADEv1) over tokens."""
    m = attention_mask[..., None].to(logits.dtype)
    act = torch.log1p(torch.relu(logits * m))
    if pooling == "sum":
        return act.sum(dim=1)
    if pooling == "max":
        return act.amax(dim=1)
    raise ValueError("SPLADE pooling must be 'max' or 'sum'")


def prune_topk(activations: torch.Tensor, keep_topk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Keep only the top-k activations per row. Returns (pruned [B,V], idx [B,k])."""
    vals, idx = stable_topk(activations, keep_topk)
    return torch.zeros_like(activations).scatter(-1, idx, vals), idx


def l2_normalize(x: torch.Tensor, axis: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps) along ``axis``, computed in x's dtype (bf16 stays bf16)."""
    norm = torch.sqrt((x * x).sum(dim=axis, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def _check_similarity(similarity: str) -> None:
    if similarity not in SIMILARITIES:
        raise ValueError(f"similarity must be one of {SIMILARITIES}, got {similarity!r}")


def pairwise_similarity(q: torch.Tensor, d: torch.Tensor, similarity: str = "cos_sim") -> torch.Tensor:
    """Row-aligned similarity: q [..., H] vs d [..., H] → [...], in the
    inputs' dtype."""
    _check_similarity(similarity)
    if similarity == "cos_sim":
        q, d = l2_normalize(q), l2_normalize(d)
    return (q * d).sum(dim=-1)


def batchwise_similarity(q: torch.Tensor, d: torch.Tensor, similarity: str = "cos_sim") -> torch.Tensor:
    """All-pairs similarity: q [Nq, H] × d [Nd, H] → [Nq, Nd] f32 (the
    products of the inputs' dtype summed in f32)."""
    _check_similarity(similarity)
    if similarity == "cos_sim":
        q, d = l2_normalize(q), l2_normalize(d)
    return q.float() @ d.float().T


class ColBERTHead(nn.Module):
    """Per-token projection to the late-interaction dim (default 128)."""

    def __init__(self, hidden_size: int, dim: int = 128):
        super().__init__()
        self.proj = Linear(hidden_size, dim, bias=False)

    def forward(self, hidden: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        tok = l2_normalize(self.proj(hidden).float())
        return tok * attention_mask[..., None].to(torch.float32)


class CrossEncoderHead(nn.Module):
    """CLS pooled representation → one relevance logit: the ``pooler`` dense
    in the compute dtype, tanh, then the ``classifier`` in f32 (its weights
    stay f32 when the module is placed)."""

    def __init__(self, hidden_size: int):
        super().__init__()
        self.pooler = Linear(hidden_size, hidden_size)
        self.classifier = Linear(hidden_size, 1)
        self.classifier.keep_f32 = True

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        x = torch.tanh(self.pooler(hidden[:, 0, :]))
        return self.classifier(x.float())[..., 0]
