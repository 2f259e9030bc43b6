"""Ranking and regularization losses, as ``fusion_tpu/train/losses.py``:

  * ``info_nce``    — temperature-scaled cross-entropy, positive at index 0
  * ``margin_mse``  — student-vs-teacher margin MSE distillation
  * ``kld``         — softmax distribution distillation, batch mean
  * ``mnrl``        — in-batch multiple-negatives ranking loss (DPR; scale 20
                      over cosine similarity)
  * ``bce_logits``  — pointwise binary relevance (monoBERT)
  * ``flops_reg``   — Σ_j mean_batch(|rep_j|)², its weight ramped
                      quadratically to ``target_step``; ``l1_reg``, ``l0_reg``

Plain functions of tensors, computed in their inputs' dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fusion_tpu_torch.models.heads import batchwise_similarity


def info_nce(pos_scores: torch.Tensor, neg_scores: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    """pos [B], neg [B, N] → scalar. Positive is class 0 of the (1+N)-way CE."""
    logits = torch.cat([pos_scores[:, None], neg_scores], dim=-1) / temperature
    return -torch.log_softmax(logits, dim=-1)[:, 0].mean()


def margin_mse(
    pos_scores: torch.Tensor,
    neg_scores: torch.Tensor,
    teacher_pos_scores: torch.Tensor,
    teacher_neg_scores: torch.Tensor,
    teacher_scale: float = 1.0,
) -> torch.Tensor:
    """pos [B], neg [B, N], teacher_* same shapes → mean squared margin gap."""
    student = pos_scores[:, None] - neg_scores
    teacher = (teacher_pos_scores[:, None] - teacher_neg_scores) * teacher_scale
    return ((student - teacher) ** 2).mean()


def kld(
    pos_scores: torch.Tensor,
    neg_scores: torch.Tensor,
    teacher_pos_scores: torch.Tensor,
    teacher_neg_scores: torch.Tensor,
    teacher_scale: float = 1.0,
) -> torch.Tensor:
    """KL(teacher softmax ‖ student softmax), summed over classes, batch mean."""
    student = torch.cat([pos_scores[:, None], neg_scores], dim=-1)
    teacher = torch.cat([teacher_pos_scores[:, None], teacher_neg_scores], dim=-1) * teacher_scale
    s_logp = torch.log_softmax(student, dim=-1)
    t_logp = torch.log_softmax(teacher, dim=-1)
    return (torch.softmax(teacher, dim=-1) * (t_logp - s_logp)).sum(dim=-1).mean()


def mnrl(q_embs: torch.Tensor, d_embs: torch.Tensor, scale: float = 20.0, similarity: str = "cos_sim") -> torch.Tensor:
    """Multiple-negatives ranking loss over in-batch positives: q_embs [B, H],
    d_embs [B(+extra), H]; d_embs[i] is q_embs[i]'s positive, every other
    row a negative."""
    logprobs = torch.log_softmax(batchwise_similarity(q_embs, d_embs, similarity) * scale, dim=-1)
    labels = torch.arange(q_embs.shape[0], device=q_embs.device)
    return -logprobs.gather(-1, labels[:, None]).mean()


def bce_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Sigmoid binary cross-entropy on relevance logits."""
    return -(labels * F.logsigmoid(logits) + (1.0 - labels) * F.logsigmoid(-logits)).mean()


# ----------------------------------------------------------------------
# sparsity regularizers (SPLADE)
# ----------------------------------------------------------------------
def flops_value(reps: torch.Tensor) -> torch.Tensor:
    """FLOPS regularizer term: Σ_vocab (mean over batch of |activation|)²."""
    return (reps.abs().mean(dim=0) ** 2).sum()


def flops_weight(weight: float, step: torch.Tensor | int, target_step: int | None) -> torch.Tensor:
    """The FLOPS weight, ramped quadratically until ``target_step``; ``step``
    an int or a tensor."""
    if target_step is None:
        return torch.tensor(weight, dtype=torch.float32)
    step = torch.as_tensor(step, dtype=torch.float32)
    ramp = weight * (step / (target_step + 1)) ** 2
    return torch.where(step < target_step, torch.clamp(ramp, max=weight), torch.tensor(weight, dtype=torch.float32))


def flops_reg(
    reps: torch.Tensor, weight: float, step: torch.Tensor | int = 0, target_step: int | None = None
) -> torch.Tensor:
    return flops_value(reps) * flops_weight(weight, step, target_step).to(reps.device)


def l1_reg(reps: torch.Tensor, weight: float) -> torch.Tensor:
    return reps.abs().sum(dim=-1).mean() * weight


def l0_reg(reps: torch.Tensor, weight: float) -> torch.Tensor:
    return (reps != 0).to(torch.float32).sum(dim=-1).mean() * weight


REGULARIZERS = {"FlopsLoss": "flops", "L1Loss": "l1", "L0Loss": "l0"}


def regularizer(
    name: str, reps: torch.Tensor, weight: float, step=0, target_step: int | None = None
) -> torch.Tensor:
    """Dispatch by the reference's loss-class names (or flops / l1 / l0)."""
    kind = REGULARIZERS.get(name, name)
    if kind == "flops":
        return flops_reg(reps, weight, step, target_step)
    if kind == "l1":
        return l1_reg(reps, weight)
    if kind == "l0":
        return l0_reg(reps, weight)
    raise ValueError(f"unknown regularizer {name!r}")
