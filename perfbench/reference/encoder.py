"""A CamemBERT-style (RoBERTa, post-LayerNorm) encoder and its heads.

    x = LN(word[ids] + pos[positions] + type[0])
    per layer:  a = softmax(q k^T / sqrt(d_head) + bias) v   (bias -1e9 on pad keys)
                x = LN(x + a W_o + b_o)
                x = LN(x + gelu(x W_1 + b_1) W_2 + b_2)          (exact gelu)
    positions: RoBERTa's, the count of non-pad ids so far, offset past pad

Heads: DPR mean-pools over the mask; SPLADE takes the MLM head's logits
through log1p(relu(.)) and the max over tokens; ColBERT projects each token
to ``dim`` (no bias), l2-normalizes and zeroes pads; the cross-encoder reads
the first token through the pooler (tanh) and the classifier.
"""

from __future__ import annotations

import math

import torch

FP8_MAX = 448.0


def rounded(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` in float32, or rounded through float8 e4m3 with a per-tensor
    scale (the control)."""
    x = x.float()
    if precision == "fp32":
        return x
    if precision != "fp8":
        raise ValueError(f"precision must be 'fp32' or 'fp8', got {precision!r}")
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    return rounded(a, precision) @ rounded(b, precision)


def linear(x, w, b, precision):
    y = matmul(x, w.T, precision)
    return y if b is None else y + b.float()


def layer_norm(x, g, s, eps):
    return torch.nn.functional.layer_norm(x, g.shape, g.float(), s.float(), eps)


def positions(ids: torch.Tensor, pad_id: int) -> torch.Tensor:
    real = (ids != pad_id).long()
    return torch.cumsum(real, dim=-1) * real + pad_id


def trunk(w: dict, enc: dict, ids: torch.Tensor, mask: torch.Tensor, precision: str,
          pos: torch.Tensor | None = None) -> torch.Tensor:
    """[B, L] ids and key mask → [B, L, H] last hidden states."""
    eps, heads = enc["layer_norm_eps"], enc["num_attention_heads"]
    pos = positions(ids, enc["pad_token_id"]) if pos is None else pos
    x = w["emb.word"][ids].float() + w["emb.pos"][pos].float() + w["emb.type"][0].float()
    x = layer_norm(x, w["emb.ln.g"], w["emb.ln.s"], eps)
    b, length, h = x.shape
    hd = h // heads
    bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9)
    for li in range(enc["num_hidden_layers"]):
        p = f"L{li}."
        qkv = linear(x, w[p + "qkv.w"], w[p + "qkv.b"], precision).view(b, length, 3, heads, hd)
        q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))  # [B, heads, L, hd]
        logits = matmul(q, k.transpose(-1, -2), precision) / math.sqrt(hd) + bias
        ctx = matmul(torch.softmax(logits, dim=-1), v, precision).transpose(1, 2).reshape(b, length, h)
        x = layer_norm(x + linear(ctx, w[p + "out.w"], w[p + "out.b"], precision), w[p + "ln1.g"], w[p + "ln1.s"], eps)
        inner = torch.nn.functional.gelu(linear(x, w[p + "ffn_in.w"], w[p + "ffn_in.b"], precision))
        x = layer_norm(x + linear(inner, w[p + "ffn_out.w"], w[p + "ffn_out.b"], precision),
                       w[p + "ln2.g"], w[p + "ln2.s"], eps)
    return x


def dense_embed(w, enc, ids, mask, precision):
    hidden = trunk(w, enc, ids, mask, precision)
    m = mask[..., None].float()
    return (hidden * m).sum(dim=1) / m.sum(dim=1).clamp(min=1e-9)


def splade_embed(w, enc, ids, mask, precision):
    hidden = trunk(w, enc, ids, mask, precision)
    t = torch.nn.functional.gelu(linear(hidden, w["mlm.transform.w"], w["mlm.transform.b"], precision))
    t = layer_norm(t, w["mlm.ln.g"], w["mlm.ln.s"], enc["layer_norm_eps"])
    logits = linear(t, w["mlm.decoder.w"], w["mlm.decoder.b"], precision)
    return torch.log1p(torch.relu(logits * mask[..., None].float())).amax(dim=1)


def colbert_embed(w, enc, ids, mask, precision):
    hidden = trunk(w, enc, ids, mask, precision)
    tok = linear(hidden, w["proj.w"], None, precision)
    tok = tok / tok.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    return tok * mask[..., None].float()


def cross_logits(w, enc, ids, mask, precision):
    hidden = trunk(w, enc, ids, mask, precision)
    pooled = torch.tanh(linear(hidden[:, 0], w["pooler.w"], w["pooler.b"], precision))
    return linear(pooled, w["cls.w"], w["cls.b"], precision)[:, 0]
