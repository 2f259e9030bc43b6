"""Int8-quantized dense corpus index.

Per-row symmetric int8 cuts the corpus matrix 4× against f32 and 2× against
bf16; the products stay bf16 × bf16 with f32 accumulation (int8 → bf16 is
exact), so only the rounding of the stored rows differs from the bf16 path.

    q ∈ f32[Q, H]  ×  C_int8[N, H] (row scales s[N])
    scores = (q_bf16 · C_int8ᵀ) * s
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fusion_tpu_torch.core.ranked import RankedLists
from fusion_tpu_torch.models.heads import l2_normalize
from fusion_tpu_torch.ops.mips import matmul_f32
from fusion_tpu_torch.ops.topk import blockwise_topk_offset


class QuantizedDenseIndex(NamedTuple):
    values: torch.Tensor  # int8 [N, H]
    scales: torch.Tensor  # f32 [N] per-row dequantization scale
    normalized: bool  # True when rows were L2-normalized before quantization

    @property
    def num_docs(self) -> int:
        return self.values.shape[0]

    def nbytes(self) -> int:
        return self.values.nbytes + self.scales.nbytes


def quantize_dense_index(
    corpus_embs: torch.Tensor, similarity: str = "cos_sim"
) -> QuantizedDenseIndex:
    """Per-row symmetric int8: v_int8 = round(v / s), s = max|v| / 127
    (clamped at 1e-12), on the corpus's device."""
    x = corpus_embs.to(torch.float32)
    normalized = similarity == "cos_sim"
    if normalized:
        x = l2_normalize(x)
    s = torch.clamp(x.abs().amax(dim=-1) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x / s[:, None]), -127, 127).to(torch.int8)
    return QuantizedDenseIndex(values=q, scales=s, normalized=normalized)


def quantized_dense_search(
    query_embs: torch.Tensor,
    index: QuantizedDenseIndex,
    k: int = 1000,
    doc_block: int = 65536,
) -> RankedLists:
    """Blockwise exact search over the int8 corpus with a running top-k.
    Rows of scale 0 (the pads the binned kernel's layout adds) never rank."""
    values, scales = index.values, index.scales
    n = values.shape[0]
    k = min(k, n)
    doc_block = min(doc_block, n)
    num_blocks = -(-n // doc_block)
    qf = query_embs.to(torch.float32)
    if index.normalized:
        qf = l2_normalize(qf)
    qb = qf.to(torch.bfloat16)
    offsets = torch.arange(doc_block, device=values.device)

    def block_scores(bi: int):
        start = bi * doc_block
        # the tail block is clamped to stay in bounds; its overlap with the
        # previous block is masked so no doc is scored twice
        real_start = min(start, n - doc_block)
        scales_b = scales[real_start : real_start + doc_block]
        raw = matmul_f32(qb, values[real_start : real_start + doc_block].to(torch.bfloat16).T)
        fresh = (real_start + offsets >= start) & (scales_b > 0)
        return torch.where(fresh[None, :], raw * scales_b[None, :], -torch.inf), real_start

    return blockwise_topk_offset(block_scores, num_blocks, query_embs.shape[0], k)
