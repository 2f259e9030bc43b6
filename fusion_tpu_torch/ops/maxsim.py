"""ColBERT late-interaction scoring (MaxSim).

score(q, d) = Σ_{i ∈ query tokens} max_{j ∈ doc tokens} ⟨q_i, d_j⟩

Mask semantics match colbert-ai: masked doc tokens are ZERO vectors whose
similarity 0 takes part in the max; fully padded docs are demoted to -inf
by ``maxsim_search_tm``; query pads multiply by 0 in the sum (augmentation
tokens count).

  * ``prepare_token_corpus`` — index-time relayout: zero masked tokens,
    token-major [Ld, N, D] bf16, per-doc validity;
  * ``maxsim_token_maxima_T`` — per-(doc, query-token) maxima [N, QL]: the
    hand-written Hopper kernel (``csrc/maxsim.cu``, through
    ``maxsim_maxima_cuda``) for a tensor on the card, the plain PyTorch
    version (``maxsim_maxima_plain``) for a tensor on the CPU;
  * ``maxsim_scores_tm`` — [Q, N] scores: maxima, then the query-mask sum;
  * ``maxsim_search_tm`` — streaming top-k over a prepared corpus.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from fusion_tpu_torch.core.ranked import RankedLists
from fusion_tpu_torch.ops import _kernels
from fusion_tpu_torch.ops.topk import blockwise_topk


def prepare_token_corpus(
    tokens: torch.Tensor, mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """[N, Ld, D] tokens + [N, Ld] mask → (corpus_tm [Ld, N, D] bf16 with
    masked tokens zeroed, doc_valid [N] bool)."""
    zeroed = tokens * mask[..., None].to(tokens.dtype)
    corpus_tm = zeroed.transpose(0, 1).to(torch.bfloat16).contiguous()
    return corpus_tm, mask.amax(dim=1) > 0


def maxsim_scores_zeromask(
    q_tokens: torch.Tensor, q_mask: torch.Tensor, d_tokens: torch.Tensor
) -> torch.Tensor:
    """Dense reference for the zeroed-mask semantics: [Q, Lq, D] queries vs
    [N, Ld, D] docs (pads are zero rows) → [Q, N] f32."""
    sim = torch.einsum("qid,njd->qnij", q_tokens.float(), d_tokens.float())
    best = sim.amax(dim=-1) * q_mask.float()[:, None, :]
    return best.sum(dim=-1)


def maxsim_maxima_plain(
    q_flat: torch.Tensor, corpus_tm: torch.Tensor, doc_block: int = 1024
) -> torch.Tensor:
    """Plain version of the maxima op: doc-blocked f32 matmul, then the max
    over Ld.  [QL, D] × [Ld, N, D] → f32 [N, QL]."""
    ld, n, _ = corpus_tm.shape
    qf = q_flat.float()
    out = torch.empty((n, q_flat.shape[0]), dtype=torch.float32, device=q_flat.device)
    for s in range(0, n, doc_block):
        blk = corpus_tm[:, s : s + doc_block].float()  # [Ld, B, D]
        out[s : s + blk.shape[1]] = torch.matmul(blk, qf.T).amax(dim=0)
    return out


@functools.cache
def _bind_maxsim() -> ctypes.CDLL:
    lib = _kernels.load("maxsim")
    lib.maxsim_maxima_T.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.maxsim_maxima_T.restype = ctypes.c_int
    lib.maxsim_error_string.argtypes = [ctypes.c_int]
    lib.maxsim_error_string.restype = ctypes.c_char_p
    return lib


def maxsim_maxima_cuda(q_flat: torch.Tensor, corpus_tm: torch.Tensor) -> torch.Tensor:
    """The Hopper MaxSim kernel (``csrc/maxsim.cu``): bf16 [QL, D] queries ×
    bf16 [Ld, N, D] token-major corpus → f32 [N, QL] maxima, on the current
    stream.  ``corpus_tm`` may be a doc slice of a larger corpus (its rows of
    D must be contiguous).  ``maxsim_maxima_cuda.launches`` counts launches."""
    if not (q_flat.is_cuda and corpus_tm.is_cuda) or q_flat.device != corpus_tm.device:
        raise ValueError("maxsim_maxima_cuda needs both tensors on one CUDA device")
    if q_flat.dtype != torch.bfloat16 or corpus_tm.dtype != torch.bfloat16:
        raise TypeError(
            f"maxsim_maxima_cuda takes bf16 inputs, got {q_flat.dtype} and {corpus_tm.dtype}"
        )
    if q_flat.dim() != 2 or corpus_tm.dim() != 3 or q_flat.shape[1] != corpus_tm.shape[2]:
        raise ValueError(
            f"shapes must be [QL, D] and [Ld, N, D], got {tuple(q_flat.shape)} "
            f"and {tuple(corpus_tm.shape)}"
        )
    ld, n, d = corpus_tm.shape
    ql = q_flat.shape[0]
    if d % 16 or not 16 <= d <= 256 or ld < 1:
        raise ValueError(f"need D a multiple of 16 in [16, 256] and Ld >= 1, got D {d}, Ld {ld}")
    if not q_flat.is_contiguous() or corpus_tm.stride(2) != 1 or corpus_tm.stride(1) != d:
        raise ValueError("q_flat must be contiguous and corpus_tm rows of D contiguous")
    out = torch.empty((n, ql), dtype=torch.float32, device=q_flat.device)
    if n == 0 or ql == 0:
        return out
    lib = _bind_maxsim()
    stream = torch.cuda.current_stream(q_flat.device).cuda_stream
    rc = lib.maxsim_maxima_T(
        corpus_tm.data_ptr(), q_flat.data_ptr(), out.data_ptr(),
        ld, n, d, corpus_tm.stride(0), ql, stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"maxsim kernel launch failed: {lib.maxsim_error_string(rc).decode()} ({rc})"
        )
    maxsim_maxima_cuda.launches += 1
    return out


maxsim_maxima_cuda.launches = 0


def maxsim_token_maxima_T(q_flat: torch.Tensor, corpus_tm: torch.Tensor) -> torch.Tensor:
    """Per-(doc, query-token) maxima [N, QL] f32.  A tensor on the card goes
    to the kernel (which raises on what it does not take); a tensor on the
    CPU goes to the plain version."""
    if corpus_tm.is_cuda or q_flat.is_cuda:
        return maxsim_maxima_cuda(q_flat, corpus_tm)
    return maxsim_maxima_plain(q_flat, corpus_tm)


def maxsim_scores_tm(
    q_tokens: torch.Tensor, q_mask: torch.Tensor, corpus_tm: torch.Tensor
) -> torch.Tensor:
    """[Q, N] MaxSim over a prepared (token-major, pre-zeroed) corpus."""
    q, lq, d = q_tokens.shape
    maxima = maxsim_token_maxima_T(q_tokens.reshape(q * lq, d), corpus_tm)  # [N, QL]
    # query-token sum: maxima times the token mask, summed per query
    masked = maxima.view(-1, q, lq) * q_mask.to(torch.float32)[None]
    return masked.sum(dim=-1).T


def maxsim_search_tm(
    q_tokens: torch.Tensor,
    q_mask: torch.Tensor,
    corpus_tm: torch.Tensor,
    doc_valid: torch.Tensor,
    k: int = 1000,
    outer_block: int = 65536,
) -> RankedLists:
    """Streaming MaxSim top-k over a PREPARED token corpus
    (``prepare_token_corpus``): blocks of ``outer_block`` docs are scored
    and merged into a running top-k; invalid docs score -inf."""
    ld, n, _ = corpus_tm.shape
    q = q_tokens.shape[0]
    k = min(k, n)
    outer = min(outer_block, n)
    num_blocks = -(-n // outer)
    offsets = torch.arange(outer, device=corpus_tm.device)

    def block_scores(bi: int):
        start = bi * outer
        real_start = min(start, n - outer)
        scores = maxsim_scores_tm(
            q_tokens, q_mask, corpus_tm[:, real_start : real_start + outer]
        )
        ids = real_start + offsets
        fresh = (ids >= start) & doc_valid[real_start : real_start + outer]
        scores = torch.where(fresh[None, :], scores, -torch.inf)
        return scores, ids.expand(q, outer)

    return blockwise_topk(block_scores, num_blocks, q, k)
