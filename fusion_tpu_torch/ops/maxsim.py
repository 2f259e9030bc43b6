"""ColBERT late-interaction scoring (MaxSim).

score(q, d) = Σ_{i ∈ query tokens} max_{j ∈ doc tokens} ⟨q_i, d_j⟩

Two mask semantics, as in ``fusion_tpu/ops/maxsim.py``:

  * strict — sims of masked doc tokens are ``_NEG`` = -1e9 (``maxsim_scores``
    and the fused kernel's strict mode, the counterpart of
    ``maxsim_scores_pallas``); a fully masked doc scores -1e9 times its
    query's mask sum;
  * zeroed (colbert-ai) — masked doc tokens are ZERO vectors whose similarity
    0 takes part in the max; fully padded docs are demoted to -inf by the
    searches.

Query pads multiply by 0 in the sum (augmentation tokens count).

  * ``prepare_token_corpus`` — index-time relayout: zero masked tokens,
    token-major [Ld, N, D] bf16, per-doc validity;
  * ``maxsim_token_maxima_T`` (K1) — per-(doc, query-token) maxima [N, QL]:
    the Hopper kernel ``csrc/maxsim.cu`` (``maxsim_maxima_cuda``) for a tensor
    on the card, ``maxsim_maxima_plain`` for a tensor on the CPU;
  * ``maxsim_token_maxima`` (K1-v2, the counterpart of
    ``maxsim_token_maxima_pallas``) — the same maxima [QL, N], reduced in f32
    or rounded to bf16 (``maxsim_maxima_v2_cuda`` / ``maxsim_maxima_v2_plain``);
  * ``maxsim_fused`` (K1-v1) — the Ld max and the query-mask sum in one
    kernel, the fused mode of ``csrc/maxsim.cu``, strict or zeroed
    (``maxsim_fused_cuda`` / ``maxsim_fused_plain``); ``maxsim_scores_v1`` is
    the doc-major entry, the counterpart of ``maxsim_scores_pallas``;
  * ``maxsim_scores_tm`` — [Q, N] scores: K1 maxima, then the query-mask sum;
    ``maxsim_scores_v2`` is its doc-major entry (``maxsim_scores_pallas_v2``);
  * ``maxsim_search_tm`` — streaming top-k over a prepared corpus;
    ``maxsim_search`` — the same over a doc-major token matrix.

Every ``*_cuda`` wrapper launches its kernel for tensors on the card (and
raises on what it does not take) and counts its launches in ``.launches``;
the dispatchers send CPU tensors to the plain versions.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from fusion_tpu_torch.core.device import check_use_pallas
from fusion_tpu_torch.core.ranked import RankedLists
from fusion_tpu_torch.ops import _kernels
from fusion_tpu_torch.ops.topk import blockwise_topk, blockwise_topk_offset

_NEG = -1e9
MAX_SMEM = 232_448  # shared memory one block may use on Hopper
REDUCES = ("f32", "bf16")


def prepare_token_corpus(
    tokens: torch.Tensor, mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """[N, Ld, D] tokens + [N, Ld] mask → (corpus_tm [Ld, N, D] bf16 with
    masked tokens zeroed, doc_valid [N] bool)."""
    zeroed = tokens * mask[..., None].to(tokens.dtype)
    corpus_tm = zeroed.transpose(0, 1).to(torch.bfloat16).contiguous()
    return corpus_tm, mask.amax(dim=1) > 0


def maxsim_scores(
    q_tokens: torch.Tensor, q_mask: torch.Tensor, d_tokens: torch.Tensor, d_mask: torch.Tensor
) -> torch.Tensor:
    """Dense reference with strict masking: [Q, Lq, D] queries vs [N, Ld, D]
    docs with an [N, Ld] mask → [Q, N] f32; masked doc tokens score -1e9."""
    sim = torch.einsum("qid,njd->qnij", q_tokens.float(), d_tokens.float())
    sim = torch.where(d_mask[None, :, None, :] > 0, sim, _NEG)
    return (sim.amax(dim=-1) * q_mask.float()[:, None, :]).sum(dim=-1)


def maxsim_scores_zeromask(
    q_tokens: torch.Tensor, q_mask: torch.Tensor, d_tokens: torch.Tensor
) -> torch.Tensor:
    """Dense reference for the zeroed-mask semantics: [Q, Lq, D] queries vs
    [N, Ld, D] docs (pads are zero rows) → [Q, N] f32."""
    sim = torch.einsum("qid,njd->qnij", q_tokens.float(), d_tokens.float())
    best = sim.amax(dim=-1) * q_mask.float()[:, None, :]
    return best.sum(dim=-1)


# ----------------------------------------------------------------------
# plain versions of the kernels
# ----------------------------------------------------------------------
def maxsim_maxima_plain(
    q_flat: torch.Tensor, corpus_tm: torch.Tensor, doc_block: int = 1024
) -> torch.Tensor:
    """Plain version of K1: doc-blocked f32 matmul, then the max over Ld.
    [QL, D] × [Ld, N, D] → f32 [N, QL]."""
    ld, n, _ = corpus_tm.shape
    qf = q_flat.float()
    out = torch.empty((n, q_flat.shape[0]), dtype=torch.float32, device=q_flat.device)
    for s in range(0, n, doc_block):
        blk = corpus_tm[:, s : s + doc_block].float()  # [Ld, B, D]
        out[s : s + blk.shape[1]] = torch.matmul(blk, qf.T).amax(dim=0)
    return out


def maxsim_maxima_v2_plain(
    q_flat: torch.Tensor, corpus_tm: torch.Tensor, reduce: str = "f32", doc_block: int = 1024
) -> torch.Tensor:
    """Plain version of K1-v2: the maxima [QL, N] f32, with ``reduce='bf16'``
    each rounded to bf16 (to nearest even), as the TPU's bf16 reduce gives."""
    _check_reduce(reduce)
    out = maxsim_maxima_plain(q_flat, corpus_tm, doc_block).T.contiguous()
    return out.to(torch.bfloat16).float() if reduce == "bf16" else out


def maxsim_fused_plain(
    q_flat: torch.Tensor,
    q_mask: torch.Tensor,
    corpus_tm: torch.Tensor,
    mask_tm: torch.Tensor | None = None,
    doc_block: int = 1024,
) -> torch.Tensor:
    """Plain version of K1-v1: [Q·Lq, D] query tokens, [Q, Lq] query mask,
    [Ld, N, D] token-major docs → f32 [Q, N].  With ``mask_tm`` ([Ld, N]) the
    strict mask: masked tokens' sims and the running max's start are -1e9;
    without it the docs' masked tokens are zero vectors."""
    q, lq = q_mask.shape
    ld, n, _ = corpus_tm.shape
    qf, qm = q_flat.float(), q_mask.float()
    out = torch.empty((q, n), dtype=torch.float32, device=q_flat.device)
    for s in range(0, n, doc_block):
        sims = torch.matmul(corpus_tm[:, s : s + doc_block].float(), qf.T)  # [Ld, B, QL]
        if mask_tm is not None:
            sims = torch.where(mask_tm[:, s : s + doc_block, None] > 0, sims, _NEG)
        best = sims.amax(dim=0)  # [B, QL]
        if mask_tm is not None:
            best = best.clamp(min=_NEG)
        out[:, s : s + best.shape[0]] = (best.view(-1, q, lq) * qm[None]).sum(dim=-1).T
    return out


# ----------------------------------------------------------------------
# the Hopper kernels
# ----------------------------------------------------------------------
def _check_reduce(reduce: str) -> None:
    if reduce not in REDUCES:
        raise ValueError(f"reduce must be one of {REDUCES}, got {reduce!r}")


@functools.cache
def _bind_maxsim() -> ctypes.CDLL:
    lib = _kernels.load("maxsim")
    lib.maxsim_maxima.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.maxsim_maxima.restype = ctypes.c_int
    lib.maxsim_fused.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.maxsim_fused.restype = ctypes.c_int
    lib.maxsim_error_string.argtypes = [ctypes.c_int]
    lib.maxsim_error_string.restype = ctypes.c_char_p
    return lib


CONSUMER_ROWS = 128  # query rows per consumer warpgroup; two consumers per block
# the fused epilogue's staged maxima: both consumers' 128 query rows x 64
# docs, rows padded to 68 words, in the ring
FUSED_STAGING_BYTES = 2 * CONSUMER_ROWS * 68 * 4


def maxima_smem_bytes(d: int, tchunk: int, stages: int = 1, mask: bool = False) -> int:
    """Shared memory of one block of the MaxSim kernel (``csrc/maxsim.cu``)
    at width ``d`` with ``stages`` ring stages of ``tchunk`` doc tokens: the
    256-row query tile and the ring, both in 64-column swizzle atoms (D
    rounded up to 64), with ``mask`` (the fused strict mode) each stage's
    ``tchunk`` x 64 f32 doc-mask words, plus the barriers and 1,024 bytes of
    alignment."""
    atoms = -(-d // 64)
    stage = atoms * tchunk * 64 * 64 * 2 + (tchunk * 64 * 4 if mask else 0)
    return 1024 + atoms * 256 * 64 * 2 + stages * stage + 256


def maxima_stages(d: int, tchunk: int, mask: bool = False) -> int:
    """Ring stages the MaxSim kernel runs with at width ``d`` and ``tchunk``
    doc tokens per stage: as many as fit beside the query tile, at most 8
    (0: not even one fits, and the kernel refuses the call)."""
    if not 1 <= tchunk <= 256:
        return 0
    room = MAX_SMEM - maxima_smem_bytes(d, tchunk, 0, mask)
    per_stage = maxima_smem_bytes(d, tchunk, 1, mask) - maxima_smem_bytes(d, tchunk, 0, mask)
    return max(0, min(8, room // per_stage))


@functools.cache
def k1_tokens_per_stage(d: int, mask: bool = False) -> int:
    """Doc tokens per ring stage of K1 (and, with ``mask`` for the strict
    mode, of the fused modes): 4 where two such stages fit beside the query
    tile, else 2, else 1.  Fewer, deeper stages mean fewer barrier waits per
    token (K1-v2's bench modes at the serving shape: ``tchunk`` 4 is the
    fastest, see PERF.md); the results do not depend on it."""
    return next((t for t in (4, 2) if maxima_stages(d, t, mask) >= 2), 1)


def fused_stages(d: int, mask: bool) -> int:
    """Ring stages of the fused modes at width ``d``: those of
    ``k1_tokens_per_stage(d, mask)`` tokens each, or 0 where their corpus
    bytes cannot hold the epilogue's staged maxima (the kernel then refuses
    the call)."""
    tchunk = k1_tokens_per_stage(d, mask)
    stages = maxima_stages(d, tchunk, mask)
    corpus_bytes = stages * -(-d // 64) * tchunk * 64 * 64 * 2
    return stages if corpus_bytes >= FUSED_STAGING_BYTES else 0


def fused_queries_per_consumer(lq: int) -> int:
    """Whole queries of ``lq`` tokens in one consumer's 128 query rows in the
    fused modes; a block holds twice as many."""
    return CONSUMER_ROWS // lq


def fused_first_rows(block: int, lq: int) -> tuple[int, int]:
    """The first query row (of ``q_flat``) of each of block ``block``'s two
    consumers in the fused modes: each starts at a whole query."""
    qpw = fused_queries_per_consumer(lq)
    return tuple((2 * block + w) * qpw * lq for w in (0, 1))


def _check_maxima_args(name: str, q_flat: torch.Tensor, corpus_tm: torch.Tensor) -> None:
    if not (q_flat.is_cuda and corpus_tm.is_cuda) or q_flat.device != corpus_tm.device:
        raise ValueError(f"{name} needs both tensors on one CUDA device")
    if q_flat.dtype != torch.bfloat16 or corpus_tm.dtype != torch.bfloat16:
        raise TypeError(f"{name} takes bf16 inputs, got {q_flat.dtype} and {corpus_tm.dtype}")
    if q_flat.dim() != 2 or corpus_tm.dim() != 3 or q_flat.shape[1] != corpus_tm.shape[2]:
        raise ValueError(
            f"shapes must be [QL, D] and [Ld, N, D], got {tuple(q_flat.shape)} "
            f"and {tuple(corpus_tm.shape)}"
        )
    ld, _, d = corpus_tm.shape
    if d % 16 or not 16 <= d <= 256 or ld < 1:
        raise ValueError(f"need D a multiple of 16 in [16, 256] and Ld >= 1, got D {d}, Ld {ld}")
    if not q_flat.is_contiguous() or corpus_tm.stride(2) != 1 or corpus_tm.stride(1) != d:
        raise ValueError("q_flat must be contiguous and corpus_tm rows of D contiguous")
    # the kernel's tensor maps: 16-byte aligned bases and token strides
    if (q_flat.data_ptr() | corpus_tm.data_ptr()) % 16 or _token_stride(corpus_tm) % 8:
        raise ValueError(
            f"{name} needs 16-byte aligned tensors and a token stride that is a multiple of 8 "
            f"elements, got stride {corpus_tm.stride(0)}"
        )


def _token_stride(corpus_tm: torch.Tensor) -> int:
    """Elements between doc tokens (a lone token's stride is arbitrary in
    torch: any value past its N x D rows will do)."""
    ld, n, d = corpus_tm.shape
    return corpus_tm.stride(0) if ld > 1 else n * d


def _launch_maxima(q_flat, corpus_tm, query_major: bool, round_bf16: bool, tchunk: int):
    """One launch of ``csrc/maxsim.cu`` on the current stream; f32 maxima
    [QL, N] if ``query_major`` else [N, QL]."""
    ld, n, d = corpus_tm.shape
    ql = q_flat.shape[0]
    shape = (ql, n) if query_major else (n, ql)
    out = torch.empty(shape, dtype=torch.float32, device=q_flat.device)
    if n == 0 or ql == 0:
        return out
    lib = _bind_maxsim()
    stream = torch.cuda.current_stream(q_flat.device).cuda_stream
    rc = lib.maxsim_maxima(
        corpus_tm.data_ptr(), q_flat.data_ptr(), out.data_ptr(),
        ld, n, d, _token_stride(corpus_tm), ql, tchunk, int(query_major), int(round_bf16), stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"maxsim kernel launch failed: {lib.maxsim_error_string(rc).decode()} ({rc})"
        )
    return out


def maxsim_maxima_cuda(q_flat: torch.Tensor, corpus_tm: torch.Tensor) -> torch.Tensor:
    """K1 (``csrc/maxsim.cu``): bf16 [QL, D] queries × bf16 [Ld, N, D]
    token-major corpus → f32 [N, QL] maxima, on the current stream.
    ``corpus_tm`` may be a doc slice of a larger corpus (its rows of D must be
    contiguous).  ``maxsim_maxima_cuda.launches`` counts launches."""
    _check_maxima_args("maxsim_maxima_cuda", q_flat, corpus_tm)
    out = _launch_maxima(q_flat, corpus_tm, query_major=False, round_bf16=False,
                         tchunk=k1_tokens_per_stage(corpus_tm.shape[2]))
    maxsim_maxima_cuda.launches += 1
    return out


maxsim_maxima_cuda.launches = 0


def maxsim_maxima_v2_cuda(
    q_flat: torch.Tensor, corpus_tm: torch.Tensor, reduce: str = "f32", tchunk: int = 1
) -> torch.Tensor:
    """K1-v2 (``csrc/maxsim.cu``, stored query-token-major): bf16 [QL, D] ×
    bf16 [Ld, N, D] → f32 [QL, N] maxima, each rounded to bf16 when
    ``reduce='bf16'``; ``tchunk`` doc tokens are staged per step (the token
    chunks of ``scripts/bench_maxsim.py::_kernel_chunked``).
    ``maxsim_maxima_v2_cuda.launches`` counts launches."""
    _check_reduce(reduce)
    _check_maxima_args("maxsim_maxima_v2_cuda", q_flat, corpus_tm)
    d = corpus_tm.shape[2]
    if maxima_stages(d, tchunk) < 1:
        raise ValueError(
            f"tchunk {tchunk} at D {d}: one ring stage does not fit beside the query tile "
            f"({maxima_smem_bytes(d, tchunk)} bytes of shared memory per block; at most {MAX_SMEM})"
        )
    out = _launch_maxima(q_flat, corpus_tm, query_major=True, round_bf16=reduce == "bf16",
                         tchunk=tchunk)
    maxsim_maxima_v2_cuda.launches += 1
    return out


maxsim_maxima_v2_cuda.launches = 0


def maxsim_fused_cuda(
    q_flat: torch.Tensor,
    q_mask: torch.Tensor,
    corpus_tm: torch.Tensor,
    mask_tm: torch.Tensor | None = None,
) -> torch.Tensor:
    """K1-v1 (the fused mode of ``csrc/maxsim.cu``): bf16 [Q·Lq, D] query
    tokens, f32 [Q, Lq] query mask, bf16 [Ld, N, D] token-major docs and, for
    the strict mask, f32 [Ld, N] doc mask → f32 [Q, N] scores, on the current
    stream.  Without ``mask_tm`` the docs' masked tokens are zero vectors.
    ``maxsim_fused_cuda.launches`` counts launches."""
    tensors = [q_flat, q_mask, corpus_tm] + ([] if mask_tm is None else [mask_tm])
    if not all(t.is_cuda and t.device == q_flat.device for t in tensors):
        raise ValueError("maxsim_fused_cuda needs every tensor on one CUDA device")
    if q_flat.dtype != torch.bfloat16 or corpus_tm.dtype != torch.bfloat16:
        raise TypeError(
            f"maxsim_fused_cuda takes bf16 tokens, got {q_flat.dtype} and {corpus_tm.dtype}"
        )
    if q_mask.dtype != torch.float32 or (mask_tm is not None and mask_tm.dtype != torch.float32):
        raise TypeError("maxsim_fused_cuda takes f32 masks")
    if q_mask.dim() != 2 or q_flat.dim() != 2 or corpus_tm.dim() != 3:
        raise ValueError("shapes must be [Q·Lq, D], [Q, Lq] and [Ld, N, D]")
    q, lq = q_mask.shape
    ld, n, d = corpus_tm.shape
    if q_flat.shape != (q * lq, d):
        raise ValueError(f"q_flat is {tuple(q_flat.shape)}, want {(q * lq, d)}")
    if mask_tm is not None and mask_tm.shape != (ld, n):
        raise ValueError(f"mask_tm is {tuple(mask_tm.shape)}, want {(ld, n)}")
    if d % 16 or not 16 <= d <= 256 or ld < 1 or not 1 <= lq <= 128:
        raise ValueError(
            f"need D a multiple of 16 in [16, 256], Ld >= 1 and 1 <= Lq <= 128, got D {d}, "
            f"Ld {ld}, Lq {lq}"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("maxsim_fused_cuda takes contiguous tensors")
    if (q_flat.data_ptr() | corpus_tm.data_ptr()) % 16:
        raise ValueError("maxsim_fused_cuda needs 16-byte aligned tokens")
    out = torch.empty((q, n), dtype=torch.float32, device=q_flat.device)
    if n == 0 or q == 0:
        return out
    n4 = -(-n // 4) * 4
    if mask_tm is not None and (n4 != n or mask_tm.data_ptr() % 16):
        # the kernel's tensor map reads rows of a multiple of 4 words, 16-byte aligned
        padded = torch.zeros((ld, n4), dtype=torch.float32, device=mask_tm.device)
        padded[:, :n] = mask_tm
        mask_tm = padded
    lib = _bind_maxsim()
    stream = torch.cuda.current_stream(q_flat.device).cuda_stream
    rc = lib.maxsim_fused(
        corpus_tm.data_ptr(), q_flat.data_ptr(), q_mask.data_ptr(),
        None if mask_tm is None else mask_tm.data_ptr(), out.data_ptr(),
        ld, n, d, q, lq, k1_tokens_per_stage(d, mask_tm is not None), stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"fused maxsim kernel launch failed: {lib.maxsim_error_string(rc).decode()} ({rc})"
        )
    maxsim_fused_cuda.launches += 1
    return out


maxsim_fused_cuda.launches = 0


# ----------------------------------------------------------------------
# dispatchers: the kernel for tensors on the card, the plain version on the CPU
# ----------------------------------------------------------------------
def maxsim_token_maxima_T(q_flat: torch.Tensor, corpus_tm: torch.Tensor) -> torch.Tensor:
    """Per-(doc, query-token) maxima [N, QL] f32 (K1)."""
    if corpus_tm.is_cuda or q_flat.is_cuda:
        return maxsim_maxima_cuda(q_flat, corpus_tm)
    return maxsim_maxima_plain(q_flat, corpus_tm)


def maxsim_token_maxima(
    q_flat: torch.Tensor, corpus_tm: torch.Tensor, reduce: str = "f32", tchunk: int = 1
) -> torch.Tensor:
    """Per-(query-token, doc) maxima [QL, N] f32 (K1-v2) over a token-major,
    pre-zeroed corpus; the caller applies the query-mask sum.  ``tchunk``
    only shapes the kernel's staging."""
    if tchunk < 1:
        raise ValueError(f"tchunk must be >= 1, got {tchunk}")
    if corpus_tm.is_cuda or q_flat.is_cuda:
        return maxsim_maxima_v2_cuda(q_flat, corpus_tm, reduce=reduce, tchunk=tchunk)
    return maxsim_maxima_v2_plain(q_flat, corpus_tm, reduce=reduce)


def maxsim_fused(
    q_flat: torch.Tensor,
    q_mask: torch.Tensor,
    corpus_tm: torch.Tensor,
    mask_tm: torch.Tensor | None = None,
) -> torch.Tensor:
    """[Q, N] scores with the Ld max and the query-mask sum fused (K1-v1):
    strict with ``mask_tm``, zeroed without."""
    if corpus_tm.is_cuda or q_flat.is_cuda:
        return maxsim_fused_cuda(q_flat, q_mask, corpus_tm, mask_tm)
    return maxsim_fused_plain(q_flat, q_mask, corpus_tm, mask_tm)


def maxsim_scores_v1(
    q_tokens: torch.Tensor, q_mask: torch.Tensor, d_tokens: torch.Tensor, d_mask: torch.Tensor
) -> torch.Tensor:
    """Dense [Q, N] MaxSim with strict masking through K1-v1, from doc-major
    [N, Ld, D] docs and an [N, Ld] mask (the counterpart of
    ``maxsim_scores_pallas``).  On the card the tokens go to the kernel as
    bf16, as the TPU kernel casts them; on the CPU they keep their dtype."""
    q, lq, d = q_tokens.shape
    q_flat = q_tokens.reshape(q * lq, d)
    d_tm = d_tokens.transpose(0, 1)
    if d_tokens.is_cuda:
        q_flat, d_tm = q_flat.to(torch.bfloat16), d_tm.to(torch.bfloat16)
    m_tm = d_mask.to(torch.float32).T.contiguous()
    return maxsim_fused(q_flat.contiguous(), q_mask.to(torch.float32).contiguous(),
                        d_tm.contiguous(), m_tm)


def maxsim_scores_tm(
    q_tokens: torch.Tensor, q_mask: torch.Tensor, corpus_tm: torch.Tensor
) -> torch.Tensor:
    """[Q, N] MaxSim over a prepared (token-major, pre-zeroed) corpus."""
    q, lq, d = q_tokens.shape
    maxima = maxsim_token_maxima_T(q_tokens.reshape(q * lq, d), corpus_tm)  # [N, QL]
    # query-token sum: maxima times the token mask, summed per query
    masked = maxima.view(-1, q, lq) * q_mask.to(torch.float32)[None]
    return masked.sum(dim=-1).T


def maxsim_scores_v2(
    q_tokens: torch.Tensor, q_mask: torch.Tensor, d_tokens: torch.Tensor
) -> torch.Tensor:
    """[Q, N] MaxSim with zeroed-mask semantics from doc-major [N, Ld, D]
    docs whose masked tokens are zero (the counterpart of
    ``maxsim_scores_pallas_v2``): a token-major relayout, then
    ``maxsim_scores_tm`` (K1 on the card, with bf16 tokens)."""
    d_tm = d_tokens.transpose(0, 1)
    if d_tokens.is_cuda:
        q_tokens, d_tm = q_tokens.to(torch.bfloat16), d_tm.to(torch.bfloat16)
    return maxsim_scores_tm(q_tokens, q_mask, d_tm.contiguous())


def maxsim_search_tm(
    q_tokens: torch.Tensor,
    q_mask: torch.Tensor,
    corpus_tm: torch.Tensor,
    doc_valid: torch.Tensor,
    k: int = 1000,
    use_pallas: bool | None = None,
    *,
    outer_block: int = 65536,
) -> RankedLists:
    """Streaming MaxSim top-k over a PREPARED token corpus
    (``prepare_token_corpus``): blocks of ``outer_block`` docs are scored
    and merged into a running top-k; invalid docs score -inf.
    ``use_pallas`` is JAX's, checked and dropped (``check_use_pallas``)."""
    check_use_pallas(use_pallas)
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


def maxsim_search(
    q_tokens: torch.Tensor,
    q_mask: torch.Tensor,
    corpus_tokens: torch.Tensor,
    corpus_mask: torch.Tensor,
    k: int = 1000,
    doc_block: int = 1024,
    use_pallas: bool | None = None,
    *,
    outer_block: int = 65536,
) -> RankedLists:
    """Streaming MaxSim top-k over a doc-major [N, Ld, D] token matrix with
    an [N, Ld] mask, zeroed-mask semantics; fully masked docs never rank.

    On the card (JAX's ``use_pallas=True`` path): masked tokens are zeroed,
    and each block of ``outer_block`` docs is relayouted token-major (bf16)
    and scored through K1.  On the CPU: the dense reference
    (``maxsim_scores_zeromask``) over blocks of ``doc_block`` docs.  Both clamp
    the tail block into range and mask the overlap, so ids and ties match
    ``fusion_tpu``'s blocked top-k.  ``use_pallas`` is checked and dropped:
    the device picks the path."""
    check_use_pallas(use_pallas)
    n = corpus_tokens.shape[0]
    q = q_tokens.shape[0]
    k = min(k, n)
    zeroed = corpus_tokens * corpus_mask[..., None].to(corpus_tokens.dtype)
    doc_valid = corpus_mask.amax(dim=1) > 0
    if corpus_tokens.is_cuda:
        block = min(outer_block, n)
        q_b = q_tokens.to(torch.bfloat16)

        def score(d_blk):
            return maxsim_scores_tm(q_b, q_mask, d_blk.transpose(0, 1).to(torch.bfloat16).contiguous())
    else:
        block = min(doc_block, n)

        def score(d_blk):
            return maxsim_scores_zeromask(q_tokens, q_mask, d_blk)

    offsets = torch.arange(block, device=corpus_tokens.device)

    def block_scores(bi: int):
        start = bi * block
        real_start = min(start, n - block)
        scores = score(zeroed[real_start : real_start + block])
        fresh = (real_start + offsets >= start) & doc_valid[real_start : real_start + block]
        return torch.where(fresh[None, :], scores, -torch.inf), real_start

    return blockwise_topk_offset(block_scores, -(-n // block), q, k)
