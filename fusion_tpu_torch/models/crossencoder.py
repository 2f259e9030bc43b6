"""monoBERT cross-encoder reranker.

Pointwise relevance over (query, document) pairs: the encoder trunk reads
``[CLS] q [SEP] d``, a CLS head gives one logit.  Reranking scores a fused
candidate list's head and re-sorts it (``serving.rerank_head_merge``).

The corpus is tokenized once (``prepare_corpus_tokens``) into a device
matrix of raw doc tokens, uint16 ids held as int16 bits when the vocabulary
fits, so serving assembles pairs on the device and never re-tokenizes a
document.  Two ways to score a batch's ``[Q, K]`` candidates:

  * ``rerank_tokens`` — flat: every pair padded to the full doc width
    (rounded so the pair length is a multiple of 128), scored in chunks of
    ``pair_chunk`` pairs;
  * ``rerank_tokens_packed`` — packed: the host plans a first-fit-decreasing
    packing of the pairs into rows of ``row_width`` tokens
    (``pack_pairs``, ``plan_packed``), the device assembles the rows
    (``assemble_packed_rows``) and scores them with block-diagonal segment
    attention and positions that restart at each pair, so every pair sees
    exactly the tokens and positions it has alone.

Both give the same logits up to the order of float sums.  Two more stages
trade work for padding or depth:

  * ``rerank_tokens_bucketed`` — each pair padded only to the smallest rung
    of a doc-width ladder that holds its doc (``aligned_buckets``: pair
    lengths on multiples of 128), each rung's pair count snapped to
    ``_BUCKET_CHUNK_GRID``, which fixes the padding and so the FLOPs;
  * ``rerank_tokens_cascade`` — every candidate scored with its doc cut to
    ``stage1_tokens``, the top ``keep`` rescored at full width, the rest
    shifted below the kept minimum.

All of it lives in ``PairRerankMixin``, which ``CrossEncoder`` and
``models/t5.py``'s ``T5CrossEncoder`` share; a backbone supplies its
forwards and its pair layout.  ``predict``, ``rank`` and ``rerank`` are the
host-side API over text pairs; ``save`` / ``load`` read and write the JAX
package's checkpoint format.  ``quantized`` and ``with_attention`` are
serving views holding the same parameters.  Training builds the model with
``param_dtype=torch.float32`` and scores with ``score_tokens_train``, the
grad-enabled forward with dropout.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch
from torch import nn

from fusion_tpu_torch.core.device import resolve_device
from fusion_tpu_torch.core.ranked import RankedLists, ranked_from_scores, stable_topk
from fusion_tpu_torch.data.tokenization import (
    HFTokenizer,
    WordHashTokenizer,
    pair_encode_simple,
    tokenizer_config,
    tokenizer_from_config,
)
from fusion_tpu_torch.models import checkpoint, convert
from fusion_tpu_torch.models.checkpoint import CONFIG_FILENAME  # noqa: F401 - the JAX module's name
from fusion_tpu_torch.models.encoder import (
    DropoutKey,
    Encoder,
    EncoderConfig,
    EncoderViews,
    init_weights,
    load_hf_encoder_params,
    place,
    token_tensors,
)
from fusion_tpu_torch.models.heads import CrossEncoderHead
from fusion_tpu_torch.utils.profiling import count, enabled, span

# chunk-count grid of the packed plan and the bucketed stage: dense through
# 16, then ~12 % steps.  Snapping a count to it fixes the padding (and so the
# FLOPs) as the JAX package's does, so ``plan_packed`` returns JAX's arrays
_BUCKET_CHUNK_GRID = (
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
    18, 20, 22, 25, 28, 32, 36, 40, 45, 51, 57, 64, 72, 81, 91, 102, 114, 128,
)


class CrossEncoderModule(nn.Module):
    """Encoder trunk + CLS relevance head."""

    def __init__(self, cfg: EncoderConfig):
        super().__init__()
        self.encoder = Encoder(cfg)
        self.head = CrossEncoderHead(cfg.hidden_size)

    def forward(
        self, input_ids: torch.Tensor, attention_mask: torch.Tensor, drop: DropoutKey | None = None
    ) -> torch.Tensor:
        return self.head(self.encoder(input_ids, attention_mask, drop=drop))

    def packed(self, input_ids, attention_mask, position_ids, segment_ids, gather_row, gather_col):
        """Packed-row scoring: many pairs per row, each pair's logit read from
        its own CLS slot at ``(gather_row[p], gather_col[p])``."""
        hidden = self.encoder(input_ids, attention_mask, position_ids, segment_ids)
        return self.head(hidden[gather_row, gather_col][:, None, :])


def _count_rows(n_rows: int, width: int, plen) -> None:
    """The rerank's counters for ``n_rows`` scored rows of ``width`` slots
    whose pairs attend to ``plen`` tokens each (a host array, or a device
    tensor read when the record is): rows, the pairs' tokens against the
    rows' slots, and attention's token pairs (a pair's tokens attend only to
    each other) against the rows' width²."""
    if isinstance(plen, np.ndarray):
        plen = plen.astype(np.int64)
        tokens, pairs = int(plen.sum()), int((plen * plen).sum())
    else:
        plen = plen.long()
        tokens, pairs = plen.sum(), (plen * plen).sum()
    count("rerank.rows", n_rows)
    count("rerank.row_tokens", tokens)
    count("rerank.row_slots", n_rows * width)
    count("rerank.attn_pairs", pairs)
    count("rerank.attn_slots", n_rows * width * width)


def assemble_pair_rows(desc, q_ids, drows, R: int, W: int, cls_id, sep_id, pad_id, pos_start: int, pos_pad: int):
    """Packed token rows of a plan's pairs, laid out ``[CLS | q | SEP | d]``
    (``cls_id`` None: ``[q | SEP | d]``): ``desc`` [6, P] (``plan_packed``),
    the queries' raw tokens [Q, Lq] and the pairs' doc tokens [P, Ld] →
    (ids, mask, segment ids, positions), each [R, W] int64.  A slot's owning
    pair is the running max of the pairs' scattered (index + 1) start
    markers; slots past its length are padding (segment 0, position
    ``pos_pad``), and a pair's slot t has position ``t + pos_start``."""
    qrow, _, prow, poff, qlen, dlen = (d.long() for d in desc)
    dev = desc.device
    lead = 0 if cls_id is None else 1
    n_pairs = qrow.shape[0]
    plen = lead + 1 + qlen + dlen
    start = torch.zeros(R * W, dtype=torch.int64, device=dev)
    start[prow * W + poff] = torch.arange(1, n_pairs + 1, device=dev)
    own = torch.cummax(start.view(R, W), dim=1).values
    p = (own - 1).clamp(min=0)
    t = torch.arange(W, device=dev)[None, :] - poff[p]
    ql = qlen[p]
    inseg = (own > 0) & (t < plen[p])
    qtok = q_ids[qrow[p], (t - lead).clamp(0, q_ids.shape[1] - 1)].long()
    dtok = drows[p, (t - lead - 1 - ql).clamp(0, drows.shape[1] - 1)].long()
    ids = torch.where(
        inseg & (t >= lead) & (t < ql + lead), qtok,
        torch.where(inseg & (t == ql + lead), sep_id, torch.where(inseg & (t > ql + lead), dtok, pad_id)),
    )
    if lead:
        ids = torch.where(inseg & (t == 0), cls_id, ids)
    mask = inseg.long()
    return ids, mask, own * mask, torch.where(inseg, t + pos_start, pos_pad)


class PairRerankMixin:
    """The device (query, doc) pair rerank surface shared by cross-encoder
    backbones (``CrossEncoder``, ``T5CrossEncoder``).

    A backbone provides ``score_tokens(ids, mask)`` and
    ``packed_score_tokens(...)``, the attributes ``cfg`` (with
    ``vocab_size``), ``max_length``, ``tokenizer``, ``device`` and
    ``module``; it may override ``_pair_layout`` (default ``[CLS | q | SEP |
    d]``), ``PAIR_SPECIALS`` (the special slots that layout inserts),
    ``_packed_consts`` and ``assemble_packed_rows``."""

    PAIR_SPECIALS = 2  # [CLS] and [SEP] inside a pair: [CLS | q | SEP | d]

    # -- corpus and query tokens ----------------------------------------
    def prepare_corpus_tokens(
        self, documents: Sequence[str], max_doc_tokens: int | None = None, return_lens: bool = False
    ):
        """Tokenize the corpus once: raw doc tokens (no specials) ``[N, Ld]``
        and their int8 mask on the device, with the host token counts when
        ``return_lens``.  Ids are uint16 held as int16 bits when the
        vocabulary fits (half the memory of int32), int32 otherwise."""
        ld = max_doc_tokens if max_doc_tokens is not None else max(self.max_length - 36, 16)
        ids, mask = self.tokenizer(documents, max_length=ld, add_special_tokens=False)
        ids = np.asarray(ids)
        if self.cfg.vocab_size <= 65_535:
            ids = ids.astype(np.uint16).view(np.int16)
        mask_np = np.asarray(mask, dtype=np.int8)
        out = (
            torch.as_tensor(ids, device=self.device),
            torch.as_tensor(mask_np, device=self.device),
        )
        if return_lens:
            return out + (mask_np.sum(axis=1).astype(np.int32),)
        return out

    def encode_queries_raw(
        self, queries: Sequence[str], max_query_tokens: int = 32
    ) -> tuple[np.ndarray, np.ndarray]:
        """Raw query tokens (no specials), as host arrays."""
        return self.tokenizer(queries, max_length=max_query_tokens, add_special_tokens=False)

    @staticmethod
    def _token_ids(tokens: torch.Tensor) -> torch.Tensor:
        """Stored doc tokens → int64 ids (int16 storage holds uint16 bits)."""
        ids = tokens.to(torch.int64)
        return ids & 0xFFFF if tokens.dtype == torch.int16 else ids

    def _pair_layout(self, q_ids, q_mask, d_ids, d_mask):
        """[n, Lq] + [n, Ld] → pair tokens [n, 2 + Lq + Ld] laid out
        ``[CLS | q | SEP | d]``: query padding stays mid-sequence with
        attention 0, and every unattended slot holds the pad id so RoBERTa
        positions skip it."""
        n = q_ids.shape[0]
        tok = self.tokenizer
        dev = q_ids.device
        col = lambda v: torch.full((n, 1), v, dtype=torch.int64, device=dev)  # noqa: E731
        ids = torch.cat([col(tok.cls_token_id), q_ids.long(), col(tok.sep_token_id), d_ids.long()], dim=-1)
        mask = torch.cat([col(1), q_mask.long(), col(1), d_mask.long()], dim=-1)
        return torch.where(mask > 0, ids, tok.pad_token_id), mask

    def _score_pairs_chunked(self, flat_ids, flat_mask, pair_chunk: int) -> torch.Tensor:
        """[n, L] pair tokens → [n] logits, ``pair_chunk`` pairs per forward
        to bound activation memory."""
        n = flat_ids.shape[0]
        if enabled():  # one pair a row: the flat, cascade and bucketed stages
            _count_rows(n, flat_ids.shape[1], flat_mask.sum(dim=1))
        out = torch.empty(n, dtype=torch.float32, device=flat_ids.device)
        for s in range(0, n, max(1, pair_chunk)):
            out[s : s + pair_chunk] = self.score_tokens(flat_ids[s : s + pair_chunk], flat_mask[s : s + pair_chunk])
        return out

    def rerank_tokens(self, q_ids, q_mask, doc_ids, doc_mask, pair_chunk: int = 512) -> torch.Tensor:
        """Flat candidate scoring: queries [Q, Lq] against their candidates'
        doc tokens [Q, K, Ld] → logits [Q, K].  The pair length is padded
        with attention-0 slots to a multiple of 128."""
        q, k, ld = doc_ids.shape
        lq = q_ids.shape[1]
        qe = q_ids[:, None, :].expand(q, k, lq).reshape(q * k, lq)
        qm = q_mask[:, None, :].expand(q, k, lq).reshape(q * k, lq)
        d_ids = doc_ids.reshape(q * k, ld)
        d_msk = doc_mask.reshape(q * k, ld)
        pad = -(self.PAIR_SPECIALS + lq + ld) % 128
        if pad:
            d_ids = torch.nn.functional.pad(d_ids, (0, pad))
            d_msk = torch.nn.functional.pad(d_msk, (0, pad))
        ids, mask = self._pair_layout(qe, qm, d_ids, d_msk)
        return self._score_pairs_chunked(ids, mask, pair_chunk).reshape(q, k)

    def rerank_tokens_cascade(
        self, q_ids, q_mask, doc_ids, doc_mask, keep: int, stage1_tokens: int, pair_chunk: int = 512
    ) -> torch.Tensor:
        """Two-stage flat scoring → logits [Q, K]: every candidate with its
        doc cut to ``stage1_tokens``, then the top ``keep`` real candidates
        by stage-1 logit (ties to the lower slot, as ``lax.top_k``) at full
        width.  Kept slots carry their full-width logits, the rest their
        stage-1 logits shifted below the kept minimum by ``max(rest_max -
        kept_min + 1, 0)``, so one total order holds.  With ``keep >= K`` or
        ``stage1_tokens >= Ld`` one flat pass scores every candidate, equal
        to ``rerank_tokens``."""
        q, k, ld = doc_ids.shape
        keep = max(1, min(keep, k))
        w1 = min(stage1_tokens, ld)
        if keep >= k or w1 >= ld:
            return self.rerank_tokens(q_ids, q_mask, doc_ids, doc_mask, pair_chunk)
        s1 = self.rerank_tokens(q_ids, q_mask, doc_ids[:, :, :w1], doc_mask[:, :, :w1], pair_chunk)
        # pad slots (doc mask all 0) score a query-only pair: they may not
        # take a full-width slot from a real candidate
        valid = doc_mask.sum(dim=-1) > 0
        _, idx = stable_topk(torch.where(valid, s1, -torch.inf), keep)  # [Q, keep]
        d2 = torch.take_along_dim(doc_ids, idx[..., None], dim=1)
        m2 = torch.take_along_dim(doc_mask, idx[..., None], dim=1)
        s2 = self.rerank_tokens(q_ids, q_mask, d2, m2, pair_chunk)
        kept_min = s2.min(dim=1, keepdim=True).values
        kept = torch.zeros((q, k), dtype=torch.bool, device=s1.device).scatter_(1, idx, True)
        rest_max = torch.where(kept, -torch.inf, s1).max(dim=1, keepdim=True).values
        rest = s1 - torch.clamp(rest_max - kept_min + 1.0, min=0.0)
        return rest.scatter(1, idx, s2)

    # -- length-bucketed rerank (planned on the host) ---------------------
    @classmethod
    def aligned_buckets(cls, lq: int, ld_full: int, align: int = 128) -> tuple:
        """The doc-width ladder whose pair lengths (``PAIR_SPECIALS + lq +
        ld``) land on multiples of ``align``, up to the first rung that holds
        ``ld_full`` (the last rung may be wider than the corpus matrix)."""
        ladder = []
        k = 1
        while True:
            ld = align * k - (lq + cls.PAIR_SPECIALS)
            if ld > 0:
                ladder.append(ld)
            if ld >= ld_full:
                break
            k += 1
        return tuple(ladder)

    def _bucket_score_scatter(self, ld: int, pc: int, q_ids, q_mask, doc_tokens, doc_mask, packed, buf):
        """One rung: ``packed`` [4, cap] (query row, candidate, valid, output
        slot; fillers write the spill slot) → the rung's pairs at doc width
        ``ld`` scored ``pc`` per forward and written into ``buf``."""
        q_row, cand, pvalid, slot = packed.long().unbind(0)
        w = min(ld, doc_tokens.shape[1])
        d_ids = self._token_ids(doc_tokens[cand][:, :w])
        d_msk = doc_mask[cand][:, :w].long() * pvalid[:, None]
        if ld > w:  # a rung wider than the matrix: attention-0 pad slots
            d_ids = torch.nn.functional.pad(d_ids, (0, ld - w))
            d_msk = torch.nn.functional.pad(d_msk, (0, ld - w))
        ids, mask = self._pair_layout(q_ids[q_row], q_mask[q_row], d_ids, d_msk)
        buf[slot] = self._score_pairs_chunked(ids, mask, pc)
        return buf

    def rerank_tokens_bucketed(
        self,
        q_ids: torch.Tensor,
        q_mask: torch.Tensor,
        doc_tokens: torch.Tensor,
        doc_mask: torch.Tensor,
        head_ids: np.ndarray,
        doc_lens: np.ndarray,
        buckets: Sequence[int] | None = None,
        pair_chunk: int = 512,
    ) -> torch.Tensor:
        """Length-bucketed scoring → logits [Q, Kr] on the device: each
        pair padded only to the smallest rung of ``buckets`` (default
        ``aligned_buckets``) that holds its doc, which scores it exactly as
        at full width (pad slots carry attention 0 and do not move RoBERTa
        positions).  ``head_ids`` (pads -1) and ``doc_lens`` are host
        arrays.  A rung's pair count is rounded up to a grid multiple of
        its chunk, filler pairs included in the work."""
        qn, kr = head_ids.shape
        n_docs, ld_full = doc_tokens.shape
        n = qn * kr
        with span("rerank.plan"):
            flat = head_ids.reshape(-1).astype(np.int64)
            valid = flat >= 0
            safe = np.clip(flat, 0, n_docs - 1)
            lens = np.where(valid, np.asarray(doc_lens)[safe], 0)
            if buckets is None:
                buckets = self.aligned_buckets(int(q_ids.shape[1]), ld_full)
            # the last rung must hold every stored doc width
            ladder = sorted({int(b) for b in buckets if b > 0})
            if not ladder or ladder[-1] < ld_full:
                ladder.append(ld_full)
            bidx = np.searchsorted(np.asarray(ladder), lens)
            rungs = []
            for bi, ld in enumerate(ladder):
                sel = np.nonzero(bidx == bi)[0]
                if sel.size == 0:
                    continue
                pc = min(pair_chunk, max(256, 1 << (sel.size - 1).bit_length()))
                units = -(-sel.size // pc)
                nchunks = next((g for g in _BUCKET_CHUNK_GRID if g >= units), units)
                cap = nchunks * pc
                packed = np.zeros((4, cap), np.int32)
                packed[0, : sel.size] = sel // kr
                packed[1, : sel.size] = safe[sel]
                packed[2, : sel.size] = valid[sel]
                packed[3, :] = n
                packed[3, : sel.size] = sel
                rungs.append((ld, pc, packed))
        buf = torch.zeros(n + 1, dtype=torch.float32, device=doc_tokens.device)  # slot n: the spill
        for ld, pc, packed in rungs:
            buf = self._bucket_score_scatter(
                ld, pc, q_ids, q_mask, doc_tokens, doc_mask, torch.as_tensor(packed, device=buf.device), buf
            )
        return buf[:n].reshape(qn, kr)

    # -- packed rerank (planned on the host, assembled on the device) ----
    @staticmethod
    def pack_pairs(plen: np.ndarray, width: int, quantum: int = 8):
        """Quantized first-fit-decreasing packing of pair lengths into rows
        of ``width`` tokens → (row, offset, n_rows).  Rows are kept in
        remaining-capacity classes of ``quantum`` tokens."""
        plen = np.asarray(plen, np.int64)
        if plen.size and int(plen.max()) > width:
            raise ValueError(f"pair length {int(plen.max())} exceeds row width {width}")
        order = np.argsort(-plen, kind="stable")
        nclasses = width // quantum
        buckets: list[list[int]] = [[] for _ in range(nclasses + 1)]
        rem: list[int] = []
        row = np.zeros(plen.shape[0], np.int32)
        off = np.zeros(plen.shape[0], np.int32)
        for pi in order:
            ln = int(plen[pi])
            r = -1
            for c in range(-(-ln // quantum), nclasses + 1):
                if buckets[c]:
                    r = buckets[c].pop()
                    break
            if r < 0:
                r = len(rem)
                rem.append(width)
            off[pi] = width - rem[r]
            rem[r] -= ln
            if rem[r] // quantum > 0:
                buckets[rem[r] // quantum].append(r)
            row[pi] = r
        return row, off, len(rem)

    def plan_packed(
        self,
        head_ids: np.ndarray,
        doc_lens: np.ndarray,
        q_lens: np.ndarray,
        lq_max: int,
        ld_max: int,
        n_docs: int,
        row_width: int | None = None,
        rows_per_chunk: int | None = None,
        chunk_multiple: int = 1,
    ):
        """The host packing plan of a batch's [Q, Kr] candidates (-1 pads are
        planned as empty-doc pairs) → (desc [6, P] int32: query row, doc,
        row, offset, query length, doc length, sorted by (row, offset);
        tables [nchunks, pc_cap, 3] int32: each chunk's pairs as (local row,
        column, output slot), fillers writing the spill slot Q·Kr; width,
        nchunks, rows per chunk, pc_cap).  ``nchunks`` is a multiple of
        ``chunk_multiple``, so each of that many ranks scores whole chunks
        (the sharded packed rerank)."""
        qn, kr = head_ids.shape
        flat = head_ids.reshape(-1).astype(np.int64)
        valid = flat >= 0
        safe = np.clip(flat, 0, n_docs - 1).astype(np.int32)
        dlen = np.minimum(np.where(valid, np.asarray(doc_lens)[safe], 0), ld_max).astype(np.int32)
        qrow = (np.arange(qn * kr) // kr).astype(np.int32)
        qlen = np.minimum(np.asarray(q_lens, np.int32), lq_max)[qrow]
        plen = (self.PAIR_SPECIALS + qlen + dlen).astype(np.int32)
        maxp = int(plen.max()) if plen.size else 2
        # default width: ~1.5x the longest pair, rounded up to a multiple of 128
        width = row_width or max(256, -(-(3 * maxp) // 256) * 128)
        row, off, n_rows = self.pack_pairs(plen, width)
        # (row, offset) order: the device's owner map is a running max of
        # scattered (index + 1) markers, right only if indices grow along a row
        perm = np.lexsort((off, row))
        qrow, safe, qlen, dlen, row, off = (a[perm] for a in (qrow, safe, qlen, dlen, row, off))
        rpc = rows_per_chunk or max(8, (64 * 512) // width)
        units = -(-max(n_rows, 1) // (rpc * chunk_multiple))
        nchunks = next((g for g in _BUCKET_CHUNK_GRID if g >= units), units) * chunk_multiple
        chunk_of = row // rpc
        counts = np.bincount(chunk_of, minlength=nchunks)
        cmax = int(counts.max()) if counts.size else 0
        pc_cap = max(8, 1 << max(0, cmax - 1).bit_length()) if cmax else 8
        tables = np.zeros((nchunks, pc_cap, 3), np.int32)
        tables[:, :, 2] = qn * kr  # the spill slot
        first = np.searchsorted(chunk_of, np.arange(nchunks))
        jj = np.arange(chunk_of.size) - first[chunk_of]
        tables[chunk_of, jj, 0] = row - chunk_of * rpc
        tables[chunk_of, jj, 1] = off
        tables[chunk_of, jj, 2] = perm
        desc = np.stack([qrow, safe, row, off, qlen, dlen]).astype(np.int32)
        return desc, tables, width, nchunks, rpc, pc_cap

    @property
    def _packed_consts(self) -> tuple:
        """(cls_id, sep_id, pad_id, roberta positions, the config's pad id)."""
        tok = self.tokenizer
        return (
            tok.cls_token_id,
            tok.sep_token_id,
            tok.pad_token_id,
            int(self.cfg.position_offset) != 0,
            int(self.cfg.pad_token_id),
        )

    @staticmethod
    def assemble_packed_rows(desc, q_ids, drows, R: int, W: int, consts):
        """Device assembly of packed token rows from the plan: ``desc``
        [6, P] (``plan_packed``), the queries' raw tokens [Q, Lq] and the
        pairs' doc tokens [P, Ld] → (ids, mask, segment ids, positions), each
        [R, W] int64, pairs laid out ``[CLS | q | SEP | d]``.  Every token of
        a pair is real, so its RoBERTa position is t + 1 past the pad index
        (bounded by the pair's length, not the row's); BERT's is t."""
        cls_id, sep_id, pad_id, roberta, cfg_pad = consts
        return assemble_pair_rows(desc, q_ids, drows, R, W, cls_id, sep_id, pad_id,
                                  pos_start=1 + cfg_pad if roberta else 0, pos_pad=cfg_pad if roberta else 0)

    def rerank_tokens_packed(
        self,
        q_ids: torch.Tensor,
        q_mask: torch.Tensor,
        doc_tokens: torch.Tensor,
        doc_mask: torch.Tensor,
        head_ids: np.ndarray,
        doc_lens: np.ndarray,
        q_lens: np.ndarray,
        row_width: int | None = None,
        rows_per_chunk: int | None = None,
    ) -> torch.Tensor:
        """Packed candidate scoring → logits [Q, Kr] on the device.
        ``head_ids`` (pads -1), ``doc_lens`` and ``q_lens`` are host arrays;
        ``doc_mask`` is not read (token counts stand in for contiguous
        masks).  Only rows that hold a pair are scored: the plan's chunks past
        the last packed row, and the empty rows of the last busy chunk, are
        skipped (their table entries are all fillers).  The plan runs in the
        host-only span ``rerank.plan``, which counts the scored rows' fill
        under tracing (``_count_rows``).  On the card the rows' attention in
        the ``flash`` form, and in the ``einsum`` form in bf16, runs the
        masked-attention kernel, which skips the key tiles between pairs
        (``models/encoder.packed_on_kernel``: inference, no dropout, head
        dim 64); each call counts ``attention.packed_kernel`` under tracing,
        and one that keeps its form's chain counts
        ``attention.packed_einsum``."""
        del doc_mask
        qn, kr = head_ids.shape
        with span("rerank.plan"):
            desc, tables, width, nchunks, rpc, pc_cap = self.plan_packed(
                head_ids, doc_lens, q_lens, int(q_ids.shape[1]), int(doc_tokens.shape[1]),
                int(doc_tokens.shape[0]), row_width=row_width, rows_per_chunk=rows_per_chunk,
            )
            n_rows = int(desc[2].max()) + 1 if desc.shape[1] else 0
            if enabled():
                _count_rows(n_rows, width, self.PAIR_SPECIALS + desc[4] + desc[5])
        dev = doc_tokens.device
        desc_t = torch.as_tensor(desc, device=dev)
        tables_t = torch.as_tensor(tables, device=dev).long()
        drows = self._token_ids(doc_tokens[desc_t[1].long()])
        ids, mask, seg, pos = self.assemble_packed_rows(
            desc_t, q_ids, drows, nchunks * rpc, width, self._packed_consts
        )
        buf = torch.zeros(qn * kr + 1, dtype=torch.float32, device=dev)
        for c in range(-(-n_rows // rpc)):
            rows = slice(c * rpc, min((c + 1) * rpc, n_rows))
            tb = tables_t[c]
            buf[tb[:, 2]] = self.packed_score_tokens(ids[rows], mask[rows], pos[rows], seg[rows], tb[:, 0], tb[:, 1])
        return buf[: qn * kr].reshape(qn, kr)

    def _encode_pairs(self, queries: Sequence[str], docs: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
        """Host (query, doc) pairs → (ids, mask) [n, max_length]."""
        return pair_encode_simple(self.tokenizer, queries, docs, self.max_length)

    def predict(
        self, pairs: Sequence[tuple[str, str]], batch_size: int = 64, apply_sigmoid: bool = True
    ) -> np.ndarray:
        """Relevance scores of (query, doc) pairs, ``batch_size`` per forward
        (the tail padded with empty pairs when there is more than one)."""
        out = []
        for start in range(0, len(pairs), batch_size):
            chunk = list(pairs[start : start + batch_size])
            real = len(chunk)
            while len(chunk) < batch_size and len(pairs) > batch_size:
                chunk.append(("", ""))
            ids, mask = self._encode_pairs([q for q, _ in chunk], [d for _, d in chunk])
            logits = self.score_tokens(*token_tensors(ids, mask, self.device))
            out.append(logits[:real].cpu().numpy())
        logits = np.concatenate(out, axis=0) if out else np.zeros(0, np.float32)
        return 1.0 / (1.0 + np.exp(-logits)) if apply_sigmoid else logits

    def rerank(
        self,
        queries: Sequence[str],
        candidates: RankedLists,
        corpus: Mapping[int, str] | Sequence[str],
        top_k: int = 100,
        batch_size: int = 64,
    ) -> RankedLists:
        """Rerank each query's top ``top_k`` candidates by relevance (one
        batched ``predict`` over every pair), on the host."""
        lookup = corpus if isinstance(corpus, Mapping) else dict(enumerate(corpus))
        k = min(top_k, candidates.depth)
        ids = candidates.ids.cpu().numpy()[:, :k]
        all_scores = np.full(ids.shape, -np.inf, dtype=np.float32)
        pairs, slots = [], []
        for qi, query in enumerate(queries):
            for col, cid in enumerate(ids[qi]):
                if cid >= 0:
                    pairs.append((query, lookup.get(int(cid), "")))
                    slots.append((qi, col))
        if pairs:
            rows, cols = zip(*slots)
            all_scores[np.asarray(rows), np.asarray(cols)] = self.predict(pairs, batch_size=batch_size)
        ranked = ranked_from_scores(torch.from_numpy(all_scores), k)
        pos = ranked.ids.numpy()
        remapped = np.take_along_axis(ids, np.clip(pos, 0, k - 1), axis=1)
        remapped = np.where(pos < 0, -1, remapped)
        return RankedLists(ids=torch.from_numpy(remapped.astype(np.int32)), scores=ranked.scores)


class CrossEncoder(EncoderViews, PairRerankMixin):
    """monoBERT cross-encoder on an explicit ``device``."""

    def __init__(
        self,
        cfg: EncoderConfig,
        params: Mapping[str, torch.Tensor] | None = None,
        tokenizer=None,
        max_length: int = 256,
        seed: int = 42,
        device="cuda",
        param_dtype: torch.dtype | None = None,
    ):
        self.cfg = cfg
        self.max_length = max_length
        self.device = resolve_device(device)
        self.module = self._build_module(cfg)
        if params is None:
            init_weights(self.module, seed)
        else:
            self.module.load_state_dict(params)
        place(self.module, cfg.dtype, self.device, param_dtype)
        self.tokenizer = tokenizer or WordHashTokenizer(vocab_size=cfg.vocab_size)

    @staticmethod
    def _build_module(cfg: EncoderConfig) -> CrossEncoderModule:
        return CrossEncoderModule(cfg)

    def _encode_pairs(self, queries: Sequence[str], docs: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
        """The tokenizer's own pair template where it has one (``HFTokenizer``),
        else ``[CLS] q [SEP] d [SEP]``."""
        if hasattr(self.tokenizer, "pair"):
            return self.tokenizer.pair(queries, docs, self.max_length)
        return pair_encode_simple(self.tokenizer, queries, docs, self.max_length)

    # -- scoring --------------------------------------------------------
    @torch.inference_mode()
    def score_tokens(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """Pair tokens [B, L] → f32 logits [B]."""
        return self.module(input_ids, attention_mask)

    def score_tokens_train(
        self, input_ids: torch.Tensor, attention_mask: torch.Tensor, drop: DropoutKey | None = None
    ) -> torch.Tensor:
        """The train-mode forward under autograd, dropout drawn from ``drop``."""
        return self.module(input_ids, attention_mask, drop)

    @torch.inference_mode()
    def packed_score_tokens(self, input_ids, attention_mask, position_ids, segment_ids, gather_row, gather_col):
        """Packed rows [R, W] → f32 logits [P] of the pairs whose CLS slots
        are (gather_row, gather_col)."""
        return self.module.packed(input_ids, attention_mask, position_ids, segment_ids, gather_row, gather_col)

    def rank(self, query: str, documents: Sequence[str], top_k: int | None = None, batch_size: int = 64) -> list[dict]:
        """One query's documents ranked by relevance."""
        scores = self.predict([(query, d) for d in documents], batch_size=batch_size)
        order = np.argsort(-scores, kind="stable")[: top_k or len(documents)]
        return [{"corpus_id": int(i), "score": float(scores[i])} for i in order]

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> None:
        """Write the checkpoint as the JAX package's ``CrossEncoder.save`` does."""
        config = {
            "model_type": "crossencoder",
            "max_length": self.max_length,
            "tokenizer": tokenizer_config(self.tokenizer),
            "encoder": checkpoint.encoder_config_dict(self.cfg),
        }
        checkpoint.write(path, config, self.flax_tree(self.module.state_dict()))

    def flax_tree(self, tensors) -> dict:
        """A state dict (or gradients keyed like it) → the JAX model's tree."""
        return convert.flax_tree(self.module, self.cfg.num_heads, tensors)

    @classmethod
    def from_pretrained_hf(
        cls, model_name_or_path: str, max_length: int = 256, seed: int = 42, *, dtype: torch.dtype = torch.float32,
        device="cuda", param_dtype: torch.dtype | None = None,
    ) -> "CrossEncoder":
        """Trunk weights from a local HuggingFace checkpoint directory, read
        without ``transformers`` (``load_hf_encoder_params``), computing in
        ``dtype`` on ``device``; the relevance head starts freshly seeded.
        A directory without tokenizer files gets the hashing tokenizer."""
        cfg, params = load_hf_encoder_params(model_name_or_path, dtype)
        try:
            tokenizer = HFTokenizer(model_name_or_path)
        except Exception:  # checkpoint without tokenizer files
            tokenizer = None
        model = cls(cfg, tokenizer=tokenizer, max_length=max_length, seed=seed, device=device,
                    param_dtype=param_dtype)
        model.module.encoder.load_state_dict(convert.encoder_state_dict(params["params"]["encoder"]))
        return model

    @classmethod
    def load(
        cls, path: str, tokenizer=None, device="cuda", dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype | None = None,
    ) -> "CrossEncoder":
        """Load a checkpoint written by either package, computing in
        ``dtype`` on ``device`` (weights held in ``param_dtype``, default
        ``dtype``), with the checkpoint's attention form and ``quantize``.
        A T5 cross-encoder checkpoint is ``T5CrossEncoder.load``'s."""
        config = checkpoint.read_config(path)
        if config.get("model_type") == "t5_crossencoder":
            raise ValueError(f"{path} holds a 't5_crossencoder' checkpoint: use T5CrossEncoder.load")
        if tokenizer is None:
            tokenizer = tokenizer_from_config(config.get("tokenizer"))
        return cls(
            checkpoint.encoder_config_from_dict(config["encoder"], dtype=dtype),
            params=convert.crossencoder_state_dict(checkpoint.read_params(path)),
            tokenizer=tokenizer,
            max_length=config["max_length"],
            device=device,
            param_dtype=param_dtype,
        )
