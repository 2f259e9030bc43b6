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

Both give the same logits up to the order of float sums.  ``predict``,
``rank`` and ``rerank`` are the host-side API over text pairs; ``save`` /
``load`` read and write the JAX package's checkpoint format.  Training
builds the model with ``param_dtype=torch.float32`` and scores with
``score_tokens_train``, the grad-enabled forward with dropout.  The JAX
package's cascade and length-bucketed stages, the int8 view
(``quantized``) and other attention implementations (``with_attention``)
are later work (ROADMAP.md Queue 1, items 9, 17 and 2).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch
from torch import nn

from fusion_tpu_torch.core.device import resolve_device
from fusion_tpu_torch.core.ranked import RankedLists, ranked_from_scores
from fusion_tpu_torch.data.tokenization import (
    WordHashTokenizer,
    pair_encode_simple,
    tokenizer_config,
    tokenizer_from_config,
)
from fusion_tpu_torch.models import checkpoint, convert
from fusion_tpu_torch.models.encoder import DropoutKey, Encoder, EncoderConfig, init_weights, place, token_tensors
from fusion_tpu_torch.models.heads import CrossEncoderHead

# chunk-count grid of the JAX package's packed plan: snapping a plan's chunk
# count to it bounds the shapes a compiled program sees; kept so that
# ``plan_packed`` returns JAX's arrays
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


class CrossEncoder:
    """monoBERT cross-encoder on an explicit ``device``."""

    PAIR_SPECIALS = 2  # [CLS] and [SEP] inside a pair: [CLS | q | SEP | d]

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
        self.module = CrossEncoderModule(cfg)
        if params is None:
            init_weights(self.module, seed)
        else:
            self.module.load_state_dict(params)
        place(self.module, cfg.dtype, self.device, param_dtype)
        self.tokenizer = tokenizer or WordHashTokenizer(vocab_size=cfg.vocab_size)

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
    ):
        """The host packing plan of a batch's [Q, Kr] candidates (-1 pads are
        planned as empty-doc pairs) → (desc [6, P] int32: query row, doc,
        row, offset, query length, doc length, sorted by (row, offset);
        tables [nchunks, pc_cap, 3] int32: each chunk's pairs as (local row,
        column, output slot), fillers writing the spill slot Q·Kr; width,
        nchunks, rows per chunk, pc_cap)."""
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
        units = -(-max(n_rows, 1) // rpc)
        nchunks = next((g for g in _BUCKET_CHUNK_GRID if g >= units), units)
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
    def assemble_packed_rows(desc, q_ids, drows, n_rows: int, width: int, consts):
        """Device assembly of packed token rows from the plan: ``desc``
        [6, P] (``plan_packed``), the queries' raw tokens [Q, Lq] and the
        pairs' doc tokens [P, Ld] → (ids, mask, segment ids, positions), each
        [R, W] int64.  A position's owning pair is the running max of the
        pairs' scattered (index + 1) start markers; positions past its length
        are padding (segment 0)."""
        cls_id, sep_id, pad_id, roberta, cfg_pad = consts
        qrow, _, prow, poff, qlen, dlen = (d.long() for d in desc)
        dev = desc.device
        n_pairs = qrow.shape[0]
        plen = 2 + qlen + dlen
        start = torch.zeros(n_rows * width, dtype=torch.int64, device=dev)
        start[prow * width + poff] = torch.arange(1, n_pairs + 1, device=dev)
        own = torch.cummax(start.view(n_rows, width), dim=1).values
        p = (own - 1).clamp(min=0)
        t = torch.arange(width, device=dev)[None, :] - poff[p]
        ql = qlen[p]
        inseg = (own > 0) & (t < plen[p])
        lq_max = q_ids.shape[1]
        qtok = q_ids[qrow[p], (t - 1).clamp(0, lq_max - 1)].long()
        dtok = drows[p, (t - 2 - ql).clamp(0, drows.shape[1] - 1)].long()
        ids = torch.where(
            inseg & (t == 0), cls_id,
            torch.where(
                inseg & (t == ql + 1), sep_id,
                torch.where(inseg & (t >= 1) & (t <= ql), qtok, torch.where(inseg & (t >= ql + 2), dtok, pad_id)),
            ),
        )
        mask = inseg.long()
        seg = own * mask
        if roberta:
            # every token of a pair is real, so its RoBERTa position is t + 1
            # past the pad index: bounded by the pair's length, not the row's
            pos = torch.where(inseg, t + 1 + cfg_pad, cfg_pad)
        else:
            pos = torch.where(inseg, t, 0)
        return ids, mask, seg, pos

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
        skipped (their table entries are all fillers)."""
        del doc_mask
        qn, kr = head_ids.shape
        desc, tables, width, nchunks, rpc, pc_cap = self.plan_packed(
            head_ids, doc_lens, q_lens, int(q_ids.shape[1]), int(doc_tokens.shape[1]),
            int(doc_tokens.shape[0]), row_width=row_width, rows_per_chunk=rows_per_chunk,
        )
        n_rows = int(desc[2].max()) + 1 if desc.shape[1] else 0
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

    # -- host API over text ---------------------------------------------
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
            ids, mask = pair_encode_simple(
                self.tokenizer, [q for q, _ in chunk], [d for _, d in chunk], self.max_length
            )
            logits = self.score_tokens(*token_tensors(ids, mask, self.device))
            out.append(logits[:real].cpu().numpy())
        logits = np.concatenate(out, axis=0) if out else np.zeros(0, np.float32)
        return 1.0 / (1.0 + np.exp(-logits)) if apply_sigmoid else logits

    def rank(self, query: str, documents: Sequence[str], top_k: int | None = None, batch_size: int = 64) -> list[dict]:
        """One query's documents ranked by relevance."""
        scores = self.predict([(query, d) for d in documents], batch_size=batch_size)
        order = np.argsort(-scores, kind="stable")[: top_k or len(documents)]
        return [{"corpus_id": int(i), "score": float(scores[i])} for i in order]

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

    def quantized(self, mode: str = "int8") -> "CrossEncoder":
        raise NotImplementedError(
            "CrossEncoder.quantized: the int8 views of the cross-encoder and encoders are not "
            "ported to fusion_tpu_torch yet (ROADMAP.md Queue 1, item 17)"
        )

    def with_attention(self, impl: str) -> "CrossEncoder":
        raise NotImplementedError(
            f"CrossEncoder.with_attention({impl!r}): the port's attention is the plain f32-logit "
            "math; other implementations are not ported yet (ROADMAP.md Queue 1, item 2)"
        )

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
    def load(
        cls, path: str, tokenizer=None, device="cuda", dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype | None = None,
    ) -> "CrossEncoder":
        """Load a checkpoint written by either package, computing in
        ``dtype`` on ``device`` (weights held in ``param_dtype``, default
        ``dtype``).  A T5 cross-encoder checkpoint raises."""
        config = checkpoint.read_config(path)
        if config.get("model_type") == "t5_crossencoder":
            raise NotImplementedError(
                "the checkpoint is a T5 cross-encoder: models/t5.py is not ported to fusion_tpu_torch "
                "yet (ROADMAP.md Queue 1, item 17)"
            )
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
