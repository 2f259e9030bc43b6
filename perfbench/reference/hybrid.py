"""Reference hybrid search: each leg's exact scores, RRF, the rerank.

    BM25     score(q, d) = sum_t qtf(t) idf(t) tf(t,d)(k1+1) / (tf(t,d) + k1(1 - b + b |d| / avgdl)),
             idf(t) = log10((N - df(t) + 0.5) / (df(t) + 0.5)), over the documents' words
    DPR      cos(mean-pooled query, document row)
    SPLADE   cos(query activations, document row)
    ColBERT  sum over query tokens of the max over the document's Ld slots of
             q . d (slots past the document's length are zero vectors)
    RRF      sum over legs of 1 / (60 + rank), rank from 1, over each leg's top k
    rerank   the cross-encoder's logit of [CLS] q [SEP] d (q's first 32 tokens,
             d's first Lce), the fused head re-sorted by it

Queries are tokenized here again, with the hashing tokenizer's rule
(``perfbench.textgen``): DPR and SPLADE ``[CLS] words [SEP]`` padded to the
query length; ColBERT the same with pads turned into attended ``[MASK]``.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench import textgen
from perfbench.reference import encoder as E

CE_QUERY_TOKENS = 32  # the searcher's default query cut of the rerank
RRF_K = 60.0
DOC_BLOCK = 256  # documents per block of the ColBERT product
ROW_BLOCK = 4096  # documents per block of the DPR / SPLADE products
PAIR_BLOCK = 128  # pairs per cross-encoder forward


class HybridReference:
    def __init__(self, cfg: dict, inputs, device, precision: str = "fp32"):
        self.cfg, self.inputs, self.precision = cfg, inputs, precision
        self.device = torch.device(device)
        self.enc = cfg["encoder"]
        self.w = inputs.weights
        self._bm25 = None

    # -- tokenization -------------------------------------------------------
    def _tokens(self, texts, length: int, augment: bool):
        v = self.enc["vocab_size"]
        ids = np.full((len(texts), length), textgen.PAD_ID, np.int64)
        mask = np.zeros((len(texts), length), np.int64)
        for i, t in enumerate(texts):
            row = [textgen.CLS_ID] + textgen.token_ids(t, v)[: length - 2] + [textgen.SEP_ID]
            ids[i, : len(row)] = row
            mask[i, : len(row)] = 1
        if augment:
            ids = np.where(mask > 0, ids, textgen.MASK_ID)
            mask[:] = 1
        dev = self.device
        return torch.as_tensor(ids, device=dev), torch.as_tensor(mask, device=dev)

    # -- each leg's scores over the whole corpus ----------------------------
    def bm25_matrix(self) -> torch.Tensor:
        """[W, N] f32 impacts over the word vocabulary, from the word ids."""
        if self._bm25 is None:
            inp, n = self.inputs, self.inputs.n_docs
            k1, b = self.cfg["bm25"]["k1"], self.cfg["bm25"]["b"]
            words = self.cfg["corpus"]["words"]
            doc = np.repeat(np.arange(n), inp.doc_words)
            pair, tf = np.unique(doc * words + inp.doc_flat, return_counts=True)
            d, t = pair // words, pair % words
            df = np.bincount(t, minlength=words).astype(np.float64)
            idf = np.log10((n - df + 0.5) / (df + 0.5))
            dl = inp.doc_words.astype(np.float64)
            imp = idf[t] * tf * (k1 + 1.0) / (tf + k1 * (1.0 - b + b * dl[d] / dl.mean()))
            m = torch.zeros((words, n), dtype=torch.float32, device=self.device)
            m[torch.as_tensor(t, device=self.device), torch.as_tensor(d, device=self.device)] = torch.as_tensor(
                imp, dtype=torch.float32, device=self.device)
            self._bm25 = m
        return self._bm25

    def query_words(self, rows: np.ndarray) -> torch.Tensor:
        """[Q, W] word counts of the pool's queries ``rows``."""
        inp, words = self.inputs, self.cfg["corpus"]["words"]
        out = np.zeros((len(rows), words), np.float32)
        for i, r in enumerate(rows):
            np.add.at(out[i], inp.query_flat[inp.query_offsets[r] : inp.query_offsets[r + 1]], 1.0)
        return torch.as_tensor(out, device=self.device)

    def _rows_cos(self, q: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
        q = q / q.norm(dim=1, keepdim=True).clamp(min=1e-12)
        out = []
        for s in range(0, rows.shape[0], ROW_BLOCK):
            r = rows[s : s + ROW_BLOCK].float()
            r = r / r.norm(dim=1, keepdim=True).clamp(min=1e-12)
            out.append(E.matmul(q, r.T, self.precision))
        return torch.cat(out, dim=1)

    def _maxsim(self, q_tok: torch.Tensor, q_mask: torch.Tensor) -> torch.Tensor:
        inp, n = self.inputs, self.inputs.n_docs
        qn, lq, d = q_tok.shape
        flat = q_tok.reshape(qn * lq, d)
        out = []
        for s in range(0, n, DOC_BLOCK):
            e = min(s + DOC_BLOCK, n)
            docs = (inp.colbert_tokens[s:e].float() * inp.colbert_mask[s:e, :, None]).reshape(-1, d)
            sim = E.matmul(flat, docs.T, self.precision).view(qn, lq, e - s, -1).amax(dim=-1)
            out.append((sim * q_mask.float()[:, :, None]).sum(dim=1))
        return torch.cat(out, dim=1)

    def leg_scores(self, rows: np.ndarray) -> dict[str, torch.Tensor]:
        """[Q, N] f32 scores of each leg for the pool's queries ``rows``."""
        texts = [self.inputs.query_texts[r] for r in rows]
        lq, p = self.cfg["query_length"], self.precision
        ids, mask = self._tokens(texts, lq, augment=False)
        cb_ids, cb_mask = self._tokens(texts, lq, augment=True)
        out = {}
        out["bm25"] = E.matmul(self.query_words(rows), self.bm25_matrix(), p)
        out["dpr"] = self._rows_cos(E.dense_embed(self.w["dense"], self.enc, ids, mask, p), self.inputs.dpr_rows)
        out["splade"] = self._rows_cos(E.splade_embed(self.w["splade"], self.enc, ids, mask, p),
                                       self.inputs.splade_rows)
        out["colbert"] = self._maxsim(E.colbert_embed(self.w["colbert"], self.enc, cb_ids, cb_mask, p), cb_mask)
        return out

    # -- the rerank ---------------------------------------------------------
    def cross_logits(self, rows: np.ndarray, doc_ids: np.ndarray) -> torch.Tensor:
        """[Q, K] logits of the pairs (pool query ``rows[i]``, doc ``doc_ids[i, j]``)."""
        inp, v = self.inputs, self.enc["vocab_size"]
        q_raw = [textgen.token_ids(self.inputs.query_texts[r], v)[:CE_QUERY_TOKENS] for r in rows]
        d_tok = (inp.ce_doc_tokens.long() & 0xFFFF).cpu().numpy()
        pairs = []
        for i, r in enumerate(rows):
            for doc in doc_ids[i]:
                n_d = int(inp.ce_doc_lens[doc])
                pairs.append([textgen.CLS_ID] + q_raw[i] + [textgen.SEP_ID] + d_tok[doc, :n_d].tolist())
        out = []
        for s in range(0, len(pairs), PAIR_BLOCK):
            chunk = pairs[s : s + PAIR_BLOCK]
            width = max(len(x) for x in chunk)
            ids = np.full((len(chunk), width), textgen.PAD_ID, np.int64)
            mask = np.zeros((len(chunk), width), np.int64)
            for j, x in enumerate(chunk):
                ids[j, : len(x)] = x
                mask[j, : len(x)] = 1
            ids_t, mask_t = torch.as_tensor(ids, device=self.device), torch.as_tensor(mask, device=self.device)
            out.append(E.cross_logits(self.w["cross"], self.enc, ids_t, mask_t, self.precision))
        return torch.cat(out).view(len(rows), -1)

    # -- the whole pipeline (the control's stand-in for the program) --------
    def search(self, rows: np.ndarray, rerank_depth: int) -> dict:
        """Outputs in the program's form: each leg's top k, the fused list and
        the final list, as host (ids int64, scores f32) pairs."""
        k = self.cfg["topk"]
        legs = {}
        for leg, scores in self.leg_scores(rows).items():
            s, i = torch.topk(scores, k, dim=1)
            legs[leg] = (i.cpu().numpy(), s.cpu().numpy())
        fused = rrf(legs, k)
        final = fused
        if rerank_depth:
            head = fused[0][:, :rerank_depth]
            logits = self.cross_logits(rows, head).cpu().numpy()
            final = merge_head(fused, logits, rerank_depth)
        return {"legs": legs, "fused": fused, "final": final}


def rrf_totals(legs: dict, q: int) -> dict[int, float]:
    """Row ``q``'s RRF total of every document in the legs' host lists."""
    total: dict[int, float] = {}
    for leg_ids, _ in legs.values():
        for r, doc in enumerate(leg_ids[q]):
            if doc >= 0:
                total[int(doc)] = total.get(int(doc), 0.0) + 1.0 / (RRF_K + r + 1)
    return total


def rrf(legs: dict, k: int):
    """RRF over host (ids, scores) lists → top k (ids, scores), ties by id."""
    qn = next(iter(legs.values()))[0].shape[0]
    ids = np.zeros((qn, k), np.int64)
    scores = np.zeros((qn, k), np.float32)
    for q in range(qn):
        best = sorted(rrf_totals(legs, q).items(), key=lambda kv: (-kv[1], kv[0]))[:k]
        ids[q, : len(best)] = [d for d, _ in best]
        scores[q, : len(best)] = [s for _, s in best]
    return ids, scores


def merge_head(fused, logits: np.ndarray, depth: int):
    """The head re-sorted by sigmoid(logit) and lifted above the tail."""
    ids, scores = fused
    sig = 1.0 / (1.0 + np.exp(-logits.astype(np.float64)))
    order = np.argsort(-sig, axis=1, kind="stable")
    head_ids = np.take_along_axis(ids[:, :depth], order, 1)
    head_scores = np.take_along_axis(sig, order, 1)
    if ids.shape[1] > depth:
        head_scores = head_scores + scores[:, depth : depth + 1] + 1.0
    return (np.concatenate([head_ids, ids[:, depth:]], 1),
            np.concatenate([head_scores.astype(np.float32), scores[:, depth:]], 1))
