"""Bi-encoder retrieval models: DPR (dense) and SPLADE (learned sparse).

One class covers both families, which differ only in the head applied to
the shared encoder trunk:

  * head='dense'  → pooled hidden state (mean/max/cls)        [B, H]
  * head='splade' → log1p(relu(MLM logits)) max/sum pooled    [B, V]
                    with optional top-k pruning

The model holds its module on an explicit ``device``; ``encode`` returns the
embeddings as a tensor on that device, so an encoded corpus never makes a
host round trip (a SPLADE corpus at 28k docs is 1.8 GB in bf16).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from fusion_tpu_torch.data.tokenization import TextEncoder, WordHashTokenizer
from fusion_tpu_torch.models import heads
from fusion_tpu_torch.models.encoder import (
    Encoder,
    EncoderConfig,
    EncoderWithMLM,
    init_weights,
    place,
    token_tensors,
)


def bucket_width(mask: np.ndarray) -> int:
    """Smallest power-of-two width ≥ 16 (capped at the batch width) that holds
    every real token of the batch; trailing all-pad columns are trimmed."""
    real_w = int(mask.sum(axis=1).max()) or 1
    if real_w >= mask.shape[1]:
        return mask.shape[1]
    w = 16
    while w < real_w:
        w *= 2
    return min(w, mask.shape[1])


class BiEncoder:
    """Siamese encoder with a dense or sparse head."""

    def __init__(
        self,
        cfg: EncoderConfig,
        params: Mapping[str, torch.Tensor] | None = None,
        tokenizer=None,
        head: str = "dense",
        pooling: str | None = None,
        similarity: str = "cos_sim",
        pruning_topk: int | None = None,
        max_query_length: int = 32,
        max_doc_length: int = 128,
        query_prefix: str | None = None,
        doc_prefix: str | None = None,
        augment_query_to_maxlen: bool = False,
        augment_doc_to_maxlen: bool = False,
        do_lowercase: bool = False,
        seed: int = 42,
        device="cpu",
    ):
        if head not in ("dense", "splade"):
            raise ValueError(f"head must be 'dense' or 'splade', got {head!r}")
        if similarity not in ("cos_sim", "dot_score"):
            raise ValueError(f"similarity must be 'cos_sim' or 'dot_score', got {similarity!r}")
        self.cfg = cfg
        self.head = head
        self.pooling = pooling or ("max" if head == "splade" else "mean")
        allowed = ("max", "sum") if head == "splade" else ("mean", "max", "cls")
        if self.pooling not in allowed:
            raise ValueError(f"pooling {self.pooling!r} not in {allowed} for head {head!r}")
        self.similarity = similarity
        self.pruning_topk = pruning_topk
        self.device = torch.device(device)
        self.module = EncoderWithMLM(cfg) if head == "splade" else Encoder(cfg)
        if params is None:
            init_weights(self.module, seed)
        else:
            self.module.load_state_dict(params)
        place(self.module, cfg.dtype, self.device)
        tokenizer = tokenizer or WordHashTokenizer(vocab_size=cfg.vocab_size)
        self.text_encoder = TextEncoder(
            tokenizer,
            max_query_length=max_query_length,
            max_doc_length=max_doc_length,
            query_prefix=query_prefix,
            doc_prefix=doc_prefix,
            augment_query_to_maxlen=augment_query_to_maxlen,
            augment_doc_to_maxlen=augment_doc_to_maxlen,
            do_lowercase=do_lowercase,
        )

    @torch.inference_mode()
    def embed_tokens(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """Token batch → embeddings [B, H] (dense) or [B, V] (splade)."""
        if self.head == "splade":
            _, logits = self.module(input_ids, attention_mask)
            acts = heads.splade_activation(logits, attention_mask, self.pooling)
            if self.pruning_topk is not None:
                acts, _ = heads.prune_topk(acts, self.pruning_topk)
            return acts
        hidden = self.module(input_ids, attention_mask)
        return heads.pool(hidden, attention_mask, self.pooling)

    def encode(
        self,
        sentences: Sequence[str],
        query_mode: bool = True,
        batch_size: int = 32,
        sort_by_length: bool = False,
    ) -> torch.Tensor:
        """Encode texts in fixed-size batches (tail padded with "", then
        trimmed) into one tensor on the model's device, in input order.

        ``sort_by_length=True`` groups inputs by word count and trims each
        batch to the smallest power-of-two width that holds its real tokens
        (``bucket_width``), which cuts encoder work on natural-length corpora
        and leaves every embedding unchanged.
        """
        n = len(sentences)
        if sort_by_length and n > batch_size:
            order = np.argsort([len(s.split()) for s in sentences], kind="stable")
        else:
            order = np.arange(n)
        out = None
        for start in range(0, n, batch_size):
            sel = order[start : start + batch_size]
            chunk = [sentences[i] for i in sel]
            while len(chunk) < batch_size and n > batch_size:
                chunk.append("")
            ids, mask = self.text_encoder.encode(chunk, query_mode=query_mode)
            if sort_by_length:
                w = bucket_width(np.asarray(mask))
                ids, mask = ids[:, :w], mask[:, :w]
            embs = self.embed_tokens(*token_tensors(ids, mask, self.device))[: len(sel)]
            if out is None:
                out = torch.empty((n, embs.shape[1]), dtype=embs.dtype, device=self.device)
            out[torch.as_tensor(sel, device=self.device)] = embs
        if out is None:
            return torch.zeros((0, 1), dtype=torch.float32, device=self.device)
        return out

    def build_sparse_index(
        self, documents: Sequence[str], prune_topk: int = 128, batch_size: int = 32
    ):
        """Prune each doc's activations to its top ``prune_topk`` (host-side,
        numpy, one batch at a time) into a fixed-K ``SparseIndex`` on the
        model's device; ``cos_sim`` models l2-normalize each doc first."""
        if self.head != "splade":
            raise ValueError("the sparse index is for SPLADE models")
        from fusion_tpu_torch.index.sparse import build_sparse_index

        def batches():
            for start in range(0, len(documents), batch_size):
                embs = self.encode(
                    documents[start : start + batch_size], query_mode=False, batch_size=batch_size
                ).float().cpu().numpy()
                if self.similarity == "cos_sim":
                    norms = np.linalg.norm(embs, axis=-1, keepdims=True)
                    embs = embs / np.maximum(norms, 1e-12)
                yield embs

        return build_sparse_index(
            batches(), vocab_size=self.cfg.vocab_size, prune_topk=prune_topk, device=self.device
        )
