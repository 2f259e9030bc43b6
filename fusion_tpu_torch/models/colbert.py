"""ColBERT late-interaction retriever.

Per-token 128-d embeddings, query mask-augmentation (pads become [MASK] and
are attended), a punctuation skiplist on documents, and a device-resident
token index scored by MaxSim (``ops/maxsim.py``); ``ColBERT.search`` is the
retriever's own search over a token index or a compressed one.

Training builds the model with ``param_dtype=torch.float32`` and scores
with ``embed_tokens_train`` (the grad-enabled forward with dropout) and the
strict, f32 ``pairwise_maxsim`` / ``nway_maxsim``: plain batched products
under autograd, as the JAX package computes its train step outside any
Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import os
import string
import time
from typing import Mapping, Sequence

import numpy as np
import torch
from torch import nn

from fusion_tpu_torch.core.device import resolve_device
from fusion_tpu_torch.core.ranked import RankedLists
from fusion_tpu_torch.data.tokenization import (
    HFTokenizer,
    TextEncoder,
    WordHashTokenizer,
    tokenizer_config,
    tokenizer_from_config,
)
from fusion_tpu_torch.index.compression import compress_token_index, maxsim_search_compressed
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
from fusion_tpu_torch.models.heads import ColBERTHead
from fusion_tpu_torch.models.xmod import XmodEncoder, is_xmod, load_hf_xmod_params, set_module_language
from fusion_tpu_torch.ops.maxsim import maxsim_search, maxsim_search_tm, prepare_token_corpus

_PUNCT = set(string.punctuation)


class ColBERTModule(nn.Module):
    """Trunk (an ``XmodEncoder`` for an ``XmodConfig``) + projection head."""

    def __init__(self, cfg: EncoderConfig, dim: int = 128):
        super().__init__()
        self.encoder = XmodEncoder(cfg) if is_xmod(cfg) else Encoder(cfg)
        self.colbert = ColBERTHead(cfg.hidden_size, dim)

    def forward(
        self, input_ids: torch.Tensor, attention_mask: torch.Tensor, drop: DropoutKey | None = None
    ) -> torch.Tensor:
        return self.colbert(self.encoder(input_ids, attention_mask, drop=drop), attention_mask)


@dataclasses.dataclass
class TokenIndex:
    """Device-resident token-matrix index: [N, Ld, D] bf16 + [N, Ld] f32 mask.

    ``prepared()`` caches the search layout (token-major, masked tokens
    zeroed, per-doc validity) so query batches never relayout the corpus."""

    tokens: torch.Tensor
    mask: torch.Tensor
    _prepared: tuple | None = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def num_docs(self) -> int:
        return self.tokens.shape[0]

    def prepared(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(corpus_tm [Ld, N, D] bf16 zeroed, doc_valid [N] bool)."""
        if self._prepared is None:
            self._prepared = prepare_token_corpus(self.tokens, self.mask)
        return self._prepared

    def save(self, path: str) -> None:
        """``token_index.npz``: the tokens as f16 and the mask as int8, the
        JAX package's format (bf16 values below f16's normal range do not
        round-trip exactly)."""
        os.makedirs(path, exist_ok=True)
        np.savez_compressed(
            os.path.join(path, "token_index.npz"),
            tokens=self.tokens.to(torch.float16).cpu().numpy(),
            mask=self.mask.to(torch.int8).cpu().numpy(),
        )

    @classmethod
    def load(cls, path: str, device="cuda") -> "TokenIndex":
        device = resolve_device(device)
        with np.load(os.path.join(path, "token_index.npz")) as z:
            tokens = torch.from_numpy(z["tokens"]).to(device).to(torch.bfloat16)
            mask = torch.from_numpy(z["mask"].astype(np.float32)).to(device)
        return cls(tokens=tokens, mask=mask)


class ColBERT(EncoderViews):
    """Late-interaction bi-encoder with token-level MaxSim; ``quantized`` and
    ``with_attention`` give query-side serving views holding the same
    parameters."""

    def __init__(
        self,
        cfg: EncoderConfig,
        params: Mapping[str, torch.Tensor] | None = None,
        tokenizer=None,
        dim: int = 128,
        max_query_length: int = 32,
        max_doc_length: int = 128,
        mask_punctuation: bool = True,
        seed: int = 42,
        device="cuda",
        param_dtype: torch.dtype | None = None,
    ):
        self.cfg = cfg
        self.dim = dim
        self.mask_punctuation = mask_punctuation
        self.device = resolve_device(device)
        self.module = self._build_module(cfg)
        if params is None:
            init_weights(self.module, seed)
        else:
            self.module.load_state_dict(params)
        place(self.module, cfg.dtype, self.device, param_dtype)
        tokenizer = tokenizer or WordHashTokenizer(vocab_size=cfg.vocab_size)
        # ColBERT-style query augmentation: pad → [MASK], attended
        self.text_encoder = TextEncoder(
            tokenizer,
            max_query_length=max_query_length,
            max_doc_length=max_doc_length,
            augment_query_to_maxlen=True,
        )
        self._punct_ids = sorted(self._punctuation_token_ids(tokenizer))

    def _build_module(self, cfg: EncoderConfig) -> ColBERTModule:
        return ColBERTModule(cfg, dim=self.dim)

    def set_language(self, lang: str) -> "ColBERT":
        """Pin the X-MOD language adapter ('fr' or 'fr_XX') of the trunk."""
        if not is_xmod(self.cfg):
            raise ValueError("set_language needs an X-MOD trunk")
        set_module_language(self.module, self.cfg.lang_index(lang))
        return self

    @staticmethod
    def _punctuation_token_ids(tokenizer) -> set[int]:
        """Token ids whose surface form is pure punctuation (the colbert-ai
        document skiplist)."""
        ids: set[int] = set()
        if hasattr(tokenizer, "tok"):
            for tok, tid in tokenizer.tok.get_vocab().items():
                stripped = tok.lstrip("Ġ▁")
                if stripped and all(c in _PUNCT for c in stripped):
                    ids.add(tid)
        elif isinstance(tokenizer, WordHashTokenizer):
            for ch in string.punctuation:
                ids.update(tokenizer.token_ids(ch))
        return ids

    @torch.inference_mode()
    def embed_tokens(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """Token batch → per-token embeddings [B, L, dim] f32 (pads zeroed)."""
        return self.module(input_ids, attention_mask)

    def embed_tokens_train(
        self, input_ids: torch.Tensor, attention_mask: torch.Tensor, drop: DropoutKey | None = None
    ) -> torch.Tensor:
        """The train-mode forward under autograd, dropout drawn from ``drop``."""
        return self.module(input_ids, attention_mask, drop)

    @staticmethod
    def pairwise_maxsim(q_tok, q_mask, d_tok, d_mask) -> torch.Tensor:
        """Aligned MaxSim: query i vs doc i → [B]; masked doc tokens at -1e9,
        products summed in f32."""
        sim = torch.einsum("bid,bjd->bij", q_tok.float(), d_tok.float())
        sim = torch.where(d_mask[:, None, :] > 0, sim, -1e9)
        return (sim.amax(dim=-1) * q_mask).sum(dim=-1)

    @staticmethod
    def nway_maxsim(q_tok, q_mask, d_tok, d_mask) -> torch.Tensor:
        """Query i vs its N docs → [B, N]: q [B, Lq, D], docs [B, N, Ld, D],
        one batched product over all negatives."""
        sim = torch.einsum("bqd,bnld->bnql", q_tok.float(), d_tok.float())
        sim = torch.where(d_mask[:, :, None, :] > 0, sim, -1e9)
        return (sim.amax(dim=-1) * q_mask[:, None, :]).sum(dim=-1)

    def _encode_texts(
        self, texts: Sequence[str], query_mode: bool, batch_size: int
    ) -> tuple[torch.Tensor, np.ndarray]:
        """(token embeddings [n, L, dim] f32 on device, host masks [n, L])."""
        toks, masks = [], []
        for start in range(0, len(texts), batch_size):
            chunk = list(texts[start : start + batch_size])
            real = len(chunk)
            while len(chunk) < batch_size and len(texts) > batch_size:
                chunk.append("")
            ids, mask = self.text_encoder.encode(chunk, query_mode=query_mode)
            if not query_mode and self.mask_punctuation and self._punct_ids:
                mask = np.where(np.isin(ids, self._punct_ids), 0, mask)
            toks.append(self.embed_tokens(*token_tensors(ids, mask, self.device))[:real])
            masks.append(np.asarray(mask)[:real])
        return torch.cat(toks, dim=0), np.concatenate(masks, axis=0)

    def encode_queries(self, queries: Sequence[str], batch_size: int = 32):
        return self._encode_texts(queries, query_mode=True, batch_size=batch_size)

    def index(
        self, documents: Sequence[str], batch_size: int = 32, pad_docs_to: int = 128
    ) -> TokenIndex:
        """Encode the collection into a bf16 token-matrix index on the device;
        ``pad_docs_to`` rounds the doc count up with fully masked docs."""
        toks, masks = self._encode_texts(documents, query_mode=False, batch_size=batch_size)
        n = toks.shape[0]
        n_pad = -(-max(n, 1) // pad_docs_to) * pad_docs_to
        tokens = torch.zeros((n_pad,) + tuple(toks.shape[1:]), dtype=torch.bfloat16, device=self.device)
        tokens[:n] = toks
        mask = torch.zeros((n_pad, masks.shape[1]), dtype=torch.float32, device=self.device)
        mask[:n] = torch.as_tensor(masks, dtype=torch.float32, device=self.device)
        return TokenIndex(tokens=tokens, mask=mask)

    def index_compressed(
        self,
        documents: Sequence[str],
        batch_size: int = 32,
        pad_docs_to: int = 128,
        nbits: int = 2,
        kmeans_iters: int = 4,
        num_centroids: int | None = None,
        *,
        timings: dict | None = None,
    ):
        """Residual-compressed index (colbert-ai's nbits=2, kmeans_niters=4),
        about 7x smaller than the bf16 token matrix.  ``timings``, when given,
        receives the seconds spent encoding, in k-means and compressing."""
        t0 = time.perf_counter()
        raw = self.index(documents, batch_size=batch_size, pad_docs_to=pad_docs_to)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if timings is not None:
            timings["encode"] = time.perf_counter() - t0
        return compress_token_index(
            raw.tokens.to(torch.float32), raw.mask, nbits=nbits, kmeans_iters=kmeans_iters,
            num_centroids=num_centroids, timings=timings,
        )

    def search(
        self,
        queries,
        index,
        k: int = 1000,
        batch_size: int = 32,
        doc_block: int = 1024,
        use_pallas: bool = True,
    ) -> RankedLists:
        """Top-``k`` MaxSim search of ``queries`` (texts, or precomputed
        ``(tokens [Q, Lq, D], mask [Q, Lq])``) over ``index``, on the index's
        device.  Three branches, as ``fusion_tpu``'s ``ColBERT.search``:

          * a ``CompressedTokenIndex``: exhaustive search by block
            decompression (``maxsim_search_compressed``), ``doc_block`` 1024
            read as the compressed search's 8192;
          * a ``TokenIndex`` with ``use_pallas`` (the default): the prepared
            token-major corpus through ``maxsim_search_tm`` (K1 on the card);
          * a ``TokenIndex`` without: the doc-major token matrix through
            ``maxsim_search`` (K1 on the card, the dense reference in
            ``doc_block`` blocks on the CPU).

        Zeroed-mask semantics throughout; fully padded docs never rank."""
        if isinstance(queries, tuple) and len(queries) == 2 and not isinstance(queries[0], str):
            q_tok, q_mask = queries
        else:
            q_tok, q_mask = self.encode_queries(queries, batch_size=batch_size)
        device = index.mask.device
        q_tok = torch.as_tensor(q_tok).to(device=device, dtype=torch.float32)
        q_mask = torch.as_tensor(q_mask).to(device=device, dtype=torch.float32)
        if not isinstance(index, TokenIndex):  # CompressedTokenIndex
            return maxsim_search_compressed(
                q_tok, q_mask, index, k=k, doc_block=doc_block if doc_block != 1024 else 8192
            )
        if use_pallas:
            corpus_tm, doc_valid = index.prepared()
            q = q_tok.to(torch.bfloat16) if corpus_tm.is_cuda else q_tok
            return maxsim_search_tm(q, q_mask, corpus_tm, doc_valid, k=k)
        tokens = index.tokens if index.tokens.is_cuda else index.tokens.float()
        return maxsim_search(q_tok, q_mask, tokens, index.mask, k=k, doc_block=doc_block)

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> None:
        """Write the checkpoint as the JAX package's ``ColBERT.save`` does."""
        config = {
            "model_type": "colbert",
            "dim": self.dim,
            "mask_punctuation": self.mask_punctuation,
            "max_query_length": self.text_encoder.max_query_length,
            "max_doc_length": self.text_encoder.max_doc_length,
            "tokenizer": tokenizer_config(self.text_encoder.tokenizer),
            "encoder": checkpoint.encoder_config_dict(self.cfg),
        }
        checkpoint.write(path, config, self.flax_tree(self.module.state_dict()))

    def flax_tree(self, tensors) -> dict:
        """A state dict (or gradients keyed like it) → the JAX model's tree."""
        return convert.flax_tree(self.module, self.cfg.num_heads, tensors)

    @classmethod
    def from_pretrained_hf(
        cls, model_name_or_path: str, dim: int = 128, seed: int = 42, *, dtype: torch.dtype = torch.float32, **kw
    ) -> "ColBERT":
        """Trunk weights from a local HuggingFace checkpoint directory, read
        without ``transformers`` (``load_hf_encoder_params``: dropout 0, so
        ``with_attention("flash")`` trains through the attention kernels),
        computing in ``dtype``; the projection head is freshly seeded (as
        when starting ColBERT training from a plain LM checkpoint).  A
        directory without tokenizer files (or a machine without
        ``transformers``) gets the hashing tokenizer.  ``kw`` go to the
        constructor (``device``, ``param_dtype``, ...)."""
        cfg, params = load_hf_encoder_params(model_name_or_path, dtype)
        try:
            tokenizer = HFTokenizer(model_name_or_path)
        except Exception:  # checkpoint without tokenizer files
            tokenizer = None
        model = cls(cfg, tokenizer=tokenizer, dim=dim, seed=seed, **kw)
        model.module.encoder.load_state_dict(convert.encoder_state_dict(params["params"]["encoder"]))
        return model

    @classmethod
    def from_xmod(
        cls,
        model_name_or_path: str,
        languages: Sequence[str] | None = None,
        lang: str = "fr",
        dim: int = 128,
        seed: int = 42,
        *,
        dtype: torch.dtype = torch.float32,
        **kw,
    ) -> "ColBERT":
        """Multilingual ColBERT on an X-MOD trunk: import the checkpoint (its
        adapters optionally subset to ``languages``), pin ``lang``, freshly
        seeded head; dropout 0, so ``with_attention("flash")`` trains
        through the attention kernels.  Train with
        ``models.xmod.xmod_finetune_labels`` to freeze embeddings and
        adapters."""
        cfg, params = load_hf_xmod_params(model_name_or_path, languages=tuple(languages) if languages else None,
                                          dtype=dtype)
        try:
            tokenizer = HFTokenizer(model_name_or_path)
        except Exception:
            tokenizer = None
        model = cls(cfg, tokenizer=tokenizer, dim=dim, seed=seed, **kw)
        model.module.encoder.load_state_dict(
            convert.state_dict_from_flax(model.module.encoder, cfg.num_heads, params))
        return model.set_language(lang)

    @classmethod
    def load(
        cls, path: str, tokenizer=None, device="cuda", dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype | None = None,
    ) -> "ColBERT":
        """Load a checkpoint written by either package, computing in
        ``dtype`` on ``device`` (weights held in ``param_dtype``, default
        ``dtype``)."""
        config = checkpoint.read_config(path)
        if tokenizer is None:
            tokenizer = tokenizer_from_config(config.get("tokenizer"))
        cfg = checkpoint.encoder_config_from_dict(config["encoder"], dtype=dtype)
        variables = checkpoint.read_params(path)
        if is_xmod(cfg):
            params = convert.state_dict_of(lambda: ColBERTModule(cfg, dim=config["dim"]), cfg.num_heads, variables)
        else:
            params = convert.colbert_state_dict(variables)
        return cls(
            cfg,
            params=params,
            tokenizer=tokenizer,
            dim=config["dim"],
            max_query_length=config["max_query_length"],
            max_doc_length=config["max_doc_length"],
            mask_punctuation=config["mask_punctuation"],
            device=device,
            param_dtype=param_dtype,
        )
