"""Bi-encoder retrieval models: DPR (dense) and SPLADE (learned sparse).

One class covers both families, which differ only in the head applied to
the shared encoder trunk:

  * head='dense'  → pooled hidden state (mean/max/cls)        [B, H]
  * head='splade' → log1p(relu(MLM logits)) max/sum pooled    [B, V]
                    with optional top-k pruning

The model holds its module on an explicit ``device``; ``encode`` returns the
embeddings as a tensor on that device, so an encoded corpus never makes a
host round trip (a SPLADE corpus at 28k docs is 1.8 GB in bf16).  ``search``
is the model's own exact search over an encoded corpus, ``search_sparse``
the SPLADE search over a fixed-K pruned index.  ``save`` / ``load`` read and
write the JAX package's checkpoint format (``models/checkpoint.py``), and
``save_checkpoint`` the rolling step exports of a training run;
``decode_splade_vector`` reads SPLADE activations as bags of words.

Training builds the model with ``param_dtype=torch.float32`` (f32 master
weights; the forward still computes in ``cfg.dtype``) and calls
``embed_tokens_train``, the grad-enabled forward with dropout.  The six
SPLADE training recipes are data: ``SPLADE_PRESETS``.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from fusion_tpu_torch.core.device import resolve_device
from fusion_tpu_torch.core.ranked import RankedLists
from fusion_tpu_torch.data.tokenization import (
    HFTokenizer,
    TextEncoder,
    WordHashTokenizer,
    tokenizer_config,
    tokenizer_from_config,
)
from fusion_tpu_torch.models import checkpoint, convert, heads
from fusion_tpu_torch.models.checkpoint import CONFIG_FILENAME  # noqa: F401 - the JAX module's name
from fusion_tpu_torch.models.encoder import (
    DropoutKey,
    Encoder,
    EncoderConfig,
    EncoderViews,
    EncoderWithMLM,
    init_weights,
    place,
    token_tensors,
)
from fusion_tpu_torch.models.xmod import (
    XmodEncoder,
    XmodEncoderWithMLM,
    is_xmod,
    load_hf_xmod_params,
    set_module_language,
)
from fusion_tpu_torch.ops.mips import dense_search
from fusion_tpu_torch.parallel.sharding import MODEL_AXIS, all_gather_cat

_FLOPS_REGS = {"query_reg": "FlopsLoss", "query_reg_weight": 3e-4, "doc_reg": "FlopsLoss", "doc_reg_weight": 1e-4}
_HARD = {"training_sample_format": "tuple_with_scores", "negs_type": "hard", "negs_per_query": 1}

# training recipes of the six SPLADE variants, as fusion_tpu/models/biencoder.py
SPLADE_PRESETS: dict[str, dict] = {
    "spladev1": {
        "pooling": "sum",
        "rank_loss": {"name": "InfoNCELoss", "use_ib_negs": True, "temperature": 0.05},
        "reg_loss": dict(_FLOPS_REGS),
        "data": {"training_sample_format": "triplet", "negs_type": "original"},
    },
    "spladev2": {
        "pooling": "max",
        "rank_loss": {"name": "InfoNCELoss", "use_ib_negs": True, "temperature": 0.05},
        "reg_loss": dict(_FLOPS_REGS),
        "data": {"training_sample_format": "triplet", "negs_type": "original"},
    },
    "spladeplus": {
        "pooling": "max",
        "rank_loss": {"name": "MarginMSELoss", "teacher_scale": 0.08},
        "reg_loss": dict(_FLOPS_REGS),
        "data": {**_HARD, "negs_mining_systems": "bm25"},
    },
    "spladeplus_ensemble": {
        "pooling": "max",
        "rank_loss": {"name": "MarginMSELoss", "teacher_scale": 0.08},
        "reg_loss": dict(_FLOPS_REGS),
        "data": {**_HARD, "negs_mining_systems": "all"},
    },
    "spladeeff": {
        "pooling": "max",
        "rank_loss": {"name": "KLDLoss"},
        "reg_loss": {"query_reg": "L1Loss", "query_reg_weight": 1e-2, "doc_reg": "FlopsLoss", "doc_reg_weight": 1e-4},
        "data": {**_HARD, "negs_mining_systems": "all"},
    },
    "spladev3": {
        "pooling": "max",
        "rank_loss": {"name": "KLDLoss"},
        "reg_loss": dict(_FLOPS_REGS),
        "data": {**_HARD, "negs_mining_systems": "all", "negs_per_query": 8},
    },
}


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


class BiEncoder(EncoderViews):
    """Siamese encoder with a dense or sparse head.  ``quantized`` and
    ``with_attention`` give serving views (for the query side; the corpus
    keeps the forward it was encoded with) holding the same parameters."""

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
        device="cuda",
        param_dtype: torch.dtype | None = None,
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
        self.device = resolve_device(device)
        self.module = self._build_module(cfg)
        if params is None:
            init_weights(self.module, seed)
        else:
            self.module.load_state_dict(params)
        place(self.module, cfg.dtype, self.device, param_dtype)
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

    def _build_module(self, cfg: EncoderConfig):
        if is_xmod(cfg):
            return XmodEncoderWithMLM(cfg) if self.head == "splade" else XmodEncoder(cfg)
        return EncoderWithMLM(cfg) if self.head == "splade" else Encoder(cfg)

    def set_language(self, lang: str) -> "BiEncoder":
        """Pin the X-MOD language adapter ('fr' or 'fr_XX') of the trunk."""
        if not is_xmod(self.cfg):
            raise ValueError("set_language needs an X-MOD trunk")
        set_module_language(self.module, self.cfg.lang_index(lang))
        return self

    def _embed(self, input_ids, attention_mask, drop: DropoutKey | None = None, train: bool = False):
        if self.head == "splade":
            _, logits = self.module(input_ids, attention_mask, drop)
            acts = heads.splade_activation(logits, attention_mask, self.pooling)
            # under model > 1 the logits are this rank's vocabulary columns;
            # log1p∘relu∘max acts per column, so gather the activations
            acts = all_gather_cat(acts, getattr(self.module, "tp_mesh", None), MODEL_AXIS, dim=-1)
            if self.pruning_topk is not None and not train:
                acts, _ = heads.prune_topk(acts, self.pruning_topk)
            return acts
        hidden = self.module(input_ids, attention_mask, drop=drop)
        return heads.pool(hidden, attention_mask, self.pooling)

    @torch.inference_mode()
    def embed_tokens(self, input_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """Token batch → embeddings [B, H] (dense) or [B, V] (splade)."""
        return self._embed(input_ids, attention_mask)

    def embed_tokens_train(
        self, input_ids: torch.Tensor, attention_mask: torch.Tensor, drop: DropoutKey | None = None
    ) -> torch.Tensor:
        """The train-mode forward under autograd: dropout drawn from
        ``drop``, and SPLADE's activations unpruned."""
        return self._embed(input_ids, attention_mask, drop, train=True)

    def encode(
        self,
        sentences: Sequence[str],
        query_mode: bool = True,
        batch_size: int = 32,
        convert_to_numpy: bool = True,
        sort_by_length: bool = False,
    ) -> torch.Tensor:
        """Encode texts in fixed-size batches (tail padded with "", then
        trimmed) into one tensor on the model's device, in input order.

        ``sort_by_length=True`` groups inputs by word count and trims each
        batch to the smallest power-of-two width that holds its real tokens
        (``bucket_width``), which cuts encoder work on natural-length corpora
        and leaves every embedding unchanged.  JAX's ``convert_to_numpy`` is
        checked and dropped: the embeddings stay a tensor on the device.
        """
        if not isinstance(convert_to_numpy, bool):
            raise ValueError(f"convert_to_numpy must be a bool, got {convert_to_numpy!r}")
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

    def _embeddings(self, texts_or_embs, query_mode: bool, batch_size: int) -> torch.Tensor:
        """Texts → their embeddings; anything else is taken as precomputed
        embeddings and put on the model's device."""
        if isinstance(texts_or_embs, (list, tuple)) and (
            not texts_or_embs or isinstance(texts_or_embs[0], str)
        ):
            return self.encode(texts_or_embs, query_mode=query_mode, batch_size=batch_size)
        return torch.as_tensor(texts_or_embs).to(self.device)

    def search(
        self,
        queries,
        documents,
        topk: int = 10,
        batch_size: int = 32,
        doc_block: int = 65536,
    ) -> RankedLists:
        """Exact search of ``queries`` over ``documents``, each given as texts
        or as precomputed embeddings, with the model's similarity
        (``ops/mips.dense_search``)."""
        d_embs = self._embeddings(documents, query_mode=False, batch_size=batch_size)
        q_embs = self._embeddings(queries, query_mode=True, batch_size=batch_size)
        return dense_search(q_embs, d_embs, k=topk, similarity=self.similarity, doc_block=doc_block)

    def search_sparse(self, queries, index, topk: int = 1000, batch_size: int = 32) -> RankedLists:
        """SPLADE search of query texts over a fixed-K pruned ``SparseIndex``
        (``build_sparse_index``); ``cos_sim`` models l2-normalize the
        queries, as the index's docs were."""
        from fusion_tpu_torch.index.sparse import sparse_search
        from fusion_tpu_torch.models.heads import l2_normalize

        q_embs = self.encode(queries, query_mode=True, batch_size=batch_size).float()
        if self.similarity == "cos_sim":
            q_embs = l2_normalize(q_embs)
        return sparse_search(q_embs, index, k=topk)

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

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> None:
        """Write the checkpoint as the JAX package's ``BiEncoder.save`` does:
        its config keys, and the parameters in Flax's tree layout (f32)."""
        te = self.text_encoder
        config = {
            "head": self.head,
            "pooling": self.pooling,
            "similarity": self.similarity,
            "pruning_topk": self.pruning_topk,
            "max_query_length": te.max_query_length,
            "max_doc_length": te.max_doc_length,
            "query_prefix": te.query_prefix,
            "doc_prefix": te.doc_prefix,
            "augment_query_to_maxlen": te.augment_query_to_maxlen,
            "augment_doc_to_maxlen": te.augment_doc_to_maxlen,
            "do_lowercase": te.do_lowercase,
            "tokenizer": tokenizer_config(te.tokenizer),
            "encoder": checkpoint.encoder_config_dict(self.cfg),
        }
        checkpoint.write(path, config, self.flax_tree(self.module.state_dict()))

    def flax_tree(self, tensors) -> dict:
        """A state dict (or gradients keyed like it) → the JAX model's tree."""
        return convert.flax_tree(self.module, self.cfg.num_heads, tensors)

    def save_checkpoint(self, ckpt_dir: str, step: int, save_total_limit: int = 3) -> None:
        """Rolling step exports: ``ckpt_dir/<step>``, keeping the newest
        ``save_total_limit``."""
        checkpoint.save_step(self, ckpt_dir, step, save_total_limit)

    @classmethod
    def from_pretrained_hf(
        cls, model_name_or_path: str, head: str = "dense", *, dtype: torch.dtype = torch.float32, **kw
    ) -> "BiEncoder":
        """Build from a local HuggingFace checkpoint directory, read without
        ``transformers`` (``load_hf_encoder_params``), computing in
        ``dtype``; the tokenizer is the directory's own (``HFTokenizer``).
        The dense head keeps only the trunk; SPLADE also takes the LM head.
        ``kw`` go to the constructor (``device``, ``param_dtype``, ...)."""
        from fusion_tpu_torch.models.encoder import load_hf_encoder_params

        cfg, params = load_hf_encoder_params(model_name_or_path, dtype)
        tree = params["params"]
        if head == "splade" and "mlm" not in tree:
            raise ValueError(f"{model_name_or_path} holds no masked-LM head for SPLADE")
        sd = convert.encoder_with_mlm_state_dict(tree) if head == "splade" else convert.encoder_state_dict(
            tree["encoder"])
        return cls(cfg, params=sd, tokenizer=HFTokenizer(model_name_or_path), head=head, **kw)

    @classmethod
    def from_xmod(
        cls,
        model_name_or_path: str,
        head: str = "dense",
        languages: Sequence[str] | None = None,
        lang: str = "fr",
        *,
        dtype: torch.dtype = torch.float32,
        **kw,
    ) -> "BiEncoder":
        """Multilingual DPR / SPLADE on an X-MOD trunk: import the checkpoint
        (its adapters optionally subset to ``languages``; SPLADE also takes
        the LM head of an ``XmodForMaskedLM``), pin ``lang``.  Read without
        ``transformers``; a directory without tokenizer files gets the
        hashing tokenizer."""
        cfg, params = load_hf_xmod_params(
            model_name_or_path, languages=tuple(languages) if languages else None, dtype=dtype,
            with_mlm=head == "splade",
        )
        try:
            tokenizer = HFTokenizer(model_name_or_path)
        except Exception:
            tokenizer = None
        build = XmodEncoderWithMLM if head == "splade" else XmodEncoder
        sd = convert.state_dict_of(lambda: build(cfg), cfg.num_heads, params)
        return cls(cfg, params=sd, tokenizer=tokenizer, head=head, **kw).set_language(lang)

    @classmethod
    def load(
        cls, path: str, tokenizer=None, device="cuda", dtype: torch.dtype = torch.float32,
        param_dtype: torch.dtype | None = None,
    ) -> "BiEncoder":
        """Load a checkpoint written by either package, computing in
        ``dtype`` on ``device`` (weights held in ``param_dtype``, default
        ``dtype``)."""
        config = checkpoint.read_config(path)
        if tokenizer is None:
            tokenizer = tokenizer_from_config(config.get("tokenizer"))
        cfg = checkpoint.encoder_config_from_dict(config["encoder"], dtype=dtype)
        variables = checkpoint.read_params(path)
        if is_xmod(cfg):
            build = XmodEncoderWithMLM if config["head"] == "splade" else XmodEncoder
            params = convert.state_dict_of(lambda: build(cfg), cfg.num_heads, variables)
        elif config["head"] == "splade":
            params = convert.encoder_with_mlm_state_dict(variables)
        else:
            params = convert.encoder_state_dict(variables)
        return cls(
            cfg,
            params=params,
            tokenizer=tokenizer,
            head=config["head"],
            pooling=config["pooling"],
            similarity=config["similarity"],
            pruning_topk=config["pruning_topk"],
            max_query_length=config["max_query_length"],
            max_doc_length=config["max_doc_length"],
            query_prefix=config["query_prefix"],
            doc_prefix=config["doc_prefix"],
            augment_query_to_maxlen=config["augment_query_to_maxlen"],
            augment_doc_to_maxlen=config["augment_doc_to_maxlen"],
            do_lowercase=config["do_lowercase"],
            device=device,
            param_dtype=param_dtype,
        )


def decode_splade_vector(activations, tokenizer, topk_tokens: int = 96) -> list[dict]:
    """Top-k activated vocabulary entries as a bag-of-words dict per row,
    ``{token: round(100 * weight)}`` for the positive ones (tokens by
    ``tokenizer.tok`` when it has one, else the ids as strings)."""
    if isinstance(activations, torch.Tensor):
        activations = activations.float().cpu().numpy()
    out = []
    for row in np.asarray(activations):
        idx = np.argsort(-row)[:topk_tokens]
        idx = idx[row[idx] > 0]
        weights = np.round(row[idx] * 100).astype(int)
        keep = weights > 0
        ids = idx[keep].tolist()
        toks = tokenizer.tok.convert_ids_to_tokens(ids) if hasattr(tokenizer, "tok") else [str(i) for i in ids]
        out.append(dict(zip(toks, weights[keep].tolist())))
    return out
