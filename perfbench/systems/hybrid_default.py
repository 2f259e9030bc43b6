"""``fusion_tpu_torch.serving.HybridSearcher`` in its default form.

BM25 as the dense-impact matmul over an index that ``BM25Index.build``
makes from the documents' text, DPR and SPLADE as exact MIPS over their
corpus rows, ColBERT through the MaxSim kernel (K1) over the token index,
RRF, and with ``rerank_depth`` > 0 the packed monoBERT rerank of the fused
head.  The encoders are the port's own modules holding perfbench's weights;
the corpus-side arrays are perfbench's, handed to the searcher as a
deployment's offline build would have left them.  Every implementation
choice not named in the configuration stays at the program's default.
"""

from __future__ import annotations

import numpy as np
import torch


def encoder_config(cfg: dict):
    from fusion_tpu_torch.models.encoder import EncoderConfig

    from perfbench.corpus import DTYPES

    enc = cfg["encoder"]
    return EncoderConfig(
        vocab_size=enc["vocab_size"], hidden_size=enc["hidden_size"], num_layers=enc["num_hidden_layers"],
        num_heads=enc["num_attention_heads"], intermediate_size=enc["intermediate_size"],
        max_position=enc["max_position_embeddings"], type_vocab_size=enc["type_vocab_size"],
        pad_token_id=enc["pad_token_id"], layer_norm_eps=enc["layer_norm_eps"], dropout=0.0,
        dtype=DTYPES[enc["dtype"]],
    )


def trunk_state(w: dict, n_layers: int, prefix: str = "") -> dict:
    """perfbench's layout → the program's ``Encoder`` state dict."""
    p = prefix
    out = {
        p + "embeddings.word.weight": w["emb.word"],
        p + "embeddings.position.weight": w["emb.pos"],
        p + "embeddings.token_type.weight": w["emb.type"],
        p + "embeddings.ln.weight": w["emb.ln.g"],
        p + "embeddings.ln.bias": w["emb.ln.s"],
    }
    for i in range(n_layers):
        q, s = f"{p}layers.{i}.", f"L{i}."
        for mod, key in (("attention.qkv", "qkv"), ("attention.out", "out"), ("ffn_in", "ffn_in"),
                         ("ffn_out", "ffn_out")):
            out[f"{q}{mod}.weight"] = w[f"{s}{key}.w"]
            out[f"{q}{mod}.bias"] = w[f"{s}{key}.b"]
        for mod, key in (("attn_ln", "ln1"), ("ffn_ln", "ln2")):
            out[f"{q}{mod}.weight"] = w[f"{s}{key}.g"]
            out[f"{q}{mod}.bias"] = w[f"{s}{key}.s"]
    return out


def model_states(cfg: dict, weights: dict) -> dict[str, dict]:
    layers = cfg["encoder"]["num_hidden_layers"]
    sp, cb, ce = weights["splade"], weights["colbert"], weights["cross"]
    return {
        "dense": trunk_state(weights["dense"], layers),
        "splade": {
            **trunk_state(sp, layers, "encoder."),
            "mlm.transform.weight": sp["mlm.transform.w"], "mlm.transform.bias": sp["mlm.transform.b"],
            "mlm.ln.weight": sp["mlm.ln.g"], "mlm.ln.bias": sp["mlm.ln.s"],
            "mlm.decoder.weight": sp["mlm.decoder.w"], "mlm.decoder.bias": sp["mlm.decoder.b"],
        },
        "colbert": {**trunk_state(cb, layers, "encoder."), "colbert.proj.weight": cb["proj.w"]},
        "cross": {
            **trunk_state(ce, layers, "encoder."),
            "head.pooler.weight": ce["pooler.w"], "head.pooler.bias": ce["pooler.b"],
            "head.classifier.weight": ce["cls.w"], "head.classifier.bias": ce["cls.b"],
        },
    }


def build(cfg: dict, traffic: dict, inputs, device):
    """The searcher the traffic drives, on ``device``."""
    from fusion_tpu_torch.models.biencoder import BiEncoder
    from fusion_tpu_torch.models.bm25 import BM25Index
    from fusion_tpu_torch.models.colbert import ColBERT, TokenIndex
    from fusion_tpu_torch.models.crossencoder import CrossEncoder
    from fusion_tpu_torch.serving import HybridSearcher

    device = torch.device(device)
    ecfg = encoder_config(cfg)
    states = model_states(cfg, inputs.weights)
    lq, ld = cfg["query_length"], cfg["doc_length"]
    kw = dict(max_query_length=lq, max_doc_length=ld, device=device)
    # built under the device's default so the modules never hold host copies;
    # the weights are perfbench's, so the models draw none of their own
    with torch.device(device):
        dense = BiEncoder(ecfg, params=states["dense"], head="dense", **kw)
        splade = BiEncoder(ecfg, params=states["splade"], head="splade", **kw)
        colbert = ColBERT(ecfg, params=states["colbert"], dim=cfg["colbert_dim"], **kw)
        rerank = traffic.get("rerank_depth", 0) > 0
        ce = CrossEncoder(ecfg, params=states["cross"], max_length=cfg["ce_max_length"], device=device) \
            if rerank else None
    bm = cfg["bm25"]
    bm25 = BM25Index.build(inputs.doc_texts, k1=bm["k1"], b=bm["b"], device=device)
    searcher = HybridSearcher(
        corpus_ids=np.arange(inputs.n_docs, dtype=np.int64),
        bm25=bm25, bm25_impacts=bm25.build_dense_impacts(),
        dense_model=dense, dense_corpus=inputs.dpr_rows,
        splade_model=splade, splade_corpus=inputs.splade_rows,
        colbert_model=colbert, colbert_index=TokenIndex(tokens=inputs.colbert_tokens, mask=inputs.colbert_mask),
        cross_encoder=ce, rerank_depth=traffic.get("rerank_depth", 0),
        ce_doc_tokens=inputs.ce_doc_tokens if rerank else None,
        ce_doc_mask=inputs.ce_doc_mask if rerank else None,
        ce_doc_lens=inputs.ce_doc_lens if rerank else None,
        topk=cfg["topk"], fusion_method=cfg["fusion"], device=device,
    )
    searcher.colbert_index.prepared()  # the search layout, once, as build() makes it
    return searcher


# the instance methods the traced run wraps in spans, by layer
SPANS = {
    "_prepare_inputs": "prepare",
    "_bm25_leg": "leg.bm25",
    "_dpr_leg": "leg.dpr",
    "_splade_leg": "leg.splade",
    "_colbert_leg": "leg.colbert",
    "_fuse": "fuse",
    "_rerank": "rerank",
}
ENCODERS = {"dense_model": "encoder.dpr", "splade_model": "encoder.splade", "colbert_model": "encoder.colbert"}


def span_targets(searcher):
    """(object, method name, span name) of every span of the traced run."""
    out = [(searcher, m, s) for m, s in SPANS.items()]
    out += [(getattr(searcher, attr), "embed_tokens", s) for attr, s in ENCODERS.items()]
    return out


def kernel_counters():
    """The hand-written kernels this system can launch: (name, module, entry)."""
    from fusion_tpu_torch.ops import maxsim

    return [("K1", maxsim, "maxsim_maxima_cuda")]


def server(searcher, traffic: dict):
    """The program's HTTP front end over the searcher, on a free local port:
    ``max_batch`` from the traffic mix, ``max_wait_ms`` its default unless
    the mix names one."""
    from fusion_tpu_torch.server import SearchServer

    kw = {"max_wait_ms": traffic["max_wait_ms"]} if "max_wait_ms" in traffic else {}
    return SearchServer(searcher, host="127.0.0.1", port=0, max_batch=traffic["max_batch"],
                        default_topk=traffic["topk"], **kw)


def int8_path(searcher):
    """The program's own int8 serving path switched on, as ``build(
    int8_corpus=True, encoders_int8=True)`` gives it: the DPR and SPLADE
    corpus rows and the BM25 impacts as per-row int8, the query encoders'
    and the cross-encoder's int8 views.  The control of ``correct``."""
    from fusion_tpu_torch.index.dense_quant import quantize_dense_index
    from fusion_tpu_torch.serving import _quantize_impacts

    searcher.dense_corpus = quantize_dense_index(searcher.dense_corpus, similarity=searcher.dense_model.similarity)
    searcher.splade_corpus = quantize_dense_index(searcher.splade_corpus,
                                                  similarity=searcher.splade_model.similarity)
    searcher.bm25_impacts = _quantize_impacts(searcher.bm25_impacts)
    searcher.quantize_encoders()
    if searcher.cross_encoder is not None:
        searcher.cross_encoder = searcher.cross_encoder.quantized("int8")
    return searcher


def int8_rerank(searcher):
    """The cross-encoder's int8 view alone, every other part as served: the
    step a change to the rerank alone would take.  A second control."""
    if searcher.cross_encoder is not None:
        searcher.cross_encoder = searcher.cross_encoder.quantized("int8")
    return searcher
