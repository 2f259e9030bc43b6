"""Shared pieces of the training parity tests: tiny JAX / port model
pairs on converted weights (the BERT-style trunk, X-MOD's with its
adapters, T5's), seeded token batches, and Flax trees flattened to
{path: numpy leaf}."""

import jax.numpy as jnp
import numpy as np
import torch
from torch_parity import DEVICE

from fusion_tpu.models.biencoder import BiEncoder as JaxBiEncoder
from fusion_tpu.models.colbert import ColBERT as JaxColBERT
from fusion_tpu.models.crossencoder import CrossEncoder as JaxCrossEncoder
from fusion_tpu.models.encoder import EncoderConfig as JaxConfig
from fusion_tpu.models.t5 import T5Config as JaxT5Config
from fusion_tpu.models.t5 import T5CrossEncoder as JaxT5CrossEncoder
from fusion_tpu.models.xmod import XmodConfig as JaxXmodConfig
from fusion_tpu_torch.models import convert
from fusion_tpu_torch.models.biencoder import BiEncoder
from fusion_tpu_torch.models.colbert import ColBERT
from fusion_tpu_torch.models.crossencoder import CrossEncoder
from fusion_tpu_torch.models.encoder import EncoderConfig
from fusion_tpu_torch.models.t5 import T5Config, T5CrossEncoder
from fusion_tpu_torch.models.xmod import XmodConfig, XmodEncoderWithMLM

V, B, N, LQ, LD = 256, 4, 2, 8, 12


def flat(tree, prefix=()):
    """Nested dict → {path: numpy leaf} (the variables' "params" unwrapped)."""
    if "params" in tree and len(tree) == 1:
        tree = tree["params"]
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def tokens(rng, n, length, vocab=V):
    ids = rng.integers(5, vocab, size=(n, length)).astype(np.int32)
    mask = np.ones_like(ids)
    for r in range(n):
        keep = rng.integers(2, length + 1)
        ids[r, keep:], mask[r, keep:] = 1, 0
    return ids, mask


def triplet_batch(seed=0, float_masks=False):
    rng = np.random.default_rng(seed)
    (qi, qm), (pi, pm), (ni, nm) = tokens(rng, B, LQ), tokens(rng, B, LD), tokens(rng, B * N, LD)
    if float_masks:
        qm, pm, nm = (m.astype(np.float32) for m in (qm, pm, nm))
    return {"query_ids": qi, "query_mask": qm, "pos_ids": pi, "pos_mask": pm, "neg_ids": ni, "neg_mask": nm,
            "teacher_pos": rng.normal(size=B).astype(np.float32),
            "teacher_neg": rng.normal(size=B * N).astype(np.float32)}


def pair_batch(seed=0):
    rng = np.random.default_rng(seed)
    ids, mask = tokens(rng, 6, 20)
    return {"pair_ids": ids, "pair_mask": mask, "labels": (rng.random(6) > 0.5).astype(np.float32)}


XMOD_LANG = "en_XX"  # the second of the tiny config's adapters: the index reaches the forward


def models(kind, head="dense", trunk="bert", **cfg_kw):
    """(JAX model, port model on its converted weights) of ``kind``
    (biencoder, colbert, crossencoder) on ``trunk``: the BERT-style tiny
    config, ``xmod`` (a SPLADE bi-encoder through the ``XMOD_LANG``
    adapter) or ``t5`` (the T5 cross-encoder)."""
    kw = dict(device=DEVICE, param_dtype=torch.float32)
    if trunk == "xmod":
        jcfg, tcfg = JaxXmodConfig.tiny(vocab_size=V, **cfg_kw), XmodConfig.tiny(vocab_size=V, **cfg_kw)
        jm = JaxBiEncoder(jcfg, head="splade").set_language(XMOD_LANG)
        sd = convert.state_dict_of(lambda: XmodEncoderWithMLM(tcfg), tcfg.num_heads, jm.params)
        return jm, BiEncoder(tcfg, params=sd, head="splade", **kw).set_language(XMOD_LANG)
    if trunk == "t5":
        jcfg, tcfg = JaxT5Config.tiny(vocab_size=V, **cfg_kw), T5Config.tiny(vocab_size=V, **cfg_kw)
        jm = JaxT5CrossEncoder(jcfg, max_length=20)
        return jm, T5CrossEncoder(tcfg, params=convert.t5_crossencoder_state_dict(jm.params, tcfg), max_length=20,
                                  **kw)
    jcfg, tcfg = JaxConfig.tiny(vocab_size=V, **cfg_kw), EncoderConfig.tiny(vocab_size=V, **cfg_kw)
    if kind == "colbert":
        jm = JaxColBERT(jcfg, dim=16)
        return jm, ColBERT(tcfg, params=convert.colbert_state_dict(jm.params), dim=16, **kw)
    if kind == "crossencoder":
        jm = JaxCrossEncoder(jcfg, max_length=20)
        return jm, CrossEncoder(tcfg, params=convert.crossencoder_state_dict(jm.params), max_length=20, **kw)
    jm = JaxBiEncoder(jcfg, head=head)
    conv = convert.encoder_with_mlm_state_dict if head == "splade" else convert.encoder_state_dict
    return jm, BiEncoder(tcfg, params=conv(jm.params), head=head, **kw)


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}
