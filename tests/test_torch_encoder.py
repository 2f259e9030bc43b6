"""fusion_tpu_torch encoder trunk, heads and models against the JAX package.

The JAX models are built at ``EncoderConfig.tiny(vocab_size=512)`` in f32;
their Flax params go through ``fusion_tpu_torch.models.convert`` into the
port's modules, and the same numpy token arrays feed both.  Tolerance: atol
1e-5 (f32 both sides; only the order of sums differs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import DEVICE

from fusion_tpu.models.biencoder import BiEncoder as JaxBiEncoder
from fusion_tpu.models.colbert import ColBERT as JaxColBERT
from fusion_tpu.models.encoder import EncoderConfig as JaxConfig
from fusion_tpu_torch.models import convert
from fusion_tpu_torch.models.biencoder import BiEncoder
from fusion_tpu_torch.models.colbert import ColBERT
from fusion_tpu_torch.models.encoder import EncoderConfig, token_tensors

ATOL = 1e-5
DOCS = [
    "le chat noir dort sur le tapis du salon, près de la fenêtre !",
    "le chien aboie",
    "",
    "un contrat de travail est signé par les deux parties ; la loi protège les consommateurs",
]


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = JaxConfig.tiny(vocab_size=512), EncoderConfig.tiny(vocab_size=512)
    kw = dict(max_query_length=8, max_doc_length=16)
    jd = JaxBiEncoder(jcfg, head="dense", **kw)
    js = JaxBiEncoder(jcfg, head="splade", **kw)
    jc = JaxColBERT(jcfg, dim=16, **kw)
    td = BiEncoder(tcfg, params=convert.encoder_state_dict(jd.params), head="dense", device=DEVICE, **kw)
    ts = BiEncoder(tcfg, params=convert.encoder_with_mlm_state_dict(js.params), head="splade", device=DEVICE, **kw)
    tc = ColBERT(tcfg, params=convert.colbert_state_dict(jc.params), dim=16, device=DEVICE, **kw)
    return {"dense": (jd, td), "splade": (js, ts), "colbert": (jc, tc)}


def _tokens(rng):
    """[4, 12] ids with ragged masks and one all-pad row."""
    ids = rng.integers(5, 512, size=(4, 12)).astype(np.int32)
    mask = np.ones_like(ids)
    for row, length in enumerate([12, 7, 0, 3]):
        ids[row, length:] = 1  # pad id
        mask[row, length:] = 0
    return ids, mask


def test_encoder_hidden_states(pair, rng):
    jd, td = pair["dense"]
    ids, mask = _tokens(rng)
    want = np.asarray(jd.module.apply(jd.params, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.inference_mode():
        got = td.module(*token_tensors(ids, mask, "cpu")).numpy()
    assert np.isfinite(got).all()  # the all-pad row softmaxes uniformly, no NaN
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize(
    "head,options",
    [
        ("dense", {}),
        ("dense", {"pooling": "max"}),
        ("dense", {"pooling": "cls"}),
        ("splade", {}),
        ("splade", {"pooling": "sum"}),
        ("splade", {"pruning_topk": 7}),
    ],
)
def test_biencoder_embed_tokens(pair, rng, head, options):
    jm, tm = pair[head]
    kw = dict(max_query_length=8, max_doc_length=16, **options)
    jm = JaxBiEncoder(jm.cfg, params=jm.params, head=head, **kw)
    tm = BiEncoder(tm.cfg, params=tm.module.state_dict(), head=head, device=DEVICE, **kw)
    ids, mask = _tokens(rng)
    want = np.asarray(jm.embed_tokens(jm.params, jnp.asarray(ids), jnp.asarray(mask)))
    got = tm.embed_tokens(*token_tensors(ids, mask, "cpu")).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("head", ["dense", "splade"])
def test_biencoder_encode_length_buckets(pair, head):
    jm, tm = pair[head]
    want = jm.encode(DOCS, query_mode=False, batch_size=2, sort_by_length=True)
    got = tm.encode(DOCS, query_mode=False, batch_size=2, sort_by_length=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, dtype=np.float32), atol=ATOL, rtol=0)


def test_colbert_augmented_query_and_doc_tokens(pair):
    jc, tc = pair["colbert"]
    queries = ["chat tapis", "contrat de travail signé"]
    j_ids, j_mask = jc.text_encoder.encode(queries, query_mode=True)
    t_ids, t_mask = tc.text_encoder.encode(queries, query_mode=True)
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_array_equal(t_mask, j_mask)
    mask_id = tc.text_encoder.tokenizer.mask_token_id
    assert (t_ids == mask_id).any() and t_mask.all()  # pads became attended [MASK]
    want = np.asarray(jc.embed_tokens(jc.params, jnp.asarray(j_ids), jnp.asarray(j_mask)))
    got = tc.embed_tokens(*token_tensors(t_ids, t_mask, "cpu")).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)

    # documents: punctuation skiplist + corpus padding to a multiple of 128
    j_index = jc.index(DOCS, batch_size=2)
    t_index = tc.index(DOCS, batch_size=2)
    np.testing.assert_array_equal(t_index.mask.numpy(), np.asarray(j_index.mask))
    np.testing.assert_allclose(
        t_index.tokens.float().numpy(),
        np.asarray(j_index.tokens, dtype=np.float32),
        # bf16 storage: an f32 difference of one ulp may round to the
        # neighbouring bf16 value, 2^-8 apart relatively
        atol=1e-6,
        rtol=2.0**-8,
    )
