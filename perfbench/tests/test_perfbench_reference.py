"""The plain reference against the port at a size a CPU holds: each
encoder's forward, each leg, and a whole run judged correct."""

import time

import numpy as np
import pytest
import torch

from perfbench.corpus import make_inputs
from perfbench.reference import encoder as E
from perfbench.reference.hybrid import HybridReference
from perfbench.run import run_cell
from perfbench.systems import hybrid_default
from perfbench.tests.tiny import tiny_cell


@pytest.fixture(scope="module")
def tiny():
    cell = tiny_cell("rerank-b64")
    inputs = make_inputs(cell["cfg"], cell["mix"], 2**31 + 7, "cpu")
    return cell, inputs, hybrid_default.build(cell["cfg"], cell["mix"], inputs, "cpu")


def test_encoders_match_the_port(tiny):
    cell, inputs, searcher = tiny
    ref = HybridReference(cell["cfg"], inputs, "cpu")
    texts = inputs.query_texts[:6]
    ids, mask = ref._tokens(texts, cell["cfg"]["query_length"], augment=False)
    cb_ids, cb_mask = ref._tokens(texts, cell["cfg"]["query_length"], augment=True)
    enc, w = cell["cfg"]["encoder"], inputs.weights
    got_ids, got_mask = searcher.dense_model.text_encoder.encode(texts, query_mode=True)
    assert np.array_equal(got_ids, ids.numpy()) and np.array_equal(got_mask, mask.numpy())
    pairs = (
        (searcher.dense_model, E.dense_embed, w["dense"], ids, mask),
        (searcher.splade_model, E.splade_embed, w["splade"], ids, mask),
        (searcher.colbert_model, E.colbert_embed, w["colbert"], cb_ids, cb_mask),
    )
    for model, fn, weights, i, m in pairs:
        got = model.embed_tokens(i, m.int())
        want = fn(weights, enc, i, m, "fp32")
        assert torch.allclose(got.float(), want, atol=2e-5, rtol=1e-4), fn.__name__


def test_cross_encoder_matches_the_port(tiny):
    cell, inputs, searcher = tiny
    ref = HybridReference(cell["cfg"], inputs, "cpu")
    rows = np.array([0, 1])
    head = np.array([[3, 7, 11], [5, 2, 0]])
    want = ref.cross_logits(rows, head)
    ce = searcher.cross_encoder
    q_ids, q_mask = ce.encode_queries_raw([inputs.query_texts[r] for r in rows], max_query_tokens=32)
    d_ids = ce._token_ids(inputs.ce_doc_tokens[torch.as_tensor(head)])
    d_mask = inputs.ce_doc_mask[torch.as_tensor(head)].long()
    got = ce.rerank_tokens(torch.as_tensor(q_ids), torch.as_tensor(q_mask), d_ids, d_mask)
    assert torch.allclose(got, want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("traffic", ["rerank-b64", "retrieve-b256"])
def test_a_tiny_run_is_correct(traffic):
    out = run_cell(tiny_cell(traffic), 2**31 + 11, 0.2, False, device="cpu", t0=time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
