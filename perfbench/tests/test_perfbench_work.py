"""The work counts against hand-computed values at small shapes."""

import numpy as np
import pytest

from perfbench import roofline

ENC = {"hidden_size": 4, "intermediate_size": 8, "num_hidden_layers": 2, "vocab_size": 10}


def test_k1_work():
    # QL 3, Ld 5, N 7, D 2, 11 real tokens: 2*3*2*11 products; bytes 2*5*7*2 + 2*3*2 + 4*7*3
    assert roofline.k1_work(3, 5, 7, 2, 11) == (132.0, 140.0 + 12.0 + 84.0)


def test_encoder_flops():
    # per token and layer 2*(4*16 + 2*4*8) = 256; attention 4*H*L^2 = 16*L^2
    got = roofline.encoder_flops(ENC, np.array([3, 1]))
    assert got == 2 * (256 * 4 + 16 * (9 + 1))


def test_bound_takes_the_larger():
    assert roofline.bound_s(989e12, 0.0) == pytest.approx(1.0)
    assert roofline.bound_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert roofline.bound_s(989e9, 3.35e12) == pytest.approx(1.0)


def test_hybrid_batch_flops_by_hand():
    cfg = {"encoder": ENC, "query_length": 4, "colbert_dim": 2, "n_docs": 5}
    q_words = np.array([1, 5])  # attended 3 and 4 (cut at the query length)
    enc = roofline.encoder_flops
    want = 2 * enc(ENC, np.array([3, 4])) + enc(ENC, np.array([4, 4]))
    want += 2 * (16 + 40) * 7  # SPLADE's MLM head over the attended tokens
    want += 2 * 4 * 2 * 2 * 4  # ColBERT's projection
    want += 2 * 2 * 5 * 4  # DPR
    want += 2 * 2 * 13  # SPLADE over 13 nonzeros
    want += 2 * 6  # BM25 postings
    want += 2 * 2 * 4 * 2 * 17  # MaxSim over 17 real tokens
    want += enc(ENC, np.array([6, 9])) + 2 * 2 * (16 + 4)  # two pairs
    got = roofline.hybrid_batch_flops(cfg, q_words, np.array([2, 4]), 13, 17, np.array([6, 9]))
    assert got == pytest.approx(want)
