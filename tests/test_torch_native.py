"""The port's C++ posting builders (``fusion_tpu_torch/native``) against the
JAX package's (``fusion_tpu.native``) and the port's numpy builders: the
sources byte-equal to the JAX package's, the g++ build, the three wrappers'
arrays, ``BM25Index.build``'s ``use_native`` modes and the >2M-posting
routing of ``use_native=None``.

Every comparison is exact (array equality, f16 compared by bits): the
builders do the same integer and f32 work; impacts are distinct within a
term wherever a term holds more postings than the cap, since the heap and
the lexsort may keep different members of a tie at the cap."""

import ctypes
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_parity import DEVICE

from fusion_tpu import native as jax_native
from fusion_tpu.index import inverted as jax_inv
from fusion_tpu.models.bm25 import BM25Index as JaxBM25
from fusion_tpu_torch import native
from fusion_tpu_torch.index import inverted
from fusion_tpu_torch.models import bm25 as bm25_mod
from fusion_tpu_torch.models.bm25 import BM25Index

REPO = Path(__file__).resolve().parent.parent
CORPUS = [
    "le chat noir dort sur le tapis",
    "le chien aboie dans le jardin",
    "un chat et un chien jouent",
    "",
    "chat chat chat partout",
    "café protégé café",
]

pytestmark = pytest.mark.skipif(not native.native_available(), reason="no C++ toolchain")


def _distinct_postings(rng, n_docs, vocab, per_doc):
    """Unique (term, doc) pairs, zipf-ish terms, impacts distinct within a term."""
    p = 1.0 / np.arange(1, vocab + 1) ** 0.8
    doc = np.repeat(np.arange(n_docs, dtype=np.int64), per_doc)
    term = rng.choice(vocab, size=doc.size, p=p / p.sum())
    pair = np.unique(term * n_docs + doc)
    term, doc = pair // n_docs, pair % n_docs
    imp = (rng.permutation(term.size) + 1).astype(np.float32) / term.size  # distinct below 2^24 postings
    return term, doc, imp


def _f16_bits(x) -> np.ndarray:
    return np.asarray(x).view(np.uint16)


@pytest.mark.parametrize("name", ["bm25_builder.cpp", "impact_packer.cpp"])
def test_sources_byte_equal_to_the_jax_package(name):
    assert (REPO / "fusion_tpu_torch" / "csrc" / name).read_bytes() == (REPO / "fusion_tpu" / "native" / name).read_bytes()


def test_gxx_builds_into_a_build_dir(tmp_path):
    path = native.build_library(tmp_path / "_build")
    assert path.parent == tmp_path / "_build" and path.exists()
    lib = ctypes.CDLL(str(path))
    for sym in ("bm25_build", "bm25_export", "bm25_free", "pack_chunked_impact", "pack_flat_impact"):
        assert hasattr(lib, sym)
    mtime = path.stat().st_mtime_ns
    assert native.build_library(tmp_path / "_build") == path and path.stat().st_mtime_ns == mtime  # built once
    assert list((tmp_path / "_build").iterdir()) == [path]  # no temporary file left


def test_bm25_postings_equal_jax_native_and_numpy():
    got = native.build_bm25_postings(CORPUS)
    want = jax_native.build_bm25_postings(CORPUS)
    plain = bm25_mod._numpy_postings(CORPUS)
    assert got[0] == want[0] == plain[0]  # vocab, ids in order of first appearance
    for g, w, p in zip(got[1:], want[1:], plain[1:]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, p.astype(g.dtype))
    assert native.build_bm25_postings(["a b a", "b c"])[1].tolist() == [0, 1, 1, 2]


@pytest.mark.parametrize("cap_per_chunk", [4, 64])
def test_pack_chunked_impact_equal_jax_native_and_numpy(cap_per_chunk):
    rng = np.random.default_rng(11)
    n_docs, vocab, dpc = 9000, 96, 2048
    term, doc, imp = _distinct_postings(rng, n_docs, vocab, 5)
    got = native.pack_chunked_impact(term, doc, imp, vocab, n_docs, dpc, cap_per_chunk)
    want = jax_native.pack_chunked_impact(term, doc, imp, vocab, n_docs, dpc, cap_per_chunk)
    plain = inverted.build_chunked_impact_index(term, doc, imp, vocab, n_docs, dpc, cap_per_chunk, False,
                                                device=DEVICE)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(_f16_bits(got[1]), _f16_bits(want[1]))
    assert got[2] == want[2] == plain.nnz_kept
    np.testing.assert_array_equal(got[0], plain.post_doc.numpy().view(np.uint16))
    np.testing.assert_array_equal(_f16_bits(got[1]), _f16_bits(plain.post_impact.numpy()))
    # the index the packer builds is the numpy builder's
    packed = inverted.build_chunked_impact_index(term, doc, imp, vocab, n_docs, dpc, cap_per_chunk, True,
                                                 device=DEVICE)
    assert torch.equal(packed.post_doc, plain.post_doc) and torch.equal(packed.post_impact, plain.post_impact)
    with pytest.raises(ValueError, match="out of range"):
        native.pack_chunked_impact(term, doc, imp, vocab - 1, n_docs, dpc, cap_per_chunk)


@pytest.mark.parametrize("cap", [8, 4096])
def test_pack_flat_impact_equal_jax_native_and_numpy(cap):
    rng = np.random.default_rng(13)
    n_docs, vocab = 7000, 80
    term, doc, imp = _distinct_postings(rng, n_docs, vocab, 4)
    got = native.pack_flat_impact(term, doc, imp, vocab, n_docs, cap)
    want = jax_native.pack_flat_impact(term, doc, imp, vocab, n_docs, cap)
    plain = inverted.build_impact_index(term, doc, imp, vocab, n_docs, cap, False, device=DEVICE)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(_f16_bits(got[1]), _f16_bits(want[1]))
    assert got[2] == want[2] == plain.nnz_kept
    np.testing.assert_array_equal(got[0], plain.post_doc.numpy())
    np.testing.assert_array_equal(_f16_bits(got[1]), _f16_bits(plain.post_impact.numpy()))
    packed = inverted.build_impact_index(term, doc, imp, vocab, n_docs, cap, True, device=DEVICE)
    assert torch.equal(packed.post_doc, plain.post_doc) and torch.equal(packed.post_impact, plain.post_impact)
    np.testing.assert_array_equal(packed.term_df, plain.term_df)


def test_pack_flat_f16_specials_as_numpy():
    """NaN stays NaN, inf stays inf, overflow saturates, subnormals round to
    nearest-even: numpy's astype(float16) on every value."""
    imp = np.array([np.nan, np.inf, -np.inf, 1e5, 65504.0, 6.1e-5, 5.96e-8, 1e-10, 0.0, -0.0, 1.0, 3.14159,
                    -2.71828], np.float32)
    n = imp.size
    post_doc, post_imp, kept = native.pack_flat_impact(np.arange(n), np.arange(n), imp, n, n, 1)
    assert kept == n
    got = _f16_bits(post_imp)[:n, 0]
    with np.errstate(over="ignore"):
        want = _f16_bits(imp.astype(np.float16))
    np.testing.assert_array_equal(got[~np.isnan(imp)], want[~np.isnan(imp)])
    assert np.isnan(post_imp[0, 0])


@pytest.mark.parametrize("variant", ["bm25", "atire"])
def test_bm25_index_build_use_native_modes(variant):
    """True, False and 'auto' give the same index, JAX's; True never falls
    back silently and 'auto' takes numpy for documents with newlines."""
    idx = {mode: BM25Index.build(CORPUS, variant=variant, use_native=mode, device=DEVICE)
           for mode in (True, False, "auto")}
    want = JaxBM25.build(CORPUS, variant=variant, use_native=True)
    for mode, got in idx.items():
        assert got.vocab == want.vocab and got.nnz == want.nnz, mode
        for name in ("entry_term", "entry_doc", "entry_tf", "idf", "doc_len"):
            np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
        assert got.avgdl == want.avgdl
    with pytest.raises(RuntimeError, match="newline"):
        BM25Index.build(["ok doc", "bad\ndoc"], use_native=True, device=DEVICE)
    assert BM25Index.build(["ok doc", "bad\ndoc"], use_native="auto", device=DEVICE).n_docs == 2
    with pytest.raises(ValueError, match="use_native"):
        BM25Index.build(CORPUS, use_native="yes", device=DEVICE)


def test_use_native_true_raises_when_the_builder_is_unavailable(monkeypatch):
    monkeypatch.setattr(native, "get_library", lambda: None)
    with pytest.raises(RuntimeError, match="unavailable"):
        BM25Index.build(CORPUS, use_native=True, device=DEVICE)
    auto = BM25Index.build(CORPUS, use_native="auto", device=DEVICE)  # numpy, the same index
    assert auto.vocab == BM25Index.build(CORPUS, use_native=False, device=DEVICE).vocab


def test_use_native_none_routes_above_2m_postings(monkeypatch):
    """``use_native=None`` takes the packers above 2,000,000 postings (JAX's
    threshold) and numpy at or below it; the arrays equal JAX's routed build."""
    assert inverted.NATIVE_MIN_POSTINGS == 2_000_000
    calls = []
    for name in ("pack_flat_impact", "pack_chunked_impact"):
        real = getattr(native, name)
        monkeypatch.setattr(native, name, lambda *a, _real=real, _name=name: calls.append(_name) or _real(*a))
    rng = np.random.default_rng(3)
    n_docs, vocab, nnz = 100_000, 1000, 2_000_001
    term = rng.integers(0, vocab, size=nnz)
    doc = rng.integers(0, n_docs, size=nnz)
    imp = rng.uniform(0.1, 2.0, size=nnz).astype(np.float32)
    got = inverted.build_impact_index(term, doc, imp, vocab, n_docs, 4096, device=DEVICE)
    assert calls == ["pack_flat_impact"]
    want = jax_inv.build_impact_index(term, doc, imp, vocab, n_docs, 4096)
    np.testing.assert_array_equal(got.post_doc.numpy(), np.asarray(want.post_doc))
    np.testing.assert_array_equal(_f16_bits(got.post_impact.numpy()), _f16_bits(np.asarray(want.post_impact)))
    inverted.build_chunked_impact_index(term, doc, imp, vocab, n_docs, 32_768, 4096, device=DEVICE)
    assert calls == ["pack_flat_impact", "pack_chunked_impact"]
    inverted.build_impact_index(term[:-1], doc[:-1], imp[:-1], vocab, n_docs, 4096, device=DEVICE)
    inverted.build_chunked_impact_index(term[:-1], doc[:-1], imp[:-1], vocab, n_docs, 32_768, 4096, device=DEVICE)
    assert len(calls) == 2  # 2,000,000 postings: the numpy builders
