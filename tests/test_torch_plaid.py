"""PLAID search of fusion_tpu_torch (index/plaid.py) against the JAX
package's, on one index: JAX builds it, ``plaid_index_from_arrays`` converts
it, and the same numpy-seeded queries go through both on the CPU (the port's
gathers take the kernel's plain version there).

Tolerances: the IVF build, the dedup and the candidate stage (ids and f16
probe sums; JAX with ``topk_impl="exact"``) are bit-equal; rescored scores
agree within 1e-5 (f32 sums of bf16 products in another order), and ids
equal except that ids whose JAX scores lie within 1e-5 of each other must
match as sets."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import DEVICE, assert_ranked_match

from fusion_tpu.index import compression as jc
from fusion_tpu.index import plaid as jp
from fusion_tpu_torch.index import compression as tc
from fusion_tpu_torch.index import plaid as tp
from fusion_tpu_torch.models.convert import plaid_index_from_arrays
from fusion_tpu_torch.ops import gather_rows as gr
from fusion_tpu_torch.utils import profiling

ATOL = 1e-5
N, C = 96, 32


@pytest.fixture(scope="module")
def small():
    """test_plaid.py's index (96 docs of ≤ 8 tokens, D 16, 32 centroids),
    its IVF, the port's copies, and 4 queries (one with padded tokens)."""
    rng = np.random.default_rng(5)
    ld, d = 8, 16
    toks = rng.standard_normal((N, ld, d)).astype(np.float32)
    toks /= np.linalg.norm(toks, axis=-1, keepdims=True)
    lens = rng.integers(3, ld + 1, size=N)
    mask = (np.arange(ld)[None, :] < lens[:, None]).astype(np.float32)
    j_index = jc.compress_token_index(
        jnp.asarray(toks), jnp.asarray(mask), nbits=2, kmeans_iters=4, num_centroids=C
    )
    j_ivf = jp.build_ivf(np.asarray(j_index.centroid_ids), np.asarray(j_index.mask), C, cap=N)
    t_index, t_ivf = plaid_index_from_arrays(
        j_index.centroids, j_index.centroid_ids, j_index.codes, j_index.mask,
        j_index.bucket_weights, j_index.nbits, ivf_doc=j_ivf.ivf_doc, n_docs=j_ivf.n_docs,
        cap=j_ivf.cap, device=DEVICE,
    )
    q = rng.standard_normal((4, 5, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    qm = np.ones((4, 5), np.float32)
    qm[1, 3:] = 0.0
    return (j_index, j_ivf), (t_index, t_ivf), q, qm


def _jax_q(q, qm):
    return jnp.asarray(q), jnp.asarray(qm)


def _port_q(q, qm):
    return torch.from_numpy(q), torch.from_numpy(qm)


@pytest.mark.parametrize("cap", [2, 5, 96])
def test_build_ivf_matches_jax(small, cap):
    (j_index, _), (t_index, _), _, _ = small
    want = jp.build_ivf(np.asarray(j_index.centroid_ids), np.asarray(j_index.mask), C, cap=cap)
    got = tp.build_ivf(t_index.centroid_ids, t_index.mask, C, cap=cap)
    assert (got.n_docs, got.cap) == (want.n_docs, want.cap)
    assert got.ivf_doc.dtype == torch.int32
    np.testing.assert_array_equal(got.ivf_doc.numpy(), np.asarray(want.ivf_doc))


def test_build_ivf_from_numpy_defaults_to_the_card(small):
    """numpy input goes to the card unless the caller names a device: without
    a card that raises; ``device="cpu"`` gives the lists of a tensor input."""
    (j_index, _), (t_index, _), _, _ = small
    cid, mask = np.asarray(j_index.centroid_ids), np.asarray(j_index.mask)
    if torch.cuda.is_available():
        assert tp.build_ivf(cid, mask, C, cap=5).ivf_doc.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tp.build_ivf(cid, mask, C, cap=5)
    got = tp.build_ivf(cid, mask, C, cap=5, device="cpu")
    want = tp.build_ivf(t_index.centroid_ids, t_index.mask, C, cap=5)
    assert got.ivf_doc.device.type == "cpu"
    torch.testing.assert_close(got.ivf_doc, want.ivf_doc, rtol=0, atol=0)


def test_dedup_ivf_rows_matches_jax():
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 20, size=(7, 12)).astype(np.int32)
    rows[0] = 20  # an all-sentinel row
    want = np.asarray(jp.dedup_ivf_rows(jnp.asarray(rows), 20))
    got = tp.dedup_ivf_rows(torch.from_numpy(rows), 20)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("nprobe,ncand", [(1, 16), (2, 96), (4, 48), (8, 32), (32, 96)])
def test_plaid_candidates_match_jax(small, nprobe, ncand):
    (j_index, j_ivf), (t_index, t_ivf), q, qm = small
    want_c, want_s = jp.plaid_candidates(
        *_jax_q(q, qm), j_index.centroids, j_ivf.ivf_doc, j_ivf.n_docs, nprobe=nprobe,
        ncand=ncand, topk_impl="exact",
    )
    got_c, got_s = tp.plaid_candidates(
        *_port_q(q, qm), t_index.centroids, t_ivf.ivf_doc, t_ivf.n_docs, nprobe=nprobe,
        ncand=ncand,
    )
    assert got_c.dtype == torch.int32
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_candidates_pad_with_the_sentinel_and_skip_padded_tokens(small):
    (_, _), (t_index, t_ivf), q, qm = small
    cand, scores = tp.plaid_candidates(
        *_port_q(q, qm), t_index.centroids, t_ivf.ivf_doc, t_ivf.n_docs, nprobe=1, ncand=N
    )
    cand, scores = cand.numpy(), scores.numpy()
    assert ((cand == N) == ~np.isfinite(scores)).all()
    for row in cand:
        real = row[row < N]
        assert len(set(real.tolist())) == len(real)
    # a query whose tokens are all padding reaches no document
    none, none_s = tp.plaid_candidates(
        torch.from_numpy(q[:1]), torch.zeros(1, 5), t_index.centroids, t_ivf.ivf_doc, N,
        nprobe=4, ncand=8,
    )
    assert (none.numpy() == N).all() and np.isneginf(none_s.numpy()).all()


def test_combined_key_overflow_raises(small):
    (_, _), (t_index, t_ivf), q, qm = small
    with pytest.raises(ValueError, match="overflows int32"):
        tp.plaid_candidates(*_port_q(q, qm), t_index.centroids, t_ivf.ivf_doc, 2**29, ncand=8)


def test_centroid_score_table_matches_jax(small):
    (j_index, _), (t_index, _), q, _ = small
    want = np.asarray(jp._centroid_score_table(jnp.asarray(q), j_index.centroids).astype(jnp.float32))
    got = tp._centroid_score_table(torch.from_numpy(q), t_index.centroids)
    assert got.dtype == torch.bfloat16 and got.shape == (4 * C, 5)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("ncand2,cand_chunk", [(16, 1024), (16, 12), (48, 16)])
def test_prune_tier_matches_jax(small, ncand2, cand_chunk):
    (j_index, j_ivf), (t_index, t_ivf), q, qm = small
    cand = np.array(jp.plaid_candidates(
        *_jax_q(q, qm), j_index.centroids, j_ivf.ivf_doc, N, nprobe=8, ncand=48, topk_impl="exact"
    )[0])
    cand[:, -6:] = N  # sentinel slots
    want = np.asarray(jp._plaid_centroid_prune(
        *_jax_q(q, qm), j_index.centroids, j_index.centroid_ids, j_index.mask,
        jnp.asarray(cand), ncand2=ncand2, cand_chunk=cand_chunk,
    ))
    got = tp._plaid_centroid_prune(
        *_port_q(q, qm), t_index.centroids, t_index.centroid_ids, t_index.mask,
        torch.from_numpy(cand), ncand2=ncand2, cand_chunk=cand_chunk,
    )
    assert got.dtype == torch.int32 and got.shape == want.shape
    # 42 real candidates: a cut to 16 keeps only real docs, a cut to 48 the
    # sentinels too
    assert (got.numpy() < N).all() or ncand2 > 42
    for g, w in zip(got.numpy(), want):
        assert set(g.tolist()) == set(w.tolist())


@pytest.mark.parametrize("rescore_impl", ["gather", "factored"])
@pytest.mark.parametrize(
    "knobs",
    [
        dict(nprobe=8, ncand=48, cand_chunk=16, ncand_rescore=None),
        dict(nprobe=8, ncand=48, cand_chunk=16, ncand_rescore=16),
        dict(nprobe=4, ncand=96, cand_chunk=32, ncand_rescore=1024),
        dict(nprobe=2, ncand=4096, cand_chunk=512, ncand_rescore=None),
    ],
)
def test_plaid_search_matches_jax(small, rescore_impl, knobs):
    (j_index, j_ivf), (t_index, t_ivf), q, qm = small
    want = jp.plaid_search(
        *_jax_q(q, qm), j_index, j_ivf, k=20, rescore_impl=rescore_impl, topk_impl="exact", **knobs
    )
    got = tp.plaid_search(*_port_q(q, qm), t_index, t_ivf, k=20, rescore_impl=rescore_impl, **knobs)
    assert got.ids.dtype == torch.int32
    assert_ranked_match(got.ids, got.scores, want.ids, want.scores, atol=ATOL)


def test_rescore_pads_sentinels(small):
    """Sentinel candidates come back as PAD_ID with -inf, in both forms."""
    _, (t_index, _), q, qm = small
    cand = torch.cat([torch.arange(8, dtype=torch.int32).expand(4, 8), torch.full((4, 8), N, dtype=torch.int32)], 1)
    q_t, q_m = _port_q(q, qm)
    cs = tp._centroid_score_table(q_t, t_index.centroids)
    for out in (
        tp._plaid_rescore(q_t, q_m, t_index, cand, k=16, cand_chunk=8),
        tp._plaid_rescore_factored(q_t, q_m, cs, t_index, cand, k=16, cand_chunk=8),
    ):
        ids, scores = out.ids.numpy(), out.scores.numpy()
        assert ((ids == -1) == ~np.isfinite(scores)).all()
        assert (ids[:, :8] >= 0).all() and (ids[:, 8:] == -1).all()


def test_full_candidate_plaid_equals_exhaustive_compressed_search(small):
    """With every centroid probed and every doc a candidate, PLAID rescoring
    and the exhaustive compressed search score the same bf16 tokens with the
    same bf16 queries (PLAID rounds its queries to bf16; on the CPU the
    exhaustive search keeps them as given, so it is given the rounded ones)."""
    _, (t_index, t_ivf), q, qm = small
    q_bf16 = torch.from_numpy(q).to(torch.bfloat16).float()
    got = tp.plaid_search(*_port_q(q, qm), t_index, t_ivf, k=20, nprobe=C, ncand=N, cand_chunk=32)
    want = tc.maxsim_search_compressed(q_bf16, torch.from_numpy(qm), t_index, k=20)
    assert_ranked_match(got.ids, got.scores, want.ids, want.scores, atol=ATOL)


def test_every_gather_goes_through_gather_rows(small, monkeypatch):
    """The prune tier and both rescores gather through ``gather_rows`` (the
    plain version on the CPU, the kernel never), so pointing it at the plain
    version gives the same search."""
    _, (t_index, t_ivf), q, qm = small
    kw = dict(k=10, nprobe=8, ncand=48, cand_chunk=16, ncand_rescore=16)
    before = gr.gather_rows_cuda.launches
    auto = {impl: tp.plaid_search(*_port_q(q, qm), t_index, t_ivf, rescore_impl=impl, **kw)
            for impl in ("gather", "factored")}
    calls = []
    monkeypatch.setattr(tp, "gather_rows", lambda srcs, idx: calls.append(len(srcs)) or gr.gather_rows_plain(srcs, idx))
    for impl, want in auto.items():
        calls.clear()
        got = tp.plaid_search(*_port_q(q, qm), t_index, t_ivf, rescore_impl=impl, **kw)
        assert torch.equal(got.ids, want.ids) and torch.equal(got.scores, want.scores)
        # one prune chunk of (cid, mask), then one rescore chunk of (cid, codes, mask)
        assert calls == [2, 3], calls
    assert gr.gather_rows_cuda.launches == before  # never launched on the CPU


def test_plaid_search_marks_its_stages_for_the_profiler(small):
    from torch.profiler import ProfilerActivity, profile

    _, (t_index, t_ivf), q, qm = small
    with profile(activities=[ProfilerActivity.CPU]) as prof, profiling.tracing():
        tp.plaid_search(*_port_q(q, qm), t_index, t_ivf, k=10, nprobe=8, ncand=48, cand_chunk=16,
                        ncand_rescore=16)
    profiling.reset()
    names = {e.name for e in prof.events()}
    stages = {"candidates", "probe_matmul", "probe_select", "candidate_sort", "prune", "rescore", "gather"}
    assert {f"{profiling.PREFIX}.plaid.{s}" for s in stages} <= names, names


def test_u8_mask_searches_like_the_f32_mask(small):
    """bench_mmarco.py's index stores the mask as u8."""
    _, (t_index, t_ivf), q, qm = small
    u8 = tc.CompressedTokenIndex(
        t_index.centroids, t_index.centroid_ids, t_index.codes, t_index.mask.to(torch.uint8),
        t_index.bucket_weights, t_index.nbits,
    )
    kw = dict(k=10, nprobe=8, ncand=48, cand_chunk=16, ncand_rescore=16)
    for impl in ("gather", "factored"):
        a = tp.plaid_search(*_port_q(q, qm), t_index, t_ivf, rescore_impl=impl, **kw)
        b = tp.plaid_search(*_port_q(q, qm), u8, t_ivf, rescore_impl=impl, **kw)
        assert torch.equal(a.ids, b.ids) and torch.equal(a.scores, b.scores)
