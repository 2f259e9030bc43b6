"""The rest of the fusion_tpu_torch MaxSim family against the JAX package.

On the CPU every entry point runs its kernel's plain version; the Hopper
kernels are held to those on the card by chip_smoke.py.  Inputs are
``tests/test_maxsim.py``'s fixture plus one fully masked doc, from a seeded
numpy generator.  Tolerances: the strict reference rtol 1e-5; K1-v1 atol 1e-4
(as ``test_maxsim.py`` holds the Pallas kernel to XLA); maxima atol 1e-5;
the bf16 reduce within one bf16 ulp of JAX's f32 maxima rounded (the f32
maxima may differ in the last bits and round to neighbours); scores 1e-5."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_ranked_match

from fusion_tpu.ops import maxsim as jm
from fusion_tpu_torch.ops import _kernels
from fusion_tpu_torch.ops import maxsim as tm
from fusion_tpu_torch.tools import bench_maxsim

DEAD = 6  # the fully masked (corpus pad) doc


@pytest.fixture
def data(rng):
    q, lq, n, ld, d = 3, 4, 8, 6, 16
    qt = rng.normal(size=(q, lq, d)).astype(np.float32)
    qt /= np.linalg.norm(qt, axis=-1, keepdims=True)
    dt = rng.normal(size=(n, ld, d)).astype(np.float32)
    dt /= np.linalg.norm(dt, axis=-1, keepdims=True)
    qm = np.ones((q, lq), dtype=np.float32)
    qm[0, -1] = 0
    dm = np.ones((n, ld), dtype=np.float32)
    dm[1, -2:] = 0
    dm[4, 1:] = 0
    dm[DEAD] = 0
    return qt, qm, dt, dm


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _token_major(dt, dm, zeroed):
    return np.ascontiguousarray((dt * dm[..., None] if zeroed else dt).transpose(1, 0, 2))


def _bf16_ulp(x):
    return np.ldexp(np.ones_like(x), np.frexp(x)[1] - 8)


def test_strict_reference_matches_jax(data):
    qt, qm, dt, dm = data
    want = np.asarray(jm.maxsim_scores(*map(jnp.asarray, (qt, qm, dt, dm))))
    got = tm.maxsim_scores(*_t(qt, qm, dt, dm)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # a fully masked doc scores -1e9 per valid query token
    np.testing.assert_array_equal(got[:, DEAD], -1e9 * qm.sum(axis=1))


@pytest.mark.parametrize("entry", ["maxsim_scores_v1", "maxsim_fused_plain"])
def test_k1v1_plain_matches_pallas_interpret(data, entry):
    qt, qm, dt, dm = data
    q, lq, d = qt.shape
    want = np.asarray(jm.maxsim_scores_pallas(*map(jnp.asarray, (qt, qm, dt, dm)), block_docs=4,
                                              interpret=True))
    if entry == "maxsim_scores_v1":
        got = tm.maxsim_scores_v1(*_t(qt, qm, dt, dm))
    else:  # token-major inputs, small doc blocks with a ragged tail
        q_flat, d_tm, m_tm = _t(qt.reshape(q * lq, d), _token_major(dt, dm, False), dm.T)
        got = tm.maxsim_fused_plain(q_flat, torch.from_numpy(qm), d_tm, m_tm, doc_block=3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got.numpy()[:, DEAD], -1e9 * qm.sum(axis=1))


def _jax_maxima(qt, dt, dm):
    """JAX K1-v2 in interpret mode (f32 reduce) over the zeroed corpus:
    [QL, N], QL padded to 16 rows for two query chunks of 8."""
    q, lq, d = qt.shape
    q_pad = np.zeros((16, d), np.float32)
    q_pad[: q * lq] = qt.reshape(q * lq, d)
    out = jm.maxsim_token_maxima_pallas(
        jnp.asarray(q_pad), jnp.asarray(_token_major(dt, dm, True)), block_docs=4, q_chunk=8,
        interpret=True,
    )
    return np.asarray(out)[: q * lq]


def test_k1v2_plain_f32_matches_pallas_interpret(data):
    qt, qm, dt, dm = data
    q, lq, d = qt.shape
    got = tm.maxsim_token_maxima(*_t(qt.reshape(q * lq, d), _token_major(dt, dm, True)))
    assert got.shape == (q * lq, dt.shape[0]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _jax_maxima(qt, dt, dm), atol=1e-5, rtol=0)


def test_k1v2_plain_bf16_within_one_ulp_of_the_rounded_maxima(data):
    qt, qm, dt, dm = data
    q, lq, d = qt.shape
    got = tm.maxsim_token_maxima(*_t(qt.reshape(q * lq, d), _token_major(dt, dm, True)), reduce="bf16")
    want = torch.from_numpy(_jax_maxima(qt, dt, dm)).to(torch.bfloat16).float().numpy()
    # every value is a bf16 value
    np.testing.assert_array_equal(got.numpy(), got.to(torch.bfloat16).float().numpy())
    assert (np.abs(got.numpy() - want) <= _bf16_ulp(want)).all()


@pytest.mark.parametrize("tchunk", [1, 3, 8])
def test_chunked_mode_equals_f32_mode(data, tchunk):
    qt, qm, dt, dm = data
    q, lq, d = qt.shape
    args = _t(qt.reshape(q * lq, d), _token_major(dt, dm, True))
    np.testing.assert_array_equal(
        tm.maxsim_token_maxima(*args, reduce="f32", tchunk=tchunk).numpy(),
        tm.maxsim_token_maxima(*args, reduce="f32").numpy(),
    )


@pytest.mark.parametrize(
    "d, tchunk, stages",
    [(128, 1, 8), (128, 2, 5), (128, 4, 2), (128, 8, 1), (16, 1, 8), (96, 4, 2), (256, 1, 3),
     (256, 4, 0), (128, 300, 0)],
)
def test_ring_stages_are_what_fits_beside_the_query_tile(d, tchunk, stages):
    """``maxima_stages`` mirrors csrc/maxsim.cu's count: as many stages of
    ``tchunk`` tokens as fit in one block's shared memory beside the
    256-token query tile, at most 8 (0: the wrapper refuses the call)."""
    assert tm.maxima_stages(d, tchunk) == stages
    if stages:
        assert tm.maxima_smem_bytes(d, tchunk, stages) <= tm.MAX_SMEM
        assert stages == 8 or tm.maxima_smem_bytes(d, tchunk, stages + 1) > tm.MAX_SMEM


@pytest.mark.parametrize("d, tokens", [(16, 4), (128, 4), (160, 2), (256, 1)])
def test_k1_loads_the_deepest_stages_of_which_two_fit(d, tokens):
    assert tm.k1_tokens_per_stage(d) == tokens
    assert tm.maxima_stages(d, tokens) >= (2 if tokens > 1 else 1)


@pytest.mark.parametrize("bad", [dict(reduce="f16"), dict(tchunk=0)])
def test_k1v2_rejects_bad_modes(data, bad):
    qt, qm, dt, dm = data
    q, lq, d = qt.shape
    with pytest.raises(ValueError):
        tm.maxsim_token_maxima(*_t(qt.reshape(q * lq, d), _token_major(dt, dm, True)), **bad)


@pytest.mark.parametrize("doc_block", [1024, 3])
def test_zeroed_fused_sum_is_the_query_mask_product_of_the_maxima(data, doc_block):
    qt, qm, dt, dm = data
    q, lq, d = qt.shape
    d_tm = _token_major(dt, dm, True)
    maxima = np.einsum("tnd,jd->jtn", d_tm, qt.reshape(q * lq, d)).max(axis=1)  # [QL, N]
    qm_mat = (np.eye(q, dtype=np.float32)[:, :, None] * qm[None]).reshape(q, q * lq)
    got = tm.maxsim_fused_plain(*_t(qt.reshape(q * lq, d), qm, d_tm), doc_block=doc_block)
    np.testing.assert_allclose(got.numpy(), qm_mat @ maxima, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tm.maxsim_fused(*_t(qt.reshape(q * lq, d), qm, d_tm)).numpy(),
                               qm_mat @ maxima, atol=1e-5, rtol=0)


def test_doc_major_v2_entry_matches_pallas_v2_interpret(data):
    qt, qm, dt, dm = data
    zeroed = dt * dm[..., None]
    want = np.asarray(jm.maxsim_scores_pallas_v2(*map(jnp.asarray, (qt, qm, zeroed)), block_docs=4,
                                                 q_chunk=4, interpret=True))
    got = tm.maxsim_scores_v2(*_t(qt, qm, zeroed))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("doc_block,k", [(1024, 7), (3, 7), (3, 3), (5, 4)])
def test_maxsim_search_matches_jax(data, doc_block, k):
    """doc_block 3 and 5 clamp the tail block over N 8; k 7 reaches every
    valid doc, and never the fully masked one."""
    qt, qm, dt, dm = data
    want = jm.maxsim_search(*map(jnp.asarray, (qt, qm, dt, dm)), k=k, doc_block=doc_block,
                            use_pallas=False)
    got = tm.maxsim_search(*_t(qt, qm, dt, dm), k=k, doc_block=doc_block)
    assert got.ids.dtype == torch.int32 and got.ids.shape == (qt.shape[0], k)
    assert_ranked_match(got.ids, got.scores, want.ids, want.scores, atol=1e-5)
    assert DEAD not in got.ids.numpy()


def test_cpu_tensors_never_reach_the_new_kernels(data):
    qt, qm, dt, dm = data
    q, lq, d = qt.shape
    before = (tm.maxsim_fused_cuda.launches, tm.maxsim_maxima_v2_cuda.launches)
    tm.maxsim_scores_v1(*_t(qt, qm, dt, dm))
    tm.maxsim_token_maxima(*_t(qt.reshape(q * lq, d), _token_major(dt, dm, True)), reduce="bf16")
    assert (tm.maxsim_fused_cuda.launches, tm.maxsim_maxima_v2_cuda.launches) == before == (0, 0)
    assert _kernels.load.cache_info().currsize == 0  # nothing was built
    q_flat = torch.zeros(q * lq, d, dtype=torch.bfloat16)
    d_tm = torch.zeros(6, 8, d, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tm.maxsim_fused_cuda(q_flat, torch.from_numpy(qm), d_tm)
    with pytest.raises(ValueError, match="CUDA"):
        tm.maxsim_maxima_v2_cuda(q_flat, d_tm)


def test_bench_reference_agrees_with_the_plain_versions():
    """The bench's blocked einsum reference, on the CPU at a small shape."""
    q_flat, q_mask, corpus_tm, mask_tm = bench_maxsim.make_inputs(2, 5, 50, 9, 16, seed=3, device="cpu")
    assert (mask_tm[:, 0] == 0).all() and int(mask_tm[:, 1].sum()) >= 9  # doc 0 fully masked
    maxima, zeroed, strict = bench_maxsim.reference(q_flat, q_mask, corpus_tm, mask_tm, doc_block=7)
    np.testing.assert_allclose(maxima.numpy(), tm.maxsim_maxima_v2_plain(q_flat, corpus_tm).numpy(),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(zeroed.numpy(), tm.maxsim_fused_plain(q_flat, q_mask, corpus_tm).numpy(),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(strict.numpy(),
                               tm.maxsim_fused_plain(q_flat, q_mask, corpus_tm, mask_tm).numpy(),
                               rtol=1e-6)
    assert (strict[:, 0] == -1e9 * 5).all()


def test_bench_bound_and_ulp():
    ms, by = bench_maxsim.bound(2 * 2048 * 28_032 * 128 * 128, 1.15e9)
    assert by == "operations" and abs(ms - 1.9017) < 1e-3
    ms, by = bench_maxsim.bound(0.876e12, 6.85e9)
    assert by == "bytes" and abs(ms - 2.0448) < 1e-3
    x = torch.tensor([1.0, 1.5, 16.0, 31.9, -20.0])
    np.testing.assert_array_equal(bench_maxsim.bf16_ulp(x).numpy(), [2**-7, 2**-7, 2**-3, 2**-3, 2**-3])
    with pytest.raises(RuntimeError, match="CUDA"):
        if not torch.cuda.is_available():
            bench_maxsim.run(q=1, lq=1, n=1, ld=1, d=16)
        else:
            raise RuntimeError("CUDA present")


def test_bench_fails_without_a_card():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "fusion_tpu_torch.tools.bench_maxsim"], capture_output=True,
        text=True, cwd=repo, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert out.returncode != 0 and out.stdout == "" and "CUDA" in out.stderr


@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("d", list(range(16, 257, 16)))
def test_fused_modes_fit_and_stage_their_epilogue_in_the_ring(d, mask):
    """The fused modes of csrc/maxsim.cu at every width the kernel takes: as
    many stages of ``k1_tokens_per_stage(d, mask)`` tokens as fit (the strict
    mode's stages also hold their tokens' doc-mask words), and a ring whose
    corpus bytes hold both consumers' staged maxima, so the kernel never
    refuses a valid call."""
    tchunk = tm.k1_tokens_per_stage(d, mask)
    stages = tm.fused_stages(d, mask)
    assert stages == tm.maxima_stages(d, tchunk, mask) >= 1
    assert tm.maxima_smem_bytes(d, tchunk, stages, mask) <= tm.MAX_SMEM
    assert stages == 8 or tm.maxima_smem_bytes(d, tchunk, stages + 1, mask) > tm.MAX_SMEM
    corpus = tm.maxima_smem_bytes(d, tchunk, stages) - tm.maxima_smem_bytes(d, tchunk, 0)
    assert corpus >= tm.FUSED_STAGING_BYTES


@pytest.mark.parametrize(
    "d, mask, tchunk, stages",
    [(128, True, 4, 2), (128, False, 4, 2), (64, True, 4, 5), (64, False, 4, 6), (192, True, 2, 2),
     (256, True, 1, 3), (256, False, 1, 3)],
)
def test_fused_stage_counts(d, mask, tchunk, stages):
    """The strict mode's 256 mask bytes per token can cost a stage (D 64)."""
    assert (tm.k1_tokens_per_stage(d, mask), tm.fused_stages(d, mask)) == (tchunk, stages)


@pytest.mark.parametrize("lq, qpw", [(1, 128), (13, 9), (32, 4), (48, 2), (64, 2), (65, 1), (128, 1)])
def test_fused_consumers_start_at_whole_queries(lq, qpw):
    """qpw = floor(128 / Lq) queries per consumer, 2·qpw per block; consumer
    w of block b starts at query (2b + w)·qpw, and every query's Lq rows lie
    inside its consumer's 128."""
    assert tm.fused_queries_per_consumer(lq) == qpw
    for q in range(5 * qpw):
        consumer = q // qpw
        first = tm.fused_first_rows(consumer // 2, lq)[consumer % 2]
        assert first == consumer * qpw * lq
        assert first <= q * lq and (q + 1) * lq <= first + tm.CONSUMER_ROWS


@pytest.mark.parametrize(
    "call",
    ["maxsim_maxima_cuda", "maxsim_maxima_v2_cuda", "maxsim_fused_cuda strict", "maxsim_fused_cuda zeroed",
     "scatter_binmax_cuda", "scatter_pregathered_cuda"],
)
def test_cuda_wrappers_raise_on_cpu_tensors(call):
    """Each kernel wrapper refuses CPU tensors (the dispatchers send those to
    the plain versions) and builds nothing."""
    from fusion_tpu_torch.ops import scatter_score as ts

    q_flat, corpus = torch.zeros(8, 16, dtype=torch.bfloat16), torch.zeros(3, 5, 16, dtype=torch.bfloat16)
    q_mask, d_mask = torch.ones(2, 4), torch.ones(3, 5)
    terms, weights = torch.zeros(2, 4, dtype=torch.int32), torch.ones(2, 4)
    post_doc, post_imp = torch.zeros(9, 2, 8, dtype=torch.int16), torch.ones(9, 2, 8, dtype=torch.float16)
    calls = {
        "maxsim_maxima_cuda": lambda: tm.maxsim_maxima_cuda(q_flat, corpus),
        "maxsim_maxima_v2_cuda": lambda: tm.maxsim_maxima_v2_cuda(q_flat, corpus),
        "maxsim_fused_cuda strict": lambda: tm.maxsim_fused_cuda(q_flat, q_mask, corpus, d_mask),
        "maxsim_fused_cuda zeroed": lambda: tm.maxsim_fused_cuda(q_flat, q_mask, corpus),
        "scatter_binmax_cuda": lambda: ts.scatter_binmax_cuda(terms, weights, post_doc, post_imp, 2048),
        "scatter_pregathered_cuda": lambda: ts.scatter_pregathered_cuda(
            torch.zeros(2, 2, 8, dtype=torch.int32), torch.zeros(2, 2, 8, dtype=torch.bfloat16), 2048),
    }
    with pytest.raises(ValueError, match="CUDA"):
        calls[call]()
    assert _kernels.load.cache_info().currsize == 0
