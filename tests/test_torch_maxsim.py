"""fusion_tpu_torch MaxSim against the JAX package.

The port's plain maxima op (what a CPU tensor runs; the Hopper kernel is
compared with it on the card by chip_smoke.py) is held to the JAX Pallas
kernel in interpret mode, at f32 and atol 1e-5 (only the order of sums over
D differs).  The search is held to the JAX blocked XLA path."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusion_tpu.ops import maxsim as jax_maxsim
from fusion_tpu_torch.ops import _kernels
from fusion_tpu_torch.ops import maxsim

ATOL = 1e-5


def _tokens(rng, n, ld, d):
    """Unit-norm token vectors, as the ColBERT head emits them."""
    x = rng.normal(size=(n, ld, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.fixture
def data(rng):
    q, lq, n, ld, d = 3, 5, 12, 6, 16
    qt = _tokens(rng, q, lq, d)
    qm = np.ones((q, lq), np.float32)
    qm[0, -2:] = 0
    dt = _tokens(rng, n, ld, d)
    dm = np.ones((n, ld), np.float32)
    dm[1, -3:] = 0
    dm[4, 1:] = 0
    return qt, qm, dt, dm


def test_plain_maxima_and_scores_match_pallas_interpret(data):
    qt, qm, dt, dm = data
    q, lq, d = qt.shape
    corpus_tm = np.ascontiguousarray((dt * dm[..., None]).transpose(1, 0, 2))
    q_flat = qt.reshape(q * lq, d)
    q_pad = np.zeros((128, d), np.float32)
    q_pad[: q * lq] = q_flat
    want_maxima = np.asarray(
        jax_maxsim._maxima_T_pallas(
            jnp.asarray(q_pad), jnp.asarray(corpus_tm), block_docs=4, q_chunk=128, interpret=True
        )
    )[:, : q * lq]
    got_maxima = maxsim.maxsim_maxima_plain(torch.from_numpy(q_flat), torch.from_numpy(corpus_tm))
    np.testing.assert_allclose(got_maxima.numpy(), want_maxima, atol=ATOL, rtol=0)

    want = np.asarray(
        jax_maxsim.maxsim_scores_pallas_v2_tm(
            jnp.asarray(qt), jnp.asarray(qm), jnp.asarray(corpus_tm), block_docs=4, interpret=True
        )
    )
    got = maxsim.maxsim_scores_tm(torch.from_numpy(qt), torch.from_numpy(qm), torch.from_numpy(corpus_tm))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_plain_scores_at_untiled_shapes(rng):
    """N 37 and QL 3x7 match no tile size; small doc blocks split the corpus."""
    qt = _tokens(rng, 3, 7, 32)
    qm = (rng.random((3, 7)) > 0.2).astype(np.float32)
    dt = _tokens(rng, 37, 9, 32)
    dm = (rng.random((37, 9)) > 0.3).astype(np.float32)
    zeroed = dt * dm[..., None]
    want = np.asarray(jax_maxsim.maxsim_scores_zeromask(jnp.asarray(qt), jnp.asarray(qm), jnp.asarray(zeroed)))
    corpus_tm = torch.from_numpy(np.ascontiguousarray(zeroed.transpose(1, 0, 2)))
    q_flat = torch.from_numpy(qt.reshape(21, 32))
    maxima = maxsim.maxsim_maxima_plain(q_flat, corpus_tm, doc_block=5)
    np.testing.assert_array_equal(maxima.numpy(), maxsim.maxsim_maxima_plain(q_flat, corpus_tm).numpy())
    got = maxsim.maxsim_scores_tm(torch.from_numpy(qt), torch.from_numpy(qm), corpus_tm)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    ref = maxsim.maxsim_scores_zeromask(torch.from_numpy(qt), torch.from_numpy(qm), torch.from_numpy(zeroed))
    np.testing.assert_allclose(ref.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("outer_block", [65536, 5])
def test_search_matches_jax_and_demotes_padded_docs(data, outer_block):
    qt, qm, dt, dm = data
    dm = dm.copy()
    dm[6] = 0  # fully masked pad doc
    j_tm, j_valid = jax.jit(jax_maxsim.prepare_token_corpus)(jnp.asarray(dt), jnp.asarray(dm))
    t_tm, t_valid = maxsim.prepare_token_corpus(torch.from_numpy(dt), torch.from_numpy(dm))
    np.testing.assert_array_equal(t_tm.float().numpy(), np.asarray(j_tm, dtype=np.float32))
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(j_valid))

    k = dt.shape[0] - 1
    q_bf16 = jnp.asarray(qt).astype(jnp.bfloat16)  # serving casts queries to bf16
    want = jax_maxsim.maxsim_search_tm(
        q_bf16, jnp.asarray(qm), j_tm, j_valid, k=k, use_pallas=False, doc_block=4
    )
    got = maxsim.maxsim_search_tm(
        torch.from_numpy(qt).to(torch.bfloat16), torch.from_numpy(qm), t_tm, t_valid,
        k=k, outer_block=outer_block,
    )
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-6, rtol=0)
    assert 6 not in got.ids.numpy()  # k = N - 1: every valid doc, never the pad


def test_cpu_tensors_never_reach_the_kernel(data):
    qt, qm, dt, dm = data
    t_tm, t_valid = maxsim.prepare_token_corpus(torch.from_numpy(dt), torch.from_numpy(dm))
    before = maxsim.maxsim_maxima_cuda.launches
    maxsim.maxsim_search_tm(torch.from_numpy(qt), torch.from_numpy(qm), t_tm, t_valid, k=4)
    assert maxsim.maxsim_maxima_cuda.launches == before == 0
    assert _kernels.load.cache_info().currsize == 0  # nothing was built
    # the kernel wrapper refuses host tensors instead of computing on them
    with pytest.raises(ValueError, match="CUDA"):
        maxsim.maxsim_maxima_cuda(torch.zeros(4, 16, dtype=torch.bfloat16), t_tm)


def test_import_needs_no_nvcc_triton_or_jax():
    code = (
        "import sys, os; os.environ['PATH'] = ''; "
        "import fusion_tpu_torch.ops.maxsim, fusion_tpu_torch.serving, "
        "fusion_tpu_torch.models.colbert, fusion_tpu_torch.models.biencoder, "
        "fusion_tpu_torch.models.bm25, fusion_tpu_torch.index.sparse, "
        "fusion_tpu_torch.tools.bench_maxsim; "
        "print(sorted(m for m in ('jax', 'triton', 'fusion_tpu') if m in sys.modules))"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, check=True, cwd=repo
    )
    assert out.stdout.strip() == "[]"


def test_build_key_covers_shared_headers_and_flags(tmp_path):
    """The build key of a source changes when only a shared ``csrc/*.cuh``
    header changes (its includers must rebuild), or only the flags."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(_kernels.CSRC_DIR, csrc)
    assert sorted(csrc.glob("*.cuh")), "the kernels share a header"
    base = {name: _kernels.source_digest(name, csrc) for name in ("maxsim", "dense_topk")}
    assert base["maxsim"] == _kernels.source_digest("maxsim")  # the copy keys like the tree
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    for name, digest in base.items():
        assert _kernels.source_digest(name, csrc) != digest
    flags = (*_kernels.NVCC_FLAGS, "-lineinfo")
    assert _kernels.source_digest("maxsim", csrc, flags) != _kernels.source_digest("maxsim", csrc)
