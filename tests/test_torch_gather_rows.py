"""The candidate-row gather of fusion_tpu_torch (ops/gather_rows.py) against
the JAX package's (fusion_tpu/ops/gather_rows.py, Pallas interpret mode):
the same numpy-seeded sources and indices through both, on the CPU, where the
port runs the kernel's plain version (JAX's kernel takes only rows that pack
to 4-byte lanes, so the ragged 3-byte row is held to JAX's plain gather).
Tolerance: none, the outputs are byte-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusion_tpu.ops.gather_rows import gather_rows as jax_gather_rows
from fusion_tpu_torch.ops import gather_rows as gr

N = 30


def _sources(rng, n=N):
    """The PLAID tiers' sources: int32 centroid ids [N, Ld], u8 codes
    [N, Ld, P] (512 B rows, which the interpret-mode kernel streams), an f32
    and a u8 mask [N, Ld], and a ragged 3-byte u8 row."""
    return (
        rng.integers(0, 2**31 - 1, size=(n, 4)).astype(np.int32),
        rng.integers(0, 256, size=(n, 16, 32)).astype(np.uint8),
        (rng.uniform(size=(n, 4)) > 0.3).astype(np.float32),
        (rng.uniform(size=(n, 4)) > 0.3).astype(np.uint8),
        rng.integers(0, 256, size=(n, 3)).astype(np.uint8),
    )


def _both(srcs, idx, rows_per_block):
    # JAX's kernel takes rows that pack to 4-byte lanes; a ragged row goes
    # through its plain src[idx] form (use_pallas=False)
    want = tuple(
        jax_gather_rows(
            (jnp.asarray(s),), jnp.asarray(idx), rows_per_block=rows_per_block, interpret=True,
            use_pallas=s[:1].nbytes % 4 == 0,
        )[0]
        for s in srcs
    )
    got = gr.gather_rows(tuple(torch.from_numpy(s) for s in srcs), torch.from_numpy(idx))
    return got, want


def _assert_bytes_equal(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape
        assert g.numpy().tobytes() == w.tobytes()


@pytest.mark.parametrize("source", range(5))
def test_each_source_matches_jax(source):
    rng = np.random.default_rng(1)
    srcs = _sources(rng)
    idx = rng.integers(0, N, size=(3, 12)).astype(np.int32)
    got, want = _both((srcs[source],), idx, rows_per_block=4)
    _assert_bytes_equal(got, want)


def test_multi_source_one_call_matches_jax():
    """All five sources share one index, as the rescore's cid + codes + mask."""
    rng = np.random.default_rng(2)
    srcs = _sources(rng)
    idx = rng.integers(0, N, size=(2, 8)).astype(np.int32)
    got, want = _both(srcs, idx, rows_per_block=8)
    _assert_bytes_equal(got, want)


def test_duplicate_and_boundary_rows_match_jax():
    rng = np.random.default_rng(3)
    srcs = _sources(rng)
    idx = np.array([[0, 0, N - 1, N - 1, 3, 3, 0, N - 1]], np.int32)
    got, want = _both(srcs, idx, rows_per_block=8)
    _assert_bytes_equal(got, want)


def test_rank_one_source_and_empty_index():
    src = torch.arange(10, dtype=torch.int64)
    (out,) = gr.gather_rows((src,), torch.tensor([[9, 0, 4]], dtype=torch.int32))
    assert out.tolist() == [[9, 0, 4]]
    (empty,) = gr.gather_rows((torch.zeros(10, 3),), torch.zeros((4, 0), dtype=torch.int32))
    assert empty.shape == (4, 0, 3)


def test_plain_path_rejects_rows_out_of_range():
    """An index outside [0, N) is the caller's bug; the kernel does not check
    it, the plain version raises."""
    src = torch.zeros(5, 2)
    with pytest.raises((IndexError, RuntimeError)):
        gr.gather_rows((src,), torch.tensor([[5]], dtype=torch.int32))


def test_cpu_tensors_take_the_plain_version():
    before = gr.gather_rows_cuda.launches
    src = torch.arange(12, dtype=torch.int32).reshape(6, 2)
    (out,) = gr.gather_rows((src,), torch.tensor([[5, 1]], dtype=torch.int32))
    assert out.tolist() == [[[10, 11], [2, 3]]]
    assert gr.gather_rows_cuda.launches == before


@pytest.mark.parametrize(
    "args",
    [
        "cpu",  # a tensor on the CPU never reaches the kernel's wrapper
        "no_sources",
        "too_many_sources",
    ],
)
def test_kernel_wrapper_rejects_what_it_does_not_take(args):
    idx = torch.zeros((1, 1), dtype=torch.int32)
    srcs = {"cpu": (torch.zeros(2, 2),), "no_sources": (), "too_many_sources": (torch.zeros(2),) * 9}[args]
    with pytest.raises(ValueError):
        gr.gather_rows_cuda(srcs, idx)
