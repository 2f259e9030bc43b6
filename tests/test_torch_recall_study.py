"""The port's recall study (``fusion_tpu_torch.tools.recall_study``) against
the JAX package's ``scripts/recall_study.py`` at the script's smoke sizes
(``--n_docs 20000 --colbert_docs 4096 --batch 8``), on the CPU.

  * lexical and splade: both draw their worlds from one numpy generator in
    the same order; the sparse indexes and query matrices every exact search
    receives are bit-equal (hashed), and every overlap key is equal;
  * dense: the script draws its world with ``jax.random`` and the port with
    a torch generator, so one numpy world goes through JAX's
    ``dense_search`` / ``quantized_dense_search`` / ``fused_dense_topk`` (the
    script's calls) and the port's ``dense_section``: equal overlaps;
  * colbert: the worlds are bit-equal; k-means seeding differs between the
    packages, so the port searches the JAX-built compressed index, converted
    (``convert.plaid_index_from_arrays``): every PLAID key equal;
  * the script's ``int8_approx_topk`` row is named under ``not_ported``.

Tolerance: overlaps are compared exactly (rounded to 4 places, as both
report them)."""

import contextlib
import hashlib
import importlib.util
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fusion_tpu_torch.models.convert import plaid_index_from_arrays
from fusion_tpu_torch.tools import recall_study as rs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "recall_study.py")
SMOKE = ["--n_docs", "20000", "--colbert_docs", "4096", "--batch", "8"]


def _digest(*arrays) -> tuple:
    return tuple((a.shape, str(a.dtype), hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest())
                 for a in arrays)


def _load_script():
    spec = importlib.util.spec_from_file_location("jax_recall_study", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def runs():
    """One run of the JAX script and one of the port's tool, every section
    (the worlds draw from one generator in section order), the port's colbert
    section on the JAX-built index; the sparse-search inputs and the colbert
    tokens each received."""
    import fusion_tpu.index.compression as jcomp
    import fusion_tpu.index.sparse as jsparse
    import fusion_tpu_torch.index.sparse as tsparse

    seen = {"jax": [], "port": []}
    built = {}
    orig_jss, orig_tss, orig_ci = jsparse.sparse_search, tsparse.sparse_search, jcomp.compress_token_index

    def jax_ss(qv, sp, *a, **kw):
        seen["jax"].append(_digest(np.asarray(qv), np.asarray(sp.entry_term), np.asarray(sp.entry_weight)))
        return orig_jss(qv, sp, *a, **kw)

    def port_ss(qv, sp, *a, **kw):
        seen["port"].append(_digest(qv.numpy(), sp.entry_term.numpy(), sp.entry_weight.numpy()))
        return orig_tss(qv, sp, *a, **kw)

    def jax_ci(tokens, mask, **kw):
        built["tokens"] = np.asarray(tokens)
        built["index"] = orig_ci(tokens, mask, **kw)
        return built["index"]

    cache_dir = jax.config.jax_compilation_cache_dir
    mp = pytest.MonkeyPatch()
    mp.setattr(jsparse, "sparse_search", jax_ss)
    mp.setattr(tsparse, "sparse_search", port_ss)
    mp.setattr(jcomp, "compress_token_index", jax_ci)
    mp.setattr(sys, "argv", ["recall_study.py", *SMOKE, "--cpu"])
    try:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            _load_script().main()
        jax_detail = json.loads(out.getvalue().strip().splitlines()[-1])["detail"]

        def converted(world, device):
            built["port_tokens"] = world["toks"]
            j = built["index"]
            index, _ = plaid_index_from_arrays(j.centroids, j.centroid_ids, j.codes, j.mask, j.bucket_weights,
                                               j.nbits, device=device)
            return index

        port = rs.run(rs.parse_args([*SMOKE, "--device", "cpu"]), build_colbert_index=converted)["detail"]
    finally:
        mp.undo()
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    return jax_detail, port, seen, built


def _keys(detail, prefix):
    return {k: v for k, v in detail.items() if k.startswith(prefix)}


@pytest.mark.parametrize("section", ["lexical_", "splade_flat_", "splade_peaked_", "plaid_"])
def test_overlaps_equal_the_scripts(runs, section):
    jax_detail, port, _, _ = runs
    want = _keys(jax_detail, section)
    assert want, section
    assert _keys(port, section) == want


def test_sparse_worlds_and_queries_are_bit_equal(runs):
    _, _, seen, _ = runs
    # lexical: one exact search per query set; splade: exact, two query-term
    # caps and the f16 exact, per world
    assert len(seen["port"]) == len(seen["jax"]) == 2 + 2 * 4
    assert seen["port"] == seen["jax"]


def test_colbert_world_is_bit_equal_and_structured(runs):
    jax_detail, port, _, built = runs
    np.testing.assert_array_equal(built["port_tokens"], built["tokens"])
    assert port["plaid_exact_topk_same_topic_frac"] == jax_detail["plaid_exact_topk_same_topic_frac"]
    assert port["plaid_cheapest_config_with_overlap>=0.9"] == jax_detail["plaid_cheapest_config_with_overlap>=0.9"]


def test_dense_section_matches_jax_on_one_numpy_world():
    from fusion_tpu.index.dense_quant import quantize_dense_index, quantized_dense_search
    from fusion_tpu.ops.dense_topk import fused_dense_topk
    from fusion_tpu.ops.mips import dense_search

    rng = np.random.default_rng(3)
    n, b, h, k = 20_000, 8, rs.DENSE_H, 100
    centers = rng.standard_normal((64, h)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=-1, keepdims=True)
    x = centers[rng.integers(0, 64, n)] + 0.35 * rng.standard_normal((n, h)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    q = centers[:b] + 0.35 * rng.standard_normal((b, h)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)

    # the script's dense block on JAX
    corpus, jq = jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(q)
    exact_ids = np.asarray(dense_search(jq.astype(jnp.bfloat16), corpus, k=k, similarity="cos_sim").ids)
    qidx = quantize_dense_index(corpus, similarity="cos_sim")
    want = {
        f"dense_int8_exact_merge_overlap@{k}": rs.overlap_at_k(
            np.asarray(quantized_dense_search(jq, qidx, k=k, local_topk=None).ids), exact_ids, k),
        f"dense_fused_binned_overlap@{k}": rs.overlap_at_k(
            np.asarray(fused_dense_topk(jq, qidx, k=k, use_pallas=False).ids), exact_ids, k),
        "dense_fused_binned_overlap@1000": rs.overlap_at_k(
            np.asarray(fused_dense_topk(jq, qidx, k=1000, use_pallas=False).ids),
            np.asarray(quantized_dense_search(jq, qidx, k=1000, local_topk=None).ids), 1000),
    }
    got = {}
    rs.dense_section(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(q), k, got)
    assert got == {key: round(v, 4) for key, v in want.items()}
    assert got["dense_fused_binned_overlap@1000"] < 1.0  # the binned select does lose docs here


def test_the_approx_row_is_not_ported_and_dense_runs_on_its_own_world():
    record = rs.run(rs.parse_args([*SMOKE, "--device", "cpu", "--only", "dense"]))
    detail = record["detail"]
    assert "int8_approx_topk" in detail["not_ported"]
    assert "exact" in detail["not_ported"]["int8_approx_topk"]
    assert not any("approx" in key for key in detail if key != "not_ported")
    assert 0.9 <= detail["dense_int8_exact_merge_overlap@100"] <= 1.0
    assert set(detail["section_seconds"]) == {"dense"}


def test_the_card_is_the_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rs.run(rs.parse_args(SMOKE))
