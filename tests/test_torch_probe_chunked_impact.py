"""The port's chunked impact probe (``fusion_tpu_torch/tools/
probe_chunked_impact.py``) against the JAX package, on the CPU.

Each stage's output on the same numpy-seeded postings (uint16 local doc
ids with pads, f16 impacts, pad query terms, f32 query weights) against its
JAX form: the gather against ``jnp`` indexing, the two sorts against
``jax.lax.sort`` (the key + payload one stable), the run totals against
``fusion_tpu.ops.segscan.segmented_run_totals`` and the full search, in
both sort forms, against ``fusion_tpu.index.inverted.chunked_impact_search``;
and a run of the JAX script and of the port's tool at one tiny size, which
must print the same metric name and detail keys.

Tolerances: every stage bit-equal (the same f16 products, the same sort
keys, the same additions in the same order); the full search as
``test_torch_item9.py``'s: the packed form bit-equal, the key + payload
form, whose runs the JAX sort orders otherwise, at 2e-6 of the largest
score, ids equal except within ties."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import DEVICE, assert_ranked_match

from fusion_tpu.index import inverted as jax_inv
from fusion_tpu.ops.segscan import segmented_run_totals as jax_run_totals
from fusion_tpu_torch.index.inverted import CHUNK_SENTINEL, ChunkedImpactIndex, chunked_impact_search
from fusion_tpu_torch.tools import probe_chunked_impact as probe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, C, CAPC, DPC, B, KQ = 90, 5, 12, 700, 4, 10


@pytest.fixture(scope="module")
def postings():
    """(JAX index, port index, q_terms, q_weights): a third of each row's
    tail padded, doc ids drawn with repeats inside a row."""
    rng = np.random.default_rng(17)
    post_doc = rng.integers(0, DPC, size=(V + 1, C, CAPC)).astype(np.uint16)
    post_imp = rng.uniform(0.05, 3.0, size=(V + 1, C, CAPC)).astype(np.float16)
    fill = rng.integers(CAPC // 3, CAPC + 1, size=(V + 1, C))
    pad = np.arange(CAPC)[None, None, :] >= fill[..., None]
    pad[V] = True  # the pad term's row
    post_doc[pad], post_imp[pad] = CHUNK_SENTINEL, 0.0
    qt = rng.integers(0, V, size=(B, KQ)).astype(np.int32)
    qw = rng.uniform(0.2, 1.5, size=(B, KQ)).astype(np.float32)
    qt[1, KQ // 2:], qw[1, KQ // 2:] = V, 0.0
    meta = dict(n_docs=C * DPC - 111, docs_per_chunk=DPC, vocab_size=V, cap_per_chunk=CAPC,
                nnz_kept=int((~pad).sum()))
    want = jax_inv.ChunkedImpactIndex(jnp.asarray(post_doc), jnp.asarray(post_imp), **meta)
    got = ChunkedImpactIndex(torch.from_numpy(post_doc.view(np.int16)), torch.from_numpy(post_imp), **meta)
    return want, got, qt, qw


def _jax_gather(index, qt, qw):
    terms = jnp.clip(jnp.asarray(qt), 0, V)
    docs = index.post_doc[terms]
    vals = index.post_impact[terms] * jnp.asarray(qw)[..., None, None].astype(jnp.float16)
    width = qt.shape[1] * CAPC
    return (docs.transpose(0, 2, 1, 3).reshape(B * C, width), vals.transpose(0, 2, 1, 3).reshape(B * C, width))


def _jax_packed(index, qt, qw):
    docs, vals = _jax_gather(index, qt, qw)
    key = (docs.astype(jnp.uint32) << 16) | jax.lax.bitcast_convert_type(vals, jnp.uint16).astype(jnp.uint32)
    return jax.lax.sort(key)


def _bits(x):
    return np.asarray(x).view(np.uint16)


def test_gather_stage_matches_jax(postings):
    want_i, got_i, qt, qw = postings
    docs, vals = probe.gather_stage(got_i, torch.from_numpy(qt), torch.from_numpy(qw))
    w_docs, w_vals = _jax_gather(want_i, qt, qw)
    assert docs.dtype == torch.int64 and vals.dtype == torch.float16
    np.testing.assert_array_equal(docs.numpy(), np.asarray(w_docs).astype(np.int64))
    np.testing.assert_array_equal(_bits(vals.numpy()), _bits(w_vals))


def test_sort2_stage_matches_a_stable_lax_sort(postings):
    want_i, got_i, qt, qw = postings
    docs_s, vals_s = probe.sort2_stage(got_i, torch.from_numpy(qt), torch.from_numpy(qw))
    w_docs, w_vals = jax.lax.sort(_jax_gather(want_i, qt, qw), num_keys=1, is_stable=True)
    np.testing.assert_array_equal(docs_s.numpy(), np.asarray(w_docs).astype(np.int64))
    np.testing.assert_array_equal(_bits(vals_s.numpy()), _bits(w_vals))


def test_packed_sort_stage_matches_lax_sort(postings):
    want_i, got_i, qt, qw = postings
    key_s = probe.sort_packed_stage(got_i, torch.from_numpy(qt), torch.from_numpy(qw))
    want = np.asarray(_jax_packed(want_i, qt, qw))
    np.testing.assert_array_equal(key_s.numpy(), want.astype(np.int64))
    # the pad sorts last: every row's sentinel postings close the row
    docs = key_s.numpy() >> 16
    assert (np.diff((docs == CHUNK_SENTINEL).astype(int), axis=1) >= 0).all()


def test_segscan_stage_matches_jax(postings):
    want_i, got_i, qt, qw = postings
    seg, is_end = probe.segscan_stage(got_i, torch.from_numpy(qt), torch.from_numpy(qw))
    key_s = _jax_packed(want_i, qt, qw)
    docs_s = (key_s >> 16).astype(jnp.uint16)
    vals_s = jax.lax.bitcast_convert_type((key_s & 0xFFFF).astype(jnp.uint16), jnp.float16)
    w_seg, w_end = jax_run_totals(docs_s, vals_s.astype(jnp.float32), KQ)
    np.testing.assert_array_equal(is_end.numpy(), np.asarray(w_end))
    np.testing.assert_array_equal(seg.numpy(), np.asarray(w_seg))


@pytest.mark.parametrize("packed_sort", [True, False], ids=["packed", "sort2"])
def test_full_search_matches_jax(postings, packed_sort):
    want_i, got_i, qt, qw = postings
    kw = dict(k=300, local_k=16, packed_sort=packed_sort)
    w = jax_inv.chunked_impact_search(jnp.asarray(qt), jnp.asarray(qw), want_i, **kw)
    g = chunked_impact_search(torch.from_numpy(qt), torch.from_numpy(qw), got_i, **kw)
    w_ids, w_sc = np.asarray(w.ids), np.asarray(w.scores)
    g_ids, g_sc = g.ids.numpy(), g.scores.numpy()
    fin = np.isfinite(w_sc)
    np.testing.assert_array_equal(np.isfinite(g_sc), fin)
    if packed_sort:
        np.testing.assert_array_equal(g_sc[fin], w_sc[fin])
    atol = 0.0 if packed_sort else 2e-6 * float(np.abs(w_sc[fin]).max())
    assert_ranked_match(g_ids, np.where(fin, g_sc, -1.0), w_ids, np.where(fin, w_sc, -1.0), atol=atol,
                        cut_ties=True)


def test_make_index_draws_rows_of_local_ids_and_impacts():
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    index = probe.make_index(3000, 40, 8, 1024, gen, DEVICE)
    assert index.post_doc.shape == (41, 3, 8) and index.post_doc.dtype == torch.int16
    docs = index.post_doc.long() & 0xFFFF
    assert int(docs.min()) >= 0 and int(docs.max()) < 1024
    imp = index.post_impact.float()
    assert index.post_impact.dtype == torch.float16 and float(imp.min()) >= 0.05 and float(imp.max()) <= 3.0
    wide = probe.make_index(70_000, 2, 4, 65_000, torch.Generator(device=DEVICE).manual_seed(4), DEVICE)
    assert int((wide.post_doc.long() & 0xFFFF).max()) >= 32_768  # past int16: the uint16 bits


TINY = ["--n_docs", "4096", "--batch", "3", "--vocab", "300", "--capc", "8", "--docs_per_chunk", "1024",
        "--iters", "1"]


# the script in a process of its own, on the CPU, its persistent compilation
# cache (a directory outside the checkout) left unset
RUN_SCRIPT = """
import runpy, sys
import jax
update = jax.config.update
jax.config.update = lambda k, v: None if "cache" in k else update(k, v)
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
"""


def test_tool_prints_the_scripts_metric_and_keys():
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}
    script = os.path.join(REPO, "scripts", "probe_chunked_impact.py")
    done = subprocess.run([sys.executable, "-c", RUN_SCRIPT, script, *TINY, "--cpu"], capture_output=True, text=True,
                          env=env, timeout=300, check=True)
    want = json.loads(done.stdout.strip().splitlines()[-1])
    got = probe.main([*TINY, "--device", DEVICE])
    assert got["metric"] == want["metric"] == "chunked_impact_stage_breakdown"
    assert list(got["detail"]) == list(want["detail"])
    for key in ("n_docs", "batch", "vocab", "capc", "chunks"):
        assert got["detail"][key] == want["detail"][key], key
    assert got["device"] == "cpu"
    assert all(got["detail"][k] > 0 for k in got["detail"] if k.endswith("_ms"))


def test_tool_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.main(TINY)
