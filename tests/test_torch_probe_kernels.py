"""The plain versions of the probe kernels P3, P4 and P5 (which a CPU tensor
runs, and the Hopper kernels are held to on the card) against the JAX
package and the probe scripts' own TPU kernels.

  * P3 (``scripts/probe_dense.py::_binmax_nomask``): ``binmax_plain(...,
    dead_rows=False)`` against ``_bin_reduce_pack(raw · s, doc0, n_docs)``
    per doc block, bit-equal.  Queries of small integers make every dot an
    exact integer sum, so the two matmuls agree bit for bit whatever their
    order; scale-0 rows are planted where a pad row must win its bin without
    the dead-row term (and lose it with it, as JAX's K2 reference shows).
  * ``fused_dense_topk(doc_block=4096)`` against JAX's
    ``use_pallas=False`` path: scores at atol 1e-6, ids equal up to the order
    of near-ties.
  * P5 (``scripts/probe_scatter_kernel.py::_b3d_kernel``, loaded by path and
    run through ``pl.pallas_call(..., interpret=True)`` on JAX's
    ``_gather_postings`` output): packed bits equal where no doc gets more
    than two postings in a chunk (a sum of two values is the same in any
    order), within rtol 1e-6 with equal offsets on random postings.
  * P4 (term-major, ``_kernel_nt``'s function): bit-equal to P5 on the
    transposed operands, and its search equal to JAX's reference scatter
    search on the same index (scores bit-exact, ids up to exact ties).
  * The Hopper kernel's arithmetic that the CPU can reach: its
    shared-memory sizes (``pregathered_smem_bytes``) and the refusal of a
    layout that does not fit, its staging and posting loop emulated in
    numpy on every item of small operands, and the persistent CTAs' item
    partition; and the variant specs of ``tools/scatter_ab.py``."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import DEVICE, assert_ranked_match

from fusion_tpu.index import dense_quant as jax_quant
from fusion_tpu.index import inverted as jax_inv
from fusion_tpu.ops import dense_topk as jax_topk
from fusion_tpu.ops import scatter_score as jax_scatter
from fusion_tpu_torch.index import dense_quant, inverted
from fusion_tpu_torch.ops import _kernels, dense_topk, scatter_score
from fusion_tpu_torch.tools import scatter_ab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.uint32)


def _jax_binmax(q, values, scales, n_docs, doc_block, dead_rows):
    """JAX's per-block body: the bf16 → f32 dot, then ``_apply_scales`` (K2)
    or the bare ``raw · s`` (P3, ``_binmax_nomask``), then the bin pack."""
    out = []
    for b in range(values.shape[0] // doc_block):
        v = jnp.asarray(values[b * doc_block : (b + 1) * doc_block])
        s = jnp.asarray(scales[b * doc_block : (b + 1) * doc_block])
        raw = jax.lax.dot_general(
            jnp.asarray(q), v.astype(jnp.bfloat16), (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        scored = jax_topk._apply_scales(raw, s) if dead_rows else raw * s[None, :]
        out.append(np.asarray(jax_topk._bin_reduce_pack(scored, jnp.int32(b * doc_block), n_docs)))
    return np.concatenate(out, axis=1)


def _binmax_inputs(rng, doc_block, h=32, q=4):
    """Integer-valued bf16 queries, int8 rows over 3 doc blocks, scales with
    planted zeros; query 0's bin (block 0, lane 3) holds only docs of
    negative similarity and one scale-0 row."""
    n = 3 * doc_block
    qi = rng.integers(-8, 9, size=(q, h)).astype(np.float32)
    qi[0, 0] = 5.0  # never all zero
    values = rng.integers(-127, 128, size=(n, h)).astype(np.int8)
    scales = rng.uniform(5e-4, 2.5e-3, size=n).astype(np.float32)
    scales[::37] = 0.0
    lanes = doc_block // 16
    bin_docs = 3 + lanes * np.arange(16)
    values[bin_docs] = np.clip(-np.sign(qi[0]) * 100, -127, 127).astype(np.int8)
    scales[bin_docs] = 1e-3
    scales[bin_docs[5]] = 0.0
    return jnp.asarray(qi, jnp.bfloat16), qi, values, scales, n


@pytest.mark.parametrize("doc_block", [2048, 4096, 8192])
def test_p3_plain_bit_equal_to_binmax_nomask(rng, doc_block):
    q_bf16, qi, values, scales, n = _binmax_inputs(rng, doc_block)
    n_docs = 2 * doc_block + 100  # the rows past the real row count stay masked
    tq = torch.from_numpy(qi).to(torch.bfloat16)
    tv, ts = torch.from_numpy(values), torch.from_numpy(scales)
    got_p3 = dense_topk.binmax_plain(tq, tv, ts, n_docs, doc_block, dead_rows=False).numpy()
    got_k2 = dense_topk.binmax_plain(tq, tv, ts, n_docs, doc_block).numpy()
    want_p3 = _jax_binmax(q_bf16, values, scales, n_docs, doc_block, dead_rows=False)
    want_k2 = _jax_binmax(q_bf16, values, scales, n_docs, doc_block, dead_rows=True)
    np.testing.assert_array_equal(_bits(got_p3), _bits(want_p3))
    np.testing.assert_array_equal(_bits(got_k2), _bits(want_k2))
    # the planted bin: the scale-0 row wins it without the dead-row term
    # (score -0.0, offset 5) and loses it with it
    assert _bits(got_p3[0, 3]) == np.uint32(0x80000005)
    assert got_k2[0, 3] < 0 and (_bits(got_k2[0, 3]) & 0xF) != 5
    differ = _bits(got_p3) != _bits(got_k2)
    assert differ.any() and np.array_equal(differ, _bits(want_p3) != _bits(want_k2))
    # bins whose docs all lie past n_docs are -inf in both variants
    first = 2 * (doc_block // 16) + 100
    assert np.isneginf(got_p3[:, first:]).all() and np.isneginf(got_k2[:, first:]).all()
    assert np.isfinite(got_p3[:, first - 1]).all()


@pytest.mark.parametrize("dead", [False, True])
def test_fused_dense_topk_doc_block_4096_matches(rng, dead):
    n, k = 3 * 4096 + 100, 50
    x = rng.normal(size=(n, 32)).astype(np.float32)
    q = rng.normal(size=(3, 32)).astype(np.float32)
    want_idx = jax_quant.quantize_dense_index(jnp.asarray(x), "cos_sim")
    got_idx = dense_quant.quantize_dense_index(torch.from_numpy(x), "cos_sim")
    if dead:  # scale 0: the dead-row convention of build pads
        rows = np.arange(0, n, 3)
        want_idx = want_idx._replace(scales=want_idx.scales.at[rows].set(0.0))
        got_idx.scales[torch.from_numpy(rows)] = 0.0
    want = jax_topk.fused_dense_topk(jnp.asarray(q), want_idx, k=k, doc_block=4096, use_pallas=False)
    got = dense_topk.fused_dense_topk(torch.from_numpy(q), got_idx, k=k, doc_block=4096)
    assert got.ids.dtype == torch.int32 and got.ids.shape == (3, k)
    assert_ranked_match(got.ids, got.scores, want.ids, want.scores, atol=1e-6)


def _b3d_kernel():
    spec = importlib.util.spec_from_file_location(
        "probe_scatter_kernel", os.path.join(REPO, "scripts", "probe_scatter_kernel.py")
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module._b3d_kernel


def _b3d_interpret(docs, vals, dpc: int, cb: int) -> np.ndarray:
    """The script's ``run_kernel(_b3d_kernel, cb, ...)`` in interpret mode
    → packed bins [Q, Cp·dpc/16]."""
    import functools

    from jax.experimental import pallas as pl

    h = jax_scatter._plan(dpc)
    q, c_pad, w = docs.shape
    g = h // 16
    out = pl.pallas_call(
        functools.partial(_b3d_kernel(), h=h, chunk_block=cb),
        grid=(q, c_pad // cb),
        in_specs=[
            pl.BlockSpec((1, cb, w), lambda qi, ci: (qi, ci, 0)),
            pl.BlockSpec((1, cb, w), lambda qi, ci: (qi, ci, 0)),
        ],
        out_specs=pl.BlockSpec((1, cb, g, 128), lambda qi, ci: (qi, ci, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((q, c_pad, g, 128), jnp.float32),
        interpret=True,
    )(docs, vals)
    return np.asarray(out).reshape(q, -1)


def _chunk_index(post_doc, vocab, dpc, seed):
    """(JAX index rows, port index rows) from the same uint16 doc ids."""
    rng = np.random.default_rng(seed)
    imp = rng.uniform(0.05, 3.0, size=post_doc.shape).astype(np.float16)
    post_doc = post_doc.astype(np.uint16)
    post_doc[vocab], imp[vocab] = 0xFFFF, 0.0  # the sentinel row of pad terms
    return (jnp.asarray(post_doc), jnp.asarray(imp)), (
        torch.from_numpy(post_doc.view(np.int16).copy()), torch.from_numpy(imp.copy()))


def _queries(rng, vocab, q, kq):
    terms = np.stack([rng.permutation(vocab)[:kq] for _ in range(q)]).astype(np.int32)
    weights = rng.uniform(0.2, 1.5, size=(q, kq)).astype(np.float32)
    terms[0, kq // 2 :], weights[0, kq // 2 :] = vocab, 0.0  # pad slots
    return terms, weights


@pytest.mark.parametrize("fixture", ["two_per_doc", "random"])
def test_p5_plain_matches_b3d_kernel(rng, fixture):
    vocab, c, capc, dpc, kq = 200, 5, 16, 2048, 8
    if fixture == "two_per_doc":
        # term v's docs in chunk c are v·16 + j + 7c (mod 2048): two terms
        # share a doc only when they are 128 apart, so no doc of a chunk
        # gets more than two postings from distinct query terms
        v, ci, j = np.meshgrid(np.arange(vocab + 1), np.arange(c), np.arange(capc), indexing="ij")
        post_doc = (v * capc + j + 7 * ci) % dpc
    else:
        post_doc = rng.integers(0, 64, size=(vocab + 1, c, capc))  # crowded: many sums
    (jd, ji), (td, ti) = _chunk_index(post_doc, vocab, dpc, seed=1)
    terms, weights = _queries(rng, vocab, 4, kq)
    cb = 2
    w_docs, w_vals = jax_scatter._gather_postings(jnp.asarray(terms), jnp.asarray(weights), jd, ji, cb)
    want = _b3d_interpret(w_docs, w_vals, dpc, cb)
    g_docs, g_vals = scatter_score._gather_postings(torch.from_numpy(terms), torch.from_numpy(weights), td, ti, cb)
    got = scatter_score.scatter_pregathered_plain(g_docs, g_vals, dpc).numpy()
    assert got.shape == want.shape == (4, 6 * dpc // 16)  # 5 chunks padded to 6
    if fixture == "two_per_doc":
        np.testing.assert_array_equal(_bits(got), _bits(want))
    else:
        fin = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), fin)
        clean = lambda x: (_bits(x) & 0xFFFFFFF0).view(np.float32)  # noqa: E731
        np.testing.assert_allclose(clean(got)[fin], clean(want)[fin], rtol=1e-6, atol=0)
        np.testing.assert_array_equal(_bits(got)[fin] & 0xF, _bits(want)[fin] & 0xF)


def _chunked(rng, n=9000, vocab=48, dpc=2048, cap=16):
    doc = np.repeat(np.arange(n, dtype=np.int64), 3)
    term = rng.integers(0, vocab, size=doc.size)
    pair = np.unique(term * n + doc)
    term, doc = pair // n, pair % n
    imp = rng.uniform(0.1, 2.0, size=term.size).astype(np.float32)
    want = jax_inv.build_chunked_impact_index(term, doc, imp, vocab, n, dpc, cap, use_native=False)
    got = inverted.build_chunked_impact_index(term, doc, imp, vocab, n, dpc, cap, device=DEVICE)
    return want, got


@pytest.mark.parametrize("k", [40, 9000])
def test_p4_plain_matches_p5_and_reference_search(rng, k):
    want_idx, got_idx = _chunked(rng)
    terms, weights = _queries(rng, 48, 4, 6)
    tt, tw = torch.from_numpy(terms), torch.from_numpy(weights)
    cm = scatter_score._gather_postings(tt, tw, got_idx.post_doc, got_idx.post_impact, 4)
    tm = scatter_score.gather_postings_term_major(tt, tw, got_idx.post_doc, got_idx.post_impact, 4)
    assert tm[0].shape == (4, 6, 8, 16) and cm[0].shape == (4, 8, 96)  # 5 chunks padded to 8
    np.testing.assert_array_equal(tm[0].permute(0, 2, 1, 3).reshape(cm[0].shape).numpy(), cm[0].numpy())
    p4 = scatter_score.scatter_pregathered_plain(*tm, 2048, "term_major")
    p5 = scatter_score.scatter_pregathered_plain(*cm, 2048, "chunk_major")
    np.testing.assert_array_equal(_bits(p4.numpy()), _bits(p5.numpy()))
    want = jax_scatter.scatter_impact_search(jnp.asarray(terms), jnp.asarray(weights), want_idx, k=k,
                                             chunk_block=4, use_pallas=False)
    got = scatter_score.pregathered_search(*tm, got_idx.n_docs, 2048, k=k, layout="term_major")
    assert got.ids.dtype == torch.int32 and got.ids.shape == want.ids.shape
    # scores bit-exact; ids too, up to the order of exactly equal packed
    # scores (JAX's approx_max_k on the CPU does not order those by position)
    assert_ranked_match(got.ids, got.scores, want.ids, want.scores, atol=0.0)


def test_cpu_tensors_never_reach_the_probe_kernels(rng):
    _, got_idx = _chunked(rng, n=3000)
    terms, weights = _queries(rng, 48, 2, 4)
    docs, vals = scatter_score.gather_postings_term_major(
        torch.from_numpy(terms), torch.from_numpy(weights), got_idx.post_doc, got_idx.post_impact, 16
    )
    before = (scatter_score.scatter_pregathered_cuda.launches,
              scatter_score.scatter_pregathered_cuda.term_major_launches, dense_topk.binmax_cuda.nomask_launches)
    scatter_score.pregathered_search(docs, vals, 3000, 2048, k=5, layout="term_major")
    idx = dense_quant.quantize_dense_index(torch.from_numpy(rng.normal(size=(4096, 32)).astype(np.float32)))
    dense_topk.fused_dense_topk(torch.ones(2, 32), idx, k=5, doc_block=4096, dead_rows=False)
    after = (scatter_score.scatter_pregathered_cuda.launches,
             scatter_score.scatter_pregathered_cuda.term_major_launches, dense_topk.binmax_cuda.nomask_launches)
    assert before == after == (0, 0, 0)
    assert _kernels.load.cache_info().currsize == 0  # nothing was built
    with pytest.raises(ValueError, match="CUDA"):
        scatter_score.scatter_pregathered_cuda(docs, vals, 2048, "term_major")
    with pytest.raises(ValueError, match="layout"):
        scatter_score.scatter_pregathered_plain(docs, vals, 2048, "diagonal")


@pytest.mark.parametrize(
    "kq, capc, dpc, layout, depth, nbytes",
    [(64, 32, 16384, "chunk_major", 3, 102_430), (64, 32, 16384, "term_major", 3, 102_808),
     (64, 128, 2048, "chunk_major", 2, 106_516), (64, 128, 2048, "term_major", 2, 106_768),
     (64, 74, 2048, "term_major", 3, 103_832), (7, 13, 2048, "term_major", 3, 10_946),
     (64, 512, 16384, "chunk_major", 0, 458_772), (64, 512, 16384, "term_major", 0, 459_024)],
)
def test_pregathered_staging_fits_two_blocks_at_the_probe_layout(kq, capc, dpc, layout, depth, nbytes):
    """``pregathered_smem_bytes`` mirrors csrc/scatter_score.cu's
    ``runs_smem``: three ring slots at the probe layout (Kq 64 x capc 32 at
    dpc 16,384, 12 KB an item) and at unaligned rows (capc 74, 13), two at
    the widest (Kq·capc 8,192, 48 KB an item: two blocks still fit an SM),
    none past one block's 227 KB, where the wrapper refuses the layout
    before anything is built."""
    assert scatter_score.pregathered_smem_bytes(kq, capc, dpc, layout) == (depth, nbytes)
    if depth == 3:
        assert nbytes <= scatter_score.SMEM_PER_TWO_BLOCKS
    elif depth == 2:  # a third slot would not leave room for a second block
        assert nbytes <= scatter_score.SMEM_PER_TWO_BLOCKS < nbytes + (nbytes - 4 * dpc) // 2
    else:
        assert nbytes > scatter_score.MAX_SMEM
        shape = (1, 1, kq * capc) if layout == "chunk_major" else (1, kq, 1, capc)
        docs = torch.zeros(shape, dtype=torch.int32)
        with pytest.raises(ValueError, match="shared memory"):
            scatter_score.scatter_pregathered_cuda(docs, docs.to(torch.bfloat16), dpc, layout)
        assert _kernels.load.cache_info().currsize == 0  # nothing was built


def _item_geometry(shape, layout):
    """(runs, run length, q_stride, c_stride, t_stride) of an item, as
    ``scatter_pregathered`` passes them to the kernel."""
    if layout == "chunk_major":
        _, cp, w = shape
        return 1, w, cp * w, w, w
    _, kq, cp, capc = shape
    return kq, capc, kq * cp * capc, capc, cp * capc


def _stage_and_read(docs, vals, layout, q, c, bulk):
    """numpy emulation of ``scatter_runs_kernel`` on item (q, c): its copies
    into a ring slot (bulk: one copy of each run's 16-byte-aligned span;
    else the span's 16-byte words), then its posting loop's reads (a
    16-byte word of docs and the 8 bytes of values beside it per group of 4
    postings).  Addresses count bytes from the arrays' 16-byte-aligned
    starts.  Returns the (doc, value-bits) postings read, [runs, length]."""
    mem = (docs.numpy().tobytes(), vals.view(torch.int16).numpy().tobytes())
    runs, length, q_stride, c_stride, t_stride = _item_geometry(docs.shape, layout)
    dslot, vslot = scatter_score.pregathered_run_slots(length)
    slot = np.zeros(runs * (dslot + vslot), np.uint8)
    copied = np.zeros(slot.size, bool)
    offs = np.zeros((runs, 2), np.int64)
    base = q * q_stride + c * c_stride
    for i in range(2 * runs):
        t, arr = i >> 1, i & 1
        eb, room = (2, vslot) if arr else (4, dslot)
        start = eb * (base + t * t_stride)
        s16 = start - start % 16
        offs[t, arr] = start - s16
        n = -(-(offs[t, arr] + eb * length) // 16) * 16  # the span's bytes
        dst = runs * dslot + t * vslot if arr else t * dslot
        words = [(s16, dst, n)] if bulk else [(s16 + 16 * k, dst + 16 * k, 16) for k in range(room // 16) if 16 * k < n]
        for src, at, nb in words:
            assert src % 16 == at % 16 == nb % 16 == 0 and dst <= at and at + nb <= dst + room
            # the last word may run past the array's end, never past its 16-byte word
            assert src + nb <= -(-len(mem[arr]) // 16) * 16
            got = np.frombuffer(mem[arr][src : src + nb], np.uint8)
            slot[at : at + got.size] = got
            copied[at : at + nb] = True
    if length % 8 == 0:
        assert not offs.any()  # the kernel reads no offsets then
    got_d = np.zeros((runs, length), np.int32)
    got_v = np.zeros((runs, length), np.uint16)
    seen = np.zeros((runs, length), np.int64)
    for t in range(runs):
        od, ov = offs[t]
        for g in range(dslot // 16):
            i0 = 4 * g - od // 4  # the run's posting in the group's first lane
            if i0 >= length:
                continue
            dpos = t * dslot + 16 * g
            vpos = runs * dslot + t * vslot + ov - od // 2 + 8 * g
            assert vpos % 8 == 0 and vpos + 8 <= runs * dslot + (t + 1) * vslot
            d4, v4 = slot[dpos : dpos + 16].view(np.int32), slot[vpos : vpos + 8].view(np.uint16)
            for k in range(4):
                if 0 <= i0 + k < length:
                    assert copied[dpos + 4 * k : dpos + 4 * k + 4].all()
                    assert copied[vpos + 2 * k : vpos + 2 * k + 2].all()
                    got_d[t, i0 + k], got_v[t, i0 + k] = d4[k], v4[k]
                    seen[t, i0 + k] += 1
    assert (seen == 1).all()
    return got_d, got_v


@pytest.mark.parametrize("layout", ["chunk_major", "term_major"])
@pytest.mark.parametrize("capc", [13, 16, 32, 74])
def test_pregathered_staging_reads_each_items_postings(rng, layout, capc):
    """The kernel's staging and posting loop, emulated in numpy for every
    item of small gathered operands, reproduce ``docs[q, c]`` (chunk-major)
    or ``docs[q, :, c]`` (term-major) and the value bits byte for byte,
    whether the runs go as bulk copies or as 16-byte copies: capc 13 and 74
    start runs inside 16-byte words, capc 16 and 32 on their boundaries."""
    vocab, c, kq = 40, 3, 3
    post_doc = rng.integers(0, 2048, size=(vocab + 1, c, capc))
    _, (td, ti) = _chunk_index(post_doc, vocab, 2048, seed=2)
    terms, weights = _queries(rng, vocab, 2, kq)
    gather = scatter_score._gather_postings if layout == "chunk_major" else scatter_score.gather_postings_term_major
    docs, vals = gather(torch.from_numpy(terms), torch.from_numpy(weights), td, ti, 1)
    vbits = vals.view(torch.int16).numpy().view(np.uint16)
    for q in range(2):
        for ci in range(c):
            want_d = docs.numpy()[q, ci] if layout == "chunk_major" else docs.numpy()[q, :, ci]
            want_v = vbits[q, ci] if layout == "chunk_major" else vbits[q, :, ci]
            for bulk in (True, False):
                got_d, got_v = _stage_and_read(docs, vals, layout, q, ci, bulk)
                np.testing.assert_array_equal(got_d.reshape(want_d.shape), want_d)
                np.testing.assert_array_equal(got_v.reshape(want_v.shape), want_v)


@pytest.mark.parametrize("blocks", [1, 7, 264])
@pytest.mark.parametrize("nq, c", [(3, 100), (64, 545)])
def test_persistent_ctas_cover_each_item_once(blocks, nq, c):
    """The persistent kernels' item partition (grid = min(items, resident
    blocks); CTA b takes items [items·b/grid, items·(b+1)/grid) and walks
    them by (query, chunk) additions) covers every (query, chunk) exactly
    once, at item counts no grid size here divides."""
    items = nq * c
    grid = min(items, blocks)
    assert grid == 1 or items % grid
    seen = np.zeros((nq, c), np.int64)
    for b in range(grid):
        first = items * b // grid
        steps = items * (b + 1) // grid - first
        assert steps >= 1
        q, chunk = first // c, first % c
        for _ in range(steps):
            seen[q, chunk] += 1
            chunk += 1
            if chunk == c:
                chunk, q = 0, q + 1
    assert (seen == 1).all()


@pytest.mark.parametrize(
    "spec, want",
    [("old=_scratch/old.cu", ("old", "_scratch/old.cu", [])),
     ("split=a.cu:NO_POST,FORCE_BULK", ("split", "a.cu", ["-DNO_POST", "-DFORCE_BULK"]))],
)
def test_scatter_ab_variant_specs(spec, want):
    """``tools/scatter_ab.py``'s variants: NAME=PATH[:MACRO,...]; a spec
    without a name or a path is refused before anything is built."""
    assert scatter_ab.parse_variant(spec) == want
    for bad in ("old.cu", "=old.cu", "old="):
        with pytest.raises(ValueError, match="NAME=PATH"):
            scatter_ab.parse_variant(bad)
