"""What surrounds the masked-attention kernels (``ops/attention.py``,
``csrc/attention.cu``), in Python that a CPU run reaches: each operand's
TMA tensor map (dims, byte strides, box) derived from its strided view, the
refusal of views TMA cannot take, the grid of each kernel, the constants
the Python mirrors of the source, and the source's determinism (no atomic
operation).  The kernels themselves run only on the card (``cuda`` marker,
``test_torch_attention_backward.py`` and ``test_torch_attention_forms.py``)."""

import re
from pathlib import Path

import pytest
import torch

from fusion_tpu_torch.ops import attention as att

SRC = Path(att.__file__).resolve().parent.parent / "csrc" / "attention.cu"
BOX = (64, 1, att.TILE, 1)


@pytest.mark.parametrize("length", [256, 37, 70, 32, 1])
@pytest.mark.parametrize("plane", [0, 1, 2])
def test_tensor_map_of_fused_projection_views(length, plane):
    """q, k, v as the three planes of one fused ``[B, L, 3, H, 64]``
    projection: dims (64, H, L, B), byte strides (head 128, position 3·H·128,
    batch L·3·H·128; at L 1 the position's is the heads' extent, H·128), one
    head's 64 rows per box; the view's base address is the plane's."""
    b, heads = 3, 12
    qkv = torch.zeros((b, length, 3, heads, 64), dtype=torch.bfloat16)
    view = qkv.unbind(2)[plane]
    dims, strides, box = att.tensor_map(view)
    assert dims == (64, heads, length, b)
    assert strides == (128, (3 if length > 1 else 1) * heads * 128, length * 3 * heads * 128)
    assert box == BOX
    assert view.data_ptr() - qkv.data_ptr() == plane * heads * 128


@pytest.mark.parametrize("shape", [(1024, 256, 12, 64), (3, 37, 2, 64), (3, 70, 2, 64), (64, 32, 12, 64)],
                         ids=["bench_doc", "ragged37", "ragged70", "query"])
def test_tensor_map_of_contiguous_tensor(shape):
    """A contiguous ``[B, L, H, 64]`` tensor (the forward's output, dO):
    strides 128, H·128, L·H·128 bytes."""
    b, length, heads, hd = shape
    dims, strides, box = att.tensor_map(torch.zeros(shape, dtype=torch.bfloat16))
    assert dims == (hd, heads, length, b)
    assert strides == (hd * 2, heads * hd * 2, length * heads * hd * 2)
    assert box == BOX


def test_tensor_map_of_gradient_planes():
    """The backward's output buffer ``[B, L, 3, H, 64]``: each of its three
    planes maps as the fused projection's views do."""
    dqkv = torch.zeros((2, 70, 3, 4, 64), dtype=torch.bfloat16)
    maps = [att.tensor_map(t) for t in dqkv.unbind(2)]
    assert all(m == ((64, 4, 70, 2), (128, 3 * 4 * 128, 70 * 3 * 4 * 128), BOX) for m in maps)
    fields = list(att._maps(*dqkv.unbind(2)))
    assert len(fields) == 3 * 11 and fields[:11] == [64, 4, 70, 2, 128, 1536, 107520, *BOX]


def test_tensor_map_extent_one_dims_take_the_inner_extent():
    """A dim of extent 1 is never stepped: its stride is taken as the
    extent of the dims inside it, whatever stride the view reports."""
    t = torch.zeros((1, 37, 1, 64), dtype=torch.bfloat16).as_strided((1, 37, 1, 64), (5, 64, 3, 1))
    assert att.tensor_map(t) == ((64, 1, 37, 1), (128, 128, 37 * 128), BOX)


@pytest.mark.parametrize("case", ["head_stride", "position_stride", "last_dim", "base"])
def test_tensor_map_refuses_what_tma_cannot_take(case):
    """Byte strides that are not multiples of 16, a last dim that is not
    contiguous, and a base address off 16 bytes are refused."""
    if case == "head_stride":  # 68 elements = 136 bytes between heads
        t = torch.zeros((2, 37, 4, 68), dtype=torch.bfloat16)[..., :64]
    elif case == "position_stride":  # rows of 3 heads of 64 + 4 elements
        t = torch.zeros((2, 37, 3 * 64 + 4), dtype=torch.bfloat16)[..., : 3 * 64].view(2, 37, 3, 64)
    elif case == "last_dim":
        t = torch.zeros((2, 37, 64, 4), dtype=torch.bfloat16).transpose(2, 3)
    else:
        t = torch.zeros(2 * 37 * 4 * 64 + 8, dtype=torch.bfloat16)[1:].as_strided((2, 37, 4, 64),
                                                                                (37 * 256, 256, 64, 1))
    with pytest.raises(ValueError):
        att.tensor_map(t)


@pytest.mark.parametrize("b, length, heads", [(128, 256, 12), (1024, 256, 12), (64, 32, 12), (3, 37, 2),
                                              (3, 70, 2), (8, 512, 12), (2, 150, 3)])
def test_grids_of_the_kernels(b, length, heads):
    """bf16: the forward, dQ and dK/dV a block per (row, head, 64 rows) of
    a consumer and a producer warpgroup (256 threads); the D pass 8 lanes
    per row of 64 in blocks of 256.  f32: a
    block of 128 threads per (row, head, 64 rows); the D pass 16 lanes per
    row."""
    tiles = lambda n: b * heads * -(-length // n)  # noqa: E731
    g = att.grids(torch.bfloat16, b, length, heads)
    assert g["forward"] == g["dq"] == g["dkv"] == (tiles(64), 256)
    assert g["rowdot"] == (-(-b * length * heads * 8 // 256), 256)
    g = att.grids(torch.float32, b, length, heads)
    assert g["forward"] == g["dq"] == g["dkv"] == (tiles(64), 128)
    assert g["rowdot"] == (-(-b * length * heads * 16 // 256), 256)


def test_grids_at_the_serving_and_training_shapes():
    """The packed rerank and the bench doc call, as ``PERF.md`` counts them."""
    assert att.grids(torch.bfloat16, 128, 256, 12)["forward"] == (6144, 256)
    assert att.grids(torch.bfloat16, 1024, 256, 12)["dkv"] == (49152, 256)
    assert att.grids(torch.bfloat16, 64, 32, 12)["forward"][0] == 768


def _constant(name: str) -> str:
    m = re.search(rf"constexpr\s+int\s+{name}\s*=\s*([0-9]+)", SRC.read_text())
    assert m, name
    return m.group(1)


def test_python_mirrors_match_the_source():
    """``TILE``, ``MAX_BF16_LENGTH`` and the blocks the grids assume are the
    source's."""
    assert int(_constant("kTile")) == int(_constant("kRows")) == att.TILE == 64
    assert int(_constant("kMaxLength")) == att.MAX_BF16_LENGTH
    assert int(_constant("kRowdotThreads")) == att._ROWDOT_THREADS
    assert int(_constant("kBlockThreads")) == att.grids(torch.bfloat16, 1, 1, 1)["forward"][1]
    assert int(_constant("kWarps")) * 32 == att.grids(torch.float32, 1, 1, 1)["forward"][1]


def test_source_has_no_atomic_operation():
    """Determinism: no atomic function or PTX atomic / reduction in the
    kernels' source or the header it includes, so every launch sums in one
    order."""
    for path in (SRC, SRC.parent / "hopper.cuh"):
        code = re.sub(r"//[^\n]*", "", path.read_text())  # comments may speak of atomics
        assert not re.search(r"atomic|\batom\.|\bred\.", code, re.IGNORECASE), path.name


def _ragged(b, length, heads, seed, packed):
    """Seeded fused qkv [b, length, 3, heads, 64] and dO in bf16, a key mask
    (a full row, a ragged one, an all-pad one, then full rows) and, packed,
    contiguous segments of 23 tokens with a padded tail."""
    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn((b, length, 3, heads, 64), generator=gen).bfloat16()
    d_out = torch.randn((b, length, heads, 64), generator=gen).bfloat16()
    mask = torch.ones((b, length), dtype=torch.int32)
    mask[1, length // 2 + 1:] = 0
    mask[2] = 0
    seg = None
    if packed:
        seg = (torch.arange(length) // 23 + 1)[None].repeat(b, 1) * mask
        mask[0, length - 5:] = seg[0, length - 5:] = 0
    return qkv, d_out, mask, seg


@pytest.mark.cuda
@pytest.mark.parametrize("length", [37, 70, 256, 512])
@pytest.mark.parametrize("packed", [False, True], ids=["flat", "packed"])
def test_bf16_kernels_match_plain_on_the_card(length, packed):
    """On the card (this file imports no JAX, so it runs with
    ``--noconftest`` on a machine without it): FA, its residual mode and
    FA-bwd against their plain versions in bf16 within chip_smoke.py's
    ATTN_TOL / ATTN_BWD_TOL (3e-2 + 1e-2 of the plain value: P and dS round
    to bf16 in another summation order), m within 1e-5 and l within 1e-5
    relative, the residual mode bit-equal to the inference call and a
    second backward bit-equal to the first."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels have no CPU mode")
    qkv, d_out, mask, seg = (None if t is None else t.cuda() for t in _ragged(4, length, 3, length, packed))
    q, k, v = qkv.unbind(2)

    def within(got, want):
        assert bool(((got.float() - want.float()).abs() <= 3e-2 + 1e-2 * want.float().abs()).all())

    with torch.no_grad():
        out, m, l = att.masked_attention_cuda(q, k, v, mask, seg, 0.125, residuals=True)
        assert torch.equal(out, att.masked_attention_cuda(q, k, v, mask, seg, 0.125))
        want, pm, pl = att.masked_attention_plain(q, k, v, mask, seg, 0.125, residuals=True)
        within(out, want)
        assert ((m - pm).abs() / (1 + pm.abs())).max() <= 1e-5 and ((l - pl).abs() / pl).max() <= 1e-5
        got = att.masked_attention_backward_cuda(q, k, v, out, m, l, d_out, mask, seg, 0.125)
        for g, w in zip(got, att.masked_attention_backward_plain(q, k, v, out, m, l, d_out, mask, seg, 0.125)):
            within(g, w)
        assert all(torch.equal(a, b) for a, b in zip(got, att.masked_attention_backward_cuda(
            q, k, v, out, m, l, d_out, mask, seg, 0.125)))
