"""Seeded weights of the CamemBERT-style encoders, made on the device.

One layout, perfbench's own, that the reference reads directly and that
``systems/`` maps onto the program's modules: the same values reach both.
Each model's weights come from one ``randn`` over all of its entries, drawn
from the run's generator on the device, then cut into views and cast to the
type they are served in (``dtype`` for the linear and embedding matrices and
their biases; float32 for LayerNorm and the cross-encoder's classifier).

Entries: matrices and biases normal(0, ``std``); LayerNorm gains 1 +
normal(0, ``ln_std``), shifts normal(0, ``std``).  Nonzero biases and
gains make the reference follow every term of the layer equations.
"""

from __future__ import annotations

import torch

HEADS = ("dense", "splade", "colbert", "cross")


def layout(enc: dict, head: str, colbert_dim: int = 128) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every entry; kind is ``w`` (matrix), ``b``
    (bias), ``g`` (LayerNorm gain), ``s`` (LayerNorm shift), ``w32`` / ``b32``
    (kept in float32)."""
    h, i, v = enc["hidden_size"], enc["intermediate_size"], enc["vocab_size"]
    out = [
        ("emb.word", (v, h), "w"),
        ("emb.pos", (enc["max_position_embeddings"], h), "w"),
        ("emb.type", (enc["type_vocab_size"], h), "w"),
        ("emb.ln.g", (h,), "g"),
        ("emb.ln.s", (h,), "s"),
    ]
    for li in range(enc["num_hidden_layers"]):
        p = f"L{li}."
        out += [
            (p + "qkv.w", (3 * h, h), "w"), (p + "qkv.b", (3 * h,), "b"),
            (p + "out.w", (h, h), "w"), (p + "out.b", (h,), "b"),
            (p + "ln1.g", (h,), "g"), (p + "ln1.s", (h,), "s"),
            (p + "ffn_in.w", (i, h), "w"), (p + "ffn_in.b", (i,), "b"),
            (p + "ffn_out.w", (h, i), "w"), (p + "ffn_out.b", (h,), "b"),
            (p + "ln2.g", (h,), "g"), (p + "ln2.s", (h,), "s"),
        ]
    if head == "splade":
        out += [
            ("mlm.transform.w", (h, h), "w"), ("mlm.transform.b", (h,), "b"),
            ("mlm.ln.g", (h,), "g"), ("mlm.ln.s", (h,), "s"),
            ("mlm.decoder.w", (v, h), "w"), ("mlm.decoder.b", (v,), "b"),
        ]
    elif head == "colbert":
        out.append(("proj.w", (colbert_dim, h), "w"))
    elif head == "cross":
        out += [
            ("pooler.w", (h, h), "w"), ("pooler.b", (h,), "b"),
            ("cls.w", (1, h), "w32"), ("cls.b", (1,), "b32"),
        ]
    return out


def n_params(enc: dict, head: str, colbert_dim: int = 128) -> int:
    total = 0
    for _, shape, _ in layout(enc, head, colbert_dim):
        size = 1
        for s in shape:
            size *= s
        total += size
    return total


def make_weights(enc: dict, head: str, gen: torch.Generator, device, dtype: torch.dtype,
                 std: float, ln_std: float, colbert_dim: int = 128) -> dict[str, torch.Tensor]:
    """One model's weights from ``gen``: one draw, then views cast to their
    served type."""
    entries = layout(enc, head, colbert_dim)
    z = torch.randn(n_params(enc, head, colbert_dim), generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, kind in entries:
        size = 1
        for s in shape:
            size *= s
        x = z[at : at + size].view(shape)
        at += size
        if kind == "g":
            out[name] = 1.0 + ln_std * x
        elif kind in ("s", "w32", "b32"):
            out[name] = std * x
        else:
            out[name] = (std * x).to(dtype)
    return out
