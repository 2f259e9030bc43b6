"""The C++ host builders of the lexical indexes, bound by ctypes.

Two hot host loops feed the index builds: the BM25 posting builder
(``csrc/bm25_builder.cpp``: one pass over the newline-joined corpus →
vocabulary, doc-major COO postings, document lengths and frequencies) and
the impact packers (``csrc/impact_packer.cpp``: a bounded min-heap per
(term, doc-range chunk) or per term instead of a global lexsort, which needs
~30 GB and minutes at mMARCO's ~1e9 postings).  They are the JAX package's
sources, kept byte-equal here.

``get_library`` compiles both with ``g++ -O3 -std=c++17 -shared -fPIC`` at
first use into ``_build/`` (listed in ``.gitignore``), keyed by a hash of
the sources and flags, and returns None, with the compiler's stderr logged,
when no compiler is there; each wrapper then returns None and its caller
takes its numpy builder.  Nothing here runs at import.  This is host code,
on every device alike: the arrays it returns are what the numpy builders
give, so only the build time changes.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "bm25_builder.cpp", _PKG / "csrc" / "impact_packer.cpp")
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_LOCK = threading.Lock()
_LIB = None
_LIB_FAILED = False


def build_library(build_dir: Path = BUILD_DIR) -> Path:
    """Compile the two sources into one shared library under ``build_dir``
    (once per source digest) and return its path; raises with the
    compiler's stderr when g++ fails or is missing."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    out = Path(build_dir) / f"libfusion_native-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        ["g++", *GXX_FLAGS, *map(str, SOURCES), "-o", str(tmp)],
        capture_output=True, text=True, timeout=300,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {', '.join(s.name for s in SOURCES)}:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    i32, i64, f32, u16 = (np.ctypeslib.ndpointer(t, flags="C_CONTIGUOUS")
                          for t in (np.int32, np.int64, np.float32, np.uint16))
    lib.bm25_build.restype = ctypes.c_void_p
    lib.bm25_build.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    for fn in ("bm25_nnz", "bm25_vocab_size", "bm25_ndocs", "bm25_vocab_bytes"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.bm25_export.restype = None
    lib.bm25_export.argtypes = [ctypes.c_void_p, i32, i32, f32, f32, i64, ctypes.c_char_p]
    lib.bm25_free.restype = None
    lib.bm25_free.argtypes = [ctypes.c_void_p]
    lib.pack_chunked_impact.restype = ctypes.c_int64
    lib.pack_chunked_impact.argtypes = [i64, i64, f32] + [ctypes.c_int64] * 5 + [u16, u16]
    lib.pack_flat_impact.restype = ctypes.c_int64
    lib.pack_flat_impact.argtypes = [i64, i64, f32] + [ctypes.c_int64] * 4 + [i32, u16]
    return lib


def get_library():
    """The loaded library (compiled if needed), or None when it cannot be
    built (the reason is logged once)."""
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    with _LOCK:
        if _LIB is None and not _LIB_FAILED:
            try:
                _LIB = _bind(build_library())
            except Exception as e:  # log why, so a numpy fallback is diagnosable
                _LIB_FAILED = True
                logging.getLogger(__name__).warning(
                    "native posting builders unavailable (%s): %s — using the numpy builders",
                    type(e).__name__, str(e)[:500],
                )
    return _LIB


def native_available() -> bool:
    return get_library() is not None


def build_bm25_postings(corpus: list[str]):
    """BM25 postings of whitespace-token documents (none may contain a
    newline: the wire format is line-delimited).

    Returns (vocab dict, entry_term i64, entry_doc i64, entry_tf f32,
    doc_len f32, df i64), the numpy builder's arrays in its order, or None
    when the library is unavailable."""
    lib = get_library()
    if lib is None:
        return None
    blob = "\n".join(corpus).encode("utf-8")
    handle = lib.bm25_build(blob, len(blob))
    try:
        nnz, v = lib.bm25_nnz(handle), lib.bm25_vocab_size(handle)
        n, vbytes = lib.bm25_ndocs(handle), lib.bm25_vocab_bytes(handle)
        entry_term = np.empty(nnz, dtype=np.int32)
        entry_doc = np.empty(nnz, dtype=np.int32)
        entry_tf = np.empty(nnz, dtype=np.float32)
        doc_len = np.empty(n, dtype=np.float32)
        df = np.empty(v, dtype=np.int64)
        vocab_buf = ctypes.create_string_buffer(int(vbytes) + 1)
        lib.bm25_export(handle, entry_term, entry_doc, entry_tf, doc_len, df, vocab_buf)
        terms = vocab_buf.raw[: int(vbytes)].decode("utf-8").split("\n")[:v]
        vocab = {t: i for i, t in enumerate(terms)}
        return vocab, entry_term.astype(np.int64), entry_doc.astype(np.int64), entry_tf, doc_len, df
    finally:
        lib.bm25_free(handle)


def _coo(entry_term, entry_doc, impacts):
    return (np.ascontiguousarray(entry_term, dtype=np.int64), np.ascontiguousarray(entry_doc, dtype=np.int64),
            np.ascontiguousarray(impacts, dtype=np.float32))


def pack_chunked_impact(
    entry_term: np.ndarray,
    entry_doc: np.ndarray,
    impacts: np.ndarray,
    vocab_size: int,
    n_docs: int,
    docs_per_chunk: int,
    cap_per_chunk: int,
):
    """Top ``cap_per_chunk`` postings by impact per (term, doc-range chunk).

    Returns (post_doc uint16 [V+1, C, capc], post_imp float16 [V+1, C, capc],
    nnz_kept), the ChunkedImpactIndex arrays, or None when the library is
    unavailable."""
    lib = get_library()
    if lib is None:
        return None
    t, d, v = _coo(entry_term, entry_doc, impacts)
    shape = (vocab_size + 1, -(-n_docs // docs_per_chunk), cap_per_chunk)
    post_doc = np.empty(shape, dtype=np.uint16)
    post_imp_bits = np.empty(shape, dtype=np.uint16)
    kept = lib.pack_chunked_impact(
        t, d, v, t.size, vocab_size, n_docs, docs_per_chunk, cap_per_chunk,
        post_doc.reshape(-1), post_imp_bits.reshape(-1),
    )
    if kept < 0:
        raise ValueError(
            "pack_chunked_impact: term/doc out of range or invalid chunking "
            f"(vocab_size={vocab_size}, n_docs={n_docs}, docs_per_chunk={docs_per_chunk})"
        )
    return post_doc, post_imp_bits.view(np.float16), int(kept)


def pack_flat_impact(
    entry_term: np.ndarray,
    entry_doc: np.ndarray,
    impacts: np.ndarray,
    vocab_size: int,
    n_docs: int,
    cap: int,
):
    """Top ``cap`` postings by impact per term (the flat ImpactIndex layout).

    Returns (post_doc int32 [V+1, cap], post_imp float16 [V+1, cap],
    nnz_kept) or None when the library is unavailable."""
    lib = get_library()
    if lib is None:
        return None
    t, d, v = _coo(entry_term, entry_doc, impacts)
    post_doc = np.empty((vocab_size + 1, cap), dtype=np.int32)
    post_imp_bits = np.empty((vocab_size + 1, cap), dtype=np.uint16)
    kept = lib.pack_flat_impact(
        t, d, v, t.size, vocab_size, n_docs, cap, post_doc.reshape(-1), post_imp_bits.reshape(-1),
    )
    if kept < 0:
        raise ValueError(f"pack_flat_impact: term/doc out of range (vocab_size={vocab_size}, n_docs={n_docs})")
    return post_doc, post_imp_bits.view(np.float16), int(kept)
