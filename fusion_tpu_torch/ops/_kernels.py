"""Build and bind the package's CUDA kernels: ``nvcc`` → shared library →
``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface.  ``load(name)``
compiles it for Hopper (``sm_90a``) at first use into ``_build/`` (listed in
``.gitignore``), keyed by ``source_digest`` (the source, every shared
``csrc/*.cuh`` header and the flags), and returns the
loaded library; ``load_all(names)`` runs the compilers in parallel.  Nothing here runs at import, so the package imports on a
machine without ``nvcc`` or a card; a build failure raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    nvcc = Path(cuda_home) / "bin" / "nvcc"
    if nvcc.exists():
        return str(nvcc)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def source_digest(name: str, csrc_dir: Path = CSRC_DIR, flags=NVCC_FLAGS) -> str:
    """The build key of ``csrc/<name>.cu``: a hash of the source, of every
    header in ``csrc_dir`` (a header edit alone must rebuild its includers)
    and of the compiler flags."""
    h = hashlib.sha256((csrc_dir / f"{name}.cu").read_bytes())
    for header in sorted(csrc_dir.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The compiled ``csrc/<name>.cu``.  The library carries ``build_log``
    (the compiler's register/shared-memory report, empty when it was already
    built) and ``build_seconds``."""
    src = CSRC_DIR / f"{name}.cu"
    lib_path = BUILD_DIR / f"lib{name}-{source_digest(name)}.so"
    log, seconds = "", 0.0
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib_path)  # atomic: concurrent loaders never see half a file
        log = proc.stdout + proc.stderr
    lib = ctypes.CDLL(str(lib_path))
    lib.build_log, lib.build_seconds = log, seconds
    return lib


def load_all(names) -> list[ctypes.CDLL]:
    """``load`` for several sources at once: one ``nvcc`` per source, all
    running together."""
    from concurrent.futures import ThreadPoolExecutor

    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return list(pool.map(load, names))
