"""fusion_tpu_torch — the hybrid retrieval framework in PyTorch, for one
NVIDIA Hopper GPU.

The port of ``fusion_tpu`` (JAX, the reference it is tested against).  Plain
tensor code is PyTorch; each TPU kernel on a ported path is a kernel written
by hand for Hopper under ``csrc/``, built with ``nvcc`` at first use.  A
tensor on the card always goes to its kernel; a tensor on the CPU goes to the
kernel's plain PyTorch version, which the CPU tests compare with the JAX
package.  This package never imports JAX.

Ported so far: the ``HybridSearcher`` (BM25 dense impacts, DPR, SPLADE,
ColBERT MaxSim, rank fusion, int8 corpora) and its scale mode (impact-ordered
BM25, the int8 DPR corpus through the binned top-k kernel, SPLADE through the
scatter kernel with an exact rescore), and everything they run.
"""

__version__ = "0.1.0"

from fusion_tpu_torch.core.ranked import PAD_ID, RankedLists

# Heavier public classes resolve lazily so `import fusion_tpu_torch` stays cheap.
_LAZY = {
    "BM25Index": "fusion_tpu_torch.models.bm25",
    "BiEncoder": "fusion_tpu_torch.models.biencoder",
    "ColBERT": "fusion_tpu_torch.models.colbert",
    "EncoderConfig": "fusion_tpu_torch.models.encoder",
    "Aggregator": "fusion_tpu_torch.fusion.aggregator",
    "HybridSearcher": "fusion_tpu_torch.serving",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["RankedLists", "PAD_ID", "__version__", *sorted(_LAZY)]
