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
scatter kernel with an exact rescore, ColBERT's residual-compressed index
searched exhaustively or by PLAID through the row-gather kernel), the
cross-encoder rerank (monoBERT or the T5 cross-encoder; packed, flat, the
two-stage cascade and length-bucketed), the encoders' attention forms
(``einsum``, ``einsum_bf16``, ``flash``) and int8 views, the probe tools of the
TPU kernels' variants (``tools/``), and everything they run; and the serving
surface around them: index directories and model checkpoints in the JAX
package's formats (either package loads the other's), percentile NSF, the
metrics (``eval/metrics.py``), ``HybridPipeline`` (``hybrid.py``), the HTTP
server (``server.py``) and the CLI's ``bm25`` / ``hybrid`` / ``serve``
commands (``cli/``, the ``fusion-tpu-torch`` script); and training
(``train/``: losses, schedules, AdamW / Adafactor / blocked Shampoo, the
four families' train steps with dropout and per-layer remat, ``fit``), the
evaluators (``eval/evaluators.py``) and the CLI's ``dpr`` / ``splade`` /
``colbert`` / ``monobert`` commands; training through the ``flash`` form's
kernels (the attention backward); and the way in from HuggingFace
checkpoints, read without ``transformers`` (``utils/hf_weights.py``; the
models' ``from_pretrained_hf``, the T5 loader, ``HFTokenizer``) and the X-MOD
trunk with per-language adapters (``models/xmod.py``, ``from_xmod``); and
streaming index updates (``segmented.py``: new documents as new neural
segments, BM25 rebuilt over the whole corpus on every update by the C++
posting builders of ``native/``), the mMARCO and Mr. TyDi loaders from local
record files (``data/mmarco.py``, ``data/mrtydi.py``); and the multi-device
serving tier (``parallel/``: one process per card on ``torch.distributed``;
``serving_sharded.py``'s ``ShardedHybridSearcher``, the sharded index forms,
sharded segments).
"""

__version__ = "0.1.0"

from fusion_tpu_torch._lazy import lazy_exports
from fusion_tpu_torch.core.ranked import PAD_ID, RankedLists

# Heavier public classes resolve lazily so `import fusion_tpu_torch` stays cheap.
_LAZY = {
    "BM25Index": "models.bm25",
    "BiEncoder": "models.biencoder",
    "ColBERT": "models.colbert",
    "CrossEncoder": "models.crossencoder",
    "T5CrossEncoder": "models.t5",
    "EncoderConfig": "models.encoder",
    "Aggregator": "fusion.aggregator",
    "HybridPipeline": "hybrid",
    "HybridSearcher": "serving",
    "SegmentedHybridSearcher": "segmented",
    "SearchServer": "server",
    "Metrics": "eval.metrics",
    "InformationRetrievalEvaluator": "eval.evaluators",
    "RerankingEvaluator": "eval.evaluators",
    # index forms
    "ImpactIndex": "index.inverted",
    "ChunkedImpactIndex": "index.inverted",
    "scatter_impact_search": "ops.scatter_score",
    "SparseIndex": "index.sparse",
    "QuantizedDenseIndex": "index.dense_quant",
    "CompressedTokenIndex": "index.compression",
    "IVFIndex": "index.plaid",
    # multilingual trunk
    "XmodConfig": "models.xmod",
    "XmodEncoder": "models.xmod",
}
__getattr__, _lazy_names = lazy_exports(__name__, _LAZY)
__all__ = ["RankedLists", "PAD_ID", "__version__", *sorted(_lazy_names)]
