"""Residual-compressed ColBERT token index (colbert-ai's scheme: nbits=2,
kmeans_niters=4).

  * ``kmeans``           — Lloyd iterations on the index's device: assignment
                           is an argmax of ``x·c − ‖c‖²/2`` blocked over points,
                           the update a sum per cluster; empty clusters are
                           re-seeded from the farthest points;
  * compression          — every token is its nearest centroid id plus a
                           per-dimension residual quantized to ``nbits``
                           against global quantile cutoffs, bit-packed into
                           uint8 (planar layout);
  * ``maxsim_search_compressed`` — block decompression into a token-major
                           bf16 ``[Ld, B, D]`` block scored by the MaxSim
                           kernel (``ops/maxsim.py``), merged into a running
                           top-k.

The k-means seeding draws from a numpy generator built from ``seed``, so the
CPU and the card start from the same centroids (the JAX package draws from
``jax.random``, which the port cannot reproduce: ``init=`` takes given
centroids instead).  Memory at D 128, nbits 2: 32 B of codes + 4 B of
centroid id + the mask per token, against 256 B in bf16.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from fusion_tpu_torch.core.ranked import RankedLists
from fusion_tpu_torch.ops.maxsim import maxsim_scores_tm
from fusion_tpu_torch.ops.topk import blockwise_topk_offset

KMEANSPP_MAX_K = 4096  # above this, seed from a random permutation (faiss's choice)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ----------------------------------------------------------------------
# k-means (Lloyd)
# ----------------------------------------------------------------------
def _kmeanspp_init(x: torch.Tensor, k: int, rng: np.random.Generator) -> torch.Tensor:
    """k-means++ seeding: each next centroid is drawn ∝ the squared distance
    to the nearest chosen one, by inverse CDF with uniforms from ``rng``."""
    n, d = x.shape
    out = torch.empty((k, d), dtype=x.dtype, device=x.device)
    out[0] = x[int(rng.integers(n))]
    mindist = ((x - out[0]) ** 2).sum(-1)
    draws = torch.as_tensor(rng.random(max(k - 1, 0)), dtype=torch.float32, device=x.device)
    for i in range(1, k):
        cdf = torch.cumsum(mindist.clamp_min(1e-30), 0)
        pick = torch.searchsorted(cdf, cdf[-1:] * draws[i - 1 : i], right=True).clamp_max(n - 1)
        out[i] = x[pick][0]
        mindist = torch.minimum(mindist, ((x - out[i]) ** 2).sum(-1))
    return out


def kmeans(
    x: torch.Tensor,
    k: int,
    iters: int = 4,
    seed: int = 0,
    block_points: int = 16384,
    init: torch.Tensor | None = None,
) -> torch.Tensor:
    """Lloyd k-means over the rows of ``x`` [N, D] → f32 centroids [k, D].

    Seeding (unless ``init`` gives the initial centroids): k-means++ at
    k ≤ 4096, else a random permutation of the points.  The assignment
    logits are blocked over ``block_points`` points, so at colbert-ai's
    centroid counts no [N, k] matrix exists at once."""
    x = x.to(torch.float32)
    n, d = x.shape
    if init is not None:
        centroids = init.to(device=x.device, dtype=torch.float32).clone()
    else:
        rng = np.random.default_rng(seed)
        if k <= KMEANSPP_MAX_K:
            centroids = _kmeanspp_init(x, k, rng)
        else:
            centroids = x[torch.as_tensor(rng.permutation(n)[:k], device=x.device)]
    blk = min(block_points, n)
    for _ in range(iters):
        c_half = 0.5 * (centroids * centroids).sum(-1)
        sums = torch.zeros_like(centroids)
        counts = torch.zeros(k, dtype=torch.float32, device=x.device)
        dists = torch.empty(n, dtype=torch.float32, device=x.device)
        for s in range(0, n, blk):
            xb = x[s : s + blk]
            logits = xb @ centroids.T - c_half
            a = torch.argmax(logits, dim=-1)
            sums.index_add_(0, a, xb)
            counts += torch.bincount(a, minlength=k).to(torch.float32)
            best = torch.gather(logits, 1, a[:, None])[:, 0]
            dists[s : s + blk] = (xb * xb).sum(-1) - 2.0 * best
        new = torch.where(counts[:, None] > 0, sums / counts.clamp_min(1.0)[:, None], centroids)
        # re-seed empty clusters with the points farthest from their centroid
        far_order = torch.argsort(-dists, stable=True)
        empty = counts == 0
        slot = (torch.cumsum(empty, 0) - 1).clamp(0, n - 1)
        centroids = torch.where(empty[:, None], x[far_order[slot]], new)
    return centroids


def assign_centroids(
    x: torch.Tensor, centroids: torch.Tensor, block_points: int = 16384
) -> torch.Tensor:
    """Nearest-centroid ids (int32), blocked over points: argmax of
    ``x·c − ‖c‖²/2`` (the lower id on ties)."""
    x = x.to(torch.float32)
    c_half = 0.5 * (centroids * centroids).sum(-1)
    out = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    for s in range(0, x.shape[0], block_points):
        out[s : s + block_points] = torch.argmax(x[s : s + block_points] @ centroids.T - c_half, dim=-1)
    return out


# ----------------------------------------------------------------------
# residual codec
# ----------------------------------------------------------------------
def _pack_codes(codes, nbits: int):
    """[..., D] small ints → [..., D·nbits/8] uint8, PLANAR layout: byte i
    carries dim ``j·(D/p) + i`` at bit ``j·nbits``.  Takes a numpy array or a
    tensor and returns the same kind."""
    per_byte = 8 // nbits
    d = codes.shape[-1]
    plane = d // per_byte
    if isinstance(codes, torch.Tensor):
        flat = codes.reshape(-1, d).to(torch.uint8)
        packed = torch.zeros((flat.shape[0], plane), dtype=torch.uint8, device=codes.device)
    else:
        flat = codes.reshape(-1, d).astype(np.uint8)
        packed = np.zeros((flat.shape[0], plane), dtype=np.uint8)
    for j in range(per_byte):
        packed |= flat[:, j * plane : (j + 1) * plane] << (j * nbits)
    return packed.reshape(*codes.shape[:-1], plane)


def _unpack_codes(packed: torch.Tensor, nbits: int, d: int) -> torch.Tensor:
    """uint8 [..., D·nbits/8] → int32 codes [..., D] (planar)."""
    mask = (1 << nbits) - 1
    parts = [((packed >> (j * nbits)) & mask).to(torch.int32) for j in range(8 // nbits)]
    return torch.cat(parts, dim=-1)


def _rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for int32 ids of any shape (one flat row gather)."""
    return torch.index_select(table, 0, ids.reshape(-1)).reshape(*ids.shape, *table.shape[1:])


@dataclasses.dataclass
class CompressedTokenIndex:
    centroids: torch.Tensor  # [C, D] f32
    centroid_ids: torch.Tensor  # [N, Ld] int32
    codes: torch.Tensor  # [N, Ld, D·nbits/8] uint8
    mask: torch.Tensor  # [N, Ld] (f32 from a build; u8 accepted)
    bucket_weights: torch.Tensor  # [2^nbits] f32 (reconstruction values)
    nbits: int
    _prepared: tuple | None = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def num_docs(self) -> int:
        return self.centroid_ids.shape[0]

    @property
    def dim(self) -> int:
        return self.centroids.shape[-1]

    def save(self, path: str) -> None:
        """``compressed_index.npz`` in the JAX package's format: centroids as
        f16 (so a reloaded index's centroids are the f16 rounding of the
        built ones), the mask as int8, the codes as u8."""
        os.makedirs(path, exist_ok=True)
        np.savez_compressed(
            os.path.join(path, "compressed_index.npz"),
            centroids=self.centroids.to(torch.float16).cpu().numpy(),
            centroid_ids=self.centroid_ids.cpu().numpy(),
            codes=self.codes.cpu().numpy(),
            mask=self.mask.to(torch.int8).cpu().numpy(),
            bucket_weights=self.bucket_weights.cpu().numpy(),
            nbits=np.array([self.nbits]),
        )

    @classmethod
    def load(cls, path: str, *, device="cuda") -> "CompressedTokenIndex":
        """An index written by either package, on ``device``.  The JAX
        package's segmented codes form (``dma_form``) has no counterpart:
        the port's gather kernel reads the u8 codes directly."""
        device = torch.device(device)
        with np.load(os.path.join(path, "compressed_index.npz")) as z:
            return cls(
                centroids=torch.as_tensor(z["centroids"].astype(np.float32), device=device),
                centroid_ids=torch.as_tensor(z["centroid_ids"], device=device),
                codes=torch.as_tensor(z["codes"], device=device),
                mask=torch.as_tensor(z["mask"].astype(np.float32), device=device),
                bucket_weights=torch.as_tensor(z["bucket_weights"], device=device),
                nbits=int(z["nbits"][0]),
            )

    def to(self, device) -> "CompressedTokenIndex":
        """A copy of the index on ``device`` (the search layout is rebuilt)."""
        return dataclasses.replace(
            self, centroids=self.centroids.to(device), centroid_ids=self.centroid_ids.to(device),
            codes=self.codes.to(device), mask=self.mask.to(device),
            bucket_weights=self.bucket_weights.to(device), _prepared=None,
        )

    def prepared(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """Search layout, cached: ``(centroid_ids_tm [Ld, N] int32, codes_tm
        [Ld, N, D·nbits/8] u8, mask_tm [Ld, N], doc_valid [N] bool)``, so the
        exhaustive search decompresses token-major blocks directly.  PLAID
        never reads it."""
        if self._prepared is None:
            self._prepared = (
                self.centroid_ids.T.contiguous(),
                self.codes.transpose(0, 1).contiguous(),
                self.mask.T.contiguous(),
                self.mask.amax(dim=1) > 0,
            )
        return self._prepared

    def decompress(self, doc_slice: torch.Tensor, code_slice: torch.Tensor, use_onehot: bool = False) -> torch.Tensor:
        """(centroid ids [..., Ld], packed codes [..., Ld, D/p]) → bf16 tokens
        [..., Ld, D]: the bf16 centroid plus the bf16 bucket weight of each
        code, rounded once to bf16.  ``use_onehot`` (JAX's TPU lookup as a
        matmul) is checked and dropped."""
        if not isinstance(use_onehot, bool):
            raise ValueError(f"use_onehot must be a bool, got {use_onehot!r}")
        base = _rows(self.centroids.to(torch.bfloat16), doc_slice)
        residual = _rows(
            self.bucket_weights.to(torch.bfloat16), _unpack_codes(code_slice, self.nbits, self.dim)
        )
        return base + residual

    def decompress_tm(
        self, cid_tm: torch.Tensor, codes_tm: torch.Tensor, mask_tm: torch.Tensor
    ) -> torch.Tensor:
        """Token-major block decompress: (centroid ids [Ld, B], codes
        [Ld, B, D/p], mask [Ld, B]) → bf16 tokens [Ld, B, D] with masked
        tokens zeroed, the layout the MaxSim kernel takes."""
        return self.decompress(cid_tm, codes_tm) * mask_tm[..., None].to(torch.bfloat16)

    def nbytes(self) -> int:
        return sum(
            t.nbytes for t in (self.centroids, self.centroid_ids, self.codes, self.bucket_weights)
        )


def _quantile_cutoffs(vals: torch.Tensor, levels: int) -> np.ndarray:
    """The ``levels - 1`` inner quantiles of ``vals`` (f32, 1-D) as float64,
    by numpy's default ('linear') rule on the sorted values: the same
    arithmetic as ``np.quantile``, with the sort on ``vals``' device."""
    q = np.linspace(0, 1, levels + 1)[1:-1]
    n = vals.numel()
    virtual = n * q + (1 + q * (1 - 1 - 1)) - 1  # numpy's virtual index, alpha = beta = 1
    lo = np.clip(np.floor(virtual), 0, n - 1).astype(np.int64)
    hi = np.minimum(lo + 1, n - 1)
    gamma = virtual - lo
    ends = torch.as_tensor(np.concatenate([lo, hi]), device=vals.device)
    picked = torch.sort(vals).values[ends].cpu().numpy()
    a, b = picked[: len(q)], picked[len(q) :]
    diff = np.subtract(b, a)  # f32, as numpy's _lerp
    return np.where(gamma >= 0.5, b - diff * (1 - gamma), a + diff * gamma)


def _bucketize(x: torch.Tensor, cutoffs: np.ndarray) -> torch.Tensor:
    """``np.searchsorted(cutoffs, x)`` for f32 ``x`` and float64 cutoffs, as
    uint8 codes: each cutoff is rounded DOWN to f32, so ``x > c32`` holds
    exactly when ``x > c`` does."""
    c32 = cutoffs.astype(np.float32)
    c32 = np.where(c32 > cutoffs, np.nextafter(c32, np.float32(-np.inf)), c32)
    codes = torch.zeros(x.shape, dtype=torch.uint8, device=x.device)
    for c in c32:
        codes += (x > float(c)).to(torch.uint8)
    return codes


def compress_token_index(
    tokens: torch.Tensor,  # [N, Ld, D] (normalized token embeddings)
    mask: torch.Tensor,  # [N, Ld]
    num_centroids: int | None = None,
    nbits: int = 2,
    kmeans_iters: int = 4,
    sample_size: int = 262_144,
    seed: int = 0,
    *,
    timings: dict | None = None,
) -> CompressedTokenIndex:
    """Build the residual-compressed index on ``tokens``' device.

    ``num_centroids`` defaults to colbert-ai's 16·sqrt(#tokens) rounded up to
    a power of two.  ``timings``, when given, receives the seconds spent in
    k-means and in compression."""
    if 8 % nbits:
        raise ValueError(f"nbits must divide 8, got {nbits}")
    n, ld, d = tokens.shape
    device = tokens.device
    flat = tokens.reshape(-1, d).to(torch.float32)
    valid_np = mask.reshape(-1).cpu().numpy() > 0
    valid_idx = np.nonzero(valid_np)[0]
    n_tokens = max(len(valid_idx), 1)

    t0 = time.perf_counter()
    if num_centroids is None:
        num_centroids = int(2 ** np.ceil(np.log2(max(16 * np.sqrt(n_tokens), 2))))
    # k-means yields at most as many centroids as sample rows
    num_centroids = min(num_centroids, n_tokens, sample_size)
    rng = np.random.default_rng(seed)
    sample_idx = rng.choice(valid_idx, size=min(sample_size, n_tokens), replace=False)
    sample = flat[torch.as_tensor(sample_idx, device=device)]
    centroids = kmeans(sample, k=num_centroids, iters=kmeans_iters, seed=seed)
    _sync(device)
    t1 = time.perf_counter()

    assign = assign_centroids(flat, centroids)
    residuals = flat - _rows(centroids, assign)
    # global quantile cutoffs over the valid residual values (colbert-ai:
    # 2^nbits buckets, reconstruction value = the bucket's mean)
    levels = 1 << nbits
    valid = torch.as_tensor(valid_np, device=device)
    vals = residuals[valid].reshape(-1)
    if vals.numel() == 0:
        vals = torch.zeros(1, device=device)
    codes = _bucketize(residuals, _quantile_cutoffs(vals, levels))
    # bucket means over VALID rows only (pad-slot residuals ≈ -centroid would
    # bias the extreme buckets)
    valid_codes = codes[valid].reshape(-1)
    weights = []
    for b in range(levels):
        sel = valid_codes == b
        count = int(sel.sum())
        total = torch.where(sel, vals, 0.0).sum(dtype=torch.float64)
        weights.append(float(total) / count if count else 0.0)
    index = CompressedTokenIndex(
        centroids=centroids,
        centroid_ids=assign.reshape(n, ld),
        codes=_pack_codes(codes.reshape(n, ld, d), nbits),
        mask=mask.to(device=device, dtype=torch.float32),
        bucket_weights=torch.tensor(weights, dtype=torch.float32, device=device),
        nbits=nbits,
    )
    _sync(device)
    if timings is not None:
        timings["kmeans"] = t1 - t0
        timings["compress"] = time.perf_counter() - t1
    return index


# ----------------------------------------------------------------------
# search over the compressed index
# ----------------------------------------------------------------------
def maxsim_search_compressed(
    q_tokens: torch.Tensor,
    q_mask: torch.Tensor,
    index: CompressedTokenIndex,
    k: int = 1000,
    doc_block: int = 8192,
) -> RankedLists:
    """Exhaustive MaxSim with block decompression: per ``doc_block`` docs, a
    token-major bf16 [Ld, B, D] block (masked tokens zeroed) is rebuilt from
    centroid ids and codes and scored through ``maxsim_scores_tm`` (the
    MaxSim kernel on the card, with bf16 queries; f32 queries on the CPU, as
    the JAX package's CPU path keeps them); invalid docs score -inf.  Only one
    decompressed block exists at a time."""
    cid_tm, codes_tm, mask_tm, doc_valid = index.prepared()
    n = cid_tm.shape[1]
    doc_block = min(doc_block, n)
    q_b = q_tokens.to(torch.bfloat16 if cid_tm.is_cuda else torch.float32)
    q_m = q_mask.to(torch.float32)
    offsets = torch.arange(doc_block, device=cid_tm.device)

    def block_scores(bi: int):
        start = bi * doc_block
        real_start = min(start, n - doc_block)
        blk = slice(real_start, real_start + doc_block)
        d_blk = index.decompress_tm(cid_tm[:, blk], codes_tm[:, blk], mask_tm[:, blk])
        scores = maxsim_scores_tm(q_b, q_m, d_blk)
        fresh = (real_start + offsets >= start) & doc_valid[blk]
        return torch.where(fresh[None, :], scores, -torch.inf), real_start

    return blockwise_topk_offset(block_scores, -(-n // doc_block), q_tokens.shape[0], min(k, n))
