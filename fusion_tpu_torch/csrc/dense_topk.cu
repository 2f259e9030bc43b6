// Fused int8-corpus matmul + 16-doc binned max on Hopper (sm_90a): the DPR
// leg of scale mode, and its no-mask variant.
//
// Replaces the TPU kernels fusion_tpu/ops/dense_topk.py::_binmax_kernel
// (driven there by _fused_search and fused_dense_topk; kDeadRows = true) and
// scripts/probe_dense.py::_binmax_nomask (the same body without the dead-row
// term; kDeadRows = false), at doc blocks of 2048, 4096 and 8192 docs.
//
// For bf16 queries q[Q, H], int8 corpus rows v[N_pad, H] with f32 row scales
// s[N_pad] and a real row count n_docs, doc block b of D docs (lanes = D/16)
// gives
//
//     score[q, d] = (sum_h q[q, h] * v[d, h]) * s[d]   (+ -3e38 where s[d] <= 0
//                                                        and kDeadRows)
//     score[q, d] = -inf                                where d >= n_docs
//     out[q, b*lanes + l] = max_{s < 16} score[q, b*D + s*lanes + l]
//
// with a strict '>' over s (ties keep the lowest s) and s packed into the 4
// low mantissa bits of the maximum; a -inf maximum stays -inf.  Without the
// dead-row term a pad row of scale 0 scores exactly +-0.0 and can win its bin
// over real docs of negative similarity: that is the variant's semantics,
// kept here; the n_docs mask stays.  Products are bf16 x bf16 on the tensor
// cores with f32 accumulation; int8 -> bf16 is exact (|v| <= 127).  The
// queries are not quantized: an int8 product would be a different score.
//
// What bounds it: at the mMARCO serving shape (Q 64, H 768, N 8,912,896) one
// call reads 6.85 GB of int8 rows (~2 ms at 3.35 TB/s) for 0.88 TFLOP
// (~0.9 ms at the bf16 dense peak): memory-bound, so every row is read once.
//
// Design: one block owns a 64-query tile and 128 bins of one doc block (a
// doc block of D docs spans D/2048 blocks), so with Q <= 64 the corpus is
// read exactly once, whatever D.  The block's 16 strided sub-tiles are rows
// b*D + s*(D/16) + lane0 + [0, 128); its output bins are 128 consecutive
// columns, blockIdx.x*128 + [0, 128), for every D.  The query tile stays in
// shared memory for the whole block.  The block walks its sub-tiles; for
// each it stages the rows in 128-deep chunks, converting int8 -> bf16 on the
// way into shared memory, with the next chunk's global loads issued before
// the current chunk's products (register prefetch).  Eight warps each take a
// 32 x 32 quadrant of the 64 x 128 score tile as 2 x 2 wmma 16x16x16
// products.  The finished tile goes through shared memory once per
// sub-tile, where each thread owns one doc lane (one scale, one pad test)
// and 32 queries, and keeps their running max and offset in registers
// across the 16 sub-tiles; the packed maxima are written once.  The full
// 64 x D f32 score tile never exists.  wgmma/TMA and a deeper pipeline are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kBin = 16;                   // sub-tiles per block = docs per bin
constexpr int kLanes = 128;                // docs per sub-tile = bins per block
constexpr int kMinDocBlock = kBin * kLanes;  // 2048: one thread block per doc block
constexpr int kTileQ = 64;                 // queries per block
constexpr int kKC = 128;                   // depth of one staged chunk
constexpr int kWarps = 8;                  // 2 (queries) x 4 (docs), 32 x 32 each
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;                    // bf16 row padding against bank conflicts
constexpr int kDRow = kKC + kPad;          // staged corpus row, bf16 elements
constexpr int kOutLd = kLanes + 4;         // f32 row of the score staging tile
constexpr int kVecPerThread = kLanes * (kKC / 16) / kThreads;  // 16-byte int8 loads
constexpr int kQPerThread = kTileQ * kLanes / kThreads;        // 32 (q, lane) pairs
constexpr float kDead = -3.0e38f;

static_assert(kVecPerThread * kThreads == kLanes * (kKC / 16), "staging split");
static_assert(kThreads % kLanes == 0, "one lane per thread");

// 16 int8 values -> 16 bf16 values (exact), written as two 16-byte stores.
__device__ __forceinline__ void store_int8x16_as_bf16(const int4 v, __nv_bfloat16* dst) {
  const uint32_t w[4] = {(uint32_t)v.x, (uint32_t)v.y, (uint32_t)v.z, (uint32_t)v.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float lo = (float)(int8_t)(w[i] >> (16 * j));
      const float hi = (float)(int8_t)(w[i] >> (16 * j + 8));
      const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
      o[2 * i + j] = *reinterpret_cast<const uint32_t*>(&p);
    }
  }
  reinterpret_cast<uint4*>(dst)[0] = make_uint4(o[0], o[1], o[2], o[3]);
  reinterpret_cast<uint4*>(dst)[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

// kDocBlock docs per bin block (2048, 4096 or 8192); kDeadRows adds the
// dead-row term of _binmax_kernel.  Grid: (N_pad / 2048, ceil(nq / 64)).
template <int kDocBlock, bool kDeadRows>
__global__ void __launch_bounds__(kThreads)
dense_binmax_kernel(const __nv_bfloat16* __restrict__ q,  // [nq, h]
                    const int8_t* __restrict__ v,         // [gridDim.x * 2048, h]
                    const float* __restrict__ scales,     // [gridDim.x * 2048]
                    float* __restrict__ out,              // [nq, gridDim.x * 128]
                    int nq, int h, long long n_docs) {
  static_assert(kDocBlock % kMinDocBlock == 0, "doc block: a multiple of 2048");
  constexpr int kStride = kDocBlock / kBin;          // docs between sub-tiles
  constexpr int kGroups = kDocBlock / kMinDocBlock;  // thread blocks per doc block
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int qrow = h + kPad;
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][qrow]
  __nv_bfloat16* d_s = q_s + kTileQ * qrow;                         // [128][kDRow]
  float* o_s = reinterpret_cast<float*>(d_s + kLanes * kDRow);       // [64][kOutLd]

  const int blk = blockIdx.x;
  const int q0 = blockIdx.y * kTileQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wq = (warp / 4) * 32;  // this warp's query offset in the tile
  const int wd = (warp % 4) * 32;  // this warp's doc offset in the sub-tile
  const long long row0 = (long long)(blk / kGroups) * kDocBlock + (blk % kGroups) * kLanes;

  // the query tile, once; rows past nq are zero and their outputs dropped
  const int qvecs = h / 8;
  for (int i = tid; i < kTileQ * qvecs; i += kThreads) {
    const int r = i / qvecs, c = (i % qvecs) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < nq) x = *reinterpret_cast<const uint4*>(q + (size_t)(q0 + r) * h + c);
    *reinterpret_cast<uint4*>(q_s + r * qrow + c) = x;
  }

  const int nkc = (h + kKC - 1) / kKC;
  const int steps = kBin * nkc;
  int4 pre[kVecPerThread];
  // global loads of step t (sub-tile t / nkc, depth chunk t % nkc) into pre
  auto prefetch = [&](int t) {
    const int s = t / nkc, k0 = (t % nkc) * kKC;
    const int klen = min(kKC, h - k0);
    const int kv = klen / 16;
#pragma unroll
    for (int i = 0; i < kVecPerThread; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / (kKC / 16), c = e % (kKC / 16);
      pre[i] = make_int4(0, 0, 0, 0);
      if (c < kv)
        pre[i] = *reinterpret_cast<const int4*>(
            v + (size_t)(row0 + (long long)s * kStride + r) * h + k0 + c * 16);
    }
  };

  // this thread's epilogue slice: one doc lane, queries (tid / 128) + 2i
  const int lane = tid % kLanes;
  const int qsub = tid / kLanes;
  float best[kQPerThread];
  int off[kQPerThread];
#pragma unroll
  for (int i = 0; i < kQPerThread; ++i) {
    best[i] = -INFINITY;
    off[i] = 0;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  prefetch(0);
  for (int t = 0; t < steps; ++t) {
    const int s = t / nkc, kc = t % nkc;
    const int klen = min(kKC, h - kc * kKC);
    __syncthreads();  // the previous chunk is consumed (t = 0: q_s is staged)
#pragma unroll
    for (int i = 0; i < kVecPerThread; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / (kKC / 16), c = e % (kKC / 16);
      store_int8x16_as_bf16(pre[i], d_s + r * kDRow + c * 16);
    }
    __syncthreads();
    if (t + 1 < steps) prefetch(t + 1);  // in flight during the products below

    if (kc == 0)
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    for (int k = 0; k < klen; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b[2];
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], q_s + (wq + 16 * i) * qrow + kc * kKC + k, qrow);
      // B[k][d] = row d of the staged chunk: a column-major KC x 128 matrix
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], d_s + (wd + 16 * j) * kDRow + k, kDRow);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    if (kc != nkc - 1) continue;

    // sub-tile s is complete: scale, mask, and fold into the running maxima
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(o_s + (wq + 16 * i) * kOutLd + wd + 16 * j, acc[i][j], kOutLd,
                                wmma::mem_row_major);
    __syncthreads();
    const long long doc = row0 + (long long)s * kStride + lane;
    const float sc = scales[doc];
    const float dead = sc <= 0.0f ? kDead : -0.0f;  // -0.0: x + -0.0 == x, sign of zero kept
    const bool valid = doc < n_docs;
#pragma unroll
    for (int i = 0; i < kQPerThread; ++i) {
      const float raw = o_s[(qsub + 2 * i) * kOutLd + lane];
      const float scaled = __fmul_rn(raw, sc);
      const float score = !valid ? -INFINITY : kDeadRows ? __fadd_rn(scaled, dead) : scaled;
      if (score > best[i]) {
        best[i] = score;
        off[i] = s;
      }
    }
  }

  const long long out_ld = (long long)gridDim.x * kLanes;
#pragma unroll
  for (int i = 0; i < kQPerThread; ++i) {
    const int qi = q0 + qsub + 2 * i;
    if (qi >= nq) continue;
    float packed = -INFINITY;
    if (isfinite(best[i]))
      packed = __uint_as_float((__float_as_uint(best[i]) & 0xFFFFFFF0u) | (unsigned)off[i]);
    out[qi * out_ld + (long long)blk * kLanes + lane] = packed;
  }
}

template <int kDocBlock, bool kDeadRows>
cudaError_t launch(const void* q, const void* v, const void* scales, void* out, int nq, int h,
                   int ntiles, long long n_docs, size_t smem, cudaStream_t stream) {
  auto kernel = dense_binmax_kernel<kDocBlock, kDeadRows>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(ntiles, (nq + kTileQ - 1) / kTileQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(v),
      static_cast<const float*>(scales), static_cast<float*>(out), nq, h, n_docs);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// q: [nq, h] bf16; v: [nblocks * doc_block, h] int8 with 16-byte aligned
// rows; scales: [nblocks * doc_block] f32; out: [nq, nblocks * doc_block / 16]
// f32; all contiguous.  doc_block is 2048, 4096 or 8192; dead_rows != 0 adds
// the dead-row term (K2), 0 leaves it out (the no-mask variant).  Requires
// h % 16 == 0, 16 <= h <= 1024, nq >= 1, nblocks >= 1.
extern "C" int dense_binmax(const void* q, const void* v, const void* scales, void* out, int nq,
                            int h, int nblocks, int doc_block, int dead_rows, long long n_docs,
                            void* stream) {
  if (h % 16 != 0 || h < 16 || h > 1024 || nq < 1 || nblocks < 1 ||
      (nq + kTileQ - 1) / kTileQ > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kTileQ * (h + kPad) * sizeof(__nv_bfloat16) +
                      (size_t)kLanes * kDRow * sizeof(__nv_bfloat16) +
                      (size_t)kTileQ * kOutLd * sizeof(float);
  const long long ntiles = (long long)nblocks * (doc_block / kMinDocBlock);
  if (ntiles > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int t = (int)ntiles;
  cudaError_t err;
  switch (doc_block * 2 + (dead_rows ? 1 : 0)) {
    case 2048 * 2 + 1: err = launch<2048, true>(q, v, scales, out, nq, h, t, n_docs, smem, s); break;
    case 2048 * 2: err = launch<2048, false>(q, v, scales, out, nq, h, t, n_docs, smem, s); break;
    case 4096 * 2 + 1: err = launch<4096, true>(q, v, scales, out, nq, h, t, n_docs, smem, s); break;
    case 4096 * 2: err = launch<4096, false>(q, v, scales, out, nq, h, t, n_docs, smem, s); break;
    case 8192 * 2 + 1: err = launch<8192, true>(q, v, scales, out, nq, h, t, n_docs, smem, s); break;
    case 8192 * 2: err = launch<8192, false>(q, v, scales, out, nq, h, t, n_docs, smem, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" const char* dense_binmax_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
