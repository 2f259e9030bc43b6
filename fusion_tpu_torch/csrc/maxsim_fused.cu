// Fused MaxSim scores on Hopper (sm_90a): the Ld running max and the
// query-mask sum in one kernel, so the [QL, N] maxima never reach device
// memory.
//
// Replaces these TPU kernels:
//   * K1-v1 fusion_tpu/ops/maxsim.py::_maxsim_kernel (driven by
//     maxsim_scores_pallas): strict masking -- sims of masked doc tokens are
//     -1e9 and the running max starts at -1e9, so a fully masked doc scores
//     -1e9 times its query's mask sum;
//   * scripts/bench_maxsim.py::_kernel_fusedsum: zeroed masking -- masked doc
//     tokens are already zero vectors and there is no doc mask.
//
// Computes
//
//     out[q, n] = sum_i qm[q, i] * max_{t < Ld} s(q*Lq + i, t, n),
//     s(j, t, n) = sum_d corpus[t, n, d] * qtok[j, d]   (strict: -1e9 where dm[t, n] <= 0)
//
// with bf16 tokens, f32 accumulation, an f32 running max and an f32 sum over
// each query's Lq tokens in ascending order (the TPU sums them as one
// [Q, QL] x [QL, B] product, in another order).  Padded query tokens have
// qm = 0 and add 0 * max, which is 0: every max is finite.
//
// What bounds it: at Q 32, Lq 32, N 28,032, Ld 128, D 128 one call is
// 2*Q*Lq*N*Ld*D ~ 0.94 TFLOP against ~0.92 GB of corpus, 14 MB of mask read
// and 3.6 MB of scores written: compute-bound, on the tensor cores.
//
// Design: as the maxima kernel (csrc/maxsim.cu), one block owns a 64-doc x
// kTileQ-query-token tile and walks the Ld doc tokens, the products as 16x16x16
// bf16 wmma, the running max in accumulator registers.  The tile holds WHOLE
// queries -- floor(kTileQ / Lq) of them, kTileQ = 64 for Lq <= 64 and 128 for
// Lq <= 128 -- so the block owns every token it sums and no sum crosses
// blocks; rows past the last whole query are zero and never summed.  For the
// strict mask the block stages the token's 64 mask values beside the doc tile
// (read once per token per doc tile) and needs each accumulator element's
// doc: wmma leaves the element-to-row mapping unspecified, so the kernel
// learns it at start by loading a tile of row numbers into a fragment of the
// same type.  At the end the tile goes through shared memory and each thread
// sums one (doc, query) pair.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int kTileN = 64;  // docs per block
constexpr int kPad = 8;     // bf16 row padding (16 bytes) against bank conflicts
constexpr float kNeg = -1e9f;
using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

template <int kTileQ>
size_t smem_bytes(int d) {
  return (size_t)(kTileQ + kTileN) * (d + kPad) * sizeof(__nv_bfloat16) +
         (size_t)kTileN * (kTileQ + 4) * sizeof(float) + kTileN * sizeof(float);
}

template <int kTileQ, bool kStrict>
__global__ void __launch_bounds__(kTileQ * 2)
maxsim_fused_kernel(const __nv_bfloat16* __restrict__ corpus,  // [Ld, N, D] contiguous
                    const __nv_bfloat16* __restrict__ q,       // [nq * lq, D] contiguous
                    const float* __restrict__ qmask,           // [nq, lq] contiguous
                    const float* __restrict__ dmask,           // [Ld, N] contiguous (strict)
                    float* __restrict__ out,                   // [nq, N] contiguous
                    int ld, int n, int d, int nq, int lq, int qpb) {
  constexpr int kWarpsQ = kTileQ / 32;  // warps along the query tokens; 2 along the docs
  constexpr int kThreads = kTileQ * 2;
  constexpr int kOutLd = kTileQ + 4;
  __shared__ __align__(32) float idx_s[16 * 16];  // wmma pointers are 256-bit aligned
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int row = d + kPad;
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* d_s = q_s + kTileQ * row;
  float* o_s = reinterpret_cast<float*>(d_s + kTileN * row);
  float* m_s = o_s + kTileN * kOutLd;

  const int g = blockIdx.x;  // query group: queries g*qpb .. g*qpb + qpb - 1
  const int n0 = blockIdx.y * kTileN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wn = (warp / kWarpsQ) * 32;  // this warp's doc offset in the tile
  const int wq = (warp % kWarpsQ) * 32;  // this warp's query-token offset in the tile
  const int vecs = d / 8;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const int q_used = min(qpb, nq - g * qpb);  // whole queries in this tile
  const int rows = q_used * lq;
  const size_t row0 = (size_t)g * qpb * lq;

  for (int i = tid; i < kTileQ * vecs; i += kThreads) {
    const int r = i / vecs, c = (i % vecs) * 8;
    uint4 v = zero;
    if (r < rows) v = *reinterpret_cast<const uint4*>(q + (row0 + r) * d + c);
    *reinterpret_cast<uint4*>(q_s + r * row + c) = v;
  }
  // each accumulator element's row within its 16x16 fragment
  for (int i = tid; i < 16 * 16; i += kThreads) idx_s[i] = (float)(i / 16);
  __syncthreads();
  int elem_row[Acc::num_elements];
  {
    Acc rows_frag;
    wmma::load_matrix_sync(rows_frag, idx_s, 16, wmma::mem_row_major);
    for (int e = 0; e < Acc::num_elements; ++e) elem_row[e] = (int)rows_frag.x[e];
  }

  Acc best[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(best[i][j], kStrict ? kNeg : -INFINITY);

  for (int t = 0; t < ld; ++t) {
    __syncthreads();  // the previous token's tile is consumed
    const __nv_bfloat16* src = corpus + (size_t)t * n * d;
    for (int i = tid; i < kTileN * vecs; i += kThreads) {
      const int r = i / vecs, c = (i % vecs) * 8;
      uint4 v = zero;
      if (n0 + r < n) v = *reinterpret_cast<const uint4*>(src + (size_t)(n0 + r) * d + c);
      *reinterpret_cast<uint4*>(d_s + r * row + c) = v;
    }
    if (kStrict)
      for (int i = tid; i < kTileN; i += kThreads)
        m_s[i] = n0 + i < n ? dmask[(size_t)t * n + n0 + i] : 1.0f;
    __syncthreads();

    Acc acc[2][2];
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    for (int k = 0; k < d; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b[2];
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], d_s + (wn + 16 * i) * row + k, row);
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], q_s + (wq + 16 * j) * row + k, row);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    for (int i = 0; i < 2; ++i)
      for (int e = 0; e < Acc::num_elements; ++e) {
        // the element's doc is row wn + 16 i + elem_row[e] of the tile
        const bool masked = kStrict && m_s[wn + 16 * i + elem_row[e]] <= 0.0f;
        for (int j = 0; j < 2; ++j)
          best[i][j].x[e] = fmaxf(best[i][j].x[e], masked ? kNeg : acc[i][j].x[e]);
      }
  }

  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(o_s + (wn + 16 * i) * kOutLd + wq + 16 * j, best[i][j], kOutLd,
                              wmma::mem_row_major);
  __syncthreads();
  // neighbouring threads take neighbouring docs of one query: coalesced stores
  for (int p = tid; p < kTileN * q_used; p += kThreads) {
    const int r = p % kTileN, qq = p / kTileN;
    if (n0 + r >= n) continue;
    const int gq = g * qpb + qq;
    const float* m = o_s + r * kOutLd + qq * lq;
    const float* w = qmask + (size_t)gq * lq;
    float s = 0.0f;
    for (int i = 0; i < lq; ++i) s = fmaf(w[i], m[i], s);
    out[(size_t)gq * n + n0 + r] = s;
  }
}

template <int kTileQ, bool kStrict>
int launch(const void* corpus, const void* q, const void* qmask, const void* dmask, void* out,
           int ld, int n, int d, int nq, int lq, cudaStream_t stream) {
  const size_t smem = smem_bytes<kTileQ>(d);
  auto kernel = maxsim_fused_kernel<kTileQ, kStrict>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int qpb = kTileQ / lq;
  const dim3 grid((nq + qpb - 1) / qpb, (n + kTileN - 1) / kTileN);
  kernel<<<grid, kTileQ * 2, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(corpus), static_cast<const __nv_bfloat16*>(q),
      static_cast<const float*>(qmask), static_cast<const float*>(dmask), static_cast<float*>(out),
      ld, n, d, nq, lq, qpb);
  return (int)cudaGetLastError();
}

template <int kTileQ>
int launch_mode(const void* corpus, const void* q, const void* qmask, const void* dmask, void* out,
                int ld, int n, int d, int nq, int lq, cudaStream_t stream) {
  if (dmask != nullptr)
    return launch<kTileQ, true>(corpus, q, qmask, dmask, out, ld, n, d, nq, lq, stream);
  return launch<kTileQ, false>(corpus, q, qmask, dmask, out, ld, n, d, nq, lq, stream);
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// corpus: [ld, n, d] bf16 contiguous; q: [nq * lq, d] bf16 contiguous;
// qmask: [nq, lq] f32 contiguous; dmask: [ld, n] f32 contiguous for the strict
// mask, or null for zeroed tokens; out: [nq, n] f32 contiguous.  Requires
// d % 16 == 0, 16 <= d <= 256, 1 <= lq <= 128, n >= 1, nq >= 1, ld >= 1.
extern "C" int maxsim_fused(const void* corpus, const void* q, const void* qmask,
                            const void* dmask, void* out, int ld, int n, int d, int nq, int lq,
                            void* stream) {
  if (d % 16 != 0 || d < 16 || d > 256 || lq < 1 || lq > 128 || n < 1 || nq < 1 || ld < 1 ||
      (n + kTileN - 1) / kTileN > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lq <= 64) return launch_mode<64>(corpus, q, qmask, dmask, out, ld, n, d, nq, lq, s);
  return launch_mode<128>(corpus, q, qmask, dmask, out, ld, n, d, nq, lq, s);
}

extern "C" const char* maxsim_fused_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
