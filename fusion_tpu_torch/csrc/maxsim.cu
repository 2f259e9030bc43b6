// MaxSim token maxima on Hopper (sm_90a): the ColBERT late-interaction core.
//
// Replaces the TPU kernel fusion_tpu/ops/maxsim.py::_maxsim_kernel_T (driven
// there by _maxima_T_pallas and maxsim_scores_pallas_v2_tm).
//
// Computes, for a token-major corpus whose masked tokens are zero vectors,
//
//     out[n, j] = max_{t < Ld} sum_d corpus[t, n, d] * q[j, d]
//
// with bf16 inputs, f32 accumulation and an f32 running max.  The caller
// applies the query-mask sum and demotes invalid docs.
//
// What bounds it: at the serving shape (Ld 128, N 28,032, D 128, QL 2,048)
// one call is 2*QL*N*Ld*D ~ 1.9 TFLOP against ~0.9 GB of corpus read and
// 0.23 GB of maxima written, about 1,600 FLOP per byte -- far above the
// H100's ~295 bf16 FLOP/byte ridge, so the kernel is compute-bound and the
// products must run on the tensor cores.
//
// Design: one block owns a 64-doc x 64-query-token output tile.  It stages
// its query tile in shared memory once, then walks the Ld doc tokens; for
// each token t it stages corpus[t, n0:n0+64, :] (16 KB at D 128) and four
// warps each take a 32x32 quadrant as 2x2 16x16x16 bf16 wmma products with
// f32 accumulators.  The running max over t is element-wise between
// accumulator fragments of one type, which share one element mapping, so it
// stays in registers; the tile goes to device memory once, at the end.
// Blocks that share a doc tile are adjacent in launch order (query tiles on
// grid.x), so the corpus is read from device memory about once and from L2
// by the rest.  The kernel masks the ragged N and QL edges itself.
// wgmma, TMA and a fused query-mask sum / top-k are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int kTileN = 64;  // docs per block
constexpr int kTileQ = 64;  // query tokens per block
constexpr int kWarps = 4;   // 2 x 2 warps, each 32 docs x 32 query tokens
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;                // bf16 row padding (16 bytes) against bank conflicts
constexpr int kOutLd = kTileQ + 4;     // f32 row length of the output staging tile

__global__ void __launch_bounds__(kThreads)
maxsim_maxima_T_kernel(const __nv_bfloat16* __restrict__ corpus,  // [Ld, N, D], rows of D contiguous
                       const __nv_bfloat16* __restrict__ q,       // [QL, D] contiguous
                       float* __restrict__ out,                   // [N, QL] contiguous
                       int ld, int n, int d, long long stride_t, int ql) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int row = d + kPad;  // shared-memory row length, bf16 elements
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* d_s = q_s + kTileQ * row;
  float* o_s = reinterpret_cast<float*>(d_s + kTileN * row);

  const int q0 = blockIdx.x * kTileQ;
  const int n0 = blockIdx.y * kTileN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wn = (warp / 2) * 32;  // this warp's doc offset in the tile
  const int wq = (warp % 2) * 32;  // this warp's query-token offset in the tile
  const int vecs = d / 8;          // 16-byte vectors per row
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // query tile, once; rows past QL are zero and their outputs are dropped
  for (int i = tid; i < kTileQ * vecs; i += kThreads) {
    const int r = i / vecs, c = (i % vecs) * 8;
    uint4 v = zero;
    if (q0 + r < ql) v = *reinterpret_cast<const uint4*>(q + (size_t)(q0 + r) * d + c);
    *reinterpret_cast<uint4*>(q_s + r * row + c) = v;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> best[2][2];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(best[i][j], -INFINITY);

  for (int t = 0; t < ld; ++t) {
    __syncthreads();  // the previous token's tile is consumed (t = 0: q_s is staged)
    const __nv_bfloat16* src = corpus + (size_t)t * (size_t)stride_t;
    for (int i = tid; i < kTileN * vecs; i += kThreads) {
      const int r = i / vecs, c = (i % vecs) * 8;
      uint4 v = zero;
      if (n0 + r < n) v = *reinterpret_cast<const uint4*>(src + (size_t)(n0 + r) * d + c);
      *reinterpret_cast<uint4*>(d_s + r * row + c) = v;
    }
    __syncthreads();

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    for (int k = 0; k < d; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b[2];
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], d_s + (wn + 16 * i) * row + k, row);
      // B[k][j] = q[j][k]: the query rows read as a column-major D x QL matrix
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], q_s + (wq + 16 * j) * row + k, row);
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    for (int i = 0; i < 2; ++i)
      for (int j = 0; j < 2; ++j)
        for (int e = 0; e < acc[i][j].num_elements; ++e)
          best[i][j].x[e] = fmaxf(best[i][j].x[e], acc[i][j].x[e]);
  }

  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(o_s + (wn + 16 * i) * kOutLd + wq + 16 * j, best[i][j], kOutLd,
                              wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < kTileN * kTileQ; i += kThreads) {
    const int r = i / kTileQ, c = i % kTileQ;
    if (n0 + r < n && q0 + c < ql) out[(size_t)(n0 + r) * ql + q0 + c] = o_s[r * kOutLd + c];
  }
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// corpus: [ld, n, d] bf16 with rows of d contiguous and `stride_t` elements
// between tokens; q: [ql, d] bf16 contiguous; out: [n, ql] f32 contiguous.
// Requires d % 16 == 0, 16 <= d <= 256, n >= 1, ql >= 1, ld >= 1.
extern "C" int maxsim_maxima_T(const void* corpus, const void* q, void* out, int ld, int n,
                               int d, long long stride_t, int ql, void* stream) {
  if (d % 16 != 0 || d < 16 || d > 256 || n < 1 || ql < 1 || ld < 1 ||
      (n + kTileN - 1) / kTileN > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(kTileQ + kTileN) * (d + kPad) * sizeof(__nv_bfloat16) +
                      (size_t)kTileN * kOutLd * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(maxsim_maxima_T_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((ql + kTileQ - 1) / kTileQ, (n + kTileN - 1) / kTileN);
  maxsim_maxima_T_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(corpus), static_cast<const __nv_bfloat16*>(q),
      static_cast<float*>(out), ld, n, d, stride_t, ql);
  return (int)cudaGetLastError();
}

extern "C" const char* maxsim_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
