// MaxSim token maxima on Hopper (sm_90a): the ColBERT late-interaction core.
//
// Replaces these TPU kernels, which differ only in where the maxima go and in
// how the max is rounded:
//   * K1    fusion_tpu/ops/maxsim.py::_maxsim_kernel_T (driven by
//           _maxima_T_pallas): maxima stored doc-major, [N, QL];
//   * K1-v2 fusion_tpu/ops/maxsim.py::_maxsim_v2_kernel_3d (driven by
//           maxsim_token_maxima_pallas): the same maxima stored
//           query-token-major, [QL, N], reduced in bf16 on the TPU;
//   * the maxima variants of the MaxSim benches: scripts/bench_maxsim.py
//     _kernel_bf16max, _kernel_f32max and _kernel_chunked(tchunk), and
//     scripts/bench_maxsim2.py _kernel_bf16max, _kernel_dotgen and
//     _kernel_dotgen_bf16.
//
// Computes, for a token-major corpus whose masked tokens are zero vectors,
//
//     M[n, j] = max_{t < Ld} sum_d corpus[t, n, d] * q[j, d]
//
// with bf16 inputs, f32 accumulation and an f32 running max, and stores M
// doc-major ([N, QL], K1) or query-token-major ([QL, N], K1-v2), either as
// it is or rounded once to bf16 (round-to-nearest-even is monotone, so
// rounding the f32 max equals the max of the rounded sims, which is what the
// TPU's bf16 reduce computes).  The caller applies the query-mask sum and
// demotes invalid docs.
//
// What bounds it: at the serving shape (Ld 128, N 28,032, D 128, QL 2,048)
// one call is 2*QL*N*Ld*D ~ 1.9 TFLOP against ~0.9 GB of corpus read and
// 0.23 GB of maxima written, about 1,600 FLOP per byte -- far above the
// H100's ~295 bf16 FLOP/byte ridge, so the kernel is compute-bound and the
// products must run on the tensor cores.
//
// Design: one block owns a 64-doc x 64-query-token output tile.  It stages
// its query tile in shared memory once, then walks the Ld doc tokens
// `tchunk` at a time: it stages corpus[t0:t0+tchunk, n0:n0+64, :] (16 KB per
// token at D 128) between two barriers, and for each staged token four warps
// each take a 32x32 quadrant as 2x2 16x16x16 bf16 wmma products with f32
// accumulators.  The running max over t is element-wise between accumulator
// fragments of one type, which share one element mapping, so it stays in
// registers; the tile goes to device memory once, at the end, through a
// shared-memory staging tile that also turns it for the [QL, N] store.
// Blocks that share a doc tile are adjacent in launch order (query tiles on
// grid.x), so the corpus is read from device memory about once and from L2
// by the rest.  The kernel masks the ragged N and QL edges itself.  A larger
// `tchunk` halves the barriers per token at the cost of shared memory (and
// so of blocks per SM).  wgmma, TMA and a fused query-mask sum / top-k are
// later work.

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
constexpr size_t kMaxSmem = 232448;    // shared memory one block may use on Hopper

size_t smem_bytes(int d, int tchunk) {
  return (size_t)(kTileQ + (size_t)tchunk * kTileN) * (d + kPad) * sizeof(__nv_bfloat16) +
         (size_t)kTileN * kOutLd * sizeof(float);
}

template <bool kQueryMajor, bool kRoundBf16>
__global__ void __launch_bounds__(kThreads)
maxima_kernel(const __nv_bfloat16* __restrict__ corpus,  // [Ld, N, D], rows of D contiguous
              const __nv_bfloat16* __restrict__ q,       // [QL, D] contiguous
              float* __restrict__ out,                   // [N, QL] or [QL, N] contiguous
              int ld, int n, int d, long long stride_t, int ql, int tchunk) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int row = d + kPad;  // shared-memory row length, bf16 elements
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* d_s = q_s + kTileQ * row;  // tchunk tiles of kTileN rows
  float* o_s = reinterpret_cast<float*>(d_s + (size_t)tchunk * kTileN * row);

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

  for (int t0 = 0; t0 < ld; t0 += tchunk) {
    const int tc = min(tchunk, ld - t0);
    __syncthreads();  // the previous chunk is consumed (t0 = 0: q_s is staged)
    for (int tt = 0; tt < tc; ++tt) {
      const __nv_bfloat16* src = corpus + (size_t)(t0 + tt) * (size_t)stride_t;
      __nv_bfloat16* dst = d_s + (size_t)tt * kTileN * row;
      for (int i = tid; i < kTileN * vecs; i += kThreads) {
        const int r = i / vecs, c = (i % vecs) * 8;
        uint4 v = zero;
        if (n0 + r < n) v = *reinterpret_cast<const uint4*>(src + (size_t)(n0 + r) * d + c);
        *reinterpret_cast<uint4*>(dst + r * row + c) = v;
      }
    }
    __syncthreads();

    for (int tt = 0; tt < tc; ++tt) {
      const __nv_bfloat16* dt = d_s + (size_t)tt * kTileN * row;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
      for (int k = 0; k < d; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b[2];
        for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], dt + (wn + 16 * i) * row + k, row);
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
  }

  // o_s[r][c]: doc r, query token c (doc-major) or query token r, doc c
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) {
      if (kQueryMajor)
        wmma::store_matrix_sync(o_s + (wq + 16 * j) * kOutLd + wn + 16 * i, best[i][j], kOutLd,
                                wmma::mem_col_major);
      else
        wmma::store_matrix_sync(o_s + (wn + 16 * i) * kOutLd + wq + 16 * j, best[i][j], kOutLd,
                                wmma::mem_row_major);
    }
  __syncthreads();
  for (int i = tid; i < kTileN * kTileQ; i += kThreads) {
    const int r = i / kTileQ, c = i % kTileQ;
    float v = o_s[r * kOutLd + c];
    if (kRoundBf16) v = __bfloat162float(__float2bfloat16_rn(v));
    if (kQueryMajor) {
      if (q0 + r < ql && n0 + c < n) out[(size_t)(q0 + r) * n + n0 + c] = v;
    } else {
      if (n0 + r < n && q0 + c < ql) out[(size_t)(n0 + r) * ql + q0 + c] = v;
    }
  }
}

template <bool kQueryMajor, bool kRoundBf16>
int launch(const void* corpus, const void* q, void* out, int ld, int n, int d, long long stride_t,
           int ql, int tchunk, cudaStream_t stream) {
  const size_t smem = smem_bytes(d, tchunk);
  auto kernel = maxima_kernel<kQueryMajor, kRoundBf16>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((ql + kTileQ - 1) / kTileQ, (n + kTileN - 1) / kTileN);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const __nv_bfloat16*>(corpus),
                                           static_cast<const __nv_bfloat16*>(q),
                                           static_cast<float*>(out), ld, n, d, stride_t, ql, tchunk);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// corpus: [ld, n, d] bf16 with rows of d contiguous and `stride_t` elements
// between tokens; q: [ql, d] bf16 contiguous; out: f32 contiguous, [ql, n]
// when `query_major`, else [n, ql]; `round_bf16` rounds each max to bf16;
// `tchunk` doc tokens are staged per step.  K1 is query_major 0,
// round_bf16 0, tchunk 1.  Requires d % 16 == 0, 16 <= d <= 256, n >= 1,
// ql >= 1, ld >= 1, tchunk >= 1 and smem_bytes(d, tchunk) <= 232,448.
extern "C" int maxsim_maxima(const void* corpus, const void* q, void* out, int ld, int n, int d,
                             long long stride_t, int ql, int tchunk, int query_major,
                             int round_bf16, void* stream) {
  if (d % 16 != 0 || d < 16 || d > 256 || n < 1 || ql < 1 || ld < 1 || tchunk < 1 ||
      smem_bytes(d, tchunk) > kMaxSmem || (n + kTileN - 1) / kTileN > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (query_major)
    return round_bf16 ? launch<true, true>(corpus, q, out, ld, n, d, stride_t, ql, tchunk, s)
                      : launch<true, false>(corpus, q, out, ld, n, d, stride_t, ql, tchunk, s);
  return round_bf16 ? launch<false, true>(corpus, q, out, ld, n, d, stride_t, ql, tchunk, s)
                    : launch<false, false>(corpus, q, out, ld, n, d, stride_t, ql, tchunk, s);
}

extern "C" const char* maxsim_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
