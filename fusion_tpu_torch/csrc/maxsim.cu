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
// H100's ~295 bf16 FLOP/byte ridge: compute-bound, so the products must run
// at the tensor cores' full rate, which only wgmma reaches.  The second
// limit is L2: every CTA of one doc tile reads that tile again.
//
// Design (warp-specialised wgmma/TMA pipeline):
//   * One CTA owns 64 docs x 256 query tokens: three warpgroups, a producer
//     and two consumers.  Each consumer owns 128 of the query tokens.
//   * The query tile (256 x D bf16, 64 KB at D 128) is loaded once by TMA.
//     Every doc tile is then read from L2 QL/256 times (8 at QL 2,048),
//     half what a 128-token tile would read.
//   * The producer's one elected thread keeps a ring of stages in flight by
//     TMA.  A stage is `tchunk` doc tokens of the 64 docs (a 3-D box over
//     the [Ld, N, D] corpus, 8 KB per token and 64 columns of D); it is
//     full when its bytes land (mbarrier transaction count) and empty when
//     all eight consumer warps have arrived, after their products from it
//     complete.  The ring holds as many stages as fit beside the query tile
//     (at most 8).  K1 loads 4 tokens per stage: fewer, deeper stages mean
//     fewer barrier waits per token.
//   * Per doc token each consumer issues D/16 `wgmma m64n128k16` steps, A =
//     the token's 64 x D doc tile, B = its 128 query rows (both K-major,
//     128-byte swizzle), the first with the accumulator's scale-d off (no
//     zero fill), then folds the 64 accumulator registers into a running
//     max kept in 64 more registers.  While one consumer folds, the other's
//     products run.  setmaxnreg gives the producer 40 registers and the
//     consumers 232.
//   * Width: the tile's reduction extent is D rounded up to 64 (one or more
//     64-column swizzle atoms); TMA fills columns past D with zeros, which
//     add nothing to a dot product, and only the D/16 real k-steps run, so
//     every D in [16, 256] that is a multiple of 16 takes the same layout.
//   * Ld: a stage past the last doc token is zero-filled by TMA, and a zero
//     token's similarity 0 would enter the max, so a consumer folds only the
//     min(tchunk, Ld - t0) real tokens of a stage.  Docs past N and query
//     tokens past QL are zero-filled too; their maxima are dropped at the
//     store.
//   * Epilogue in registers: each thread writes its maxima straight from
//     the accumulator layout (four threads of a quad cover 8 consecutive
//     columns, 8 quads 8 consecutive rows, so every 32-byte sector is
//     written whole).  No shared-memory staging, no barrier.
//   * `corpus` may be a doc slice of a larger corpus (stride_t != N*D): the
//     tensor map is built per call on the host with dims (D, N, Ld) and
//     byte strides (2*D, 2*stride_t), so TMA never reads past the slice.

#include <cuda_bf16.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kTileN = 64;       // docs per CTA (wgmma M)
constexpr int kTileQ = 256;      // query tokens per CTA, 128 per consumer (wgmma N)
constexpr int kAtom = 64;        // bf16 columns of one swizzle atom (128 bytes)
constexpr int kThreads = 384;    // consumer warpgroups 0, 1; producer warpgroup 2
constexpr int kMaxStages = 8;
constexpr size_t kMaxSmem = 232448;  // shared memory one block may use on Hopper
constexpr size_t kBarBytes = 256;    // the ring's mbarriers, and the query tile's
constexpr size_t kTokenBytes = (size_t)kTileN * kAtom * 2;  // one token of one atom: 8 KB

__host__ __device__ inline int atoms(int d) { return (d + kAtom - 1) / kAtom; }
__host__ __device__ inline size_t q_bytes(int d) {
  return (size_t)atoms(d) * kTileQ * kAtom * 2;
}
__host__ __device__ inline size_t stage_bytes(int d, int tchunk) {
  return (size_t)atoms(d) * tchunk * kTokenBytes;
}

// stages that fit beside the query tile (0: the call cannot run)
int ring_stages(int d, int tchunk) {
  const size_t fixed = q_bytes(d) + kBarBytes + hopper::kAtomAlign;  // + alignment slack
  if (fixed >= kMaxSmem) return 0;
  const size_t n = (kMaxSmem - fixed) / stage_bytes(d, tchunk);
  return (int)(n < (size_t)kMaxStages ? n : kMaxStages);
}

size_t smem_bytes(int d, int tchunk, int stages) {
  return hopper::kAtomAlign + q_bytes(d) + (size_t)stages * stage_bytes(d, tchunk) + kBarBytes;
}

template <bool kQueryMajor, bool kRoundBf16>
__global__ void __launch_bounds__(kThreads, 1)
maxima_kernel(const __grid_constant__ CUtensorMap corpus_map,  // (D, N, Ld), box (64, 64, tchunk)
              const __grid_constant__ CUtensorMap q_map,       // (D, QL), box (64, 256)
              float* __restrict__ out,                         // [N, QL] or [QL, N]
              int ld, int n, int d, int ql, int tchunk, int stages) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + hopper::kAtomAlign - 1) &
      ~(uintptr_t)(hopper::kAtomAlign - 1));
  const int na = atoms(d);
  unsigned char* q_s = base;                                 // [na][256][64] bf16, swizzled
  unsigned char* ring = q_s + q_bytes(d);                    // stages x [na][tchunk][64][64]
  const size_t sbytes = stage_bytes(d, tchunk);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * sbytes);
  uint64_t* empty = full + kMaxStages;
  uint64_t* q_full = empty + kMaxStages;

  const int n0 = blockIdx.y * kTileN;
  const int q0 = blockIdx.x * kTileQ;
  const int wg = threadIdx.x / 128;
  const int nchunks = (ld + tchunk - 1) / tchunk;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    hopper::mbar_init(q_full, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------------------------------------------------- producer
    hopper::regs_dealloc<40>();
    if (threadIdx.x == 256) {
      hopper::mbar_arrive_expect_tx(q_full, (uint32_t)q_bytes(d));
      for (int a = 0; a < na; ++a)
        hopper::tma_load_2d(q_s + (size_t)a * kTileQ * kAtom * 2, &q_map, q_full, a * kAtom, q0);
      for (int c = 0; c < nchunks; ++c) {
        const int s = c % stages;
        hopper::mbar_wait(&empty[s], ((c / stages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], (uint32_t)sbytes);
        unsigned char* dst = ring + s * sbytes;
        for (int a = 0; a < na; ++a)
          hopper::tma_load_3d(dst + (size_t)a * tchunk * kTokenBytes, &corpus_map, &full[s],
                              a * kAtom, n0, c * tchunk);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    hopper::regs_alloc<232>();
    float acc[64], best[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) best[i] = -INFINITY;
    const int ksteps = d / 16;
    const unsigned char* qb = q_s + (size_t)wg * 128 * 128;  // this consumer's 128 query rows
    hopper::mbar_wait(q_full, 0);
    for (int c = 0; c < nchunks; ++c) {
      const int s = c % stages;
      hopper::mbar_wait(&full[s], (c / stages) & 1);
      const unsigned char* st = ring + s * sbytes;
      const int tc = min(tchunk, ld - c * tchunk);  // real doc tokens in this stage
      for (int tt = 0; tt < tc; ++tt) {
#pragma unroll
        for (int i = 0; i < 64; ++i) hopper::fence_regs(acc[i]);
        hopper::wgmma_fence();
        for (int k = 0; k < ksteps; ++k) {
          const int a = k >> 2, kk = (k & 3) * 32;  // atom, byte offset inside its rows
          const uint64_t da = hopper::desc_sw128(st + ((size_t)a * tchunk + tt) * kTokenBytes + kk);
          const uint64_t db = hopper::desc_sw128(qb + (size_t)a * kTileQ * kAtom * 2 + kk);
          hopper::wgmma_m64n128k16_ss(acc, da, db, k > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          hopper::fence_regs(acc[i]);
          best[i] = fmaxf(best[i], acc[i]);
        }
      }
      // the stage's products are complete (wgmma_wait above): free it
      __syncwarp();
      if (threadIdx.x % 32 == 0) hopper::mbar_arrive(&empty[s]);
    }

    // accumulator element i = 4j + e: row (doc) 16*warp + lane/4 + 8*(e/2),
    // column (query token) 8j + 2*(lane%4) + e%2
    const int t = threadIdx.x % 128;
    const int row0 = n0 + 16 * (t / 32) + (t % 32) / 4;
    const int col0 = q0 + wg * 128 + 2 * (t % 4);
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int doc = row0 + 8 * ((i & 3) >> 1);
      const int tok = col0 + 8 * (i >> 2) + (i & 1);
      float v = best[i];
      if (kRoundBf16) v = __bfloat162float(__float2bfloat16_rn(v));
      if (doc < n && tok < ql) {
        if (kQueryMajor)
          out[(size_t)tok * n + doc] = v;
        else
          out[(size_t)doc * ql + tok] = v;
      }
    }
  }
}

template <bool kQueryMajor, bool kRoundBf16>
int launch(const void* corpus, const void* q, void* out, int ld, int n, int d, long long stride_t,
           int ql, int tchunk, cudaStream_t stream) {
  const int stages = ring_stages(d, tchunk);
  if (stages < 1) return (int)cudaErrorInvalidValue;
  CUtensorMap corpus_map, q_map;
  const cuuint64_t c_dims[3] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)ld};
  const cuuint64_t c_strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)stride_t * 2};
  const cuuint32_t c_box[3] = {kAtom, kTileN, (cuuint32_t)tchunk};
  cudaError_t err = hopper::encode_map(&corpus_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, corpus,
                                       c_dims, c_strides, c_box);
  if (err != cudaSuccess) return (int)err;
  const cuuint64_t q_dims[2] = {(cuuint64_t)d, (cuuint64_t)ql};
  const cuuint64_t q_strides[1] = {(cuuint64_t)d * 2};
  const cuuint32_t q_box[2] = {kAtom, kTileQ};
  err = hopper::encode_map(&q_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q, q_dims, q_strides, q_box);
  if (err != cudaSuccess) return (int)err;

  const size_t smem = smem_bytes(d, tchunk, stages);
  auto kernel = maxima_kernel<kQueryMajor, kRoundBf16>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // query tiles on grid.x: the CTAs that share a doc tile run together, so
  // the corpus comes from device memory about once and from L2 after that
  const dim3 grid((ql + kTileQ - 1) / kTileQ, (n + kTileN - 1) / kTileN);
  kernel<<<grid, kThreads, smem, stream>>>(corpus_map, q_map, static_cast<float*>(out), ld, n, d,
                                           ql, tchunk, stages);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// corpus: [ld, n, d] bf16 with rows of d contiguous and `stride_t` elements
// between tokens; q: [ql, d] bf16 contiguous; out: f32 contiguous, [ql, n]
// when `query_major`, else [n, ql]; `round_bf16` rounds each max to bf16;
// `tchunk` doc tokens are loaded per ring stage (the maxima do not depend
// on it).  K1 is query_major 0, round_bf16 0.  Requires d % 16 == 0,
// 16 <= d <= 256, n >= 1, ql >= 1, ld >= 1, 1 <= tchunk <= 256, corpus and
// q 16-byte aligned, stride_t >= n * d and a multiple of 8, and one ring
// stage beside the query tile (ops/maxsim.py::maxima_stages mirrors the
// count).
extern "C" int maxsim_maxima(const void* corpus, const void* q, void* out, int ld, int n, int d,
                             long long stride_t, int ql, int tchunk, int query_major,
                             int round_bf16, void* stream) {
  if (d % 16 != 0 || d < 16 || d > 256 || n < 1 || ql < 1 || ld < 1 || tchunk < 1 ||
      tchunk > 256 || stride_t % 8 != 0 || stride_t < (long long)n * d ||
      (reinterpret_cast<uintptr_t>(corpus) | reinterpret_cast<uintptr_t>(q)) % 16 != 0 ||
      (n + kTileN - 1) / kTileN > 65535)
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
