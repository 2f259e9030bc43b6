// MaxSim on Hopper (sm_90a): the ColBERT late-interaction core, one body for
// the token maxima and for the fused scores.
//
// Replaces these TPU kernels, which differ only in where the maxima go, in
// how the max is rounded, and in whether the query-mask sum follows:
//   * K1    fusion_tpu/ops/maxsim.py::_maxsim_kernel_T (driven by
//           _maxima_T_pallas): maxima stored doc-major, [N, QL];
//   * K1-v2 fusion_tpu/ops/maxsim.py::_maxsim_v2_kernel_3d (driven by
//           maxsim_token_maxima_pallas): the same maxima stored
//           query-token-major, [QL, N], reduced in bf16 on the TPU;
//   * K1-v1 fusion_tpu/ops/maxsim.py::_maxsim_kernel (driven by
//           maxsim_scores_pallas): the Ld max and the query-mask sum fused,
//           strict mask -- sims of masked doc tokens are -1e9 and the
//           running max starts at -1e9, so a fully masked doc scores -1e9
//           times its query's mask sum;
//   * scripts/bench_maxsim.py::_kernel_fusedsum: the fused sum over zeroed
//     tokens (no doc mask);
//   * the maxima variants of the MaxSim benches: scripts/bench_maxsim.py
//     _kernel_bf16max, _kernel_f32max and _kernel_chunked(tchunk), and
//     scripts/bench_maxsim2.py _kernel_bf16max, _kernel_dotgen and
//     _kernel_dotgen_bf16.
//
// Computes, for a token-major corpus whose masked tokens are zero vectors,
//
//     M[n, j] = max_{t < Ld} s(j, t, n),  s(j, t, n) = sum_d corpus[t, n, d] * q[j, d]
//
// with bf16 inputs, f32 accumulation and an f32 running max, and stores M
// doc-major ([N, QL], K1) or query-token-major ([QL, N], K1-v2), either as
// it is or rounded once to bf16 (round-to-nearest-even is monotone, so
// rounding the f32 max equals the max of the rounded sims, which is what the
// TPU's bf16 reduce computes); or, fused, the scores
//
//     out[q, n] = sum_i qm[q, i] * M[n, q*Lq + i]     (strict: s = -1e9 where dm[t, n] <= 0,
//                                                      and the max starts at -1e9)
//
// summed over each query's Lq tokens in ascending order (the TPU sums them as
// one [Q, QL] x [QL, B] product, in another order).
//
// What bounds it: at the serving shape (Ld 128, N 28,032, D 128, QL 2,048)
// one call is 2*QL*N*Ld*D ~ 1.9 TFLOP against ~0.9 GB of corpus read and
// 0.23 GB of maxima written, about 1,600 FLOP per byte -- far above the
// H100's ~295 bf16 FLOP/byte ridge: compute-bound, so the products must run
// at the tensor cores' full rate, which only wgmma reaches.  The fused modes
// write Q*N scores instead of QL*N maxima and read a 14 MB mask: the same
// bound.  The second limit is L2: every CTA of one doc tile reads that tile
// again.
//
// Design (warp-specialised wgmma/TMA pipeline):
//   * One CTA owns 64 docs x 256 query rows: three warpgroups, a producer
//     and two consumers.  Each consumer owns 128 of the query rows.
//   * The query tile (256 x D bf16, 64 KB at D 128) is loaded once by TMA,
//     as one 128-row box per consumer and 64-column atom.  Every doc tile is
//     then read from L2 QL/256 times (8 at QL 2,048), half what a 128-row
//     tile would read.  For the maxima the two boxes are rows q0 and
//     q0 + 128.  For the fused sum each consumer's rows start at a whole
//     query: qpw = floor(128 / Lq) queries per consumer, 2 * qpw per CTA, so
//     a consumer owns every token it sums and no sum crosses CTAs; its rows
//     past qpw * Lq are computed and never summed.  Rows past QL are
//     zero-filled by TMA (a box wholly past QL loads row 0 instead, whose
//     maxima are never stored).
//   * The producer's one elected thread keeps a ring of stages in flight by
//     TMA.  A stage is `tchunk` doc tokens of the 64 docs (a 3-D box over
//     the [Ld, N, D] corpus, 8 KB per token and 64 columns of D) and, for
//     the strict mask, the same tokens' 64 doc-mask words (a 2-D f32 box
//     over the [Ld, N] mask, 256 bytes per token, unswizzled) on the same
//     barrier; it is full when its bytes land (mbarrier transaction count)
//     and empty when all eight consumer warps have arrived, after their
//     products from it complete.  The ring holds as many stages as fit
//     beside the query tile (at most 8).  K1 and the fused modes load 4
//     tokens per stage at D 128: fewer, deeper stages mean fewer barrier
//     waits per token.
//   * Per doc token each consumer issues D/16 `wgmma m64n128k16` steps, A =
//     the token's 64 x D doc tile, B = its 128 query rows (both K-major,
//     128-byte swizzle), the first with the accumulator's scale-d off (no
//     zero fill), then folds the 64 accumulator registers into a running
//     max kept in 64 more registers.  Under the strict mask a masked sim is
//     -1e9, which never raises a max that starts at -1e9, so the fold skips
//     it: each thread reads its two doc rows' mask words for the token from
//     the stage and predicates its maxes on them -- one instruction per
//     element, as without the mask.  While one consumer folds,
//     the other's products run.  setmaxnreg gives the producer 40 registers
//     and the consumers 232.
//   * Width: the tile's reduction extent is D rounded up to 64 (one or more
//     64-column swizzle atoms); TMA fills columns past D with zeros, which
//     add nothing to a dot product, and only the D/16 real k-steps run, so
//     every D in [16, 256] that is a multiple of 16 takes the same layout.
//   * Ld: a stage past the last doc token is zero-filled by TMA, and a zero
//     token's similarity 0 would enter the max, so a consumer folds only the
//     min(tchunk, Ld - t0) real tokens of a stage.  Docs past N come back
//     as zero tokens and, under the strict mask, zero mask words (masked);
//     their maxima and scores are dropped at the store.
//   * Maxima epilogue in registers: each thread writes its maxima straight
//     from the accumulator layout (four threads of a quad cover 8
//     consecutive columns, 8 quads 8 consecutive rows, so every 32-byte
//     sector is written whole).
//   * Fused epilogue: once both consumers are past the last stage (a
//     consumer-only named barrier), each stages its 64 x 128 maxima in the
//     ring, which the pipeline no longer needs, query-token-major with rows
//     padded to 68 words (the accumulator layout then writes without bank
//     conflicts); then each thread sums one (doc, query) pair over the
//     query's Lq tokens, weighted by qm, and neighbouring threads store
//     neighbouring docs.  Any Lq in [1, 128] takes this one path.
//   * `corpus` may be a doc slice of a larger corpus (stride_t != N*D): the
//     tensor map is built per call on the host with dims (D, N, Ld) and
//     byte strides (2*D, 2*stride_t), so TMA never reads past the slice.

#include <cuda_bf16.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kTileN = 64;         // docs per CTA (wgmma M)
constexpr int kTileQ = 256;        // query rows per CTA
constexpr int kConsumerRows = 128;  // query rows per consumer (wgmma N)
constexpr int kAtom = 64;          // bf16 columns of one swizzle atom (128 bytes)
constexpr int kThreads = 384;      // consumer warpgroups 0, 1; producer warpgroup 2
constexpr int kMaxStages = 8;
constexpr size_t kMaxSmem = 232448;  // shared memory one block may use on Hopper
constexpr size_t kBarBytes = 256;    // the ring's mbarriers, and the query tile's
constexpr size_t kTokenBytes = (size_t)kTileN * kAtom * 2;  // one token of one atom: 8 KB
constexpr size_t kMaskTokenBytes = (size_t)kTileN * 4;      // one token's 64 doc-mask words
constexpr int kOutStride = kTileN + 4;  // a staged row of maxima (one query token), padded
constexpr size_t kStagingBytes = (size_t)2 * kConsumerRows * kOutStride * 4;
constexpr float kNeg = -1e9f;

// what a launch does with the maxima
enum Out { kDocMajor, kQueryMajor, kSumZeroed, kSumStrict };

__host__ __device__ inline int atoms(int d) { return (d + kAtom - 1) / kAtom; }
__host__ __device__ inline size_t q_bytes(int d) {
  return (size_t)atoms(d) * kTileQ * kAtom * 2;
}
__host__ __device__ inline size_t stage_bytes(int d, int tchunk) {
  return (size_t)atoms(d) * tchunk * kTokenBytes;
}
__host__ __device__ inline size_t mask_stage_bytes(int tchunk, bool mask) {
  return mask ? (size_t)tchunk * kMaskTokenBytes : 0;
}

// stages that fit beside the query tile (0: the call cannot run)
int ring_stages(int d, int tchunk, bool mask) {
  const size_t fixed = q_bytes(d) + kBarBytes + hopper::kAtomAlign;  // + alignment slack
  if (fixed >= kMaxSmem) return 0;
  const size_t n = (kMaxSmem - fixed) / (stage_bytes(d, tchunk) + mask_stage_bytes(tchunk, mask));
  return (int)(n < (size_t)kMaxStages ? n : kMaxStages);
}

size_t smem_bytes(int d, int tchunk, int stages, bool mask) {
  return hopper::kAtomAlign + q_bytes(d) +
         (size_t)stages * (stage_bytes(d, tchunk) + mask_stage_bytes(tchunk, mask)) + kBarBytes;
}

template <int kOut, bool kRoundBf16>
__global__ void __launch_bounds__(kThreads, 1)
maxima_kernel(const __grid_constant__ CUtensorMap corpus_map,  // (D, N, Ld), box (64, 64, tchunk)
              const __grid_constant__ CUtensorMap q_map,       // (D, QL), box (64, 128)
              const __grid_constant__ CUtensorMap mask_map,    // kSumStrict: (N, Ld) f32, box (64, tchunk)
              float* __restrict__ out,             // [N, QL], [QL, N], or the scores [nq, N]
              const float* __restrict__ qmask,     // fused: [nq, lq]
              int ld, int n, int d, int ql, int tchunk, int stages, int nq, int lq) {
  constexpr bool kFused = kOut == kSumZeroed || kOut == kSumStrict;
  constexpr bool kMask = kOut == kSumStrict;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + hopper::kAtomAlign - 1) &
      ~(uintptr_t)(hopper::kAtomAlign - 1));
  const int na = atoms(d);
  unsigned char* q_s = base;                                 // [na][256][64] bf16, swizzled
  unsigned char* ring = q_s + q_bytes(d);                    // stages x [na][tchunk][64][64]
  const size_t sbytes = stage_bytes(d, tchunk);
  float* mring = reinterpret_cast<float*>(ring + stages * sbytes);  // kMask: stages x [tchunk][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(mring) +
                                               stages * mask_stage_bytes(tchunk, kMask));
  uint64_t* empty = full + kMaxStages;
  uint64_t* q_full = empty + kMaxStages;

  const int n0 = blockIdx.y * kTileN;
  const int qpw = kFused ? kConsumerRows / lq : 0;  // whole queries per consumer
  // the first query row of consumer w
  auto first_row = [&](int w) {
    return kFused ? (blockIdx.x * 2 + w) * qpw * lq : blockIdx.x * kTileQ + w * kConsumerRows;
  };
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
      for (int w = 0; w < 2; ++w) {
        const int row = first_row(w) < ql ? first_row(w) : 0;
        for (int a = 0; a < na; ++a)
          hopper::tma_load_2d(q_s + ((size_t)a * kTileQ + (size_t)w * kConsumerRows) * kAtom * 2,
                              &q_map, q_full, a * kAtom, row);
      }
      const uint32_t tx = (uint32_t)(sbytes + mask_stage_bytes(tchunk, kMask));
      for (int c = 0; c < nchunks; ++c) {
        const int s = c % stages;
        hopper::mbar_wait(&empty[s], ((c / stages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], tx);
        unsigned char* dst = ring + s * sbytes;
        for (int a = 0; a < na; ++a)
          hopper::tma_load_3d(dst + (size_t)a * tchunk * kTokenBytes, &corpus_map, &full[s],
                              a * kAtom, n0, c * tchunk);
        if constexpr (kMask)
          hopper::tma_load_2d(mring + (size_t)s * tchunk * kTileN, &mask_map, &full[s], n0,
                              c * tchunk);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    hopper::regs_alloc<232>();
    float acc[64], best[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) best[i] = kMask ? kNeg : -INFINITY;
    // accumulator element i = 4j + e: row (doc) r0 + 8*(e/2), column (query
    // row) 8j + 2*(t%4) + e%2
    const int t = threadIdx.x % 128;
    const int r0 = 16 * (t / 32) + (t % 32) / 4;
    const int ksteps = d / 16;
    const unsigned char* qb = q_s + (size_t)wg * kConsumerRows * kAtom * 2;  // this consumer's rows
    hopper::mbar_wait(q_full, 0);
    for (int c = 0; c < nchunks; ++c) {
      const int s = c % stages;
      hopper::mbar_wait(&full[s], (c / stages) & 1);
      const unsigned char* st = ring + s * sbytes;
      const float* ms = mring + (size_t)s * tchunk * kTileN;
      const int tc = min(tchunk, ld - c * tchunk);  // real doc tokens in this stage
      for (int tt = 0; tt < tc; ++tt) {
        bool m0 = false, m1 = false;  // this thread's two doc rows masked at this token
        if constexpr (kMask) {
          m0 = hopper::lds_f32(ms + tt * kTileN + r0) <= 0.0f;
          m1 = hopper::lds_f32(ms + tt * kTileN + r0 + 8) <= 0.0f;
        }
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
          // a masked sim is -1e9, which never raises a max that starts at
          // -1e9: skip it (one predicated max per element, as unmasked)
          if (!kMask || !((i & 2) ? m1 : m0)) best[i] = fmaxf(best[i], acc[i]);
        }
      }
      // the stage's products are complete (wgmma_wait above): free it
      __syncwarp();
      if (threadIdx.x % 32 == 0) hopper::mbar_arrive(&empty[s]);
    }

    if constexpr (kFused) {
      // both consumers are past the last stage: the ring is free
      hopper::fence_proxy_async();
      hopper::named_barrier_sync(1, 256);
      float* o_s = reinterpret_cast<float*>(ring) + (size_t)wg * kConsumerRows * kOutStride;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int tok = 8 * (i >> 2) + 2 * (t % 4) + (i & 1);
        o_s[tok * kOutStride + r0 + 8 * ((i & 3) >> 1)] = best[i];
      }
      hopper::named_barrier_sync(2 + wg, 128);
      const int q_first = (blockIdx.x * 2 + wg) * qpw;
      const int q_count = min(qpw, nq - q_first);
      for (int p = t; p < kTileN * q_count; p += 128) {
        const int r = p % kTileN, qq = p / kTileN;
        if (n0 + r >= n) continue;
        const float* m = o_s + (size_t)qq * lq * kOutStride + r;
        const float* w = qmask + (size_t)(q_first + qq) * lq;
        float sum = 0.0f;
        for (int i = 0; i < lq; ++i) sum = fmaf(w[i], m[i * kOutStride], sum);
        out[(size_t)(q_first + qq) * n + n0 + r] = sum;
      }
    } else {
      const int row0 = n0 + r0;
      const int col0 = first_row(wg) + 2 * (t % 4);
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int doc = row0 + 8 * ((i & 3) >> 1);
        const int tok = col0 + 8 * (i >> 2) + (i & 1);
        float v = best[i];
        if (kRoundBf16) v = __bfloat162float(__float2bfloat16_rn(v));
        if (doc < n && tok < ql) {
          if (kOut == kQueryMajor)
            out[(size_t)tok * n + doc] = v;
          else
            out[(size_t)doc * ql + tok] = v;
        }
      }
    }
  }
}

// nq and lq only for the fused modes (the maxima take ql rows as they are);
// dmask only for kSumStrict
template <int kOut, bool kRoundBf16>
int launch(const void* corpus, const void* q, const void* qmask, const void* dmask, void* out,
           int ld, int n, int d, long long stride_t, int ql, int nq, int lq, int tchunk,
           cudaStream_t stream) {
  constexpr bool kFused = kOut == kSumZeroed || kOut == kSumStrict;
  constexpr bool kMask = kOut == kSumStrict;
  const int stages = ring_stages(d, tchunk, kMask);
  if (stages < 1) return (int)cudaErrorInvalidValue;
  // the fused epilogue stages both consumers' maxima in the ring
  if (kFused && (size_t)stages * stage_bytes(d, tchunk) < kStagingBytes)
    return (int)cudaErrorInvalidValue;
  CUtensorMap corpus_map, q_map, mask_map{};
  const cuuint64_t c_dims[3] = {(cuuint64_t)d, (cuuint64_t)n, (cuuint64_t)ld};
  const cuuint64_t c_strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)stride_t * 2};
  const cuuint32_t c_box[3] = {kAtom, kTileN, (cuuint32_t)tchunk};
  cudaError_t err = hopper::encode_map(&corpus_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, corpus,
                                       c_dims, c_strides, c_box);
  if (err != cudaSuccess) return (int)err;
  const cuuint64_t q_dims[2] = {(cuuint64_t)d, (cuuint64_t)ql};
  const cuuint64_t q_strides[1] = {(cuuint64_t)d * 2};
  const cuuint32_t q_box[2] = {kAtom, kConsumerRows};
  err = hopper::encode_map(&q_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q, q_dims, q_strides, q_box);
  if (err != cudaSuccess) return (int)err;
  if (kMask) {
    // rows of round_up(n, 4) words: TMA needs 16-byte row strides
    const cuuint64_t m_dims[2] = {(cuuint64_t)n, (cuuint64_t)ld};
    const cuuint64_t m_strides[1] = {(cuuint64_t)((n + 3) / 4 * 4) * 4};
    const cuuint32_t m_box[2] = {kTileN, (cuuint32_t)tchunk};
    err = hopper::encode_map(&mask_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, dmask, m_dims, m_strides,
                             m_box, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err != cudaSuccess) return (int)err;
  }

  const size_t smem = smem_bytes(d, tchunk, stages, kMask);
  auto kernel = maxima_kernel<kOut, kRoundBf16>;
  err = hopper::raise_smem_limit(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  // query tiles on grid.x: the CTAs that share a doc tile run together, so
  // the corpus comes from device memory about once and from L2 after that
  const int qtiles = kFused ? (nq + 2 * (kConsumerRows / lq) - 1) / (2 * (kConsumerRows / lq))
                            : (ql + kTileQ - 1) / kTileQ;
  const dim3 grid(qtiles, (n + kTileN - 1) / kTileN);
  kernel<<<grid, kThreads, smem, stream>>>(corpus_map, q_map, mask_map, static_cast<float*>(out),
                                           static_cast<const float*>(qmask), ld, n, d, ql, tchunk,
                                           stages, nq, lq);
  return (int)cudaGetLastError();
}

bool aligned16(const void* a, const void* b) {
  return (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16 == 0;
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
      tchunk > 256 || stride_t % 8 != 0 || stride_t < (long long)n * d || !aligned16(corpus, q) ||
      (n + kTileN - 1) / kTileN > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto args = [&](auto launcher) {
    return launcher(corpus, q, nullptr, nullptr, out, ld, n, d, stride_t, ql, 0, 0, tchunk, s);
  };
  if (query_major)
    return round_bf16 ? args(launch<kQueryMajor, true>) : args(launch<kQueryMajor, false>);
  return round_bf16 ? args(launch<kDocMajor, true>) : args(launch<kDocMajor, false>);
}

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// corpus: [ld, n, d] bf16 contiguous; q: [nq * lq, d] bf16 contiguous;
// qmask: [nq, lq] f32 contiguous; dmask: [ld, round_up(n, 4)] f32 contiguous
// (columns past n unread) for the strict mask, or null for zeroed tokens;
// out: [nq, n] f32 contiguous; `tchunk` doc tokens per ring stage (the scores
// do not depend on it).  Requires d % 16 == 0, 16 <= d <= 256,
// 1 <= lq <= 128, n >= 1, nq >= 1, ld >= 1, 1 <= tchunk <= 256, corpus, q and
// dmask 16-byte aligned, and ring stages beside the query tile that hold the
// epilogue's staged maxima (ops/maxsim.py::fused_stages mirrors the count).
extern "C" int maxsim_fused(const void* corpus, const void* q, const void* qmask,
                            const void* dmask, void* out, int ld, int n, int d, int nq, int lq,
                            int tchunk, void* stream) {
  if (d % 16 != 0 || d < 16 || d > 256 || lq < 1 || lq > 128 || n < 1 || nq < 1 || ld < 1 ||
      tchunk < 1 || tchunk > 256 || !aligned16(corpus, q) || !aligned16(dmask, nullptr) ||
      (n + kTileN - 1) / kTileN > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long stride_t = (long long)n * d;
  if (dmask != nullptr)
    return launch<kSumStrict, false>(corpus, q, qmask, dmask, out, ld, n, d, stride_t, nq * lq, nq,
                                     lq, tchunk, s);
  return launch<kSumZeroed, false>(corpus, q, qmask, nullptr, out, ld, n, d, stride_t, nq * lq, nq,
                                   lq, tchunk, s);
}

extern "C" const char* maxsim_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
