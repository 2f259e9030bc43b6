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
// cores with f32 accumulation; int8 -> bf16 is exact (|v| <= 128).  The
// queries are not quantized: an int8 product would be a different score.
//
// What bounds it: at the mMARCO serving shape (Q 64, H 768, N 8,912,896) one
// call reads 6.85 GB of int8 rows (~2 ms at 3.35 TB/s) for 0.88 TFLOP
// (~0.9 ms at the bf16 dense peak): memory-bound, so every row is read once
// and enough bytes must be in flight on every SM to cover the latency of
// device memory (Little's law: ~25 KB per SM at 3.35 TB/s).
//
// Design (warp-specialised wgmma/TMA pipeline):
//   * One CTA owns a 64-query tile and the 128 bins of one 2,048-doc group (a
//     doc block of D docs spans D/2048 CTAs), so with Q <= 64 the corpus is
//     read exactly once, whatever D.  Its 16 strided sub-tiles are rows
//     b*D + s*(D/16) + lane0 + [0, 128); its output bins are 128 consecutive
//     columns, blockIdx.x*128 + [0, 128), for every D.
//   * Persistent CTAs: one per SM (per query tile), each walking the
//     groups blockIdx.x, blockIdx.x + gridDim.x, ...; the queries are
//     staged once per CTA, not once per group, and no CTA exit and launch
//     drains the pipeline between groups.
//   * Three warpgroups: a producer and two consumers.  The producer's one
//     elected thread keeps a ring of TMA stages in flight, each 128 rows x
//     128 int8 columns (16 KB, one box under the 128-byte swizzle): 8 stages
//     (128 KB in flight per SM) at H 768, as many as fit beside the query
//     tile at other H.  It starts at once, while the consumers stage the
//     queries, and runs on into the next group while the consumers finish
//     a group's epilogue.
//   * The 64 queries are the B operand of `wgmma m64n64k16`, resident in
//     shared memory for the whole CTA (K-major, 128-byte swizzle; 96 KB at
//     H 768), written once by the consumers with their columns permuted
//     inside each 64-column group (below).
//   * Each consumer takes 64 of the stage's rows (doc lanes) as the M side,
//     with A from registers: a thread reads its two rows' int8 bytes from the
//     stage with two 16-byte loads per 64 columns, widens them exactly to
//     bf16 (a magic-number f32 add, then one packed convert) and issues the
//     products; the stage goes back to the producer once those products
//     complete (an arrive placed right after the loads could overtake
//     them: ptxas schedules it before the loaded values are used).  The int8 bytes a
//     thread reads are 16 consecutive columns, while an mma fragment holds
//     columns {2c, 2c+1, 2c+8, 2c+9} of each 16-column step (c = lane % 4):
//     since a dot product is a sum over columns, the kernel takes a
//     thread's 16 consecutive bytes as its fragment slots of four k-steps
//     and permutes the query columns to match when it stages the queries:
//     inside a 64-column group, column 16c + 4j + v goes to step j, slot
//     2c + (v & 1) + 8 (v >> 1).
//   * Epilogue in registers: after a sub-tile's k-steps, each thread holds
//     32 (doc lane, query) scores in the accumulator.  It applies its two
//     docs' scales, the dead-row term and the n_docs mask (__fmul_rn then
//     __fadd_rn with -0.0 for live rows, so the sign of zero is kept) and
//     folds them into a running best / offset in the accumulator's own
//     layout, in sub-tile order, with a strict '>'.  No shared-memory round
//     trip and no barrier per sub-tile; the packed bins are written once.
//   * Width: a row box is 128 int8 columns and TMA fills columns past H
//     with zeros, and the query tile holds zeros past H, so every H in
//     [16, 1024] that is a multiple of 16 takes the same layout; 64-column
//     groups wholly past H are skipped.

#include <cuda_bf16.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int kBin = 16;                     // sub-tiles per CTA = docs per bin
constexpr int kLanes = 128;                  // docs per sub-tile = bins per CTA
constexpr int kMinDocBlock = kBin * kLanes;  // 2048: one CTA per doc group
constexpr int kTileQ = 64;                   // queries per CTA (wgmma N)
constexpr int kKC = 128;                     // int8 columns per stage (one 128-byte box row)
constexpr int kGroup = 64;                   // columns per bf16 swizzle atom of the queries
constexpr int kThreads = 384;                // consumer warpgroups 0, 1; producer warpgroup 2
constexpr int kMaxStages = 8;
constexpr size_t kStageBytes = (size_t)kLanes * kKC;  // 16 KB
constexpr size_t kGroupBytes = (size_t)kTileQ * kGroup * 2;  // 8 KB of queries per group
constexpr size_t kMaxSmem = 232448;
constexpr size_t kBarBytes = 256;
constexpr float kDead = -3.0e38f;

__host__ __device__ inline int groups(int h) { return (h + kGroup - 1) / kGroup; }

int ring_stages(int h) {
  const size_t fixed = (size_t)groups(h) * kGroupBytes + kBarBytes + hopper::kAtomAlign;
  const size_t n = (kMaxSmem - fixed) / kStageBytes;
  return (int)(n < (size_t)kMaxStages ? n : kMaxStages);
}

// two int8 values (bytes 2*half, 2*half + 1 of w) -> a bf16 pair, exactly:
// a byte b read as unsigned u = b + 128 is the f32 2^23 + u, minus 2^23 + 128
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t w_biased, int half) {
  const float lo = __uint_as_float(__byte_perm(w_biased, 0x4B000000u, 0x7540 + 2 * half)) - 8388736.0f;
  const float hi = __uint_as_float(__byte_perm(w_biased, 0x4B000000u, 0x7541 + 2 * half)) - 8388736.0f;
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// kDocBlock docs per bin block (2048, 4096 or 8192); kDeadRows adds the
// dead-row term of _binmax_kernel.  Grid: (CTAs per query tile,
// ceil(nq / 64)); CTA x walks the 2,048-doc groups x, x + gridDim.x, ...
// of the ntiles = N_pad / 2048.
template <int kDocBlock, bool kDeadRows>
__global__ void __launch_bounds__(kThreads, 1)
dense_binmax_kernel(const __grid_constant__ CUtensorMap v_map,  // int8 (H, N_pad), box (128, 128)
                    const __nv_bfloat16* __restrict__ q,        // [nq, h]
                    const float* __restrict__ scales,           // [ntiles * 2048]
                    float* __restrict__ out,                    // [nq, ntiles * 128]
                    int nq, int h, int ntiles, long long n_docs, int stages) {
  static_assert(kDocBlock % kMinDocBlock == 0, "doc block: a multiple of 2048");
  constexpr int kStride = kDocBlock / kBin;          // docs between sub-tiles
  constexpr int kGroups = kDocBlock / kMinDocBlock;  // CTAs per doc block
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + hopper::kAtomAlign - 1) &
      ~(uintptr_t)(hopper::kAtomAlign - 1));
  const int ng = groups(h);
  unsigned char* q_s = base;                          // [ng][64 queries][64 cols] bf16, swizzled
  unsigned char* ring = q_s + (size_t)ng * kGroupBytes;  // stages x [128 rows][128 int8]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + (size_t)stages * kStageBytes);
  uint64_t* empty = full + kMaxStages;

  const int q0 = blockIdx.y * kTileQ;
  const int wg = threadIdx.x / 128;
  // the first row of group blk's sub-tile 0
  auto first_row = [](int blk) {
    return (long long)(blk / kGroups) * kDocBlock + (blk % kGroups) * kLanes;
  };
  const int nkc = (h + kKC - 1) / kKC;  // stages per sub-tile
  const int steps = kBin * nkc;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------------------------------------------------- producer
    hopper::regs_dealloc<40>();
    if (threadIdx.x == 256) {
      int s = 0;  // the ring runs on across groups
      uint32_t phase = 0;
      for (int blk = blockIdx.x; blk < ntiles; blk += gridDim.x) {
        const long long row0 = first_row(blk);
        for (int t = 0; t < steps; ++t, s = s + 1 == stages ? 0 : s + 1, phase ^= s == 0) {
          const int sub = t / nkc, kc = t % nkc;
          hopper::mbar_wait(&empty[s], phase ^ 1);
          hopper::mbar_arrive_expect_tx(&full[s], (uint32_t)kStageBytes);
          hopper::tma_load_2d(ring + (size_t)s * kStageBytes, &v_map, &full[s], kc * kKC,
                              (int)(row0 + (long long)sub * kStride));
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    hopper::regs_alloc<232>();
    const int tid = threadIdx.x;  // 0..255
    // the query tile, once: 16-byte chunk p of query r's group g holds, for
    // w = 0..3, the column pair at 64g + 16w + 4(p/2) + 2(p%2) (the
    // permutation above), at chunk p ^ (r % 8) of its 128-byte row
    for (int ci = tid; ci < kTileQ * ng * 8; ci += 256) {
      const int r = ci / (ng * 8), g = (ci / 8) % ng, p = ci % 8;
      uint32_t w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int col = g * kGroup + 16 * k + 4 * (p / 2) + 2 * (p % 2);
        w[k] = (q0 + r < nq && col < h)
                   ? *reinterpret_cast<const uint32_t*>(q + (size_t)(q0 + r) * h + col)
                   : 0u;
      }
      *reinterpret_cast<uint4*>(q_s + (size_t)g * kGroupBytes + r * 128 + ((p ^ (r % 8)) * 16)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
    hopper::fence_proxy_async();       // the tile is read by wgmma (async proxy)
    hopper::named_barrier_sync(1, 256);  // both consumers' writes done

    const int t = tid % 128;
    const int warp = t / 32, lane = t % 32, quad = lane % 4;
    const int rA = wg * 64 + 16 * warp + lane / 4;  // this thread's two rows (doc lanes)
    const int rB = rA + 8;
    float acc[32], best[32];
    int off[32];
    int s = 0;
    uint32_t phase = 0;
    // A stage goes back to the producer only once the products made from it
    // have completed (after a wgmma_wait): an arrive right after its loads
    // were issued may be scheduled before the loads return, and the
    // producer's next TMA into the stage would race them.
    auto release = [&](int stage) {
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[stage]);
    };
    int held = -1;  // the stage whose products are in flight
    for (int blk = blockIdx.x; blk < ntiles; blk += gridDim.x) {
      const long long row0 = first_row(blk);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        best[i] = -INFINITY;
        off[i] = 0;
      }
      float scA = 0.f, scB = 0.f;
      for (int step = 0; step < steps; ++step, s = s + 1 == stages ? 0 : s + 1, phase ^= s == 0) {
        const int sub = step / nkc, kc = step % nkc;
        if (kc == 0) {
          const long long docA = row0 + (long long)sub * kStride + rA;
          scA = scales[docA];
          scB = scales[docA + 8];
        }
        hopper::mbar_wait(&full[s], phase);
        const unsigned char* st = ring + (size_t)s * kStageBytes;
        // this thread's bytes: rows rA, rB, 16-byte chunk quad + 4*half of the
        // stage's 128 columns (swizzled: chunk c of row r sits at c ^ (r % 8))
        uint4 raw[2][2];  // [half][row A / B]
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int chunk = (quad + 4 * half) ^ (rA % 8);  // rB % 8 == rA % 8
          raw[half][0] = hopper::lds128(st + rA * kKC + chunk * 16);
          raw[half][1] = hopper::lds128(st + rB * kKC + chunk * 16);
        }
        // the previous stage's products read a[] until they complete; the
        // fences keep the conversion below this wait
        hopper::wgmma_wait<0>();
        if (held >= 0) release(held);
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int r = 0; r < 2; ++r) hopper::fence_regs(raw[half][r]);
        // A fragments of the stage's 8 k-steps: step 4*half + j takes word j
        uint32_t a[8][4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t wa = word(raw[half][0], j) ^ 0x80808080u;
            const uint32_t wb = word(raw[half][1], j) ^ 0x80808080u;
            a[4 * half + j][0] = i8x2_to_bf16x2(wa, 0);
            a[4 * half + j][1] = i8x2_to_bf16x2(wb, 0);
            a[4 * half + j][2] = i8x2_to_bf16x2(wa, 1);
            a[4 * half + j][3] = i8x2_to_bf16x2(wb, 1);
          }
        }

#pragma unroll
        for (int i = 0; i < 32; ++i) hopper::fence_regs(acc[i]);
        hopper::wgmma_fence();
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int g = 2 * kc + half;
          if (g >= ng) break;  // a 64-column group wholly past H
          const unsigned char* qg = q_s + (size_t)g * kGroupBytes;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            hopper::wgmma_m64n64k16_rs(acc, a[4 * half + j], hopper::desc_sw128(qg + 32 * j),
                                       kc > 0 || half > 0 || j > 0);
        }
        hopper::wgmma_commit();
        held = s;
        if (kc != nkc - 1) continue;

        // sub-tile `sub` is complete: scale, mask, and fold into the running
        // maxima.  Element i = 4j + e: doc lane rA (e < 2) or rB, query
        // 8j + 2*quad + (e & 1).
        hopper::wgmma_wait<0>();
        release(held);
        held = -1;
#pragma unroll
        for (int i = 0; i < 32; ++i) hopper::fence_regs(acc[i]);
        const long long docA = row0 + (long long)sub * kStride + rA;
        const bool validA = docA < n_docs, validB = docA + 8 < n_docs;
        const float deadA = scA <= 0.0f ? kDead : -0.0f;  // -0.0: x + -0.0 == x, sign of zero kept
        const float deadB = scB <= 0.0f ? kDead : -0.0f;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const bool rowB = (i & 2) != 0;
          const float scaled = __fmul_rn(acc[i], rowB ? scB : scA);
          const float score = !(rowB ? validB : validA) ? -INFINITY
                              : kDeadRows ? __fadd_rn(scaled, rowB ? deadB : deadA)
                                          : scaled;
          if (score > best[i]) {
            best[i] = score;
            off[i] = sub;
          }
        }
      }

      const long long out_ld = (long long)ntiles * kLanes;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qi = q0 + 8 * (i >> 2) + 2 * quad + (i & 1);
        if (qi >= nq) continue;
        const int lane_out = (i & 2) ? rB : rA;
        float packed = -INFINITY;
        if (isfinite(best[i]))
          packed = __uint_as_float((__float_as_uint(best[i]) & 0xFFFFFFF0u) | (unsigned)off[i]);
        out[qi * out_ld + (long long)blk * kLanes + lane_out] = packed;
      }
    }  // groups
  }
}

template <int kDocBlock, bool kDeadRows>
cudaError_t launch(const CUtensorMap& v_map, const void* q, const void* scales, void* out, int nq,
                   int h, int ntiles, long long n_docs, int stages, size_t smem,
                   cudaStream_t stream) {
  auto kernel = dense_binmax_kernel<kDocBlock, kDeadRows>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // persistent: one CTA per SM, shared among the query tiles
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int qtiles = (nq + kTileQ - 1) / kTileQ;
  const int per_tile = sms / qtiles > 1 ? sms / qtiles : 1;
  const dim3 grid(per_tile < ntiles ? per_tile : ntiles, qtiles);
  kernel<<<grid, kThreads, smem, stream>>>(v_map, static_cast<const __nv_bfloat16*>(q),
                                           static_cast<const float*>(scales),
                                           static_cast<float*>(out), nq, h, ntiles, n_docs, stages);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// q: [nq, h] bf16; v: [nblocks * doc_block, h] int8; scales:
// [nblocks * doc_block] f32; out: [nq, nblocks * doc_block / 16] f32; all
// contiguous, q and v 16-byte aligned.  doc_block is 2048, 4096 or 8192;
// dead_rows != 0 adds the dead-row term (K2), 0 leaves it out (the no-mask
// variant).  Requires h % 16 == 0, 16 <= h <= 1024, nq >= 1, nblocks >= 1.
extern "C" int dense_binmax(const void* q, const void* v, const void* scales, void* out, int nq,
                            int h, int nblocks, int doc_block, int dead_rows, long long n_docs,
                            void* stream) {
  if (h % 16 != 0 || h < 16 || h > 1024 || nq < 1 || nblocks < 1 ||
      (nq + kTileQ - 1) / kTileQ > 65535 ||
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long ntiles = (long long)nblocks * (doc_block / kMinDocBlock);
  const long long n_pad = (long long)nblocks * doc_block;
  if (ntiles > 0x7FFFFFFF || n_pad > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  CUtensorMap v_map;
  const cuuint64_t dims[2] = {(cuuint64_t)h, (cuuint64_t)n_pad};
  const cuuint64_t strides[1] = {(cuuint64_t)h};
  const cuuint32_t box[2] = {kKC, kLanes};
  cudaError_t err = hopper::encode_map(&v_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, v, dims, strides, box);
  if (err != cudaSuccess) return (int)err;
  const int stages = ring_stages(h);
  const size_t smem = hopper::kAtomAlign + (size_t)groups(h) * kGroupBytes +
                      (size_t)stages * kStageBytes + kBarBytes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int t = (int)ntiles;
  switch (doc_block * 2 + (dead_rows ? 1 : 0)) {
    case 2048 * 2 + 1: err = launch<2048, true>(v_map, q, scales, out, nq, h, t, n_docs, stages, smem, s); break;
    case 2048 * 2: err = launch<2048, false>(v_map, q, scales, out, nq, h, t, n_docs, stages, smem, s); break;
    case 4096 * 2 + 1: err = launch<4096, true>(v_map, q, scales, out, nq, h, t, n_docs, stages, smem, s); break;
    case 4096 * 2: err = launch<4096, false>(v_map, q, scales, out, nq, h, t, n_docs, stages, smem, s); break;
    case 8192 * 2 + 1: err = launch<8192, true>(v_map, q, scales, out, nq, h, t, n_docs, stages, smem, s); break;
    case 8192 * 2: err = launch<8192, false>(v_map, q, scales, out, nq, h, t, n_docs, stages, smem, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" const char* dense_binmax_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
