// Masked multi-head attention, forward and backward, on Hopper (sm_90a):
//   out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h] * scale + bias[b, i, j]) v[b, j, h]
// with bias = 0 where key j is allowed for query i and -1e9 elsewhere.  Key j
// is allowed when mask[b, j] > 0 and, for packed rows, seg[b, i] == seg[b, j]
// (pairs packed into one row attend only within their own segment).  The
// bias is added in f32 after the scale, two roundings (no fused multiply-
// add), as the plain version adds it; so a query with no allowed key
// softmaxes uniformly over the row's keys instead of giving NaN, and keys
// past the row's length L take no part.
//
// Kernels (bf16 is the path serving and training run; f32 is the
// reference-precision path, scalar FMAs, kept as the first port wrote it):
//
// FA, fa_forward_kernel (bf16) / attention_f32_kernel: replaces the TPU
// kernel behind the JAX package's `flash` attention form
// (fusion_tpu/models/encoder.py:217, SelfAttention's call of
// jax.experimental.pallas.ops.tpu.flash_attention, whose forward is the
// pl.pallas_call at flash_attention.py:758; segment ids there, an additive
// bias here).  The main path calls it in every layer of the cross-encoder's
// packed rerank ([128, 256, 12, 64]) and of the query encoders ([B, 32, 12,
// 64]), and training runs it per layer, twice under remat ([1024, 256, 12,
// 64], one layer's doc call of the ColBERT bench step).
//   Bound: 4 L^2 d operations per (row, head) against 4 L d bf16 values
//   moved (q, k, v read, out written): ~64 operations a byte at L 256,
//   under the card's ~295, so device memory bounds it: 201 MB, 0.060 ms at
//   the packed shape; 1.61 GB, 0.481 ms at the bench doc shape (operations
//   0.208 ms).
//   Residual mode: the instantiation that also writes each query row's f32
//   m (max of its biased logits) and l (sum of exp(logit - m)), [B, H, L],
//   from which the backward recomputes P (JAX's forward saves l and m for
//   the same purpose, flash_attention.py:234-252; the pair, not their
//   log-sum-exp, because m + log(l) rounds away log(l) beside the -1e9 bias
//   of a query with no allowed key).  The inference call is the
//   instantiation without it, so serving pays nothing for it, and both run
//   the same arithmetic: their outputs are bit-equal.
//
// FA-bwd: replaces the TPU kernels of JAX's flash-attention backward, the
// dK/dV pallas_call at flash_attention.py:1121 and the dQ pallas_call at
// :1456, reached through _flash_attention_bwd (:254-318) when a dropout-0
// model trains in the flash form.  Three launches: rowdot_kernel (D =
// rowsum(dO o O) in f32, one pass over dO and O; JAX computes its di outside
// its kernels, :273-275), fa_dkv_kernel (a block per 64 keys walking the
// query tiles) and fa_dq_kernel (a block per 64 queries walking the key
// tiles); each recomputes S and dP, so none needs an atomic and every
// launch gives the same bits.
//   Bound: five L^2 d products, 10 L^2 d operations, against 8 L d bf16
//   values moved (q, k, v, out, dO read; dq, dk, dv written) and the f32
//   residuals: ~160 operations a byte at L 256, so device memory bounds it:
//   3.2 GB, 0.969 ms at the bench doc shape (operations 0.52 ms); 0.40 GB,
//   0.121 ms at the packed shape.
//
// Design of the bf16 kernels (FlashAttention-3's shape).  A block is one
// consumer warpgroup that owns 64 rows (queries; keys for dK/dV) and one
// producer warpgroup, and several blocks share an SM (FA and dQ three,
// with 136 registers a consumer thread; dK/dV two, with 216), so one
// block's prologue, TMA latency and epilogue overlap another's products;
// setmaxnreg hands the producer's registers to the consumer.  The shape
// first written, two consumer warpgroups of 64 rows (128 a block, one block
// per SM, 232 registers), read slower for both directions at the packed and
// bench doc shapes (tools/attention_ab.py, PERF.md).  Before the split
// every thread loads the row's key mask and segment ids into shared memory
// once, and the block decides which walk tiles it computes (the skip rule
// below), while its own tiles already load by TMA.  One producer thread then
// streams those walk tiles through a ring of 3 (FA, dQ) or 4 (dK/dV) stages
// on mbarriers (full: the bytes landed; empty: every consumer warp is
// done), straight from the
// strided views of the fused qkv projection: each operand is a 4-D tensor
// map (64 elements, heads, L, B) with the view's byte strides and a box of
// one head's 64 rows, written under the 128-byte swizzle; rows past L read
// as zeros.  Walk tiles are 64 rows: S of 64 keys is 32 registers a thread
// beside the 32 of the accumulator, and a row of 256 is four tiles.  The
// consumer's walk is software-pipelined (consume()): a tile's products from
// registers are issued, then the next tile's products from shared memory
// behind them, so the tensor cores run both back to back before the next
// elementwise step.  Each kernel is built twice, for packed rows (segment
// ids) and without, and a key's mask is kept as its bias (0, -1e9, or -inf
// past the row), so a logit without segments is a multiply and an add.
//   FA: per key tile each consumer forms S = Q.K^T by wgmma m64n64k16 from
//   shared memory (both K-major) into registers, scales and biases it there,
//   and runs the online softmax in registers: a query row lives in a quad
//   of lanes, so a row max is two shuffles, and each lane keeps a partial
//   row sum (the quad is summed once, at the end).  P is rounded to bf16 in
//   registers and, as the register A operand of an RS wgmma, multiplies the
//   V tile read MN-major (the transpose-B immediate), accumulating into O,
//   which stays in registers (32 f32 a thread) and is rescaled there.  The
//   epilogue normalises O, writes it as bf16 into the consumer's own Q tile
//   (free by then) in the swizzled layout, and stores it with one TMA
//   store; in residual mode the quad's first lane writes m and l.
//   Removes the first kernel's six costs: the f32 accumulator in shared
//   memory with its 32-way bank conflicts (now registers); S and P.V
//   through shared memory (registers); the serial two-lanes-per-row softmax
//   (a quad per row, 16 values a lane); synchronous loads (TMA ring, K and V
//   in flight ahead of the products); three 4-warp blocks per SM doing
//   their own loads (three blocks, each a consumer warpgroup fed by a
//   producer); wmma 16x16x16 (wgmma).  K and V are read once per 64
//   queries, from L2 after the first block of a (row, head).
//   dQ: the same skeleton over the key tiles, with Q and dO as the own
//   tiles: S = Q.K^T and dP = dO.V^T by SS wgmma, P = exp(s - m) * (1 / l)
//   with 1 / l once per row (not a division per pair), dS = P o (dP - D)
//   rounded to bf16 in registers, dQ += dS.K by RS wgmma with K read
//   MN-major; dQ stays in registers and, times scale, goes out through the
//   Q tile by TMA into plane 0 of the [B, L, 3, H, 64] buffer.
//   dK/dV: the block owns 64 keys (K and V its own tiles) and walks the
//   query tiles; a stage holds the Q and dO tiles by TMA and the tile's m,
//   1 / l and D, which the producer warp's 32 lanes load and store (the
//   stage's full barrier counts their 32 arrivals beside the TMA bytes).
//   S^T = K.Q^T and dP^T = V.dO^T by SS wgmma (all four operands K-major as
//   stored), P^T and dS^T in registers rounded to bf16 as the A operands of
//   dV += P^T.dO and dK += dS^T.Q (RS, dO and Q read MN-major); dK, dV stay
//   in registers over the walk and leave through the K and V tiles by TMA
//   into planes 1 and 2.
//   Removes the first backward's five costs: S^T / dP^T and P / dS through
//   shared memory (registers); P formed with an expf and an exact division
//   per pair in both kernels (exp2 and a multiply by 1 / l); synchronous
//   loads (TMA ring); two blocks of 4 warps per SM doing their own loads
//   (three dQ or two dK/dV blocks, each a consumer warpgroup fed by a
//   producer); D from two f32 copies of dO and O (rowdot_kernel reads the
//   bf16 tensors once).
//
// Tile skipping (all kernels): a key tile that no query of a 64-query tile
// may attend adds exactly nothing to a query that may attend some key of
// its row (its terms are exp(-1e9 + x - m) = 0, or are wiped by the rescale
// exp(-1e9 - m) = 0 when they came first; in the backward its P, and so its
// dS, are exactly 0), so such pairs of tiles are skipped, bit for bit, when
// every query of the query tile has an allowed key: packed, a query is real
// (its own key is allowed); otherwise, the row has one real key.  A query
// with no allowed key averages over all keys, so its tile skips nothing.
// The bf16 kernels decide per block (64 own rows) and load only the walk
// tiles they compute; with segments they compute a tile pair whose segment
// ranges meet (plan_tiles), which is exact for the packed rows' contiguous
// segments and adds nothing otherwise.
//
// Later work: a cluster of the key-tile blocks of one (row, head) reducing
// dQ through distributed shared memory in a fixed order, so one pass forms
// dQ beside dK / dV; intra-warpgroup overlap of the softmax with the next
// tile's products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kHd = 64;  // head dim
constexpr float kMaskedBias = -1e9f;

// ===========================================================================
// f32: one block of four warps per (row, head, 64-query or 64-key tile),
// tiles staged in shared memory with 16-byte loads, scalar f32 FMAs (the f32
// plain version is exact f32).

constexpr int kRows = 64;     // queries per block
constexpr int kKeys = 64;     // keys per tile
constexpr int kWarps = 4;     // 16 queries each
constexpr int kThreads = kWarps * 32;
constexpr int kSPitch = kKeys + 4;  // f32 score rows
constexpr int kPitch = kHd + 4;     // f32 tile rows

constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

// shared memory: Q, K, V tiles; per warp its scores and f32 output
// accumulator; the key tile's mask and segments
struct Smem {
  static constexpr size_t tile = align128(sizeof(float) * kRows * kPitch);
  static constexpr size_t scores = align128(sizeof(float) * kWarps * 16 * kSPitch);
  static constexpr size_t acc = align128(sizeof(float) * kWarps * 16 * kHd);
  static constexpr size_t keys = align128(sizeof(int) * (2 * kKeys + kRows));
  static constexpr size_t total = 3 * tile + scores + acc + keys;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;          // contiguous [B, L, H, 64]
  float* m_out;       // residual mode: [B, H, L] row max of the biased logits, or null
  float* l_out;       // residual mode: [B, H, L] sum of exp(logit - max), or null
  const int* mask;    // [B, L]
  const int* seg;     // [B, L] or null
  long long sq[3];    // q strides in elements: batch, position, head
  long long sk[3];
  long long sv[3];
  long long batch;
  int length, heads;
  float scale;
};

// rows [row0, row0 + 64) of a [L, 64] slice with row stride `stride` into a
// shared tile; rows past `length` are zeros
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long stride, int row0, int length) {
  constexpr int kPerRow = kHd / 4;
  for (int i = threadIdx.x; i < kRows * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * 4;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < length) val = __ldg(reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * stride + c));
    *reinterpret_cast<uint4*>(dst + r * kPitch + c) = val;
  }
}

// the row holds a real key
__device__ __forceinline__ bool row_has_key(const int* mask_b, int length) {
  bool any = false;
  for (int i = threadIdx.x; i < length; i += kThreads) any = any || mask_b[i] > 0;
  return __syncthreads_or(any);
}

// every query of [q0, q0 + 64) has an allowed key; `row_key`: row_has_key
// (read only without segments)
__device__ __forceinline__ bool queries_have_keys(const int* mask_b, const int* seg_b, int q0, int length,
                                                  bool row_key) {
  bool ok = row_key;
  if (seg_b) {
    for (int i = threadIdx.x; i < kRows; i += kThreads) ok = ok && (q0 + i >= length || mask_b[q0 + i] > 0);
  }
  return __syncthreads_and(ok);
}

// some (query, key) pair of the two tiles is allowed: two threads per query
// row, 32 keys each; kmask_s: 1 real, 0 pad, -1 past the row
__device__ __forceinline__ bool tile_has_pair(const int* kmask_s, const int* kseg_s, const int* qseg_s,
                                              bool segments) {
  const int qs = qseg_s[threadIdx.x >> 1];
  bool any = false;
#pragma unroll 8
  for (int c = 0; c < 32; ++c) {
    const int j = (threadIdx.x & 1) * 32 + c;
    any = any || (kmask_s[j] > 0 && (!segments || kseg_s[j] == qs));
  }
  return __syncthreads_or(any);
}

// the key tile's mask (1 real, 0 pad, -1 past the row) and segments
__device__ __forceinline__ void load_key_ids(int* kmask_s, int* kseg_s, const int* mask_b, const int* seg_b, int k0,
                                             int length) {
  if (threadIdx.x < kKeys) {
    const int key = k0 + threadIdx.x;
    kmask_s[threadIdx.x] = key < length ? (mask_b[key] > 0 ? 1 : 0) : -1;
    kseg_s[threadIdx.x] = (seg_b && key < length) ? seg_b[key] : 0;
  }
}

// kResiduals: also write each query row's m and l
template <bool kResiduals>
__global__ void __launch_bounds__(kThreads) attention_f32_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* k_s = reinterpret_cast<float*>(smem + Smem::tile);
  float* v_s = reinterpret_cast<float*>(smem + 2 * Smem::tile);
  float* s_all = reinterpret_cast<float*>(smem + 3 * Smem::tile);
  float* o_all = reinterpret_cast<float*>(smem + 3 * Smem::tile + Smem::scores);
  int* kmask_s = reinterpret_cast<int*>(smem + 3 * Smem::tile + Smem::scores + Smem::acc);
  int* kseg_s = kmask_s + kKeys;
  int* qseg_s = kseg_s + kKeys;

  const int L = p.length;
  const int n_qt = (L + kRows - 1) / kRows;
  const int qt = (int)(blockIdx.x % n_qt);
  const long long bh = blockIdx.x / n_qt;
  const int h = (int)(bh % p.heads);
  const long long b = bh / p.heads;
  const int q0 = qt * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane >> 1, half = lane & 1;  // this lane: query row r of its warp, key / dim half `half`
  const int qpos = q0 + warp * 16 + r;
  float* s_w = s_all + warp * 16 * kSPitch;
  float* o_w = o_all + warp * 16 * kHd;

  const float* qg = static_cast<const float*>(p.q) + b * p.sq[0] + h * p.sq[2];
  const float* kg = static_cast<const float*>(p.k) + b * p.sk[0] + h * p.sk[2];
  const float* vg = static_cast<const float*>(p.v) + b * p.sv[0] + h * p.sv[2];
  const int* mask_b = p.mask + b * L;
  const int* seg_b = p.seg ? p.seg + b * L : nullptr;
  const int qseg = (seg_b && qpos < L) ? seg_b[qpos] : 0;

  load_tile(q_s, qg, p.sq[1], q0, L);
#pragma unroll
  for (int c = 0; c < 32; ++c) o_w[r * kHd + half * 32 + c] = 0.f;
  if (threadIdx.x < kRows) {
    const int qi = q0 + threadIdx.x;
    qseg_s[threadIdx.x] = (seg_b && qi < L) ? seg_b[qi] : 0;
  }
  const bool may_skip = queries_have_keys(mask_b, seg_b, q0, L, seg_b ? true : row_has_key(mask_b, L));

  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < L; k0 += kKeys) {
    __syncthreads();  // every warp is done with the previous K / V tile
    load_key_ids(kmask_s, kseg_s, mask_b, seg_b, k0, L);
    __syncthreads();
    if (may_skip && !tile_has_pair(kmask_s, kseg_s, qseg_s, seg_b != nullptr)) continue;
    load_tile(k_s, kg, p.sk[1], k0, L);
    load_tile(v_s, vg, p.sv[1], k0, L);
    __syncthreads();

    // raw scores q . k of the warp's 16 queries x 64 keys
    const float* qrow = q_s + (warp * 16 + r) * kPitch;
    for (int c = 0; c < 32; ++c) {
      const float* krow = k_s + (half * 32 + c) * kPitch;
      float acc = 0.f;
#pragma unroll 16
      for (int d = 0; d < kHd; ++d) acc = fmaf(qrow[d], krow[d], acc);
      s_w[r * kSPitch + half * 32 + c] = acc;
    }
    __syncwarp();

    // online softmax over this lane's 32 keys of row r
    float sv[32];
    float tile_max = -INFINITY;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int j = half * 32 + c;
      const int km = kmask_s[j];
      if (km < 0) {
        sv[c] = -INFINITY;
      } else {
        const bool ok = km > 0 && (seg_b == nullptr || kseg_s[j] == qseg);
        // two roundings, as the plain version's scale and bias (no fused multiply-add)
        sv[c] = __fadd_rn(__fmul_rn(s_w[r * kSPitch + j], p.scale), ok ? 0.f : kMaskedBias);
      }
      tile_max = fmaxf(tile_max, sv[c]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    const float m_new = fmaxf(m, tile_max);  // finite: key k0 < L lies in the tile
    const float alpha = expf(m - m_new);     // 0 on the first tile
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float e = expf(sv[c] - m_new);
      sum += e;
      s_w[r * kSPitch + half * 32 + c] = e;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * alpha + sum;
    m = m_new;
    __syncwarp();

    // o = o * alpha + P . V for the lane's 32 output dims of row r
    float acc[32];
#pragma unroll
    for (int c = 0; c < 32; ++c) acc[c] = 0.f;
    for (int j = 0; j < kKeys; ++j) {
      const float pj = s_w[r * kSPitch + j];
#pragma unroll
      for (int c = 0; c < 32; ++c) acc[c] = fmaf(pj, v_s[j * kPitch + half * 32 + c], acc[c]);
    }
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      float& o = o_w[r * kHd + half * 32 + c];
      o = o * alpha + acc[c];
    }
  }

  if (qpos < L) {
    if (kResiduals && half == 0) {  // the backward's P = exp(s - m) / l
      const long long st = (b * p.heads + h) * L + qpos;
      p.m_out[st] = m;
      p.l_out[st] = l;
    }
    const float inv = 1.f / l;
    float* dst = static_cast<float*>(p.out) + ((b * L + qpos) * p.heads + h) * kHd + half * 32;
#pragma unroll
    for (int c = 0; c < 32; ++c) dst[c] = o_w[r * kHd + half * 32 + c] * inv;
  }
}

// The f32 backward, from P = exp(s - m) / l recomputed from the forward's
// residuals, D = rowsum(dO o O) and dS = P o (dP - D), dP = dO . V^T:
//   dV = P^T . dO,  dK = scale * dS^T . Q,  dQ = scale * dS . K,
// in two kernels: attention_dkv_f32_kernel owns 64 keys and walks the query
// tiles, attention_dq_f32_kernel owns 64 queries and walks the key tiles.

// shared memory of both f32 backward kernels: four [64, 64] tiles; per warp
// S and dP; the query tile's m, l, D; segment and mask ids
struct BwdSmem {
  static constexpr size_t tile = Smem::tile;
  static constexpr size_t scores = Smem::scores;
  static constexpr size_t stats = align128(sizeof(float) * 3 * kRows);
  static constexpr size_t ints = align128(sizeof(int) * (kRows + 2 * kKeys));
  static constexpr size_t total = 4 * tile + 2 * scores + stats + ints;
};

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;   // [B, L, H, 64] view, strides in so
  const float* m;     // [B, H, L] forward residuals
  const float* l;
  const float* d;     // [B, H, L] rowsum(dO o O)
  const int* mask;    // [B, L]
  const int* seg;     // [B, L] or null
  void* dqkv;         // contiguous [B, L, 3, H, 64]: dq, dk, dv
  long long sq[3];
  long long sk[3];
  long long sv[3];
  long long so[3];
  long long batch;
  int length, heads;
  float scale;
};

struct BwdSmemPtrs {
  float* s;
  float* dp;
  float* m;
  float* l;
  float* d;
  int* qseg;
  int* kmask;
  int* kseg;
};

__device__ __forceinline__ BwdSmemPtrs bwd_smem(unsigned char* smem) {
  unsigned char* rest = smem + 4 * BwdSmem::tile;
  BwdSmemPtrs ptr;
  ptr.s = reinterpret_cast<float*>(rest);
  ptr.dp = reinterpret_cast<float*>(rest + BwdSmem::scores);
  ptr.m = reinterpret_cast<float*>(rest + 2 * BwdSmem::scores);
  ptr.l = ptr.m + kRows;
  ptr.d = ptr.l + kRows;
  ptr.qseg = reinterpret_cast<int*>(rest + 2 * BwdSmem::scores + BwdSmem::stats);
  ptr.kmask = ptr.qseg + kRows;
  ptr.kseg = ptr.kmask + kKeys;
  return ptr;
}

// P and dS of one (query, key) pair from its raw score q . k and dP, with
// the forward's roundings of the logit (no fused multiply-add on the bias)
__device__ __forceinline__ void grad_pair(float raw, float dp, bool allowed, float scale, float m, float l, float d,
                                          float& pr, float& ds) {
  const float s = __fadd_rn(__fmul_rn(raw, scale), allowed ? 0.f : kMaskedBias);
  pr = __fdiv_rn(expf(s - m), l);
  ds = __fmul_rn(pr, __fsub_rn(dp, d));
}

// a warp's [16, 64] f32 result rows (lane: row r, 32 columns from c0) times
// `scale` into row `pos` of one of dqkv's three [B, L, H, 64] planes
__device__ __forceinline__ void write_grad_row(const BwdParams& p, long long b, int pos, int which, int h, int c0,
                                               const float* row, float scale) {
  float* dst = static_cast<float*>(p.dqkv) + (((b * p.length + pos) * 3 + which) * p.heads + h) * kHd + c0;
#pragma unroll
  for (int c = 0; c < 32; ++c) dst[c] = row[c] * scale;
}

// dK and dV of one (row, head, 64-key tile); each lane keeps its key row's
// dK, dV halves in registers over the query tiles
__global__ void __launch_bounds__(kThreads) attention_dkv_f32_kernel(BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem);
  float* v_s = reinterpret_cast<float*>(smem + BwdSmem::tile);
  float* q_s = reinterpret_cast<float*>(smem + 2 * BwdSmem::tile);
  float* o_s = reinterpret_cast<float*>(smem + 3 * BwdSmem::tile);  // dO
  const BwdSmemPtrs sp = bwd_smem(smem);

  const int L = p.length;
  const int n_kt = (L + kKeys - 1) / kKeys;
  const int kt = (int)(blockIdx.x % n_kt);
  const long long bh = blockIdx.x / n_kt;
  const int h = (int)(bh % p.heads);
  const long long b = bh / p.heads;
  const int k0 = kt * kKeys;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane >> 1, half = lane & 1;  // this lane: key row r of its warp, query / dim half `half`
  const int key = k0 + warp * 16 + r;
  float* s_w = sp.s + warp * 16 * kSPitch;    // S^T, then P^T
  float* dp_w = sp.dp + warp * 16 * kSPitch;  // dP^T, then dS^T

  const float* qg = static_cast<const float*>(p.q) + b * p.sq[0] + h * p.sq[2];
  const float* kg = static_cast<const float*>(p.k) + b * p.sk[0] + h * p.sk[2];
  const float* vg = static_cast<const float*>(p.v) + b * p.sv[0] + h * p.sv[2];
  const float* og = static_cast<const float*>(p.dout) + b * p.so[0] + h * p.so[2];
  const long long st = (b * p.heads + h) * L;
  const int* mask_b = p.mask + b * L;
  const int* seg_b = p.seg ? p.seg + b * L : nullptr;
  const bool key_real = key < L && mask_b[key] > 0;
  const int kseg = (seg_b && key < L) ? seg_b[key] : 0;

  load_tile(k_s, kg, p.sk[1], k0, L);
  load_tile(v_s, vg, p.sv[1], k0, L);
  load_key_ids(sp.kmask, sp.kseg, mask_b, seg_b, k0, L);
  const bool row_key = seg_b ? true : row_has_key(mask_b, L);
  __syncthreads();

  float dk_f[32], dv_f[32];
#pragma unroll
  for (int c = 0; c < 32; ++c) dk_f[c] = dv_f[c] = 0.f;

  for (int q0 = 0; q0 < L; q0 += kRows) {
    __syncthreads();  // every warp is done with the previous query tile
    if (threadIdx.x < kRows) {
      const int i = q0 + threadIdx.x;
      const bool in = i < L;
      sp.qseg[threadIdx.x] = (seg_b && in) ? seg_b[i] : 0;
      sp.m[threadIdx.x] = in ? p.m[st + i] : 0.f;
      sp.l[threadIdx.x] = in ? p.l[st + i] : 1.f;
      sp.d[threadIdx.x] = in ? p.d[st + i] : 0.f;
    }
    __syncthreads();
    if (queries_have_keys(mask_b, seg_b, q0, L, row_key) &&
        !tile_has_pair(sp.kmask, sp.kseg, sp.qseg, seg_b != nullptr))
      continue;
    load_tile(q_s, qg, p.sq[1], q0, L);
    load_tile(o_s, og, p.so[1], q0, L);
    __syncthreads();

    // S^T = K_w . Q^T and dP^T = V_w . dO^T: the warp's 16 keys x 64 queries
    const float* krow = k_s + (warp * 16 + r) * kPitch;
    const float* vrow = v_s + (warp * 16 + r) * kPitch;
    for (int c = 0; c < 32; ++c) {
      const int il = half * 32 + c;
      const float* qrow = q_s + il * kPitch;
      const float* orow = o_s + il * kPitch;
      float acc_s = 0.f, acc_p = 0.f;
#pragma unroll 16
      for (int d = 0; d < kHd; ++d) {
        acc_s = fmaf(krow[d], qrow[d], acc_s);
        acc_p = fmaf(vrow[d], orow[d], acc_p);
      }
      s_w[r * kSPitch + il] = acc_s;
      dp_w[r * kSPitch + il] = acc_p;
    }
    __syncwarp();

    // P^T and dS^T of the lane's key row r, queries [half * 32, half * 32 + 32)
#pragma unroll 4
    for (int c = 0; c < 32; ++c) {
      const int il = half * 32 + c;
      float pr = 0.f, ds = 0.f;
      if (q0 + il < L && key < L) {
        const bool ok = key_real && (seg_b == nullptr || kseg == sp.qseg[il]);
        grad_pair(s_w[r * kSPitch + il], dp_w[r * kSPitch + il], ok, p.scale, sp.m[il], sp.l[il], sp.d[il], pr, ds);
      }
      s_w[r * kSPitch + il] = pr;
      dp_w[r * kSPitch + il] = ds;
    }
    __syncwarp();

    // dV += P^T . dO and dK += dS^T . Q over this tile's 64 queries
    for (int il = 0; il < kRows; ++il) {
      const float pr = s_w[r * kSPitch + il], ds = dp_w[r * kSPitch + il];
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        dv_f[c] = fmaf(pr, o_s[il * kPitch + half * 32 + c], dv_f[c]);
        dk_f[c] = fmaf(ds, q_s[il * kPitch + half * 32 + c], dk_f[c]);
      }
    }
  }

  if (key < L) {
    write_grad_row(p, b, key, 1, h, half * 32, dk_f, p.scale);
    write_grad_row(p, b, key, 2, h, half * 32, dv_f, 1.f);
  }
}

// dQ of one (row, head, 64-query tile); each lane keeps its query row's dQ
// half in registers over the key tiles
__global__ void __launch_bounds__(kThreads) attention_dq_f32_kernel(BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* o_s = reinterpret_cast<float*>(smem + BwdSmem::tile);  // dO
  float* k_s = reinterpret_cast<float*>(smem + 2 * BwdSmem::tile);
  float* v_s = reinterpret_cast<float*>(smem + 3 * BwdSmem::tile);
  const BwdSmemPtrs sp = bwd_smem(smem);

  const int L = p.length;
  const int n_qt = (L + kRows - 1) / kRows;
  const int qt = (int)(blockIdx.x % n_qt);
  const long long bh = blockIdx.x / n_qt;
  const int h = (int)(bh % p.heads);
  const long long b = bh / p.heads;
  const int q0 = qt * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane >> 1, half = lane & 1;  // this lane: query row r of its warp, key / dim half `half`
  const int qpos = q0 + warp * 16 + r;
  float* s_w = sp.s + warp * 16 * kSPitch;    // S, then dS
  float* dp_w = sp.dp + warp * 16 * kSPitch;  // dP

  const float* qg = static_cast<const float*>(p.q) + b * p.sq[0] + h * p.sq[2];
  const float* kg = static_cast<const float*>(p.k) + b * p.sk[0] + h * p.sk[2];
  const float* vg = static_cast<const float*>(p.v) + b * p.sv[0] + h * p.sv[2];
  const float* og = static_cast<const float*>(p.dout) + b * p.so[0] + h * p.so[2];
  const long long st = (b * p.heads + h) * L;
  const int* mask_b = p.mask + b * L;
  const int* seg_b = p.seg ? p.seg + b * L : nullptr;
  const bool in = qpos < L;
  const int qseg = (seg_b && in) ? seg_b[qpos] : 0;
  const float m_i = in ? p.m[st + qpos] : 0.f;
  const float l_i = in ? p.l[st + qpos] : 1.f;
  const float d_i = in ? p.d[st + qpos] : 0.f;

  load_tile(q_s, qg, p.sq[1], q0, L);
  load_tile(o_s, og, p.so[1], q0, L);
  if (threadIdx.x < kRows) {
    const int i = q0 + threadIdx.x;
    sp.qseg[threadIdx.x] = (seg_b && i < L) ? seg_b[i] : 0;
  }
  const bool may_skip = queries_have_keys(mask_b, seg_b, q0, L, seg_b ? true : row_has_key(mask_b, L));

  float dq_f[32];
#pragma unroll
  for (int c = 0; c < 32; ++c) dq_f[c] = 0.f;

  for (int k0 = 0; k0 < L; k0 += kKeys) {
    __syncthreads();  // every warp is done with the previous K / V tile
    load_key_ids(sp.kmask, sp.kseg, mask_b, seg_b, k0, L);
    __syncthreads();
    if (may_skip && !tile_has_pair(sp.kmask, sp.kseg, sp.qseg, seg_b != nullptr)) continue;
    load_tile(k_s, kg, p.sk[1], k0, L);
    load_tile(v_s, vg, p.sv[1], k0, L);
    __syncthreads();

    // S = Q_w . K^T and dP = dO_w . V^T: the warp's 16 queries x 64 keys
    const float* qrow = q_s + (warp * 16 + r) * kPitch;
    const float* orow = o_s + (warp * 16 + r) * kPitch;
    for (int c = 0; c < 32; ++c) {
      const int jl = half * 32 + c;
      const float* krow = k_s + jl * kPitch;
      const float* vrow = v_s + jl * kPitch;
      float acc_s = 0.f, acc_p = 0.f;
#pragma unroll 16
      for (int d = 0; d < kHd; ++d) {
        acc_s = fmaf(qrow[d], krow[d], acc_s);
        acc_p = fmaf(orow[d], vrow[d], acc_p);
      }
      s_w[r * kSPitch + jl] = acc_s;
      dp_w[r * kSPitch + jl] = acc_p;
    }
    __syncwarp();

    // dS of the lane's query row r, keys [half * 32, half * 32 + 32)
#pragma unroll 4
    for (int c = 0; c < 32; ++c) {
      const int jl = half * 32 + c;
      const int km = sp.kmask[jl];
      float pr = 0.f, ds = 0.f;
      if (in && km >= 0) {
        const bool ok = km > 0 && (seg_b == nullptr || sp.kseg[jl] == qseg);
        grad_pair(s_w[r * kSPitch + jl], dp_w[r * kSPitch + jl], ok, p.scale, m_i, l_i, d_i, pr, ds);
      }
      s_w[r * kSPitch + jl] = ds;
    }
    __syncwarp();

    // dQ += dS . K over this tile's 64 keys
    for (int jl = 0; jl < kKeys; ++jl) {
      const float ds = s_w[r * kSPitch + jl];
#pragma unroll
      for (int c = 0; c < 32; ++c) dq_f[c] = fmaf(ds, k_s[jl * kPitch + half * 32 + c], dq_f[c]);
    }
  }

  if (in) write_grad_row(p, b, qpos, 0, h, half * 32, dq_f, p.scale);
}

// ===========================================================================
// D = rowsum(dO o O) in f32, [B, H, L]: each (b, l, h) row of 64 is read as
// 16-byte loads by 8 (bf16) or 16 (f32) lanes, products summed in f32 and
// reduced by shuffles; dO is a [B, L, H, 64] view (strides in so), O the
// forward's contiguous output.
constexpr int kRowdotThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kRowdotThreads) rowdot_kernel(const T* __restrict__ dout, const T* __restrict__ out,
                                                               float* __restrict__ d, long long so0, long long so1,
                                                               long long so2, long long rows, int length, int heads) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int kLanes = kHd / kVec;    // lanes per row
  const long long gid = (long long)blockIdx.x * kRowdotThreads + threadIdx.x;
  const long long row = gid / kLanes;
  const int part = (int)(gid % kLanes);
  float acc = 0.f;
  long long b = 0;
  int l = 0, h = 0;
  if (row < rows) {
    h = (int)(row % heads);
    l = (int)((row / heads) % length);
    b = row / ((long long)heads * length);
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(dout + b * so0 + l * so1 + h * so2) + part);
    const uint4 c = __ldg(reinterpret_cast<const uint4*>(out + row * kHd) + part);
    const T* av = reinterpret_cast<const T*>(&a);
    const T* cv = reinterpret_cast<const T*>(&c);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      if constexpr (sizeof(T) == 2)
        acc = fmaf(__bfloat162float(av[e]), __bfloat162float(cv[e]), acc);
      else
        acc = fmaf(av[e], cv[e], acc);
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < rows && part == 0) d[(b * heads + h) * length + l] = acc;
}

// ===========================================================================
// bf16: warp-specialised wgmma / TMA kernels (see the header).

constexpr int kTile = 64;                       // rows of one TMA box, and of a block's own tile
constexpr int kTileBytes = kTile * kHd * 2;     // one swizzled [64, 64] bf16 tile: 8 KB
constexpr int kStatBytes = 1024;                // dK/dV stage: m, 1 / l, D of 64 queries (768 B), padded
constexpr int kBarBytes = 128;                  // the mbarriers: full, empty per stage, the own tiles'
constexpr int kMaxLength = 8192;                // the row ids' shared memory bound
constexpr int kBlockThreads = 256;              // a consumer warpgroup, then a producer warpgroup
constexpr float kLog2e = 1.4426950408889634f;

// A block shape: kMin blocks per SM (the launch bound: kCap registers a
// thread at launch), kS ring stages.  setmaxnreg hands the producer's
// registers to the consumer: kProducerRegs and kConsumerRegs out of kCap.
template <int kMin_, int kS_>
struct Shape {
  static constexpr int kMin = kMin_, kS = kS_;
  static constexpr int kCap = 65536 / (kBlockThreads * kMin) / 8 * 8;
  static constexpr int kProducerRegs = kMin > 2 ? 24 : 40;
  static constexpr int kConsumerRegs = (2 * kCap - kProducerRegs) / 8 * 8;
  static_assert(kCap <= 248 && kConsumerRegs <= 256 && kConsumerRegs >= kCap, "no registers to hand over");
};

using FwdShape = Shape<3, 3>;
using DqShape = Shape<3, 3>;   // three blocks per SM, 136 registers a consumer thread
using DkvShape = Shape<2, 4>;  // two blocks per SM, 216 registers a consumer thread

struct Bf16Args {
  float* m_out;      // forward residual mode: [B, H, L], or null
  float* l_out;
  const float* m;    // backward: the forward's residuals, [B, H, L]
  const float* l;
  const float* d;    // backward: rowsum(dO o O), [B, H, L]
  const int* mask;   // [B, L]
  const int* seg;    // [B, L] or null
  int length, heads;
  float scale;
};

__host__ __device__ constexpr int n_tiles(int length) { return (length + kTile - 1) / kTile; }

// shared memory past the tiles: the barriers, the row ids (int2 per
// position, padded to whole tiles) and the need flags (a byte per walk tile)
__host__ __device__ constexpr size_t ids_bytes(int length) {
  return kBarBytes + 8 * (size_t)n_tiles(length) * kTile + ((size_t)n_tiles(length) + 15) / 16 * 16;
}

__device__ __forceinline__ unsigned char* aligned_base(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + hopper::kAtomAlign - 1) &
                                          ~(uintptr_t)(hopper::kAtomAlign - 1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x in one instruction; results below 2^-126 flush to 0 (P's smallest
// values, which their bf16 rounding would keep as subnormals, add nothing
// within the tolerances)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ int4 lds_int4(const void* p) {
  const uint4 v = hopper::lds128(p);
  return make_int4((int)v.x, (int)v.y, (int)v.z, (int)v.w);
}

__device__ __forceinline__ float2 lds_f32x2(const void* p) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(hopper::smem_u32(p)) : "memory");
  return v;
}

// a key's bias before segments: 0 real, -1e9 pad, -inf past the row (its
// logit is then -inf whatever its score)
__device__ __forceinline__ float key_bias(int2 ki) { return __int_as_float(ki.x); }

// The block's prologue, every thread: kinfo[i] = (key_bias's bits, segment)
// for i < L and (-inf, 0) past it up to whole tiles; then need[w]: whether
// the block's own tile (64 rows from own0: queries when `own_queries`, else
// keys) and walk tile w are computed, by the skip rule of the header: an own
// tile wholly past L computes nothing; a pair is computed unless every
// query of its query tile has an allowed key and no (query, key) pair of
// the two tiles is allowed.  With segments the last test is whether the
// segment ranges of the tile's queries and real keys meet: disjoint ranges
// share no segment, so the skip is exact, and meeting ranges (the same
// segment, for the contiguous segments of packed rows) compute the pair,
// which adds nothing where no pair is allowed.  One warp per walk tile.
__device__ void plan_tiles(int2* kinfo, unsigned char* need, const int* mask_b, const int* seg_b, int L, int own0,
                           bool own_queries) {
  const int n_walk = n_tiles(L);
  for (int i = threadIdx.x; i < n_walk * kTile; i += blockDim.x)
    kinfo[i] = make_int2(__float_as_int(i < L ? (mask_b[i] > 0 ? 0.f : kMaskedBias) : -INFINITY),
                         i < L && seg_b ? seg_b[i] : 0);
  __syncthreads();
  bool any = false;
  for (int i = threadIdx.x; i < L; i += blockDim.x) any = any || key_bias(kinfo[i]) == 0.f;
  const bool row_key = __syncthreads_or(any);  // read only without segments
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  for (int w = warp; w < n_walk; w += nwarps) {
    const int q0 = own_queries ? own0 : w * kTile;
    const int k0 = own_queries ? w * kTile : own0;
    bool flag = false;
    if (own0 < L) {
      bool may_skip = row_key;
      if (seg_b) {
        bool real = true;
        for (int i = lane; i < kTile; i += 32) real = real && (q0 + i >= L || key_bias(kinfo[q0 + i]) == 0.f);
        may_skip = __all_sync(0xffffffffu, real);
      }
      bool pair = !may_skip;
      if (seg_b) {
        int qlo = INT_MAX, qhi = INT_MIN, klo = INT_MAX, khi = INT_MIN;
        for (int i = lane; i < kTile; i += 32) {
          if (q0 + i < L) {
            qlo = min(qlo, kinfo[q0 + i].y);
            qhi = max(qhi, kinfo[q0 + i].y);
          }
          const int2 ki = kinfo[k0 + i];  // past L: not real
          if (key_bias(ki) == 0.f) {
            klo = min(klo, ki.y);
            khi = max(khi, ki.y);
          }
        }
        qlo = __reduce_min_sync(0xffffffffu, qlo);
        qhi = __reduce_max_sync(0xffffffffu, qhi);
        klo = __reduce_min_sync(0xffffffffu, klo);
        khi = __reduce_max_sync(0xffffffffu, khi);
        pair = pair || (qlo <= khi && klo <= qhi);
      } else {
        for (int j = lane; j < kTile; j += 32) pair = pair || (k0 + j < L && key_bias(kinfo[k0 + j]) == 0.f);
      }
      flag = __any_sync(0xffffffffu, pair);
    }
    if (lane == 0) need[w] = flag ? 1 : 0;
  }
  __syncthreads();
}

// the first walk tile after w that the block computes (n_walk: none)
__device__ __forceinline__ int next_tile(const unsigned char* need, int w, int n_walk) {
  do ++w;
  while (w < n_walk && !need[w]);
  return w;
}

// the block's (b, h, first own row) from blockIdx.x: a block per (row,
// head, 64 rows)
struct BlockPos {
  int b, h, own0;
};

__device__ __forceinline__ BlockPos block_pos(const Bf16Args& a) {
  const int n_own = n_tiles(a.length);
  const long long bh = blockIdx.x / n_own;
  BlockPos pos;
  pos.own0 = (int)(blockIdx.x % n_own) * kTile;
  pos.h = (int)(bh % a.heads);
  pos.b = (int)(bh / a.heads);
  return pos;
}

// acc = A . B^T over the head dim: four m64n64k16 steps from two K-major tiles
__device__ __forceinline__ void product_ss(float* acc, const unsigned char* a_s, const unsigned char* b_s) {
#pragma unroll
  for (int kk = 0; kk < kHd / 16; ++kk)
    hopper::wgmma_m64n64k16_ss(acc, hopper::desc_sw128(a_s + kk * 32), hopper::desc_sw128(b_s + kk * 32), kk > 0);
}

// acc += P . T over the tile's 64 rows: P as register A fragments (p[kk]:
// k-step kk), T a [64, 64] tile read MN-major
__device__ __forceinline__ void product_rs(float* acc, const uint32_t (*p)[4], const unsigned char* t_s) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk)
    hopper::wgmma_m64n64k16_rs_mn(acc, p[kk], hopper::desc_mn_sw128(t_s + kk * 2 * hopper::kAtomAlign), 1);
}

template <int N>
__device__ __forceinline__ void fence_all(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) hopper::fence_regs(r[i]);
}

__device__ __forceinline__ void fence_all(uint32_t (*p)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(p[i][j])::"memory");
}

// frees a ring stage: one arrival per consumer warp, once its lanes are done
__device__ __forceinline__ void release(uint64_t* empty) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) hopper::mbar_arrive(empty);
}

// the accumulator's 32 values (rows g, g + 8 of each warp's 16; element i =
// 4j + e: row + 8 * (e >> 1), column 8j + 2t + (e & 1)) times `mul[row]` as
// bf16 into a [64, 64] tile under the 128-byte swizzle, for a TMA store
__device__ __forceinline__ void stage_bf16(unsigned char* tile, const float* acc, float mul0, float mul1) {
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = warp * 16 + g + 8 * hr;
      const float mul = hr ? mul1 : mul0;
      const uint32_t v = pack_bf16(acc[4 * j + 2 * hr] * mul, acc[4 * j + 2 * hr + 1] * mul);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(hopper::smem_u32(tile + row * 128 + ((j ^ (row & 7)) << 4) +
                                                                     t * 4)),
                   "r"(v)
                   : "memory");
    }
}

// the consumer's staged tiles out by TMA (one thread issues and waits until
// the copies have read them)
__device__ __forceinline__ void store_tiles(const CUtensorMap* map0, const unsigned char* t0,
                                            const CUtensorMap* map1, const unsigned char* t1, int h, int row, int b) {
  hopper::fence_proxy_async();
  hopper::named_barrier_sync(1, 128);
  if (threadIdx.x == 0) {
    hopper::tma_store_4d(map0, t0, 0, h, row, b);
    if (map1) hopper::tma_store_4d(map1, t1, 0, h, row, b);
    hopper::bulk_commit();
    hopper::bulk_wait_read<0>();
  }
}

// the logit of one (query, key) pair from its raw score: scale, then the
// key's bias (key_bias; with segments, -1e9 at least off the query's
// segment), two roundings
template <bool kSeg>
__device__ __forceinline__ float logit(float raw, float kbias, int kseg, int qseg, float scale) {
  float bias = kbias;
  if constexpr (kSeg) bias = kseg == qseg ? kbias : fminf(kbias, kMaskedBias);
  return __fadd_rn(__fmul_rn(raw, scale), bias);
}

// The shared memory of a kernel: the own tiles, the ring, then the
// barriers, the row ids and the need flags.
struct Layout {
  unsigned char* own;
  unsigned char* ring;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* own_full;
  int2* kinfo;
  unsigned char* need;
};

__device__ __forceinline__ Layout layout(unsigned char* raw, int own_tiles, int stages, int stage_bytes, int L) {
  Layout s;
  s.own = aligned_base(raw);
  s.ring = s.own + own_tiles * kTileBytes;
  s.full = reinterpret_cast<uint64_t*>(s.ring + stages * stage_bytes);
  s.empty = s.full + stages;
  s.own_full = s.empty + stages;
  s.kinfo = reinterpret_cast<int2*>(reinterpret_cast<unsigned char*>(s.full) + kBarBytes);
  s.need = reinterpret_cast<unsigned char*>(s.kinfo + n_tiles(L) * kTile);
  return s;
}

__host__ __device__ constexpr size_t smem_bytes(int own_tiles, int stages, int stage_bytes, int length) {
  return hopper::kAtomAlign + (size_t)own_tiles * kTileBytes + (size_t)stages * stage_bytes + ids_bytes(length);
}

// thread 0: the barriers (`full_count` arrivals a stage), then the own
// tiles' loads (at `row`, or row 0 for a tile wholly past L, never used),
// which run while the block plans
__device__ __forceinline__ void start_block(const Layout& s, int stages, int full_count, const CUtensorMap* m0,
                                            const CUtensorMap* m1, const BlockPos& pos, int L) {
  if (threadIdx.x != 0) return;
  for (int i = 0; i < stages; ++i) {
    hopper::mbar_init(&s.full[i], full_count);
    hopper::mbar_init(&s.empty[i], 4);  // one arrival per consumer warp
  }
  hopper::mbar_init(s.own_full, 1);
  hopper::fence_barrier_init();
  const int row = pos.own0 < L ? pos.own0 : 0;
  hopper::mbar_arrive_expect_tx(s.own_full, (m1 ? 2 : 1) * kTileBytes);
  hopper::tma_load_4d(s.own, m0, s.own_full, 0, pos.h, row, pos.b);
  if (m1) hopper::tma_load_4d(s.own + kTileBytes, m1, s.own_full, 0, pos.h, row, pos.b);
}

// the producer thread: each computed walk tile's two [64, 64] tiles by TMA
// into the ring (the stage's first 16 KB)
template <int kStages>
__device__ __forceinline__ void produce(const Layout& s, int stage_bytes, const CUtensorMap* m0,
                                        const CUtensorMap* m1, const BlockPos& pos, int n_walk) {
  int it = 0;
  for (int w = next_tile(s.need, -1, n_walk); w < n_walk; w = next_tile(s.need, w, n_walk), ++it) {
    const int st = it % kStages;
    hopper::mbar_wait(&s.empty[st], ((it / kStages) & 1) ^ 1);
    hopper::mbar_arrive_expect_tx(&s.full[st], 2 * kTileBytes);
    unsigned char* dst = s.ring + st * stage_bytes;
    hopper::tma_load_4d(dst, m0, &s.full[st], 0, pos.h, w * kTile, pos.b);
    hopper::tma_load_4d(dst + kTileBytes, m1, &s.full[st], 0, pos.h, w * kTile, pos.b);
  }
}

// The consumer's walk, software-pipelined: tile it's elementwise step and
// its register-A products run, then the next tile's shared-memory products
// are issued behind them, so the tensor cores run the two back to back;
// stage it is freed once both have completed.  `ss(stage, w)` issues the
// shared-memory products of walk tile w, `step(stage, w)` waits for
// nothing, reads their results and issues the register-A products.
template <int kStages, class SS, class Step>
__device__ __forceinline__ void consume(const Layout& s, int n_walk, SS ss, Step step) {
  int w = next_tile(s.need, -1, n_walk);
  if (w >= n_walk) return;
  hopper::mbar_wait(&s.full[0], 0);
  hopper::wgmma_fence();
  ss(0, w);
  hopper::wgmma_commit();
  for (int it = 0; w < n_walk; ++it) {
    const int st = it % kStages;
    hopper::wgmma_wait<0>();  // tile it's shared-memory products, tile it - 1's register-A products
    if (it > 0) release(&s.empty[(it - 1) % kStages]);
    step(st, w);  // ends with wgmma_fence and the register-A products issued
    hopper::wgmma_commit();
    w = next_tile(s.need, w, n_walk);
    if (w < n_walk) {
      const int nx = (it + 1) % kStages;
      hopper::mbar_wait(&s.full[nx], ((it + 1) / kStages) & 1);
      ss(nx, w);
      hopper::wgmma_commit();
    }
  }
  hopper::wgmma_wait<0>();
}

// ------------------------------------------------------------------ FA
// own tile: 64 queries (Q); walk: key tiles (K, V per stage)
constexpr int kKVStage = 2 * kTileBytes;

// kSeg: packed rows (segment ids given)
template <bool kResiduals, bool kSeg>
__global__ void __launch_bounds__(kBlockThreads, FwdShape::kMin)
    fa_forward_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap out_map,
                      const Bf16Args a) {
  using S = FwdShape;
  extern __shared__ unsigned char smem_raw[];
  const int L = a.length, n_walk = n_tiles(L);
  const Layout s = layout(smem_raw, 1, S::kS, kKVStage, L);
  const BlockPos pos = block_pos(a);
  const int* seg_b = a.seg ? a.seg + (long long)pos.b * L : nullptr;
  start_block(s, S::kS, 1, &q_map, nullptr, pos, L);
  plan_tiles(s.kinfo, s.need, a.mask + (long long)pos.b * L, seg_b, L, pos.own0, true);

  if (threadIdx.x >= 128) {
    // ------------------------------------------------------------ producer
    hopper::regs_dealloc<S::kProducerRegs>();
    if (threadIdx.x == 128) produce<S::kS>(s, kKVStage, &k_map, &v_map, pos, n_walk);
    return;
  }
  // ------------------------------------------------------------- consumer
  hopper::regs_alloc<S::kConsumerRegs>();
  const int warp = threadIdx.x / 32, t = threadIdx.x % 4;
  const int q0 = pos.own0;
  const int r0 = q0 + warp * 16 + (threadIdx.x % 32) / 4, r1 = r0 + 8;  // this thread's two query rows
  const int qs0 = (kSeg && r0 < L) ? s.kinfo[r0].y : 0;
  const int qs1 = (kSeg && r1 < L) ? s.kinfo[r1].y : 0;
  float o[32], sc[32];
  uint32_t pa[4][4];  // P in bf16: the A fragments of the 4 k-steps
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // l: this lane's partial row sums
  hopper::mbar_wait(s.own_full, 0);

  auto ss = [&](int st, int) {
    fence_all<32>(sc);
    product_ss(sc, s.own, s.ring + st * kKVStage);
  };
  auto step = [&](int st, int w) {
    fence_all<32>(sc);
    fence_all<32>(o);
    // logits and the tile's row maxima
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int4 ki = lds_int4(s.kinfo + w * kTile + 8 * j + 2 * t);  // (bias, seg) of keys 2t, 2t + 1
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float kb = __int_as_float((e & 1) ? ki.z : ki.x);
        const float x = logit<kSeg>(sc[4 * j + e], kb, (e & 1) ? ki.w : ki.y, (e & 2) ? qs1 : qs0, a.scale);
        sc[4 * j + e] = x;
        if (e & 2)
          mx1 = fmaxf(mx1, x);
        else
          mx0 = fmaxf(mx0, x);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);  // finite: key 64w < L lies in the tile
    const float al0 = exp2_ftz((m0 - n0) * kLog2e), al1 = exp2_ftz((m1 - n1) * kLog2e);  // 0 on the first tile
    m0 = n0;
    m1 = n1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float e = exp2_ftz((sc[i] - ((i & 2) ? n1 : n0)) * kLog2e);
      sc[i] = e;
      if (i & 2)
        sum1 += e;
      else
        sum0 += e;
    }
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= (i & 2) ? al1 : al0;
    fence_all<32>(o);
    fence_all(pa);
    fence_all<32>(sc);
    hopper::wgmma_fence();
    product_rs(o, pa, s.ring + st * kKVStage + kTileBytes);  // O += P . V
  };
  consume<S::kS>(s, n_walk, ss, step);
  fence_all<32>(o);

  // epilogue: the quad's row sums, O / l in bf16 through the Q tile
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  if (kResiduals && t == 0) {  // the backward's P = exp(s - m) / l
    const long long st = ((long long)pos.b * a.heads + pos.h) * L;
    if (r0 < L) {
      a.m_out[st + r0] = m0;
      a.l_out[st + r0] = l0;
    }
    if (r1 < L) {
      a.m_out[st + r1] = m1;
      a.l_out[st + r1] = l1;
    }
  }
  if (q0 < L) {
    hopper::named_barrier_sync(1, 128);  // every warp's last product has read the Q tile
    stage_bf16(s.own, o, 1.f / l0, 1.f / l1);
    store_tiles(&out_map, s.own, nullptr, nullptr, pos.h, q0, pos.b);
  }
}

// ------------------------------------------------------------------ dQ
// own tiles: 64 queries (Q, then dO); walk: key tiles (K, V per stage)
template <bool kSeg>
__global__ void __launch_bounds__(kBlockThreads, DqShape::kMin)
    fa_dq_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap do_map,
                 const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
                 const __grid_constant__ CUtensorMap dq_map, const Bf16Args a) {
  using S = DqShape;
  extern __shared__ unsigned char smem_raw[];
  const int L = a.length, n_walk = n_tiles(L);
  const Layout s = layout(smem_raw, 2, S::kS, kKVStage, L);
  const BlockPos pos = block_pos(a);
  const int* seg_b = a.seg ? a.seg + (long long)pos.b * L : nullptr;
  start_block(s, S::kS, 1, &q_map, &do_map, pos, L);
  plan_tiles(s.kinfo, s.need, a.mask + (long long)pos.b * L, seg_b, L, pos.own0, true);

  if (threadIdx.x >= 128) {
    // ------------------------------------------------------------ producer
    hopper::regs_dealloc<S::kProducerRegs>();
    if (threadIdx.x == 128) produce<S::kS>(s, kKVStage, &k_map, &v_map, pos, n_walk);
    return;
  }
  // ------------------------------------------------------------- consumer
  hopper::regs_alloc<S::kConsumerRegs>();
  const int warp = threadIdx.x / 32, t = threadIdx.x % 4;
  const int q0 = pos.own0;
  const int r0 = q0 + warp * 16 + (threadIdx.x % 32) / 4, r1 = r0 + 8;
  const int qs0 = (kSeg && r0 < L) ? s.kinfo[r0].y : 0;
  const int qs1 = (kSeg && r1 < L) ? s.kinfo[r1].y : 0;
  const long long stat = ((long long)pos.b * a.heads + pos.h) * L;
  // rows past L: m = +inf makes their P exactly 0
  const float m0 = r0 < L ? a.m[stat + r0] : INFINITY, m1 = r1 < L ? a.m[stat + r1] : INFINITY;
  const float il0 = r0 < L ? 1.f / a.l[stat + r0] : 0.f, il1 = r1 < L ? 1.f / a.l[stat + r1] : 0.f;
  const float d0 = r0 < L ? a.d[stat + r0] : 0.f, d1 = r1 < L ? a.d[stat + r1] : 0.f;
  float dq[32], sc[32], dp[32];
  uint32_t da[4][4];  // dS in bf16: the A fragments of the 4 k-steps
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;
  hopper::mbar_wait(s.own_full, 0);

  auto ss = [&](int st, int) {
    fence_all<32>(sc);
    fence_all<32>(dp);
    product_ss(sc, s.own, s.ring + st * kKVStage);                            // S = Q . K^T
    product_ss(dp, s.own + kTileBytes, s.ring + st * kKVStage + kTileBytes);  // dP = dO . V^T
  };
  auto step = [&](int st, int w) {
    fence_all<32>(sc);
    fence_all<32>(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int4 ki = lds_int4(s.kinfo + w * kTile + 8 * j + 2 * t);
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float kb = __int_as_float((e & 1) ? ki.z : ki.x);
        const bool hi = e & 2;
        const float x = logit<kSeg>(sc[4 * j + e], kb, (e & 1) ? ki.w : ki.y, hi ? qs1 : qs0, a.scale);
        const float pr = __fmul_rn(exp2_ftz((x - (hi ? m1 : m0)) * kLog2e), hi ? il1 : il0);
        ds[e] = __fmul_rn(pr, __fsub_rn(dp[4 * j + e], hi ? d1 : d0));
      }
      da[j / 2][2 * (j & 1)] = pack_bf16(ds[0], ds[1]);
      da[j / 2][2 * (j & 1) + 1] = pack_bf16(ds[2], ds[3]);
    }
    fence_all<32>(dq);
    fence_all(da);
    fence_all<32>(sc);
    fence_all<32>(dp);
    hopper::wgmma_fence();
    product_rs(dq, da, s.ring + st * kKVStage);  // dQ += dS . K
  };
  consume<S::kS>(s, n_walk, ss, step);
  fence_all<32>(dq);

  if (q0 < L) {
    hopper::named_barrier_sync(1, 128);  // every warp's last product has read the Q tile
    stage_bf16(s.own, dq, a.scale, a.scale);
    store_tiles(&dq_map, s.own, nullptr, nullptr, pos.h, q0, pos.b);
  }
}

// --------------------------------------------------------------- dK / dV
// own tiles: 64 keys (K, then V); walk: query tiles (Q, dO, and their m,
// 1 / l, D per stage)
constexpr int kQStage = 2 * kTileBytes + kStatBytes;

template <bool kSeg>
__global__ void __launch_bounds__(kBlockThreads, DkvShape::kMin)
    fa_dkv_kernel(const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
                  const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap do_map,
                  const __grid_constant__ CUtensorMap dk_map, const __grid_constant__ CUtensorMap dv_map,
                  const Bf16Args a) {
  using S = DkvShape;
  extern __shared__ unsigned char smem_raw[];
  const int L = a.length, n_walk = n_tiles(L);
  const Layout s = layout(smem_raw, 2, S::kS, kQStage, L);
  const BlockPos pos = block_pos(a);
  const int* seg_b = a.seg ? a.seg + (long long)pos.b * L : nullptr;
  const long long stat = ((long long)pos.b * a.heads + pos.h) * L;
  // the stage's full barrier: the producer warp's 32 lanes (stats stored),
  // lane 0 with the TMA bytes
  start_block(s, S::kS, 32, &k_map, &v_map, pos, L);
  plan_tiles(s.kinfo, s.need, a.mask + (long long)pos.b * L, seg_b, L, pos.own0, false);

  if (threadIdx.x >= 128) {
    // ------------------------------------------------------------ producer
    hopper::regs_dealloc<S::kProducerRegs>();
    if (threadIdx.x >= 160) return;
    const int lane = threadIdx.x % 32;
    int it = 0;
    for (int w = next_tile(s.need, -1, n_walk); w < n_walk; w = next_tile(s.need, w, n_walk), ++it) {
      const int st = it % S::kS;
      hopper::mbar_wait(&s.empty[st], ((it / S::kS) & 1) ^ 1);
      unsigned char* stg = s.ring + st * kQStage;
      float* stats = reinterpret_cast<float*>(stg + 2 * kTileBytes);  // m, 1 / l, D of the 64 queries
      for (int i = lane; i < kTile; i += 32) {
        const int q = w * kTile + i;
        // queries past L: m = +inf and 1 / l = 0 make their P exactly 0
        stats[i] = q < L ? a.m[stat + q] : INFINITY;
        stats[kTile + i] = q < L ? 1.f / a.l[stat + q] : 0.f;
        stats[2 * kTile + i] = q < L ? a.d[stat + q] : 0.f;
      }
      if (lane == 0) {
        hopper::mbar_arrive_expect_tx(&s.full[st], 2 * kTileBytes);
        hopper::tma_load_4d(stg, &q_map, &s.full[st], 0, pos.h, w * kTile, pos.b);
        hopper::tma_load_4d(stg + kTileBytes, &do_map, &s.full[st], 0, pos.h, w * kTile, pos.b);
      } else {
        hopper::mbar_arrive(&s.full[st]);
      }
    }
    return;
  }
  // ------------------------------------------------------------- consumer
  hopper::regs_alloc<S::kConsumerRegs>();
  const int warp = threadIdx.x / 32, t = threadIdx.x % 4;
  const int k0 = pos.own0;
  const int r0 = k0 + warp * 16 + (threadIdx.x % 32) / 4, r1 = r0 + 8;  // this thread's two key rows
  const float kb0 = r0 < L ? key_bias(s.kinfo[r0]) : -INFINITY, kb1 = r1 < L ? key_bias(s.kinfo[r1]) : -INFINITY;
  const int ks0 = r0 < L ? s.kinfo[r0].y : 0, ks1 = r1 < L ? s.kinfo[r1].y : 0;
  unsigned char* kc = s.own;
  unsigned char* vc = s.own + kTileBytes;
  float dk[32], dv[32], sc[32], dp[32];
  uint32_t pa[4][4], da[4][4];  // P^T and dS^T in bf16: the A fragments of the 4 k-steps
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  hopper::mbar_wait(s.own_full, 0);

  auto ss = [&](int st, int) {
    fence_all<32>(sc);
    fence_all<32>(dp);
    product_ss(sc, kc, s.ring + st * kQStage);               // S^T = K . Q^T
    product_ss(dp, vc, s.ring + st * kQStage + kTileBytes);  // dP^T = V . dO^T
  };
  auto step = [&](int st, int w) {
    fence_all<32>(sc);
    fence_all<32>(dp);
    const unsigned char* stg = s.ring + st * kQStage;
    const float* stats = reinterpret_cast<const float*>(stg + 2 * kTileBytes);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ql = 8 * j + 2 * t;  // this thread's queries ql, ql + 1 of the tile
      int qs[2] = {0, 0};
      if constexpr (kSeg) {
        const int4 qi = lds_int4(s.kinfo + w * kTile + ql);
        qs[0] = qi.y;
        qs[1] = qi.w;
      }
      const float2 mq = lds_f32x2(stats + ql), iq = lds_f32x2(stats + kTile + ql),
                   dq = lds_f32x2(stats + 2 * kTile + ql);
      float pr[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool odd = e & 1;
        // a key past L (its bias is -inf), or a query past L (its m is
        // +inf), gives P = 0
        const float x = logit<kSeg>(sc[4 * j + e], (e & 2) ? kb1 : kb0, (e & 2) ? ks1 : ks0, qs[odd], a.scale);
        pr[e] = __fmul_rn(exp2_ftz((x - (odd ? mq.y : mq.x)) * kLog2e), odd ? iq.y : iq.x);
        ds[e] = __fmul_rn(pr[e], __fsub_rn(dp[4 * j + e], odd ? dq.y : dq.x));
      }
      pa[j / 2][2 * (j & 1)] = pack_bf16(pr[0], pr[1]);
      pa[j / 2][2 * (j & 1) + 1] = pack_bf16(pr[2], pr[3]);
      da[j / 2][2 * (j & 1)] = pack_bf16(ds[0], ds[1]);
      da[j / 2][2 * (j & 1) + 1] = pack_bf16(ds[2], ds[3]);
    }
    fence_all<32>(dv);
    fence_all<32>(dk);
    fence_all(pa);
    fence_all(da);
    fence_all<32>(sc);
    fence_all<32>(dp);
    hopper::wgmma_fence();
    product_rs(dv, pa, stg + kTileBytes);  // dV += P^T . dO
    product_rs(dk, da, stg);               // dK += dS^T . Q
  };
  consume<S::kS>(s, n_walk, ss, step);
  fence_all<32>(dv);
  fence_all<32>(dk);

  if (k0 < L) {
    hopper::named_barrier_sync(1, 128);  // every warp's last product has read the K and V tiles
    stage_bf16(kc, dk, a.scale, a.scale);
    stage_bf16(vc, dv, 1.f, 1.f);
    store_tiles(&dk_map, kc, &dv_map, vc, pos.h, k0, pos.b);
  }
}

// ---------------------------------------------------------------- launch

// maps[i * 11 .. i * 11 + 11): dims (4, innermost first, in elements), byte
// strides of dims 1..3, box (4) of one [B, L, H, 64] bf16 view
cudaError_t encode_view(CUtensorMap* map, const void* base, const long long* f) {
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4];
  for (int i = 0; i < 4; ++i) dims[i] = (cuuint64_t)f[i];
  for (int i = 0; i < 3; ++i) strides[i] = (cuuint64_t)f[4 + i];
  for (int i = 0; i < 4; ++i) box[i] = (cuuint32_t)f[7 + i];
  if (box[0] != kHd || box[1] != 1 || box[2] != kTile || box[3] != 1) return cudaErrorInvalidValue;
  return hopper::encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box);
}

constexpr int kMapFields = 11;

template <bool kResiduals, bool kSeg>
int launch_fa(const CUtensorMap* m, const Bf16Args& a, long long blocks, cudaStream_t stream) {
  const size_t smem = smem_bytes(1, FwdShape::kS, kKVStage, a.length);
  auto kernel = fa_forward_kernel<kResiduals, kSeg>;
  cudaError_t err = hopper::raise_smem_limit(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned int)blocks, kBlockThreads, smem, stream>>>(m[0], m[1], m[2], m[3], a);
  return (int)cudaGetLastError();
}

// maps: q, k, v, dout, dq, dk, dv
template <bool kSeg>
int launch_bwd(const CUtensorMap* m, const Bf16Args& a, long long blocks, cudaStream_t stream) {
  size_t smem = smem_bytes(2, DkvShape::kS, kQStage, a.length);
  cudaError_t err = hopper::raise_smem_limit(fa_dkv_kernel<kSeg>, smem);
  if (err != cudaSuccess) return (int)err;
  fa_dkv_kernel<kSeg><<<(unsigned int)blocks, kBlockThreads, smem, stream>>>(m[1], m[2], m[0], m[3], m[5], m[6], a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  smem = smem_bytes(2, DqShape::kS, kKVStage, a.length);
  err = hopper::raise_smem_limit(fa_dq_kernel<kSeg>, smem);
  if (err != cudaSuccess) return (int)err;
  fa_dq_kernel<kSeg><<<(unsigned int)blocks, kBlockThreads, smem, stream>>>(m[0], m[3], m[1], m[2], m[4], a);
  return (int)cudaGetLastError();
}

int launch_f32(const Params& prm, cudaStream_t stream) {
  const size_t smem = Smem::total;
  const bool res = prm.m_out != nullptr;
  cudaError_t err = res ? hopper::raise_smem_limit(attention_f32_kernel<true>, smem)
                        : hopper::raise_smem_limit(attention_f32_kernel<false>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = prm.batch * prm.heads * ((prm.length + kRows - 1) / kRows);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  if (res)
    attention_f32_kernel<true><<<(unsigned int)blocks, kThreads, smem, stream>>>(prm);
  else
    attention_f32_kernel<false><<<(unsigned int)blocks, kThreads, smem, stream>>>(prm);
  return (int)cudaGetLastError();
}

int launch_backward_f32(const BwdParams& prm, cudaStream_t stream) {
  const size_t smem = BwdSmem::total;
  cudaError_t err = hopper::raise_smem_limit(attention_dkv_f32_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  err = hopper::raise_smem_limit(attention_dq_f32_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = prm.batch * prm.heads * ((prm.length + kRows - 1) / kRows);  // kKeys == kRows
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  attention_dkv_f32_kernel<<<(unsigned int)blocks, kThreads, smem, stream>>>(prm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attention_dq_f32_kernel<<<(unsigned int)blocks, kThreads, smem, stream>>>(prm);
  return (int)cudaGetLastError();
}

// the bf16 grid: a block per (row, head, 64 rows)
bool bf16_shape_ok(long long batch, int length, int heads, long long blocks) {
  return length <= kMaxLength && blocks == batch * heads * n_tiles(length) && blocks <= 2147483647LL;
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// dtype: 0 = bf16, 1 = f32 for q, k, v and out.  q, k, v: [B, L, H, 64]
// views with a contiguous last dim, 16-byte aligned rows, and element
// strides (batch, position, head) in strides[0:3], [3:6], [6:9]; out:
// contiguous [B, L, H, 64]; m_out, l_out: the residual mode's contiguous f32
// [B, H, L] row max and sum (both null for inference); mask: contiguous
// int32 [B, L]; seg: contiguous int32 [B, L] or null.  bf16 also takes
// `maps`, the tensor maps of q, k, v and out (11 fields each, as
// ops/attention.py::tensor_map gives them), and `blocks`, the grid
// (ops/attention.py::grids; a mismatch is refused); f32 ignores both.
// Requires head_dim == 64, B, L, H >= 1, and L <= 8,192 for bf16.
extern "C" int masked_attention(int dtype, const void* q, const void* k, const void* v, void* out,
                                void* m_out, void* l_out, const void* mask, const void* seg,
                                const long long* strides, const long long* maps,
                                long long batch, int length, int heads, int head_dim, float scale,
                                long long blocks, void* stream) {
  if (head_dim != kHd || batch < 1 || length < 1 || heads < 1) return (int)cudaErrorInvalidValue;
  if ((m_out == nullptr) != (l_out == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (maps == nullptr || !bf16_shape_ok(batch, length, heads, blocks)) return (int)cudaErrorInvalidValue;
    CUtensorMap m[4];
    const void* bases[4] = {q, k, v, out};
    for (int i = 0; i < 4; ++i) {
      const cudaError_t err = encode_view(&m[i], bases[i], maps + i * kMapFields);
      if (err != cudaSuccess) return (int)err;
    }
    Bf16Args a = {};
    a.m_out = static_cast<float*>(m_out);
    a.l_out = static_cast<float*>(l_out);
    a.mask = static_cast<const int*>(mask);
    a.seg = static_cast<const int*>(seg);
    a.length = length;
    a.heads = heads;
    a.scale = scale;
    if (seg != nullptr)
      return m_out != nullptr ? launch_fa<true, true>(m, a, blocks, s) : launch_fa<false, true>(m, a, blocks, s);
    return m_out != nullptr ? launch_fa<true, false>(m, a, blocks, s) : launch_fa<false, false>(m, a, blocks, s);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  Params prm = {};
  prm.q = q;
  prm.k = k;
  prm.v = v;
  prm.out = out;
  prm.m_out = static_cast<float*>(m_out);
  prm.l_out = static_cast<float*>(l_out);
  prm.mask = static_cast<const int*>(mask);
  prm.seg = static_cast<const int*>(seg);
  for (int i = 0; i < 3; ++i) {
    prm.sq[i] = strides[i];
    prm.sk[i] = strides[3 + i];
    prm.sv[i] = strides[6 + i];
  }
  prm.batch = batch;
  prm.length = length;
  prm.heads = heads;
  prm.scale = scale;
  return launch_f32(prm, s);
}

// D = rowsum(dout o out) on `stream`: dout a [B, L, H, 64] view (element
// strides batch, position, head in strides[0:3], contiguous last dim,
// 16-byte aligned rows), out contiguous [B, L, H, 64] of the same dtype (0 =
// bf16, 1 = f32), d a contiguous f32 [B, H, L]; `blocks` the grid
// (ops/attention.py::grids, a mismatch is refused).  Returns the launch's
// cudaError_t.
extern "C" int masked_attention_rowdot(int dtype, const void* dout, const void* out, void* d,
                                       const long long* strides, long long batch, int length, int heads,
                                       long long blocks, void* stream) {
  if (batch < 1 || length < 1 || heads < 1) return (int)cudaErrorInvalidValue;
  const long long rows = batch * length * heads;
  const int lanes = dtype == 0 ? 8 : 16;
  if (blocks != (rows * lanes + kRowdotThreads - 1) / kRowdotThreads || blocks > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    rowdot_kernel<__nv_bfloat16><<<(unsigned int)blocks, kRowdotThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(dout), static_cast<const __nv_bfloat16*>(out), static_cast<float*>(d),
        strides[0], strides[1], strides[2], rows, length, heads);
  else if (dtype == 1)
    rowdot_kernel<float><<<(unsigned int)blocks, kRowdotThreads, 0, s>>>(
        static_cast<const float*>(dout), static_cast<const float*>(out), static_cast<float*>(d), strides[0],
        strides[1], strides[2], rows, length, heads);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The backward's dK/dV and dQ kernels on `stream`, the cudaError_t of the
// launches (0 = ok).  dtype as above for q, k, v, dout and dqkv.  q, k, v,
// dout: [B, L, H, 64] views with a contiguous last dim, 16-byte aligned rows
// and element strides (batch, position, head) in strides[0:3], [3:6],
// [6:9], [9:12]; m, l: the forward's residuals, d: rowsum(dout o out)
// (masked_attention_rowdot), each a contiguous f32 [B, H, L]; mask, seg as
// above; dqkv: contiguous [B, L, 3, H, 64], written whole (dq, dk, dv at
// index 0, 1, 2 of its third dim).  bf16 also takes `maps` (q, k, v, dout,
// dq, dk, dv: the three planes of dqkv) and `blocks`, as masked_attention.
extern "C" int masked_attention_backward(int dtype, const void* q, const void* k, const void* v, const void* dout,
                                         const void* m, const void* l, const void* d, const void* mask,
                                         const void* seg, void* dqkv, const long long* strides,
                                         const long long* maps, long long batch, int length, int heads,
                                         int head_dim, float scale, long long blocks, void* stream) {
  if (head_dim != kHd || batch < 1 || length < 1 || heads < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (maps == nullptr || !bf16_shape_ok(batch, length, heads, blocks)) return (int)cudaErrorInvalidValue;
    CUtensorMap mp[7];
    const size_t plane = (size_t)heads * kHd * 2;
    const void* bases[7] = {q, k, v, dout, dqkv, static_cast<const char*>(dqkv) + plane,
                            static_cast<const char*>(dqkv) + 2 * plane};
    for (int i = 0; i < 7; ++i) {
      const cudaError_t err = encode_view(&mp[i], bases[i], maps + i * kMapFields);
      if (err != cudaSuccess) return (int)err;
    }
    Bf16Args a = {};
    a.m = static_cast<const float*>(m);
    a.l = static_cast<const float*>(l);
    a.d = static_cast<const float*>(d);
    a.mask = static_cast<const int*>(mask);
    a.seg = static_cast<const int*>(seg);
    a.length = length;
    a.heads = heads;
    a.scale = scale;
    return seg != nullptr ? launch_bwd<true>(mp, a, blocks, s) : launch_bwd<false>(mp, a, blocks, s);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  BwdParams prm = {};
  prm.q = q;
  prm.k = k;
  prm.v = v;
  prm.dout = dout;
  prm.m = static_cast<const float*>(m);
  prm.l = static_cast<const float*>(l);
  prm.d = static_cast<const float*>(d);
  prm.mask = static_cast<const int*>(mask);
  prm.seg = static_cast<const int*>(seg);
  prm.dqkv = dqkv;
  for (int i = 0; i < 3; ++i) {
    prm.sq[i] = strides[i];
    prm.sk[i] = strides[3 + i];
    prm.sv[i] = strides[6 + i];
    prm.so[i] = strides[9 + i];
  }
  prm.batch = batch;
  prm.length = length;
  prm.heads = heads;
  prm.scale = scale;
  return launch_backward_f32(prm, s);
}

extern "C" const char* masked_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
