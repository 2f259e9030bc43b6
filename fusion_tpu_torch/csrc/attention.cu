// Masked multi-head attention, forward and backward, on Hopper (sm_90a):
//   out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h] * scale + bias[b, i, j]) v[b, j, h]
// with bias = 0 where key j is allowed for query i and -1e9 elsewhere.  Key j
// is allowed when mask[b, j] > 0 and, for packed rows, seg[b, i] == seg[b, j]
// (pairs packed into one row attend only within their own segment).
//
// Replaces the TPU kernel behind the JAX package's `flash` attention form
// (fusion_tpu/models/encoder.py:217, SelfAttention's call of
// jax.experimental.pallas.ops.tpu.flash_attention, whose forward is the
// pl.pallas_call at flash_attention.py:758; segment ids there, an additive
// bias here, as the port's encoder hands it the key mask and the segments).
// The main path calls it in every layer of the cross-encoder's packed
// rerank: rows of 256 tokens, 12 heads of 64.
//
// What bounds it: at L = 256 and head dim 64 the work is 4 L^2 d operations
// per (row, head) against 4 L d bf16 values moved, ~64 operations a byte,
// under the card's ~295: device memory would allow ~4x the tensor-core
// rate, so the operations bound it.  With segments, much of each row's
// L x L tile is masked; the bound counts only the allowed pairs.
//
// Design (a first, simple kernel): one block of four warps per (row, head,
// 64-query tile); each warp owns 16 queries.  The block walks the keys in
// tiles of 64: K and V tiles are staged in shared memory with 16-byte
// loads, each warp forms its 16 x 64 scores with wmma (bf16 in, f32
// accumulated), the online softmax runs in f32 with two lanes per query row
// (max and sum combined by a shuffle), the unnormalized probabilities are
// rounded to bf16 for the P.V product, and the f32 output accumulator lives
// in shared memory, rescaled per tile.  Padding follows the plain version
// bit for bit in the bias: -1e9 added in f32, so a query with no allowed
// key softmaxes uniformly over the row's keys instead of giving NaN; keys
// past the row's length take no part.  f32 inputs run the same loop with
// scalar f32 dot products (no tensor cores: the f32 plain version is exact
// f32).  Key tiles that no query of the block may attend (a flat pair's
// padding, the packed rows' off-diagonal blocks) are skipped where that
// changes no bit of the result (see tile_has_pair).  Later work: wgmma with
// TMA staging and register-resident accumulators.
//
// Residual mode: the same kernel, instantiated to also write each query
// row's f32 m (max of its biased logits) and l (sum of exp(logit - m)),
// [B, H, L], from which the backward recomputes P = exp(s - m) / l.  JAX's
// forward saves l and m for the same purpose (flash_attention.py:234-252);
// the pair, not their log-sum-exp, because m + log(l) rounds away log(l)
// beside the -1e9 bias of a query with no allowed key.  The inference call
// is the instantiation without it, so serving runs the code it ran before.
//
// Backward (FA-bwd): replaces the TPU kernels of JAX's flash-attention
// backward, the dK/dV pallas_call at flash_attention.py:1121 and the dQ
// pallas_call at :1456, reached through _flash_attention_bwd (:254-318)
// when the JAX package trains a dropout-0 model in the flash form.  Two
// kernels, as there: attention_dkv_kernel, one block per (row, head, 64-key
// tile) walking the query tiles, and attention_dq_kernel, one block per
// (row, head, 64-query tile) walking the key tiles; each recomputes S and
// dP, so neither needs an atomic and every launch gives the same bits.  D =
// rowsum(dO o O) comes in from the caller (a torch reduction, as JAX's di
// is computed outside its kernels).
//
// What bounds the backward: five L^2 d products per (row, head), 10 L^2 d
// operations, against 8 L d bf16 values moved (q, k, v, out, dO read; dq,
// dk, dv written): ~160 operations a byte at L = 256, under the card's
// ~295, so device memory bounds it (3.2 GB, 0.97 ms at the ColBERT bench's
// [1024, 256, 12, 64]); the kernels move far more than that (each re-reads
// its tiles per pass and stages S and dP in shared memory) and do seven
// products, not five.  The design spends its time in
// the simplest places: wmma (16 x 16 x 16, bf16 in, f32 accumulated) from
// padded shared-memory tiles, f32 S and dP staged through shared memory for
// the elementwise step (two lanes per row, P and dS rounded to bf16 as the
// operands of the next products), and dK, dV, dQ accumulated in wmma
// fragments across the loop.  Later work: wgmma with register-resident S
// and P, TMA staging, and one pass that forms dQ beside dK / dV.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace nvcuda;

constexpr int kHd = 64;       // head dim
constexpr int kRows = 64;     // queries per block
constexpr int kKeys = 64;     // keys per tile
constexpr int kWarps = 4;     // 16 queries each
constexpr int kThreads = kWarps * 32;
constexpr int kSPitch = kKeys + 4;  // f32 score rows: 272 B, every 16-row step 32 B aligned
constexpr int kPPitch = kKeys + 8;  // bf16 probability rows: 144 B
constexpr float kMaskedBias = -1e9f;

template <typename T>
struct Pitch;
template <>
struct Pitch<__nv_bfloat16> {
  static constexpr int value = kHd + 8;  // 144-byte rows: wmma's 32-byte fragment alignment
};
template <>
struct Pitch<float> {
  static constexpr int value = kHd + 4;
};

constexpr size_t align128(size_t n) { return (n + 127) / 128 * 128; }

// shared memory: Q, K, V tiles; per warp its scores, bf16 probabilities and
// f32 output accumulator; the key tile's mask and segments
template <typename T>
struct Smem {
  static constexpr size_t tile = align128(sizeof(T) * kRows * Pitch<T>::value);
  static constexpr size_t scores = align128(sizeof(float) * kWarps * 16 * kSPitch);
  static constexpr size_t probs = align128(sizeof(__nv_bfloat16) * kWarps * 16 * kPPitch);
  static constexpr size_t acc = align128(sizeof(float) * kWarps * 16 * kHd);
  static constexpr size_t keys = align128(sizeof(int) * (2 * kKeys + kRows));
  static constexpr size_t total = 3 * tile + scores + probs + acc + keys;
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
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long stride, int row0, int length) {
  constexpr int kChunk = 16 / sizeof(T);
  constexpr int kPerRow = kHd / kChunk;
  for (int i = threadIdx.x; i < kRows * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kChunk;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < length) val = __ldg(reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * stride + c));
    *reinterpret_cast<uint4*>(dst + r * Pitch<T>::value + c) = val;
  }
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}

// Key-tile skipping: the forward's rule (spelled out in its body), taken by
// both backward kernels through these helpers.  A key
// tile that no query of a 64-query tile may attend adds exactly nothing to
// a query that may attend some key of its row (its terms are
// exp(-1e9 + x - m) = 0, or are wiped by the rescale exp(-1e9 - m) = 0 when
// they came first; in the backward its P, and so its dS, are exactly 0), so
// such pairs of tiles are skipped, bit for bit, when every query of the
// query tile has an allowed key: packed, a query is real (its own key is
// allowed); otherwise, the row has one real key.  A query with no allowed
// key averages over all keys, so its tile skips nothing.  Each helper is
// called by every thread of the block (they synchronize).

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

// kResiduals: also write each query row's m and l (the backward's
// residuals); the inference call is the instantiation without them
template <typename T, bool kResiduals>
__global__ void __launch_bounds__(kThreads) attention_kernel(Params p) {
  constexpr int P = Pitch<T>::value;
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = reinterpret_cast<T*>(smem + Smem<T>::tile);
  T* v_s = reinterpret_cast<T*>(smem + 2 * Smem<T>::tile);
  float* s_all = reinterpret_cast<float*>(smem + 3 * Smem<T>::tile);
  __nv_bfloat16* p_all = reinterpret_cast<__nv_bfloat16*>(smem + 3 * Smem<T>::tile + Smem<T>::scores);
  float* o_all = reinterpret_cast<float*>(smem + 3 * Smem<T>::tile + Smem<T>::scores + Smem<T>::probs);
  int* kmask_s = reinterpret_cast<int*>(smem + 3 * Smem<T>::tile + Smem<T>::scores + Smem<T>::probs + Smem<T>::acc);
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
  __nv_bfloat16* p_w = p_all + warp * 16 * kPPitch;
  float* o_w = o_all + warp * 16 * kHd;

  const T* qg = static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[2];
  const T* kg = static_cast<const T*>(p.k) + b * p.sk[0] + h * p.sk[2];
  const T* vg = static_cast<const T*>(p.v) + b * p.sv[0] + h * p.sv[2];
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
  // skip key tiles that change no bit of the result (see tile_has_pair; the
  // same rule as the helpers, spelled out here as the inference kernel has
  // always had it)
  bool has_key;
  if (seg_b) {
    has_key = true;
    for (int i = threadIdx.x; i < kRows; i += kThreads)
      has_key = has_key && (q0 + i >= L || mask_b[q0 + i] > 0);
  } else {
    has_key = false;
    for (int i = threadIdx.x; i < L; i += kThreads) has_key = has_key || mask_b[i] > 0;
    has_key = __syncthreads_or(has_key);
  }
  const bool may_skip = __syncthreads_and(has_key);
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qa[kHd / 16];
  if constexpr (kBf16) {
#pragma unroll
    for (int kk = 0; kk < kHd / 16; ++kk)
      wmma::load_matrix_sync(qa[kk], reinterpret_cast<const __nv_bfloat16*>(q_s) + warp * 16 * P + kk * 16, P);
  }

  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < L; k0 += kKeys) {
    __syncthreads();  // every warp is done with the previous K / V tile
    if (threadIdx.x < kKeys) {
      const int key = k0 + threadIdx.x;
      kmask_s[threadIdx.x] = key < L ? (mask_b[key] > 0 ? 1 : 0) : -1;  // -1: past the row
      kseg_s[threadIdx.x] = (seg_b && key < L) ? seg_b[key] : 0;
    }
    __syncthreads();
    if (may_skip) {  // two threads per query row, 32 keys each
      const int qs = qseg_s[threadIdx.x >> 1];
      bool any = false;
#pragma unroll 8
      for (int c = 0; c < 32; ++c) {
        const int j = (threadIdx.x & 1) * 32 + c;
        any = any || (kmask_s[j] > 0 && (seg_b == nullptr || kseg_s[j] == qs));
      }
      if (!__syncthreads_or(any)) continue;
    }
    load_tile(k_s, kg, p.sk[1], k0, L);
    load_tile(v_s, vg, p.sv[1], k0, L);
    __syncthreads();

    // raw scores q . k of the warp's 16 queries x 64 keys, f32
    if constexpr (kBf16) {
      const __nv_bfloat16* kb_s = reinterpret_cast<const __nv_bfloat16*>(k_s);
#pragma unroll
      for (int j = 0; j < kKeys / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
        for (int kk = 0; kk < kHd / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kb;
          wmma::load_matrix_sync(kb, kb_s + j * 16 * P + kk * 16, P);
          wmma::mma_sync(acc, qa[kk], kb, acc);
        }
        wmma::store_matrix_sync(s_w + j * 16, acc, kSPitch, wmma::mem_row_major);
      }
    } else {
      const float* qrow = reinterpret_cast<const float*>(q_s) + (warp * 16 + r) * P;
      for (int c = 0; c < 32; ++c) {
        const float* krow = reinterpret_cast<const float*>(k_s) + (half * 32 + c) * P;
        float acc = 0.f;
#pragma unroll 16
        for (int d = 0; d < kHd; ++d) acc = fmaf(qrow[d], krow[d], acc);
        s_w[r * kSPitch + half * 32 + c] = acc;
      }
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
      if constexpr (kBf16) {
        p_w[r * kPPitch + half * 32 + c] = __float2bfloat16(e);
      } else {
        s_w[r * kSPitch + half * 32 + c] = e;
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * alpha + sum;
    m = m_new;
    __syncwarp();

    // o = o * alpha + P . V for the lane's 32 output dims of row r
    if constexpr (kBf16) {
      const __nv_bfloat16* vb_s = reinterpret_cast<const __nv_bfloat16*>(v_s);
#pragma unroll
      for (int j = 0; j < kHd / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vb;
          wmma::load_matrix_sync(pa, p_w + kk * 16, kPPitch);
          wmma::load_matrix_sync(vb, vb_s + kk * 16 * P + j * 16, P);
          wmma::mma_sync(acc, pa, vb, acc);
        }
        wmma::store_matrix_sync(s_w + j * 16, acc, kSPitch, wmma::mem_row_major);
      }
      __syncwarp();
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        float& o = o_w[r * kHd + half * 32 + c];
        o = o * alpha + s_w[r * kSPitch + half * 32 + c];
      }
    } else {
      float acc[32];
#pragma unroll
      for (int c = 0; c < 32; ++c) acc[c] = 0.f;
      const float* vf = reinterpret_cast<const float*>(v_s);
      for (int j = 0; j < kKeys; ++j) {
        const float pj = s_w[r * kSPitch + j];
#pragma unroll
        for (int c = 0; c < 32; ++c) acc[c] = fmaf(pj, vf[j * P + half * 32 + c], acc[c]);
      }
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        float& o = o_w[r * kHd + half * 32 + c];
        o = o * alpha + acc[c];
      }
    }
  }

  if (qpos < L) {
    if (kResiduals && half == 0) {  // the backward's P = exp(s - m) / l
      const long long st = (b * p.heads + h) * L + qpos;
      p.m_out[st] = m;
      p.l_out[st] = l;
    }
    const float inv = 1.f / l;
    T* dst = static_cast<T*>(p.out) + ((b * L + qpos) * p.heads + h) * kHd + half * 32;
#pragma unroll
    for (int c = 0; c < 32; ++c) dst[c] = from_float<T>(o_w[r * kHd + half * 32 + c] * inv);
  }
}

template <typename T, bool kResiduals>
int launch_mode(const Params& prm, cudaStream_t stream) {
  const size_t smem = Smem<T>::total;
  cudaError_t err = hopper::raise_smem_limit(attention_kernel<T, kResiduals>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = prm.batch * prm.heads * ((prm.length + kRows - 1) / kRows);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  attention_kernel<T, kResiduals><<<(unsigned int)blocks, kThreads, smem, stream>>>(prm);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Params& prm, cudaStream_t stream) {
  return prm.m_out != nullptr ? launch_mode<T, true>(prm, stream) : launch_mode<T, false>(prm, stream);
}

// ---------------------------------------------------------------------------
// Backward.  With P = exp(s - m) / l recomputed from the forward's residuals
// (s the biased logits, rounded as the forward rounds them), D = rowsum(dO o O)
// (computed by the caller) and dS = P o (dP - D), dP = dO . V^T:
//   dV = P^T . dO,  dK = scale * dS^T . Q,  dQ = scale * dS . K.
// Two kernels, the split of JAX's backward: attention_dkv_kernel owns 64
// keys and walks the query tiles (JAX's dkv pallas_call), attention_dq_kernel
// owns 64 queries and walks the key tiles (its dq pallas_call).  Each
// recomputes S and dP; neither needs an atomic, so every launch gives the
// same bits.  bf16: S, dP, dV, dK, dQ on wmma (bf16 in, f32 accumulated), P
// and dS rounded to bf16 as operands; f32: scalar f32 FMAs.

// shared memory of both backward kernels: four [64, 64] tiles; per warp S and
// dP (f32), P and dS (bf16); the query tile's m, l, D; segment and mask ids
template <typename T>
struct BwdSmem {
  static constexpr size_t tile = Smem<T>::tile;
  static constexpr size_t scores = Smem<T>::scores;
  static constexpr size_t probs = Smem<T>::probs;
  static constexpr size_t stats = align128(sizeof(float) * 3 * kRows);
  static constexpr size_t ints = align128(sizeof(int) * (kRows + 2 * kKeys));
  static constexpr size_t total = 4 * tile + 2 * scores + 2 * probs + stats + ints;
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
  __nv_bfloat16* p;
  __nv_bfloat16* ds;
  float* m;
  float* l;
  float* d;
  int* qseg;
  int* kmask;
  int* kseg;
};

template <typename T>
__device__ __forceinline__ BwdSmemPtrs bwd_smem(unsigned char* smem) {
  unsigned char* rest = smem + 4 * BwdSmem<T>::tile;
  BwdSmemPtrs ptr;
  ptr.s = reinterpret_cast<float*>(rest);
  ptr.dp = reinterpret_cast<float*>(rest + BwdSmem<T>::scores);
  ptr.p = reinterpret_cast<__nv_bfloat16*>(rest + 2 * BwdSmem<T>::scores);
  ptr.ds = reinterpret_cast<__nv_bfloat16*>(rest + 2 * BwdSmem<T>::scores + BwdSmem<T>::probs);
  ptr.m = reinterpret_cast<float*>(rest + 2 * BwdSmem<T>::scores + 2 * BwdSmem<T>::probs);
  ptr.l = ptr.m + kRows;
  ptr.d = ptr.l + kRows;
  ptr.qseg = reinterpret_cast<int*>(rest + 2 * BwdSmem<T>::scores + 2 * BwdSmem<T>::probs + BwdSmem<T>::stats);
  ptr.kmask = ptr.qseg + kRows;
  ptr.kseg = ptr.kmask + kKeys;
  return ptr;
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
template <typename T>
__device__ __forceinline__ void write_grad_row(const BwdParams& p, long long b, int pos, int which, int h, int c0,
                                               const float* row, float scale) {
  T* dst = static_cast<T*>(p.dqkv) + (((b * p.length + pos) * 3 + which) * p.heads + h) * kHd + c0;
#pragma unroll
  for (int c = 0; c < 32; ++c) dst[c] = from_float<T>(row[c] * scale);
}

// dK and dV of one (row, head, 64-key tile); each warp owns 16 keys and
// keeps their dK, dV accumulators in registers over the query tiles
template <typename T>
__global__ void __launch_bounds__(kThreads) attention_dkv_kernel(BwdParams p) {
  constexpr int P = Pitch<T>::value;
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ __align__(128) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = reinterpret_cast<T*>(smem + BwdSmem<T>::tile);
  T* q_s = reinterpret_cast<T*>(smem + 2 * BwdSmem<T>::tile);
  T* o_s = reinterpret_cast<T*>(smem + 3 * BwdSmem<T>::tile);  // dO
  const BwdSmemPtrs sp = bwd_smem<T>(smem);

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
  float* s_w = sp.s + warp * 16 * kSPitch;    // S^T, then P^T (f32 path); dK rows at the end
  float* dp_w = sp.dp + warp * 16 * kSPitch;  // dP^T, then dS^T (f32 path); dV rows at the end
  __nv_bfloat16* p_w = sp.p + warp * 16 * kPPitch;
  __nv_bfloat16* ds_w = sp.ds + warp * 16 * kPPitch;

  const T* qg = static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[2];
  const T* kg = static_cast<const T*>(p.k) + b * p.sk[0] + h * p.sk[2];
  const T* vg = static_cast<const T*>(p.v) + b * p.sv[0] + h * p.sv[2];
  const T* og = static_cast<const T*>(p.dout) + b * p.so[0] + h * p.so[2];
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

  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> ka[kHd / 16], va[kHd / 16];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk_acc[kHd / 16], dv_acc[kHd / 16];
  float dk_f[32], dv_f[32];
  if constexpr (kBf16) {
#pragma unroll
    for (int kk = 0; kk < kHd / 16; ++kk) {
      wmma::load_matrix_sync(ka[kk], reinterpret_cast<const __nv_bfloat16*>(k_s) + warp * 16 * P + kk * 16, P);
      wmma::load_matrix_sync(va[kk], reinterpret_cast<const __nv_bfloat16*>(v_s) + warp * 16 * P + kk * 16, P);
      wmma::fill_fragment(dk_acc[kk], 0.f);
      wmma::fill_fragment(dv_acc[kk], 0.f);
    }
  } else {
#pragma unroll
    for (int c = 0; c < 32; ++c) dk_f[c] = dv_f[c] = 0.f;
  }

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

    // S^T = K_w . Q^T and dP^T = V_w . dO^T: the warp's 16 keys x 64 queries, f32
    if constexpr (kBf16) {
      const __nv_bfloat16* qb_s = reinterpret_cast<const __nv_bfloat16*>(q_s);
      const __nv_bfloat16* ob_s = reinterpret_cast<const __nv_bfloat16*>(o_s);
#pragma unroll
      for (int j = 0; j < kRows / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_s, acc_p;
        wmma::fill_fragment(acc_s, 0.f);
        wmma::fill_fragment(acc_p, 0.f);
#pragma unroll
        for (int kk = 0; kk < kHd / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> qb, ob;
          wmma::load_matrix_sync(qb, qb_s + j * 16 * P + kk * 16, P);
          wmma::load_matrix_sync(ob, ob_s + j * 16 * P + kk * 16, P);
          wmma::mma_sync(acc_s, ka[kk], qb, acc_s);
          wmma::mma_sync(acc_p, va[kk], ob, acc_p);
        }
        wmma::store_matrix_sync(s_w + j * 16, acc_s, kSPitch, wmma::mem_row_major);
        wmma::store_matrix_sync(dp_w + j * 16, acc_p, kSPitch, wmma::mem_row_major);
      }
    } else {
      const float* krow = reinterpret_cast<const float*>(k_s) + (warp * 16 + r) * P;
      const float* vrow = reinterpret_cast<const float*>(v_s) + (warp * 16 + r) * P;
      for (int c = 0; c < 32; ++c) {
        const int il = half * 32 + c;
        const float* qrow = reinterpret_cast<const float*>(q_s) + il * P;
        const float* orow = reinterpret_cast<const float*>(o_s) + il * P;
        float acc_s = 0.f, acc_p = 0.f;
#pragma unroll 16
        for (int d = 0; d < kHd; ++d) {
          acc_s = fmaf(krow[d], qrow[d], acc_s);
          acc_p = fmaf(vrow[d], orow[d], acc_p);
        }
        s_w[r * kSPitch + il] = acc_s;
        dp_w[r * kSPitch + il] = acc_p;
      }
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
      if constexpr (kBf16) {
        p_w[r * kPPitch + il] = __float2bfloat16(pr);
        ds_w[r * kPPitch + il] = __float2bfloat16(ds);
      } else {
        s_w[r * kSPitch + il] = pr;
        dp_w[r * kSPitch + il] = ds;
      }
    }
    __syncwarp();

    // dV += P^T . dO and dK += dS^T . Q over this tile's 64 queries
    if constexpr (kBf16) {
      const __nv_bfloat16* qb_s = reinterpret_cast<const __nv_bfloat16*>(q_s);
      const __nv_bfloat16* ob_s = reinterpret_cast<const __nv_bfloat16*>(o_s);
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pa, dsa;
        wmma::load_matrix_sync(pa, p_w + kk * 16, kPPitch);
        wmma::load_matrix_sync(dsa, ds_w + kk * 16, kPPitch);
#pragma unroll
        for (int j = 0; j < kHd / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> ob, qb;
          wmma::load_matrix_sync(ob, ob_s + kk * 16 * P + j * 16, P);
          wmma::load_matrix_sync(qb, qb_s + kk * 16 * P + j * 16, P);
          wmma::mma_sync(dv_acc[j], pa, ob, dv_acc[j]);
          wmma::mma_sync(dk_acc[j], dsa, qb, dk_acc[j]);
        }
      }
    } else {
      const float* qf = reinterpret_cast<const float*>(q_s);
      const float* of = reinterpret_cast<const float*>(o_s);
      for (int il = 0; il < kRows; ++il) {
        const float pr = s_w[r * kSPitch + il], ds = dp_w[r * kSPitch + il];
#pragma unroll
        for (int c = 0; c < 32; ++c) {
          dv_f[c] = fmaf(pr, of[il * P + half * 32 + c], dv_f[c]);
          dk_f[c] = fmaf(ds, qf[il * P + half * 32 + c], dk_f[c]);
        }
      }
    }
  }

  if constexpr (kBf16) {
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kHd / 16; ++j) {
      wmma::store_matrix_sync(s_w + j * 16, dk_acc[j], kSPitch, wmma::mem_row_major);
      wmma::store_matrix_sync(dp_w + j * 16, dv_acc[j], kSPitch, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      dk_f[c] = s_w[r * kSPitch + half * 32 + c];
      dv_f[c] = dp_w[r * kSPitch + half * 32 + c];
    }
  }
  if (key < L) {
    write_grad_row<T>(p, b, key, 1, h, half * 32, dk_f, p.scale);
    write_grad_row<T>(p, b, key, 2, h, half * 32, dv_f, 1.f);
  }
}

// dQ of one (row, head, 64-query tile); each warp owns 16 queries and keeps
// their dQ accumulator in registers over the key tiles
template <typename T>
__global__ void __launch_bounds__(kThreads) attention_dq_kernel(BwdParams p) {
  constexpr int P = Pitch<T>::value;
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ __align__(128) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* o_s = reinterpret_cast<T*>(smem + BwdSmem<T>::tile);  // dO
  T* k_s = reinterpret_cast<T*>(smem + 2 * BwdSmem<T>::tile);
  T* v_s = reinterpret_cast<T*>(smem + 3 * BwdSmem<T>::tile);
  const BwdSmemPtrs sp = bwd_smem<T>(smem);

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
  float* s_w = sp.s + warp * 16 * kSPitch;    // S, then dS (f32 path); dQ rows at the end
  float* dp_w = sp.dp + warp * 16 * kSPitch;  // dP
  __nv_bfloat16* ds_w = sp.ds + warp * 16 * kPPitch;

  const T* qg = static_cast<const T*>(p.q) + b * p.sq[0] + h * p.sq[2];
  const T* kg = static_cast<const T*>(p.k) + b * p.sk[0] + h * p.sk[2];
  const T* vg = static_cast<const T*>(p.v) + b * p.sv[0] + h * p.sv[2];
  const T* og = static_cast<const T*>(p.dout) + b * p.so[0] + h * p.so[2];
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

  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qa[kHd / 16], oa[kHd / 16];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dq_acc[kHd / 16];
  float dq_f[32];
  if constexpr (kBf16) {
#pragma unroll
    for (int kk = 0; kk < kHd / 16; ++kk) {
      wmma::load_matrix_sync(qa[kk], reinterpret_cast<const __nv_bfloat16*>(q_s) + warp * 16 * P + kk * 16, P);
      wmma::load_matrix_sync(oa[kk], reinterpret_cast<const __nv_bfloat16*>(o_s) + warp * 16 * P + kk * 16, P);
      wmma::fill_fragment(dq_acc[kk], 0.f);
    }
  } else {
#pragma unroll
    for (int c = 0; c < 32; ++c) dq_f[c] = 0.f;
  }

  for (int k0 = 0; k0 < L; k0 += kKeys) {
    __syncthreads();  // every warp is done with the previous K / V tile
    load_key_ids(sp.kmask, sp.kseg, mask_b, seg_b, k0, L);
    __syncthreads();
    if (may_skip && !tile_has_pair(sp.kmask, sp.kseg, sp.qseg, seg_b != nullptr)) continue;
    load_tile(k_s, kg, p.sk[1], k0, L);
    load_tile(v_s, vg, p.sv[1], k0, L);
    __syncthreads();

    // S = Q_w . K^T and dP = dO_w . V^T: the warp's 16 queries x 64 keys, f32
    if constexpr (kBf16) {
      const __nv_bfloat16* kb_s = reinterpret_cast<const __nv_bfloat16*>(k_s);
      const __nv_bfloat16* vb_s = reinterpret_cast<const __nv_bfloat16*>(v_s);
#pragma unroll
      for (int j = 0; j < kKeys / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_s, acc_p;
        wmma::fill_fragment(acc_s, 0.f);
        wmma::fill_fragment(acc_p, 0.f);
#pragma unroll
        for (int kk = 0; kk < kHd / 16; ++kk) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kb, vb;
          wmma::load_matrix_sync(kb, kb_s + j * 16 * P + kk * 16, P);
          wmma::load_matrix_sync(vb, vb_s + j * 16 * P + kk * 16, P);
          wmma::mma_sync(acc_s, qa[kk], kb, acc_s);
          wmma::mma_sync(acc_p, oa[kk], vb, acc_p);
        }
        wmma::store_matrix_sync(s_w + j * 16, acc_s, kSPitch, wmma::mem_row_major);
        wmma::store_matrix_sync(dp_w + j * 16, acc_p, kSPitch, wmma::mem_row_major);
      }
    } else {
      const float* qrow = reinterpret_cast<const float*>(q_s) + (warp * 16 + r) * P;
      const float* orow = reinterpret_cast<const float*>(o_s) + (warp * 16 + r) * P;
      for (int c = 0; c < 32; ++c) {
        const int jl = half * 32 + c;
        const float* krow = reinterpret_cast<const float*>(k_s) + jl * P;
        const float* vrow = reinterpret_cast<const float*>(v_s) + jl * P;
        float acc_s = 0.f, acc_p = 0.f;
#pragma unroll 16
        for (int d = 0; d < kHd; ++d) {
          acc_s = fmaf(qrow[d], krow[d], acc_s);
          acc_p = fmaf(orow[d], vrow[d], acc_p);
        }
        s_w[r * kSPitch + jl] = acc_s;
        dp_w[r * kSPitch + jl] = acc_p;
      }
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
      if constexpr (kBf16) {
        ds_w[r * kPPitch + jl] = __float2bfloat16(ds);
      } else {
        s_w[r * kSPitch + jl] = ds;
      }
    }
    __syncwarp();

    // dQ += dS . K over this tile's 64 keys
    if constexpr (kBf16) {
      const __nv_bfloat16* kb_s = reinterpret_cast<const __nv_bfloat16*>(k_s);
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> dsa;
        wmma::load_matrix_sync(dsa, ds_w + kk * 16, kPPitch);
#pragma unroll
        for (int j = 0; j < kHd / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> kb;
          wmma::load_matrix_sync(kb, kb_s + kk * 16 * P + j * 16, P);
          wmma::mma_sync(dq_acc[j], dsa, kb, dq_acc[j]);
        }
      }
    } else {
      const float* kf = reinterpret_cast<const float*>(k_s);
      for (int jl = 0; jl < kKeys; ++jl) {
        const float ds = s_w[r * kSPitch + jl];
#pragma unroll
        for (int c = 0; c < 32; ++c) dq_f[c] = fmaf(ds, kf[jl * P + half * 32 + c], dq_f[c]);
      }
    }
  }

  if constexpr (kBf16) {
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kHd / 16; ++j)
      wmma::store_matrix_sync(s_w + j * 16, dq_acc[j], kSPitch, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 32; ++c) dq_f[c] = s_w[r * kSPitch + half * 32 + c];
  }
  if (in) write_grad_row<T>(p, b, qpos, 0, h, half * 32, dq_f, p.scale);
}

template <typename T>
int launch_backward(const BwdParams& prm, cudaStream_t stream) {
  const size_t smem = BwdSmem<T>::total;
  cudaError_t err = hopper::raise_smem_limit(attention_dkv_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  err = hopper::raise_smem_limit(attention_dq_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = prm.batch * prm.heads * ((prm.length + kRows - 1) / kRows);  // kKeys == kRows
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  attention_dkv_kernel<T><<<(unsigned int)blocks, kThreads, smem, stream>>>(prm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attention_dq_kernel<T><<<(unsigned int)blocks, kThreads, smem, stream>>>(prm);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// dtype: 0 = bf16, 1 = f32 for q, k, v and out.  q, k, v: [B, L, H, 64]
// views with a contiguous last dim, 16-byte aligned rows, and element
// strides (batch, position, head) in strides[0:3], [3:6], [6:9]; out:
// contiguous [B, L, H, 64]; m_out, l_out: the residual mode's contiguous f32
// [B, H, L] row max and sum (both null for inference); mask: contiguous
// int32 [B, L]; seg: contiguous int32 [B, L] or null.  Requires head_dim ==
// 64, B, L, H >= 1.
extern "C" int masked_attention(int dtype, const void* q, const void* k, const void* v, void* out,
                                void* m_out, void* l_out, const void* mask, const void* seg,
                                const long long* strides,
                                long long batch, int length, int heads, int head_dim, float scale,
                                void* stream) {
  if (head_dim != kHd || batch < 1 || length < 1 || heads < 1) return (int)cudaErrorInvalidValue;
  Params prm = {};
  prm.q = q;
  prm.k = k;
  prm.v = v;
  prm.out = out;
  prm.m_out = static_cast<float*>(m_out);
  prm.l_out = static_cast<float*>(l_out);
  if ((m_out == nullptr) != (l_out == nullptr)) return (int)cudaErrorInvalidValue;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<__nv_bfloat16>(prm, s);
  if (dtype == 1) return launch<float>(prm, s);
  return (int)cudaErrorInvalidValue;
}

// The backward: both kernels on `stream`, the cudaError_t of the launches
// (0 = ok).  dtype as above for q, k, v, dout and dqkv.  q, k, v, dout:
// [B, L, H, 64] views with a contiguous last dim, 16-byte aligned rows and
// element strides (batch, position, head) in strides[0:3], [3:6], [6:9],
// [9:12]; m, l: the forward's residuals, d: rowsum(dout o out), each a
// contiguous f32 [B, H, L]; mask, seg as above; dqkv: contiguous [B, L, 3,
// H, 64], written whole (dq, dk, dv at index 0, 1, 2 of its third dim).
extern "C" int masked_attention_backward(int dtype, const void* q, const void* k, const void* v, const void* dout,
                                         const void* m, const void* l, const void* d, const void* mask,
                                         const void* seg, void* dqkv, const long long* strides, long long batch,
                                         int length, int heads, int head_dim, float scale, void* stream) {
  if (head_dim != kHd || batch < 1 || length < 1 || heads < 1) return (int)cudaErrorInvalidValue;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_backward<__nv_bfloat16>(prm, s);
  if (dtype == 1) return launch_backward<float>(prm, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* masked_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
