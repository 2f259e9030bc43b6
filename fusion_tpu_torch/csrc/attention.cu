// Masked multi-head attention forward on Hopper (sm_90a):
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
// changes no bit of the result (see the kernel).  Later work: wgmma with TMA
// staging and register-resident accumulators.

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

template <typename T>
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
  // A key tile that no query of the block may attend adds exactly nothing
  // to a query that may attend some key of its row (its terms are
  // exp(-1e9 + x - m) = 0, or are wiped by the rescale exp(-1e9 - m) = 0
  // when they came first), so such tiles are skipped, bit for bit, when
  // every query of the block has an allowed key: packed, a query is real
  // (its own key is allowed); otherwise, the row has one real key.  A query
  // with no allowed key averages over all keys, so its block skips nothing.
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
    const float inv = 1.f / l;
    T* dst = static_cast<T*>(p.out) + ((b * L + qpos) * p.heads + h) * kHd + half * 32;
#pragma unroll
    for (int c = 0; c < 32; ++c) dst[c] = from_float<T>(o_w[r * kHd + half * 32 + c] * inv);
  }
}

template <typename T>
int launch(const Params& prm, cudaStream_t stream) {
  const size_t smem = Smem<T>::total;
  cudaError_t err = hopper::raise_smem_limit(attention_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = prm.batch * prm.heads * ((prm.length + kRows - 1) / kRows);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  attention_kernel<T><<<(unsigned int)blocks, kThreads, smem, stream>>>(prm);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// dtype: 0 = bf16, 1 = f32 for q, k, v and out.  q, k, v: [B, L, H, 64]
// views with a contiguous last dim, 16-byte aligned rows, and element
// strides (batch, position, head) in strides[0:3], [3:6], [6:9]; out:
// contiguous [B, L, H, 64]; mask: contiguous int32 [B, L]; seg: contiguous
// int32 [B, L] or null.  Requires head_dim == 64, B, L, H >= 1.
extern "C" int masked_attention(int dtype, const void* q, const void* k, const void* v, void* out,
                                const void* mask, const void* seg, const long long* strides,
                                long long batch, int length, int heads, int head_dim, float scale,
                                void* stream) {
  if (head_dim != kHd || batch < 1 || length < 1 || heads < 1) return (int)cudaErrorInvalidValue;
  Params prm = {};
  prm.q = q;
  prm.k = k;
  prm.v = v;
  prm.out = out;
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

extern "C" const char* masked_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
