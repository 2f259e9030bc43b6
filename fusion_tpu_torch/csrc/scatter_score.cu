// Scatter scorer over the chunked impact index on Hopper (sm_90a): the
// SPLADE leg of scale mode.
//
// Replaces the TPU kernel fusion_tpu/ops/scatter_score.py::_scatter_kernel
// (driven there by _fused_scatter_search and scatter_impact_search).
//
// For query q with terms t[q, :Kq] (pad >= V, clamped to the sentinel row V)
// and f32 weights w[q, :Kq], and chunk c of docs_per_chunk (dpc) docs:
//
//     acc[d] = sum over postings (term, c, j) with post_doc == d < dpc of
//              bf16( bf16(f16 impact) * bf16(w) )          accumulated in f32
//     score[d] = acc[d] > 0 ? acc[d] : -inf
//     out[q, c*dpc/16 + b] = max_{s < 16} score[s*dpc/16 + b]
//
// with a strict '>' over s (ties keep the lowest s), s packed into the 4 low
// mantissa bits, and a -inf maximum kept -inf.  The bf16 roundings are the
// ones the JAX package's posting gather applies; the sentinel 0xFFFF (and any
// doc >= dpc) is dropped, as the TPU kernel's one-hot drops hi >= H.
//
// The TPU kernel routes postings to docs through a factorized one-hot matmul
// only because the TPU has no scatter.  Here each block owns one
// (query, chunk) pair and scatters for real: an f32 accumulator of dpc floats
// in shared memory (64 KB at dpc 16,384), zeroed, then one shared-memory
// atomicAdd per posting read straight from the index rows (no gathered
// [Q, C, Kq*capc] copy in device memory), then the bin pass over the
// accumulator.  What bounds it: per (query, chunk) only Kq*capc postings
// (2,048 at the serving layout, 8 KB) are read from device memory; the
// shared-memory passes over the accumulator (zeroing and the bin pass,
// 2 x dpc words) dominate, and three 64 KB blocks fit an SM.
//
// The atomics make the order of the f32 additions vary from run to run: a
// doc's score is a sum of at most Kq values, so two runs differ by a few
// ulps, and the packing clears 4 more bits.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBin = 16;
constexpr int kThreads = 512;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__global__ void __launch_bounds__(kThreads)
scatter_binmax_kernel(const int* __restrict__ q_terms,       // [nq, kq]
                      const float* __restrict__ q_weights,   // [nq, kq]
                      const uint16_t* __restrict__ post_doc, // [vp1, c, capc]
                      const __half* __restrict__ post_imp,   // [vp1, c, capc]
                      float* __restrict__ out,               // [nq, c * dpc / 16]
                      int kq, int vp1, int c, int capc, int dpc) {
  extern __shared__ __align__(16) float acc[];  // [dpc]
  const int chunk = blockIdx.x;
  const int q = blockIdx.y;
  const int tid = threadIdx.x;

  for (int i = tid * 4; i < dpc; i += kThreads * 4)
    *reinterpret_cast<float4*>(acc + i) = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  const int width = kq * capc;
  for (int e = tid; e < width; e += kThreads) {
    const int t = e / capc, j = e - t * capc;
    const int term = min(max(q_terms[(size_t)q * kq + t], 0), vp1 - 1);
    const size_t p = ((size_t)term * c + chunk) * capc + j;
    const int d = post_doc[p];
    if (d < dpc) {
      const float imp = round_bf16(__half2float(post_imp[p]));
      const float w = round_bf16(q_weights[(size_t)q * kq + t]);
      atomicAdd(acc + d, round_bf16(__fmul_rn(imp, w)));
    }
  }
  __syncthreads();

  const int lanes = dpc / kBin;
  float* dst = out + ((size_t)q * c + chunk) * lanes;
  for (int b = tid; b < lanes; b += kThreads) {
    float best = -INFINITY;
    unsigned off = 0;
#pragma unroll
    for (int s = 0; s < kBin; ++s) {
      const float x = acc[s * lanes + b];
      const float score = x > 0.0f ? x : -INFINITY;
      if (score > best) {
        best = score;
        off = s;
      }
    }
    dst[b] = isfinite(best) ? __uint_as_float((__float_as_uint(best) & 0xFFFFFFF0u) | off)
                            : -INFINITY;
  }
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// q_terms: [nq, kq] int32; q_weights: [nq, kq] f32; post_doc: [vp1, c, capc]
// uint16; post_imp: [vp1, c, capc] f16; out: [nq, c * dpc / 16] f32; all
// contiguous.  Requires dpc = 128 * H with H a multiple of 16 in [16, 128].
extern "C" int scatter_binmax(const void* q_terms, const void* q_weights, const void* post_doc,
                              const void* post_imp, void* out, int nq, int kq, int vp1, int c,
                              int capc, int dpc, void* stream) {
  if (dpc % 2048 != 0 || dpc < 2048 || dpc > 16384 || nq < 1 || nq > 65535 || c < 1 ||
      kq < 1 || capc < 1 || vp1 < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)dpc * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(scatter_binmax_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(c, nq);
  scatter_binmax_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(q_terms), static_cast<const float*>(q_weights),
      static_cast<const uint16_t*>(post_doc), static_cast<const __half*>(post_imp),
      static_cast<float*>(out), kq, vp1, c, capc, dpc);
  return (int)cudaGetLastError();
}

extern "C" const char* scatter_binmax_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
