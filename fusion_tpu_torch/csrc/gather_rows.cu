// Candidate-row gather on Hopper (sm_90a): out_s[e] = src_s[idx[e]] for
// several sources that share one index, in one launch.
//
// Replaces the TPU kernel fusion_tpu/ops/gather_rows.py::_gather_kernel
// (driven there by gather_rows_pallas / gather_rows).  PLAID's prune and
// rescore tiers gather the compressed token rows of every candidate: at the
// mMARCO serving shape one call copies Q 64 x K 512 rows of centroid ids
// (int32 [N, 32], 128 B), packed codes (u8 [N, 32, 32], 1,024 B) and the
// token mask (u8 [N, 32], 32 B) out of a 9.13 GB codes array.
//
// What bounds it: pure data movement, ~39 MB read at random rows and
// ~39 MB written per call, so device-memory latency and bandwidth; there
// is no arithmetic to hide anything behind.
//
// Design: one warp per index entry.  The warp reads the row id once (all
// lanes load the same word) and then copies that row of every source, its
// lanes on neighbouring units, so each row read is one or a few coalesced
// transactions.  The copy unit of a source is the widest of 16, 8, 4, 2 and
// 1 bytes that divides its row width and both base addresses (chosen on the
// host), so 1,024-byte code rows move as 16-byte vectors and a ragged row
// (3 bytes, say) still copies exactly byte by byte.  Row offsets are 64-bit:
// row * row_bytes passes 2^32 in the codes array.  Many warps in flight hide
// the row latency that the TPU kernel hid with explicit DMA semaphores; its
// rows_per_block / in_flight pipeline and the f32 row bitcast (a Mosaic
// workaround) have no counterpart here.  Fusing the gather into the
// decompress + MaxSim rescore, so gathered rows never reach device memory,
// is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSrcs = 8;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

struct Sources {
  const unsigned char* src[kMaxSrcs];
  unsigned char* out[kMaxSrcs];
  long long row_bytes[kMaxSrcs];
  int unit[kMaxSrcs];  // copy unit in bytes: 16, 8, 4, 2 or 1
  int n_srcs;
};

template <typename T>
__device__ __forceinline__ void copy_row(const unsigned char* src, unsigned char* dst,
                                         long long units, int lane) {
  const T* s = reinterpret_cast<const T*>(src);
  T* d = reinterpret_cast<T*>(dst);
  for (long long u = lane; u < units; u += 32) d[u] = __ldg(s + u);
}

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(Sources p, const int* __restrict__ idx, long long n_idx) {
  const long long entry = (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (entry >= n_idx) return;
  const long long row = __ldg(idx + entry);
  for (int s = 0; s < p.n_srcs; ++s) {
    const long long rb = p.row_bytes[s];
    const unsigned char* src = p.src[s] + row * rb;
    unsigned char* dst = p.out[s] + entry * rb;
    switch (p.unit[s]) {
      case 16: copy_row<uint4>(src, dst, rb / 16, lane); break;
      case 8: copy_row<uint2>(src, dst, rb / 8, lane); break;
      case 4: copy_row<unsigned int>(src, dst, rb / 4, lane); break;
      case 2: copy_row<unsigned short>(src, dst, rb / 2, lane); break;
      default: copy_row<unsigned char>(src, dst, rb, lane); break;
    }
  }
}

int copy_unit(const void* src, const void* out, long long row_bytes) {
  const unsigned long long bits = (unsigned long long)(uintptr_t)src |
                                  (unsigned long long)(uintptr_t)out |
                                  (unsigned long long)row_bytes;
  for (int unit = 16; unit > 1; unit /= 2)
    if (bits % unit == 0) return unit;
  return 1;
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// srcs[s]: a contiguous array of rows of row_bytes[s] bytes; outs[s]: n_idx
// rows of the same width; idx: n_idx int32 row ids, each already in [0, N).
// Requires 1 <= n_srcs <= 8 and n_idx >= 1.
extern "C" int gather_rows(int n_srcs, const void* const* srcs, void* const* outs,
                           const long long* row_bytes, const void* idx, long long n_idx,
                           void* stream) {
  if (n_srcs < 1 || n_srcs > kMaxSrcs || n_idx < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (n_idx + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  Sources p = {};
  p.n_srcs = n_srcs;
  for (int s = 0; s < n_srcs; ++s) {
    if (row_bytes[s] < 0) return (int)cudaErrorInvalidValue;
    p.src[s] = static_cast<const unsigned char*>(srcs[s]);
    p.out[s] = static_cast<unsigned char*>(outs[s]);
    p.row_bytes[s] = row_bytes[s];
    p.unit[s] = copy_unit(srcs[s], outs[s], row_bytes[s]);
  }
  gather_rows_kernel<<<(unsigned int)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const int*>(idx), n_idx);
  return (int)cudaGetLastError();
}

extern "C" const char* gather_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
