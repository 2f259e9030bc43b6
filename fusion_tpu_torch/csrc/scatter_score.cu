// Scatter scorer over the chunked impact index on Hopper (sm_90a): the
// SPLADE leg of scale mode, and its pre-gathered forms.
//
// scatter_binmax replaces the TPU kernel
// fusion_tpu/ops/scatter_score.py::_scatter_kernel (driven there by
// _fused_scatter_search and scatter_impact_search).  scatter_pregathered
// (scatter_runs_kernel, below: P5 and P4) replaces
// scripts/probe_scatter_kernel.py::_b3d_kernel (chunk-major operands, the
// rank-3 form of the same function) and
// scripts/probe_scatter_layout.py::_kernel_nt (term-major operands read
// without a transpose), on the same design.
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
// only because the TPU has no scatter.  Here the scatter is real: per
// (query, chunk) item an f32 accumulator of dpc floats in shared memory
// (64 KB at dpc 16,384), one shared-memory add per posting read from the
// index rows (no gathered [Q, C, Kq*capc] copy in device memory), then the
// bin pass over the accumulator.
//
// What bounds it: device memory is the floor -- the real query terms' rows,
// 4 bytes a posting, and the bins written (0.123 ms at the mMARCO serving
// shape) -- but the shared-memory work of every item costs more on this
// card: the shared f32 atomicAdd has no native instruction on sm_90a (the
// SASS is an ATOMS.CAST.SPIN compare-and-swap loop: a load, an add and a CAS
// per posting, retried on a collision), and the bin pass reads all dpc words
// of every item, ~16 instructions per bin.  With 64 KB accumulators only two
// blocks fit an SM, so the per-item phases (stage, scatter, bin) are bound
// by instructions and latency: every instruction and barrier per item
// counts.
// The first ports (one 512-thread block per item, 34,816 blocks at the
// serving shape) also zeroed all dpc words per item, and each thread's
// posting loop was a chain of dependent global loads (term, then doc and
// impact, then the atomic) with nothing in flight across items.
//
// Design (scatter_binmax_kernel):
//   * Persistent CTAs, as many as fit the card (2 per SM at the serving
//     layout), each walking a contiguous range of items in (query, chunk)
//     order: a CTA's consecutive items share a query, so the query's terms
//     stay in L1 and its bf16 weights are staged once.  Positions advance by
//     additions: no division in the item loop.  (An order that keeps
//     neighbouring chunks of one query in flight across CTAs measured no
//     faster.)
//   * The posting rows of the item kDepth - 1 ahead are prefetched while the
//     current item is scattered and binned: 16-byte cp.async copies into a
//     ring of kDepth item slots (3 where three fit beside the accumulator
//     with two CTAs per SM, else 2), one commit group per item.  A
//     (term, chunk) row is 2*capc bytes of doc ids plus as many of impacts,
//     contiguous in [V+1, C, capc]: 64 + 64 bytes at capc 32 -- too small
//     for TMA tensor boxes (one request per term, plus a tensor map per
//     call), while cp.async moves them with one 16-byte copy per thread, no
//     registers and no barrier object.  Where 2*capc is not a multiple of 16
//     a row is copied as the 16-byte-aligned span around it (one more copy
//     at most) and read at its offset in the span, kept per slot.
//   * No zero pass per item: the CTA zeroes its accumulator once, and the
//     bin pass clears each word as it reads it, so an item costs two
//     barriers (staged rows ready, scatter done).
//   * A posting lands by a native shared exchange (scatter_add below): the
//     CAS loop runs only for the ~6 % of postings whose word already holds
//     a value (2,048 postings over 16,384 docs per item).
//   * The bin pass gives each thread 4 neighbouring bins: 16 float4 reads
//     (and zero stores) of the accumulator and one float4 store of packed
//     bins.
// The bins of untouched words are computed like the rest: a touched-bin
// bitmap would cost a second shared atomic per posting to skip ~13 % of the
// bins at the serving shape.
//
// The atomics make the order of the f32 additions vary from run to run: a
// doc's score is a sum of at most Kq values, so two runs differ by a few
// ulps, and the packing clears 4 more bits.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>

#include "hopper.cuh"

namespace {

constexpr int kBin = 16;
constexpr int kThreads = 512;
constexpr size_t kMaxSmem = 232448;   // shared memory one block may use on Hopper
constexpr size_t kSmPerTwo = 115712;  // per block with two blocks on an SM (228 KB, 1 KB each reserved)

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// acc += v in shared memory.  The f32 atomicAdd is a compare-and-swap loop
// on sm_90a; the exchange is native.  Most postings are the first to reach
// their word (it is 0: the accumulator starts cleared), so each exchanges
// its value in and is done; a posting that takes out a value already there
// adds that value back (a CAS loop, on collisions only).  Every value taken
// out is put back by its taker, so the word ends as the sum of all values.
__device__ __forceinline__ void scatter_add(float* acc, float v) {
  const int old = atomicExch(reinterpret_cast<int*>(acc), __float_as_int(v));
  if (old != 0) atomicAdd(acc, __int_as_float(old));
}

// Zero the block's dpc-float shared-memory accumulator (dpc % 4 == 0): once
// per CTA, as the bin pass clears what it reads.
__device__ __forceinline__ void zero_acc(float* acc, int dpc) {
  for (int i = threadIdx.x * 4; i < dpc; i += kThreads * 4)
    *reinterpret_cast<float4*>(acc + i) = make_float4(0.f, 0.f, 0.f, 0.f);
}

// a bin's packed maximum: its best score with the offset in the 4 low
// mantissa bits; -inf where no word was > 0 (or the maximum is not finite)
__device__ __forceinline__ float pack(float best, unsigned off) {
  return best > 0.0f && isfinite(best) ? __uint_as_float((__float_as_uint(best) & 0xFFFFFFF0u) | off)
                                       : -INFINITY;
}

// The bin pass over a finished accumulator: score = acc > 0 ? acc : -inf,
// dst[b] = max_{s < 16} score[s * dpc/16 + b] with the lowest s of a tie
// packed into the 4 low mantissa bits; a -inf maximum stays -inf.  Each
// thread takes 4 neighbouring bins (dst 16-byte aligned) and zeroes each
// word after reading it, so the accumulator is clear for the next item.
__device__ __forceinline__ void bin_pack_store(float* acc, float* dst, int dpc) {
  const int lanes = dpc / kBin;
  for (int b = threadIdx.x * 4; b < lanes; b += kThreads * 4) {
    float best[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // only a word > 0 counts
    unsigned off[4] = {0, 0, 0, 0};
#pragma unroll
    for (int s = 0; s < kBin; ++s) {
      float4* p = reinterpret_cast<float4*>(acc + s * lanes + b);
      const float4 x4 = *p;
      *p = make_float4(0.f, 0.f, 0.f, 0.f);
      const float x[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (x[k] > best[k]) {  // strict: a tie keeps the lowest s
          best[k] = x[k];
          off[k] = s;
        }
      }
    }
    *reinterpret_cast<float4*>(dst + b) =
        make_float4(pack(best[0], off[0]), pack(best[1], off[1]), pack(best[2], off[2]),
                    pack(best[3], off[3]));
  }
}

// bytes of one staged posting row: 2*capc rounded up to 16, plus 16 where
// rows do not start on 16-byte boundaries (capc % 8 != 0)
__host__ __device__ inline int row_slot(int capc) {
  return ((2 * capc + 15) & ~15) + (capc % 8 ? 16 : 0);
}
// one item's staged rows: Kq doc-id rows, then Kq impact rows
__host__ __device__ inline size_t item_bytes(int kq, int capc) {
  return (size_t)2 * kq * row_slot(capc);
}
// accumulator, ring, the query's weights and each slot's row offsets
size_t k3_smem(int kq, int capc, int dpc, int depth) {
  return (size_t)dpc * 4 + depth * item_bytes(kq, capc) + (size_t)kq * 4 + (size_t)depth * kq;
}
// ring slots: 3 where two blocks still fit an SM, else 2 (0: not even that fits)
int ring_depth(int kq, int capc, int dpc) {
  if (k3_smem(kq, capc, dpc, 3) <= kSmPerTwo) return 3;
  return k3_smem(kq, capc, dpc, 2) <= kMaxSmem ? 2 : 0;
}

template <int kDepth>
__global__ void __launch_bounds__(kThreads, 2)
scatter_binmax_kernel(const int* __restrict__ q_terms,       // [nq, kq]
                      const float* __restrict__ q_weights,   // [nq, kq]
                      const uint16_t* __restrict__ post_doc, // [vp1, c, capc]
                      const __half* __restrict__ post_imp,   // [vp1, c, capc]
                      float* __restrict__ out,               // [nq, c * dpc / 16]
                      int nq, int kq, int vp1, int c, int capc, int dpc) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);                      // [dpc]
  unsigned char* ring = smem + (size_t)dpc * 4;                      // kDepth x item slots
  const int slot = row_slot(capc);
  const int ibytes = (int)item_bytes(kq, capc);
  float* s_w = reinterpret_cast<float*>(ring + kDepth * ibytes);    // [kq] the query's bf16 weights
  unsigned char* s_off = reinterpret_cast<unsigned char*>(s_w + kq);  // [kDepth][kq] row offsets
  const int tid = threadIdx.x;
  const int width = kq * capc;
  const int per_row = slot / 16;  // 16-byte copies per staged row
  const int span = 2 * per_row;
  const bool unaligned = capc % 8 != 0;
  // this thread's first posting (t, j) and first copy (t, r) of an item, and
  // how they advance per kThreads (no division inside the loops)
  const int pt0 = tid / capc, pj0 = tid % capc, pdt = kThreads / capc, pdj = kThreads % capc;
  const int ct0 = tid / span, cr0 = tid % span, cdt = kThreads / span, cdr = kThreads % span;

  // this CTA's items: a contiguous range in (query, chunk) order, so its
  // consecutive items share a query (its terms stay in L1, its weights are
  // staged once); positions advance by additions, not divisions
  const long long items = (long long)nq * c;
  const long long first = items * blockIdx.x / gridDim.x;
  const int steps = (int)(items * (blockIdx.x + 1) / gridDim.x - first);
  auto advance = [&](int& q, int& chunk) {
    if (++chunk == c) {
      chunk = 0;
      ++q;
    }
  };

  // the 16-byte copies of the next unstaged step's rows into its ring slot,
  // one commit group (empty past the last step)
  int pr = 0, pq = (int)(first / c), pc = (int)(first % c);
  auto stage_rows = [&]() {
    if (pr < steps) {
      unsigned char* dst = ring + (pr % kDepth) * ibytes;
      int t = ct0, r = cr0;
      for (int i = tid; i < kq * span; i += kThreads) {
        const int arr = r >= per_row, k = r - arr * per_row;  // arr 0: doc ids, 1: impacts
        const int term = min(max(__ldg(q_terms + (size_t)pq * kq + t), 0), vp1 - 1);
        const size_t start = ((size_t)term * c + pc) * capc * 2;  // byte offset of the row
        const size_t s16 = start & ~(size_t)15;
        if (r == 0) s_off[(pr % kDepth) * kq + t] = (unsigned char)(start - s16);
        if ((size_t)16 * k < start + 2 * capc - s16) {
          const unsigned char* src =
              (arr ? reinterpret_cast<const unsigned char*>(post_imp)
                   : reinterpret_cast<const unsigned char*>(post_doc)) + s16 + 16 * k;
          cp_async16(dst + (size_t)(arr * kq + t) * slot + 16 * k, src);
        }
        t += cdt;
        r += cdr;
        if (r >= span) {
          r -= span;
          ++t;
        }
      }
      advance(pq, pc);
    }
    ++pr;
    cp_async_commit();
  };

  zero_acc(acc, dpc);
  for (int k = 0; k < kDepth - 1; ++k) stage_rows();
  int q = (int)(first / c), chunk = (int)(first % c), wq = -1;  // wq: the query s_w holds
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kDepth - 2>();  // this thread's copies of this step have landed
    if (q != wq) {
      wq = q;
      for (int t = tid; t < kq; t += kThreads) s_w[t] = round_bf16(q_weights[(size_t)q * kq + t]);
    }
    // every thread's copies and weights visible; the previous step's bin
    // pass has cleared the accumulator and its scatter left its slot, which
    // takes the copies of the step kDepth - 1 ahead
    __syncthreads();
    stage_rows();

    const unsigned char* st = ring + (step % kDepth) * ibytes;
    const unsigned char* offs = s_off + (step % kDepth) * kq;
    int t = pt0, j = pj0;
    for (int e = tid; e < width; e += kThreads) {
      const unsigned char* row = st + t * slot + 2 * j + (unaligned ? offs[t] : 0);
      const int d = *reinterpret_cast<const uint16_t*>(row);
      if (d < dpc) {
        const float imp = round_bf16(__half2float(*reinterpret_cast<const __half*>(row + kq * slot)));
        scatter_add(acc + d, round_bf16(__fmul_rn(imp, s_w[t])));
      }
      t += pdt;
      j += pdj;
      if (j >= capc) {
        j -= capc;
        ++t;
      }
    }
    __syncthreads();
    bin_pack_store(acc, out + ((size_t)q * c + chunk) * (dpc / kBin), dpc);
    advance(q, chunk);
  }
  cp_async_wait<0>();
}

// The same function over postings already gathered per query: int32 docs
// and bf16 values (impact x query weight, rounded to bf16 as the JAX
// package's _gather_postings rounds them).  Chunk c of query q holds
// n_runs runs of run_len postings; posting j of run t sits at
//     q * q_stride + c * c_stride + t * t_stride + j
// which covers both layouts the TPU kernels read:
//   chunk-major [Q, Cp, W]:        one run of W (q_stride Cp*W, c_stride W);
//   term-major  [Q, Kq, Cp, capc]: Kq runs of capc at a stride of Cp*capc
//                                  (q_stride Kq*Cp*capc, c_stride capc).
struct RunArgs {
  const int* docs;
  const __nv_bfloat16* vals;
  long long q_stride, c_stride, t_stride;
  int n_runs, run_len;
};

// A run is staged as the 16-byte-aligned span around it (bulk copies move
// whole aligned 16-byte words): its docs where run_len % 4 != 0 and its
// values where run_len % 8 != 0 may start inside a word, and then take one
// word more.  Slot bytes of one run's docs and of its values:
__host__ __device__ inline int doc_slot(int len) { return ((4 * len + 15) & ~15) + (len % 4 ? 16 : 0); }
__host__ __device__ inline int val_slot(int len) { return ((2 * len + 15) & ~15) + (len % 8 ? 16 : 0); }
// accumulator, then per ring slot: the item's doc spans and value spans,
// its mbarrier, and its runs' (doc, value) offsets in their spans
size_t runs_smem(const RunArgs& a, int dpc, int depth) {
  const int item = a.n_runs * (doc_slot(a.run_len) + val_slot(a.run_len));
  return (size_t)dpc * 4 + (size_t)depth * (item + 8 + 2 * a.n_runs);
}

// P4 and P5 on K3's design (scatter_binmax_kernel above): persistent CTAs
// over contiguous (query, chunk) ranges, a ring of kDepth item slots filled
// kDepth - 1 items ahead, the accumulator zeroed once and cleared by the
// bin pass (two barriers per item), postings landed by scatter_add, no
// division in any loop.  What differs is the staging and the posting loop:
//   * Staging by what the item is.  An item that is one run (chunk-major:
//     W docs, then W values, each contiguous) goes as two 1-D bulk copies
//     (cp.async.bulk, kBulk) of the runs' aligned spans, issued by two lanes
//     of warp 0 and completing on the slot's mbarrier: the copy engine
//     walks the 12 KB, where 768 16-byte cp.async copies an item cost every
//     thread instructions.  An item of many short runs (term-major: Kq runs
//     of capc, 128 + 64 bytes at capc 32) goes as K3's rows do, 16-byte
//     cp.async copies of each run's span by all threads, one commit group
//     per item: one bulk copy per run measured twice as slow there.  Both
//     measured with tools/scatter_ab.py (PERF.md).
//   * Each thread lands a group of 4 postings per step: one 16-byte read of
//     docs and one 8-byte read of values from the slot.  A group is a
//     16-byte word of the doc span, so a run that starts or ends inside a
//     word leaves lanes outside it, which drop out; the group's values sit
//     at an 8-byte boundary of the value span whatever the run's offset
//     (both spans start at a multiple of 4 postings).
// What bounds it: device memory is the floor -- 6 bytes a posting read once
// and the packed bins written, 0.170 ms at the probe shape, against K3's 4
// bytes a posting -- but as for K3 the per-item shared-memory work (the
// scatter and the bin pass) costs more.
template <int kDepth, bool kBulk>
__global__ void __launch_bounds__(kThreads, 2)
scatter_runs_kernel(const RunArgs a,
                    float* __restrict__ out,  // [nq, c * dpc / 16]
                    int nq, int c, int dpc) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);  // [dpc]
  unsigned char* ring = smem + (size_t)dpc * 4;  // kDepth x item slots
  const int dslot = doc_slot(a.run_len), vslot = val_slot(a.run_len);
  const int ibytes = a.n_runs * (dslot + vslot);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + kDepth * ibytes);  // [kDepth] (kBulk)
  unsigned char* s_off = reinterpret_cast<unsigned char*>(bars + kDepth);  // [kDepth][n_runs][2]
  const int tid = threadIdx.x, lane = tid % 32;
  const bool aligned = a.run_len % 8 == 0;  // every span offset is 0
  // 4-posting groups per run (16-byte words of a doc slot); this thread's
  // first group (t, g) and its advance per kThreads
  const int groups = dslot / 16;
  const int gt0 = tid / groups, gg0 = tid % groups, gdt = kThreads / groups, gdg = kThreads % groups;
  // without kBulk: this thread's first 16-byte copy (t, r) of an item (r
  // counts the run's doc words, then its value words) and its advance
  const int dwords = dslot / 16, rwords = dwords + vslot / 16;
  const int ct0 = tid / rwords, cr0 = tid % rwords, cdt = kThreads / rwords, cdr = kThreads % rwords;

  // this CTA's items: a contiguous range in (query, chunk) order; positions
  // advance by additions, not divisions
  const long long items = (long long)nq * c;
  const long long first = items * blockIdx.x / gridDim.x;
  const int steps = (int)(items * (blockIdx.x + 1) / gridDim.x - first);
  auto advance = [&](int& q, int& chunk) {
    if (++chunk == c) {
      chunk = 0;
      ++q;
    }
  };

  // copy i of an item's 2 * n_runs: run i / 2's docs (i even) or values
  // (i odd) from `base`, the item's first posting.  Returns the bytes of its
  // aligned span, whose start and the run's offset in it go to s16 and off.
  auto span = [&](int i, long long base, uintptr_t& s16, uint32_t& off) -> uint32_t {
    const long long p = base + (i >> 1) * a.t_stride;
    const uintptr_t start = i & 1 ? reinterpret_cast<uintptr_t>(a.vals + p)
                                  : reinterpret_cast<uintptr_t>(a.docs + p);
    s16 = start & ~(uintptr_t)15;
    off = (uint32_t)(start - s16);
    return (off + (i & 1 ? 2u : 4u) * a.run_len + 15) & ~15u;
  };
  // the next unstaged step's item into its slot.  kBulk: warp 0 issues the
  // copies; its lanes sum their spans' bytes first, so the slot's barrier
  // expects all of them before any copy can complete on it.  Else every
  // thread issues its 16-byte copies, one commit group per call (empty past
  // the last step).
  int pr = 0, pq = (int)(first / c), pc = (int)(first % c);
  auto stage = [&]() {
    if (pr < steps) {
      const int si = pr % kDepth;
      unsigned char* dst = ring + si * ibytes;
      unsigned char* offs = s_off + si * a.n_runs * 2;
      const long long base = pq * a.q_stride + pc * a.c_stride;
      uintptr_t s16;
      uint32_t off;
      if (!kBulk) {
        int t = ct0, r = cr0;
        for (int i = tid; i < a.n_runs * rwords; i += kThreads) {
          const int arr = r >= dwords, k = r - arr * dwords;  // arr 0: docs, 1: values
          const uint32_t n = span(2 * t + arr, base, s16, off);
          if (k == 0) offs[2 * t + arr] = (unsigned char)off;
          if (16u * k < n)
            cp_async16(dst + (arr ? a.n_runs * dslot + t * vslot : t * dslot) + 16 * k,
                       reinterpret_cast<const void*>(s16 + 16 * k));
          t += cdt;
          r += cdr;
          if (r >= rwords) {
            r -= rwords;
            ++t;
          }
        }
      } else if (tid < 32) {
        uint32_t bytes = 0;
        for (int i = lane; i < 2 * a.n_runs; i += 32) {
          bytes += span(i, base, s16, off);
          offs[i] = (unsigned char)off;
        }
        bytes = __reduce_add_sync(0xffffffffu, bytes);
        if (lane == 0) hopper::mbar_arrive_expect_tx(&bars[si], bytes);
        __syncwarp();
        hopper::fence_proxy_async();  // the slot's earlier reads before the copies' writes
        for (int i = lane; i < 2 * a.n_runs; i += 32) {
          const uint32_t n = span(i, base, s16, off);
          const int t = i >> 1;
          hopper::bulk_load_1d(dst + (i & 1 ? a.n_runs * dslot + t * vslot : t * dslot),
                               reinterpret_cast<const void*>(s16), n, &bars[si]);
        }
      }
      advance(pq, pc);
    }
    ++pr;
    if (!kBulk) cp_async_commit();
  };

  if (kBulk && tid == 0) {
    for (int k = 0; k < kDepth; ++k) hopper::mbar_init(&bars[k], 1);
    hopper::fence_barrier_init();
  }
  zero_acc(acc, dpc);
  __syncthreads();
  for (int k = 0; k < kDepth - 1; ++k) stage();
  int q = (int)(first / c), chunk = (int)(first % c);
  for (int step = 0; step < steps; ++step) {
    const int si = step % kDepth;
    // this step's spans have landed (kBulk), or this thread's copies of them
    if (kBulk)
      hopper::mbar_wait(&bars[si], (step / kDepth) & 1);
    else
      cp_async_wait<kDepth - 2>();
    // the previous step's bin pass has cleared the accumulator and its
    // scatter left its slot, which takes the item kDepth - 1 ahead
    __syncthreads();
    stage();

    const unsigned char* st = ring + si * ibytes;
    const unsigned char* vst = st + a.n_runs * dslot;
    const unsigned char* offs = s_off + si * a.n_runs * 2;
    int t = gt0, g = gg0;
    for (int e = tid; e < a.n_runs * groups; e += kThreads) {
      const int od = aligned ? 0 : offs[2 * t], ov = aligned ? 0 : offs[2 * t + 1];
      const int i0 = 4 * g - od / 4;  // the run's posting in the group's first lane
      if (i0 < a.run_len) {
        const int4 d4 = *reinterpret_cast<const int4*>(st + t * dslot + 16 * g);
        const uint2 v2 = *reinterpret_cast<const uint2*>(vst + t * vslot + ov - od / 2 + 8 * g);
        const unsigned d[4] = {(unsigned)d4.x, (unsigned)d4.y, (unsigned)d4.z, (unsigned)d4.w};
        const float v[4] = {__uint_as_float(v2.x << 16), __uint_as_float(v2.x & 0xFFFF0000u),
                            __uint_as_float(v2.y << 16), __uint_as_float(v2.y & 0xFFFF0000u)};
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (d[k] < (unsigned)dpc && i0 + k >= 0 && i0 + k < a.run_len) scatter_add(acc + d[k], v[k]);
      }
      t += gdt;
      g += gdg;
      if (g >= groups) {
        g -= groups;
        ++t;
      }
    }
    __syncthreads();
    bin_pack_store(acc, out + ((size_t)q * c + chunk) * (dpc / kBin), dpc);
    advance(q, chunk);
  }
  if (!kBulk) cp_async_wait<0>();
}

// Launches `kernel` persistently: as many CTAs as fit the card at `smem`
// bytes, at most one per item.  The shared-memory limit is raised once per
// kernel and device to the largest size asked for (never lowered: another
// size's launch may follow), and the resident-block count is read once per
// kernel, device and size: the queries cost as much host time as the launch.
template <typename... P, typename... A>
int launch_persistent(void (*kernel)(P...), size_t smem, long long items, cudaStream_t stream,
                      A... args) {
  static std::mutex lock;
  static std::map<std::tuple<const void*, int, size_t>, long long> resident;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = hopper::raise_smem_limit(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  long long blocks;
  {
    std::lock_guard<std::mutex> guard(lock);
    const auto key = std::make_tuple(reinterpret_cast<const void*>(kernel), dev, smem);
    auto it = resident.find(key);
    if (it == resident.end()) {
      int sms = 0, per_sm = 0;
      if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
          (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) != cudaSuccess)
        return (int)err;
      it = resident.emplace(key, (long long)sms * std::max(per_sm, 1)).first;
    }
    blocks = it->second;
  }
  const int grid = (int)std::min(items, blocks);
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// q_terms: [nq, kq] int32; q_weights: [nq, kq] f32; post_doc: [vp1, c, capc]
// uint16; post_imp: [vp1, c, capc] f16; out: [nq, c * dpc / 16] f32; all
// contiguous, post_doc and post_imp 16-byte aligned (a row's 16-byte span
// is read whole).  Requires dpc = 128 * H with H a multiple of 16 in
// [16, 128], and two ring slots of kq * capc postings beside the
// accumulator (ops/scatter_score.py::scatter_smem_bytes mirrors the sizes).
extern "C" int scatter_binmax(const void* q_terms, const void* q_weights, const void* post_doc,
                              const void* post_imp, void* out, int nq, int kq, int vp1, int c,
                              int capc, int dpc, void* stream) {
  if (dpc % 2048 != 0 || dpc < 2048 || dpc > 16384 || nq < 1 || c < 1 || kq < 1 || capc < 1 ||
      vp1 < 1 ||
      (reinterpret_cast<uintptr_t>(post_doc) | reinterpret_cast<uintptr_t>(post_imp)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int depth = ring_depth(kq, capc, dpc);
  if (depth == 0) return (int)cudaErrorInvalidValue;
  auto kernel = depth == 3 ? scatter_binmax_kernel<3> : scatter_binmax_kernel<2>;
  return launch_persistent(kernel, k3_smem(kq, capc, dpc, depth), (long long)nq * c,
                           static_cast<cudaStream_t>(stream), static_cast<const int*>(q_terms),
                           static_cast<const float*>(q_weights), static_cast<const uint16_t*>(post_doc),
                           static_cast<const __half*>(post_imp), static_cast<float*>(out), nq, kq, vp1,
                           c, capc, dpc);
}

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// docs: int32, vals: bf16, both contiguous and 16-byte aligned,
// [nq, cp, kq * capc] (layout 0, chunk-major) or [nq, kq, cp, capc]
// (layout 1, term-major); out: [nq, cp * dpc / 16] f32.  Requires
// dpc = 128 * H with H a multiple of 16 in [16, 128], and two ring slots of
// one item beside the accumulator
// (ops/scatter_score.py::pregathered_smem_bytes mirrors the sizes).
extern "C" int scatter_pregathered(const void* docs, const void* vals, void* out, int nq, int cp,
                                   int kq, int capc, int dpc, int layout, void* stream) {
  const long long w = (long long)kq * capc;
  if (dpc % 2048 != 0 || dpc < 2048 || dpc > 16384 || nq < 1 || cp < 1 || kq < 1 || capc < 1 ||
      w > (1 << 20) || (layout != 0 && layout != 1) ||
      (reinterpret_cast<uintptr_t>(docs) | reinterpret_cast<uintptr_t>(vals)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const RunArgs a{static_cast<const int*>(docs), static_cast<const __nv_bfloat16*>(vals),
                  (long long)cp * w,                       // q_stride
                  layout == 0 ? w : capc,                  // c_stride
                  layout == 0 ? w : (long long)cp * capc,  // t_stride
                  layout == 0 ? 1 : kq,                    // n_runs
                  layout == 0 ? (int)w : capc};            // run_len
  // ring slots: 3 where two blocks still fit an SM, else 2; an item of one
  // run is staged by bulk copies
  const int depth = runs_smem(a, dpc, 3) <= kSmPerTwo ? 3 : runs_smem(a, dpc, 2) <= kMaxSmem ? 2 : 0;
  if (depth == 0) return (int)cudaErrorInvalidValue;
  auto kernel = a.n_runs == 1 ? (depth == 3 ? scatter_runs_kernel<3, true> : scatter_runs_kernel<2, true>)
                              : (depth == 3 ? scatter_runs_kernel<3, false> : scatter_runs_kernel<2, false>);
  return launch_persistent(kernel, runs_smem(a, dpc, depth), (long long)nq * cp,
                           static_cast<cudaStream_t>(stream), a, static_cast<float*>(out), nq, cp, dpc);
}

extern "C" const char* scatter_binmax_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
