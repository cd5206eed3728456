// Probability quantization and the encode table, for every member of a
// batch at once (a single input is a batch of one): each member's 256
// symbol counts become weights that sum to exactly 2^prob_bits, and the
// weights become the encode kernel's table.
//
// Replaces: no Pallas kernel. The JAX package computes this between its
// histogram (or split) kernel and its encode kernel as XLA ops
// (dietgpu_tpu/ans/stats.py:normalize_probs and build_encode_table); the
// port ran the same as ~100 torch ops (ans/stats.py:normalize_probs,
// ans/encode.py:encode_table), each its own small kernel on the card. The
// reference computes it in ansCalcWeights (GpuANSStatistics.cuh:179-367).
//
// Bound on the H100: neither bytes (1 KiB in, 3 KiB out a member) nor
// operations; the time is the latency of one CTA's short chain of block
// reductions. It exists to take ~100 launches off every compress.
//
// Design: one CTA of 256 threads a member, thread t holding symbol t, on a
// 1-D grid over the members (any B launches). Bit for bit what
// normalize_probs and encode_table compute:
//
// - quantize: q = trunc(f32(count) / f32(total) * 2^prob_bits) in IEEE
//   round-to-nearest, at least 1 where the count is not 0;
// - deficit (the weights sum below K = 2^prob_bits): +1 a symbol-value pass;
// - excess: the passes that take 1 from the smallest weights above 1, in
//   the descending order of the unique key (q << 16) | sym, solved in the
//   closed form that ans/stats.py documents: the rank of each key is
//   counted over the 256 keys in shared memory (no sort), the number m of
//   full passes is the largest m <= K whose cost C(m) = sum min(m, q - 1)
//   fits the excess (a binary search, one block reduction a step, where
//   the excess reaches the number of weights above 1), and the last
//   partial pass takes 1 from the last ranks still above 1;
// - a total of 0 gives zeros;
// - the table: cdf by a block scan, shift = bit_length(pdf - 1), magic =
//   ((2^shift - pdf) << 32) / pdf + 1 mod 2^32 in 64-bit integers, and
//   e1 = shift << 24 | pdf << 12 | cdf.
//
// Given the weights (a caller's pdfs), the same kernel builds the table
// alone.

#include <cstdint>
#include <cuda_runtime.h>

#include "byte_hist.cuh"
#include "launch.cuh"

namespace {

constexpr int kSyms = 256;
constexpr int kThreads = kSyms;  // a thread a symbol
constexpr int kWarps = kThreads / 32;

// Sum of v over the CTA, in every thread. Every thread must call it.
__device__ __forceinline__ long long block_sum(long long v, long long* s_warp) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  __syncthreads();  // the previous call's readers are done with s_warp
  if (threadIdx.x % 32 == 0) s_warp[threadIdx.x / 32] = v;
  __syncthreads();
  long long t = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += s_warp[w];
  return t;
}

// The weights of symbol threadIdx.x from the member's counts; the CTA's
// threads call it together.
__device__ long long quantize(uint32_t count, uint32_t total, int prob_bits,
                             long long* s_key, long long* s_vals,
                             long long* s_warp) {
  const int t = threadIdx.x;
  const long long K = 1ll << prob_bits;
  const float ratio = total == 0 ? 0.0f : __fdiv_rn((float)count, (float)total);
  long long q = (long long)__fmul_rn(ratio, (float)K);  // K exact in f32
  if (count > 0 && q == 0) q = 1;
  const long long diff = K - block_sum(q, s_warp);
  if (diff > 0) return q + diff / kSyms + (t < diff % kSyms ? 1 : 0);
  if (diff == 0) return q;

  // excess: vals0[r] is the weight of rank r in descending key order
  const long long key = (q << 16) | t;
  s_key[t] = key;
  __syncthreads();
  int rank = 0;
#pragma unroll 8
  for (int j = 0; j < kSyms; ++j) rank += s_key[j] > key;
  s_vals[rank] = q;
  __syncthreads();
  const long long v0 = s_vals[t];  // thread t now holds rank t
  const long long spare = v0 > 1 ? v0 - 1 : 0;
  const long long need = -diff;
  // the largest m in [0, K] with C(m) <= need; C(0) = 0, and C(1) is the
  // number of weights above 1, so an excess below it takes no full pass
  // (N(0,1) exponents: no search)
  const long long c1 = __syncthreads_count(spare > 0);
  long long lo = need < c1 ? 0 : 1, hi = need < c1 ? 0 : K, c_lo = need < c1 ? 0 : c1;
  while (lo < hi) {
    const long long mid = (lo + hi + 1) / 2;
    const long long c = block_sum(spare < mid ? spare : mid, s_warp);
    if (c <= need) {
      lo = mid;
      c_lo = c;
    } else {
      hi = mid - 1;
    }
  }
  long long v = v0 > 1 ? (v0 - lo > 1 ? v0 - lo : 1) : v0;
  const long long r = need - c_lo;
  const long long g = __syncthreads_count(v > 1);
  if (t >= g - r && t < g) v -= 1;
  __syncthreads();  // every thread has read s_vals[t]
  s_vals[t] = v;
  __syncthreads();
  return s_vals[rank];
}

__global__ void __launch_bounds__(kThreads)
tables_kernel(const uint32_t* __restrict__ hist, const uint32_t* __restrict__ pdf_in,
              long long total, const long long* __restrict__ totals, int prob_bits,
              uint32_t* __restrict__ pdfs, uint32_t* __restrict__ table) {
  __shared__ long long s_key[kSyms];
  __shared__ long long s_vals[kSyms];
  __shared__ long long s_warp[kWarps];
  const long long m = blockIdx.x;
  const int t = threadIdx.x;
  uint32_t pdf;
  if (hist != nullptr) {
    const uint32_t tot = (uint32_t)(totals != nullptr ? totals[m] : total);
    const long long q = quantize(hist[m * kSyms + t], tot, prob_bits, s_key, s_vals, s_warp);
    pdf = tot == 0 ? 0u : (uint32_t)q;
    pdfs[m * kSyms + t] = pdf;
  } else {
    pdf = pdf_in[m * kSyms + t];
  }
  // exclusive cdf, mod 2^32 (the low bits of the 64-bit sum)
  __syncthreads();  // quantize's last readers of s_warp are done
  long long sum;
  const uint32_t cdf =
      (uint32_t)(dtt::block_scan<kThreads>((long long)pdf, s_warp, &sum) - pdf);
  const uint32_t p = pdf > 1u ? pdf : 1u;
  const int shift = 32 - __clz(p - 1u);
  const unsigned long long a = (1ull << shift) - p;
  const uint32_t magic = (uint32_t)((a << 32) / p + 1ull);
  table[m * 2 * kSyms + t] = ((uint32_t)shift << 24) | (pdf << 12) | cdf;
  table[m * 2 * kSyms + kSyms + t] = magic;
}

// reported only: its grid is a CTA a member on any card
dtt::Kernel kTables(tables_kernel, kThreads, 0, false);

}  // namespace

// Quantize and tabulate `batch` members: hist holds `batch` rows of 256
// u32 counts, member m's total is totals[m] (int64, its low 32 bits) or
// `total` when totals is null; pdfs gets `batch` rows of 256 u32 weights
// and table `batch` rows of 512 u32 (e1 for the 256 symbols, then magic).
// With hist null, pdf_in holds the weights and only the table is written.
extern "C" int dtt_tables(const void* hist, const void* pdf_in, long long batch,
                          long long total, const void* totals, int prob_bits,
                          void* pdfs, void* table, void* stream) {
  if (batch > 0) {
    tables_kernel<<<(unsigned)batch, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const uint32_t*>(hist), static_cast<const uint32_t*>(pdf_in), total,
        static_cast<const long long*>(totals), prob_bits, static_cast<uint32_t*>(pdfs),
        static_cast<uint32_t*>(table));
  }
  return (int)cudaGetLastError();
}

// The kernel's resources, into out[0..5] (launch.cuh).
extern "C" int dtt_tables_resources(int config, int* out) {
  (void)config;  // one configuration
  return kTables.report(out);
}
