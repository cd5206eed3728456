// Exact 256-bin byte histogram with the folded XOR checksum fused.
//
// Replaces: dietgpu_tpu/ans/pallas_hist.py:_hist_kernel
// (histogram_u8_pallas), the reference's histogramBatch
// (GpuANSStatistics.cuh:21-143) with the checksum of GpuChecksum.cuh:27-93
// riding the same pass.
//
// Bound on the H100: bytes. The kernel reads each of the first `length`
// bytes once; the 256 counts and the checksum are its only writes, so the
// least time is `length` bytes over 3.35 TB/s.
//
// Design: no warp vote. Merging equal bytes of a warp with a
// __match_any_sync per byte position (16 votes per 16-byte load) costs
// more than the loads themselves. Instead the histogram is the 32
// lane-owned shared copies of byte_hist.cuh, whose every shared atomic is
// one conflict-free wavefront whatever the bytes. The copies are 32-bit,
// so no counter needs flushing before a member ends (per-thread 8-bit
// counters would need a flush every 255 bytes a thread, a pass over 256
// counters a thread, doubling the shared traffic). 32 KiB of copies per
// 512-thread CTA leave room for 3 CTAs (48 warps) per SM, enough 16-byte
// loads in flight to cover device latency.
//
// Work is divided by bytes, not by member: the B members' 16-byte groups
// (quads) form one index space of `total_quads`, and CTA i takes the i-th
// contiguous share of it (byte_hist.cuh's for_each_member: through a
// block-wide prefix of the quad counts, from `lengths` on the card or the
// one `length`, 512 members a round). Each CTA counts each member's part,
// then folds its copies into the member's global histogram and resets
// them. A ragged batch costs what its bytes cost; the longest member no
// longer sets the time.
//
// Bytes at index >= length are masked in the kernel and not counted, so
// the counts are exact for `length` (the TPU kernel counts the tail into
// bin 0 and its host wrapper subtracts it; the result is the same). The
// checksum XORs each word masked to its bytes below `length` into a
// per-thread register, folded by warp shuffles and merged with one
// atomicXor per warp and member (the 8-bit fold is linear over XOR).

#include <cstdint>
#include <cuda_runtime.h>

#include "byte_hist.cuh"
#include "launch.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 3;  // CTAs per SM the launch bound asks for
constexpr int kUnroll = 2;     // 16-byte loads in flight per thread

// The 16 bytes of quad q of a member of `length` bytes; the checksum too.
__device__ __forceinline__ void count_quad(unsigned* my, const uint4 p,
                                           long long q, long long length,
                                           uint32_t& x) {
  const long long rem = length - q * 16;
  if (rem >= 16) {
    dtt::count4(my, p.x);
    dtt::count4(my, p.y);
    dtt::count4(my, p.z);
    dtt::count4(my, p.w);
    x ^= p.x ^ p.y ^ p.z ^ p.w;
    return;
  }
  const uint32_t pw[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long r = rem - 4 * k;
    if (r <= 0) break;
    const uint32_t w = r >= 4 ? pw[k] : pw[k] & ((1u << (8 * r)) - 1u);
    x ^= w;
    dtt::count_first(my, w, r);
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
hist_kernel(const uint32_t* __restrict__ data_all, long long batch,
            long long row_quads, long long length_all,
            const long long* __restrict__ lengths, long long total_quads,
            unsigned* __restrict__ hist_all, unsigned* __restrict__ cks_all,
            long long stride32) {
  __shared__ unsigned sh[dtt::kHistWords];
  __shared__ long long s_start[kThreads];
  __shared__ long long s_warp[kWarps];

  long long q0, q1;
  dtt::cta_share(total_quads, &q0, &q1);
  if (q0 >= q1) return;  // the whole CTA: an empty share
  dtt::clear_copies<kThreads>(sh);
  __syncthreads();
  unsigned* my = sh + threadIdx.x % 32;
  auto len_of = [&](long long m) { return lengths == nullptr ? length_all : lengths[m]; };
  auto quads = [&](long long m) {
    const long long nq = (len_of(m) + 15) / 16;
    return nq < row_quads ? nq : row_quads;
  };
  dtt::for_each_member<kThreads>(
      batch, q0, q1, quads, s_start, s_warp,
      [&](long long m, long long a, long long b) {
        const uint4* __restrict__ data =
            reinterpret_cast<const uint4*>(data_all + m * stride32);
        const long long length = len_of(m);
        uint32_t x = 0;
        for (long long q = a + threadIdx.x; q < b; q += (long long)kThreads * kUnroll) {
          uint4 p[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const long long qu = q + (long long)u * kThreads;
            p[u] = qu < b ? data[qu] : make_uint4(0, 0, 0, 0);
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const long long qu = q + (long long)u * kThreads;
            if (qu < b) count_quad(my, p[u], qu, length, x);
          }
        }
        __syncthreads();
        dtt::fold_member<kThreads>(sh, hist_all + 256 * m, x,
                                   cks_all == nullptr ? nullptr : cks_all + m);
        __syncthreads();
      });
}

// The kernel, with shared memory before L1 (its 32 copies of the bins).
dtt::Kernel kHist(hist_kernel, kThreads, 0, true);

}  // namespace

// data: `batch` rows of row_quads * 16 bytes (16-byte aligned) at a stride
// of stride32 u32 (a multiple of 4); member m counts the first lengths[m]
// bytes of its row (int64, <= 16 row_quads), or the first `length` when
// `lengths` is null, into hist + 256 m (zeroed by the caller) and cks + m
// (zeroed by the caller; null when no checksum is wanted). total_quads is
// the sum over the members of ceil(length / 16).
extern "C" int dtt_hist(const void* data, long long batch, long long row_quads,
                        long long length, const void* lengths,
                        long long total_quads, void* hist, void* cks,
                        long long stride32, void* stream) {
  if (batch <= 0) return (int)cudaGetLastError();
  unsigned blocks = 0;  // one wave, and at least 8 quads a thread
  const cudaError_t e = kHist.wave((total_quads + kThreads * 8 - 1) / (kThreads * 8), &blocks);
  if (e != cudaSuccess) return (int)e;
  hist_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(data), batch, row_quads, length,
      static_cast<const long long*>(lengths), total_quads,
      static_cast<unsigned*>(hist), static_cast<unsigned*>(cks), stride32);
  return (int)cudaGetLastError();
}

// The kernel's resources, into out[0..5] (launch.cuh).
extern "C" int dtt_hist_resources(int config, int* out) {
  (void)config;  // one configuration
  return kHist.report(out);
}
