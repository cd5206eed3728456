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
// more than the loads themselves. Instead each CTA keeps 32 copies of the
// 256-bin histogram in shared memory, bin b of copy c at word 32 b + c,
// and lane l of every warp counts into copy l: the 32 lanes of one atomic
// add always hit 32 different banks, whatever the bytes (a run of one
// value included), so every shared atomic is one conflict-free wavefront
// and its result is never waited for. The copies are 32-bit, so no
// counter needs flushing before a member ends (per-thread 8-bit counters
// would need a flush every 255 bytes a thread, a pass over 256 counters a
// thread, doubling the shared traffic). 32 KiB of copies per 512-thread
// CTA leave room for 3 CTAs (48 warps) per SM, enough 16-byte loads in
// flight to cover device latency.
//
// Work is divided by bytes, not by member: the B members' 16-byte groups
// (quads) form one index space of `total_quads`, and CTA i takes the i-th
// contiguous share of it. Each CTA finds the members its share touches
// with a block-wide prefix of their quad counts (from `lengths` on the card
// or the one `length`, 512 members a round), counts each member's part,
// then folds its 32 copies into the member's global histogram with one
// atomic add per nonzero bin and resets them. A ragged batch costs what
// its bytes cost; the longest member no longer sets the time.
//
// Bytes at index >= length are masked in the kernel and not counted, so
// the counts are exact for `length` (the TPU kernel counts the tail into
// bin 0 and its host wrapper subtracts it; the result is the same). The
// checksum XORs each word masked to its bytes below `length` into a
// per-thread register, folded by warp shuffles and merged with one
// atomicXor per warp and member (the 8-bit fold is linear over XOR).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 3;  // CTAs per SM the launch bound asks for
constexpr int kCopies = 32;
constexpr int kUnroll = 2;     // 16-byte loads in flight per thread

__device__ __forceinline__ uint32_t fold8(uint32_t x) {
  x ^= x >> 16;
  x ^= x >> 8;
  return x & 0xffu;
}

// Inclusive prefix of v over the CTA; *total gets the CTA's sum. Every
// thread must call it; s_warp is reused only after a later __syncthreads.
__device__ __forceinline__ long long block_scan(long long v, long long* s_warp,
                                                long long* total) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += y;
  }
  if (lane == 31) s_warp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < kWarps ? s_warp[lane] : 0;
    for (int d = 1; d < kWarps; d <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kWarps) s_warp[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += s_warp[warp - 1];
  *total = s_warp[kWarps - 1];
  return v;
}

// The 4 bytes of one word into copy `my` (the lane's).
__device__ __forceinline__ void count4(unsigned* my, uint32_t w) {
  atomicAdd(my + ((w << 5) & 0x1fe0u), 1u);
  atomicAdd(my + ((w >> 3) & 0x1fe0u), 1u);
  atomicAdd(my + ((w >> 11) & 0x1fe0u), 1u);
  atomicAdd(my + ((w >> 19) & 0x1fe0u), 1u);
}

// The 16 bytes of quad q of a member of `length` bytes; the checksum too.
__device__ __forceinline__ void count_quad(unsigned* my, const uint4 p,
                                           long long q, long long length,
                                           uint32_t& x) {
  const long long rem = length - q * 16;
  if (rem >= 16) {
    count4(my, p.x);
    count4(my, p.y);
    count4(my, p.z);
    count4(my, p.w);
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
    for (int i = 0; i < 4 && i < r; ++i) {
      atomicAdd(my + (((w >> (8 * i)) & 0xffu) << 5), 1u);
    }
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
hist_kernel(const uint32_t* __restrict__ data_all, long long batch,
            long long row_quads, long long length_all,
            const long long* __restrict__ lengths, long long total_quads,
            unsigned* __restrict__ hist_all, unsigned* __restrict__ cks_all,
            long long stride32) {
  __shared__ unsigned sh[256 * kCopies];
  __shared__ long long s_start[kThreads];
  __shared__ long long s_warp[kWarps];

  const int lane = threadIdx.x % 32;
  const long long chunk = (total_quads + gridDim.x - 1) / gridDim.x;
  const long long q0 = (long long)blockIdx.x * chunk;
  const long long q1 = q0 + chunk < total_quads ? q0 + chunk : total_quads;
  if (q0 >= q1) return;  // the whole CTA: an empty share
  for (int i = threadIdx.x; i < 256 * kCopies; i += kThreads) sh[i] = 0;
  unsigned* my = sh + lane;

  long long carry = 0;  // quads of the members before this round
  for (long long r0 = 0; r0 < batch && carry < q1; r0 += kThreads) {
    const long long m = r0 + threadIdx.x;
    long long nq = 0;
    if (m < batch) {
      const long long len = lengths == nullptr ? length_all : lengths[m];
      nq = (len + 15) / 16;
      if (nq > row_quads) nq = row_quads;
    }
    long long total;
    const long long incl = block_scan(nq, s_warp, &total);
    s_start[threadIdx.x] = carry + incl - nq;
    __syncthreads();

    const int nm = batch - r0 < kThreads ? (int)(batch - r0) : kThreads;
    for (int j = 0; j < nm; ++j) {
      const long long st = s_start[j];
      if (st >= q1) break;
      const long long en = j + 1 < nm ? s_start[j + 1] : carry + total;
      const long long lo = st > q0 ? st : q0;
      const long long hi = en < q1 ? en : q1;
      if (lo >= hi) continue;

      // ---- member r0 + j, its quads [lo - st, hi - st) ----
      const long long mm = r0 + j;
      const uint4* __restrict__ data =
          reinterpret_cast<const uint4*>(data_all + mm * stride32);
      const long long length = lengths == nullptr ? length_all : lengths[mm];
      const long long a = lo - st;
      const long long b = hi - st;
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
      // fold the copies into the member's histogram (bin t, copies read
      // in a rotated order so a warp's 32 bins hit 32 banks) and reset them
      for (int bin = threadIdx.x; bin < 256; bin += kThreads) {
        unsigned s = 0;
#pragma unroll 8
        for (int c = 0; c < kCopies; ++c) {
          const int i = bin * kCopies + ((c + bin) & (kCopies - 1));
          s += sh[i];
          sh[i] = 0;
        }
        if (s) atomicAdd(&hist_all[256 * mm + bin], s);
      }
      if (cks_all != nullptr) {
        for (int d = 16; d > 0; d >>= 1) x ^= __shfl_xor_sync(0xffffffffu, x, d);
        const uint32_t f = fold8(x);
        if (lane == 0 && f) atomicXor(&cks_all[mm], f);
      }
      __syncthreads();
    }
    carry += total;
    __syncthreads();  // s_start and s_warp are rewritten next round
  }
}

int launch_hist(const void* data, long long batch, long long row_quads,
                long long length, const void* lengths, long long total_quads,
                void* hist, void* cks, long long stride32, void* stream) {
  if (batch <= 0) return (int)cudaGetLastError();
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(hist_kernel,
                                       cudaFuncAttributePreferredSharedMemoryCarveout,
                                       cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hist_kernel, kThreads, 0);
  // one wave, and at least 8 quads a thread
  long long blocks = (total_quads + kThreads * 8 - 1) / (kThreads * 8);
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  hist_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(data), batch, row_quads, length,
      static_cast<const long long*>(lengths), total_quads,
      static_cast<unsigned*>(hist), static_cast<unsigned*>(cks), stride32);
  return (int)cudaGetLastError();
}

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
  return launch_hist(data, batch, row_quads, length, lengths, total_quads, hist,
                     cks, stride32, stream);
}

// The kernel's resources: registers a thread, static and dynamic shared
// bytes a CTA, local (spilled) bytes a thread, threads a CTA and CTAs per
// SM at its launch shape, into out[0..5].
extern "C" int dtt_hist_resources(int config, int* out) {
  (void)config;  // one configuration
  cudaError_t e = cudaFuncSetAttribute(hist_kernel,
                                       cudaFuncAttributePreferredSharedMemoryCarveout,
                                       cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, hist_kernel);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hist_kernel, kThreads, 0);
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = 0;
  out[3] = (int)a.localSizeBytes;
  out[4] = kThreads;
  out[5] = per_sm;
  return (int)e;
}
