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
// Design: a grid-stride pass. Each thread reads 16 bytes as one 16-byte
// load, so loads are full-width and coalesced. The histogram lives in
// shared memory, one 256-bin copy per warp; for each byte position, lanes
// holding equal bytes are merged with __match_any_sync first, so skewed
// data (long runs of one value, a handful of exponents) does not serialise
// on one shared-memory address. Bytes at index >= length are masked in the
// kernel and not counted, so the counts are exact for `length` (the TPU
// kernel counts the tail into bin 0 and its driver subtracts it; the
// result is the same). The checksum XORs each word masked to its bytes
// below `length` into a per-thread register, folded by warp shuffles and
// merged with one atomicXor per warp (the 8-bit fold is linear over XOR).
//
// Batched (the vmapped histogram_u8_pallas of the TPU path's one-grid batch
// encode): grid y is the member. Member m reads row m of the bytes, up to
// its own length from a device array (or one length for every member), and
// counts into histogram row m and checksum m.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNoSymbol = 256;

__device__ __forceinline__ uint32_t fold8(uint32_t x) {
  x ^= x >> 16;
  x ^= x >> 8;
  return x & 0xffu;
}

__global__ void __launch_bounds__(kThreads)
hist_kernel(const uint32_t* __restrict__ data_all, long long row_quads,
            long long length_all, const long long* __restrict__ lengths,
            unsigned* __restrict__ hist_all, unsigned* __restrict__ cks_all,
            long long stride32) {
  __shared__ unsigned sh[kWarps][256];
  const long long m = blockIdx.y;
  const uint4* __restrict__ data =
      reinterpret_cast<const uint4*>(data_all + m * stride32);
  const long long length = lengths == nullptr ? length_all : lengths[m];
  long long n_quad = (length + 15) / 16;
  if (n_quad > row_quads) n_quad = row_quads;
  unsigned* __restrict__ hist = hist_all + 256 * m;
  unsigned* __restrict__ cks = cks_all == nullptr ? nullptr : cks_all + m;
  for (int i = threadIdx.x; i < kWarps * 256; i += kThreads) {
    (&sh[0][0])[i] = 0;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  uint32_t x = 0;
  const long long stride = (long long)gridDim.x * kThreads;
  // the trip count is uniform across each warp (the loop runs over
  // block-aligned bases), as __match_any_sync requires
  for (long long base = (long long)blockIdx.x * kThreads; base < n_quad;
       base += stride) {
    const long long o = base + threadIdx.x;
    const bool in = o < n_quad;
    const uint4 p = in ? data[o] : make_uint4(0, 0, 0, 0);
    const uint32_t pw[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long rem = length - (o * 4 + k) * 4;
      const uint32_t w = pw[k];
      if (rem >= 4) {
        x ^= w;
      } else if (rem > 0) {
        x ^= w & ((1u << (8 * rem)) - 1u);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t key = (in && q < rem) ? (w >> (8 * q)) & 0xffu : kNoSymbol;
        const unsigned peers = __match_any_sync(0xffffffffu, key);
        if (key != kNoSymbol && lane == __ffs(peers) - 1) {
          atomicAdd(&sh[warp][key], (unsigned)__popc(peers));
        }
      }
    }
  }
  __syncthreads();

  for (int b = threadIdx.x; b < 256; b += kThreads) {
    unsigned s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += sh[w][b];
    if (s) atomicAdd(&hist[b], s);
  }
  if (cks != nullptr) {
    for (int d = 16; d > 0; d >>= 1) x ^= __shfl_xor_sync(0xffffffffu, x, d);
    const uint32_t f = fold8(x);
    if (lane == 0 && f) atomicXor(cks, f);
  }
}

int launch_hist(const void* data, long long batch, long long row_quads,
                long long length, const void* lengths, void* hist, void* cks,
                long long stride32, void* stream) {
  if (batch <= 0) return (int)cudaGetLastError();
  int dev = 0;
  int sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (row_quads + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * 8 / batch;  // one wave in all
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  hist_kernel<<<dim3((unsigned)blocks, (unsigned)batch), kThreads, 0,
                (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(data), row_quads, length,
      static_cast<const long long*>(lengths), static_cast<unsigned*>(hist),
      static_cast<unsigned*>(cks), stride32);
  return (int)cudaGetLastError();
}

}  // namespace

// data: `batch` rows of row_quads * 16 bytes (16-byte aligned) at a stride
// of stride32 u32 (a multiple of 4); member m counts the first lengths[m]
// bytes of its row (int64, <= 16 row_quads), or the first `length` when
// `lengths` is null, into hist + 256 m (zeroed by the caller) and cks + m
// (zeroed by the caller; null when no checksum is wanted).
extern "C" int dtt_hist(const void* data, long long batch, long long row_quads,
                        long long length, const void* lengths, void* hist,
                        void* cks, long long stride32, void* stream) {
  return launch_hist(data, batch, row_quads, length, lengths, hist, cks,
                     stride32, stream);
}
