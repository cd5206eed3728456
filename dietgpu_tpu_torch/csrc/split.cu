// Float split for f16/bf16 with the exponent histogram and checksum fused.
//
// Replaces: dietgpu_tpu/floatcodec/pallas_float.py:_split_kernel
// (split_words_pallas), the reference's splitFloat (GpuFloatCompress.cuh).
//
// Bound on the H100: bytes. Each word is read once (2 B) and its two byte
// planes are written once (1 B + 1 B), so the least time is 4 B per word
// over 3.35 TB/s; the histogram and checksum add no device-memory traffic.
//
// Design: a grid-stride elementwise pass. Each thread reads 8 words as one
// 16-byte load and writes 8 exponent bytes and 8 nonComp bytes as two
// 8-byte stores, so loads and stores are full-width and coalesced. Words at
// index >= length are masked to zero in-kernel (odd lengths included), so
// the caller needs no padding copy. The histogram lives in shared memory,
// one 256-bin copy per warp; lanes holding equal exponent bytes are merged
// with __match_any_sync first, so the heavily skewed exponent distribution
// of real data does not serialise on one shared-memory address. Masked
// words are not counted, so the histogram is exact for `length`. The XOR
// checksum is a per-thread register folded by warp shuffles and merged into
// global memory with one atomicXor per warp (the 8-bit fold is linear over
// XOR, so folding before merging is exact).
//
// Batched (the vmapped split_words_pallas of float_compress_batched_pallas):
// grid y is the member. Member m reads row m of the word pairs, writes row m
// of the exponent plane and its nonComp plane into row m of the caller's
// buffer (the members' containers), and counts into histogram row m and
// checksum m. Each member reads its own length from a device array (the
// ragged batches of the API), or every member takes one length.

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
split_kernel(const uint32_t* __restrict__ pairs_all, long long n_oct,
             long long length_all, const long long* __restrict__ lengths, int bf16,
             uint32_t* __restrict__ exp_all,
             uint32_t* __restrict__ nc_all, unsigned* __restrict__ hist_all,
             unsigned* __restrict__ cks_all, long long in_stride32,
             long long exp_stride32, long long nc_stride32) {
  __shared__ unsigned sh[kWarps][256];
  const long long m = blockIdx.y;
  const long long length = lengths == nullptr ? length_all : lengths[m];
  const uint4* __restrict__ pairs =
      reinterpret_cast<const uint4*>(pairs_all + m * in_stride32);
  uint2* __restrict__ exp_out = reinterpret_cast<uint2*>(exp_all + m * exp_stride32);
  uint2* __restrict__ nc_out = reinterpret_cast<uint2*>(nc_all + m * nc_stride32);
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
  for (long long base = (long long)blockIdx.x * kThreads; base < n_oct;
       base += stride) {
    const long long o = base + threadIdx.x;
    const bool in = o < n_oct;
    const uint4 p = in ? pairs[o] : make_uint4(0, 0, 0, 0);
    const uint32_t pw[4] = {p.x, p.y, p.z, p.w};
    uint32_t e[2] = {0, 0};
    uint32_t nc[2] = {0, 0};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      uint32_t w = (pw[k >> 1] >> (16 * (k & 1))) & 0xffffu;
      const bool valid = in && (o * 8 + k < length);
      if (!valid) w = 0;
      x ^= w;
      if (bf16) w = ((w << 1) | (w >> 15)) & 0xffffu;
      const uint32_t c = w >> 8;
      e[k >> 2] |= c << (8 * (k & 3));
      nc[k >> 2] |= (w & 0xffu) << (8 * (k & 3));
      const uint32_t key = valid ? c : kNoSymbol;
      const unsigned peers = __match_any_sync(0xffffffffu, key);
      if (key != kNoSymbol && lane == __ffs(peers) - 1) {
        atomicAdd(&sh[warp][key], (unsigned)__popc(peers));
      }
    }
    if (in) {
      exp_out[o] = make_uint2(e[0], e[1]);
      nc_out[o] = make_uint2(nc[0], nc[1]);
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

int launch_split(const void* pairs, long long batch, long long n_oct,
                 long long length, const void* lengths, int bf16, void* exp_out,
                 void* nc_out,
                 void* hist, void* cks, long long in_stride32,
                 long long exp_stride32, long long nc_stride32, void* stream) {
  if (batch <= 0) return (int)cudaGetLastError();
  int dev = 0;
  int sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (n_oct + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * 8 / batch;  // one wave in all
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  split_kernel<<<dim3((unsigned)blocks, (unsigned)batch), kThreads, 0,
                 (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(pairs), n_oct, length,
      static_cast<const long long*>(lengths), bf16,
      static_cast<uint32_t*>(exp_out), static_cast<uint32_t*>(nc_out),
      static_cast<unsigned*>(hist), static_cast<unsigned*>(cks), in_stride32,
      exp_stride32, nc_stride32);
  return (int)cudaGetLastError();
}

}  // namespace

// `batch` members, member m of length lengths[m] (n_oct * 8 at most), or of
// `length` each when `lengths` is null. Member m's pairs (n_oct * 4 u32
// word pairs, 16-byte aligned), exponent plane and nonComp plane (n_oct * 8
// bytes each, 8-byte aligned) are at u32 m * in_stride32, m * exp_stride32
// and m * nc_stride32; words at index >= its length are treated as zero. hist:
// 256 u32 per member, zeroed by the caller. cks: one u32 per member, zeroed
// by the caller, or null when no checksum is wanted.
extern "C" int dtt_split(const void* pairs, long long batch, long long n_oct,
                         long long length, const void* lengths, int bf16,
                         void* exp_out, void* nc_out, void* hist, void* cks,
                         long long in_stride32, long long exp_stride32,
                         long long nc_stride32, void* stream) {
  return launch_split(pairs, batch, n_oct, length, lengths, bf16, exp_out, nc_out,
                      hist, cks, in_stride32, exp_stride32, nc_stride32, stream);
}
