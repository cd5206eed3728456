// Float split for f32 with the exponent histogram and checksum fused.
//
// Replaces: dietgpu_tpu/floatcodec/pallas_float.py:_split_kernel_f32
// (split_words_pallas_f32), the reference's splitFloat for the two-plane
// f32 layout (GpuFloatCompress.cuh, GpuFloatUtils.cuh:181-203).
//
// Bound on the H100: bytes. Each word is read once (4 B) and its three
// planes are written once (1 B exponent, 2 B low, 1 B high), so the least
// time is 8 B per word over 3.35 TB/s; the histogram and checksum add no
// device-memory traffic.
//
// Design: a grid-stride elementwise pass. Each thread reads 4 words as one
// 16-byte load, rotates each left by 1 (v = rotl32(w, 1)) and writes their
// 4 exponent bytes (v >> 24), 4 low u16 (v & 0xffff) and 4 high bytes
// ((v >> 16) & 0xff) as one 4-byte, one 8-byte and one 4-byte store, so a
// warp's stores are whole coalesced lines. Words at index >= length are
// masked to zero in-kernel. The codec points the planes straight into the
// float container (container mode, hi_out null): the low plane at lo_out,
// the high plane right after its archived 2 * round_up(n, 8) bytes, and
// the ANS archive right after the high plane's round_up(n, 16) bytes. There
// a plane stops at its archived length, because its zero tail would
// overwrite the next section within the same launch, and the high plane's
// offset follows from the member's own length. The histogram is one
// 256-bin shared-memory copy per warp; lanes holding equal exponent
// bytes are merged with __match_any_sync first, since the exponents of real
// data fall in a handful of values. Masked words are not counted. The XOR
// checksum of the words is a per-thread register folded by warp shuffles
// and merged with one atomicXor per warp.
//
// Batched (the vmapped split_words_pallas_f32 of
// float_compress_batched_pallas): one 1-D grid, `per` CTAs a member (CTA x
// works on member x / per), so any B launches. Member m reads row m
// of the words, writes row m of the exponent plane, its low and high planes
// into row m of the caller's buffer (the members' containers), each still
// stopping at its archived length, and counts into histogram row m and
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
split_f32_kernel(const uint32_t* __restrict__ words_all, long long n_quad,
                 long long length_all, const long long* __restrict__ lengths,
                 uint32_t* __restrict__ exp_all, uint32_t* __restrict__ lo_all,
                 uint32_t* __restrict__ hi_all, unsigned* __restrict__ hist_all,
                 unsigned* __restrict__ cks_all,
                 long long in_stride32, long long exp_stride32,
                 long long plane_stride32, unsigned per) {
  __shared__ unsigned sh[kWarps][256];
  const long long m = blockIdx.x / per;
  const long long length = lengths == nullptr ? length_all : lengths[m];
  const uint4* __restrict__ words =
      reinterpret_cast<const uint4*>(words_all + m * in_stride32);
  uint32_t* __restrict__ exp_out = exp_all + m * exp_stride32;
  uint32_t* const lo_row = lo_all + m * plane_stride32;
  uint2* __restrict__ lo_out = reinterpret_cast<uint2*>(lo_row);
  uint32_t* __restrict__ hi_out;
  long long lo_quads = n_quad;
  long long hi_quads = n_quad;
  if (hi_all == nullptr) {  // container mode: the archived lengths only
    const long long lo32 = (length + 7) / 8 * 4;  // round_up(n, 8) / 2
    hi_out = lo_row + lo32;
    lo_quads = lo32 / 2;
    hi_quads = (length + 15) / 16 * 4;  // round_up(n, 16) / 4
  } else {
    hi_out = hi_all + m * plane_stride32;
  }
  unsigned* __restrict__ hist = hist_all + 256 * m;
  unsigned* __restrict__ cks = cks_all == nullptr ? nullptr : cks_all + m;
  for (int i = threadIdx.x; i < kWarps * 256; i += kThreads) {
    (&sh[0][0])[i] = 0;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  uint32_t x = 0;
  const long long stride = (long long)per * kThreads;
  // the trip count is uniform across each warp (the loop runs over
  // block-aligned bases), as __match_any_sync requires
  for (long long base = (long long)(blockIdx.x % per) * kThreads; base < n_quad;
       base += stride) {
    const long long o = base + threadIdx.x;
    const bool in = o < n_quad;
    const uint4 p = in ? words[o] : make_uint4(0, 0, 0, 0);
    const uint32_t pw[4] = {p.x, p.y, p.z, p.w};
    uint32_t e = 0;
    uint32_t h = 0;
    uint32_t l[2] = {0, 0};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool valid = in && (o * 4 + k < length);
      const uint32_t w = valid ? pw[k] : 0u;
      x ^= w;
      const uint32_t v = (w << 1) | (w >> 31);
      const uint32_t c = v >> 24;
      e |= c << (8 * k);
      h |= ((v >> 16) & 0xffu) << (8 * k);
      l[k >> 1] |= (v & 0xffffu) << (16 * (k & 1));
      const uint32_t key = valid ? c : kNoSymbol;
      const unsigned peers = __match_any_sync(0xffffffffu, key);
      if (key != kNoSymbol && lane == __ffs(peers) - 1) {
        atomicAdd(&sh[warp][key], (unsigned)__popc(peers));
      }
    }
    if (in) {
      exp_out[o] = e;
      if (o < lo_quads) lo_out[o] = make_uint2(l[0], l[1]);
      if (o < hi_quads) hi_out[o] = h;
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

int launch_split_f32(const void* words, long long batch, long long n_quad,
                     long long length, const void* lengths, void* exp_out,
                     void* lo_out, void* hi_out, void* hist, void* cks,
                     long long in_stride32,
                     long long exp_stride32, long long plane_stride32,
                     void* stream) {
  if (batch <= 0) return (int)cudaGetLastError();
  int dev = 0;
  int sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (n_quad + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * 8 / batch;  // one wave in all
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  split_f32_kernel<<<(unsigned)(blocks * batch), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(words), n_quad, length,
      static_cast<const long long*>(lengths), static_cast<uint32_t*>(exp_out),
      static_cast<uint32_t*>(lo_out), static_cast<uint32_t*>(hi_out),
      static_cast<unsigned*>(hist), static_cast<unsigned*>(cks), in_stride32,
      exp_stride32, plane_stride32, (unsigned)blocks);
  return (int)cudaGetLastError();
}

}  // namespace

// `batch` members, member m of length lengths[m] (4 * n_quad at most), or of
// `length` each when `lengths` is null. Member m's words (n_quad * 4 u32,
// 16-byte aligned) and exponent plane (n_quad u32, 4 exponent bytes each)
// are at u32 m * in_stride32 and m * exp_stride32; words at index >= its
// length are treated as zero. Its low plane (8-byte aligned; 4 u16 a quad)
// starts at lo_out + m * plane_stride32. With hi_out given, its high plane
// (4 bytes a quad) starts at hi_out + m * plane_stride32 and both planes get
// all n_quad quads; with hi_out null (container mode), the low plane gets
// quads [0, round_up(n, 8) / 4) and the high plane quads
// [0, round_up(n, 16) / 4) right after it, at u32 round_up(n, 8) / 2 past
// the low plane's start. hist: 256 u32 per member, zeroed by the caller.
// cks: one u32 per member, zeroed by the caller, or null when no checksum
// is wanted.
extern "C" int dtt_split_f32(const void* words, long long batch,
                             long long n_quad, long long length,
                             const void* lengths, void* exp_out, void* lo_out,
                             void* hi_out, void* hist, void* cks,
                             long long in_stride32, long long exp_stride32,
                             long long plane_stride32, void* stream) {
  return launch_split_f32(words, batch, n_quad, length, lengths, exp_out, lo_out,
                          hi_out, hist, cks, in_stride32, exp_stride32,
                          plane_stride32, stream);
}
