// Standalone float join: the packed exponent and raw planes back to words.
//
// Replaces: dietgpu_tpu/floatcodec/pallas_float.py:_join_kernel
// (join_words_pallas) and :_join_kernel_f32 (join_words_pallas_f32), the
// reference's two-pass joinFloat (GpuFloatDecompress.cuh). The decompress
// paths join inside the decode kernel (csrc/decode.cu); this kernel is the
// planes -> words entry point on its own.
//
// Bound on the H100: bytes. f16/bf16: each word's exponent byte and raw
// byte are read once (2 B) and the word written once (2 B), 4 B per word;
// f32: exponent, high and low planes read once (4 B) and the word written
// once (4 B), 8 B per word; all over 3.35 TB/s. A handful of byte
// permutes per word is far below the operations bound.
//
// Design: a grid-stride elementwise pass over units of 4 words: one u32
// of the exponent plane.
//
// - f16/bf16: the exponent u32 and the matching u32 of the nonComp plane
//   become two output word pairs, each built by one __byte_perm ((exp << 8)
//   | raw per 16-bit half), then rotated right by 1 within each half for
//   bf16. When every plane's rows are 16-byte aligned, each thread takes 4
//   units at once: one 16-byte load per plane and 16-byte stores; a unit
//   past the last whole 4 (an unaligned n4) takes the scalar form.
//   Otherwise every unit takes the scalar form: 4-byte loads and one 8-byte
//   store.
// - f32: one thread a unit, consecutive lanes on consecutive units, so
//   every access of a warp is one contiguous run: 128 bytes of the exponent
//   plane, 128 of the high plane, 256 of the low plane (one 8-byte load a
//   lane when the low plane's rows are 8-byte aligned, else two 4-byte
//   loads, which is the unaligned route) and one 16-byte store a lane, 512
//   bytes. The exponent and high u32 are interleaved by two __byte_perm,
//   each word is completed with its low u16 by one more, then rotated right
//   by 1 (__funnelshift_r). The grid covers every unit: on the card this
//   reads as fast as a copy_ of the same bytes, and one wave of threads
//   that each loaded 4 units a grid stride apart read slower.
//
// Batched: one 1-D grid, `per` CTAs a member (CTA x works on member
// x / per), so any B launches; a member's CTAs stride over its units.
// Member m reads row m of each plane (at its own row stride, so a plane may
// sit inside a larger buffer) and writes row m of the output.

#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotr16x2(uint32_t x) {
  return ((x >> 1) & 0x7fff7fffu) | ((x << 15) & 0x80008000u);
}

// 4 words from one exponent u32 and one nonComp u32: two word pairs
__device__ __forceinline__ uint2 join_half4(uint32_t e, uint32_t m, bool bf16) {
  uint32_t p0 = __byte_perm(m, e, 0x5140);  // m0 e0 m1 e1
  uint32_t p1 = __byte_perm(m, e, 0x7362);  // m2 e2 m3 e3
  if (bf16) {
    p0 = rotr16x2(p0);
    p1 = rotr16x2(p1);
  }
  return make_uint2(p0, p1);
}

// 4 f32 words from one exponent u32, one high u32 and two low u32
__device__ __forceinline__ uint4 join_f32x4(uint32_t e, uint32_t h, uint32_t lo0,
                                            uint32_t lo1) {
  const uint32_t hc0 = __byte_perm(h, e, 0x5140);  // h0 e0 h1 e1
  const uint32_t hc1 = __byte_perm(h, e, 0x7362);  // h2 e2 h3 e3
  uint4 r;
  r.x = __byte_perm(lo0, hc0, 0x5410);
  r.y = __byte_perm(lo0, hc0, 0x7632);
  r.z = __byte_perm(lo1, hc1, 0x5410);
  r.w = __byte_perm(lo1, hc1, 0x7632);
  r.x = __funnelshift_r(r.x, r.x, 1);
  r.y = __funnelshift_r(r.y, r.y, 1);
  r.z = __funnelshift_r(r.z, r.z, 1);
  r.w = __funnelshift_r(r.w, r.w, 1);
  return r;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
join_kernel(const uint32_t* __restrict__ exp_all, const uint32_t* __restrict__ nc_all,
            long long n4, int bf16, uint32_t* __restrict__ out_all,
            long long exp_stride32, long long nc_stride32, long long out_stride32,
            unsigned per) {
  const long long m = blockIdx.x / per;
  const uint32_t* __restrict__ exp = exp_all + m * exp_stride32;
  const uint32_t* __restrict__ nc = nc_all + m * nc_stride32;
  uint32_t* __restrict__ out = out_all + m * out_stride32;
  const long long stride = (long long)per * kThreads;
  const long long t = (long long)(blockIdx.x % per) * kThreads + threadIdx.x;
  long long first = 0;
  if (kVec) {
    const long long n16 = n4 / 4;
    const uint4* __restrict__ e4 = reinterpret_cast<const uint4*>(exp);
    const uint4* __restrict__ m4 = reinterpret_cast<const uint4*>(nc);
    uint4* __restrict__ o4 = reinterpret_cast<uint4*>(out);
    for (long long i = t; i < n16; i += stride) {
      const uint4 e = e4[i];
      const uint4 c = m4[i];
      const uint2 a = join_half4(e.x, c.x, bf16);
      const uint2 b = join_half4(e.y, c.y, bf16);
      const uint2 d = join_half4(e.z, c.z, bf16);
      const uint2 f = join_half4(e.w, c.w, bf16);
      o4[2 * i] = make_uint4(a.x, a.y, b.x, b.y);
      o4[2 * i + 1] = make_uint4(d.x, d.y, f.x, f.y);
    }
    first = 4 * n16;
  }
  uint2* __restrict__ o2 = reinterpret_cast<uint2*>(out);
  for (long long j = first + t; j < n4; j += stride) {
    o2[j] = join_half4(exp[j], nc[j], bf16);
  }
}

template <bool kLo8>
__global__ void __launch_bounds__(kThreads)
join_f32_kernel(const uint32_t* __restrict__ exp_all, const uint32_t* __restrict__ lo_all,
                const uint32_t* __restrict__ hi_all, long long n4,
                uint32_t* __restrict__ out_all, long long exp_stride32,
                long long lo_stride32, long long hi_stride32, long long out_stride32,
                unsigned per) {
  const long long m = blockIdx.x / per;
  const uint32_t* __restrict__ exp = exp_all + m * exp_stride32;
  const uint32_t* __restrict__ lo = lo_all + m * lo_stride32;
  const uint32_t* __restrict__ hi = hi_all + m * hi_stride32;
  uint4* __restrict__ o4 = reinterpret_cast<uint4*>(out_all + m * out_stride32);
  const long long stride = (long long)per * kThreads;
  for (long long j = (long long)(blockIdx.x % per) * kThreads + threadIdx.x; j < n4;
       j += stride) {
    uint32_t l0;
    uint32_t l1;
    if (kLo8) {
      const uint2 l = reinterpret_cast<const uint2*>(lo)[j];
      l0 = l.x;
      l1 = l.y;
    } else {
      l0 = lo[2 * j];
      l1 = lo[2 * j + 1];
    }
    o4[j] = join_f32x4(exp[j], hi[j], l0, l1);
  }
}

// Both joins, vectorized where their rows allow; the f16/bf16 join's grid
// is one wave of 8 CTAs an SM, the f32 join's one CTA a unit.
dtt::Kernel kJoin[2] = {{join_kernel<false>, kThreads, 0, false},
                        {join_kernel<true>, kThreads, 0, false}};
dtt::Kernel kJoinF32(join_f32_kernel<true>, kThreads, 0, false);  // reported only

bool aligned16(const void* p, long long stride32) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (stride32 * 4) % 16 == 0;
}

}  // namespace

// `batch` members of n4 exponent u32 each (4 * n4 words). Member m's
// exponent and nonComp planes (n4 u32 each, 4-byte aligned) are at u32
// m * exp_stride32 and m * nc_stride32; its 2 * n4 output word pairs
// (8-byte aligned) at u32 m * out_stride32. bf16 != 0 rotates each word
// right by 1.
extern "C" int dtt_join(const void* exp, const void* nc, long long batch, long long n4,
                        int bf16, void* out, long long exp_stride32,
                        long long nc_stride32, long long out_stride32, void* stream) {
  if (batch <= 0 || n4 <= 0) return (int)cudaGetLastError();
  const bool vec = aligned16(exp, exp_stride32) && aligned16(nc, nc_stride32) &&
                   aligned16(out, out_stride32);
  const dtt::Fit* fit = nullptr;
  const cudaError_t e = kJoin[vec].fit(&fit);
  if (e != cudaSuccess) return (int)e;
  // a member's CTAs: a unit a thread, one wave of 8 CTAs an SM in all
  long long per = ((vec ? (n4 + 3) / 4 : n4) + kThreads - 1) / kThreads;
  const long long cap = (long long)fit->sms * 8 / batch;  // 0 past 8 members an SM
  if (per > cap) per = cap;
  if (per < 1) per = 1;
  const long long grid = per * batch;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  auto* kernel = vec ? &join_kernel<true> : &join_kernel<false>;
  kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(exp), static_cast<const uint32_t*>(nc), n4, bf16,
      static_cast<uint32_t*>(out), exp_stride32, nc_stride32, out_stride32, (unsigned)per);
  return (int)cudaGetLastError();
}

// `batch` members of n4 exponent u32 each (4 * n4 f32 words). Member m's
// exponent and high planes (n4 u32 each) and low plane (2 * n4 u32), all
// 4-byte aligned, are at u32 m * exp_stride32, m * hi_stride32 and
// m * lo_stride32; its 4 * n4 output words (16-byte aligned) at u32
// m * out_stride32.
extern "C" int dtt_join_f32(const void* exp, const void* lo, const void* hi,
                            long long batch, long long n4, void* out,
                            long long exp_stride32, long long lo_stride32,
                            long long hi_stride32, long long out_stride32, void* stream) {
  if (batch <= 0 || n4 <= 0) return (int)cudaGetLastError();
  const bool lo8 = reinterpret_cast<uintptr_t>(lo) % 8 == 0 && lo_stride32 % 2 == 0;
  // a unit a thread: a grid over every unit, not one wave (a member's
  // CTAs loop only past 2^31 - 1 CTAs in all)
  const long long blocks = (n4 + kThreads - 1) / kThreads;
  const long long cap = 0x7fffffffLL / batch;
  const unsigned per = (unsigned)(blocks < cap ? blocks : cap);
  const long long grid = per * batch;
  if (per == 0) return (int)cudaErrorInvalidConfiguration;
  auto* kernel = lo8 ? &join_f32_kernel<true> : &join_f32_kernel<false>;
  kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(exp), static_cast<const uint32_t*>(lo),
      static_cast<const uint32_t*>(hi), n4, static_cast<uint32_t*>(out), exp_stride32,
      lo_stride32, hi_stride32, out_stride32, per);
  return (int)cudaGetLastError();
}

// The resources of configuration `config` (0 the f16/bf16 join on 16-byte
// aligned rows, 1 the f32 join on 8-byte aligned low-plane rows), into
// out[0..5] (launch.cuh).
extern "C" int dtt_join_resources(int config, int* out) {
  return (config == 1 ? kJoinF32 : kJoin[1]).report(out);
}
