// Float split for f16/bf16 with the exponent histogram and checksum fused.
//
// Replaces: dietgpu_tpu/floatcodec/pallas_float.py:_split_kernel
// (split_words_pallas, vmapped by pallas_codec.py's batched compress, per
// member lengths at dietgpu_tpu/api.py's batched float encode), the
// reference's splitFloat (GpuFloatCompress.cuh).
//
// Bound on the H100: bytes. Each word below its member's length is read
// once (2 B) and both byte planes are written in full (1 B + 1 B a word of
// the row), so the least time is those bytes over 3.35 TB/s; the
// histogram and checksum add no device-memory traffic.
//
// Design, for every member of a batch in one 1-D launch:
//
// - Octets. A thread takes 8 words at a time: one 16-byte load of 4 word
//   pairs, two __byte_perm per plane, and one 8-byte store to each plane,
//   so loads and stores are full-width and coalesced. Each thread keeps
//   kUnroll = 2 loads in flight before it splits any; 6 CTAs of 256
//   threads an SM (the 32 KiB of copies each allow 6) read faster than 3
//   of 512 or 4 of 384 at the same thread count, and 4 loads in flight
//   read slower.
// - No vote. The exponent bytes go into the 32 lane-owned shared copies
//   of byte_hist.cuh (hist.cu's histogram): every shared atomic is one
//   conflict-free wavefront, whatever the bytes. A warp vote per byte
//   position (the first port) cost more than the loads, and on uniformly
//   random words, whose exponents take every value, it tripled the time.
// - Nothing past a length is read. The octets that hold a word below
//   their member's length (live) are split and counted; only the one that
//   holds the length is masked word by word, and the masked words are not
//   counted. The octets past it (dead) are written as zeros in both planes
//   without a load, so the planes keep their full width with zero tails.
// - One grid for the batch. The live octets of all members form one index
//   space and the dead octets another; CTA i takes the i-th share of each
//   (byte_hist.cuh's for_each_member: through an on-card prefix of the
//   members' octets, from `lengths` or the one length), the live share
//   first. A CTA folds its copies into the member's histogram row and its
//   checksum into the member's word when it leaves a member. The grid has
//   no member dimension, so any B launches. (Giving the dead octets CTAs
//   of their own, to run beside the live ones, read slower at path H.)
//
// The checksum XORs the (masked) word pairs into a per-thread register,
// folded by warp shuffles and merged with one atomicXor per warp and
// member (the 8-bit fold is linear over XOR).

#include <cstdint>
#include <cuda_runtime.h>

#include "byte_hist.cuh"
#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 6;  // CTAs per SM the launch bound asks for
constexpr int kUnroll = 2;     // 16-byte loads in flight per thread

// each 16-bit half rotated left by 1 (the bf16 split's rotl16)
__device__ __forceinline__ uint32_t rotl16x2(uint32_t p) {
  return ((p << 1) & 0xfffefffeu) | ((p >> 15) & 0x00010001u);
}

// Octet o of a member of `length` words: 4 word pairs -> 8 exponent bytes
// and 8 nonComp bytes, stored; the exponents counted into copy `my`, the
// pairs XORed into x. Words at index >= length are zero and not counted.
template <bool kBf16>
__device__ __forceinline__ void split_octet(unsigned* my, uint4 p, long long o,
                                            long long length, uint2* __restrict__ exp_out,
                                            uint2* __restrict__ nc_out, uint32_t& x) {
  const long long rem = length - o * 8;  // words of the octet below the length
  if (rem < 8) {
    uint32_t pw[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (2 * k >= rem) pw[k] = 0;
      else if (2 * k + 1 >= rem) pw[k] &= 0xffffu;
    }
    p = make_uint4(pw[0], pw[1], pw[2], pw[3]);
  }
  x ^= p.x ^ p.y ^ p.z ^ p.w;
  if (kBf16) {
    p = make_uint4(rotl16x2(p.x), rotl16x2(p.y), rotl16x2(p.z), rotl16x2(p.w));
  }
  // byte 1 of each word is its exponent byte, byte 0 its nonComp byte
  const uint32_t e0 = __byte_perm(p.x, p.y, 0x7531);
  const uint32_t e1 = __byte_perm(p.z, p.w, 0x7531);
  exp_out[o] = make_uint2(e0, e1);
  nc_out[o] = make_uint2(__byte_perm(p.x, p.y, 0x6420), __byte_perm(p.z, p.w, 0x6420));
  if (rem >= 8) {
    dtt::count4(my, e0);
    dtt::count4(my, e1);
  } else {
    dtt::count_first(my, e0, rem);
    dtt::count_first(my, e1, rem - 4);
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
split_kernel(const uint32_t* __restrict__ pairs_all, long long batch, long long n_oct,
             long long length_all, const long long* __restrict__ lengths,
             long long live_total, uint32_t* __restrict__ exp_all,
             uint32_t* __restrict__ nc_all, unsigned* __restrict__ hist_all,
             unsigned* __restrict__ cks_all, long long in_stride32,
             long long exp_stride32, long long nc_stride32) {
  __shared__ unsigned sh[dtt::kHistWords];
  __shared__ long long s_start[kThreads];
  __shared__ long long s_warp[kWarps];

  const bool same = lengths == nullptr;
  auto live = [&](long long m) {
    return ((same ? length_all : lengths[m]) + 7) / 8;
  };
  auto dead = [&](long long m) { return n_oct - live(m); };
  auto exp_row = [&](long long m) {
    return reinterpret_cast<uint2*>(exp_all + m * exp_stride32);
  };
  auto nc_row = [&](long long m) {
    return reinterpret_cast<uint2*>(nc_all + m * nc_stride32);
  };

  // the live octets: load, split, count
  long long q0, q1;
  dtt::cta_share(live_total, &q0, &q1);
  if (q0 < q1) {
    dtt::clear_copies<kThreads>(sh);
    __syncthreads();
    unsigned* my = sh + threadIdx.x % 32;
    dtt::for_each_member<kThreads>(
        batch, q0, q1, live, s_start, s_warp,
        [&](long long m, long long a, long long b) {
          const uint4* __restrict__ pairs =
              reinterpret_cast<const uint4*>(pairs_all + m * in_stride32);
          uint2* __restrict__ exp_out = exp_row(m);
          uint2* __restrict__ nc_out = nc_row(m);
          const long long length = same ? length_all : lengths[m];
          uint32_t x = 0;
          for (long long o = a + threadIdx.x; o < b; o += (long long)kThreads * kUnroll) {
            uint4 p[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              const long long ou = o + (long long)u * kThreads;
              p[u] = ou < b ? pairs[ou] : make_uint4(0, 0, 0, 0);
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              const long long ou = o + (long long)u * kThreads;
              if (ou < b) split_octet<kBf16>(my, p[u], ou, length, exp_out, nc_out, x);
            }
          }
          __syncthreads();
          dtt::fold_member<kThreads>(sh, hist_all + 256 * m, x,
                                     cks_all == nullptr ? nullptr : cks_all + m);
          __syncthreads();
        });
  }

  // the dead octets: zeros in both planes, nothing read
  dtt::cta_share(batch * n_oct - live_total, &q0, &q1);
  dtt::for_each_member<kThreads>(
      batch, q0, q1, dead, s_start, s_warp,
      [&](long long m, long long a, long long b) {
        const long long first = live(m);
        uint2* __restrict__ exp_out = exp_row(m) + first;
        uint2* __restrict__ nc_out = nc_row(m) + first;
        for (long long o = a + threadIdx.x; o < b; o += kThreads) {
          exp_out[o] = make_uint2(0, 0);
          nc_out[o] = make_uint2(0, 0);
        }
      });
}

// The f16 and bf16 kernels, with shared memory before L1 (their 32 copies
// of the bins).
dtt::Kernel kSplit[2] = {{split_kernel<false>, kThreads, 0, true},
                         {split_kernel<true>, kThreads, 0, true}};

}  // namespace

// `batch` members, member m of length lengths[m] (n_oct * 8 at most), or of
// `length` each when `lengths` is null; live_total is the sum over the
// members of ceil(length / 8). Member m's pairs (n_oct * 4 u32 word pairs,
// 16-byte aligned), exponent plane and nonComp plane (n_oct * 8 bytes each,
// 8-byte aligned) are at u32 m * in_stride32, m * exp_stride32 and
// m * nc_stride32; words at index >= its length are not read and are zero in
// both planes. hist: 256 u32 per member, zeroed by the caller. cks: one u32
// per member, zeroed by the caller, or null when no checksum is wanted.
extern "C" int dtt_split(const void* pairs, long long batch, long long n_oct,
                         long long length, const void* lengths, long long live_total,
                         int bf16, void* exp_out, void* nc_out, void* hist, void* cks,
                         long long in_stride32, long long exp_stride32,
                         long long nc_stride32, void* stream) {
  if (batch <= 0 || n_oct <= 0) return (int)cudaGetLastError();
  unsigned blocks = 0;  // one wave, and at least 8 octets a thread
  const cudaError_t e =
      kSplit[bf16 != 0].wave((batch * n_oct + kThreads * 8 - 1) / (kThreads * 8), &blocks);
  if (e != cudaSuccess) return (int)e;
  auto* kernel = bf16 ? &split_kernel<true> : &split_kernel<false>;
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(pairs), batch, n_oct, length,
      static_cast<const long long*>(lengths), live_total, static_cast<uint32_t*>(exp_out),
      static_cast<uint32_t*>(nc_out), static_cast<unsigned*>(hist),
      static_cast<unsigned*>(cks), in_stride32, exp_stride32, nc_stride32);
  return (int)cudaGetLastError();
}

// The kernel's resources (the bf16 configuration; the f16 one differs by
// the rotation), into out[0..5] (launch.cuh).
extern "C" int dtt_split_resources(int config, int* out) {
  (void)config;  // one configuration reported
  return kSplit[1].report(out);
}
