// Float split for f32 with the exponent histogram and checksum fused.
//
// Replaces: dietgpu_tpu/floatcodec/pallas_float.py:_split_kernel_f32
// (split_words_pallas_f32, vmapped by pallas_codec.py's batched compress,
// per-member lengths at dietgpu_tpu/api.py's batched float encode), the
// reference's splitFloat for the two-plane f32 layout
// (GpuFloatCompress.cuh, GpuFloatUtils.cuh:181-203).
//
// Bound on the H100: bytes. Each word is read once (4 B) and its three
// planes are written once (1 B exponent, 2 B low, 1 B high), so the least
// time is 8 B per word over 3.35 TB/s (fewer where a member is shorter than
// its row: its words past the length are not read, and in container mode
// its low and high planes stop at their archived ends); the histogram and
// checksum add no device-memory traffic.
//
// Each word is rotated left by 1 (v = rotl32(w, 1)); its exponent byte is
// v >> 24, its low u16 v & 0xffff and its high byte (v >> 16) & 0xff.
//
// Design, for every member of a batch in one 1-D launch:
//
// - Quads, tiles and runs. A lane takes 4 words (a quad) at a time as one
//   16-byte load and writes their 4 exponent bytes, 4 low u16 and 4 high
//   bytes as one 4-byte, one 8-byte and one 4-byte store (__byte_perm).
//   Work is dealt in tiles of 32 quads, and each warp takes a contiguous
//   run of its CTA's tiles, a tile a step, so every load starts on a
//   512-byte line of the member's words and every exponent store on a
//   128-byte line. A store that straddles a 32-byte sector is costly: shares
//   that started mid-line (quads dealt one by one) read markedly slower at
//   path B, and so did the planes 16 bytes past a sector, where the
//   container puts the low plane (and the high plane of half the lengths).
//   So the low and high stores are shifted by the plane's offset within a
//   sector (ShiftedStore: a warp shuffle and one element carried per lane
//   from step to step), and every sector but the two at a run's ends is
//   written whole by one store.
// - No vote. The exponent bytes go into the 32 lane-owned shared copies of
//   byte_hist.cuh (hist.cu's histogram): every shared atomic is one
//   conflict-free wavefront, whatever the bytes. The first port merged
//   equal bytes of a warp with a __match_any_sync vote per word, which
//   serialised on uniformly random words (up to 32 distinct exponents a
//   warp: 2.6 times its time on normal words).
// - Nothing past a length is read. A tile that holds a word below its
//   member's length is live: its quads below the length are loaded, split
//   and counted, the one that holds the length masked word by word (the
//   masked words are not counted), and its quads past the length written
//   as zeros without a load. The tiles past those (dead) are written as
//   zeros, nothing read.
// - One grid for the batch. The live tiles of all members form one index
//   space and the dead tiles another; CTA i takes the i-th contiguous share
//   of each (byte_hist.cuh's cta_share and for_each_member: through an
//   on-card prefix of the members' tiles, from `lengths` or the one
//   length), the live share first. A CTA folds its copies into the
//   member's histogram row and its checksum into the member's word when it
//   leaves a member. The grid has no member dimension, so any B launches,
//   and a ragged batch costs what its words cost, not B times its longest
//   member.
// - Container mode (hi_out null). The codec points the planes straight
//   into the float container: the low plane at lo_out, the high plane
//   right after its archived 2 * round_up(n, 8) bytes, and the ANS archive
//   right after the high plane's round_up(n, 16) bytes. A plane then stops
//   at its archived end, since whatever follows it is another section of
//   the same container. The quads between ceil(n / 4) and those ends still
//   get their zeros: the low plane's up to round_up(n, 8) / 4 quads, the
//   high plane's up to round_up(n, 16) / 4; both ends lie in the member's
//   last live tile. Outside container mode the dead quads write zeros to
//   all three planes at full width. The exponent plane always has its full
//   width.
// - Launch shape: 256 threads a CTA, 6 CTAs an SM (the 32 KiB of copies
//   allow 6), kUnroll = 2 loads in flight a lane. tools/tune_split_f32.py
//   times the others: 1 load in flight, 512-thread CTAs, and 5 or 4 CTAs
//   an SM (48 or 64 registers) read within 2% of this shape, 4 loads in
//   flight spill and read slower, and the kernel with its counting removed
//   is no faster, so the memory streams and not the histogram set its time
//   (about 80% of the bytes bound at path B). Streaming cache hints
//   (__ldcs, __stcs) read slower.
//
// The checksum XORs the (masked) words into a per-thread register, folded
// by warp shuffles and merged with one atomicXor per warp and member (the
// 8-bit fold is linear over XOR).

#include <cstdint>
#include <cuda_runtime.h>

#include "byte_hist.cuh"
#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 6;  // CTAs per SM the launch bound asks for
constexpr int kUnroll = 2;     // 16-byte loads in flight per thread
constexpr int kTile = 32;      // quads a tile

// Member m's three planes and the quads its low and high planes take.
struct Planes {
  uint32_t* exp;
  uint2* lo;
  uint32_t* hi;
  long long lo_quads;
  long long hi_quads;
};

__device__ __forceinline__ Planes member_planes(long long m, long long length, long long n_quad,
                                                uint32_t* exp_all, uint32_t* lo_all,
                                                uint32_t* hi_all, long long exp_stride32,
                                                long long plane_stride32) {
  Planes p;
  p.exp = exp_all + m * exp_stride32;
  uint32_t* const lo_row = lo_all + m * plane_stride32;
  p.lo = reinterpret_cast<uint2*>(lo_row);
  if (hi_all == nullptr) {  // container mode: the archived lengths only
    const long long lo32 = (length + 7) / 8 * 4;  // round_up(n, 8) / 2
    p.hi = lo_row + lo32;
    p.lo_quads = lo32 / 2;
    p.hi_quads = (length + 15) / 16 * 4;  // round_up(n, 16) / 4
  } else {
    p.hi = hi_all + m * plane_stride32;
    p.lo_quads = p.hi_quads = n_quad;
  }
  return p;
}

// Quad o with no word below the length: zeros, up to each plane's end.
__device__ __forceinline__ void zero_quad(const Planes& p, long long o) {
  p.exp[o] = 0;
  if (o < p.lo_quads) p.lo[o] = make_uint2(0, 0);
  if (o < p.hi_quads) p.hi[o] = 0;
}

// One quad: 4 words -> their 4 exponent bytes e, 4 low u16 (lo) and 4 high
// bytes h. Only the first r words count (r < 4 in the quad that holds the
// member's length): the others are taken as zero. x gets the words' XOR.
struct Split {
  uint32_t e;
  uint2 lo;
  uint32_t h;
};

__device__ __forceinline__ Split split_quad(uint4 w, int r, uint32_t& x) {
  if (r < 4) {
    if (r < 2) w.y = 0;
    if (r < 3) w.z = 0;
    w.w = 0;
  }
  x ^= w.x ^ w.y ^ w.z ^ w.w;
  const uint32_t v0 = __funnelshift_l(w.x, w.x, 1);
  const uint32_t v1 = __funnelshift_l(w.y, w.y, 1);
  const uint32_t v2 = __funnelshift_l(w.z, w.z, 1);
  const uint32_t v3 = __funnelshift_l(w.w, w.w, 1);
  // byte 3 of each v is its exponent, byte 2 its high byte, bytes 0-1 its low u16
  Split s;
  s.e = __byte_perm(__byte_perm(v0, v1, 0x0073), __byte_perm(v2, v3, 0x0073), 0x5410);
  s.h = __byte_perm(__byte_perm(v0, v1, 0x0062), __byte_perm(v2, v3, 0x0062), 0x5410);
  s.lo = make_uint2(__byte_perm(v0, v1, 0x5410), __byte_perm(v2, v3, 0x5410));
  return s;
}

__device__ __forceinline__ uint32_t shfl_lane(uint32_t v, int src) {
  return __shfl_sync(0xffffffffu, v, src);
}

__device__ __forceinline__ uint2 shfl_lane(uint2 v, int src) {
  return make_uint2(__shfl_sync(0xffffffffu, v.x, src), __shfl_sync(0xffffffffu, v.y, src));
}

// A plane whose warp stores start c elements into a 32-byte sector (the
// container's low and high planes start 16 bytes past one): each step of a
// warp's run writes the sector-aligned window that starts c elements
// earlier, lane i storing lane i - c's element, and lanes i < c the
// previous step's last c elements, held in `carry`. So every sector but
// the two at the ends of a run is written whole by one store.
template <class T>
struct ShiftedStore {
  T* out;  // element 0 of the run's first step
  int c;   // 0 <= c < 32
  T carry;

  // step s of the run, this lane's element v at index 32 s + lane; n
  // elements of the run are valid (all of every step but the last)
  __device__ __forceinline__ void put(int s, T v, int n) {
    const int lane = threadIdx.x % 32;
    const T rot = shfl_lane(v, (lane - c) & 31);
    const int i = 32 * s + lane - c;
    if (lane >= c) {
      if (i < n) out[i] = rot;
    } else if (s > 0) {
      out[i] = carry;
    }
    carry = rot;
  }
  // after the last step s: the last c elements
  __device__ __forceinline__ void flush(int s, int n) {
    const int lane = threadIdx.x % 32;
    const int i = 32 * s + 32 - c + lane;
    if (lane < c && i < n) out[i] = carry;
  }
};

// elements of T from the start of the 32-byte sector that holds p
template <class T>
__device__ __forceinline__ int sector_offset(const T* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) % 32) / sizeof(T));
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
split_f32_kernel(const uint32_t* __restrict__ words_all, long long batch, long long n_quad,
                 long long length_all, const long long* __restrict__ lengths,
                 long long live_total, uint32_t* __restrict__ exp_all,
                 uint32_t* __restrict__ lo_all, uint32_t* __restrict__ hi_all,
                 unsigned* __restrict__ hist_all, unsigned* __restrict__ cks_all,
                 long long in_stride32, long long exp_stride32, long long plane_stride32) {
  __shared__ unsigned sh[dtt::kHistWords];
  __shared__ long long s_start[kThreads];
  __shared__ long long s_warp[kWarps];

  const bool same = lengths == nullptr;
  auto length_of = [&](long long m) { return same ? length_all : lengths[m]; };
  // tiles that hold a word below member m's length, and the tiles past them
  auto live = [&](long long m) { return (length_of(m) + 4 * kTile - 1) / (4 * kTile); };
  auto dead = [&](long long m) { return n_quad / kTile - live(m); };
  auto planes = [&](long long m, long long length) {
    return member_planes(m, length, n_quad, exp_all, lo_all, hi_all, exp_stride32,
                         plane_stride32);
  };

  // the live tiles: load, split, count
  long long q0, q1;
  dtt::cta_share(live_total, &q0, &q1);
  if (q0 < q1) {
    dtt::clear_copies<kThreads>(sh);
    __syncthreads();
    unsigned* my = sh + threadIdx.x % 32;
    dtt::for_each_member<kThreads>(
        batch, q0, q1, live, s_start, s_warp,
        [&](long long m, long long a, long long b) {
          // the piece's quads [a, b) * kTile, from its own base at 32-bit
          // offsets; warp w takes the w-th contiguous run of its tiles, 32
          // quads a step, lane l quad 32 step + l
          const long long length = length_of(m);
          const Planes p = planes(m, length);
          const long long first = a * kTile;
          const long long end = b * kTile;
          const long long live_quads = (length + 3) / 4;
          // the last live tile's quads past the length (fewer than kTile)
          if (live_quads + threadIdx.x < end) zero_quad(p, live_quads + threadIdx.x);
          const int len = (int)((end < live_quads ? end : live_quads) - first);
          // the quad that holds the length, if it is in the piece and partial
          const int tail = end >= live_quads && length % 4 ? len - 1 : len;
          const int tail_r = (int)(length % 4);
          const int warp = threadIdx.x / 32;
          const int lane = threadIdx.x % 32;
          const int tiles = (len + kTile - 1) / kTile;
          const int t0 = tiles * warp / kWarps;
          const int steps = tiles * (warp + 1) / kWarps - t0;
          const int base = t0 * kTile;  // the run's first quad
          const int n = len - base;     // its live quads (all of every step but the last)
          const uint4* __restrict__ words =
              reinterpret_cast<const uint4*>(words_all + m * in_stride32) + first + base;
          uint32_t* const exp = p.exp + first + base;
          ShiftedStore<uint2> lo{p.lo + first + base, sector_offset(p.lo + first + base)};
          ShiftedStore<uint32_t> hi{p.hi + first + base, sector_offset(p.hi + first + base)};
          uint32_t x = 0;
          for (int s = 0; s < steps; s += kUnroll) {
            uint4 w[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              const int i = 32 * (s + u) + lane;
              w[u] = s + u < steps && i < n ? words[i] : make_uint4(0, 0, 0, 0);
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              if (s + u < steps) {  // warp-uniform: the shuffles need every lane
                const int i = 32 * (s + u) + lane;
                const int r = base + i == tail ? tail_r : 4;
                const Split q = split_quad(w[u], r, x);
                if (i < n) {
                  exp[i] = q.e;
                  if (r == 4) {
                    dtt::count4(my, q.e);
                  } else {
                    dtt::count_first(my, q.e, r);
                  }
                }
                lo.put(s + u, q.lo, n);
                hi.put(s + u, q.h, n);
              }
            }
          }
          if (steps > 0) {
            lo.flush(steps - 1, n);
            hi.flush(steps - 1, n);
          }
          __syncthreads();
          dtt::fold_member<kThreads>(sh, hist_all + 256 * m, x,
                                     cks_all == nullptr ? nullptr : cks_all + m);
          __syncthreads();
        });
  }

  // the dead tiles: zeros up to each plane's end, nothing read
  dtt::cta_share(batch * (n_quad / kTile) - live_total, &q0, &q1);
  dtt::for_each_member<kThreads>(
      batch, q0, q1, dead, s_start, s_warp,
      [&](long long m, long long a, long long b) {
        const Planes p = planes(m, length_of(m));
        const long long first = (live(m) + a) * kTile;
        const long long end = (live(m) + b) * kTile;
        for (long long o = first + threadIdx.x; o < end; o += kThreads) zero_quad(p, o);
      });
}

// The kernel, with shared memory before L1 (its 32 copies of the bins).
dtt::Kernel kSplitF32(split_f32_kernel, kThreads, 0, true);

}  // namespace

// `batch` members, member m of length lengths[m] (4 * n_quad at most), or of
// `length` each when `lengths` is null; n_quad is a multiple of 32, and
// live_total is the sum over the members of ceil(length / 128), the tiles
// of 32 quads that hold a word below the length. Member m's words (n_quad
// * 4 u32, 16-byte aligned) and exponent plane (n_quad u32, 4 exponent
// bytes each) are at u32 m * in_stride32 and m * exp_stride32; words at
// index >= its length are not read and are zero in every plane. Its low
// plane (8-byte aligned; 4 u16 a quad) starts at lo_out + m *
// plane_stride32. With hi_out given, its high plane (4 bytes a quad)
// starts at hi_out + m * plane_stride32 and both planes get all n_quad
// quads; with hi_out null (container mode), the low plane gets quads [0,
// round_up(n, 8) / 4) and the high plane quads [0, round_up(n, 16) / 4)
// right after it, at u32 round_up(n, 8) / 2 past the low plane's start, and
// nothing past those ends is written. hist: 256 u32 per member, zeroed by
// the caller. cks: one u32 per member, zeroed by the caller, or null when
// no checksum is wanted.
extern "C" int dtt_split_f32(const void* words, long long batch, long long n_quad,
                             long long length, const void* lengths, long long live_total,
                             void* exp_out, void* lo_out, void* hi_out, void* hist, void* cks,
                             long long in_stride32, long long exp_stride32,
                             long long plane_stride32, void* stream) {
  if (batch <= 0 || n_quad <= 0) return (int)cudaGetLastError();
  if (n_quad % kTile) return (int)cudaErrorInvalidValue;
  unsigned blocks = 0;  // one wave, and at least 16 quads a thread
  const cudaError_t e =
      kSplitF32.wave((batch * n_quad + kThreads * 16 - 1) / (kThreads * 16), &blocks);
  if (e != cudaSuccess) return (int)e;
  split_f32_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(words), batch, n_quad, length,
      static_cast<const long long*>(lengths), live_total, static_cast<uint32_t*>(exp_out),
      static_cast<uint32_t*>(lo_out), static_cast<uint32_t*>(hi_out),
      static_cast<unsigned*>(hist), static_cast<unsigned*>(cks), in_stride32, exp_stride32,
      plane_stride32);
  return (int)cudaGetLastError();
}

// The kernel's resources, into out[0..5] (launch.cuh).
extern "C" int dtt_split_f32_resources(int config, int* out) {
  (void)config;  // one configuration
  return kSplitF32.report(out);
}
