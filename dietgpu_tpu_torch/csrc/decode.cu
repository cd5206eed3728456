// Fused rANS decode, in three configurations of one kernel template:
//
//   kHalf -- f16/bf16 join, straight out of a float container;
//   kF32  -- f32 3-plane join (exponent, low u16, high u8), straight out of
//            a float container;
//   kRaw  -- raw bytes, out of a bare ANS archive.
//
// Replaces: dietgpu_tpu/ans/pallas_decode.py:_decode_kernel with fuse_float
// in {FLOAT16, BFLOAT16} (kHalf), FLOAT32 (kF32) and None (kRaw, the raw
// driver at pallas_decode.py:1609-1628), the reference's ansDecodeKernel
// (GpuANSDecode.cuh:305-403) with and without the fused JoinFloatWriter
// (GpuFloatDecompress.cuh:391-521, GpuFloatUtils.cuh:111-203).
//
// Bound on the H100: operations, not bytes. The kernel reads the raw planes
// (1 B per f16/bf16 word, 3 B per f32 word, none for raw bytes) and the
// compressed exponents once and writes each output once, but each symbol is
// a dependent chain (LUT lookup, multiply, compare, warp vote, stream read)
// 128 steps deep per warp. The least time counted for it is its bytes over
// 3.35 TB/s.
//
// Design: a persistent grid, one warp per 4 KiB block at a time, as in the
// reference. Every CTA parses the headers itself -- for a float container
// the float header, then the ANS header at the offset its word count gives
// (4 + round_up(n, 16)/4 u32 for f16/bf16, 4 + round_up(n, 8)/2 +
// round_up(n, 16)/4 for f32, whose high plane starts at 4 + round_up(n,
// 8)/2); for a raw archive the ANS header at u32 0 -- and builds the
// 2^prob_bits decode LUT, (sminus << 20) | (pdf << 8) | sym as in
// decode.py:46-59, in shared memory from the archive's pdf, so the decode
// needs no host round trip and no table pass in device memory. A warp first
// copies its block's compressed stream (at most 2560 u16) to shared memory
// with coalesced loads; the backward refill reads then cost a shared-memory
// access instead of a dependent device-memory load each step. Lanes start
// from the archived final states; steps run from s = 127 (or the ragged
// last step) down to 0; a lane whose state falls below 2^15 refills from
// stream[pos - rank], rank taken from a reversed __popc of the ballot.
// Symbols collect in shared memory and then leave in groups of 4: as
// finished, tail-masked f16/bf16 word pairs (8-byte stores), as finished,
// tail-masked f32 words (16-byte stores), or as raw bytes (16-byte stores
// of 16 symbols); outputs past a block's symbols are zero. The optional
// XOR digest of the output is folded per warp and merged with atomicXor.
//
// Every read goes through a clamp to the buffer, so a lying header can only
// fail `success` (status[0]) and never read or write out of bounds.
//
// Batched (the per_row_tables=True configurations of the TPU kernel, via
// ans_decode_batched_pallas and float_decompress_batched_pallas): the grid
// gains a member dimension, (x, B), each CTA persistent over its member's
// blocks. Member m's archive is row m of a buffer with a stride of `a32`
// u32, which is also the clamp bound, so a lying header in member m fails
// only member m's success and never reads member m + 1; its output is row
// m of the output, its status is status[3m .. 3m + 3). Each CTA parses its
// own member's headers and builds that member's LUT; a single archive is a
// batch of one. `static_nb` >= 0 is the batched path's known block
// count: the block geometry comes from it and success requires the
// header's count to equal it, as with static_nb in the TPU path.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kHalf = 0;
constexpr int kF32 = 1;
constexpr int kRaw = 2;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockBytes = 4096;
constexpr int kMaxWords = 2560;
constexpr int kStreamWords32 = kMaxWords / 2 + 1;
constexpr uint32_t kFloatMagic = 0xF00F0001u;
constexpr uint32_t kAnsMagic = 0xD00D0001u;
constexpr int kBf16 = 2;

__device__ __forceinline__ uint32_t ld(const uint32_t* __restrict__ a,
                                       long long a32, long long i) {
  return (i >= 0 && i < a32) ? a[i] : 0u;
}

__device__ __forceinline__ long long clampll(long long v, long long lo,
                                             long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const uint32_t* __restrict__ arcs, long long a32,
              void* __restrict__ out_all, int nb_cap, int float_type,
              int prob_bits, long long static_length, long long static_nb,
              int with_digest, uint32_t* __restrict__ status_all) {
  __shared__ uint32_t lut[2048];
  __shared__ uint32_t incl[256];
  __shared__ uint32_t pdfs[256];
  __shared__ __align__(16) uint8_t syms[kWarps][kBlockBytes];
  __shared__ uint32_t streams[kWarps][kStreamWords32];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // output capacity: words of a float container, bytes of a raw archive
  const long long Lw = (long long)nb_cap * kBlockBytes;
  constexpr int kOutBytesPerSymbol = kMode == kRaw ? 1 : (kMode == kF32 ? 4 : 2);
  const long long m = blockIdx.y;
  const uint32_t* __restrict__ arc = arcs + m * a32;
  void* __restrict__ out_v =
      static_cast<uint8_t*>(out_all) + m * Lw * kOutBytesPerSymbol;
  uint32_t* __restrict__ status = status_all + 3 * m;

  // ---- headers: success, the ANS archive's base, the planes' bases ----
  long long base = 0;
  long long hi_base = 0;
  long long n_eff = 0;
  bool ok;
  uint32_t n_word;
  if constexpr (kMode == kRaw) {
    n_word = ld(arc, a32, 2);
    ok = ld(arc, a32, 0) == kAnsMagic &&
         (ld(arc, a32, 4) & 0xfu) == (uint32_t)prob_bits &&
         (int)n_word <= Lw;
  } else {
    n_word = ld(arc, a32, 1);
    const int n = (int)n_word;
    const uint32_t fopt = ld(arc, a32, 2);
    ok = ld(arc, a32, 0) == kFloatMagic &&
         (fopt & 0xfu) == (uint32_t)float_type && n <= Lw;
    if (static_length >= 0) {
      ok = ok && (long long)n == (static_length < Lw ? static_length : Lw);
    }
    n_eff = clampll(n, 0, Lw);
    if constexpr (kMode == kF32) {
      hi_base = 4 + ((n_eff + 7) / 8) * 4;
      base = hi_base + ((n_eff + 15) / 16) * 4;
    } else {
      base = 4 + ((n_eff + 15) / 16) * 4;
    }
    const int an = (int)ld(arc, a32, base + 2);
    ok = ok && ld(arc, a32, base) == kAnsMagic &&
         (ld(arc, a32, base + 4) & 0xfu) == (uint32_t)prob_bits && an <= Lw &&
         (long long)an == n_eff;
  }
  const int nb = (int)ld(arc, a32, base + 1);
  const long long nb_eff = clampll(nb, 0, nb_cap);
  // blocks of the section geometry, and blocks that decode
  long long nb_geo = nb_eff;
  long long nb_live = nb_eff;
  if (static_nb >= 0) {
    nb_geo = static_nb < nb_cap ? static_nb : nb_cap;
    ok = ok && (long long)nb == nb_geo;
    nb_live = nb_geo < nb_eff ? nb_geo : nb_eff;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    status[0] = ok ? 1u : 0u;
    status[1] = n_word;
  }

  // ---- decode LUT from the archive pdf: sym = #{incl <= slot} ----
  for (int t = threadIdx.x; t < 256; t += kThreads) {
    const uint32_t pw = ld(arc, a32, base + 8 + t / 2);
    pdfs[t] = (t & 1) ? (pw >> 16) : (pw & 0xffffu);
  }
  __syncthreads();
  if (warp == 0) {
    uint32_t carry = 0;
    for (int c = 0; c < 256; c += 32) {
      uint32_t v = pdfs[c + lane];
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t y = __shfl_up_sync(0xffffffffu, v, d);
        if (lane >= d) v += y;
      }
      incl[c + lane] = v + carry;
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();
  const int K = 1 << prob_bits;
  for (int slot = threadIdx.x; slot < K; slot += kThreads) {
    int lo = 0;
    int hi = 256;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (incl[mid] <= (uint32_t)slot) lo = mid + 1; else hi = mid;
    }
    const uint32_t s = lo < 255 ? lo : 255;
    const uint32_t pof = pdfs[s];
    const uint32_t sminus = (uint32_t)slot - (incl[s] - pof);
    lut[slot] = (sminus << 20) | (pof << 8) | s;
  }
  __syncthreads();

  // ---- one warp per block ----
  const long long bw_start = base + 136 + nb_geo * 32;
  const long long ds32 = bw_start + 2 * (nb_geo + (nb_geo & 1));
  const uint32_t smask = (uint32_t)K - 1u;
  const bool bf16 = float_type == kBf16;
  uint8_t* sy = syms[warp];
  uint32_t* st32 = streams[warp];
  const uint16_t* st16 = reinterpret_cast<const uint16_t*>(st32);
  uint32_t digest = 0;

  for (long long b = (long long)blockIdx.x * kWarps + warp; b < nb_cap;
       b += (long long)gridDim.x * kWarps) {
    int kmax = 0;
    if (b < nb_live) {
      const uint32_t bx = ld(arc, a32, bw_start + 2 * b);
      const int start = (int)ld(arc, a32, bw_start + 2 * b + 1);
      const int uncomp = (int)(bx >> 16);
      const int cw = (int)(bx & 0xffffu);
      const int steps = (uncomp + 31) / 32;
      const int rem = uncomp % 32;
      kmax = steps < 128 ? steps : 128;

      // the block's stream, u16 index sbase.. in the archive
      const long long sbase = 2 * ds32 + start;
      const int odd = (int)(sbase & 1);
      const int cwc = cw < kMaxWords ? cw : kMaxWords;
      const int nw = (odd + cwc + 1) >> 1;
      for (int i = lane; i < nw; i += 32) {
        st32[i] = ld(arc, a32, (sbase >> 1) + i);
      }
      __syncwarp();

      uint32_t state = ld(arc, a32, base + 136 + b * 32 + lane);
      int pos = cw;
      for (int k = kmax - 1; k >= 0; --k) {
        const bool act = !(k == steps - 1 && rem > 0) || lane < rem;
        uint32_t sym = 0;
        if (act) {
          const uint32_t t = lut[state & smask];
          sym = t & 0xffu;
          state = ((t >> 8) & 0xfffu) * (state >> prob_bits) + (t >> 20);
        }
        const bool rd = act && state < (1u << 15);
        const unsigned ballot = __ballot_sync(0xffffffffu, rd);
        if (rd) {
          int ridx = pos - __popc(ballot >> lane);
          ridx = ridx < 0 ? 0 : (ridx > kMaxWords - 1 ? kMaxWords - 1 : ridx);
          // ridx >= cwc only for a lying header: the slot then holds a
          // stale word, never an out-of-bounds one
          state = (state << 16) + st16[odd + ridx];
        }
        pos -= __popc(ballot);
        sy[k * 32 + lane] = (uint8_t)sym;
      }
    }
    for (int i = kmax * 32 + lane; i < kBlockBytes; i += 32) sy[i] = 0;
    __syncwarp();

    const uint32_t* s4 = reinterpret_cast<const uint32_t*>(sy);
    if constexpr (kMode == kRaw) {
      // ---- raw bytes: 16 symbols per 16-byte store ----
      uint4* out = static_cast<uint4*>(out_v);
      const uint4* q4 = reinterpret_cast<const uint4*>(sy);
      for (int j = lane; j < kBlockBytes / 16; j += 32) {
        const uint4 o = q4[j];
        out[b * (kBlockBytes / 16) + j] = o;
        digest ^= o.x ^ o.y ^ o.z ^ o.w;
      }
    } else if constexpr (kMode == kF32) {
      // ---- join 4 words at a time with the low plane at u32 4 + 2048 b
      // and the high plane at u32 hi_base + 1024 b ----
      uint4* out = static_cast<uint4*>(out_v);
      for (int j = lane; j < kBlockBytes / 4; j += 32) {
        const uint32_t sv = s4[j];
        const uint32_t hv = ld(arc, a32, hi_base + b * (kBlockBytes / 4) + j);
        const long long lo_i = 4 + b * (kBlockBytes / 2) + 2 * j;
        const uint32_t lv[2] = {ld(arc, a32, lo_i), ld(arc, a32, lo_i + 1)};
        const long long i0 = b * kBlockBytes + 4LL * j;
        uint32_t w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint32_t v = (((sv >> (8 * q)) & 0xffu) << 24) |
                             (((hv >> (8 * q)) & 0xffu) << 16) |
                             ((lv[q >> 1] >> (16 * (q & 1))) & 0xffffu);
          w[q] = i0 + q < n_eff ? ((v >> 1) | (v << 31)) : 0u;
        }
        const uint4 o = make_uint4(w[0], w[1], w[2], w[3]);
        out[b * (kBlockBytes / 4) + j] = o;
        digest ^= o.x ^ o.y ^ o.z ^ o.w;
      }
    } else {
      // ---- join 4 words at a time with the nonComp plane at byte 16 ----
      uint2* out = static_cast<uint2*>(out_v);
      for (int j = lane; j < kBlockBytes / 4; j += 32) {
        const uint32_t sv = s4[j];
        const uint32_t nc = ld(arc, a32, 4 + b * (kBlockBytes / 4) + j);
        const long long i0 = b * kBlockBytes + 4LL * j;
        uint32_t w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t v = (((sv >> (8 * q)) & 0xffu) << 8) | ((nc >> (8 * q)) & 0xffu);
          if (bf16) v = ((v >> 1) | (v << 15)) & 0xffffu;
          w[q] = i0 + q < n_eff ? v : 0u;
        }
        const uint2 o = make_uint2(w[0] | (w[1] << 16), w[2] | (w[3] << 16));
        out[b * (kBlockBytes / 4) + j] = o;
        digest ^= o.x ^ o.y;
      }
    }
    __syncwarp();
  }

  if (with_digest) {
    for (int d = 16; d > 0; d >>= 1) {
      digest ^= __shfl_xor_sync(0xffffffffu, digest, d);
    }
    digest ^= digest >> 16;
    digest ^= digest >> 8;
    digest &= 0xffu;
    if (lane == 0 && digest) atomicXor(&status[2], digest);
  }
}

template <int kMode>
int launch_decode(const void* arcs, long long batch, long long a32, void* out,
                  int nb_cap, int float_type, int prob_bits,
                  long long static_length, long long static_nb,
                  int with_digest, void* status, void* stream) {
  if (batch <= 0) return (int)cudaGetLastError();
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, decode_kernel<kMode>,
                                                kThreads, 0);
  // one wave of CTAs over the whole batch (so the share rounds down), each
  // member's share persistent over its blocks
  long long grid = (nb_cap + kWarps - 1) / kWarps;
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long share = cap / batch;
  if (grid > share) grid = share;
  if (grid < 1) grid = 1;
  decode_kernel<kMode><<<dim3((unsigned)grid, (unsigned)batch), kThreads, 0,
                         (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(arcs), a32, out, nb_cap, float_type,
      prob_bits, static_length, static_nb, with_digest,
      static_cast<uint32_t*>(status));
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry point takes `batch` archives, rows of a32 u32 each, writes
// `batch` output rows, and 3 status words per member, zeroed by the caller:
// success, the header's count (words of a float container, bytes of a raw
// archive) and the folded output digest. static_length < 0 and static_nb <
// 0 mean none.

// f16/bf16 containers -> nb_cap * 4096 words per row, as 8-byte aligned u32
// pairs.
extern "C" int dtt_decode(const void* arcs, long long batch, long long a32,
                          void* out, int nb_cap, int float_type, int prob_bits,
                          long long static_length, long long static_nb,
                          int with_digest, void* status, void* stream) {
  return launch_decode<kHalf>(arcs, batch, a32, out, nb_cap, float_type,
                              prob_bits, static_length, static_nb, with_digest,
                              status, stream);
}

// f32 containers -> nb_cap * 4096 u32 words per row, 16-byte aligned.
extern "C" int dtt_decode_f32(const void* arcs, long long batch, long long a32,
                              void* out, int nb_cap, int prob_bits,
                              long long static_length, long long static_nb,
                              int with_digest, void* status, void* stream) {
  return launch_decode<kF32>(arcs, batch, a32, out, nb_cap, 3, prob_bits,
                             static_length, static_nb, with_digest, status,
                             stream);
}

// raw ANS archives -> nb_cap * 4096 bytes per row, 16-byte aligned, zero
// past each block's symbols.
extern "C" int dtt_decode_raw(const void* arcs, long long batch, long long a32,
                              void* out, int nb_cap, int prob_bits,
                              long long static_nb, int with_digest,
                              void* status, void* stream) {
  return launch_decode<kRaw>(arcs, batch, a32, out, nb_cap, 0, prob_bits, -1,
                             static_nb, with_digest, status, stream);
}
