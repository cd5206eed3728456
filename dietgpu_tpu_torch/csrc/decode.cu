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
// Bound on the H100: bytes. The kernel reads the compressed archive and
// the raw planes (1 B per f16/bf16 word, 3 B per f32 word, none for raw
// bytes) once and writes each output once; counted at 16 32-bit operations
// a symbol over 67 T/s the work is a quarter of that time, so the least
// time is the archive's size plus the output over 3.35 TB/s. What keeps
// the kernel from it is latency: each 4 KiB block is a 128-step dependent
// chain a warp (LUT load, multiply-add, vote, stream read), and the
// block's stream and planes must come from device memory before it walks.
// Enough chains must be in flight on an SM, and no warp may wait on a
// device round trip more than once a block.
//
// Design:
//
// - One warp walks one block at a time, all 4096 outputs of it, with the
//   join fused into the walk: at step k lane l decodes the symbol of output
//   k * 32 + l, joins it with that output's plane bytes from shared memory
//   and stores the finished word (a coalesced 32/64/128-byte store a warp
//   a step). No symbol buffer and no second pass: a warp's shared memory is
//   its block's stream window (5 KiB) and its planes (4 KiB for f16/bf16,
//   12 KiB for f32). So 32 (raw), 22 (f16/bf16) or 12 (f32) warps fit on an
//   SM, each with its own chain in flight.
// - The stream window and the planes come in by cp.async, 16-byte copies
//   all issued at once, then one wait: one round of device latency a block
//   instead of one a u32, during which the SM's other warps walk. A block
//   whose whole range lies in its member's row takes that path; one that
//   does not (a lying header, the last bytes of a row that is not 16-byte
//   aligned) copies word by word with the plain version's clamps. The range
//   is checked once a block, not a word. The block table's words and the
//   lanes' final states are loaded a block ahead, so the copy is the one
//   wait a block. The copies are not double-buffered: shared memory bounds
//   the chains in flight on an SM, a second slot a warp would halve them,
//   and a single slot is idle only for one round trip of a block's walk.
// - Reads of the ANS archive follow the plain version's clamps exactly
//   (an index below 0 reads the archive's word 0, one past its end its last
//   word when it has 137 or more, else 0; plane words past the row read 0),
//   and the stream window is the plain version's: 2560 u16 from u32
//   ds32 + (start >> 1). So a lying header or a corrupted payload decodes
//   to the same bytes and status as the plain version, and never reads or
//   writes outside its member's row or output.
// - Work is divided by blocks, not by member. Every CTA parses the
//   headers of all B members (128 a round) and takes its share of the live
//   blocks (those with symbols) and, separately, of the dead blocks (past
//   a member's block count: zeros, or the plane joined with symbol 0 below
//   the word count), through prefixes of the members' counts. A ragged
//   batch costs what its blocks cost; the longest member no longer sets the
//   time. A CTA builds the 2^prob_bits decode LUT, (sminus << 20) |
//   (pdf << 8) | sym as in decode.py:46-59, in shared memory for each
//   member whose live blocks it takes.
//
// Float containers: the ANS archive sits at 4 + round_up(n, 16)/4 u32 for
// f16/bf16, 4 + round_up(n, 8)/2 + round_up(n, 16)/4 for f32, whose high
// plane starts at 4 + round_up(n, 8)/2; n is the container's word count.
// Outputs past a block's symbols are the plane joined with symbol 0, words
// past n are zero, raw bytes past a block's symbols zero. The optional XOR
// digest of the output is folded per warp and merged with atomicXor.
//
// Batched (the per_row_tables=True configurations of the TPU kernel, via
// ans_decode_batched_pallas and float_decompress_batched_pallas): the
// batch comes in one of two forms, chosen at run time.
//
// - Strided: member m's archive is row m of a buffer with a stride of
//   `a32` u32, which is also its read bound; its output is row m of the
//   output (nb_cap * 4096 symbols).
// - Descriptors (the reference's BatchProviderInlinePointer,
//   ans/BatchProvider.cuh:135-194): a table of B {archive, output, alen,
//   cap}, passed in the launch parameters up to kInline members and read
//   from the card above that. The archive is read where it lies, as the
//   first `alen` u32 (alen <= a32) of a row of a32 whose words past alen
//   read 0, which is what a zero-filled staging row of a32 holds; the
//   output is written up to `cap` symbols (cap <= nb_cap * 4096), in
//   div_up(cap, 4096) blocks. A member succeeds only if its header's
//   count fits `cap` too. With `in_place`, a member that fails takes no
//   blocks, so its output keeps every byte it had (the status contract
//   of torch_api.decompress_data, the reference's capacity check at
//   GpuANSDecode.cuh:326-337).
//
// The launch chooses the form at run time between two overloads of
// decode_kernel<kMode>, which a trace names alike. They share one body,
// instantiated once for each form, so that the strided form carries none
// of the descriptor form's per-member state. On an H100, against the
// strided kernel alone: a row, read bound and capacity held for every
// block slowed the strided batched decode by 6-15%, and one kernel that
// switched between the forms at run time by up to 3%; as two overloads
// the strided form is within 1% (batched raw, 2%).
//
// Member m's status is status[3m .. 3m + 3). A single archive is a batch
// of one. `static_nb` >= 0 is the batched path's known block count: the
// block geometry comes from it and success requires the header's count to
// equal it, as with static_nb in the TPU path.

#include <cstdint>
#include <cstring>
#include <type_traits>

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kHalf = 0;
constexpr int kF32 = 1;
constexpr int kRaw = 2;

constexpr int kBlockBytes = 4096;
constexpr int kMaxWords = 2560;     // u16 of a block's stream window
constexpr int kStreamBuf = 5136;    // 1280 u32 and a skew of <= 12 B, whole chunks
constexpr int kPlaneBuf = 4112;     // 1024 u32 and a skew
constexpr int kLoBuf = 8208;        // 2048 u32 and a skew
constexpr int kRound = 128;         // members parsed a round
constexpr int kLutWords = 2048;     // 2^11, the largest prob_bits
constexpr uint32_t kFloatMagic = 0xF00F0001u;
constexpr uint32_t kAnsMagic = 0xD00D0001u;
constexpr int kBf16 = 2;
constexpr int kInline = 128;        // descriptors a launch carries in its parameters
// shared bytes a CTA besides the warps' slots: the LUT and the pdf's
// prefix, seven int arrays of a round's members, the scans' scratch
constexpr int kOverhead = 4 * (kLutWords + 256) + kRound * 7 * 4 + 32 * 8;

template <int kMode>
struct Cfg {
  static constexpr int kWarps = kMode == kRaw ? 8 : (kMode == kF32 ? 12 : 11);
  static constexpr int kMinBlocks = kMode == kRaw ? 4 : (kMode == kF32 ? 1 : 2);  // a SM
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kSlot =
      kStreamBuf + (kMode == kRaw ? 0 : (kMode == kHalf ? kPlaneBuf : kLoBuf + kPlaneBuf));
  static constexpr int kSmem = kOverhead + kWarps * kSlot;
};
static_assert(kOverhead % 16 == 0 && kStreamBuf % 16 == 0 && kPlaneBuf % 16 == 0 &&
              kLoBuf % 16 == 0, "slots must stay 16-byte aligned");
static_assert(Cfg<kF32>::kSmem <= 232448, "more than a CTA may hold");

// A member of the descriptor form, 24 bytes (ans/cuda_decode.py's DESC).
struct Desc {
  const uint32_t* arc;  // the archive, where it lies
  void* out;            // the output, where it lies
  uint32_t alen;        // u32 of the archive that are read, <= a32
  uint32_t cap;         // symbols of the output, <= nb_cap * 4096
};
static_assert(sizeof(Desc) == 24, "ans/cuda_decode.py packs a descriptor in 24 bytes");

// The descriptor form's batch: its n descriptors on the card (`table`), or
// in the launch parameters (`d`, up to kInline: a __grid_constant__
// parameter, read in place, never copied to local memory).
struct Members {
  const Desc* table;
  long long n;
  Desc d[kInline];
};

__device__ __forceinline__ long long clampll(long long v, long long lo, long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Word `i` of a row whose first `alen` words lie at `arc`, the rest 0; in
// the strided form every word of the row lies there.
template <bool kDesc>
__device__ __forceinline__ uint32_t at(const uint32_t* __restrict__ arc, long long alen,
                                       long long i) {
  return !kDesc || i < alen ? arc[i] : 0u;
}

// Word `rel` of the ANS archive at u32 `base` of a row, as the plain
// version reads it (decode.py: decode_rows.take): clamped to [0, lim - 1],
// lim = max(rel_len, 137), and 0 at or past the archive's rel_len words
// (rel_len = a32 - base) or the row's `alen` read words.
template <bool kDesc>
__device__ __forceinline__ uint32_t take(const uint32_t* __restrict__ arc,
                                         long long base, long long rel_len,
                                         long long alen, long long rel) {
  const long long lim = rel_len > 137 ? rel_len : 137;
  const long long r = clampll(rel, 0, lim - 1);
  return r < rel_len ? at<kDesc>(arc, alen, base + r) : 0u;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copy the n row words [w0, w0 + n) to shared `dst`, word i landing at
// dst[skew + i], skew = the source's offset in its 16-byte chunk (returned).
// When `direct` (every word lies in the row's alen read words and reads as
// itself) and the chunks covering the range lie in them, by 16-byte
// cp.async; otherwise word by word through `slow(i)`. The caller waits for
// the copies.
template <class Slow>
__device__ __forceinline__ int stage(uint32_t* dst, const uint32_t* arc, long long alen,
                                     long long w0, int n, bool direct, Slow slow,
                                     int lane) {
  const uintptr_t src = reinterpret_cast<uintptr_t>(arc) + 4 * w0;
  const int skew = (int)((src & 15u) >> 2);
  if (direct) {
    const uintptr_t c0 = src & ~uintptr_t(15);
    const uintptr_t c1 = (src + 4 * (uintptr_t)n + 15) & ~uintptr_t(15);
    const uintptr_t r0 = reinterpret_cast<uintptr_t>(arc);
    const uintptr_t r1 = r0 + 4 * (uintptr_t)alen;
    if (c0 >= r0 && c1 <= r1) {
      const int chunks = (int)((c1 - c0) >> 4);
      for (int i = lane; i < chunks; i += 32) {
        cp_async16(dst + 4 * i, reinterpret_cast<const void*>(c0 + 16 * (uintptr_t)i));
      }
      return skew;
    }
  }
  for (int i = lane; i < n; i += 32) dst[skew + i] = slow(i);
  return skew;
}

// A member's headers, as the plain version parses them, and the blocks
// it takes.
struct Member {
  long long base;      // u32 of the ANS archive in the row
  long long hi_base;   // f32: u32 of the high plane
  int n_eff;           // float: the word count, clamped to [0, Lw]
  int nb_geo;          // blocks of the section geometry
  int nb_live;         // blocks that decode
  int nb_dead;         // blocks of the output past them: zeros, or planes
  bool ok;
  uint32_t n_word;     // the header's count (words, or raw bytes)
};

// The member whose row of a32 u32 has its first alen words at `arc` (the
// descriptor form; the strided form's rows lie whole at `arc`). Its dead
// blocks are the caller's to count.
template <int kMode, bool kDesc>
__device__ Member parse(const uint32_t* __restrict__ arc, long long a32, long long alen,
                        int nb_cap, int float_type, int prob_bits, long long static_length,
                        long long static_nb) {
  const long long Lw = (long long)nb_cap * kBlockBytes;
  Member M;
  M.base = 0;
  M.hi_base = 0;
  M.n_eff = 0;
  if constexpr (kMode == kRaw) {
    M.n_word = take<kDesc>(arc, 0, a32, alen, 2);
    M.ok = take<kDesc>(arc, 0, a32, alen, 0) == kAnsMagic &&
           (take<kDesc>(arc, 0, a32, alen, 4) & 0xfu) == (uint32_t)prob_bits &&
           (int)M.n_word <= Lw;
  } else {
    M.n_word = at<kDesc>(arc, alen, 1);
    const int n = (int)M.n_word;
    M.ok = at<kDesc>(arc, alen, 0) == kFloatMagic &&
           (at<kDesc>(arc, alen, 2) & 0xfu) == (uint32_t)float_type && n <= Lw;
    if (static_length >= 0) {
      M.ok = M.ok && (long long)n == (static_length < Lw ? static_length : Lw);
    }
    M.n_eff = (int)clampll(n, 0, Lw);
    if constexpr (kMode == kF32) {
      M.hi_base = 4 + ((M.n_eff + 7LL) / 8) * 4;
      M.base = M.hi_base + ((M.n_eff + 15LL) / 16) * 4;
    } else {
      M.base = 4 + ((M.n_eff + 15LL) / 16) * 4;
    }
    const long long rl = a32 - M.base;
    const int an = (int)take<kDesc>(arc, M.base, rl, alen, 2);
    M.ok = M.ok && take<kDesc>(arc, M.base, rl, alen, 0) == kAnsMagic &&
           (take<kDesc>(arc, M.base, rl, alen, 4) & 0xfu) == (uint32_t)prob_bits &&
           an <= Lw && an == M.n_eff;
  }
  const int nb = (int)take<kDesc>(arc, M.base, a32 - M.base, alen, 1);
  const int nb_eff = (int)clampll(nb, 0, nb_cap);
  M.nb_geo = nb_eff;
  M.nb_live = nb_eff;
  if (static_nb >= 0) {
    M.nb_geo = (int)(static_nb < nb_cap ? static_nb : nb_cap);
    M.ok = M.ok && nb == M.nb_geo;
    M.nb_live = M.nb_geo < nb_eff ? M.nb_geo : nb_eff;
  }
  return M;
}

// Inclusive prefix over a warp.
__device__ __forceinline__ long long warp_scan(long long v, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += y;
  }
  return v;
}

__device__ __forceinline__ long long warp_sum(long long v) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

__device__ __forceinline__ void flush_digest(uint32_t& digest, uint32_t* status,
                                             int lane) {
  for (int d = 16; d > 0; d >>= 1) digest ^= __shfl_xor_sync(0xffffffffu, digest, d);
  digest ^= digest >> 16;
  digest ^= digest >> 8;
  digest &= 0xffu;
  if (lane == 0 && digest) atomicXor(&status[2], digest);
  digest = 0;
}

// The kernel's body for one form of the batch: strided (kDesc false:
// member m's archive is row m of `arcs`, a32 u32 a row, its output row m of
// `out_all`) or descriptors (`descs`), each form its own instantiation.
template <int kMode, bool kDesc>
__device__ __forceinline__ void decode_batch(
    const uint32_t* __restrict__ arcs, long long batch, long long a32,
    void* __restrict__ out_all, const Desc* __restrict__ descs, int in_place, int nb_cap,
    int float_type, int prob_bits, long long static_length, long long static_nb,
    int with_digest, uint32_t* __restrict__ status_all) {
  constexpr int kWarps = Cfg<kMode>::kWarps;
  constexpr int kThreads = Cfg<kMode>::kThreads;
  constexpr int kOut = kMode == kRaw ? 1 : (kMode == kF32 ? 4 : 2);  // bytes a symbol
  using Sym = std::conditional_t<kMode == kRaw, uint8_t,
                                 std::conditional_t<kMode == kF32, uint32_t, uint16_t>>;
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* lut = reinterpret_cast<uint32_t*>(smem);
  uint32_t* incl = lut + kLutWords;
  long long* s_warp = reinterpret_cast<long long*>(incl + 256);  // 32 scan words
  int* m_base = reinterpret_cast<int*>(s_warp + 32);  // a round's members: ANS base,
  int* m_hib = m_base + kRound;                       // f32 high plane,
  int* m_neff = m_hib + kRound;                       // word count,
  int* m_geo = m_neff + kRound;                       // geometry's blocks,
  int* m_live = m_geo + kRound;                       // blocks that decode,
  int* m_l0 = m_live + kRound;  // first live block in the prefix of all members
  int* m_d0 = m_l0 + kRound;    // first dead block in the prefix of all members

  const long long Lw = (long long)nb_cap * kBlockBytes;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  uint8_t* slot = smem + kOverhead + warp * Cfg<kMode>::kSlot;
  uint32_t* sbuf = reinterpret_cast<uint32_t*>(slot);
  uint32_t* pbuf = reinterpret_cast<uint32_t*>(slot + kStreamBuf);  // nonComp or high plane
  uint32_t* lobuf = reinterpret_cast<uint32_t*>(slot + kStreamBuf + kPlaneBuf);
  const uint32_t smask = (1u << prob_bits) - 1u;
  const bool bf16 = float_type == kBf16;
  const bool cta0 = blockIdx.x == 0;

  // member m's header parsed and its blocks counted: its output's blocks
  // are nb_cap in the strided form; in the descriptor form its capacity's,
  // which the header's count must fit, and none where an in-place member
  // fails
  auto member = [&](long long m) {
    const Desc d = kDesc ? descs[m] : Desc{};
    Member M = parse<kMode, kDesc>(kDesc ? d.arc : arcs + m * a32, a32, kDesc ? d.alen : a32,
                                   nb_cap, float_type, prob_bits, static_length, static_nb);
    int nb_out = nb_cap;
    if constexpr (kDesc) {
      nb_out = (int)((d.cap + kBlockBytes - 1) / kBlockBytes);
      M.ok = M.ok && M.n_word <= d.cap;
      if (in_place && !M.ok) nb_out = 0;
      M.nb_live = M.nb_live < nb_out ? M.nb_live : nb_out;
    }
    M.nb_dead = nb_out - M.nb_live;
    return M;
  };

  // ---- totals of live and dead blocks over the batch ----
  long long l_tot = 0;
  long long d_tot = 0;
  if (batch > kRound) {  // more than one round: a pass of its own
    long long l = 0;
    long long d = 0;
    for (long long m = threadIdx.x; m < batch; m += kThreads) {
      const Member M = member(m);
      l += M.nb_live;
      d += M.nb_dead;
      if (cta0) {
        status_all[3 * m] = M.ok ? 1u : 0u;
        status_all[3 * m + 1] = M.n_word;
      }
    }
    l = warp_sum(l);
    d = warp_sum(d);
    if (lane == 0) {
      s_warp[warp] = l;
      s_warp[16 + warp] = d;
    }
    __syncthreads();
    for (int w = 0; w < kWarps; ++w) {
      l_tot += s_warp[w];
      d_tot += s_warp[16 + w];
    }
    __syncthreads();
  }

  uint32_t digest = 0;
  long long cl = 0;  // live blocks of the members before this round
  long long cd = 0;  // dead blocks of the members before this round
  long long L0 = 0, L1 = 0, D0 = 0, D1 = 0;
  for (long long r0 = 0; r0 < batch; r0 += kRound) {
    long long live = 0;
    long long dead = 0;
    if (threadIdx.x < kRound && r0 + threadIdx.x < batch) {
      const long long m = r0 + threadIdx.x;
      const Member M = member(m);
      m_base[threadIdx.x] = (int)M.base;
      m_hib[threadIdx.x] = (int)M.hi_base;
      m_neff[threadIdx.x] = M.n_eff;
      m_geo[threadIdx.x] = M.nb_geo;
      m_live[threadIdx.x] = M.nb_live;
      live = M.nb_live;
      dead = M.nb_dead;
      if (cta0 && batch <= kRound) {
        status_all[3 * m] = M.ok ? 1u : 0u;
        status_all[3 * m + 1] = M.n_word;
      }
    }
    // prefix over the round's members (threads 0..127, four warps)
    long long vl = warp_scan(live, lane);
    long long vd = warp_scan(dead, lane);
    if (lane == 31 && warp < kRound / 32) {
      s_warp[warp] = vl;
      s_warp[16 + warp] = vd;
    }
    __syncthreads();
    long long tl = 0;
    long long td = 0;
    for (int w = 0; w < kRound / 32; ++w) {
      if (w < warp) {
        vl += s_warp[w];
        vd += s_warp[16 + w];
      }
      tl += s_warp[w];
      td += s_warp[16 + w];
    }
    if (threadIdx.x < kRound) {
      m_l0[threadIdx.x] = (int)(cl + vl - live);
      m_d0[threadIdx.x] = (int)(cd + vd - dead);
    }
    if (batch <= kRound) {
      l_tot = tl;
      d_tot = td;
    }
    if (r0 == 0) {  // this CTA's shares of the live and the dead blocks
      const long long lc = (l_tot + gridDim.x - 1) / gridDim.x;
      const long long dc = (d_tot + gridDim.x - 1) / gridDim.x;
      L0 = blockIdx.x * lc;
      L1 = L0 + lc < l_tot ? L0 + lc : l_tot;
      D0 = blockIdx.x * dc;
      D1 = D0 + dc < d_tot ? D0 + dc : d_tot;
    }
    __syncthreads();

    const int nm = batch - r0 < kRound ? (int)(batch - r0) : kRound;
    for (int j = 0; j < nm; ++j) {
      const long long m = r0 + j;
      const Desc d = kDesc ? descs[m] : Desc{};
      const uint32_t* __restrict__ arc = kDesc ? d.arc : arcs + m * a32;
      const long long alen = kDesc ? d.alen : a32;  // u32 of the row that are read
      uint8_t* out_m = kDesc ? static_cast<uint8_t*>(d.out)
                             : static_cast<uint8_t*>(out_all) + m * Lw * kOut;
      const long long cap = kDesc ? d.cap : Lw;  // symbols of the output
      uint32_t* status = status_all + 3 * m;
      const long long base = m_base[j];
      const long long rel_len = a32 - base;
      const long long hi_base = m_hib[j];
      const int n_eff = m_neff[j];
      const int nb_geo = m_geo[j];
      const int nb_live = m_live[j];
      // the member's dead blocks: the rest of its nb_cap; in the descriptor
      // form, up to the next member's first one
      const long long nb_dead =
          kDesc ? (j + 1 < nm ? m_d0[j + 1] : cd + td) - m_d0[j] : nb_cap - nb_live;
      const long long lo_l = m_l0[j] > L0 ? m_l0[j] : L0;
      const long long hi_l = m_l0[j] + nb_live < L1 ? m_l0[j] + nb_live : L1;
      const long long lo_d = m_d0[j] > D0 ? m_d0[j] : D0;
      const long long hi_d = m_d0[j] + nb_dead < D1 ? m_d0[j] + nb_dead : D1;
      const bool any_live = lo_l < hi_l;
      const bool any_dead = lo_d < hi_d;
      if (!any_live && !any_dead) continue;

      if (any_live) {
        // ---- the member's decode LUT: sym = #{incl <= slot} ----
        __syncthreads();  // the last member's blocks are done with the LUT
        if (warp == 0) {  // the pdf's inclusive prefix
          uint32_t pw[8];
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            pw[c] = take<kDesc>(arc, base, rel_len, alen, 8 + 16 * c + lane / 2);
          }
          uint32_t carry = 0;
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            uint32_t v = (lane & 1) ? (pw[c] >> 16) : (pw[c] & 0xffffu);
            for (int d = 1; d < 32; d <<= 1) {
              const uint32_t y = __shfl_up_sync(0xffffffffu, v, d);
              if (lane >= d) v += y;
            }
            incl[32 * c + lane] = v + carry;
            carry += __shfl_sync(0xffffffffu, v, 31);
          }
        }
        __syncthreads();
        for (int s = threadIdx.x; s <= (int)smask; s += kThreads) {
          int lo = 0;
          int hi = 256;
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (incl[mid] <= (uint32_t)s) lo = mid + 1; else hi = mid;
          }
          const uint32_t sym = lo < 255 ? lo : 255;
          const uint32_t pof = incl[sym] - (sym ? incl[sym - 1] : 0u);
          const uint32_t sminus = (uint32_t)s - (incl[sym] - pof);
          lut[s] = (sminus << 20) | (pof << 8) | sym;
        }
        __syncthreads();
      }

      const long long bw_rel = 136 + 32LL * nb_geo;
      const long long ds_rel = bw_rel + 2LL * (nb_geo + (nb_geo & 1));
      // live blocks [lo_l - l0, hi_l - l0), then dead ones from nb_live on
      const long long n_l = any_live ? hi_l - lo_l : 0;
      const long long n_d = any_dead ? hi_d - lo_d : 0;
      const long long lb0 = lo_l - m_l0[j];                 // first live block
      const long long db0 = nb_live + (lo_d - m_d0[j]) - n_l;  // + i: a dead block
      // a live block's words in the block table and its lanes' final states,
      // loaded a block ahead so that they arrive while the warp walks
      uint32_t bx = 0;
      int start = 0;
      uint32_t state = 0;
      auto head = [&](long long b) {
        bx = take<kDesc>(arc, base, rel_len, alen, bw_rel + 2 * b);
        start = (int)take<kDesc>(arc, base, rel_len, alen, bw_rel + 2 * b + 1);
        state = take<kDesc>(arc, base, rel_len, alen, 136 + 32 * b + lane);
      };
      if (warp < n_l) head(lb0 + warp);
      for (long long i = warp; i < n_l + n_d; i += kWarps) {
        const bool is_live = i < n_l;
        const long long b = is_live ? lb0 + i : db0 + i;
        uint8_t* outb = out_m + b * kBlockBytes * kOut;
        // words of this block below the container's count, and symbols of
        // it the output holds
        const int vlim = (int)clampll((long long)n_eff - b * kBlockBytes, 0, kBlockBytes);
        const int olim =
            kDesc ? (int)clampll(cap - b * kBlockBytes, 0, kBlockBytes) : kBlockBytes;
        if (!is_live && (kMode == kRaw || vlim == 0)) {
          if (!kDesc ||
              (olim == kBlockBytes && (reinterpret_cast<uintptr_t>(outb) & 15u) == 0)) {
            uint4* o = reinterpret_cast<uint4*>(outb);
            for (int q = lane; q < kBlockBytes * kOut / 16; q += 32) o[q] = make_uint4(0, 0, 0, 0);
          } else {
            for (int p = lane; p < olim; p += 32) reinterpret_cast<Sym*>(outb)[p] = 0;
          }
          continue;
        }

        int kmax = 0;
        int rem = 0;
        int pos = 0;
        uint32_t st = 0;
        int sskew = 0;
        if (is_live) {
          const int uncomp = (int)(bx >> 16);
          const int cw = (int)(bx & 0xffffu);
          const int steps = (uncomp + 31) / 32;
          kmax = steps < 128 ? steps : 128;
          rem = steps <= 128 ? uncomp % 32 : 0;  // lanes of a ragged last step
          pos = cw;
          st = state;
          // the stream window the refills can reach: u16 [0, n16)
          const int n16 = cw < 1 ? 1 : (cw > kMaxWords ? kMaxWords : cw);
          const int n32 = (n16 + 1) / 2;
          const long long s_rel = ds_rel + (start >> 1);
          sskew = stage(sbuf, arc, alen, base + s_rel, n32,
                        s_rel >= 0 && (kDesc ? base + s_rel + n32 <= alen
                                             : s_rel + n32 <= rel_len),
                        [&](int w) { return take<kDesc>(arc, base, rel_len, alen, s_rel + w); },
                        lane);
        }
        int pskew = 0;
        int loskew = 0;
        if constexpr (kMode != kRaw) {
          // plane words past the row's read words read 0
          auto plane = [&](uint32_t* buf, long long w0, int n) {
            return stage(buf, arc, alen, w0, n, w0 + n <= alen,
                         [&](int w) { return w0 + w < alen ? arc[w0 + w] : 0u; }, lane);
          };
          if constexpr (kMode == kF32) {
            loskew = plane(lobuf, 4 + b * (kBlockBytes / 2), kBlockBytes / 2);
            pskew = plane(pbuf, hi_base + b * (kBlockBytes / 4), kBlockBytes / 4);
          } else {
            pskew = plane(pbuf, 4 + b * (kBlockBytes / 4), kBlockBytes / 4);
          }
        }
        if (i + kWarps < n_l) head(lb0 + i + kWarps);
        cp_async_wait_all();
        __syncwarp();

        const uint16_t* st16 = reinterpret_cast<const uint16_t*>(sbuf + sskew);
        const uint8_t* pl8 = reinterpret_cast<const uint8_t*>(pbuf + pskew);
        const uint16_t* lo16 = reinterpret_cast<const uint16_t*>(lobuf + loskew);
        // output k * 32 + lane of the block for symbol `sym`; `edge` when
        // the block holds the container's last word or the output's last
        // symbol: words past the count are 0, symbols past the output are
        // not written
        auto emit = [&](int k, uint32_t sym, auto edge) {
          const int p = k * 32 + lane;
          if (kDesc && decltype(edge)::value && p >= olim) return;
          if constexpr (kMode == kRaw) {
            outb[p] = (uint8_t)sym;
            digest ^= sym;
          } else if constexpr (kMode == kF32) {
            uint32_t w = (sym << 24) | ((uint32_t)pl8[p] << 16) | lo16[p];
            w = (w >> 1) | (w << 31);
            if (decltype(edge)::value && p >= vlim) w = 0;
            reinterpret_cast<uint32_t*>(outb)[p] = w;
            digest ^= w;
          } else {
            uint32_t w = (sym << 8) | pl8[p];
            if (bf16) w = ((w >> 1) | (w << 15)) & 0xffffu;
            if (decltype(edge)::value && p >= vlim) w = 0;
            reinterpret_cast<uint16_t*>(outb)[p] = (uint16_t)w;
            digest ^= w;
          }
        };
        // one step of the walk for the lanes in `act`
        const unsigned ge = 0xffffffffu << lane;  // lanes >= this one
        auto step = [&](bool act) {
          uint32_t sym = 0;
          if (act) {
            const uint32_t t = lut[st & smask];
            sym = t & 0xffu;
            st = ((t >> 8) & 0xfffu) * (st >> prob_bits) + (t >> 20);
          }
          const bool rd = act && st < (1u << 15);
          const unsigned ballot = __ballot_sync(0xffffffffu, rd);
          if (rd) {
            int ridx = pos - __popc(ballot & ge);
            ridx = ridx < 0 ? 0 : (ridx > kMaxWords - 1 ? kMaxWords - 1 : ridx);
            st = (st << 16) + st16[ridx];
          }
          pos -= __popc(ballot);
          return sym;
        };
        auto walk = [&](auto edge) {
          for (int k = 127; k >= kmax; --k) emit(k, 0, edge);
          int k = kmax - 1;
          if (rem > 0) {  // the ragged last step
            emit(k, step(lane < rem), edge);
            --k;
          }
#pragma unroll 4
          for (; k >= 0; --k) emit(k, step(true), edge);
        };
        if ((kMode != kRaw && vlim < kBlockBytes) || (kDesc && olim < kBlockBytes)) {
          walk(std::true_type{});
        } else {
          walk(std::false_type{});
        }
        __syncwarp();  // the slot is free for the warp's next block
      }
      if (with_digest) flush_digest(digest, status, lane);
    }
    cl += tl;
    cd += td;
    __syncthreads();  // the round's arrays are rewritten next round
    if (cl >= L1 && cd >= D1) break;  // statuses: pass 1, or the one round
  }
}

// The strided form.
template <int kMode>
__global__ void __launch_bounds__(Cfg<kMode>::kThreads, Cfg<kMode>::kMinBlocks)
decode_kernel(const uint32_t* __restrict__ arcs, long long batch, long long a32,
              void* __restrict__ out_all, int nb_cap, int float_type,
              int prob_bits, long long static_length, long long static_nb,
              int with_digest, uint32_t* __restrict__ status_all) {
  decode_batch<kMode, false>(arcs, batch, a32, out_all, nullptr, 0, nb_cap, float_type,
                             prob_bits, static_length, static_nb, with_digest, status_all);
}

// The descriptor form.
template <int kMode>
__global__ void __launch_bounds__(Cfg<kMode>::kThreads, Cfg<kMode>::kMinBlocks)
decode_kernel(const __grid_constant__ Members mb, long long a32, int nb_cap, int float_type,
              int prob_bits, long long static_length, long long static_nb, int with_digest,
              int in_place, uint32_t* __restrict__ status_all) {
  decode_batch<kMode, true>(nullptr, mb.n, a32, nullptr,
                            mb.table != nullptr ? mb.table : mb.d, in_place, nb_cap,
                            float_type, prob_bits, static_length, static_nb, with_digest,
                            status_all);
}

// Each configuration's kernel (kMode's order) in the two forms, which the
// types tell apart.
using Strided = void (*)(const uint32_t*, long long, long long, void*, int, int, int, long long,
                         long long, int, uint32_t*);
using ByMember = void (*)(Members, long long, int, int, int, long long, long long, int, int,
                          uint32_t*);
const Strided kStrided[3] = {decode_kernel<kHalf>, decode_kernel<kF32>, decode_kernel<kRaw>};
const ByMember kByMember[3] = {decode_kernel<kHalf>, decode_kernel<kF32>, decode_kernel<kRaw>};

// Their shapes, the strided form's then the descriptor form's
// (configuration 3 + kMode), with shared memory before L1, so that the
// CTAs the slots allow fit on an SM.
dtt::Kernel kDecode[6] = {
    {kStrided[kHalf], Cfg<kHalf>::kThreads, Cfg<kHalf>::kSmem, true},
    {kStrided[kF32], Cfg<kF32>::kThreads, Cfg<kF32>::kSmem, true},
    {kStrided[kRaw], Cfg<kRaw>::kThreads, Cfg<kRaw>::kSmem, true},
    {kByMember[kHalf], Cfg<kHalf>::kThreads, Cfg<kHalf>::kSmem, true},
    {kByMember[kF32], Cfg<kF32>::kThreads, Cfg<kF32>::kSmem, true},
    {kByMember[kRaw], Cfg<kRaw>::kThreads, Cfg<kRaw>::kSmem, true},
};

}  // namespace

// The one entry point of the three configurations, chosen by float_type:
// 1 or 2 (f16/bf16 containers -> nb_cap * 4096 words per row, as 8-byte
// aligned u32 pairs; a descriptor's output is 2-byte aligned), 3 (f32
// containers -> nb_cap * 4096 u32 words per row, 16-byte aligned; a
// descriptor's output is 4-byte aligned) or 0 (raw ANS archives -> nb_cap
// * 4096 bytes per row, 16-byte aligned, zero past each block's symbols; a
// descriptor's output has any alignment). It takes `batch` archives, rows
// of a32 u32 each, writes `batch` output rows, and 3 status words per
// member, zeroed by the caller: success, the header's count (words of a
// float container, bytes of a raw archive) and the folded output digest.
// static_length < 0 and static_nb < 0 mean none; a raw archive has no
// static_length. With `descs` (a host array of up to kInline Desc) or
// `table` (the same on the card, for more members), the batch is in the
// descriptor form and `arcs` and `out` are unused; `in_place` then leaves
// a failing member's output as it was.
extern "C" int dtt_decode(const void* arcs, long long batch, long long a32,
                          void* out, int nb_cap, int float_type, int prob_bits,
                          long long static_length, long long static_nb,
                          int with_digest, void* status, const void* descs,
                          const void* table, int in_place, void* stream) {
  if (float_type < 0 || float_type > 3) return (int)cudaErrorInvalidValue;
  if (batch <= 0) return (int)cudaGetLastError();
  const int mode = float_type == 0 ? kRaw : (float_type == 3 ? kF32 : kHalf);
  const bool strided = descs == nullptr && table == nullptr;
  // a table is for more than kInline members, the inline descriptors for
  // up to kInline
  if (!strided &&
      ((descs != nullptr) == (table != nullptr) || (descs != nullptr) != (batch <= kInline))) {
    return (int)cudaErrorInvalidValue;
  }
  dtt::Kernel& k = kDecode[(strided ? 0 : 3) + mode];
  const int warps = k.threads / 32;
  unsigned grid = 0;  // one wave, a block a warp at the least
  const cudaError_t e = k.wave((batch * nb_cap + warps - 1) / warps, &grid);
  if (e != cudaSuccess) return (int)e;
  if (strided) {
    kStrided[mode]<<<grid, k.threads, k.smem, (cudaStream_t)stream>>>(
        static_cast<const uint32_t*>(arcs), batch, a32, out, nb_cap, float_type, prob_bits,
        static_length, static_nb, with_digest, static_cast<uint32_t*>(status));
    return (int)cudaGetLastError();
  }
  Members mb;
  mb.table = static_cast<const Desc*>(table);
  mb.n = batch;
  if (descs != nullptr) memcpy(mb.d, descs, sizeof(Desc) * batch);
  kByMember[mode]<<<grid, k.threads, k.smem, (cudaStream_t)stream>>>(
      mb, a32, nb_cap, float_type, prob_bits, static_length, static_nb, with_digest, in_place,
      static_cast<uint32_t*>(status));
  return (int)cudaGetLastError();
}

// The resources of configuration `config` (0 f16/bf16, 1 f32, 2 raw; 3-5
// the same in the descriptor form), into out[0..5] (launch.cuh).
extern "C" int dtt_decode_resources(int config, int* out) {
  if (config < 0 || config >= 6) return (int)cudaErrorInvalidValue;
  return kDecode[config].report(out);
}
