// rANS encode of 4 KiB blocks, 32 interleaved states, with per-block
// stream compaction into a staging row, for a batch of members, each with its
// own table (a single input is a batch of one).
//
// Replaces: dietgpu_tpu/ans/pallas_encode.py:_encode_kernel (via
// _encode_stage1, and with per_row_tables=True via
// ans_encode_batched_pallas), the reference's ansEncodeBatchFull /
// encodeOneWarp (GpuANSEncode.cuh:49-211).
//
// Bound on the H100: the least time counted for it is its bytes over 3.35
// TB/s (a block moves 4 KiB in, at most 5 KiB and 132 bytes out). What the
// kernel waits on is instruction issue and the shared-memory pipe: each of
// a block's 128 steps is, for 32 symbols, a symbol load, a 16-byte table
// load, the emission vote with two population counts and a store, and the
// state update, 18 instructions a warp (`cuobjdump -sass`); a warp's steps
// form one dependent chain, but 24 or 32 chains an SM time the same.
//
// Design:
//
// - One warp encodes one block at a time: lane l holds state l, step s
//   encodes symbol 32 s + l going forward, as in the reference. A lane
//   whose state reaches pdf << (31 - prob_bits) emits its low 16 bits; the
//   emitted words are compacted with __ballot_sync/__popc in (step, lane)
//   order into the block's staging row of 2560 u16. A block whose payload
//   would pass 2560 words stops writing (the count keeps growing, so the
//   caller sees the overflow and sets SIZE_OVERFLOW_BIT, as encode.py does).
// - Few instructions a step. The CTA's table is rebuilt in shared memory as
//   one 16-byte entry a symbol (see load_table), so a step makes one table
//   load and extracts no field: the quotient is a multiply-high and a
//   funnel shift that reads only the low 5 bits of the entry's last word,
//   the new state one add-with-shift and one multiply-add. Symbols are read
//   one byte a lane at immediate offsets. 32 steps (a quarter block) are
//   unrolled whole and carry no valid test and no overflow test where
//   neither can fire: a full block, and a count that 1024 more words cannot
//   take past 2560. Only a member's last block and a block near overflow
//   take the checked form.
// - The symbols come in by cp.async a quarter block (1 KiB) at a time into
//   a ring of four slots a warp: a slot is refilled with the same quarter
//   of the warp's next block as soon as it is consumed, so each warp waits
//   on device memory once a member, not once a block. 8 warps and 36 KiB a
//   CTA, 4 CTAs (32 warps) an SM.
// - Persistent CTAs: the grid fills the SMs once. The blocks that hold
//   symbols (a member's first ceil(length / 4096)) form one index space
//   over the batch; CTA i takes the i-th contiguous share of it and finds
//   the members it touches with a block-wide prefix of their block counts
//   (on the card, from `lengths` or the one `length`, 256 members a round),
//   loading each member's table once; its warps take the member's blocks in
//   turn. A ragged batch costs what its live blocks cost. Blocks past a
//   member's length (count 0, every state the start state) are written by
//   a grid-stride pass of their own, with no symbol copy.
//
// Batched: member m's blocks are rows m * NBm + b of the staging, count and
// state outputs, and its length comes from a device array, or is one scalar
// for every member (a single input, a float batch of one static length).

#include <cstdint>
#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

constexpr int kBlockBytes = 4096;
constexpr int kLanes = 32;
constexpr int kMaxWords = 2560;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMinBlocks = 4;  // CTAs per SM the launch bound asks for
constexpr int kQuarter = kBlockBytes / 4;  // a ring slot: 32 steps of symbols
constexpr int kQuarterSteps = kQuarter / kLanes;
constexpr int kTableWords = 512;
constexpr uint32_t kStartState = 1u << 15;
constexpr int kTableBytes = 256 * 16;
constexpr int kSmem = kTableBytes + kWarps * kBlockBytes;  // dynamic, a CTA

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

// A member's table (e1 = shift << 24 | pdf << 12 | cdf, then magic) as the
// step's 16-byte entries {m, pdf << (31 - prob_bits), 2^prob_bits - pdf,
// cdf' << 5 | k}. A state is below 2^31 where it is divided, and for pdf >=
// 2, with k = ceil(log2 pdf) - 1 and m = ceil(2^(32 + k) / pdf) < 2^32,
// floor(x / pdf) = umulhi(x, m) >> k for every x < 2^31 (m's error is
// below 2^(k + 1)), as the table's own magic numbers divide exactly: the
// quotients are equal. For pdf <= 1 (which the table's magic numbers
// divide as 1), m = 2^32 - 1 gives x - 1 for x >= 1, one multiple of
// 2^prob_bits - pdf short in the new state, which cdf' = cdf + 2^prob_bits
// - pdf restores (mod 2^32).
__device__ __forceinline__ void load_table(const uint32_t* __restrict__ table,
                                           uint4* tab, int prob_bits) {
  const uint32_t cs = 31u - (uint32_t)prob_bits;
  for (int i = threadIdx.x; i < 256; i += kThreads) {
    const uint32_t e1 = table[i];
    const uint32_t pdf = (e1 >> 12) & 0xfffu;
    const uint32_t cmpl = (1u << prob_bits) - pdf;
    uint32_t cdf = e1 & 0xfffu;
    uint32_t m = 0xffffffffu;
    uint32_t k = 0;
    if (pdf <= 1) {
      cdf += cmpl;
    } else {
      k = 31u - __clz(pdf - 1);  // ceil(log2 pdf) - 1
      m = (uint32_t)(((1ull << (32 + k)) + pdf - 1) / pdf);
    }
    tab[i] = make_uint4(m, pdf << cs, cmpl, (cdf << 5) | k);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// The warp's copy of a quarter block's 1024 symbol bytes, as one cp.async
// group.
__device__ __forceinline__ void stage_quarter(uint8_t* dst, const uint8_t* src, int lane) {
  cp_async16(dst + 16 * lane, src + 16 * lane);
  cp_async16(dst + 512 + 16 * lane, src + 512 + 16 * lane);
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Waits for every group but the 3 newest.
__device__ __forceinline__ void wait_oldest() {
  asm volatile("cp.async.wait_group 3;\n" ::: "memory");
}

// One step for the lanes where `v`, with the symbol's entry `e`.
template <bool kCheck>
__device__ __forceinline__ void step(uint32_t& state, uint32_t& count, const uint4 e,
                                     bool v, uint16_t* __restrict__ out, uint32_t below) {
  const bool write = v && state >= e.y;
  const unsigned ballot = __ballot_sync(0xffffffffu, write);
  if (write) {
    const uint32_t pos = count + __popc(ballot & below);
    if (!kCheck || pos < kMaxWords) __stcg(out + pos, (unsigned short)state);
  }
  state = write ? state >> 16 : state;
  count += __popc(ballot);
  // (div << prob_bits) + state - div * pdf + cdf, mod 2^32
  const uint32_t div = __funnelshift_r(__umulhi(state, e.x), 0u, e.w);
  const uint32_t next = div * e.z + (state + (e.w >> 5));
  if (v) state = next;
}

// 32 steps of a block from the ring slot `sy`: symbols i0 + [0, 1024) of
// the block, of which those below `nvalid` are encoded. The fast form, for
// a full quarter whose words cannot pass 2560 (32 steps emit at most 1024),
// has no valid or overflow test and is unrolled whole.
__device__ __forceinline__ void quarter_fast(const uint8_t* sy, const uint4* tab,
                                             uint32_t& state, uint32_t& count,
                                             uint16_t* __restrict__ out, uint32_t below,
                                             int lane) {
  const uint8_t* p = sy + lane;
#pragma unroll
  for (int s = 0; s < kQuarterSteps; ++s) {
    step<false>(state, count, tab[p[s * kLanes]], true, out, below);
  }
}

__device__ __forceinline__ void quarter_checked(const uint8_t* sy, int i0, int nvalid,
                                                const uint4* tab, uint32_t& state,
                                                uint32_t& count, uint16_t* __restrict__ out,
                                                uint32_t below, int lane) {
#pragma unroll 4
  for (int s = 0; s < kQuarterSteps; ++s) {
    const int i = s * kLanes + lane;
    step<true>(state, count, tab[sy[i]], i0 + i < nvalid, out, below);
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
encode_kernel(const uint8_t* __restrict__ data, long long batch, long long nbm,
              long long length, const long long* __restrict__ lengths,
              int prob_bits, const uint32_t* __restrict__ tables,
              uint16_t* __restrict__ staged, uint32_t* __restrict__ counts,
              uint32_t* __restrict__ states) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ long long s_start[kThreads];
  __shared__ long long s_warp[kWarps];
  uint4* tab = reinterpret_cast<uint4*>(smem);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  uint8_t* ring = smem + kTableBytes + warp * kBlockBytes;  // 4 quarter slots

  // blocks of member m that hold symbols
  auto live_blocks = [&](long long m) {
    const long long n = lengths == nullptr ? length : lengths[m];
    const long long nb = n <= 0 ? 0 : (n + kBlockBytes - 1) / kBlockBytes;
    return nb < nbm ? nb : nbm;
  };

  // ---- blocks past their member's symbols: count 0, the start states ----
  if (lengths != nullptr || live_blocks(0) < nbm) {
    const long long nw = (long long)gridDim.x * kWarps;
    for (long long r = (long long)blockIdx.x * kWarps + warp; r < batch * nbm; r += nw) {
      const long long m = r / nbm;
      if (r - m * nbm < live_blocks(m)) continue;
      states[r * kLanes + lane] = kStartState;
      if (lane == 0) counts[r] = 0;
    }
  }

  // ---- this CTA's share of the live blocks ----
  long long total = 0;
  if (lengths == nullptr) {
    total = batch * live_blocks(0);
  } else {
    long long s = 0;
    for (long long m = threadIdx.x; m < batch; m += kThreads) s += live_blocks(m);
    for (int d = 16; d > 0; d >>= 1) s += __shfl_xor_sync(0xffffffffu, s, d);
    if (lane == 0) s_warp[warp] = s;
    __syncthreads();
    for (int w = 0; w < kWarps; ++w) total += s_warp[w];
    __syncthreads();  // s_warp is the scan's next
  }
  const long long share = (total + gridDim.x - 1) / gridDim.x;
  const long long q0 = (long long)blockIdx.x * share;
  const long long q1 = q0 + share < total ? q0 + share : total;
  if (q0 >= q1) return;  // the whole CTA: an empty share

  long long carry = 0;  // live blocks of the members before this round
  for (long long r0 = 0; r0 < batch && carry < q1; r0 += kThreads) {
    const long long m = r0 + threadIdx.x;
    const long long nb = m < batch ? live_blocks(m) : 0;
    long long round_total;
    const long long incl = block_scan(nb, s_warp, &round_total);
    s_start[threadIdx.x] = carry + incl - nb;
    __syncthreads();

    const int nm = batch - r0 < kThreads ? (int)(batch - r0) : kThreads;
    for (int j = 0; j < nm; ++j) {
      const long long st = s_start[j];
      if (st >= q1) break;
      const long long en = j + 1 < nm ? s_start[j + 1] : carry + round_total;
      const long long lo = st > q0 ? st : q0;
      const long long hi = en < q1 ? en : q1;
      if (lo >= hi) continue;

      // ---- member r0 + j, its blocks [lo - st, hi - st), a warp each in turn ----
      const long long mm = r0 + j;
      const uint8_t* src = data + mm * nbm * kBlockBytes;
      const long long n = lengths == nullptr ? length : lengths[mm];
      const long long b_end = hi - st;
      long long b = lo - st + warp;
      // the ring: quarter q of a block in slot q, the next block's quarter
      // copied in as soon as the slot is free; four groups in flight
      for (int q = 0; q < 4; ++q) {
        if (b < b_end) stage_quarter(ring + q * kQuarter, src + b * kBlockBytes + q * kQuarter, lane);
        commit();
      }
      __syncthreads();  // the last member's blocks are done with the table
      load_table(tables + mm * kTableWords, tab, prob_bits);
      __syncthreads();
      for (; b < b_end; b += kWarps) {
        const long long row = mm * nbm + b;
        uint16_t* out = staged + row * kMaxWords;
        // Pin the output row's address in a register: otherwise nvcc
        // recomputes the 64-bit row offset at every store.
        asm volatile("" : "+l"(out));
        const long long rem = n - b * kBlockBytes;
        const int nvalid = rem >= kBlockBytes ? kBlockBytes : (int)rem;
        const bool next = b + kWarps < b_end;
        const uint32_t below = (1u << lane) - 1u;
        uint32_t state = kStartState;
        uint32_t count = 0;
        for (int q = 0; q < 4; ++q) {
          wait_oldest();
          __syncwarp();
          const uint8_t* sy = ring + q * kQuarter;
          if (nvalid == kBlockBytes && count + kQuarter <= (uint32_t)kMaxWords) {
            quarter_fast(sy, tab, state, count, out, below, lane);
          } else if (q * kQuarter < nvalid) {
            quarter_checked(sy, q * kQuarter, nvalid, tab, state, count, out, below, lane);
          }
          __syncwarp();  // the slot is free
          if (next) {
            stage_quarter(ring + q * kQuarter,
                          src + (b + kWarps) * kBlockBytes + q * kQuarter, lane);
          }
          commit();
        }
        states[row * kLanes + lane] = state;
        if (lane == 0) counts[row] = count;
      }
    }
    carry += round_total;
    __syncthreads();  // s_start and s_warp are rewritten next round
  }
}

// The kernel, with shared memory before L1, so that the CTAs its slots
// allow fit on an SM.
dtt::Kernel kEncode(encode_kernel, kThreads, kSmem, true);

}  // namespace

// data: `batch` rows of nbm * 4096 symbol bytes (16-byte aligned); member
// m encodes the first lengths[m] bytes of its row (int64, <= nbm * 4096),
// or the first `length` when `lengths` is null. tables: `batch` rows of 512
// u32, e1 = (shift << 24) | (pdf << 12) | cdf for the 256 symbols (shift
// <= 11, as encode_table makes it), then their magic numbers. staged (2560
// u16 per block), counts (u32) and states (32 u32) hold batch * nbm rows,
// member m's block b at row m * nbm + b; staging words past a block's count
// are left unwritten.
extern "C" int dtt_encode(const void* data, long long batch, long long nbm,
                          long long length, const void* lengths,
                          int prob_bits, const void* tables, void* staged,
                          void* counts, void* states, void* stream) {
  if (batch <= 0 || nbm <= 0) return (int)cudaGetLastError();
  unsigned grid = 0;  // one wave, a block a warp at the least
  const cudaError_t e = kEncode.wave((batch * nbm + kWarps - 1) / kWarps, &grid);
  if (e != cudaSuccess) return (int)e;
  encode_kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(data), batch, nbm, length,
      static_cast<const long long*>(lengths), prob_bits,
      static_cast<const uint32_t*>(tables), static_cast<uint16_t*>(staged),
      static_cast<uint32_t*>(counts), static_cast<uint32_t*>(states));
  return (int)cudaGetLastError();
}

// The kernel's resources, into out[0..5] (launch.cuh).
extern "C" int dtt_encode_resources(int config, int* out) {
  (void)config;  // one configuration
  return kEncode.report(out);
}
