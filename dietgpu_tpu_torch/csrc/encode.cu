// rANS encode of 4 KiB blocks, 32 interleaved states, with per-block
// stream compaction into a staging row, for a batch of members, each with its
// own table (a single input is a batch of one).
//
// Replaces: dietgpu_tpu/ans/pallas_encode.py:_encode_kernel (via
// _encode_stage1, and with per_row_tables=True via
// ans_encode_batched_pallas), the reference's ansEncodeBatchFull /
// encodeOneWarp (GpuANSEncode.cuh:49-211).
//
// Bound on the H100: operations, not bytes. A block moves 4 KiB in and at
// most 5 KiB out, but each of its 4096 symbols is a dependent chain of
// table lookup, 32-bit multiply-high, shifts and a warp vote, 128 steps
// deep per warp. The least time counted for it is its bytes over 3.35 TB/s;
// the chain is what the kernel actually waits on.
//
// Design: one warp per block, lane l holding state l, step s encoding
// symbol 32*s + l going forward, as in the reference. The block's 4096
// symbol bytes are staged to shared memory with 16-byte loads first, so
// each step reads its 32 bytes from shared memory instead of issuing a
// byte load to device memory. The 256-entry encode table (pdf | cdf |
// shift, plus the division magic) also sits in shared memory. Division
// by pdf is __umulhi(state, magic) then (t + state) >> shift. A lane whose
// state reaches pdf << (31 - prob_bits) emits its low 16 bits; the emitted
// words are compacted with __ballot_sync/__popc in (step, lane) order into
// the block's staging row of 2560 u16. A block whose payload would pass
// 2560 words stops writing (the count keeps growing, so the caller sees
// the overflow and sets SIZE_OVERFLOW_BIT, as encode.py does).
//
// Batched: the grid is (ceil(NBm / 4), B), so a CTA never spans members and
// loads only its own member's table; member m's blocks are rows m * NBm + b
// of the staging, count and state outputs, and its length comes from a
// device array, or is one scalar for every member (a single input, a float
// batch of one static length).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockBytes = 4096;
constexpr int kLanes = 32;
constexpr int kMaxWords = 2560;
constexpr int kWarpsPerCta = 4;
constexpr int kTableWords = 512;
constexpr uint32_t kStartState = 1u << 15;

// The CTA's 256-entry table into shared memory: e1 then magic.
__device__ __forceinline__ void load_table(const uint32_t* __restrict__ table,
                                           uint32_t* e1s, uint32_t* magics) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    e1s[i] = table[i];
    magics[i] = table[256 + i];
  }
  __syncthreads();
}

// One warp encodes one block: `src` is its 4096 symbol bytes (16-byte
// aligned), `rem` the input's symbols from the block's first one on (only
// the first min(rem, 4096) are encoded), `sy` the warp's shared staging.
__device__ __forceinline__ void encode_block(
    const uint8_t* __restrict__ src, long long rem, int prob_bits,
    const uint32_t* e1s, const uint32_t* magics, uint8_t* sy,
    uint16_t* __restrict__ out, uint32_t* __restrict__ count_out,
    uint32_t* __restrict__ state_out, int lane) {
  // Pin the output row's address in a register: otherwise nvcc recomputes
  // the 64-bit row offset (member * nbm + block) at every store of the loop
  // below, which made the loop 7% slower than with a one-member offset.
  asm volatile("" : "+l"(out));
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  uint4* d4 = reinterpret_cast<uint4*>(sy);
  for (int i = lane; i < kBlockBytes / 16; i += kLanes) d4[i] = s4[i];
  __syncwarp();

  const int nvalid = rem <= 0 ? 0 : (rem >= kBlockBytes ? kBlockBytes : (int)rem);
  const int steps = (nvalid + kLanes - 1) / kLanes;
  const uint32_t check_shift = 31u - (uint32_t)prob_bits;
  const uint32_t lanes_below = (1u << lane) - 1u;

  uint32_t state = kStartState;
  uint32_t count = 0;
  for (int s = 0; s < steps; ++s) {
    const int i = s * kLanes + lane;
    const bool v = i < nvalid;
    const uint32_t sym = sy[i];
    const uint32_t e1 = e1s[sym];
    const uint32_t cdf = e1 & 0xfffu;
    const uint32_t pdf = (e1 >> 12) & 0xfffu;
    const uint32_t shift = e1 >> 24;

    const bool write = v && state >= (pdf << check_shift);
    const unsigned ballot = __ballot_sync(0xffffffffu, write);
    if (write) {
      const uint32_t pos = count + __popc(ballot & lanes_below);
      if (pos < kMaxWords) out[pos] = (uint16_t)(state & 0xffffu);
      state >>= 16;
    }
    count += __popc(ballot);

    if (v) {
      const uint32_t t = __umulhi(state, magics[sym]);
      const uint32_t div = (t + state) >> shift;
      const uint32_t mod = state - div * pdf;
      state = (div << prob_bits) + mod + cdf;
    }
  }
  state_out[lane] = state;
  if (lane == 0) *count_out = count;
}

__global__ void __launch_bounds__(kWarpsPerCta * 32)
encode_kernel(const uint8_t* __restrict__ data, long long nbm,
              long long length, const long long* __restrict__ lengths,
              int prob_bits, const uint32_t* __restrict__ tables,
              uint16_t* __restrict__ staged, uint32_t* __restrict__ counts,
              uint32_t* __restrict__ states) {
  __shared__ uint32_t e1s[256];
  __shared__ uint32_t magics[256];
  __shared__ __align__(16) uint8_t syms[kWarpsPerCta][kBlockBytes];
  const long long m = blockIdx.y;
  load_table(tables + m * kTableWords, e1s, magics);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long b = (long long)blockIdx.x * kWarpsPerCta + warp;
  if (b >= nbm) return;
  const long long row = m * nbm + b;
  const long long n = lengths == nullptr ? length : lengths[m];
  encode_block(data + row * kBlockBytes, n - b * kBlockBytes, prob_bits, e1s,
               magics, syms[warp], staged + row * kMaxWords, counts + row,
               states + row * kLanes, lane);
}

}  // namespace

// data: `batch` rows of nbm * 4096 symbol bytes (16-byte aligned); member
// m encodes the first lengths[m] bytes of its row (int64), or the first
// `length` when `lengths` is null. tables: `batch` rows of 512 u32, e1 =
// (shift << 24) | (pdf << 12) | cdf for the 256 symbols, then their magic
// numbers. staged (2560 u16 per block), counts (u32) and states (32 u32)
// hold batch * nbm rows, member m's block b at row m * nbm + b.
extern "C" int dtt_encode(const void* data, long long batch, long long nbm,
                          long long length, const void* lengths,
                          int prob_bits, const void* tables, void* staged,
                          void* counts, void* states, void* stream) {
  const long long gx = (nbm + kWarpsPerCta - 1) / kWarpsPerCta;
  if (gx > 0 && batch > 0) {
    encode_kernel<<<dim3((unsigned)gx, (unsigned)batch), kWarpsPerCta * 32, 0,
                    (cudaStream_t)stream>>>(
        static_cast<const uint8_t*>(data), nbm, length,
        static_cast<const long long*>(lengths), prob_bits,
        static_cast<const uint32_t*>(tables), static_cast<uint16_t*>(staged),
        static_cast<uint32_t*>(counts), static_cast<uint32_t*>(states));
  }
  return (int)cudaGetLastError();
}
