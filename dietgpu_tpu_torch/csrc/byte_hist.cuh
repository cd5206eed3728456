// The exact byte histogram of hist.cu, split.cu and split_f32.cu, and the
// division of a batch's work over one grid that they use.
//
// Histogram: each CTA keeps 32 copies of the 256 bins in shared memory, bin
// b of copy c at word 32 b + c, and lane l of every warp counts into copy l.
// The 32 lanes of one atomic add then always hit 32 different banks,
// whatever the bytes (a run of one value included), so every shared atomic
// is one conflict-free wavefront and its result is never waited for. The
// copies are 32-bit, so no counter needs flushing before a member ends.
// When a CTA leaves a member it folds the copies into the member's global
// row, one atomic add per nonzero bin, and resets them.
//
// Division of work: the items of B members (16-byte groups of bytes or of
// words, or tiles of them) form one index space, and CTA i takes the i-th
// contiguous share of it. A CTA finds the members its share touches by a
// block-wide prefix of the members' item counts, kThreads members a round.
// A ragged batch costs what its items cost; the longest member no longer
// sets the time, and the grid has no member dimension.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace dtt {

constexpr int kCopies = 32;  // lane-owned copies of the 256 bins
constexpr int kHistWords = 256 * kCopies;

__device__ __forceinline__ uint32_t fold8(uint32_t x) {
  x ^= x >> 16;
  x ^= x >> 8;
  return x & 0xffu;
}

// Inclusive prefix of v over the CTA; *total gets the CTA's sum. Every
// thread must call it; s_warp is reused only after a later __syncthreads.
template <int kThreads>
__device__ __forceinline__ long long block_scan(long long v, long long* s_warp,
                                                long long* total) {
  constexpr int kWarps = kThreads / 32;
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

// The 4 bytes of one word into copy `my` (the lane's).
__device__ __forceinline__ void count4(unsigned* my, uint32_t w) {
  atomicAdd(my + ((w << 5) & 0x1fe0u), 1u);
  atomicAdd(my + ((w >> 3) & 0x1fe0u), 1u);
  atomicAdd(my + ((w >> 11) & 0x1fe0u), 1u);
  atomicAdd(my + ((w >> 19) & 0x1fe0u), 1u);
}

// The first r bytes of one word (none when r <= 0, all 4 when r >= 4).
__device__ __forceinline__ void count_first(unsigned* my, uint32_t w, long long r) {
  for (int i = 0; i < 4 && i < r; ++i) {
    atomicAdd(my + (((w >> (8 * i)) & 0xffu) << 5), 1u);
  }
}

// Zero the copies; the caller synchronises before counting.
template <int kThreads>
__device__ __forceinline__ void clear_copies(unsigned* sh) {
  for (int i = threadIdx.x; i < kHistWords; i += kThreads) sh[i] = 0;
}

// After a __syncthreads: fold the copies into a member's 256 global bins
// and reset them (copies read in a rotated order, so a warp's 32 bins hit
// 32 banks); merge the lanes' checksums x into *cks with one atomicXor a
// warp (the 8-bit fold is linear over XOR), unless cks is null.
template <int kThreads>
__device__ __forceinline__ void fold_member(unsigned* sh, unsigned* __restrict__ hist,
                                            uint32_t x, unsigned* __restrict__ cks) {
  for (int bin = threadIdx.x; bin < 256; bin += kThreads) {
    unsigned s = 0;
#pragma unroll 8
    for (int c = 0; c < kCopies; ++c) {
      const int i = bin * kCopies + ((c + bin) & (kCopies - 1));
      s += sh[i];
      sh[i] = 0;
    }
    if (s) atomicAdd(&hist[bin], s);
  }
  if (cks != nullptr) {
    for (int d = 16; d > 0; d >>= 1) x ^= __shfl_xor_sync(0xffffffffu, x, d);
    const uint32_t f = fold8(x);
    if (threadIdx.x % 32 == 0 && f) atomicXor(cks, f);
  }
}

// CTA blockIdx.x's share [q0, q1) of `total` items, or q0 == q1.
__device__ __forceinline__ void cta_share(long long total, long long* q0, long long* q1) {
  const long long chunk = (total + gridDim.x - 1) / gridDim.x;
  *q0 = (long long)blockIdx.x * chunk;
  *q1 = *q0 + chunk < total ? *q0 + chunk : total;
  if (*q0 > *q1) *q0 = *q1;
}

// Calls body(m, a, b) for each member m whose items [a, b) (member-local)
// meet [q0, q1), in member order; count(m) is member m's item count. Every
// thread of the CTA must call it with the same arguments; body may
// synchronise the CTA. s_start holds kThreads and s_warp kThreads / 32
// values.
template <int kThreads, class Count, class Body>
__device__ __forceinline__ void for_each_member(long long batch, long long q0, long long q1,
                                                Count count, long long* s_start,
                                                long long* s_warp, Body body) {
  if (q0 >= q1) return;
  long long carry = 0;  // items of the members before this round
  for (long long r0 = 0; r0 < batch && carry < q1; r0 += kThreads) {
    const long long m = r0 + threadIdx.x;
    const long long n = m < batch ? count(m) : 0;
    long long total;
    const long long incl = block_scan<kThreads>(n, s_warp, &total);
    s_start[threadIdx.x] = carry + incl - n;
    __syncthreads();
    const int nm = batch - r0 < kThreads ? (int)(batch - r0) : kThreads;
    for (int j = 0; j < nm; ++j) {
      const long long st = s_start[j];
      if (st >= q1) break;
      const long long en = j + 1 < nm ? s_start[j + 1] : carry + total;
      const long long lo = st > q0 ? st : q0;
      const long long hi = en < q1 ? en : q1;
      if (lo < hi) body(r0 + j, lo - st, hi - st);
    }
    carry += total;
    __syncthreads();  // s_start and s_warp are rewritten next round
  }
}

}  // namespace dtt
