// Payload assembly: copies each block's staged u16 words to its 16-byte
// aligned exclusive-prefix offset in the (section-prefilled) archive, for
// every member of a batch at once (a single archive is a batch of one).
//
// Replaces: dietgpu_tpu/ans/pallas_encode.py:_assembly_kernel (via
// _encode_finish, and with per_tile_seed=True via ans_encode_batched_pallas),
// the reference's ansEncodeCoalesceBatch (GpuANSEncode.cuh:630-672).
//
// Bound on the H100: bytes. Each payload byte is read once from staging
// and written once into the archive.
//
// Design: one CTA per block, 16-byte loads and stores. Every block's
// payload starts 16-byte aligned (the prefix is in multiples of 8 u16 and
// the payload section itself starts 16-byte aligned), so whole uint4 moves
// need no shifting. The 0-7 padding u16 after a block's payload are written
// as zeros, which is what the staging row does not guarantee. Copies are
// clamped to the staging row (2560 u16) and to the archive's end, so an
// overflowing block (whose archive is flagged invalid) writes nothing out
// of bounds.
//
// Batched: one 1-D grid of NBm x B CTAs, CTA x copying row x (member
// x / NBm's block x % NBm), so any B launches. Member m's archive is row m
// of a buffer with a stride of `stride32` u32 (16-byte aligned), its
// payload starts at u32 ds32[m] of the row (or at one offset for every
// member), its prefix is row m of a (B, NBm) array, and its copies are
// clamped to the row's end, so a member never writes into the next one.
// The vmapped single assembly of the TPU path and its one-grid
// per_tile_seed variant write the same bytes; this one launch does both's
// work. For a float batch the rows are the members' containers.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWords = 2560;
constexpr int kRowVec = kMaxWords / 8;  // uint4 per staging row
constexpr int kThreads = 128;

// Copy one block's staged row (w words) to uint4 slot `off` of `out`,
// writing only slots below cap_vec.
__device__ __forceinline__ void copy_block(const uint4* __restrict__ row,
                                           uint32_t w, long long off,
                                           uint4* __restrict__ out,
                                           long long cap_vec) {
  uint32_t padded = (w + 7u) & ~7u;
  if (padded > (uint32_t)kMaxWords) padded = kMaxWords;
  const int nvec = (int)(padded / 8);
  for (int j = threadIdx.x; j < nvec; j += kThreads) {
    uint4 v = row[j];
    const uint32_t first = 8u * (uint32_t)j;
    if (first + 8u > w) {
      uint32_t h[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (first + 2u * q >= w) h[q] &= 0xffff0000u;
        if (first + 2u * q + 1u >= w) h[q] &= 0x0000ffffu;
      }
      v = make_uint4(h[0], h[1], h[2], h[3]);
    }
    if (off + j < cap_vec) out[off + j] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
assembly_kernel(const uint4* __restrict__ staged,
                const uint32_t* __restrict__ counts,
                const int* __restrict__ prefix, long long nbm,
                uint32_t* __restrict__ arcs, long long stride32, long long ds,
                const long long* __restrict__ ds32) {
  const long long row = blockIdx.x;
  const long long m = row / nbm;
  const long long d = ds32 == nullptr ? ds : ds32[m];
  uint4* out = reinterpret_cast<uint4*>(arcs + m * stride32 + d);
  copy_block(staged + row * kRowVec, counts[row], (long long)prefix[row] / 8,
             out, (stride32 - d) / 4);
}

}  // namespace

// staged (2560 u16 per block, 16-byte aligned), counts (u32 words per
// block) and prefix (int32 exclusive prefix of the 8-rounded counts, u16
// units) hold batch * nbm rows, member m's block b at row m * nbm + b. arcs
// is `batch` rows of stride32 u32 (16-byte aligned, stride32 % 4 == 0);
// member m's payload starts at u32 ds32[m] of its row (int64, a multiple of
// 4), or at u32 `ds` of every row when ds32 is null.
extern "C" int dtt_assemble(const void* staged, const void* counts,
                            const void* prefix, long long batch, long long nbm,
                            void* arcs, long long stride32, long long ds,
                            const void* ds32, void* stream) {
  if (nbm > 0 && batch > 0) {
    assembly_kernel<<<(unsigned)(nbm * batch), kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const uint4*>(staged), static_cast<const uint32_t*>(counts),
        static_cast<const int*>(prefix), nbm, static_cast<uint32_t*>(arcs),
        stride32, ds, static_cast<const long long*>(ds32));
  }
  return (int)cudaGetLastError();
}
