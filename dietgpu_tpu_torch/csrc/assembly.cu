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
//
// Sections: the archive sections that the assembly fills around, for every
// member of a batch at once: the 8 header words (the payload's total u16
// words at word 3, the checksum at word 5), the 128 words of packed u16
// probabilities, the blocks' final states, and the blockWords pairs
// ((uncompressed bytes << 16) | words, the block's payload offset), with
// the exclusive prefix of the 8-rounded word counts that the assembly
// kernel takes and each archive's byte size.
//
// Replaces: no Pallas kernel. The JAX package writes the sections as XLA
// ops (dietgpu_tpu/ans/pallas_encode.py:_encode_stage2's prefill); the port
// ran them as ~60 torch ops (ans/encode.py:write_sections_batched), which
// stays the CPU route and the kernel's plain version, and whose words this
// kernel writes one for one, the words past a short member's sections
// included.
//
// Bound on the H100: bytes, mostly the states (128 bytes a block read and
// written; path A's member has 32,768 blocks, 4 MiB).
//
// Design: a 1-D grid over tiles of 256 blocks of each member, a thread a
// block, so one member's states spread over the card (path A: 128 CTAs).
// A tile's prefix is the sum of the 8-rounded counts before it, read by
// the tile itself with 16-byte loads, 8 in flight a thread (at most the
// member's counts, 128 KiB at path A, from L2), then a block scan within
// the tile: no scratch, no order between CTAs, one launch. The last tile
// of path A's member, which reads the most, sets the kernel's time
// (~10 us; a bound of 2.7 us). Each word of the region a member's
// sections cover has one writer: the tile of its block writes the block's
// states and its two words of the zero tail, except the words the
// blockWords take (a short member's blockWords lie over the states of its
// blocks past its length), and the member's last tile, which alone knows
// the total and sees every count, writes the header, the probabilities and
// the size.

#include <cstdint>
#include <cuda_runtime.h>

#include "byte_hist.cuh"
#include "launch.cuh"

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

constexpr int kSecThreads = 256;
constexpr int kSecWarps = kSecThreads / 32;
constexpr int kTile = kSecThreads;  // blocks a sections CTA, one a thread
constexpr int kLoads = 8;  // 16-byte loads in flight a thread, reading the counts
constexpr int kBlockBytes = 4096;
constexpr int kHeadWords = 8;
constexpr int kProbWords = 128;
constexpr long long kSizeOverflowBit = 1ll << 31;

__device__ __forceinline__ long long padded_words(uint32_t w) {
  return ((long long)w + 7) & ~7ll;
}

__global__ void __launch_bounds__(kSecThreads)
sections_kernel(const uint32_t* __restrict__ counts, const uint4* __restrict__ states,
                const uint32_t* __restrict__ pdfs, const long long* __restrict__ geo,
                const uint32_t* __restrict__ checksums, long long batch, long long nbm,
                long long ntiles, uint32_t* __restrict__ arcs, long long stride32,
                int* __restrict__ prefix, long long* __restrict__ sizes) {
  __shared__ long long s_warp[kSecWarps];
  const int t = threadIdx.x;
  const long long m = blockIdx.x / ntiles;
  const long long tile = blockIdx.x % ntiles;
  const bool last = tile == ntiles - 1;
  const long long b0 = tile * kTile;
  const long long b1 = b0 + kTile < nbm ? b0 + kTile : nbm;

  // the 8-rounded counts of the member's blocks before the tile, and
  // whether one of them overflowed
  long long before = 0;
  int over = 0;
  {
    const long long g0 = m * nbm, g1 = g0 + b0;  // indices into counts
    const long long a = (g0 + 3) & ~3ll;
    const long long e = g1 & ~3ll;
    if (a >= e) {
      for (long long i = g0 + t; i < g1; i += kSecThreads) {
        before += padded_words(counts[i]);
        over |= counts[i] > (uint32_t)kMaxWords;
      }
    } else {
      if (t < a - g0) {
        before += padded_words(counts[g0 + t]);
        over |= counts[g0 + t] > (uint32_t)kMaxWords;
      }
      if (t < g1 - e) {
        before += padded_words(counts[e + t]);
        over |= counts[e + t] > (uint32_t)kMaxWords;
      }
      const uint4* v = reinterpret_cast<const uint4*>(counts + a);
      const long long nv = (e - a) / 4;
      // kLoads loads in flight a thread: the last tile of path A's member
      // reads 8,128 of them
      for (long long i0 = t; i0 < nv; i0 += kLoads * kSecThreads) {
        uint4 c[kLoads];
#pragma unroll
        for (int k = 0; k < kLoads; ++k) {
          const long long i = i0 + (long long)k * kSecThreads;
          c[k] = i < nv ? v[i] : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int k = 0; k < kLoads; ++k) {
          before += padded_words(c[k].x) + padded_words(c[k].y) + padded_words(c[k].z) +
                    padded_words(c[k].w);
          const uint32_t hi = max(max(c[k].x, c[k].y), max(c[k].z, c[k].w));
          over |= hi > (uint32_t)kMaxWords;
        }
      }
    }
  }
  for (int d = 16; d > 0; d >>= 1) before += __shfl_xor_sync(0xffffffffu, before, d);
  if (t % 32 == 0) s_warp[t / 32] = before;
  __syncthreads();
  before = 0;
#pragma unroll
  for (int w = 0; w < kSecWarps; ++w) before += s_warp[w];
  __syncthreads();  // every thread has read s_warp

  // the thread's block: its payload offset and its blockWords pair
  const long long j = b0 + t;
  const uint32_t w = j < b1 ? counts[m * nbm + j] : 0u;
  over = __syncthreads_or(over | (w > (uint32_t)kMaxWords));
  long long tile_sum;
  const long long pre_j =
      before + dtt::block_scan<kSecThreads>(padded_words(w), s_warp, &tile_sum) -
      padded_words(w);
  const long long* gm = geo + m;  // the member's column of the (12, batch) geometry
  const long long len = gm[2 * batch];
  const long long bw32 = gm[9 * batch];
  const long long base = gm[11 * batch];
  const long long st32 = base + kHeadWords + kProbWords;
  uint32_t* row = arcs + m * stride32;
  if (j < b1) {
    prefix[m * nbm + j] = (int)pre_j;
    long long unc = len - j * kBlockBytes;
    unc = unc < 0 ? 0 : (unc > kBlockBytes ? kBlockBytes : unc);
    row[bw32 + 2 * j] = (uint32_t)((unc << 16) | w);
    row[bw32 + 2 * j + 1] = unc > 0 ? (uint32_t)pre_j : 0u;
  }

  // the tile's states and zero tail, but for the words the blockWords take
  const long long bw_end = bw32 + 2 * nbm;
  const long long s0 = st32 + 32 * b0;  // a multiple of 4
  uint4* out = reinterpret_cast<uint4*>(row + s0);
  const uint4* src = states + (m * nbm + b0) * 8;
  const long long nvec = (b1 - b0) * 8;
  for (long long i = t; i < nvec; i += kSecThreads) {
    const long long p = s0 + 4 * i;
    const uint4 v = src[i];
    if (p + 4 <= bw32 || p >= bw_end) {
      out[i] = v;
    } else {
      const uint32_t h[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (p + q < bw32 || p + q >= bw_end) row[p + q] = h[q];
      }
    }
  }
  // two tail words a block, and the pair that rounds an odd nbm up
  const long long z0 = st32 + 32 * nbm + 2 * b0;
  const long long nz = 2 * (b1 - b0) + (last ? 2 * (nbm & 1) : 0);
  for (long long i = t; i < nz; i += kSecThreads) {
    const long long p = z0 + i;
    if (p < bw32 || p >= bw_end) row[p] = 0u;
  }

  // the member's header, probabilities and size
  if (last) {
    const long long total = before + tile_sum;
    if (t < kHeadWords) {
      long long v = gm[t * batch];
      if (t == 3) v = total;
      if (t == 5 && checksums != nullptr) v = checksums[m];
      row[base + t] = (uint32_t)v;
    }
    if (t < kProbWords) {
      const uint32_t* p = pdfs + m * 256 + 2 * t;
      row[base + kHeadWords + t] = p[0] | (p[1] << 16);
    }
    if (t == 0) sizes[m] = (gm[10 * batch] + 2 * total) | (over ? kSizeOverflowBit : 0);
  }
}

// reported only: its grid is a CTA a tile of a member's blocks on any card
dtt::Kernel kSections(sections_kernel, kSecThreads, 0, false);

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

// The sections of `batch` archives, archive m at u32 offset geo[11][m] of
// row m of arcs (stride32 u32 a row, 16-byte aligned, stride32 % 4 == 0).
// counts (u32 words) and states (32 u32, 16-byte aligned) hold batch * nbm
// rows, member m's block b at row m * nbm + b; pdfs is `batch` rows of 256
// u32 weights; geo is the (12, batch) int64 geometry of
// ans/encode.py:section_geometry (header words, lengths, blockWords and
// pre-payload offsets, archive offsets, each a multiple of 4 u32);
// checksums (u32) is null for archives without one. Writes prefix
// (batch * nbm int32) and sizes (batch int64 bytes, bit 31 set where a
// block overflowed).
extern "C" int dtt_sections(const void* counts, const void* states, const void* pdfs,
                            const void* geo, const void* checksums, long long batch,
                            long long nbm, void* arcs, long long stride32, void* prefix,
                            void* sizes, void* stream) {
  if (nbm > 0 && batch > 0) {
    const long long ntiles = (nbm + kTile - 1) / kTile;
    sections_kernel<<<(unsigned)(batch * ntiles), kSecThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const uint32_t*>(counts), static_cast<const uint4*>(states),
        static_cast<const uint32_t*>(pdfs), static_cast<const long long*>(geo),
        static_cast<const uint32_t*>(checksums), batch, nbm, ntiles,
        static_cast<uint32_t*>(arcs), stride32, static_cast<int*>(prefix),
        static_cast<long long*>(sizes));
  }
  return (int)cudaGetLastError();
}

// The sections kernel's resources, into out[0..5] (launch.cuh).
extern "C" int dtt_sections_resources(int config, int* out) {
  (void)config;  // one configuration
  return kSections.report(out);
}
