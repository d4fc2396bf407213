// K2: the mxsum256 keyed linear bitrot digest, hand-written for Hopper.
//
// Replaces the XLA device code minio_tpu/ops/mxsum.py:digest_device (with
// len_term_device and pack_words_device), which JAX fuses into the codec
// launch. It runs on every PUT byte (digests of all k+m shard chunks), on
// every GET byte (batched verify) and on every healed byte.
//
// What it computes, per row n of chunks [N, S] (zero-padded past its
// length), for c = 0..7, in uint32 arithmetic mod 2^32:
//   d[n, c] = sum_i int8(chunks[n, i]) * K[i, c]
//           + sum_{j<4} int8(byte j of lens[n], little-endian) * L[j, c]
// and writes the eight words little-endian: out [N, 32] uint8. Data bytes
// are SIGNED (bytes >= 0x80 are negative), as in the JAX version.
//
// Layout (ops/mxsum.py builds both keys host-side with the port's own
// _key_rows and caches them on the device):
//   keyt  [8, ldk] int8: K transposed (row c holds column c of K), ldk a
//         multiple of 64 and >= S; the cache grows it by doubling and the
//         kernel reads its first S columns (the stream is prefix-stable);
//   lkey  [4, 8] int8 = L[:4] (only the low 4 length bytes are nonzero);
//   lens  [N] int32; out is written as [N, 8] uint32;
//   work  a per-stream workspace of mtpu_mxsum_workspace_words(N) uint32,
//         zero when no launch runs and left zero by every launch (below).
//
// Bound on an H100: memory. N * S data bytes plus 8 * S key bytes in,
// 32 * N out, over the HBM rate (7.8 us at [192, 131072]); the 16 int8
// operations per data byte are far below the card's int8 rate.
//
// What held the first version back: a block took 4 rows, so the 1 MiB key
// was read 48 times at [192, S] (48 MiB of L2 traffic for 24 MiB of data);
// data moved as 4-byte loads; and a memset of the output ran as a second
// launch ahead of the atomics.
//
// Design:
// - The contraction runs on the tensor cores:
//   mma.sync.m16n8k32.row.col.s32.s8.s8.s32, with n = 8 the digest's 8
//   words and m = 16 rows. The k order inside an mma is free as long as A
//   and B agree, so thread (g, tig) of a warp loads 16 bytes of rows g and
//   g+8 at offset tig*16 of a 64-byte warp step and 16 bytes of key row g
//   at the same offset; the first 8 bytes feed one mma and the last 8 the
//   next. Data and key move as aligned 16-byte loads that ask L2 to fetch
//   256-byte pieces; a warp load covers 8 rows x 64 bytes.
// - A block takes kRows = 16 rows and one S segment, its 8
//   warps walking the segment in 64-byte steps, two steps' loads in
//   flight. The grid is one wave: about as many blocks as fit on the card,
//   spread over the row groups. A step's key (512 bytes a warp) serves all
//   kRows rows, so the 1 MiB key is read ceil(N / kRows) times, from L2
//   after the first; the first version read it N / 4 times.
// - Sums stay exact mod 2^32: the s32 accumulators restart at 0 every step
//   (at most 64 products of |p| <= 2^14 each, far below 2^31) and fold into
//   uint32 totals, where wrap-around is defined.
// - Warps meet in shared memory (atomicAdd on uint32), blocks in the
//   workspace (atomicAdd on uint32; addition mod 2^32 is associative and
//   commutative, so the digest is deterministic). The last block of a row
//   group (an atomicInc counter that wraps back to 0 after gridDim.x
//   arrivals) takes each sum with atomicExch(.., 0), adds the length term
//   and stores the words. The workspace is thus zero again when the
//   launch ends, and no memset of the output is needed.
// - A ragged S or an unaligned chunks pointer takes the byte path (VEC =
//   false), which gathers the same 16 bytes a byte at a time, zero past S;
//   the key is read as 16-byte loads either way (ldk >= S rounded to 16).
// What still bounds it (timed variants, PERF.md 6.3): the loads
// themselves, 8 rows x 64 bytes per warp instruction as the mma fragments
// lay them out, and the cross-block reduction at the end (fence, counter,
// exchange), about 1.7 us at [192, 131072] on an H100.

#include <cstdint>
#include <map>
#include <mutex>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;               // rows per block: one mma tile
constexpr int kSpan = 64;               // bytes of S per warp step
constexpr long long kSegQuantum = (long long)kWarps * kSpan;

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// A 16-byte read-only load that asks L2 to fetch the 256-byte piece.
__device__ __forceinline__ uint4 ldg16(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// 16 bytes of row r at offset s, zero past S or for a row past N.
template <bool VEC>
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ chunks, int r,
                                        int N, long long S, long long s) {
  if (r >= N || s >= S) return make_uint4(0, 0, 0, 0);
  const uint8_t* p = chunks + (long long)r * S + s;
  if (VEC) return ldg16(p);
  uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (s + i < S) v[i >> 2] |= (uint32_t)__ldg(p + i) << (8 * (i & 3));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
mxsum_kernel(const uint8_t* __restrict__ chunks, const int32_t* __restrict__ lens,
             const int8_t* __restrict__ keyt, long long ldk,
             const int8_t* __restrict__ lkey, uint32_t* __restrict__ out,
             uint32_t* __restrict__ work, int N, long long S, long long seg_len) {
  __shared__ uint32_t part[kRows * 8];
  __shared__ bool last;
  for (int i = threadIdx.x; i < kRows * 8; i += kThreads) part[i] = 0;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.y * kRows;
  const long long seg0 = (long long)blockIdx.x * seg_len;
  const long long seg1 = seg0 + seg_len < S ? seg0 + seg_len : S;

  uint32_t tot[4] = {0, 0, 0, 0};

#pragma unroll 2
  for (long long sp = seg0 + warp * kSpan; sp < seg1; sp += kSegQuantum) {
    const long long s = sp + tig * 16;
    // ldk >= S rounded up to 16 and s % 16 == 0: in bounds whenever s < S.
    const uint4 kv = s < S ? ldg16(keyt + g * ldk + s) : make_uint4(0, 0, 0, 0);
    const uint4 lo = load16<VEC>(chunks, row0 + g, N, S, s);
    const uint4 hi = load16<VEC>(chunks, row0 + g + 8, N, S, s);
    int c[4] = {0, 0, 0, 0};
    mma_s8(c, lo.x, hi.x, lo.y, hi.y, kv.x, kv.y);
    mma_s8(c, lo.z, hi.z, lo.w, hi.w, kv.z, kv.w);
#pragma unroll
    for (int i = 0; i < 4; ++i) tot[i] += (uint32_t)c[i];
  }

  __syncthreads();  // part is zero
  // Accumulator i: row g + 8*(i >> 1) of the block, word 2*tig + (i & 1).
#pragma unroll
  for (int i = 0; i < 4; ++i)
    atomicAdd(&part[(g + 8 * (i >> 1)) * 8 + 2 * tig + (i & 1)], tot[i]);
  __syncthreads();

  // work: [gridDim.y][kRows * 8] sums, then gridDim.y counters.
  uint32_t* wk = work + (long long)blockIdx.y * kRows * 8;
  unsigned int* counter = work + (long long)gridDim.y * kRows * 8 + blockIdx.y;
  for (int i = threadIdx.x; i < kRows * 8; i += kThreads)
    if (row0 + i / 8 < N) atomicAdd(&wk[i], part[i]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicInc(counter, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < kRows * 8; i += kThreads) {
    const int r = row0 + i / 8, c = i % 8;
    if (r >= N) continue;
    uint32_t sum = atomicExch(&wk[i], 0u);
    const uint32_t len = (uint32_t)lens[r];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      sum += (uint32_t)((int)(int8_t)(len >> (8 * j)) * (int)lkey[j * 8 + c]);
    out[(long long)r * 8 + c] = sum;
  }
}

// The blocks of mxsum_kernel<VEC> that fit on the current device at once
// (its SMs times the blocks per SM). The runtime is asked on the first
// launch on each device and the answer kept, so later launches make no
// queries.
template <bool VEC>
cudaError_t resident_blocks(long long* blocks) {
  static std::mutex mu;
  static std::map<int, long long> known;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> hold(mu);
  auto it = known.find(dev);
  if (it == known.end()) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mxsum_kernel<VEC>,
                                                        kThreads, 0);
    if (err != cudaSuccess) return err;
    it = known.emplace(dev, (long long)sms * (per_sm > 0 ? per_sm : 1)).first;
  }
  *blocks = it->second;
  return cudaSuccess;
}

}  // namespace

// uint32 words of the workspace for N rows: ops/mxsum.py allocates it.
extern "C" long long mtpu_mxsum_workspace_words(int N) {
  const long long groups = (N + kRows - 1) / kRows;
  return groups * (kRows * 8 + 1);
}

// Returns the CUDA error of the launch (0 on success). The wrapper
// (ops/mxsum.py) checks shapes: ceil(N / 16) <= 65535, ldk >= S rounded up
// to 16 and a multiple of 16, keyt 16-byte aligned, work zero and holding
// mtpu_mxsum_workspace_words(N) uint32, out N * 32 bytes.
extern "C" int mtpu_mxsum_digest(const uint8_t* chunks, const int32_t* lens,
                                 const int8_t* keyt, long long ldk,
                                 const int8_t* lkey, uint8_t* out, uint32_t* work,
                                 int N, long long S, void* stream) {
  if (N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = (S % 16 == 0) && ((uintptr_t)chunks % 16 == 0);
  auto* fn = vec ? mxsum_kernel<true> : mxsum_kernel<false>;
  const int groups = (N + kRows - 1) / kRows;
  long long blocks = 0;
  const cudaError_t err = vec ? resident_blocks<true>(&blocks)
                              : resident_blocks<false>(&blocks);
  if (err != cudaSuccess) return (int)err;
  // One wave: about `blocks` blocks over the row groups, each segment a
  // whole number of 512-byte warp steps.
  long long segs = (blocks + groups - 1) / groups;
  long long seg_len = (S + segs - 1) / segs;
  seg_len = (seg_len + kSegQuantum - 1) / kSegQuantum * kSegQuantum;
  if (seg_len < kSegQuantum) seg_len = kSegQuantum;
  segs = (S + seg_len - 1) / seg_len;
  if (segs < 1) segs = 1;  // S == 0: one block per group adds the length term
  const dim3 grid((unsigned)segs, (unsigned)groups);
  fn<<<grid, kThreads, 0, st>>>(chunks, lens, keyt, ldk, lkey,
                                reinterpret_cast<uint32_t*>(out), work, N, S, seg_len);
  return (int)cudaGetLastError();
}
