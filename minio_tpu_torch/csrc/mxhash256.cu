// K3: the mxhash256 keyed GF(2) Merkle-Damgard bitrot hash, hand-written
// for Hopper.
//
// Replaces minio_tpu/ops/mxhash.py:104 mxhash256 (a jax.lax.scan of one
// int8 matmul per 512-byte block, which XLA runs on the TPU's MXU); also
// serves its encode_with_bitrot (:133), where it follows K1.
//
// What it computes, per row r of chunks [N, S] with length len = lens[r]
// (0 <= len <= S):
//   the message is the row's len bytes, then 0x80, then zeros, then the bit
//   length len*8 as 8 little-endian bytes ending a 512-byte block:
//   nb = ceil((len + 9) / 512) blocks. With state_0 = 0 (256 bits),
//     state_{i+1} = ([state_i bits | block_i bits] @ K) mod 2
//   where K = [SK; DK] is the [4352, 256] GF(2) key matrix (ops/mxhash.py
//   _key_matrix), bits LSB-first within each byte and state first in x.
//   out[r] = state_nb packed LSB-first into 32 bytes.
//
// Bound on an H100: operations. The data term, 2 * 4096 * 256 per block,
// counted as int8 tensor-core operations (chip_smoke.py _mxhash_bound_ms;
// folding the state in adds 2 * 256 * 256 a folded term, which a term of
// more blocks makes as small as wanted): [192, 131072] with 7 short rows
// is 0.0504 ms at 1979 TOP/s; its bytes take 0.0073 ms.
//
// What held the first design (one block of 256 threads per row, one
// dependent step per 512-byte block) back:
// 1. a row's whole chain ran in one block, so the parallelism was the row
//    count: at 16-128 rows most of the 132 SMs sat idle, and 186 registers
//    allowed one block per SM;
// 2. each of a row's 257 steps was a dependent round trip (stage a block
//    from HBM, two barriers, 68 AND/XOR and a popcount a thread), about
//    0.87 us a step at every row count: latency, not throughput;
// 3. the data term, 94% of the operations, ran as 64-bit bitwise work and
//    never reached the tensor cores.
//
// The chain is linear over GF(2): state_{i+1} = state_i SK ^ D_i with
// D_i = (block_i @ DK) mod 2, so with j = nb - 1 - i a block's place from
// the row's end,  state_nb = XOR_i (block_i @ DK SK^j) mod 2.
// Write j = 4 g + v (v < 4): the blocks of group g (the 4 blocks ending
// 4 g blocks before the row's end; the first group of a row may be short)
// give the term T_g = (group bits @ [DK SK^3; DK SK^2; DK SK; DK]) mod 2,
// one product of 2 KiB of bits with a 16384 x 256 key, and
// state_nb = XOR_g T_g SK^(4 g).
// Design: two kernels a call (one launch counted by the wrapper).
// - Stage 1, every group term of every row at once, on the int8 tensor
//   cores (against 3.; against 1.: the parallelism is the group count).
//   The 2 KiB of a group are cut in 32 slices of 64 bytes. The grid is 128
//   blocks, one per SM; block b owns slice b % 32 for the whole launch and
//   keeps that slice of the stacked key in shared memory, 128 KiB of 0/1
//   int8 (ops/mxhash.py tile_key), loaded once, and takes every fourth
//   64-group tile of the M = N * ceil(ceil((S + 9) / 512) / 4) groups (a
//   row's groups from its end; tiles past a row's groups are skipped). Its
//   two warpgroups take alternate tiles of its share. A warpgroup loads
//   its tile's 64 x 64 bytes into registers while the previous tile's
//   products run (16-byte loads; two aligned loads and a funnel shift where
//   a row is not 16-byte aligned; byte by byte where a piece holds the
//   row's end, terminator or bit length; zeros for a block before the
//   row's start), stores them to shared memory, expands them there to 0/1
//   bytes (k = 4 b + e of a 32-bit k-step is bit b of byte e:
//   (word >> b) & 0x01010101), then issues 16 wgmma.m64n256k32.s32.s8.s8
//   with both operands in shared memory, K-major with the 128-byte swizzle;
//   int32 sums of at most 512; one warpgroup's loads, expansion and
//   epilogue run beside the other's products. The parities of the 32
//   slices' partial sums are packed to 32 bytes a group and XORed in
//   stage 2 (the parity of a sum is the XOR of the parities of its parts):
//   scratch [32, M, 32] bytes from the wrapper.
// - Stage 2, the chain as a log-depth combine (against 2.): one block per
//   row, thread c owning output bit c. A row's terms T_g (65 for a
//   257-block row) are folded in windows of 256: level l pairs
//   E_(2j) ^ E_(2j+1) SK^(4 * 2^l), thread c taking the parity of x & column
//   c of the power and a warp ballot packing 32 bits of each product;
//   windows combine from the oldest by Horner with SK^1024. A 257-block row
//   waits on 7 levels, not 257 steps; any length works.
// The group size trades the two stages (timed on an H100 at 1, 2, 4, 8 and
// 16 blocks, PERF.md 6.11): a larger group shortens the combine but slows
// stage 1, whose time per tile grows as fewer blocks share a key slice.
// What still bounds it (PERF.md 6.11; chip_smoke.py's per-kernel device
// times): stage 1, about 104 of 130 us at [192, 131072], where it runs
// alone at 48% of the bound (8.7 ns a group); the combine, 11-18 us, one
// block a row; and at [256, 87382] the unaligned rows' loads (a group
// cost 6% and 16% more there than at 8+4 in two runs). Deeper staging, four
// warpgroups of half the width and the swizzle did not shorten stage 1;
// what sets the rest of a tile's time is not resolved.

#include <cstdint>
#include <map>
#include <mutex>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockBytes = 512;
constexpr int kGroupBlocks = 4;                      // blocks folded by the key
constexpr int kSliceBytes = 64;                      // of a group, per slice
constexpr int kSlices = kGroupBlocks * kBlockBytes / kSliceBytes;   // 32
constexpr int kBlocks = 128;                         // of the grid: 4 a slice
constexpr int kSteps = kSliceBytes / 4;              // 16 k-steps of 32 bits
constexpr int kTile = 64;                            // groups (M) a warpgroup tile
constexpr int kThreads = 256;                        // 2 warpgroups
constexpr int kGroupThreads = 128;
constexpr int kKeyBlock = 256 * 128;                 // B of 4 k-steps: 32 KiB
constexpr int kKeyBytes = kSteps / 4 * kKeyBlock;    // 128 KiB a slice
constexpr int kABlock = kTile * 128;                 // A of 4 k-steps: 8 KiB
constexpr int kABytes = kSteps / 4 * kABlock;        // 32 KiB a warpgroup
constexpr int kRawBytes = kTile * kSliceBytes;       // 4 KiB a stage
constexpr int kSmem1 = kKeyBytes + 2 * kABytes + 2 * kRawBytes;   // 200 KiB
constexpr int kCombineThreads = 256;                 // one per output bit
constexpr int kWindow = 256;                         // stage 2 terms a window
constexpr int kLevels = 9;                           // SK^(4 * 2^l), l < 9
constexpr int kBatch = 8;                            // products in flight a warp
constexpr uint32_t kPlane = 0x01010101u;

__device__ __forceinline__ long long row_len(const int32_t* lens, long long r,
                                             long long S) {
  const long long l = lens[r];
  return l < 0 ? 0 : (l > S ? S : l);
}

__host__ __device__ __forceinline__ long long row_blocks(long long len) {
  return (len + 9 + kBlockBytes - 1) / kBlockBytes;
}

__host__ __device__ __forceinline__ long long row_groups(long long nb) {
  return (nb + kGroupBlocks - 1) / kGroupBlocks;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// Commit this thread's cp.async copies and wait for all of them.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Shared-memory writes of this thread (st.shared, cp.async) made visible to
// the tensor cores' async proxy.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A warpgroup's own barrier (ids 1 and 2; 0 is __syncthreads).
__device__ __forceinline__ void group_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kGroupThreads) : "memory");
}

// Operand tiles are K-major with the 128-byte swizzle: a row holds 128
// bytes (4 k-steps of 32), its 16-byte chunk c stored at chunk c ^ (row % 8)
// of a 1024-byte-aligned group of 8 rows. The descriptor of k-step j of such
// a block starts 32 j bytes into it; groups of 8 rows are 1024 bytes apart
// (the stride byte offset); the leading byte offset is not used.
__device__ __forceinline__ uint64_t tile_desc(const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// Byte offset of chunk c (16 bytes) of row r in a swizzled block.
__device__ __forceinline__ int swizzled(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// d (+)= A[64 x 32] B[256 x 32]^T in s8 with s32 sums; d is the warpgroup's
// m64n256 accumulator fragment: d[4 nt + i] holds row 16 (warp % 4) + g +
// 8 (i >> 1), column 8 nt + 2 tig + (i & 1).
__device__ __forceinline__ void wgmma_s8(uint32_t (&d)[128], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Whether tile t holds a group that some row needs. Every row needs its
// group 0, so only a tile inside one row, past that row's groups, is dead.
__device__ __forceinline__ bool tile_alive(uint32_t t, uint32_t M, uint32_t G,
                                           const int32_t* lens, long long S) {
  const uint32_t m0 = t * kTile;
  const uint32_t r0 = m0 / G;
  if (m0 - r0 * G < row_groups(row_blocks(row_len(lens, r0, S)))) return true;
  const uint32_t last = m0 + kTile - 1 < M ? m0 + kTile - 1 : M - 1;
  return last / G > r0;
}

// Slice s of tile t (kTile groups x 64 bytes), loaded into registers: the
// 16-byte chunk q of row rl, bound for raw at rl * 64 + 16 (q ^ ((rl >> 1)
// & 3)) so that the expansion's 16-byte reads of one chunk of 8 rows meet
// no bank twice. Thread i (of its warpgroup) holds chunks i and i + 128.
// Loaded while the tensor cores run and stored after, so that no load's
// latency stalls the warpgroup.
struct Staged {
  uint4 v[kTile * 4 / kGroupThreads];
};

__device__ __forceinline__ Staged load_tile(uint32_t t, int s, int i,
                                            const uint8_t* __restrict__ chunks,
                                            long long stride, long long S,
                                            const int32_t* __restrict__ lens,
                                            uint32_t M, uint32_t G) {
  Staged st;
#pragma unroll
  for (int it = 0; it < kTile * 4 / kGroupThreads; ++it) {
    st.v[it] = make_uint4(0u, 0u, 0u, 0u);
    const int idx = it * kGroupThreads + i;
    const int rl = idx >> 2, q = idx & 3;
    const uint32_t m = t * kTile + rl;
    if (m >= M) continue;
    const uint32_t r = m / G, grp = m - r * G;
    const long long len = row_len(lens, r, S);
    const long long nb = row_blocks(len);
    // Block v of the group (s / 8) is block nb - 16 (grp + 1) + v of the row;
    // one before the row's start, or in a group past the row's, is zero.
    const long long blk = nb - kGroupBlocks * (static_cast<long long>(grp) + 1) + (s >> 3);
    if (blk < 0) continue;
    const long long p0 = blk * kBlockBytes + (s & 7) * kSliceBytes + 16 * q;
    const uint8_t* src = chunks + static_cast<long long>(r) * stride + p0;
    if (p0 + 16 <= len) {
      const uintptr_t off = reinterpret_cast<uintptr_t>(src) & 15;
      if (off == 0) {
        st.v[it] = __ldg(reinterpret_cast<const uint4*>(src));
      } else {
        // An unaligned row: the two aligned 16-byte chunks that hold the
        // piece (both hold bytes of the row), funnel-shifted into place.
        const uint4* a = reinterpret_cast<const uint4*>(src - off);
        const uint4 x = __ldg(a), y = __ldg(a + 1);
        const uint32_t w[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
        const int j = static_cast<int>(off >> 2), sh = static_cast<int>(off & 3) * 8;
        uint32_t u[5];
#pragma unroll
        for (int k = 0; k < 5; ++k)
          u[k] = j == 0 ? w[k] : j == 1 ? w[k + 1] : j == 2 ? w[k + 2] : w[k + 3];
        st.v[it] = make_uint4(__funnelshift_r(u[0], u[1], sh), __funnelshift_r(u[1], u[2], sh),
                              __funnelshift_r(u[2], u[3], sh), __funnelshift_r(u[3], u[4], sh));
      }
      continue;
    }
    // The row's end, its padding or its bit length.
    const long long lf = nb * kBlockBytes - 8;  // first byte of the bit length
    const unsigned long long bitlen = static_cast<unsigned long long>(len) * 8ull;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const long long p = p0 + e;
      uint32_t b = 0u;
      if (p < len) b = __ldg(src + e);
      else if (p == len) b = 0x80u;
      else if (p >= lf) b = static_cast<uint32_t>((bitlen >> (8 * (p - lf))) & 0xffull);
      v[e >> 2] |= b << (8 * (e & 3));
    }
    st.v[it] = make_uint4(v[0], v[1], v[2], v[3]);
  }
  return st;
}

__device__ __forceinline__ void store_tile(unsigned char* raw, const Staged& st, int i) {
#pragma unroll
  for (int it = 0; it < kTile * 4 / kGroupThreads; ++it) {
    const int idx = it * kGroupThreads + i;
    const int rl = idx >> 2, q = idx & 3;
    *reinterpret_cast<uint4*>(raw + rl * kSliceBytes + 16 * (q ^ ((rl >> 1) & 3))) = st.v[it];
  }
}

// The raw tile as the A operand: k-step ks of row r covers raw bytes
// 4 ks + e (e < 4), and k = 4 b + e is bit b of byte e, 0 or 1. Word b of
// the k-step's 32 bytes is (raw word >> b) & 0x01010101; raw chunk c (k-steps
// 4c .. 4c + 3) is row r of swizzled block c.
__device__ __forceinline__ void expand_tile(unsigned char* a, const unsigned char* raw, int i) {
#pragma unroll
  for (int it = 0; it < kTile * 4 / kGroupThreads; ++it) {
    const int idx = it * kGroupThreads + i;
    const int r = idx & (kTile - 1), c = idx / kTile;   // chunk c: k-steps 4c .. 4c + 3
    const uint4 x = *reinterpret_cast<const uint4*>(raw + r * kSliceBytes +
                                                    16 * (c ^ ((r >> 1) & 3)));
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      unsigned char* blk = a + c * kABlock;
      *reinterpret_cast<uint4*>(blk + swizzled(r, 2 * q)) =
          make_uint4(w[q] & kPlane, (w[q] >> 1) & kPlane, (w[q] >> 2) & kPlane,
                     (w[q] >> 3) & kPlane);
      *reinterpret_cast<uint4*>(blk + swizzled(r, 2 * q + 1)) =
          make_uint4((w[q] >> 4) & kPlane, (w[q] >> 5) & kPlane, (w[q] >> 6) & kPlane,
                     (w[q] >> 7) & kPlane);
    }
  }
}

// The next live tile of warpgroup wg at or after tile t (tiles if none).
__device__ __forceinline__ uint32_t live_tile(uint32_t t, uint32_t step, uint32_t tiles,
                                              uint32_t M, uint32_t G, const int32_t* lens,
                                              long long S) {
  while (t < tiles && !tile_alive(t, M, G, lens, S)) t += step;
  return t < tiles ? t : tiles;
}

__global__ void __launch_bounds__(kThreads, 1)
group_term_kernel(const uint8_t* __restrict__ chunks, long long stride, long long S,
                  const int32_t* __restrict__ lens, const unsigned char* __restrict__ key,
                  uint32_t* __restrict__ part, uint32_t M, uint32_t G) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int s = blockIdx.x % kSlices;
  const uint32_t share = blockIdx.x / kSlices, shares = kBlocks / kSlices;
  const uint32_t step = 2 * shares;   // a block's tiles: share, share + shares, ...
  const uint32_t tiles = (M + kTile - 1) / kTile;
  const int wg = threadIdx.x / kGroupThreads, i = threadIdx.x % kGroupThreads;
  const int lane = threadIdx.x & 31, wq = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, tig = lane & 3;
  unsigned char* bs = smem;
  unsigned char* as = smem + kKeyBytes + wg * kABytes;
  unsigned char* raw = smem + kKeyBytes + 2 * kABytes + wg * kRawBytes;

  // This slice of the stacked key as the B tiles, once for the launch.
  const unsigned char* ksrc = key + static_cast<long long>(s) * kKeyBytes;
  for (int j = threadIdx.x; j < kKeyBytes / 16; j += kThreads)
    cp_async16(bs + 16 * j, ksrc + 16 * j);

  // Warpgroup wg takes tiles share + wg * shares, then every step-th; the
  // next tile is loaded into registers while this one's products run.
  uint32_t t = live_tile(share + wg * shares, step, tiles, M, G, lens, S);
  if (t < tiles) store_tile(raw, load_tile(t, s, i, chunks, stride, S, lens, M, G), i);
  cp_async_wait_all();
  fence_async_shared();
  __syncthreads();      // the key and both warpgroups' first tiles are in place

  // The descriptors of k-step 0; k-step ks adds its offset in 16-byte units.
  const uint64_t desc_a = tile_desc(as), desc_b = tile_desc(bs);
  const uint32_t lsb = 1u << (2 * tig);   // where a lane's bit of a byte goes
  while (t < tiles) {
    expand_tile(as, raw, i);
    fence_async_shared();
    group_sync(wg);

    uint32_t d[128];
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks)
      wgmma_s8(d, desc_a + (((ks >> 2) * kABlock + 32 * (ks & 3)) >> 4),
               desc_b + (((ks >> 2) * kKeyBlock + 32 * (ks & 3)) >> 4), ks);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");

    // While the tensor cores run: find and load the next tile.
    const uint32_t tn = live_tile(t + step, step, tiles, M, G, lens, S);
    Staged next;
    if (tn < tiles) next = load_tile(tn, s, i, chunks, stride, S, lens, M, G);

    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

    // Pack the parities: word W of a row is n-tiles 4W .. 4W + 3, each lane
    // holding 2 bits of each (bit 8 q + 2 tig + j of the word, a shift and
    // a masked OR each); OR across the 4 lanes of a row, and lane tig stores
    // words tig and tig + 4 of rows g and g + 8.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t m = t * kTile + 16 * wq + g + 8 * h;
#pragma unroll
      for (int W = 0; W < 8; ++W) {
        uint32_t v = 0u;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int nt = 4 * W + q;
          v |= (d[4 * nt + 2 * h] << (2 * tig + 8 * q)) & (lsb << (8 * q));
          v |= (d[4 * nt + 2 * h + 1] << (2 * tig + 1 + 8 * q)) & (lsb << (8 * q + 1));
        }
        v |= __shfl_xor_sync(0xffffffffu, v, 1);
        v |= __shfl_xor_sync(0xffffffffu, v, 2);
        if ((W & 3) == tig && m < M)
          part[(static_cast<long long>(s) * M + m) * 8 + W] = v;
      }
    }
    if (tn < tiles) store_tile(raw, next, i);   // raw was read before the products
    group_sync(wg);       // tile tn is in place
    t = tn;
  }
}

// Bit c (this thread's) of x P for a 256-bit x in shared memory: the parity
// of x & column c of P.
__device__ __forceinline__ uint32_t times_power(const uint32_t* x, const uint32_t (&col)[8]) {
  const uint4 x0 = reinterpret_cast<const uint4*>(x)[0];
  const uint4 x1 = reinterpret_cast<const uint4*>(x)[1];
  const uint32_t f = (((x0.x & col[0]) ^ (x0.y & col[1])) ^ ((x0.z & col[2]) ^ (x0.w & col[3]))) ^
                     (((x1.x & col[4]) ^ (x1.y & col[5])) ^ ((x1.z & col[6]) ^ (x1.w & col[7])));
  return __popc(f) & 1u;
}

// Column c of power l: bit p of word q is P[32 q + p, c].
__device__ __forceinline__ void load_column(uint32_t (&col)[8], const uint32_t* __restrict__ powers,
                                            int l, int c) {
  const uint4* p = reinterpret_cast<const uint4*>(powers + (l * kCombineThreads + c) * 8);
  const uint4 a = __ldg(p), b = __ldg(p + 1);
  col[0] = a.x; col[1] = a.y; col[2] = a.z; col[3] = a.w;
  col[4] = b.x; col[5] = b.y; col[6] = b.z; col[7] = b.w;
}

__global__ void __launch_bounds__(kCombineThreads, 2)
combine_kernel(const uint32_t* __restrict__ part, uint32_t M, uint32_t G, long long S,
               const int32_t* __restrict__ lens, const uint32_t* __restrict__ powers,
               uint32_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t e[2][kWindow][8];
  __shared__ __align__(16) uint32_t acc[8];
  const uint32_t row = blockIdx.x;
  const int c = threadIdx.x, lane = c & 31, warp = c >> 5;
  const long long ng = row_groups(row_blocks(row_len(lens, row, S)));

  const long long windows = (ng + kWindow - 1) / kWindow;
  for (long long k = windows - 1; k >= 0; --k) {
    // Window k: terms u < n, E_u = T_(256 k + u), the XOR of the 32
    // slices' partials. Thread (u % 16, half, slice class) XORs 4 slices;
    // shuffles finish the XOR over the 8 classes.
    const long long u0 = k * kWindow;
    int n = ng - u0 < kWindow ? static_cast<int>(ng - u0) : kWindow;
    const int sc = c & 7, half = (c >> 3) & 1;
    for (int ub = 0; ub < n; ub += kCombineThreads / 16) {
      const int u = ub + (c >> 4);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (u < n) {
        const long long m = static_cast<long long>(row) * G + u0 + u;
#pragma unroll
        for (int j = 0; j < kSlices / 8; ++j) {
          const uint4 x = __ldg(reinterpret_cast<const uint4*>(
              part + (static_cast<long long>(sc + 8 * j) * M + m) * 8) + half);
          v.x ^= x.x; v.y ^= x.y; v.z ^= x.z; v.w ^= x.w;
        }
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) {
        v.x ^= __shfl_xor_sync(0xffffffffu, v.x, o);
        v.y ^= __shfl_xor_sync(0xffffffffu, v.y, o);
        v.z ^= __shfl_xor_sync(0xffffffffu, v.z, o);
        v.w ^= __shfl_xor_sync(0xffffffffu, v.w, o);
      }
      if (u < n && sc == 0) reinterpret_cast<uint4*>(e[0][u])[half] = v;
    }
    __syncthreads();
    int cur = 0, l = 0;
    for (; n > 1 && l < kLevels - 1; ++l) {
      uint32_t col[8];
      load_column(col, powers, l, c);
      const int half_n = (n + 1) >> 1;
      for (int j0 = 0; j0 < half_n; j0 += kBatch) {
        // No branch and every read before any write: kBatch products in
        // flight. A pair past the level's end reads a valid term and drops it.
        uint32_t even[kBatch], bits[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          const int j = j0 + q;
          const int je = 2 * j < n ? 2 * j : n - 1, jo = 2 * j + 1 < n ? 2 * j + 1 : n - 1;
          even[q] = e[cur][je][warp];
          bits[q] = times_power(e[cur][jo], col);
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          const uint32_t b = __ballot_sync(0xffffffffu, bits[q]);
          bits[q] = 2 * (j0 + q) + 1 < n ? b : 0u;
        }
        if (lane == 0) {
#pragma unroll
          for (int q = 0; q < kBatch; ++q)
            if (j0 + q < half_n) e[cur ^ 1][j0 + q][warp] = even[q] ^ bits[q];
        }
      }
      __syncthreads();
      cur ^= 1;
      n = half_n;
    }
    // Horner across windows: acc = acc SK^1024 ^ F_k.
    uint32_t word = e[cur][0][warp];
    if (k != windows - 1) {
      uint32_t col[8];
      load_column(col, powers, kLevels - 1, c);
      word ^= __ballot_sync(0xffffffffu, times_power(acc, col));
    }
    __syncthreads();      // acc and the window are read
    if (lane == 0) acc[warp] = word;
    __syncthreads();
  }
  if (c < 8) out[row * 8 + c] = acc[c];
}

// The shared memory opt-in of group_term_kernel, set once per device.
cudaError_t prepare() {
  static std::mutex mu;
  static std::map<int, bool> done;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> hold(mu);
  if (!done.count(dev)) {
    err = cudaFuncSetAttribute(group_term_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem1);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

// Groups of a row of width S.
long long groups_of(long long S) {
  return row_groups((S + 9 + kBlockBytes - 1) / kBlockBytes);
}

}  // namespace

// Bytes of scratch for N rows of width S: the 32 slices' partial group terms.
extern "C" long long mtpu_mxhash256_scratch_bytes(int N, long long S) {
  return static_cast<long long>(kSlices) * N * groups_of(S) * 32;
}

// Returns the CUDA error of the launches (0 on success). The wrapper
// (ops/mxhash.py) checks shapes: chunks [N, S] uint8 with rows `stride`
// bytes apart, every lens[r] in 0..S (clamped here), N * groups(S) < 2^31,
// key the 4 MiB tile_key, powers [9, 256, 8] uint32 (ops/mxhash.py
// combine_columns), part mtpu_mxhash256_scratch_bytes(N, S) bytes, out
// [N, 32] uint8, the key, powers, part and out 16-byte aligned.
extern "C" int mtpu_mxhash256(const uint8_t* chunks, long long stride, long long S,
                              const int32_t* lens, const void* key,
                              const uint32_t* powers, void* part,
                              uint8_t* out, int N, void* stream) {
  if (N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = prepare();
  if (err != cudaSuccess) return (int)err;
  const long long G = groups_of(S);
  const long long M = static_cast<long long>(N) * G;
  if (M >= (1ll << 31)) return (int)cudaErrorInvalidValue;   // the wrapper refuses it
  group_term_kernel<<<kBlocks, kThreads, kSmem1, st>>>(
      chunks, stride, S, lens, static_cast<const unsigned char*>(key),
      static_cast<uint32_t*>(part), static_cast<uint32_t>(M), static_cast<uint32_t>(G));
  const cudaError_t e1 = cudaGetLastError();
  if (e1 != cudaSuccess) return (int)e1;
  combine_kernel<<<(unsigned)N, kCombineThreads, 0, st>>>(
      static_cast<const uint32_t*>(part), static_cast<uint32_t>(M),
      static_cast<uint32_t>(G), S, lens, powers, reinterpret_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}
