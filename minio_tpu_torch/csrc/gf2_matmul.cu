// K1: the GF(2) bit-matrix Reed-Solomon contraction, hand-written for Hopper.
//
// Replaces minio_tpu/ops/rs_pallas.py:_gf2_kernel (launched by
// gf2_matmul_with_weights) and serves the three contractions of
// minio_tpu/ops/rs_xla.py (_gf2_matmul, gf2_matmul_with_weights,
// gf2_matmul_multi): encode parity, single-pattern reconstruct, and the
// per-block-weight reconstruct.
//
// What it computes: out[b, t, s] = XOR_j M[t, j] * x[b, j, s] over GF(2^8),
// where the GF(2^8) matrix M arrives lifted to its GF(2) bit-matrix W.
//
// Layout (the one layout this kernel takes; ops/rs.py converts):
//   x    [B, kin, S] uint8, contiguous, any S (ragged S handled here)
//   w    [kin*8, tout*8] int8 holding 0/1, the minio_tpu/ops/gf.py
//        expand_to_bitmatrix layout: W[j*8 + bi, t*8 + bo] is bit bo of
//        (M[t, j] * x^bi). Block b reads w + b * w_batch_stride: stride 0
//        shares one weight (encode, single-pattern reconstruct); stride
//        kin*8*tout*8 gives each block its own decode matrix.
//   out  [B, tout, S] uint8
// The weight is runtime data: one compiled kernel serves every failure
// pattern, as heal sweeps need.
//
// Bound on an H100: memory. At EC 8+4 with 1 MiB blocks a launch moves
// B*kin*S bytes in and B*tout*S out; the least time is those bytes over
// the HBM rate (7.5 us at [16, 8, 131072] -> 4).
//
// What held the first version (a 256-entry byte table per (t, j)) back:
// tout byte lookups per input byte, each a shared load that a warp's random
// bytes hit with 2-way bank conflicts, plus shift-and-OR work per lookup;
// 512 blocks that each rebuilt 8 KiB of tables for 4 KiB per shard of
// work; and 4-byte loads with few bytes in flight.
//
// Design:
// - Packed-output nibble tables. Multiplying by M[t, j] is linear over
//   GF(2), so for input shard j and nibble half h a block keeps 16 entries
//   P[j][h][u]; byte t of entry u is M[t, j] * (u << 4h), for all outputs
//   at once: one uint32 when tout <= 4, a uint2 when <= 8, a uint4 when
//   <= 16, and passes of 16 outputs above that. An input byte costs two
//   shared loads whatever tout is, and one 3-input XOR folds them into an
//   accumulator that holds every output byte of its position. The 16
//   uint32 entries of a table lie in 16 distinct banks: no conflicts at
//   tout <= 4.
// - Addresses without arithmetic: input j's tables start on a 256-byte
//   boundary, so an entry's shared address is that base with its low byte
//   replaced by the nibble times the entry size. Two shift-and-masks per
//   4 input bytes make all 8 low bytes, and one __byte_perm per lookup
//   splices one into the base: about 4 integer instructions and 2 shared
//   loads per input byte (accumulate()).
// - Aligned path (S % 16 == 0, aligned pointers): a thread takes 16
//   consecutive positions, one 16-byte load per shard row (a warp covers
//   512 consecutive bytes, and asks L2 to fetch 256-byte pieces) and, after
//   a 4x4 byte transpose per 4 positions (__byte_perm), one 16-byte store
//   per output row. At 64 registers 4 blocks of 256 threads fit on an SM,
//   so all of [16, 8, 131072] is in flight in one wave.
// - The tables (kin * 256 bytes at tout <= 8) are built from W in shared
//   memory, about one entry per thread. The grid is persistent: at most
//   the blocks that fit on the card at once, each walking a contiguous
//   range of (b, output group, S-tile) tiles, so a block rebuilds its
//   tables only where b changes and the weight is per block.
// - Shard rows are loaded kRowsPerLoad at a time, so any kin works (ops/
//   rs.py admits kin <= 32).
// - Byte path (a ragged S or an unaligned pointer): a thread's 16
//   positions lie kThreads apart, so each byte load and store of a warp
//   covers 32 consecutive bytes; the edge is masked.
// What still bounds it (timed variants, PERF.md 6.3): the table build
// ahead of the loads and the lookups each add about a microsecond to the
// memory time, and loading the shard rows before the build needs more
// registers than the one-wave grid has.

#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerLoad = 8;           // shard rows loaded together

constexpr int kPos = 16;                  // positions (bytes of S) per thread
constexpr long long kTile = (long long)kThreads * kPos;
// Blocks per SM the registers must allow on the aligned path at tout <= 4:
// 4 blocks of 256 threads at 64 registers hold all of [16, 8, 131072] in
// one wave.
template <int NW, bool VEC>
constexpr int kMinBlocks = NW == 1 && VEC ? 4 : 1;

// Table words per entry: 1, 2 or 4 bytes-of-4 outputs; groups of 16 outputs.
__host__ __device__ inline int words_per_entry(int tout) {
  return tout <= 4 ? 1 : tout <= 8 ? 2 : 4;
}
__host__ __device__ inline int output_groups(int tout) {
  return tout <= 16 ? 1 : (tout + 15) / 16;
}
// Bytes of input j's tables: 32 entries of nwt words, at least 256 so that
// an entry's shared address is base_j with its low byte replaced.
__host__ __device__ inline int table_stride(int tout) {
  const int bytes = 32 * words_per_entry(tout) * output_groups(tout) * 4;
  return bytes < 256 ? 256 : bytes;
}
// Dynamic shared memory: 256 bytes of alignment slack, the tables, then one
// byte per (input bit, output) column.
__host__ __device__ inline size_t smem_bytes(int kin, int tout) {
  return 256 + (size_t)kin * table_stride(tout) + (size_t)kin * 8 * tout;
}

// A 16-byte read-only load that asks L2 to fetch the 256-byte piece.
__device__ __forceinline__ uint4 load16(const uint8_t* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ uint2 lds64(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];" : "=r"(v.x), "=r"(v.y) : "r"(addr));
  return v;
}

// Columns 0-3 of 4 words (word p's bytes in a_p) -> out[r] holding byte r
// of words 0..3 in its bytes 0..3: a 4x4 byte transpose.
__device__ __forceinline__ void transpose4(uint32_t a0, uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint32_t* out) {
  const uint32_t x0 = __byte_perm(a0, a1, 0x5140), x1 = __byte_perm(a0, a1, 0x7362);
  const uint32_t y0 = __byte_perm(a2, a3, 0x5140), y1 = __byte_perm(a2, a3, 0x7362);
  out[0] = __byte_perm(x0, y0, 0x5410);
  out[1] = __byte_perm(x0, y0, 0x7632);
  out[2] = __byte_perm(x1, y1, 0x5410);
  out[3] = __byte_perm(x1, y1, 0x7632);
}

// Input j's tables start at byte j * table_stride of `tab`: entry (h, u)
// at (h*16 + u) * nwt words, and its word q holds in byte r the output
// t = 4q + r of M[t, j] * (u << 4h). colb[(j*8 + bi) * tout + t] is output
// byte t for input bit bi of shard j alone.
__device__ void build_tables(const int8_t* __restrict__ w, int kin, int tout,
                             uint32_t* tab, uint8_t* colb) {
  const int cols = tout * 8;
  const int nwt = words_per_entry(tout) * output_groups(tout);
  const int jwords = table_stride(tout) / 4;
  for (int e = threadIdx.x; e < kin * 8 * tout; e += blockDim.x) {
    const int t = e % tout, row = e / tout;
    const int8_t* wr = w + (size_t)row * cols + t * 8;
    uint32_t c = 0;
    for (int bo = 0; bo < 8; ++bo) c |= (uint32_t)(wr[bo] & 1) << bo;
    colb[e] = (uint8_t)c;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kin * 32 * nwt; e += blockDim.x) {
    const int q = e % nwt, ent = e / nwt;
    const int u = ent & 15, h = (ent >> 4) & 1, j = ent >> 5;
    uint32_t v = 0;
    for (int r = 0; r < 4 && q * 4 + r < tout; ++r) {
      uint32_t by = 0;
      for (int i = 0; i < 4; ++i)
        if (u >> i & 1) by ^= colb[(j * 8 + h * 4 + i) * tout + q * 4 + r];
      v |= by << (8 * r);
    }
    tab[j * jwords + (ent & 31) * nwt + q] = v;
  }
  __syncthreads();
}

// acc[p] ^= P[j][0][low nibble of byte p] ^ P[j][1][high nibble], for the 16
// bytes of words[4] (byte p in byte p % 4 of word p / 4). tj is the
// shared address of input j's tables (256-aligned), g the output group.
//
// For 1 and 2 words per entry the entry's address is tj with its low byte
// replaced by the nibble times the entry size (plus 16 entries for the high
// half): two shifts and masks per word make all 8 offsets, and one
// __byte_perm per lookup splices one into tj. With 4 words, an add.
template <int NW>
__device__ __forceinline__ void accumulate(uint32_t (&acc)[kPos][NW], uint32_t tj,
                                           int nwt, int g, const uint32_t* words) {
#pragma unroll
  for (int wi = 0; wi < kPos / 4; ++wi) {
    const uint32_t wv = words[wi];
    if (NW == 1) {
      const uint32_t lo = (wv << 2) & 0x3C3C3C3Cu;
      const uint32_t hi = ((wv >> 2) & 0x3C3C3C3Cu) | 0x40404040u;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[wi * 4 + i][0] ^= lds32(__byte_perm(lo, tj, 0x7650 + i)) ^
                              lds32(__byte_perm(hi, tj, 0x7650 + i));
    } else if (NW == 2) {
      const uint32_t lo = (wv << 3) & 0x78787878u;
      const uint32_t hi = ((wv >> 1) & 0x78787878u) | 0x80808080u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint2 a = lds64(__byte_perm(lo, tj, 0x7650 + i));
        const uint2 b = lds64(__byte_perm(hi, tj, 0x7650 + i));
        acc[wi * 4 + i][0] ^= a.x ^ b.x;
        acc[wi * 4 + i][1] ^= a.y ^ b.y;
      }
    } else {
      const uint32_t base = tj + g * 16;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t by = (wv >> (8 * i)) & 0xFF;
        const uint32_t la = base + (by & 15) * nwt * 4;
        const uint32_t ha = base + (16 + (by >> 4)) * nwt * 4;
        uint4 a, b;
        asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                     : "=r"(a.x), "=r"(a.y), "=r"(a.z), "=r"(a.w) : "r"(la));
        asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                     : "=r"(b.x), "=r"(b.y), "=r"(b.z), "=r"(b.w) : "r"(ha));
        uint32_t* ac = acc[wi * 4 + i];
        ac[0] ^= a.x ^ b.x;
        ac[1] ^= a.y ^ b.y;
        ac[2] ^= a.z ^ b.z;
        ac[3] ^= a.w ^ b.w;
      }
    }
  }
}

// Shard rows j0 + jj, j0 + jj < kin, of block xb at a thread's positions
// from s0 (see gf2_kernel), byte p in byte p % 4 of words[jj][p / 4].
template <bool VEC>
__device__ __forceinline__ void load_rows(uint32_t (&words)[kRowsPerLoad][kPos / 4],
                                          const uint8_t* __restrict__ xb, int j0,
                                          int kin, long long S, long long s0) {
#pragma unroll
  for (int jj = 0; jj < kRowsPerLoad; ++jj) {
    const uint8_t* row = xb + (j0 + jj) * S;
    if (VEC) {
      if (j0 + jj < kin) {
        const uint4 v = load16(row + s0);
        words[jj][0] = v.x; words[jj][1] = v.y; words[jj][2] = v.z; words[jj][3] = v.w;
      }
    } else {
#pragma unroll
      for (int p = 0; p < kPos; ++p) {
        const long long s = s0 + (long long)p * kThreads;
        const uint32_t by = (j0 + jj < kin && s < S) ? __ldg(row + s) : 0u;
        if ((p & 3) == 0) words[jj][p >> 2] = by;
        else words[jj][p >> 2] |= by << (8 * (p & 3));
      }
    }
  }
}

// VEC: S % 16 == 0 and x, out 16-byte aligned: a thread's 16 positions are
// consecutive, one 16-byte load per shard row and one 16-byte store per
// output row, so a warp's load or store covers 512 consecutive bytes.
// Otherwise (the byte path) they lie kThreads apart (s0 + p * kThreads),
// so each byte load and store of a warp covers 32 consecutive bytes, and
// the edge is masked.
template <int NW, bool VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks<NW, VEC>)
gf2_kernel(const uint8_t* __restrict__ x, const int8_t* __restrict__ w,
           uint8_t* __restrict__ out, int kin, int tout, long long S,
           long long w_batch_stride, int groups, long long chunks, long long tiles) {
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t tbase = (sbase + 255) & ~255u;
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem + (tbase - sbase));
  uint8_t* colb = smem + (tbase - sbase) + (size_t)kin * table_stride(tout);
  const int nwt = NW * groups;
  const uint32_t jstride = table_stride(tout);

  const long long per = tiles / gridDim.x, extra = tiles % gridDim.x;
  const long long first = blockIdx.x * per + min((long long)blockIdx.x, extra);
  const long long last = first + per + (blockIdx.x < extra ? 1 : 0);
  long long built = -1;

  for (long long tile = first; tile < last; ++tile) {
    const long long b = tile / (groups * chunks);
    const int g = (int)((tile - b * groups * chunks) / chunks);
    const long long c = tile - b * groups * chunks - (long long)g * chunks;
    const long long s0 = c * kTile + (VEC ? (long long)threadIdx.x * kPos : threadIdx.x);
    const uint8_t* xb = x + b * kin * S;
    const long long wb = w_batch_stride ? b : 0;
    if (wb != built) {
      if (built >= 0) __syncthreads();  // the last tile's lookups are done
      build_tables(w + wb * w_batch_stride, kin, tout, tab, colb);
      built = wb;
    }
    if (s0 >= S) continue;

    uint32_t acc[kPos][NW];
#pragma unroll
    for (int p = 0; p < kPos; ++p)
#pragma unroll
      for (int q = 0; q < NW; ++q) acc[p][q] = 0;
    uint32_t words[kRowsPerLoad][kPos / 4];
    for (int j0 = 0; j0 < kin; j0 += kRowsPerLoad) {
      load_rows<VEC>(words, xb, j0, kin, S, s0);
#pragma unroll
      for (int jj = 0; jj < kRowsPerLoad; ++jj)
        if (j0 + jj < kin)
          accumulate<NW>(acc, tbase + (j0 + jj) * jstride, nwt, g, words[jj]);
    }

    uint8_t* ob = out + b * tout * S;
#pragma unroll
    for (int q = 0; q < NW; ++q) {
      if (VEC) {
        uint32_t rows[4][4];  // [output byte r][4 positions each]
#pragma unroll
        for (int p4 = 0; p4 < 4; ++p4) {
          uint32_t o[4];
          transpose4(acc[4 * p4][q], acc[4 * p4 + 1][q], acc[4 * p4 + 2][q],
                     acc[4 * p4 + 3][q], o);
#pragma unroll
          for (int r = 0; r < 4; ++r) rows[r][p4] = o[r];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int t = g * 16 + q * 4 + r;
          if (t < tout)
            *reinterpret_cast<uint4*>(ob + t * S + s0) =
                make_uint4(rows[r][0], rows[r][1], rows[r][2], rows[r][3]);
        }
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int t = g * 16 + q * 4 + r;
          if (t >= tout) continue;
#pragma unroll
          for (int p = 0; p < kPos; ++p) {
            const long long s = s0 + (long long)p * kThreads;
            if (s < S) ob[t * S + s] = (uint8_t)(acc[p][q] >> (8 * r));
          }
        }
      }
    }
  }
}

// The blocks of gf2_kernel<NW, VEC> that fit on the current device at once
// (its SMs times the blocks per SM at `smem` bytes of dynamic shared
// memory). The runtime is asked on the first launch of each (device, smem)
// and the answer kept, so later launches make no queries.
template <int NW, bool VEC>
cudaError_t resident_blocks(size_t smem, long long* blocks) {
  static std::mutex mu;
  static std::map<std::tuple<int, size_t>, long long> known;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> hold(mu);
  auto it = known.find({dev, smem});
  if (it == known.end()) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gf2_kernel<NW, VEC>,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    it = known.emplace(std::make_tuple(dev, smem),
                       (long long)sms * (per_sm > 0 ? per_sm : 1)).first;
  }
  *blocks = it->second;
  return cudaSuccess;
}

template <int NW, bool VEC>
cudaError_t launch(const uint8_t* x, const int8_t* w, uint8_t* out, int B, int kin,
                   int tout, long long S, long long w_batch_stride,
                   cudaStream_t st) {
  const size_t smem = smem_bytes(kin, tout);
  const int groups = output_groups(tout);
  const long long chunks = (S + kTile - 1) / kTile;
  const long long tiles = (long long)B * groups * chunks;
  auto* fn = gf2_kernel<NW, VEC>;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  long long grid = 0;
  if ((err = resident_blocks<NW, VEC>(smem, &grid)) != cudaSuccess) return err;
  if (grid > tiles) grid = tiles;
  fn<<<(unsigned)grid, kThreads, smem, st>>>(x, w, out, kin, tout, S, w_batch_stride,
                                              groups, chunks, tiles);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_width(const uint8_t* x, const int8_t* w, uint8_t* out, int B,
                         int kin, int tout, long long S, long long w_batch_stride,
                         cudaStream_t st) {
  switch (words_per_entry(tout)) {
    case 1: return launch<1, VEC>(x, w, out, B, kin, tout, S, w_batch_stride, st);
    case 2: return launch<2, VEC>(x, w, out, B, kin, tout, S, w_batch_stride, st);
    default: return launch<4, VEC>(x, w, out, B, kin, tout, S, w_batch_stride, st);
  }
}

}  // namespace

// Returns the CUDA error of the launch (0 on success). Shapes are checked
// by the Python wrapper (ops/rs.py, kernel_geometry): 1 <= kin <= 32,
// tout >= 1, smem_bytes() within the card's shared memory.
extern "C" int mtpu_gf2_matmul(const uint8_t* x, const int8_t* w, uint8_t* out,
                               int B, int kin, int tout, long long S,
                               long long w_batch_stride, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  const bool vec = (S % 16 == 0) && ((uintptr_t)x % 16 == 0) &&
                   ((uintptr_t)out % 16 == 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(vec ? launch_width<true>(x, w, out, B, kin, tout, S, w_batch_stride, st)
                   : launch_width<false>(x, w, out, B, kin, tout, S, w_batch_stride, st));
}
