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
//   key   [S, 8] int8: K, row-major (row i is the 8 column keys of byte i);
//   lkey  [4, 8] int8 = L[:4] (only the low 4 length bytes are nonzero);
//   lens  [N] int32; out is written as [N, 8] uint32 (zeroed here first).
//
// Design: a block takes kRows rows and a 16 KiB segment of each; a thread
// loads one 4-byte data word per row and the matching 4 key rows (32
// bytes) once, transposes them with __byte_perm so one int32 holds column
// c for the 4 rows, and does 8 __dp4a (signed int8 x int8 dot of 4) per
// row, so each key byte read serves kRows rows. Sums accumulate in
// uint32: wrap-around is defined for unsigned types (signed overflow is
// undefined in C++), and
// each __dp4a result is bounded by 4 * 128 * 128, so it never overflows
// before the unsigned add. Block partials meet through atomicAdd on
// uint32; addition mod 2^32 is associative and commutative, so the digest
// is deterministic however a row is split across blocks. The block of
// segment 0 adds the length term.
//
// Bound on an H100: memory. N * S data bytes plus S * 8 key bytes in,
// N * 32 out, over the HBM bandwidth; the 16 int8 operations per data byte
// are far below the card's int8 rate.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;
constexpr long long kSegWords = 4096;  // 16 KiB of each row per block

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Columns 0-3 of 4 key rows (row r's bytes in a_r) -> out[c] holding
// column c of rows 0..3 in bytes 0..3: a 4x4 byte transpose.
__device__ __forceinline__ void transpose4(int a0, int a1, int a2, int a3, int* out) {
  const int x0 = __byte_perm(a0, a1, 0x5140), x1 = __byte_perm(a0, a1, 0x7362);
  const int y0 = __byte_perm(a2, a3, 0x5140), y1 = __byte_perm(a2, a3, 0x7362);
  out[0] = __byte_perm(x0, y0, 0x5410);
  out[1] = __byte_perm(x0, y0, 0x7632);
  out[2] = __byte_perm(x1, y1, 0x5410);
  out[3] = __byte_perm(x1, y1, 0x7632);
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
mxsum_kernel(const uint8_t* __restrict__ chunks, const int32_t* __restrict__ lens,
             const int8_t* __restrict__ key, const int8_t* __restrict__ lkey,
             uint32_t* __restrict__ out, int N, long long S) {
  __shared__ uint32_t red[kThreads / 32][kRows * 8];
  const int row0 = blockIdx.y * kRows;
  const long long seg0 = (long long)blockIdx.x * kSegWords * 4;  // bytes
  long long seg1 = seg0 + kSegWords * 4;
  if (seg1 > S) seg1 = S;

  uint32_t acc[kRows][8];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0;

  if (VEC) {
    for (long long wi = (seg0 >> 2) + threadIdx.x; wi < (seg1 >> 2);
         wi += blockDim.x) {
      // Rows 4wi..4wi+3 of K: ka = (r0 c0-3, r0 c4-7, r1 c0-3, r1 c4-7), kb
      // the same for rows 2 and 3.
      const int4* kp = reinterpret_cast<const int4*>(key + wi * 32);
      const int4 ka = __ldg(kp);
      const int4 kb = __ldg(kp + 1);
      int kc[8];
      transpose4(ka.x, ka.z, kb.x, kb.z, kc);
      transpose4(ka.y, ka.w, kb.y, kb.w, kc + 4);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (row0 + r < N) {
          const int d = __ldg(reinterpret_cast<const int*>(
                                  chunks + (long long)(row0 + r) * S) + wi);
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] += (uint32_t)__dp4a(d, kc[c], 0);
        }
      }
    }
  } else {
    for (long long i = seg0 + threadIdx.x; i < seg1; i += blockDim.x) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (row0 + r < N) {
          const int d = (int8_t)chunks[(long long)(row0 + r) * S + i];
#pragma unroll
          for (int c = 0; c < 8; ++c)
            acc[r][c] += (uint32_t)(d * (int)key[i * 8 + c]);
        }
      }
    }
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const uint32_t v = warp_sum(acc[r][c]);
      if (lane == 0) red[warp][r * 8 + c] = v;
    }
  __syncthreads();
  if (threadIdx.x < kRows * 8) {
    const int r = threadIdx.x >> 3;
    const int c = threadIdx.x & 7;
    if (row0 + r < N) {
      uint32_t sum = 0;
      for (int wv = 0; wv < kThreads / 32; ++wv) sum += red[wv][threadIdx.x];
      if (blockIdx.x == 0) {
        const uint32_t len = (uint32_t)lens[row0 + r];
        for (int j = 0; j < 4; ++j) {
          const int lb = (int8_t)((len >> (8 * j)) & 0xFF);
          sum += (uint32_t)(lb * (int)lkey[j * 8 + c]);
        }
      }
      atomicAdd(out + (long long)(row0 + r) * 8 + c, sum);
    }
  }
}

}  // namespace

// Returns the CUDA error of the launch (0 on success). The wrapper
// (ops/mxsum.py) checks shapes: N <= 65535 * kRows, key holds S rows,
// out holds N * 32 bytes.
extern "C" int mtpu_mxsum_digest(const uint8_t* chunks, const int32_t* lens,
                                 const int8_t* key, const int8_t* lkey,
                                 uint8_t* out, int N, long long S, void* stream) {
  if (N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)N * 32, st);
  if (err != cudaSuccess) return (int)err;
  long long segs = (S + kSegWords * 4 - 1) / (kSegWords * 4);
  if (segs < 1) segs = 1;  // S == 0: one block still adds the length term
  const dim3 grid((unsigned)segs, (unsigned)((N + kRows - 1) / kRows));
  const bool vec = (S % 4 == 0) && ((uintptr_t)chunks % 4 == 0) &&
                   ((uintptr_t)key % 16 == 0);
  uint32_t* o = reinterpret_cast<uint32_t*>(out);
  if (vec)
    mxsum_kernel<true><<<grid, kThreads, 0, st>>>(chunks, lens, key, lkey, o, N, S);
  else
    mxsum_kernel<false><<<grid, kThreads, 0, st>>>(chunks, lens, key, lkey, o, N, S);
  return (int)cudaGetLastError();
}
