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
//   where K is the [4352, 256] GF(2) key matrix (ops/mxhash.py
//   _key_matrix), bits LSB-first within each byte and state first in x.
//   out[r] = state_nb packed LSB-first into 32 bytes.
//
// Layout (ops/mxhash.py packs the key host-side and caches it on the
// device):
//   key [68, 256] uint64: word w of column c holds K[64w .. 64w+63, c],
//       bit p = K[64w + p, c]; so x, packed the same way as 68 words
//       (4 state words, then the block's 512 bytes read as 64 little-endian
//       words), gives output bit c as the parity of XOR_w (x[w] & key[w][c]).
//   lens [N] int32; out [N, 32] uint8 (written as [N, 8] uint32).
//
// Bound on an H100: operations. 2 * 4352 * 256 bit operations per block,
// counted as int8 tensor-core operations (the convention of PERF.md):
// [192, 131072] (257 blocks a row) is 0.056 ms at 1979 TOP/s; its bytes
// take 0.0076 ms.
//
// Design (the simple one; a faster one is in ROADMAP Queue 2, item 3):
// - One block of 256 threads per row, thread c owning output bit c. Its key
//   column, 68 words, is loaded once into registers; x lives in shared
//   memory and every thread reads the same word at once (a broadcast).
// - A step: 64 threads stage the next 512-byte block (8 bytes each; a byte
//   at a time where the row is not 8-byte aligned or the word holds the
//   row's end, building the terminator and the length there), then every
//   thread folds x & column over the 68 words with XOR, takes the parity
//   of the popcount, and a warp ballot packs 32 state bits into one word.
//   The chain is sequential in the blocks, so a row runs on one SM; rows
//   run in parallel across the card.
// - Rows of any length mix in one launch: each row computes its own block
//   count and padding, so a ragged batch needs no host-side padding.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;      // one per output bit
constexpr int kBlockBytes = 512;
constexpr int kWords = 4 + kBlockBytes / 8;   // 68: [state | block] in uint64

__global__ void __launch_bounds__(kThreads, 1)
mxhash256_kernel(const uint8_t* __restrict__ chunks, long long stride,
                 const int32_t* __restrict__ lens,
                 const unsigned long long* __restrict__ key,
                 uint8_t* __restrict__ out) {
  __shared__ unsigned long long x[kWords];
  const int c = threadIdx.x;
  const long long row = blockIdx.x;

  unsigned long long col[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) col[w] = __ldg(key + w * kThreads + c);

  const long long len = lens[row] < 0 ? 0 : lens[row];
  const uint8_t* src = chunks + row * stride;
  const long long nblocks = (len + 9 + kBlockBytes - 1) / kBlockBytes;
  const unsigned long long bitlen = static_cast<unsigned long long>(len) * 8ull;
  if (c < 4) x[c] = 0ull;

  for (long long blk = 0; blk < nblocks; ++blk) {
    if (c < kBlockBytes / 8) {
      const long long p0 = blk * kBlockBytes + 8 * c;
      unsigned long long v;
      if (blk == nblocks - 1 && c == kBlockBytes / 8 - 1) {
        v = bitlen;   // the last 8 bytes: never data, never the terminator
      } else if (p0 + 8 <= len &&
                 (reinterpret_cast<uintptr_t>(src + p0) & 7) == 0) {
        v = __ldg(reinterpret_cast<const unsigned long long*>(src + p0));
      } else {
        v = 0ull;
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          const long long p = p0 + b;
          const unsigned long long byte =
              p < len ? src[p] : (p == len ? 0x80ull : 0ull);
          v |= byte << (8 * b);
        }
      }
      x[4 + c] = v;
    }
    __syncthreads();
    unsigned long long acc = 0ull;
#pragma unroll
    for (int w = 0; w < kWords; ++w) acc ^= x[w] & col[w];
    const unsigned bits = __ballot_sync(0xffffffffu, __popcll(acc) & 1);
    __syncthreads();   // every thread has read the old state and block
    if ((c & 31) == 0) reinterpret_cast<uint32_t*>(x)[c >> 5] = bits;
  }
  __syncthreads();
  if (c < 8) {
    reinterpret_cast<uint32_t*>(out + row * 32)[c] =
        reinterpret_cast<const uint32_t*>(x)[c];
  }
}

}  // namespace

// Returns the CUDA error of the launch (0 on success). The wrapper
// (ops/mxhash.py) checks shapes: chunks [N, stride] uint8 with every
// lens[r] <= stride, key [68, 256] uint64, out [N, 32] uint8 4-byte aligned.
extern "C" int mtpu_mxhash256(const uint8_t* chunks, long long stride,
                              const int32_t* lens,
                              const unsigned long long* key, uint8_t* out,
                              int N, void* stream) {
  if (N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  mxhash256_kernel<<<N, kThreads, 0, st>>>(chunks, stride, lens, key, out);
  return (int)cudaGetLastError();
}
