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
// Design: the TPU kernel unpacks bytes to bits and runs an int8 MXU
// contraction. Here each block first expands W into tout*kin byte tables
// in shared memory, T[t][j][v] = M[t, j] * v (the 8x8 bit block applied to
// byte v), then every thread XORs T[t][j][x[b, j, s]] over j for 4
// consecutive bytes of s at a time. The table build goes through 16-entry
// nibble tables so its cost stays small next to the main loop.
//
// Bound on an H100: memory. At EC 8+4 with 1 MiB blocks a block moves
// 8 * 131072 bytes in and 4 * 131072 out and does 8 * 4 table lookups per
// output byte column, far below the card's operation rate; the least time
// is (B * (kin + tout) * S) bytes over the HBM bandwidth. The lookups hit
// shared memory with bank conflicts, which is what keeps this simple
// kernel above that bound. An int8 tensor-core (wgmma) form is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxIn = 32;          // kin limit: x words live in registers
constexpr int kWordsPerThread = 4;  // amortises the table build

__device__ void build_tables(const int8_t* __restrict__ w, int kin, int tout,
                             uint8_t* tab, uint8_t* nib, uint8_t* colb) {
  const int tj_count = tout * kin;
  const int cols = tout * 8;
  // colb[tj*8 + bi]: the output byte for input bit bi alone.
  for (int e = threadIdx.x; e < tj_count * 8; e += blockDim.x) {
    const int bi = e & 7;
    const int tj = e >> 3;
    const int t = tj / kin, j = tj % kin;
    const int8_t* row = w + (size_t)(j * 8 + bi) * cols + t * 8;
    uint32_t col = 0;
    for (int bo = 0; bo < 8; ++bo) col |= (uint32_t)(row[bo] & 1) << bo;
    colb[e] = (uint8_t)col;
  }
  __syncthreads();
  // nib[tj*32 + h*16 + u]: the output byte for nibble u at half h.
  for (int e = threadIdx.x; e < tj_count * 32; e += blockDim.x) {
    const int u = e & 15;
    const int h = (e >> 4) & 1;
    const int tj = e >> 5;
    const uint8_t* cb = colb + tj * 8 + h * 4;
    uint32_t acc = 0;
    for (int i = 0; i < 4; ++i)
      if (u >> i & 1) acc ^= cb[i];
    nib[e] = (uint8_t)acc;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < tj_count * 256; e += blockDim.x) {
    const int v = e & 255;
    const int tj = e >> 8;
    tab[e] = nib[tj * 32 + (v & 15)] ^ nib[tj * 32 + 16 + (v >> 4)];
  }
  __syncthreads();
}

// VEC: S % 4 == 0 and x/out 4-byte aligned, so each thread moves uint32
// words; otherwise bytes.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
gf2_kernel(const uint8_t* __restrict__ x, const int8_t* __restrict__ w,
           uint8_t* __restrict__ out, int kin, int tout, long long S,
           long long w_batch_stride) {
  extern __shared__ uint8_t smem[];
  const int tj_count = tout * kin;
  uint8_t* tab = smem;
  uint8_t* nib = smem + tj_count * 256;
  uint8_t* colb = nib + tj_count * 32;
  const long long b = blockIdx.y;
  build_tables(w + b * w_batch_stride, kin, tout, tab, nib, colb);

  const uint8_t* xb = x + b * kin * S;
  uint8_t* ob = out + b * tout * S;
  const long long stride = (long long)gridDim.x * blockDim.x;
  if (VEC) {
    const long long words = S >> 2;
    for (long long wi = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         wi < words; wi += stride) {
      uint32_t xs[kMaxIn];
#pragma unroll
      for (int j = 0; j < kMaxIn; ++j)
        if (j < kin)
          xs[j] = __ldg(reinterpret_cast<const uint32_t*>(xb + j * S) + wi);
      for (int t = 0; t < tout; ++t) {
        const uint8_t* tt = tab + t * kin * 256;
        uint32_t acc = 0;
#pragma unroll
        for (int j = 0; j < kMaxIn; ++j) {
          if (j < kin) {
            const uint32_t v = xs[j];
            const uint8_t* tb = tt + j * 256;
            acc ^= (uint32_t)tb[v & 255] | ((uint32_t)tb[(v >> 8) & 255] << 8) |
                   ((uint32_t)tb[(v >> 16) & 255] << 16) |
                   ((uint32_t)tb[v >> 24] << 24);
          }
        }
        reinterpret_cast<uint32_t*>(ob + t * S)[wi] = acc;
      }
    }
  } else {
    for (long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x; s < S;
         s += stride) {
      for (int t = 0; t < tout; ++t) {
        const uint8_t* tt = tab + t * kin * 256;
        uint32_t acc = 0;
        for (int j = 0; j < kin; ++j) acc ^= tt[j * 256 + xb[j * S + s]];
        ob[t * S + s] = (uint8_t)acc;
      }
    }
  }
}

}  // namespace

// Returns the CUDA error of the launch (0 on success). Shapes are checked
// by the Python wrapper (ops/rs.py): 1 <= kin <= 32, tout >= 1, B <= 65535,
// tout * kin * 296 bytes of tables fit in shared memory.
extern "C" int mtpu_gf2_matmul(const uint8_t* x, const int8_t* w, uint8_t* out,
                               int B, int kin, int tout, long long S,
                               long long w_batch_stride, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  const size_t smem = (size_t)tout * kin * (256 + 32 + 8);
  const bool vec = (S % 4 == 0) && ((uintptr_t)x % 4 == 0) &&
                   ((uintptr_t)out % 4 == 0);
  const long long units = vec ? (S >> 2) : S;
  long long blocks = (units + (long long)kThreads * kWordsPerThread - 1) /
                     ((long long)kThreads * kWordsPerThread);
  if (blocks < 1) blocks = 1;
  if (blocks > 65535) blocks = 65535;
  const dim3 grid((unsigned)blocks, (unsigned)B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (vec) {
    err = cudaFuncSetAttribute(gf2_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    gf2_kernel<true><<<grid, kThreads, smem, st>>>(x, w, out, kin, tout, S,
                                                   w_batch_stride);
  } else {
    err = cudaFuncSetAttribute(gf2_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    gf2_kernel<false><<<grid, kThreads, smem, st>>>(x, w, out, kin, tout, S,
                                                    w_batch_stride);
  }
  return (int)cudaGetLastError();
}
