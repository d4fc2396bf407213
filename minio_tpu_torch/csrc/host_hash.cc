// host_hash — the host bitrot hashes of the port: sip256, HighwayHash-256
// and XXH64, behind a plain C interface loaded with ctypes
// (minio_tpu_torch/native/lib.py), which releases the interpreter lock for
// the call, so the shard writer and reader threads hash side by side.
//
// sip256 and HighwayHash-256 are copies of the JAX package's host library
// (native/mtpu_native.cc: mtpu_sip256 and mtpu_highwayhash256 with their
// helpers); the digests must be the same bytes, since both packages read
// each other's shard files. XXH64 is written from the published xxHash
// specification (XXH64, version 0.1.1); the registry seeds it with
// 0x6D747075, as the JAX package seeds the xxhash package.
//
// Built with the host compiler, not nvcc: g++ -O3 -shared -fPIC.

#include <cstdint>
#include <cstring>

extern "C" {

static inline uint64_t load_le64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;  // little-endian hosts only (x86-64 / aarch64)
}

static inline uint32_t load_le32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

static inline uint64_t rotl64(uint64_t x, int b) {
  return (x << b) | (x >> (64 - b));
}

// ---------------------------------------------------------------------------
// sip256: 4 parallel keyed SipHash-2-4 lanes over interleaved 8-byte words.
//
// Lane L consumes words L, L+4, L+8, ... of the message; each lane's key is
// the 128-bit user key XOR a lane constant, so the lanes are independent
// permutations. The four 64-bit lane digests concatenate to the 256-bit
// bitrot digest.
// ---------------------------------------------------------------------------

struct SipState {
  uint64_t v0, v1, v2, v3;
};

static inline void sip_init(SipState& s, uint64_t k0, uint64_t k1) {
  s.v0 = k0 ^ 0x736f6d6570736575ULL;
  s.v1 = k1 ^ 0x646f72616e646f6dULL;
  s.v2 = k0 ^ 0x6c7967656e657261ULL;
  s.v3 = k1 ^ 0x7465646279746573ULL;
}

static inline void sip_round(SipState& s) {
  s.v0 += s.v1;
  s.v1 = rotl64(s.v1, 13);
  s.v1 ^= s.v0;
  s.v0 = rotl64(s.v0, 32);
  s.v2 += s.v3;
  s.v3 = rotl64(s.v3, 16);
  s.v3 ^= s.v2;
  s.v0 += s.v3;
  s.v3 = rotl64(s.v3, 21);
  s.v3 ^= s.v0;
  s.v2 += s.v1;
  s.v1 = rotl64(s.v1, 17);
  s.v1 ^= s.v2;
  s.v2 = rotl64(s.v2, 32);
}

static inline void sip_absorb(SipState& s, uint64_t m) {
  s.v3 ^= m;
  sip_round(s);
  sip_round(s);
  s.v0 ^= m;
}

static inline uint64_t sip_final(SipState& s, uint64_t len_tag) {
  sip_absorb(s, len_tag);
  s.v2 ^= 0xff;
  sip_round(s);
  sip_round(s);
  sip_round(s);
  sip_round(s);
  return s.v0 ^ s.v1 ^ s.v2 ^ s.v3;
}

void mtpu_torch_sip256(const uint8_t* key32, const uint8_t* data, uint64_t len,
                       uint8_t* out32) {
  const uint64_t k0 = load_le64(key32);
  const uint64_t k1 = load_le64(key32 + 8);
  const uint64_t k2 = load_le64(key32 + 16);
  const uint64_t k3 = load_le64(key32 + 24);

  SipState lane[4];
  sip_init(lane[0], k0, k1);
  sip_init(lane[1], k0 ^ 0xa5a5a5a5a5a5a5a5ULL, k2);
  sip_init(lane[2], k1 ^ 0x3c3c3c3c3c3c3c3cULL, k3);
  sip_init(lane[3], k2 ^ 0x9696969696969696ULL, k3 ^ k0);

  // Bulk: groups of 32 bytes feed one word to each lane.
  uint64_t ngroups = len / 32;
  const uint8_t* p = data;
  for (uint64_t g = 0; g < ngroups; ++g, p += 32) {
    sip_absorb(lane[0], load_le64(p));
    sip_absorb(lane[1], load_le64(p + 8));
    sip_absorb(lane[2], load_le64(p + 16));
    sip_absorb(lane[3], load_le64(p + 24));
  }

  // Tail: remaining full words round-robin, final partial word padded.
  uint64_t rem = len - ngroups * 32;
  int lane_i = 0;
  while (rem >= 8) {
    sip_absorb(lane[lane_i++ & 3], load_le64(p));
    p += 8;
    rem -= 8;
  }
  if (rem) {
    uint8_t pad[8] = {0};
    std::memcpy(pad, p, rem);
    sip_absorb(lane[lane_i & 3], load_le64(pad));
  }

  // Length tag binds total size into every lane (distinct per lane).
  for (int i = 0; i < 4; ++i) {
    uint64_t d = sip_final(lane[i], len ^ (0x0101010101010101ULL * i));
    std::memcpy(out32 + 8 * i, &d, 8);
  }
}

// ---------------------------------------------------------------------------
// HighwayHash-256 (the reference MinIO's default bitrot algorithm, keyed by
// the caller with its magic bitrot key).
// ---------------------------------------------------------------------------

struct HHState {
  uint64_t v0[4], v1[4], mul0[4], mul1[4];
};

static inline uint64_t hh_rot32(uint64_t x) { return (x >> 32) | (x << 32); }

static void hh_reset(HHState* s, const uint8_t* key32) {
  static const uint64_t init0[4] = {
      0xdbe6d5d5fe4cce2fULL, 0xa4093822299f31d0ULL, 0x13198a2e03707344ULL,
      0x243f6a8885a308d3ULL};
  static const uint64_t init1[4] = {
      0x3bd39e10cb0ef593ULL, 0xc0acf169b5f18a8cULL, 0xbe5466cf34e90c6cULL,
      0x452821e638d01377ULL};
  for (int i = 0; i < 4; ++i) {
    const uint64_t k = load_le64(key32 + 8 * i);
    s->mul0[i] = init0[i];
    s->mul1[i] = init1[i];
    s->v0[i] = init0[i] ^ k;
    s->v1[i] = init1[i] ^ hh_rot32(k);
  }
}

#define HH_MASKB(v, b) ((v) & (0xFFull << ((b) * 8)))

static inline void hh_zipper(const uint64_t v1, const uint64_t v0,
                             uint64_t* add1, uint64_t* add0) {
  *add0 += ((HH_MASKB(v0, 3) + HH_MASKB(v1, 4)) >> 24) +
           ((HH_MASKB(v0, 5) + HH_MASKB(v1, 6)) >> 16) + HH_MASKB(v0, 2) +
           (HH_MASKB(v0, 1) << 32) + (HH_MASKB(v1, 7) >> 8) + (v0 << 56);
  *add1 += ((HH_MASKB(v1, 3) + HH_MASKB(v0, 4)) >> 24) + HH_MASKB(v1, 2) +
           (HH_MASKB(v1, 5) >> 16) + (HH_MASKB(v1, 1) << 24) +
           (HH_MASKB(v0, 6) >> 8) + (HH_MASKB(v1, 0) << 48) +
           HH_MASKB(v0, 7);
}

#undef HH_MASKB

static void hh_update(HHState* s, const uint64_t lanes[4]) {
  for (int i = 0; i < 4; ++i) s->v1[i] += lanes[i] + s->mul0[i];
  for (int i = 0; i < 4; ++i) {
    const uint32_t v1_32 = static_cast<uint32_t>(s->v1[i]);
    s->mul0[i] ^= v1_32 * (s->v0[i] >> 32);
    s->v0[i] += s->mul1[i];
    const uint32_t v0_32 = static_cast<uint32_t>(s->v0[i]);
    s->mul1[i] ^= v0_32 * (s->v1[i] >> 32);
  }
  hh_zipper(s->v1[1], s->v1[0], &s->v0[1], &s->v0[0]);
  hh_zipper(s->v1[3], s->v1[2], &s->v0[3], &s->v0[2]);
  hh_zipper(s->v0[1], s->v0[0], &s->v1[1], &s->v1[0]);
  hh_zipper(s->v0[3], s->v0[2], &s->v1[3], &s->v1[2]);
}

static void hh_update_packet(HHState* s, const uint8_t* p) {
  uint64_t lanes[4];
  for (int i = 0; i < 4; ++i) lanes[i] = load_le64(p + 8 * i);
  hh_update(s, lanes);
}

// Length padding for the final 1..31 bytes (the exact Load3 semantics of
// the published algorithm: these byte placements are part of the
// definition).
static void hh_update_remainder(HHState* s, const uint8_t* bytes,
                                size_t mod32) {
  const uint64_t mod32_pair = (static_cast<uint64_t>(mod32) << 32) + mod32;
  for (int i = 0; i < 4; ++i) s->v0[i] += mod32_pair;
  for (int i = 0; i < 4; ++i) {  // Rotate32By(v1 halves, mod32); mod32 >= 1
    const uint32_t lo = static_cast<uint32_t>(s->v1[i]);
    const uint32_t hi = static_cast<uint32_t>(s->v1[i] >> 32);
    const uint32_t rlo = (lo << mod32) | (lo >> (32 - mod32));
    const uint32_t rhi = (hi << mod32) | (hi >> (32 - mod32));
    s->v1[i] = (static_cast<uint64_t>(rhi) << 32) | rlo;
  }
  const size_t mod4 = mod32 & 3;
  const uint8_t* remainder = bytes + (mod32 & ~size_t{3});
  uint8_t packet[32] = {0};
  std::memcpy(packet, bytes, mod32 & ~size_t{3});
  if (mod32 & 16) {  // 16..31 bytes: last 4 ending at remainder+mod4
    std::memcpy(packet + 28, remainder + mod4 - 4, 4);
  } else if (mod4) {  // "unordered" load of 1..3 bytes at packet+16
    uint64_t last3 = remainder[0];
    last3 += static_cast<uint64_t>(remainder[mod4 >> 1]) << 8;
    last3 += static_cast<uint64_t>(remainder[mod4 - 1]) << 16;
    std::memcpy(packet + 16, &last3, 8);
  }
  hh_update_packet(s, packet);
}

static inline void hh_shift128_left(int bits, uint64_t* a1, uint64_t* a0) {
  const uint64_t shifted1 = (*a1) << bits;
  const uint64_t top = (*a0) >> (64 - bits);
  *a0 <<= bits;
  *a1 = shifted1 | top;
}

// Modular reduction by x^128 + x^2 + x (256 -> 128 bits).
static void hh_modular_reduction(uint64_t a3, const uint64_t a2,
                                 const uint64_t a1, const uint64_t a0,
                                 uint64_t* m1, uint64_t* m0) {
  a3 &= 0x3FFFFFFFFFFFFFFFULL;
  uint64_t a3s1 = a3, a2s1 = a2, a3s2 = a3, a2s2 = a2;
  hh_shift128_left(1, &a3s1, &a2s1);
  hh_shift128_left(2, &a3s2, &a2s2);
  *m1 = a1 ^ a3s1 ^ a3s2;
  *m0 = a0 ^ a2s1 ^ a2s2;
}

void mtpu_torch_highwayhash256(const uint8_t* key32, const uint8_t* data,
                               uint64_t len, uint8_t* out32) {
  HHState s;
  hh_reset(&s, key32);
  uint64_t i = 0;
  for (; i + 32 <= len; i += 32) hh_update_packet(&s, data + i);
  if (len & 31) hh_update_remainder(&s, data + i, len & 31);
  for (int n = 0; n < 10; ++n) {  // PermuteAndUpdate x10 for 256-bit
    const uint64_t permuted[4] = {hh_rot32(s.v0[2]), hh_rot32(s.v0[3]),
                                  hh_rot32(s.v0[0]), hh_rot32(s.v0[1])};
    hh_update(&s, permuted);
  }
  uint64_t r0, r1, r2, r3;
  hh_modular_reduction(s.v1[1] + s.mul1[1], s.v1[0] + s.mul1[0],
                       s.v0[1] + s.mul0[1], s.v0[0] + s.mul0[0], &r1, &r0);
  hh_modular_reduction(s.v1[3] + s.mul1[3], s.v1[2] + s.mul1[2],
                       s.v0[3] + s.mul0[3], s.v0[2] + s.mul0[2], &r3, &r2);
  std::memcpy(out32, &r0, 8);
  std::memcpy(out32 + 8, &r1, 8);
  std::memcpy(out32 + 16, &r2, 8);
  std::memcpy(out32 + 24, &r3, 8);
}

// ---------------------------------------------------------------------------
// XXH64 (xxHash specification, XXH64 algorithm description): four
// accumulators over 32-byte stripes, then the 8-, 4- and 1-byte tail and
// the avalanche. Returns the 64-bit value; the registry writes it
// big-endian (xxHash's canonical form, what the xxhash package's digest()
// gives).
// ---------------------------------------------------------------------------

static const uint64_t XXH_P1 = 0x9E3779B185EBCA87ULL;
static const uint64_t XXH_P2 = 0xC2B2AE3D27D4EB4FULL;
static const uint64_t XXH_P3 = 0x165667B19E3779F9ULL;
static const uint64_t XXH_P4 = 0x85EBCA77C2B2AE63ULL;
static const uint64_t XXH_P5 = 0x27D4EB2F165667C5ULL;

static inline uint64_t xxh_round(uint64_t acc, uint64_t input) {
  acc += input * XXH_P2;
  acc = rotl64(acc, 31);
  return acc * XXH_P1;
}

static inline uint64_t xxh_merge(uint64_t acc, uint64_t val) {
  acc ^= xxh_round(0, val);
  return acc * XXH_P1 + XXH_P4;
}

uint64_t mtpu_torch_xxh64(const uint8_t* data, uint64_t len, uint64_t seed) {
  const uint8_t* p = data;
  const uint8_t* const end = data + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = seed + XXH_P1 + XXH_P2;
    uint64_t v2 = seed + XXH_P2;
    uint64_t v3 = seed;
    uint64_t v4 = seed - XXH_P1;
    const uint8_t* const limit = end - 32;
    do {
      v1 = xxh_round(v1, load_le64(p));
      v2 = xxh_round(v2, load_le64(p + 8));
      v3 = xxh_round(v3, load_le64(p + 16));
      v4 = xxh_round(v4, load_le64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    h = xxh_merge(h, v1);
    h = xxh_merge(h, v2);
    h = xxh_merge(h, v3);
    h = xxh_merge(h, v4);
  } else {
    h = seed + XXH_P5;
  }
  h += len;
  while (p + 8 <= end) {
    h ^= xxh_round(0, load_le64(p));
    h = rotl64(h, 27) * XXH_P1 + XXH_P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= static_cast<uint64_t>(load_le32(p)) * XXH_P1;
    h = rotl64(h, 23) * XXH_P2 + XXH_P3;
    p += 4;
  }
  while (p < end) {
    h ^= static_cast<uint64_t>(*p) * XXH_P5;
    h = rotl64(h, 11) * XXH_P1;
    ++p;
  }
  h ^= h >> 33;
  h *= XXH_P2;
  h ^= h >> 29;
  h *= XXH_P3;
  h ^= h >> 32;
  return h;
}

}  // extern "C"
