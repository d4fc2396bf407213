// host_codec — the host codecs of the data-at-rest slice: the snappy block
// codec behind the port's S2 compression (crypto/compress.py), Argon2id
// with its BLAKE2b core behind the sealed config store
// (crypto/configcrypt.py), and CRC-32C, the checksum of every S2 frame.
// A plain C interface, loaded with ctypes beside host_hash.cc in one
// library (minio_tpu_torch/native/lib.py), which releases the interpreter
// lock for each call.
//
// All three are copies of the JAX package's host library
// (native/mtpu_native.cc: mtpu_torch_snappy_*, mtpu_torch_argon2id and the portable
// slice-by-8 mtpu_crc32c), renamed mtpu_torch_*: a compressed frame, a
// derived key and a checksum must be the same bytes in both packages,
// since each reads what the other stored. The snappy compressor is the
// JAX package's greedy matcher, byte for byte, so both packages store the
// same frames for the same object.
//
// Built with the host compiler, not nvcc: g++ -O3 -shared -fPIC.

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// Snappy-format block codec — the klauspost/compress S2 role (reference
// ingest compression cmd/object-api-utils.go:926). The block format is the public snappy encoding: a varint uncompressed length, then
// literal / copy elements (tag low 2 bits: 00 literal, 01 copy-1byte-offset,
// 10 copy-2byte-offset, 11 copy-4byte-offset). The compressor is a greedy
// hash-table matcher over 64 KiB fragments, so offsets always fit copy1/2.
// Framing (stream chunking + CRC32C) lives host-side in Python; the byte
// crunching lives here.
// ---------------------------------------------------------------------------

static inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}

static const int kSnapHashBits = 14;

static inline uint32_t snap_hash(uint32_t v) {
  return (v * 0x1e35a7bdu) >> (32 - kSnapHashBits);
}

static inline uint8_t* emit_literal(uint8_t* op, const uint8_t* lit,
                                    uint32_t len) {
  uint32_t n = len - 1;
  if (n < 60) {
    *op++ = static_cast<uint8_t>(n << 2);
  } else if (n < (1u << 8)) {
    *op++ = 60 << 2;
    *op++ = static_cast<uint8_t>(n);
  } else if (n < (1u << 16)) {
    *op++ = 61 << 2;
    *op++ = static_cast<uint8_t>(n);
    *op++ = static_cast<uint8_t>(n >> 8);
  } else if (n < (1u << 24)) {
    *op++ = 62 << 2;
    *op++ = static_cast<uint8_t>(n);
    *op++ = static_cast<uint8_t>(n >> 8);
    *op++ = static_cast<uint8_t>(n >> 16);
  } else {
    *op++ = 63 << 2;
    *op++ = static_cast<uint8_t>(n);
    *op++ = static_cast<uint8_t>(n >> 8);
    *op++ = static_cast<uint8_t>(n >> 16);
    *op++ = static_cast<uint8_t>(n >> 24);
  }
  memcpy(op, lit, len);
  return op + len;
}

static inline uint8_t* emit_copy(uint8_t* op, uint32_t offset, uint32_t len) {
  // First element must keep >= 4 bytes for the tail so every emitted copy
  // is encodable (copy1 min length 4, copy2 covers 1..64).
  while (len >= 68) {
    *op++ = (63 << 2) | 2;  // copy2, length 64
    *op++ = static_cast<uint8_t>(offset);
    *op++ = static_cast<uint8_t>(offset >> 8);
    len -= 64;
  }
  if (len > 64) {
    *op++ = (59 << 2) | 2;  // copy2, length 60 — leaves a 4..8 byte tail
    *op++ = static_cast<uint8_t>(offset);
    *op++ = static_cast<uint8_t>(offset >> 8);
    len -= 60;
  }
  if (len >= 12 || offset >= 2048) {
    *op++ = static_cast<uint8_t>(((len - 1) << 2) | 2);
    *op++ = static_cast<uint8_t>(offset);
    *op++ = static_cast<uint8_t>(offset >> 8);
  } else {
    *op++ = static_cast<uint8_t>(((offset >> 8) << 5) | ((len - 4) << 2) | 1);
    *op++ = static_cast<uint8_t>(offset);
  }
  return op;
}

static uint8_t* snap_compress_fragment(const uint8_t* src, uint32_t len,
                                       uint8_t* op, uint16_t* table) {
  memset(table, 0, sizeof(uint16_t) << kSnapHashBits);
  const uint8_t* ip = src;
  const uint8_t* end = src + len;
  const uint8_t* lit = src;
  if (len >= 16) {
    const uint8_t* limit = end - 15;  // room for load32 + match extension
    while (ip < limit) {
      uint32_t v = load32(ip);
      uint32_t h = snap_hash(v);
      const uint8_t* cand = src + table[h];
      table[h] = static_cast<uint16_t>(ip - src);
      if (cand < ip && load32(cand) == v) {
        const uint8_t* m = ip + 4;
        const uint8_t* c = cand + 4;
        while (m < end && *m == *c) {
          ++m;
          ++c;
        }
        if (lit < ip) op = emit_literal(op, lit, ip - lit);
        op = emit_copy(op, ip - cand, m - ip);
        ip = m;
        lit = ip;
        if (ip < limit)
          table[snap_hash(load32(ip - 1))] = static_cast<uint16_t>(ip - 1 - src);
      } else {
        ++ip;
      }
    }
  }
  if (lit < end) op = emit_literal(op, lit, end - lit);
  return op;
}

uint64_t mtpu_torch_snappy_max_compressed(uint64_t n) {
  return 32 + n + n / 6;
}

int64_t mtpu_torch_snappy_compress(const uint8_t* in, uint64_t n, uint8_t* out) {
  uint8_t* op = out;
  uint64_t v = n;
  while (v >= 0x80) {
    *op++ = static_cast<uint8_t>(v) | 0x80;
    v >>= 7;
  }
  *op++ = static_cast<uint8_t>(v);
  static thread_local uint16_t table[1 << kSnapHashBits];
  uint64_t pos = 0;
  while (pos < n) {
    uint64_t frag = n - pos < 65536 ? n - pos : 65536;
    op = snap_compress_fragment(in + pos, static_cast<uint32_t>(frag), op,
                                table);
    pos += frag;
  }
  return op - out;
}

static int64_t snap_varint(const uint8_t* in, uint64_t n, uint64_t* val) {
  uint64_t v = 0;
  int shift = 0;
  uint64_t i = 0;
  while (i < n && shift < 35) {
    uint8_t b = in[i++];
    v |= static_cast<uint64_t>(b & 0x7f) << shift;
    if (!(b & 0x80)) {
      *val = v;
      return static_cast<int64_t>(i);
    }
    shift += 7;
  }
  return -1;
}

int64_t mtpu_torch_snappy_uncompressed_len(const uint8_t* in, uint64_t n) {
  uint64_t v;
  if (snap_varint(in, n, &v) < 0) return -1;
  return static_cast<int64_t>(v);
}

int64_t mtpu_torch_snappy_uncompress(const uint8_t* in, uint64_t n, uint8_t* out,
                               uint64_t cap) {
  uint64_t ulen;
  int64_t hdr = snap_varint(in, n, &ulen);
  if (hdr < 0 || ulen > cap) return -1;
  uint64_t i = static_cast<uint64_t>(hdr);
  uint8_t* op = out;
  uint8_t* oend = out + ulen;
  while (i < n) {
    uint8_t tag = in[i++];
    uint32_t len, offset;
    if ((tag & 3) == 0) {
      uint32_t l6 = tag >> 2;
      if (l6 < 60) {
        len = l6 + 1;
      } else {
        uint32_t nb = l6 - 59;  // 1..4 extra length bytes
        if (i + nb > n) return -1;
        len = 0;
        for (uint32_t k = 0; k < nb; ++k) len |= in[i + k] << (8 * k);
        i += nb;
        if (len == 0xffffffffu) return -1;
        len += 1;
      }
      if (i + len > n || op + len > oend) return -1;
      memcpy(op, in + i, len);
      op += len;
      i += len;
      continue;
    }
    if ((tag & 3) == 1) {
      if (i + 1 > n) return -1;
      len = 4 + ((tag >> 2) & 7);
      offset = (static_cast<uint32_t>(tag >> 5) << 8) | in[i];
      i += 1;
    } else if ((tag & 3) == 2) {
      if (i + 2 > n) return -1;
      len = (tag >> 2) + 1;
      offset = in[i] | (static_cast<uint32_t>(in[i + 1]) << 8);
      i += 2;
    } else {
      if (i + 4 > n) return -1;
      len = (tag >> 2) + 1;
      offset = load32(in + i);
      i += 4;
    }
    if (offset == 0 || static_cast<uint64_t>(op - out) < offset ||
        op + len > oend)
      return -1;
    const uint8_t* from = op - offset;
    if (offset >= len) {
      memcpy(op, from, len);
      op += len;
    } else {
      for (uint32_t k = 0; k < len; ++k) op[k] = from[k];
      op += len;
    }
  }
  return op == oend ? static_cast<int64_t>(ulen) : -1;
}

// ---------------------------------------------------------------------------
// Argon2id (RFC 9106) — the pkg/argon2 role: memory-hard KDF used to
// derive the config-at-rest encryption key from the root credential
// (reference cmd/config-encrypted.go via madmin EncryptData). Includes
// the required BLAKE2b-512 core. Checked against the RFC 9106 §5.3 test
// vector in tests/test_torch_compress.py.
// ---------------------------------------------------------------------------

static const uint64_t kB2bIV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
    0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};

static const uint8_t kB2bSigma[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3}};

static inline uint64_t rotr64(uint64_t x, int b) {
  return (x >> b) | (x << (64 - b));
}

struct B2bState {
  uint64_t h[8];
  uint64_t tlo, thi;
  uint8_t buf[128];
  size_t buflen;
  size_t outlen;
};

static void b2b_compress(B2bState* s, const uint8_t* block, bool last) {
  uint64_t m[16], v[16];
  for (int i = 0; i < 16; ++i) memcpy(&m[i], block + 8 * i, 8);
  for (int i = 0; i < 8; ++i) v[i] = s->h[i];
  for (int i = 0; i < 8; ++i) v[8 + i] = kB2bIV[i];
  v[12] ^= s->tlo;
  v[13] ^= s->thi;
  if (last) v[14] = ~v[14];
#define B2B_G(r, i, a, b, c, d)                  \
  do {                                           \
    a = a + b + m[kB2bSigma[r][2 * i]];          \
    d = rotr64(d ^ a, 32);                       \
    c = c + d;                                   \
    b = rotr64(b ^ c, 24);                       \
    a = a + b + m[kB2bSigma[r][2 * i + 1]];      \
    d = rotr64(d ^ a, 16);                       \
    c = c + d;                                   \
    b = rotr64(b ^ c, 63);                       \
  } while (0)
  for (int r = 0; r < 12; ++r) {
    B2B_G(r, 0, v[0], v[4], v[8], v[12]);
    B2B_G(r, 1, v[1], v[5], v[9], v[13]);
    B2B_G(r, 2, v[2], v[6], v[10], v[14]);
    B2B_G(r, 3, v[3], v[7], v[11], v[15]);
    B2B_G(r, 4, v[0], v[5], v[10], v[15]);
    B2B_G(r, 5, v[1], v[6], v[11], v[12]);
    B2B_G(r, 6, v[2], v[7], v[8], v[13]);
    B2B_G(r, 7, v[3], v[4], v[9], v[14]);
  }
#undef B2B_G
  for (int i = 0; i < 8; ++i) s->h[i] ^= v[i] ^ v[8 + i];
}

static void b2b_init(B2bState* s, size_t outlen) {
  for (int i = 0; i < 8; ++i) s->h[i] = kB2bIV[i];
  s->h[0] ^= 0x01010000ULL ^ (uint64_t)outlen;
  s->tlo = s->thi = 0;
  s->buflen = 0;
  s->outlen = outlen;
}

static void b2b_update(B2bState* s, const void* data, size_t len) {
  const uint8_t* p = (const uint8_t*)data;
  while (len > 0) {
    if (s->buflen == 128) {
      s->tlo += 128;
      if (s->tlo < 128) s->thi++;
      b2b_compress(s, s->buf, false);
      s->buflen = 0;
    }
    size_t take = 128 - s->buflen;
    if (take > len) take = len;
    memcpy(s->buf + s->buflen, p, take);
    s->buflen += take;
    p += take;
    len -= take;
  }
}

static void b2b_final(B2bState* s, uint8_t* out) {
  s->tlo += s->buflen;
  if (s->tlo < s->buflen) s->thi++;
  memset(s->buf + s->buflen, 0, 128 - s->buflen);
  b2b_compress(s, s->buf, true);
  uint8_t full[64];
  for (int i = 0; i < 8; ++i) memcpy(full + 8 * i, &s->h[i], 8);
  memcpy(out, full, s->outlen);
}

// Argon2's variable-length hash H' (RFC 9106 §3.3).
static void argon_hprime(uint8_t* out, uint32_t outlen, const uint8_t* in,
                         size_t inlen) {
  uint8_t le[4] = {(uint8_t)outlen, (uint8_t)(outlen >> 8),
                   (uint8_t)(outlen >> 16), (uint8_t)(outlen >> 24)};
  B2bState s;
  if (outlen <= 64) {
    b2b_init(&s, outlen);
    b2b_update(&s, le, 4);
    b2b_update(&s, in, inlen);
    b2b_final(&s, out);
    return;
  }
  uint32_t r = (outlen + 31) / 32 - 2;
  uint8_t v[64];
  b2b_init(&s, 64);
  b2b_update(&s, le, 4);
  b2b_update(&s, in, inlen);
  b2b_final(&s, v);
  memcpy(out, v, 32);
  for (uint32_t i = 1; i < r; ++i) {
    b2b_init(&s, 64);
    b2b_update(&s, v, 64);
    b2b_final(&s, v);
    memcpy(out + 32 * i, v, 32);
  }
  uint8_t last[64];
  b2b_init(&s, outlen - 32 * r);
  b2b_update(&s, v, 64);
  b2b_final(&s, last);
  memcpy(out + 32 * r, last, outlen - 32 * r);
}

struct ABlock {
  uint64_t v[128];
};

static inline uint64_t fblamka(uint64_t x, uint64_t y) {
  uint64_t xy = (uint64_t)(uint32_t)x * (uint64_t)(uint32_t)y;
  return x + y + 2 * xy;
}

#define AGB(a, b, c, d)          \
  do {                           \
    a = fblamka(a, b);           \
    d = rotr64(d ^ a, 32);       \
    c = fblamka(c, d);           \
    b = rotr64(b ^ c, 24);       \
    a = fblamka(a, b);           \
    d = rotr64(d ^ a, 16);       \
    c = fblamka(c, d);           \
    b = rotr64(b ^ c, 63);       \
  } while (0)

#define AROUND(v0, v1, v2, v3, v4, v5, v6, v7, v8, v9, v10, v11, v12, v13, \
               v14, v15)                                                   \
  do {                                                                     \
    AGB(v0, v4, v8, v12);                                                  \
    AGB(v1, v5, v9, v13);                                                  \
    AGB(v2, v6, v10, v14);                                                 \
    AGB(v3, v7, v11, v15);                                                 \
    AGB(v0, v5, v10, v15);                                                 \
    AGB(v1, v6, v11, v12);                                                 \
    AGB(v2, v7, v8, v13);                                                  \
    AGB(v3, v4, v9, v14);                                                  \
  } while (0)

// fill_block: next = P(prev ^ ref) ^ (prev ^ ref) [^ old next if with_xor]
static void argon_fill_block(const ABlock* prev, const ABlock* ref,
                             ABlock* next, bool with_xor) {
  ABlock R, tmp;
  for (int i = 0; i < 128; ++i) R.v[i] = prev->v[i] ^ ref->v[i];
  tmp = R;
  if (with_xor)
    for (int i = 0; i < 128; ++i) tmp.v[i] ^= next->v[i];
  uint64_t* w = R.v;
  for (int i = 0; i < 8; ++i) {
    uint64_t* r = w + 16 * i;
    AROUND(r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7], r[8], r[9], r[10],
           r[11], r[12], r[13], r[14], r[15]);
  }
  for (int i = 0; i < 8; ++i) {
    uint64_t* c = w + 2 * i;
    AROUND(c[0], c[1], c[16], c[17], c[32], c[33], c[48], c[49], c[64], c[65],
           c[80], c[81], c[96], c[97], c[112], c[113]);
  }
  for (int i = 0; i < 128; ++i) next->v[i] = tmp.v[i] ^ R.v[i];
}

static void argon_next_addresses(ABlock* addr, ABlock* input,
                                 const ABlock* zero) {
  input->v[6]++;
  argon_fill_block(zero, input, addr, false);
  argon_fill_block(zero, addr, addr, false);
}

// One segment of one lane (RFC 9106 §3.4; argon2id hybrid addressing:
// pass 0 slices 0-1 data-independent, the rest data-dependent).
static void argon_fill_segment(ABlock* B, uint32_t pass, uint32_t slice,
                               uint32_t lane, uint32_t lanes, uint32_t q,
                               uint32_t seg, uint32_t mp, uint32_t passes) {
  bool di = (pass == 0 && slice < 2);
  ABlock addr, input, zero;
  if (di) {
    memset(&zero, 0, sizeof(zero));
    memset(&input, 0, sizeof(input));
    input.v[0] = pass;
    input.v[1] = lane;
    input.v[2] = slice;
    input.v[3] = mp;
    input.v[4] = passes;
    input.v[5] = 2;  // Argon2id
  }
  uint32_t start = 0;
  if (pass == 0 && slice == 0) {
    start = 2;
    if (di) argon_next_addresses(&addr, &input, &zero);
  }
  for (uint32_t i = start; i < seg; ++i) {
    uint32_t cur_col = slice * seg + i;
    uint32_t cur = lane * q + cur_col;
    uint32_t prev = (cur_col == 0) ? lane * q + q - 1 : cur - 1;
    uint64_t rand;
    if (di) {
      if (i % 128 == 0) argon_next_addresses(&addr, &input, &zero);
      rand = addr.v[i % 128];
    } else {
      rand = B[prev].v[0];
    }
    uint32_t j1 = (uint32_t)rand;
    uint32_t ref_lane = (pass == 0 && slice == 0)
                            ? lane
                            : (uint32_t)((rand >> 32) % lanes);
    bool same = ref_lane == lane;
    uint32_t area;
    if (pass == 0) {
      if (slice == 0)
        area = i - 1;
      else if (same)
        area = slice * seg + i - 1;
      else
        area = slice * seg - (i == 0 ? 1 : 0);
    } else {
      if (same)
        area = q - seg + i - 1;
      else
        area = q - seg - (i == 0 ? 1 : 0);
    }
    uint64_t x = ((uint64_t)j1 * j1) >> 32;
    uint64_t y = ((uint64_t)area * x) >> 32;
    uint32_t rel = area - 1 - (uint32_t)y;
    uint32_t start_pos = (pass == 0) ? 0 : ((slice + 1) % 4) * seg;
    uint32_t ref = (start_pos + rel) % q;
    argon_fill_block(&B[prev], &B[ref_lane * q + ref], &B[cur], pass > 0);
  }
}

int mtpu_torch_argon2id(const uint8_t* pwd, uint64_t pwd_len, const uint8_t* salt,
                  uint64_t salt_len, const uint8_t* secret,
                  uint64_t secret_len, const uint8_t* ad, uint64_t ad_len,
                  uint32_t t_cost, uint32_t m_kib, uint32_t lanes,
                  uint8_t* out, uint32_t out_len) {
  // Parameter bounds (RFC 9106 §3.1 caps lanes at 2^24-1; the others are
  // sanity limits): these arrive from UNTRUSTED on-disk headers via
  // decrypt paths, so overflow here would be a remote crash primitive.
  if (lanes == 0 || lanes > 0xFFFFFF || t_cost == 0 || out_len < 4)
    return -1;
  uint64_t m = m_kib;
  if (m < 8ULL * lanes) m = 8ULL * lanes;
  if (m > (1ULL << 31)) return -1;  // >2 TiB of blocks is a DoS, not a KDF
  uint64_t mp64 = 4ULL * lanes * (m / (4ULL * lanes));
  uint32_t mp = (uint32_t)mp64;
  uint32_t q = (uint32_t)(mp64 / lanes);
  uint32_t seg = q / 4;
  if (seg == 0) return -1;
  ABlock* B = (ABlock*)malloc((size_t)mp * sizeof(ABlock));
  if (B == nullptr) return -1;

  // H0 (RFC 9106 §3.2) — note m_kib (the requested cost), not m'.
  uint8_t h0[72];
  {
    B2bState s;
    b2b_init(&s, 64);
    uint32_t hdr[6] = {lanes, out_len, m_kib, t_cost, 0x13, 2};
    b2b_update(&s, hdr, 24);
    uint32_t n = (uint32_t)pwd_len;
    b2b_update(&s, &n, 4);
    b2b_update(&s, pwd, pwd_len);
    n = (uint32_t)salt_len;
    b2b_update(&s, &n, 4);
    b2b_update(&s, salt, salt_len);
    n = (uint32_t)secret_len;
    b2b_update(&s, &n, 4);
    b2b_update(&s, secret, secret_len);
    n = (uint32_t)ad_len;
    b2b_update(&s, &n, 4);
    b2b_update(&s, ad, ad_len);
    b2b_final(&s, h0);
  }
  for (uint32_t l = 0; l < lanes; ++l) {
    for (uint32_t i = 0; i < 2; ++i) {
      memcpy(h0 + 64, &i, 4);
      memcpy(h0 + 68, &l, 4);
      argon_hprime((uint8_t*)B[l * q + i].v, 1024, h0, 72);
    }
  }
  for (uint32_t pass = 0; pass < t_cost; ++pass)
    for (uint32_t slice = 0; slice < 4; ++slice)
      for (uint32_t l = 0; l < lanes; ++l)
        argon_fill_segment(B, pass, slice, l, lanes, q, seg, mp, t_cost);

  ABlock C = B[q - 1];
  for (uint32_t l = 1; l < lanes; ++l)
    for (int i = 0; i < 128; ++i) C.v[i] ^= B[l * q + q - 1].v[i];
  argon_hprime(out, out_len, (const uint8_t*)C.v, 1024);
  // Wipe: the block matrix, H0 and C are password-derived key material.
  // Volatile pointer writes — a plain memset before free() is a dead
  // store the optimizer may elide.
  volatile uint8_t* vb = (volatile uint8_t*)B;
  for (size_t i = 0; i < (size_t)mp * sizeof(ABlock); ++i) vb[i] = 0;
  volatile uint8_t* vc = (volatile uint8_t*)C.v;
  for (size_t i = 0; i < sizeof(C); ++i) vc[i] = 0;
  volatile uint8_t* vh = (volatile uint8_t*)h0;
  for (size_t i = 0; i < sizeof(h0); ++i) vh[i] = 0;
  free(B);
  return 0;
}

// ---------------------------------------------------------------------------
// CRC-32C (Castagnoli) — the S2 frame checksum: the JAX package's portable
// slice-by-8 table (its -march=native build may take the SSE4.2
// instruction instead; the checksum is the same).
// ---------------------------------------------------------------------------

static uint32_t crc32c_table[8][256];

// Table built at load time (static init) so concurrent first calls from
// many threads never race on it.
static struct Crc32cInit {
  Crc32cInit() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c >> 1) ^ (0x82f63b78u & (0u - (c & 1)));
      crc32c_table[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = crc32c_table[0][i];
      for (int t = 1; t < 8; ++t) {
        c = crc32c_table[0][c & 0xff] ^ (c >> 8);
        crc32c_table[t][i] = c;
      }
    }
  }
} crc32c_initializer;

uint32_t mtpu_torch_crc32c(const uint8_t* data, uint64_t len) {
  uint32_t crc = 0xffffffffu;
  while (len >= 8) {
    crc ^= load32(data);
    uint32_t hi = load32(data + 4);
    crc = crc32c_table[7][crc & 0xff] ^ crc32c_table[6][(crc >> 8) & 0xff] ^
          crc32c_table[5][(crc >> 16) & 0xff] ^ crc32c_table[4][crc >> 24] ^
          crc32c_table[3][hi & 0xff] ^ crc32c_table[2][(hi >> 8) & 0xff] ^
          crc32c_table[1][(hi >> 16) & 0xff] ^ crc32c_table[0][hi >> 24];
    data += 8;
    len -= 8;
  }
  while (len--) crc = crc32c_table[0][(crc ^ *data++) & 0xff] ^ (crc >> 8);
  return crc ^ 0xffffffffu;
}

}  // extern "C"
