// Native host-prep kernels for the TPU ECC runtime.
//
// The device does all field/group algebra; what remains on the host for the
// signing path is RFC 6979 nonce derivation — a chain of HMAC-SHA-256 calls
// per signature. Python's per-call hashlib/hmac glue costs ~100us/signature;
// this C++ batch kernel does the whole derivation in-process (~1-2us/sig,
// multithreaded over the batch), the moral equivalent of the reference
// stack's native rfc6979 crate (SURVEY §2.7).
//
// Scope: qlen == 256 bits, SHA-256, no extra data — covers secp256k1, P-256
// and the brainpool-256 twins; other curves fall back to the Python path.
//
// Build: tools-free, compiled on demand by tpu_ecc/native/__init__.py with
//   g++ -O3 -shared -fPIC -pthread fastcrypt.cpp -o fastcrypt.so

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------- SHA-256
const uint32_t K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

inline uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

struct Sha256 {
  uint32_t h[8];
  uint8_t buf[64];
  uint64_t total = 0;
  size_t off = 0;

  Sha256() { reset(); }

  void reset() {
    static const uint32_t init[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372,
                                     0xa54ff53a, 0x510e527f, 0x9b05688c,
                                     0x1f83d9ab, 0x5be0cd19};
    memcpy(h, init, sizeof(h));
    total = 0;
    off = 0;
  }

  void block(const uint8_t* p) {
    uint32_t w[64];
    for (int i = 0; i < 16; i++)
      w[i] = (uint32_t(p[4 * i]) << 24) | (uint32_t(p[4 * i + 1]) << 16) |
             (uint32_t(p[4 * i + 2]) << 8) | uint32_t(p[4 * i + 3]);
    for (int i = 16; i < 64; i++) {
      uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
      uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
             g = h[6], hh = h[7];
    for (int i = 0; i < 64; i++) {
      uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t t1 = hh + S1 + ch + K[i] + w[i];
      uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      uint32_t t2 = S0 + maj;
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }

  void update(const uint8_t* p, size_t len) {
    total += len;
    if (off) {
      size_t take = 64 - off < len ? 64 - off : len;
      memcpy(buf + off, p, take);
      off += take;
      p += take;
      len -= take;
      if (off == 64) { block(buf); off = 0; }
    }
    while (len >= 64) { block(p); p += 64; len -= 64; }
    if (len) { memcpy(buf, p, len); off = len; }
  }

  void final(uint8_t out[32]) {
    uint64_t bits = total * 8;
    uint8_t pad = 0x80;
    update(&pad, 1);
    uint8_t z = 0;
    while (off != 56) update(&z, 1);
    uint8_t lb[8];
    for (int i = 0; i < 8; i++) lb[i] = uint8_t(bits >> (56 - 8 * i));
    update(lb, 8);
    for (int i = 0; i < 8; i++) {
      out[4 * i] = uint8_t(h[i] >> 24);
      out[4 * i + 1] = uint8_t(h[i] >> 16);
      out[4 * i + 2] = uint8_t(h[i] >> 8);
      out[4 * i + 3] = uint8_t(h[i]);
    }
  }
};

// ------------------------------------------------------------------- SM3
// GB/T 32905-2016 (the reference's sm3 crate). 64-byte blocks, 32-byte
// digest, SHA-2-style Merkle-Damgard padding.
inline uint32_t rotl(uint32_t x, int n) {
  n &= 31;
  return n ? (x << n) | (x >> (32 - n)) : x;
}

struct Sm3 {
  uint32_t h[8];
  uint8_t buf[64];
  uint64_t total = 0;
  size_t off = 0;

  Sm3() { reset(); }

  void reset() {
    static const uint32_t init[8] = {0x7380166f, 0x4914b2b9, 0x172442d7,
                                     0xda8a0600, 0xa96f30bc, 0x163138aa,
                                     0xe38dee4d, 0xb0fb0e4e};
    memcpy(h, init, sizeof(h));
    total = 0;
    off = 0;
  }

  static inline uint32_t p0(uint32_t x) { return x ^ rotl(x, 9) ^ rotl(x, 17); }
  static inline uint32_t p1(uint32_t x) { return x ^ rotl(x, 15) ^ rotl(x, 23); }

  void block(const uint8_t* p) {
    uint32_t w[68], wp[64];
    for (int i = 0; i < 16; i++)
      w[i] = (uint32_t(p[4 * i]) << 24) | (uint32_t(p[4 * i + 1]) << 16) |
             (uint32_t(p[4 * i + 2]) << 8) | uint32_t(p[4 * i + 3]);
    for (int i = 16; i < 68; i++)
      w[i] = p1(w[i - 16] ^ w[i - 9] ^ rotl(w[i - 3], 15)) ^
             rotl(w[i - 13], 7) ^ w[i - 6];
    for (int i = 0; i < 64; i++) wp[i] = w[i] ^ w[i + 4];
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
             g = h[6], hh = h[7];
    for (int j = 0; j < 64; j++) {
      uint32_t tj = j < 16 ? 0x79cc4519u : 0x7a879d8au;
      uint32_t ss1 = rotl(rotl(a, 12) + e + rotl(tj, j), 7);
      uint32_t ss2 = ss1 ^ rotl(a, 12);
      uint32_t ff = j < 16 ? (a ^ b ^ c) : ((a & b) | (a & c) | (b & c));
      uint32_t gg = j < 16 ? (e ^ f ^ g) : ((e & f) | (~e & g));
      uint32_t tt1 = ff + d + ss2 + wp[j];
      uint32_t tt2 = gg + hh + ss1 + w[j];
      d = c; c = rotl(b, 9); b = a; a = tt1;
      hh = g; g = rotl(f, 19); f = e; e = p0(tt2);
    }
    h[0] ^= a; h[1] ^= b; h[2] ^= c; h[3] ^= d;
    h[4] ^= e; h[5] ^= f; h[6] ^= g; h[7] ^= hh;
  }

  void update(const uint8_t* p, size_t len) {
    total += len;
    if (off) {
      size_t take = 64 - off < len ? 64 - off : len;
      memcpy(buf + off, p, take);
      off += take;
      p += take;
      len -= take;
      if (off == 64) { block(buf); off = 0; }
    }
    while (len >= 64) { block(p); p += 64; len -= 64; }
    if (len) { memcpy(buf, p, len); off = len; }
  }

  void final(uint8_t out[32]) {
    uint64_t bits = total * 8;
    uint8_t pad = 0x80;
    update(&pad, 1);
    uint8_t z = 0;
    while (off != 56) update(&z, 1);
    uint8_t lb[8];
    for (int i = 0; i < 8; i++) lb[i] = uint8_t(bits >> (56 - 8 * i));
    update(lb, 8);
    for (int i = 0; i < 8; i++) {
      out[4 * i] = uint8_t(h[i] >> 24);
      out[4 * i + 1] = uint8_t(h[i] >> 16);
      out[4 * i + 2] = uint8_t(h[i] >> 8);
      out[4 * i + 3] = uint8_t(h[i]);
    }
  }
};

// ------------------------------------------------------- BelT (belt-hash)
// STB 34.101.31: 128-bit-block cipher + sigma-compression hash (32-byte
// blocks, 32-byte digest, little-endian length block) — the reference's
// belt-hash crate (bign256/src/dsa). Mirrors tpu_ecc/protocols/belt.py,
// which self-tests against the standard's A.1 vector at import; the two
// are asserted equal in tests/test_native.py.
static const uint8_t BELT_H[256] = {
    0xB1, 0x94, 0xBA, 0xC8, 0x0A, 0x08, 0xF5, 0x3B, 0x36, 0x6D, 0x00, 0x8E,
    0x58, 0x4A, 0x5D, 0xE4, 0x85, 0x04, 0xFA, 0x9D, 0x1B, 0xB6, 0xC7, 0xAC,
    0x25, 0x2E, 0x72, 0xC2, 0x02, 0xFD, 0xCE, 0x0D, 0x5B, 0xE3, 0xD6, 0x12,
    0x17, 0xB9, 0x61, 0x81, 0xFE, 0x67, 0x86, 0xAD, 0x71, 0x6B, 0x89, 0x0B,
    0x5C, 0xB0, 0xC0, 0xFF, 0x33, 0xC3, 0x56, 0xB8, 0x35, 0xC4, 0x05, 0xAE,
    0xD8, 0xE0, 0x7F, 0x99, 0xE1, 0x2B, 0xDC, 0x1A, 0xE2, 0x82, 0x57, 0xEC,
    0x70, 0x3F, 0xCC, 0xF0, 0x95, 0xEE, 0x8D, 0xF1, 0xC1, 0xAB, 0x76, 0x38,
    0x9F, 0xE6, 0x78, 0xCA, 0xF7, 0xC6, 0xF8, 0x60, 0xD5, 0xBB, 0x9C, 0x4F,
    0xF3, 0x3C, 0x65, 0x7B, 0x63, 0x7C, 0x30, 0x6A, 0xDD, 0x4E, 0xA7, 0x79,
    0x9E, 0xB2, 0x3D, 0x31, 0x3E, 0x98, 0xB5, 0x6E, 0x27, 0xD3, 0xBC, 0xCF,
    0x59, 0x1E, 0x18, 0x1F, 0x4C, 0x5A, 0xB7, 0x93, 0xE9, 0xDE, 0xE7, 0x2C,
    0x8F, 0x0C, 0x0F, 0xA6, 0x2D, 0xDB, 0x49, 0xF4, 0x6F, 0x73, 0x96, 0x47,
    0x06, 0x07, 0x53, 0x16, 0xED, 0x24, 0x7A, 0x37, 0x39, 0xCB, 0xA3, 0x83,
    0x03, 0xA9, 0x8B, 0xF6, 0x92, 0xBD, 0x9B, 0x1C, 0xE5, 0xD1, 0x41, 0x01,
    0x54, 0x45, 0xFB, 0xC9, 0x5E, 0x4D, 0x0E, 0xF2, 0x68, 0x20, 0x80, 0xAA,
    0x22, 0x7D, 0x64, 0x2F, 0x26, 0x87, 0xF9, 0x34, 0x90, 0x40, 0x55, 0x11,
    0xBE, 0x32, 0x97, 0x13, 0x43, 0xFC, 0x9A, 0x48, 0xA0, 0x2A, 0x88, 0x5F,
    0x19, 0x4B, 0x09, 0xA1, 0x7E, 0xCD, 0xA4, 0xD0, 0x15, 0x44, 0xAF, 0x8C,
    0xA5, 0x84, 0x50, 0xBF, 0x66, 0xD2, 0xE8, 0x8A, 0xA2, 0xD7, 0x46, 0x52,
    0x42, 0xA8, 0xDF, 0xB3, 0x69, 0x74, 0xC5, 0x51, 0xEB, 0x23, 0x29, 0x21,
    0xD4, 0xEF, 0xD9, 0xB4, 0x3A, 0x62, 0x28, 0x75, 0x91, 0x14, 0x10, 0xEA,
    0x77, 0x6C, 0xDA, 0x1D};

inline uint32_t belt_g(uint32_t x, int r) {
  uint32_t y = uint32_t(BELT_H[x & 0xff]) |
               (uint32_t(BELT_H[(x >> 8) & 0xff]) << 8) |
               (uint32_t(BELT_H[(x >> 16) & 0xff]) << 16) |
               (uint32_t(BELT_H[(x >> 24) & 0xff]) << 24);
  return rotl(y, r);
}

inline uint32_t le32(const uint8_t* p) {
  return uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) |
         (uint32_t(p[3]) << 24);
}

inline void st32(uint8_t* p, uint32_t v) {
  p[0] = uint8_t(v); p[1] = uint8_t(v >> 8);
  p[2] = uint8_t(v >> 16); p[3] = uint8_t(v >> 24);
}

// BelT block encryption, STB 34.101.31 §6.1 (mirrors belt.py
// belt_block_encrypt, incl. the final word permutation b,d,a,c).
void belt_block(const uint8_t in[16], const uint8_t key[32], uint8_t out[16]) {
  uint32_t a = le32(in), b = le32(in + 4), c = le32(in + 8), d = le32(in + 12);
  uint32_t k[8];
  for (int i = 0; i < 8; i++) k[i] = le32(key + 4 * i);
  for (int i = 1; i <= 8; i++) {
    b ^= belt_g(a + k[(7 * i - 7) % 8], 5);
    c ^= belt_g(d + k[(7 * i - 6) % 8], 21);
    a -= belt_g(b + k[(7 * i - 5) % 8], 13);
    uint32_t e = belt_g(b + c + k[(7 * i - 4) % 8], 21) ^ uint32_t(i);
    b += e;
    c -= e;
    d += belt_g(c + k[(7 * i - 3) % 8], 13);
    b ^= belt_g(a + k[(7 * i - 2) % 8], 21);
    c ^= belt_g(d + k[(7 * i - 1) % 8], 5);
    uint32_t t = a; a = b; b = t;   // a <-> b
    t = c; c = d; d = t;            // c <-> d
    t = b; b = c; c = t;            // b <-> c
  }
  st32(out, b); st32(out + 4, d); st32(out + 8, a); st32(out + 12, c);
}

inline void xor16(uint8_t* o, const uint8_t* a, const uint8_t* b) {
  for (int i = 0; i < 16; i++) o[i] = a[i] ^ b[i];
}

// sigma compression (§6.9): (X1||X2, X3||X4) -> (s, Y1||Y2)
void belt_compress(const uint8_t x12[32], const uint8_t x34[32],
                   uint8_t s_out[16], uint8_t y_out[32]) {
  const uint8_t *x1 = x12, *x2 = x12 + 16, *x3 = x34, *x4 = x34 + 16;
  uint8_t t[16], e[16];
  xor16(t, x3, x4);
  belt_block(t, x12, e);            // F(X3^X4, X1||X2)
  xor16(s_out, e, t);               // ^ X3 ^ X4
  uint8_t key[32];
  memcpy(key, s_out, 16);
  memcpy(key + 16, x4, 16);
  belt_block(x1, key, e);
  xor16(y_out, e, x1);
  for (int i = 0; i < 16; i++) key[i] = s_out[i] ^ 0xff;
  memcpy(key + 16, x3, 16);
  belt_block(x2, key, e);
  xor16(y_out + 16, e, x2);
}

struct BeltHash {
  uint8_t s[16];
  uint8_t h[32];
  uint8_t buf[32];
  uint64_t total = 0;
  size_t off = 0;

  BeltHash() { reset(); }

  void reset() {
    static const uint8_t iv[32] = {
        0xb1, 0x94, 0xba, 0xc8, 0x0a, 0x08, 0xf5, 0x3b, 0x36, 0x6d, 0x00,
        0x8e, 0x58, 0x4a, 0x5d, 0xe4, 0x85, 0x04, 0xfa, 0x9d, 0x1b, 0xb6,
        0xc7, 0xac, 0x25, 0x2e, 0x72, 0xc2, 0x02, 0xfd, 0xce, 0x0d};
    memset(s, 0, 16);
    memcpy(h, iv, 32);
    total = 0;
    off = 0;
  }

  void block(const uint8_t* p) {
    uint8_t s1[16], y[32];
    belt_compress(p, h, s1, y);
    memcpy(h, y, 32);
    for (int i = 0; i < 16; i++) s[i] ^= s1[i];
  }

  void update(const uint8_t* p, size_t len) {
    total += len;
    if (off) {
      size_t take = 32 - off < len ? 32 - off : len;
      memcpy(buf + off, p, take);
      off += take;
      p += take;
      len -= take;
      if (off == 32) { block(buf); off = 0; }
    }
    while (len >= 32) { block(p); p += 32; len -= 32; }
    if (len) { memcpy(buf, p, len); off = len; }
  }

  void final(uint8_t out[32]) {
    if (off) {
      memset(buf + off, 0, 32 - off);
      block(buf);
      off = 0;
    }
    uint8_t x12[32];
    uint64_t bits = total * 8;
    for (int i = 0; i < 8; i++) x12[i] = uint8_t(bits >> (8 * i));  // LE
    memset(x12 + 8, 0, 8);
    memcpy(x12 + 16, s, 16);
    uint8_t s1[16];
    belt_compress(x12, h, s1, out);
  }
};

// HMAC over any of the 32-byte-digest hashes above; BLOCK is the hash's
// block size (64 for SHA-256/SM3, 32 for belt-hash — matching Python
// hmac's use of the digest class's block_size). RFC 6979 keys are 32
// bytes, never longer than BLOCK.
template <typename H, int BLOCK>
struct HmacT {
  uint8_t kpad[BLOCK];

  void setkey(const uint8_t* key, size_t klen) {
    memset(kpad, 0, BLOCK);
    memcpy(kpad, key, klen);
  }

  void mac(const uint8_t* const* parts, const size_t* lens, int nparts,
           uint8_t out[32]) {
    uint8_t pad[BLOCK];
    H inner;
    for (int i = 0; i < BLOCK; i++) pad[i] = kpad[i] ^ 0x36;
    inner.update(pad, BLOCK);
    for (int i = 0; i < nparts; i++) inner.update(parts[i], lens[i]);
    uint8_t ih[32];
    inner.final(ih);
    H outer;
    for (int i = 0; i < BLOCK; i++) pad[i] = kpad[i] ^ 0x5c;
    outer.update(pad, BLOCK);
    outer.update(ih, 32);
    outer.final(out);
  }
};

using Hmac = HmacT<Sha256, 64>;

// big-endian fixed-width helpers (32 bytes)
inline int cmp32(const uint8_t* a, const uint8_t* b) { return memcmp(a, b, 32); }

inline void sub32(uint8_t* a, const uint8_t* b) {  // a -= b (a >= b)
  int borrow = 0;
  for (int i = 31; i >= 0; i--) {
    int v = int(a[i]) - int(b[i]) - borrow;
    borrow = v < 0;
    a[i] = uint8_t(v & 0xff);
  }
}

inline bool is_zero32(const uint8_t* a) {
  uint8_t acc = 0;
  for (int i = 0; i < 32; i++) acc |= a[i];
  return acc == 0;
}

template <typename HM>
void derive_one(const uint8_t* q, const uint8_t* x, const uint8_t* h1,
                uint8_t* out) {
  // seed = int2octets(x) || bits2octets(h1); qlen == hlen*8 == 256
  uint8_t seed[64];
  memcpy(seed, x, 32);
  memcpy(seed + 32, h1, 32);
  if (cmp32(seed + 32, q) >= 0) sub32(seed + 32, q);

  uint8_t V[32], Kk[32], tag;
  memset(V, 0x01, 32);
  memset(Kk, 0x00, 32);
  HM hm;

  const uint8_t* parts[3];
  size_t lens[3];

  // K = HMAC(K, V || 0x00 || seed); V = HMAC(K, V)
  hm.setkey(Kk, 32);
  tag = 0x00;
  parts[0] = V; lens[0] = 32;
  parts[1] = &tag; lens[1] = 1;
  parts[2] = seed; lens[2] = 64;
  hm.mac(parts, lens, 3, Kk);
  hm.setkey(Kk, 32);
  hm.mac(parts, lens, 1, V);
  // K = HMAC(K, V || 0x01 || seed); V = HMAC(K, V)
  tag = 0x01;
  hm.mac(parts, lens, 3, Kk);
  hm.setkey(Kk, 32);
  hm.mac(parts, lens, 1, V);

  for (;;) {
    hm.mac(parts, lens, 1, V);  // V = HMAC(K, V); T = V (qlen == hlen*8)
    if (!is_zero32(V) && cmp32(V, q) < 0) {
      memcpy(out, V, 32);
      return;
    }
    tag = 0x00;
    hm.mac(parts, lens, 2, Kk);  // K = HMAC(K, V || 0x00)
    hm.setkey(Kk, 32);
    hm.mac(parts, lens, 1, V);
  }
}

// Run fn(b) for b in [0, B) across up to 8 threads (batch-parallel host
// prep — the moral equivalent of the reference caller's per-core loop).
template <typename F>
void par_for(int32_t B, F fn) {
  int nt = int(std::thread::hardware_concurrency());
  if (nt < 1) nt = 1;
  if (nt > 8) nt = 8;
  if (B < 64 || nt == 1) {
    for (int32_t b = 0; b < B; b++) fn(b);
    return;
  }
  std::vector<std::thread> ts;
  int32_t chunk = (B + nt - 1) / nt;
  for (int t = 0; t < nt; t++) {
    int32_t lo = t * chunk, hi = lo + chunk < B ? lo + chunk : B;
    if (lo >= hi) break;
    ts.emplace_back([=] {
      for (int32_t b = lo; b < hi; b++) fn(b);
    });
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// out[b] = RFC6979 k for (q, x[b], h1[b]); all 32-byte big-endian rows.
void rfc6979_k_sha256_batch(const uint8_t* q, const uint8_t* x,
                            const uint8_t* h1, uint8_t* out, int32_t B) {
  par_for(B, [=](int32_t b) {
    derive_one<Hmac>(q, x + 32 * b, h1 + 32 * b, out + 32 * b);
  });
}

// Same derivation with HMAC-SM3 (the reference's RFC6979-SM3 for SM2-DSA,
// sm2/src/dsa/signing.rs:196-201).
void rfc6979_k_sm3_batch(const uint8_t* q, const uint8_t* x,
                         const uint8_t* h1, uint8_t* out, int32_t B) {
  par_for(B, [=](int32_t b) {
    derive_one<HmacT<Sm3, 64>>(q, x + 32 * b, h1 + 32 * b, out + 32 * b);
  });
}

// Same derivation with HMAC-BeltHash (bign256/src/dsa/signing.rs:117;
// belt-hash's HMAC block size is its 32-byte digest/block size).
void rfc6979_k_belt_batch(const uint8_t* q, const uint8_t* x,
                          const uint8_t* h1, uint8_t* out, int32_t B) {
  par_for(B, [=](int32_t b) {
    derive_one<HmacT<BeltHash, 32>>(q, x + 32 * b, h1 + 32 * b,
                                    out + 32 * b);
  });
}

// Batched SHA-256 over fixed-size messages (e.g. 32-byte prehash rows).
void sha256_batch(const uint8_t* msgs, int32_t msg_len, uint8_t* out,
                  int32_t B) {
  par_for(B, [=](int32_t b) {
    Sha256 s;
    s.update(msgs + size_t(msg_len) * b, size_t(msg_len));
    s.final(out + 32 * b);
  });
}

// Batched SM3 over fixed-size messages (SM2's e = SM3(Z_A || M)).
void sm3_batch(const uint8_t* msgs, int32_t msg_len, uint8_t* out,
               int32_t B) {
  par_for(B, [=](int32_t b) {
    Sm3 s;
    s.update(msgs + size_t(msg_len) * b, size_t(msg_len));
    s.final(out + 32 * b);
  });
}

// Batched belt-hash over variable-length messages: offsets[B+1] delimits
// message b as buf[offsets[b] : offsets[b+1]] (bign's OID||R||H inputs).
void belt_hash_batch(const uint8_t* buf, const int64_t* offsets, uint8_t* out,
                     int32_t B) {
  par_for(B, [=](int32_t b) {
    BeltHash h;
    h.update(buf + offsets[b], size_t(offsets[b + 1] - offsets[b]));
    h.final(out + 32 * b);
  });
}

}  // extern "C"
