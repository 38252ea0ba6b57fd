// XChaCha20-Poly1305 AEAD — the native cipher backend.
//
// The reference delegates to the Rust chacha20poly1305 crate
// (crdt-enc-xchacha20poly1305/src/lib.rs:40-102); this environment has no
// Rust toolchain and its Python `cryptography` wheel exposes only the IETF
// 12-byte-nonce ChaCha20Poly1305, so the XChaCha construction (HChaCha20
// subkey derivation + ChaCha20-Poly1305, draft-irtf-cfrg-xchacha) is
// implemented here from RFC 8439 primitives.  The port's copy of the JAX
// package's source, cut to the six entry points the port binds: the
// one-blob seal and open in both nonce sizes, and the batch parse and
// decrypt.
//
// Exposed via a plain C ABI for ctypes (pure C, no Python API).  The batch
// entry points let the bulk decrypt front end amortize FFI overhead across
// thousands of blobs.

#include <cstdint>
#include <cstring>
#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>
#endif
#include <array>
#include <thread>
#include <vector>

namespace {

inline uint32_t rotl32(uint32_t x, int n) { return (x << n) | (x >> (32 - n)); }

inline uint32_t load32_le(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

inline void store32_le(uint8_t* p, uint32_t v) {
  p[0] = (uint8_t)v;
  p[1] = (uint8_t)(v >> 8);
  p[2] = (uint8_t)(v >> 16);
  p[3] = (uint8_t)(v >> 24);
}

inline void store64_le(uint8_t* p, uint64_t v) {
  store32_le(p, (uint32_t)v);
  store32_le(p + 4, (uint32_t)(v >> 32));
}

#define QR(a, b, c, d)      \
  a += b; d ^= a; d = rotl32(d, 16); \
  c += d; b ^= c; b = rotl32(b, 12); \
  a += b; d ^= a; d = rotl32(d, 8);  \
  c += d; b ^= c; b = rotl32(b, 7);

void chacha20_rounds(uint32_t s[16]) {
  for (int i = 0; i < 10; i++) {
    QR(s[0], s[4], s[8], s[12])
    QR(s[1], s[5], s[9], s[13])
    QR(s[2], s[6], s[10], s[14])
    QR(s[3], s[7], s[11], s[15])
    QR(s[0], s[5], s[10], s[15])
    QR(s[1], s[6], s[11], s[12])
    QR(s[2], s[7], s[8], s[13])
    QR(s[3], s[4], s[9], s[14])
  }
}

const uint32_t SIGMA[4] = {0x61707865, 0x3320646e, 0x79622d32, 0x6b206574};

// RFC 8439 §2.3: one 64-byte keystream block.
void chacha20_block(const uint8_t key[32], uint32_t counter,
                    const uint8_t nonce[12], uint8_t out[64]) {
  uint32_t init[16], s[16];
  for (int i = 0; i < 4; i++) init[i] = SIGMA[i];
  for (int i = 0; i < 8; i++) init[4 + i] = load32_le(key + 4 * i);
  init[12] = counter;
  for (int i = 0; i < 3; i++) init[13 + i] = load32_le(nonce + 4 * i);
  memcpy(s, init, sizeof(s));
  chacha20_rounds(s);
  for (int i = 0; i < 16; i++) store32_le(out + 4 * i, s[i] + init[i]);
}

// 8 independent keystream blocks with the state in GCC vector-extension
// registers (one v8u per ChaCha word, lanes = consecutive block
// counters): every quarter-round statement is a single elementwise
// vector op, which gcc/clang lower to AVX2/AVX-512 under -march=native —
// auto-vectorization of the equivalent scalar lane loops was observed to
// fail (no vector shifts emitted), so the SIMD shape is made explicit.
constexpr int LANES = 8;
typedef uint32_t v8u __attribute__((vector_size(4 * LANES)));

static inline v8u rotlv(v8u x, int n) {
  return (x << n) | (x >> (32 - n));
}

void chacha20_xor_lanes(const uint8_t key[32], uint32_t counter,
                        const uint8_t nonce[12], const uint8_t* in,
                        uint8_t* out) {
  uint32_t init[16];
  for (int i = 0; i < 4; i++) init[i] = SIGMA[i];
  for (int i = 0; i < 8; i++) init[4 + i] = load32_le(key + 4 * i);
  init[12] = counter;
  for (int i = 0; i < 3; i++) init[13 + i] = load32_le(nonce + 4 * i);

  v8u x[16];
  for (int i = 0; i < 16; i++)
    for (int j = 0; j < LANES; j++) x[i][j] = init[i];
  for (int j = 0; j < LANES; j++) x[12][j] = counter + (uint32_t)j;

#define QRV(a, b, c, d)                                      \
  x[a] += x[b]; x[d] ^= x[a]; x[d] = rotlv(x[d], 16);        \
  x[c] += x[d]; x[b] ^= x[c]; x[b] = rotlv(x[b], 12);        \
  x[a] += x[b]; x[d] ^= x[a]; x[d] = rotlv(x[d], 8);         \
  x[c] += x[d]; x[b] ^= x[c]; x[b] = rotlv(x[b], 7);

  for (int r = 0; r < 10; r++) {
    QRV(0, 4, 8, 12)
    QRV(1, 5, 9, 13)
    QRV(2, 6, 10, 14)
    QRV(3, 7, 11, 15)
    QRV(0, 5, 10, 15)
    QRV(1, 6, 11, 12)
    QRV(2, 7, 8, 13)
    QRV(3, 4, 9, 14)
  }
#undef QRV

  for (int j = 0; j < LANES; j++) {
    const uint8_t* src = in + (uint64_t)j * 64;
    uint8_t* dst = out + (uint64_t)j * 64;
    for (int i = 0; i < 16; i++) {
      uint32_t word = x[i][j] + init[i] + (i == 12 ? (uint32_t)j : 0);
      store32_le(dst + 4 * i, load32_le(src + 4 * i) ^ word);
    }
  }
}

// 16 independent keystream blocks in 512-bit vectors (zmm under
// -march=native on this AVX-512 host), with the block-major output
// produced by an in-register 16x16 u32 butterfly transpose instead of
// the 8-lane path's 128 scalar stores per group.  The transpose rule is
// the standard 4-stage interleave; masks were generated and verified by
// simulation (each stage s pairs registers i and i+2^s and interleaves
// 2^s-element chunks).
constexpr int LANES16 = 16;
typedef uint32_t v16u __attribute__((vector_size(4 * LANES16)));

static inline v16u rotlv16(v16u x, int n) {
  return (x << n) | (x >> (32 - n));
}

#if defined(__clang__) || (defined(__GNUC__) && __GNUC__ >= 12)
#define SHUF16(a, b, ...) __builtin_shufflevector(a, b, __VA_ARGS__)
#else
// GCC < 12 has no __builtin_shufflevector; its __builtin_shuffle
// two-vector form has the same concatenated-index semantics with the
// indices packed into an integer mask vector.  Same codegen class
// (vperm*); the AEAD tests cross-check against the `cryptography`
// wheel, so a semantic slip here cannot pass CI.
#define SHUF16(a, b, ...) __builtin_shuffle(a, b, (v16u){__VA_ARGS__})
#endif

static inline void transpose16(v16u x[16]) {
  v16u t[16];
  // stage 0 (step 1)
  for (int i = 0; i < 16; i += 2) {
    v16u a = x[i], b = x[i + 1];
    t[i] = SHUF16(a, b, 0, 16, 2, 18, 4, 20, 6, 22, 8, 24, 10, 26, 12, 28,
                  14, 30);
    t[i + 1] = SHUF16(a, b, 1, 17, 3, 19, 5, 21, 7, 23, 9, 25, 11, 27, 13,
                      29, 15, 31);
  }
  // stage 1 (step 2)
  for (int g = 0; g < 16; g += 4)
    for (int i = g; i < g + 2; i++) {
      v16u a = t[i], b = t[i + 2];
      x[i] = SHUF16(a, b, 0, 1, 16, 17, 4, 5, 20, 21, 8, 9, 24, 25, 12, 13,
                    28, 29);
      x[i + 2] = SHUF16(a, b, 2, 3, 18, 19, 6, 7, 22, 23, 10, 11, 26, 27,
                        14, 15, 30, 31);
    }
  // stage 2 (step 4)
  for (int g = 0; g < 16; g += 8)
    for (int i = g; i < g + 4; i++) {
      v16u a = x[i], b = x[i + 4];
      t[i] = SHUF16(a, b, 0, 1, 2, 3, 16, 17, 18, 19, 8, 9, 10, 11, 24, 25,
                    26, 27);
      t[i + 4] = SHUF16(a, b, 4, 5, 6, 7, 20, 21, 22, 23, 12, 13, 14, 15,
                        28, 29, 30, 31);
    }
  // stage 3 (step 8)
  for (int i = 0; i < 8; i++) {
    v16u a = t[i], b = t[i + 8];
    x[i] = SHUF16(a, b, 0, 1, 2, 3, 4, 5, 6, 7, 16, 17, 18, 19, 20, 21, 22,
                  23);
    x[i + 8] = SHUF16(a, b, 8, 9, 10, 11, 12, 13, 14, 15, 24, 25, 26, 27,
                      28, 29, 30, 31);
  }
}

void chacha20_xor_lanes16(const uint8_t key[32], uint32_t counter,
                          const uint8_t nonce[12], const uint8_t* in,
                          uint8_t* out) {
  uint32_t init[16];
  for (int i = 0; i < 4; i++) init[i] = SIGMA[i];
  for (int i = 0; i < 8; i++) init[4 + i] = load32_le(key + 4 * i);
  init[12] = counter;
  for (int i = 0; i < 3; i++) init[13 + i] = load32_le(nonce + 4 * i);

  v16u x[16], iv[16];
  for (int i = 0; i < 16; i++)
    for (int j = 0; j < LANES16; j++) iv[i][j] = init[i];
  for (int j = 0; j < LANES16; j++) iv[12][j] = counter + (uint32_t)j;
  for (int i = 0; i < 16; i++) x[i] = iv[i];

#define QRV16(a, b, c, d)                                    \
  x[a] += x[b]; x[d] ^= x[a]; x[d] = rotlv16(x[d], 16);      \
  x[c] += x[d]; x[b] ^= x[c]; x[b] = rotlv16(x[b], 12);      \
  x[a] += x[b]; x[d] ^= x[a]; x[d] = rotlv16(x[d], 8);       \
  x[c] += x[d]; x[b] ^= x[c]; x[b] = rotlv16(x[b], 7);

  for (int r = 0; r < 10; r++) {
    QRV16(0, 4, 8, 12)
    QRV16(1, 5, 9, 13)
    QRV16(2, 6, 10, 14)
    QRV16(3, 7, 11, 15)
    QRV16(0, 5, 10, 15)
    QRV16(1, 6, 11, 12)
    QRV16(2, 7, 8, 13)
    QRV16(3, 4, 9, 14)
  }
#undef QRV16

  for (int i = 0; i < 16; i++) x[i] += iv[i];
  transpose16(x);  // x[j] now holds block j's 16 words
  for (int j = 0; j < LANES16; j++) {
    v16u m;
    memcpy(&m, in + (uint64_t)j * 64, 64);
    m ^= x[j];
    memcpy(out + (uint64_t)j * 64, &m, 64);
  }
}

// 4 independent keystream blocks in 128-bit vectors — the guaranteed
// SIMD baseline (SSE2 on any x86-64, NEON q-registers on aarch64): one
// xmm/q register per ChaCha word.  This is the widest shape that never
// needs an ISA the build target might lack, so it is the runtime
// dispatcher's floor before the scalar tail.
constexpr int LANES4 = 4;
typedef uint32_t v4u __attribute__((vector_size(4 * LANES4)));

static inline v4u rotlv4(v4u x, int n) {
  return (x << n) | (x >> (32 - n));
}

void chacha20_xor_lanes4(const uint8_t key[32], uint32_t counter,
                         const uint8_t nonce[12], const uint8_t* in,
                         uint8_t* out) {
  uint32_t init[16];
  for (int i = 0; i < 4; i++) init[i] = SIGMA[i];
  for (int i = 0; i < 8; i++) init[4 + i] = load32_le(key + 4 * i);
  init[12] = counter;
  for (int i = 0; i < 3; i++) init[13 + i] = load32_le(nonce + 4 * i);

  v4u x[16];
  for (int i = 0; i < 16; i++)
    for (int j = 0; j < LANES4; j++) x[i][j] = init[i];
  for (int j = 0; j < LANES4; j++) x[12][j] = counter + (uint32_t)j;

#define QRV4(a, b, c, d)                                     \
  x[a] += x[b]; x[d] ^= x[a]; x[d] = rotlv4(x[d], 16);       \
  x[c] += x[d]; x[b] ^= x[c]; x[b] = rotlv4(x[b], 12);       \
  x[a] += x[b]; x[d] ^= x[a]; x[d] = rotlv4(x[d], 8);        \
  x[c] += x[d]; x[b] ^= x[c]; x[b] = rotlv4(x[b], 7);

  for (int r = 0; r < 10; r++) {
    QRV4(0, 4, 8, 12)
    QRV4(1, 5, 9, 13)
    QRV4(2, 6, 10, 14)
    QRV4(3, 7, 11, 15)
    QRV4(0, 5, 10, 15)
    QRV4(1, 6, 11, 12)
    QRV4(2, 7, 8, 13)
    QRV4(3, 4, 9, 14)
  }
#undef QRV4

  for (int j = 0; j < LANES4; j++) {
    const uint8_t* src = in + (uint64_t)j * 64;
    uint8_t* dst = out + (uint64_t)j * 64;
    for (int i = 0; i < 16; i++) {
      uint32_t word = x[i][j] + init[i] + (i == 12 ? (uint32_t)j : 0);
      store32_le(dst + 4 * i, load32_le(src + 4 * i) ^ word);
    }
  }
}

// Runtime SIMD dispatch: the usable lane width is the MIN of what this
// translation unit was compiled for (wider vector-extension code may
// contain instructions the build ISA allows) and what the running CPU
// actually supports — a build/ copied from an AVX-512 box must degrade
// to the 8/4-lane loops on an AVX2/SSE2 host instead of faulting.  On
// non-x86 the compile-time width is authoritative (vector extensions
// lower to the target baseline, NEON on aarch64).
static int simd_lanes_detect() {
  int compiled = LANES4;
#if defined(__AVX512F__) && defined(__AVX512BW__)
  compiled = LANES16;
#elif defined(__AVX2__)
  compiled = LANES;
#endif
  int runtime = compiled;
#if (defined(__x86_64__) || defined(__i386__)) && defined(__GNUC__)
  __builtin_cpu_init();
  if (__builtin_cpu_supports("avx512f") && __builtin_cpu_supports("avx512bw"))
    runtime = LANES16;
  else if (__builtin_cpu_supports("avx2"))
    runtime = LANES;
  else
    runtime = LANES4;
#endif
  return runtime < compiled ? runtime : compiled;
}

static const int SIMD_LANES = simd_lanes_detect();

void chacha20_xor(const uint8_t key[32], uint32_t counter,
                  const uint8_t nonce[12], const uint8_t* in, uint8_t* out,
                  uint64_t len) {
  while (SIMD_LANES >= LANES16 && len >= 64 * LANES16) {
    chacha20_xor_lanes16(key, counter, nonce, in, out);
    counter += LANES16;
    in += 64 * LANES16;
    out += 64 * LANES16;
    len -= 64 * LANES16;
  }
  while (SIMD_LANES >= LANES && len >= 64 * LANES) {
    chacha20_xor_lanes(key, counter, nonce, in, out);
    counter += LANES;
    in += 64 * LANES;
    out += 64 * LANES;
    len -= 64 * LANES;
  }
  while (len >= 64 * LANES4) {
    chacha20_xor_lanes4(key, counter, nonce, in, out);
    counter += LANES4;
    in += 64 * LANES4;
    out += 64 * LANES4;
    len -= 64 * LANES4;
  }
  uint8_t block[64];
  while (len > 0) {
    chacha20_block(key, counter++, nonce, block);
    uint64_t n = len < 64 ? len : 64;
    for (uint64_t i = 0; i < n; i++) out[i] = in[i] ^ block[i];
    in += n;
    out += n;
    len -= n;
  }
}

// draft-irtf-cfrg-xchacha §2.2: rounds over const|key|nonce16, no final
// add; subkey = words 0..3 and 12..15.
void hchacha20_impl(const uint8_t key[32], const uint8_t nonce16[16],
                    uint8_t out32[32]) {
  uint32_t s[16];
  for (int i = 0; i < 4; i++) s[i] = SIGMA[i];
  for (int i = 0; i < 8; i++) s[4 + i] = load32_le(key + 4 * i);
  for (int i = 0; i < 4; i++) s[12 + i] = load32_le(nonce16 + 4 * i);
  chacha20_rounds(s);
  for (int i = 0; i < 4; i++) store32_le(out32 + 4 * i, s[i]);
  for (int i = 0; i < 4; i++) store32_le(out32 + 16 + 4 * i, s[12 + i]);
}

// ---- Poly1305 (RFC 8439 §2.5), radix-2^44 limbs ------------------------
//
// Three 44/44/42-bit limbs with 64x64->128 products (9 multiplies per
// 16-byte block vs 25 in the 26-bit-limb form this replaced; measured
// ~2x on this core).  Same streaming API: partial tails buffer across
// update() calls like a hash object.

struct Poly1305 {
  uint64_t r0, r1, r2;
  uint64_t h0 = 0, h1 = 0, h2 = 0;
  uint64_t s1, s2;  // 20*r1, 20*r2 (2^130 = 5 mod p, limbs carry 2^132)
  uint64_t pad0, pad1;
  uint8_t buf[16];
  unsigned buflen = 0;

  static inline uint64_t load64(const uint8_t* p) {
    uint64_t v;
    memcpy(&v, p, 8);
    return v;  // little-endian host (x86)
  }

  // r^2 limbs for the two-block interleave: h' = (h+m1)*r^2 + m2*r
  uint64_t q0, q1, q2, qs1, qs2;

  void init(const uint8_t key[32]) {
    const uint64_t m44 = 0xfffffffffffULL, m42 = 0x3ffffffffffULL;
    uint64_t t0 = load64(key), t1 = load64(key + 8);
    // clamp per spec: r &= 0x0ffffffc0ffffffc0ffffffc0fffffff
    t0 &= 0x0ffffffc0fffffffULL;
    t1 &= 0x0ffffffc0ffffffcULL;
    r0 = t0 & m44;
    r1 = ((t0 >> 44) | (t1 << 20)) & m44;
    r2 = t1 >> 24;  // 40 bits
    s1 = r1 * 20;
    s2 = r2 * 20;
    h0 = h1 = h2 = 0;
    pad0 = load64(key + 16);
    pad1 = load64(key + 24);
    buflen = 0;
    // q = r^2 mod p (same reduction as block())
    using u128 = unsigned __int128;
    u128 d0 = (u128)r0 * r0 + (u128)r1 * s2 + (u128)r2 * s1;
    u128 d1 = (u128)r0 * r1 + (u128)r1 * r0 + (u128)r2 * s2;
    u128 d2 = (u128)r0 * r2 + (u128)r1 * r1 + (u128)r2 * r0;
    uint64_t c;
    c = (uint64_t)(d0 >> 44); q0 = (uint64_t)d0 & m44; d1 += c;
    c = (uint64_t)(d1 >> 44); q1 = (uint64_t)d1 & m44; d2 += c;
    c = (uint64_t)(d2 >> 42); q2 = (uint64_t)d2 & m42;
    q0 += c * 5;
    c = q0 >> 44; q0 &= m44; q1 += c;
    qs1 = q1 * 20;
    qs2 = q2 * 20;
  }

  // Two blocks per reduction: h = (h + m1)·r² + m2·r.  The two limb
  // products are independent, so the multiplier pipeline overlaps them
  // and the carry chain runs once per 32 bytes instead of per 16.
  void block2(const uint8_t* m) {
    const uint64_t m44 = 0xfffffffffffULL, m42 = 0x3ffffffffffULL;
    uint64_t a0 = load64(m), a1 = load64(m + 8);
    uint64_t b0 = load64(m + 16), b1 = load64(m + 24);
    uint64_t x0 = h0 + (a0 & m44);
    uint64_t x1 = h1 + (((a0 >> 44) | (a1 << 20)) & m44);
    uint64_t x2 = h2 + (((a1 >> 24) & m42) | (1ULL << 40));
    uint64_t y0 = b0 & m44;
    uint64_t y1 = ((b0 >> 44) | (b1 << 20)) & m44;
    uint64_t y2 = ((b1 >> 24) & m42) | (1ULL << 40);

    using u128 = unsigned __int128;
    u128 d0 = (u128)x0 * q0 + (u128)x1 * qs2 + (u128)x2 * qs1
            + (u128)y0 * r0 + (u128)y1 * s2 + (u128)y2 * s1;
    u128 d1 = (u128)x0 * q1 + (u128)x1 * q0 + (u128)x2 * qs2
            + (u128)y0 * r1 + (u128)y1 * r0 + (u128)y2 * s2;
    u128 d2 = (u128)x0 * q2 + (u128)x1 * q1 + (u128)x2 * q0
            + (u128)y0 * r2 + (u128)y1 * r1 + (u128)y2 * r0;

    uint64_t c;
    c = (uint64_t)(d0 >> 44); h0 = (uint64_t)d0 & m44; d1 += c;
    c = (uint64_t)(d1 >> 44); h1 = (uint64_t)d1 & m44; d2 += c;
    c = (uint64_t)(d2 >> 42); h2 = (uint64_t)d2 & m42;
    h0 += c * 5;
    c = h0 >> 44; h0 &= m44; h1 += c;
  }

  void block(const uint8_t* m, uint64_t hibit /* 1 = full block, 0 = final partial */) {
    const uint64_t m44 = 0xfffffffffffULL, m42 = 0x3ffffffffffULL;
    uint64_t t0 = load64(m), t1 = load64(m + 8);
    h0 += t0 & m44;
    h1 += ((t0 >> 44) | (t1 << 20)) & m44;
    h2 += ((t1 >> 24) & m42) | (hibit << 40);

    using u128 = unsigned __int128;
    u128 d0 = (u128)h0 * r0 + (u128)h1 * s2 + (u128)h2 * s1;
    u128 d1 = (u128)h0 * r1 + (u128)h1 * r0 + (u128)h2 * s2;
    u128 d2 = (u128)h0 * r2 + (u128)h1 * r1 + (u128)h2 * r0;

    uint64_t c;
    c = (uint64_t)(d0 >> 44); h0 = (uint64_t)d0 & m44; d1 += c;
    c = (uint64_t)(d1 >> 44); h1 = (uint64_t)d1 & m44; d2 += c;
    c = (uint64_t)(d2 >> 42); h2 = (uint64_t)d2 & m42;
    h0 += c * 5;
    c = h0 >> 44; h0 &= m44; h1 += c;
  }

  // Streaming update: partial tails are buffered, NOT finalized — multiple
  // update() calls concatenate, exactly like a hash object.
  void update(const uint8_t* m, uint64_t len) {
    if (buflen) {
      uint64_t want = 16 - buflen;
      uint64_t take = len < want ? len : want;
      memcpy(buf + buflen, m, take);
      buflen += (unsigned)take;
      m += take;
      len -= take;
      if (buflen < 16) return;
      block(buf, 1);
      buflen = 0;
    }
    while (len >= 32) {
      block2(m);
      m += 32;
      len -= 32;
    }
    while (len >= 16) {
      block(m, 1);
      m += 16;
      len -= 16;
    }
    if (len) {
      memcpy(buf, m, len);
      buflen = (unsigned)len;
    }
  }

  void finish(uint8_t tag[16]) {
    const uint64_t m44 = 0xfffffffffffULL, m42 = 0x3ffffffffffULL;
    if (buflen) {  // final partial block: append 0x01, zero-fill, no hibit
      buf[buflen] = 1;
      for (unsigned i = buflen + 1; i < 16; i++) buf[i] = 0;
      block(buf, 0);
      buflen = 0;
    }
    // full carry propagation
    uint64_t c;
    c = h1 >> 44; h1 &= m44; h2 += c;
    c = h2 >> 42; h2 &= m42; h0 += c * 5;
    c = h0 >> 44; h0 &= m44; h1 += c;
    c = h1 >> 44; h1 &= m44; h2 += c;
    c = h2 >> 42; h2 &= m42; h0 += c * 5;
    c = h0 >> 44; h0 &= m44; h1 += c;

    // g = h - p = h + 5 - 2^130; select g when h >= p (no borrow out)
    uint64_t g0 = h0 + 5;
    c = g0 >> 44; g0 &= m44;
    uint64_t g1 = h1 + c;
    c = g1 >> 44; g1 &= m44;
    uint64_t g2 = h2 + c - (1ULL << 42);
    uint64_t mask = (g2 >> 63) - 1;  // all-ones iff no borrow (h >= p)
    h0 = (h0 & ~mask) | (g0 & mask);
    h1 = (h1 & ~mask) | (g1 & mask);
    h2 = (h2 & ~mask) | (g2 & m42 & mask);

    // h mod 2^128 + pad (s), 64-bit lanes with carry
    uint64_t f0 = h0 | (h1 << 44);
    uint64_t f1 = (h1 >> 20) | (h2 << 24);
    using u128 = unsigned __int128;
    u128 acc = (u128)f0 + pad0;
    store64_le(tag, (uint64_t)acc);
    acc = (u128)f1 + pad1 + (uint64_t)(acc >> 64);
    store64_le(tag + 8, (uint64_t)acc);
  }
};

// RFC 8439 §2.8 AEAD construction.
void aead_tag(const uint8_t key[32], const uint8_t nonce[12],
              const uint8_t* aad, uint64_t aad_len, const uint8_t* ct,
              uint64_t ct_len, uint8_t tag[16]) {
  uint8_t otk[64];
  chacha20_block(key, 0, nonce, otk);  // one-time poly key = block 0
  Poly1305 p;
  p.init(otk);
  static const uint8_t zeros[16] = {0};
  p.update(aad, aad_len);
  if (aad_len % 16) p.update(zeros, 16 - (aad_len % 16));
  p.update(ct, ct_len);
  if (ct_len % 16) p.update(zeros, 16 - (ct_len % 16));
  uint8_t lens[16];
  store64_le(lens, aad_len);
  store64_le(lens + 8, ct_len);
  p.update(lens, 16);
  p.finish(tag);
}

int ct_compare16(const uint8_t* a, const uint8_t* b) {
  uint8_t d = 0;
  for (int i = 0; i < 16; i++) d |= a[i] ^ b[i];
  return d == 0 ? 0 : -1;
}

void xchacha_derive(const uint8_t key[32], const uint8_t nonce24[24],
                    uint8_t subkey[32], uint8_t nonce12[12]) {
  hchacha20_impl(key, nonce24, subkey);
  memset(nonce12, 0, 4);
  memcpy(nonce12 + 4, nonce24 + 16, 8);
}

}  // namespace

extern "C" {

// IETF ChaCha20-Poly1305 (RFC 8439 §2.8, 12-byte nonce).  out = ct || tag(16).
// Also the recipient key wrap of backends/x25519_keys.py.
void chacha20poly1305_encrypt(const uint8_t* key, const uint8_t* nonce,
                              const uint8_t* aad, uint64_t aad_len,
                              const uint8_t* pt, uint64_t pt_len,
                              uint8_t* out) {
  chacha20_xor(key, 1, nonce, pt, out, pt_len);
  aead_tag(key, nonce, aad, aad_len, out, pt_len, out + pt_len);
}

// in = ct || tag.  Returns 0 and writes pt on success, -1 on tag mismatch.
int chacha20poly1305_decrypt(const uint8_t* key, const uint8_t* nonce,
                             const uint8_t* aad, uint64_t aad_len,
                             const uint8_t* in, uint64_t in_len,
                             uint8_t* out) {
  if (in_len < 16) return -1;
  uint64_t ct_len = in_len - 16;
  uint8_t tag[16];
  aead_tag(key, nonce, aad, aad_len, in, ct_len, tag);
  if (ct_compare16(tag, in + ct_len) != 0) return -1;
  chacha20_xor(key, 1, nonce, in, out, ct_len);
  return 0;
}

// XChaCha20-Poly1305 (24-byte nonce), draft-irtf-cfrg-xchacha.
void xchacha20poly1305_encrypt(const uint8_t* key, const uint8_t* nonce24,
                               const uint8_t* aad, uint64_t aad_len,
                               const uint8_t* pt, uint64_t pt_len,
                               uint8_t* out) {
  uint8_t subkey[32], nonce12[12];
  xchacha_derive(key, nonce24, subkey, nonce12);
  chacha20poly1305_encrypt(subkey, nonce12, aad, aad_len, pt, pt_len, out);
}

int xchacha20poly1305_decrypt(const uint8_t* key, const uint8_t* nonce24,
                              const uint8_t* aad, uint64_t aad_len,
                              const uint8_t* in, uint64_t in_len,
                              uint8_t* out) {
  uint8_t subkey[32], nonce12[12];
  xchacha_derive(key, nonce24, subkey, nonce12);
  return chacha20poly1305_decrypt(subkey, nonce12, aad, aad_len, in, in_len,
                                  out);
}

}  // extern "C"

// ---- EncBox envelope fast path --------------------------------------------
//
// The wire envelope (backends/xchacha.py, mirroring the reference's EncBox,
// crdt-enc-xchacha20poly1305/src/lib.rs:59-68) is
//   raw VersionBytes:  version(16) ‖ msgpack [ nonce(bin 24), ct(bin N) ]
// At bulk scale (100k+ tiny op files) parsing this in Python costs several
// µs per blob — more than the decrypt itself.  These two calls parse and
// decrypt whole batches straight out of one concatenated buffer.

namespace {
// msgpack bin header at p (limit end): writes payload span, returns 0.
static int parse_bin(const uint8_t* p, const uint8_t* end, const uint8_t** out,
                     uint64_t* out_len, const uint8_t** next) {
  if (p >= end) return -1;
  uint64_t len;
  if (*p == 0xc4) {
    if (end - p < 2) return -1;
    len = p[1];
    p += 2;
  } else if (*p == 0xc5) {
    if (end - p < 3) return -1;
    len = ((uint64_t)p[1] << 8) | p[2];
    p += 3;
  } else if (*p == 0xc6) {
    if (end - p < 5) return -1;
    len = ((uint64_t)p[1] << 24) | ((uint64_t)p[2] << 16) |
          ((uint64_t)p[3] << 8) | p[4];
    p += 5;
  } else {
    return -1;
  }
  if ((uint64_t)(end - p) < len) return -1;
  *out = p;
  *out_len = len;
  *next = p + len;
  return 0;
}
}  // namespace

extern "C" {

// Parse n EncBox blobs concatenated in `blobs` (blob i spans
// [boffs[i], boffs[i+1])).  Each must carry `version` (16 bytes), a 24-byte
// nonce and a ct of ≥ 16 bytes (the tag).  Writes per-blob nonce offsets,
// ct offsets and ct lengths (all relative to `blobs`).  Returns the total
// CLEARTEXT byte count, or -1 if any blob is malformed (the caller then
// opens blob by blob for precise errors).
int64_t encbox_parse_batch(const uint8_t* blobs, const uint64_t* boffs,
                           uint64_t n, const uint8_t* version,
                           uint64_t* nonce_offs, uint64_t* ct_offs,
                           uint64_t* ct_lens) {
  int64_t total = 0;
  for (uint64_t i = 0; i < n; i++) {
    const uint8_t* p = blobs + boffs[i];
    const uint8_t* end = blobs + boffs[i + 1];
    if (end - p < 16 + 1) return -1;
    if (memcmp(p, version, 16) != 0) return -1;
    p += 16;
    if (*p++ != 0x92) return -1;  // fixarray(2)
    const uint8_t *nonce, *ct, *next;
    uint64_t nonce_len, ct_len;
    if (parse_bin(p, end, &nonce, &nonce_len, &next) != 0) return -1;
    if (nonce_len != 24) return -1;
    if (parse_bin(next, end, &ct, &ct_len, &next) != 0) return -1;
    if (ct_len < 16 || next != end) return -1;
    nonce_offs[i] = (uint64_t)(nonce - blobs);
    ct_offs[i] = (uint64_t)(ct - blobs);
    ct_lens[i] = ct_len;
    total += (int64_t)(ct_len - 16);
  }
  return total;
}

}  // extern "C" (parse entry point; batched decrypt engine follows)

// ---- batched small-blob decrypt helpers ---------------------------------
//
// The streaming workload (config 5) is ~100k tiny files sealed under ONE
// key: the per-file fixed crypto (HChaCha20 subkey, Poly1305 one-time-key
// block, 2-4 data blocks) dominates.  All of it is ChaCha rounds on
// independent states, so a vector register's worth of files runs per
// pass — only the state *init* differs per lane (nonce / subkey /
// counter), and the QR rounds are elementwise regardless.  The lane
// width follows the runtime dispatch (16 on AVX-512, 8 on AVX2, 4 on
// the SSE2/NEON baseline — C++ templates outside the C-linkage block).

namespace {

template <typename V>
static inline V rotlvN(V x, int n) {
  return (x << n) | (x >> (32 - n));
}

#define QRN(a, b, c, d)                                      \
  x[a] += x[b]; x[d] ^= x[a]; x[d] = rotlvN(x[d], 16);       \
  x[c] += x[d]; x[b] ^= x[c]; x[b] = rotlvN(x[b], 12);       \
  x[a] += x[b]; x[d] ^= x[a]; x[d] = rotlvN(x[d], 8);        \
  x[c] += x[d]; x[b] ^= x[c]; x[b] = rotlvN(x[b], 7);

// L independent HChaCha20 derivations (shared key, per-lane nonce16).
template <typename V, int L>
static void hchacha20_xN(const uint8_t key[32], const uint8_t* const* nonces,
                         uint8_t (*subkeys)[32], int count) {
  uint32_t kw[8];
  for (int i = 0; i < 8; i++) kw[i] = load32_le(key + 4 * i);
  V x[16];
  for (int i = 0; i < 4; i++) x[i] = SIGMA[i] - (V){};
  for (int i = 0; i < 8; i++) x[4 + i] = kw[i] - (V){};
  for (int i = 0; i < 4; i++)
    for (int j = 0; j < L; j++)
      x[12 + i][j] = load32_le(nonces[j < count ? j : 0] + 4 * i);
  for (int r = 0; r < 10; r++) {
    QRN(0, 4, 8, 12) QRN(1, 5, 9, 13) QRN(2, 6, 10, 14) QRN(3, 7, 11, 15)
    QRN(0, 5, 10, 15) QRN(1, 6, 11, 12) QRN(2, 7, 8, 13) QRN(3, 4, 9, 14)
  }
  for (int j = 0; j < count; j++) {
    for (int i = 0; i < 4; i++) store32_le(subkeys[j] + 4 * i, x[i][j]);
    for (int i = 0; i < 4; i++)
      store32_le(subkeys[j] + 16 + 4 * i, x[12 + i][j]);
  }
}

// L independent ChaCha20 blocks, each with its own key/nonce/counter.
template <typename V, int L>
static void chacha20_block_xN(const uint8_t* const* keys,
                              const uint32_t* counters,
                              const uint8_t* const* nonces12,
                              uint8_t (*outs)[64], int count) {
  V x[16], iv[16];
  for (int i = 0; i < 4; i++) iv[i] = SIGMA[i] - (V){};
  for (int i = 0; i < 8; i++)
    for (int j = 0; j < L; j++)
      iv[4 + i][j] = load32_le(keys[j < count ? j : 0] + 4 * i);
  for (int j = 0; j < L; j++) iv[12][j] = counters[j < count ? j : 0];
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < L; j++)
      iv[13 + i][j] = load32_le(nonces12[j < count ? j : 0] + 4 * i);
  for (int i = 0; i < 16; i++) x[i] = iv[i];
  for (int r = 0; r < 10; r++) {
    QRN(0, 4, 8, 12) QRN(1, 5, 9, 13) QRN(2, 6, 10, 14) QRN(3, 7, 11, 15)
    QRN(0, 5, 10, 15) QRN(1, 6, 11, 12) QRN(2, 7, 8, 13) QRN(3, 4, 9, 14)
  }
#undef QRN
  for (int i = 0; i < 16; i++) x[i] += iv[i];
  for (int j = 0; j < count; j++)
    for (int i = 0; i < 16; i++) store32_le(outs[j] + 4 * i, x[i][j]);
}

// 16 independent HChaCha20 derivations (shared key, per-lane nonce16) —
// the AVX-512 shape with the in-register output transpose.
static void hchacha20_x16(const uint8_t key[32],
                          const uint8_t* const nonces[16],
                          uint8_t subkeys[][32], int count) {
  uint32_t kw[8];
  for (int i = 0; i < 8; i++) kw[i] = load32_le(key + 4 * i);
  v16u x[16];
  for (int i = 0; i < 4; i++) x[i] = SIGMA[i] - (v16u){};
  for (int i = 0; i < 8; i++) x[4 + i] = kw[i] - (v16u){};
  for (int i = 0; i < 4; i++)
    for (int j = 0; j < 16; j++)
      x[12 + i][j] = load32_le(nonces[j < count ? j : 0] + 4 * i);
  for (int r = 0; r < 10; r++) {
#define QRX(a, b, c, d)                                      \
  x[a] += x[b]; x[d] ^= x[a]; x[d] = rotlv16(x[d], 16);      \
  x[c] += x[d]; x[b] ^= x[c]; x[b] = rotlv16(x[b], 12);      \
  x[a] += x[b]; x[d] ^= x[a]; x[d] = rotlv16(x[d], 8);       \
  x[c] += x[d]; x[b] ^= x[c]; x[b] = rotlv16(x[b], 7);
    QRX(0, 4, 8, 12) QRX(1, 5, 9, 13) QRX(2, 6, 10, 14) QRX(3, 7, 11, 15)
    QRX(0, 5, 10, 15) QRX(1, 6, 11, 12) QRX(2, 7, 8, 13) QRX(3, 4, 9, 14)
  }
  for (int j = 0; j < count; j++) {
    for (int i = 0; i < 4; i++) store32_le(subkeys[j] + 4 * i, x[i][j]);
    for (int i = 0; i < 4; i++)
      store32_le(subkeys[j] + 16 + 4 * i, x[12 + i][j]);
  }
}

// 16 independent ChaCha20 blocks, each with its own key/nonce/counter
// (the fully general lane shape: Poly1305 one-time keys AND data
// keystream blocks of different files batch together).
static void chacha20_block_x16(const uint8_t* const keys[16],
                               const uint32_t counters[16],
                               const uint8_t* const nonces12[16],
                               uint8_t outs[][64], int count) {
  v16u x[16], iv[16];
  for (int i = 0; i < 4; i++) iv[i] = SIGMA[i] - (v16u){};
  for (int i = 0; i < 8; i++)
    for (int j = 0; j < 16; j++)
      iv[4 + i][j] = load32_le(keys[j < count ? j : 0] + 4 * i);
  for (int j = 0; j < 16; j++) iv[12][j] = counters[j < count ? j : 0];
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 16; j++)
      iv[13 + i][j] = load32_le(nonces12[j < count ? j : 0] + 4 * i);
  for (int i = 0; i < 16; i++) x[i] = iv[i];
  for (int r = 0; r < 10; r++) {
    QRX(0, 4, 8, 12) QRX(1, 5, 9, 13) QRX(2, 6, 10, 14) QRX(3, 7, 11, 15)
    QRX(0, 5, 10, 15) QRX(1, 6, 11, 12) QRX(2, 7, 8, 13) QRX(3, 4, 9, 14)
  }
#undef QRX
  for (int i = 0; i < 16; i++) x[i] += iv[i];
  transpose16(x);  // x[j] = lane j's 16 words = one 64B block
  for (int j = 0; j < count; j++) memcpy(outs[j], &x[j], 64);
}

// ---- lane-parallel Poly1305 ----------------------------------------------
//
// The batched verify pass was the engine's last scalar phase: every
// file's MAC ran the radix-2^44 core one file at a time while the three
// ChaCha phases ran 4/8/16-wide.  Here the MAC goes lane-parallel the
// same way — one FILE per 64-bit vector lane, radix-2^26 limbs so every
// product fits a 64-bit lane (26+26+log2(5·5) ≈ 57 bits worst case).
// The AEAD construction makes lockstep feasible with no partial-block
// machinery at all: the Poly input is always data zero-padded to a
// 16-byte boundary plus one 16-byte length block, i.e. FULL blocks only
// (hibit always set).  Files of different lengths run lockstep with a
// per-lane active mask; a finished lane's accumulator is carried
// through untouched until every lane drains, then each lane finalizes
// scalar (carry/mod-p/pad — a handful of ops per file).
//
// Lane width is half the u32 ChaCha width (64-bit lanes in the same
// registers): 8 on AVX-512, 4 on AVX2, 2 on the SSE2/NEON baseline.

typedef uint64_t v8q __attribute__((vector_size(64)));
typedef uint64_t v4q __attribute__((vector_size(32)));
typedef uint64_t v2q __attribute__((vector_size(16)));

// 32×32→64 widening multiply per 64-bit lane (every Poly1305 operand is
// < 2^28.4).  GCC does not pattern-match a masked 64-bit vector multiply
// into the 1-µop widening form, and the general vpmullq it emits instead
// is microcoded (3 µops, ~5× the latency) — so on x86 the intrinsic is
// named explicitly; elsewhere the plain lane multiply is already the
// target's native form.  The generic template is the fallback for lane
// shapes wider than the build ISA (never dispatched at runtime there).
template <typename VQ>
static inline VQ mul32(VQ a, VQ b) {
  return a * b;
}
#if defined(__x86_64__) || defined(__i386__)
static inline v2q mul32(v2q a, v2q b) {
  return (v2q)_mm_mul_epu32((__m128i)a, (__m128i)b);
}
#if defined(__AVX2__)
static inline v4q mul32(v4q a, v4q b) {
  return (v4q)_mm256_mul_epu32((__m256i)a, (__m256i)b);
}
#endif
#if defined(__AVX512F__)
static inline v8q mul32(v8q a, v8q b) {
  return (v8q)_mm512_mul_epu32((__m512i)a, (__m512i)b);
}
#endif
#endif

template <typename VQ, int L>
static void poly1305_aead_tags_xN(const uint8_t* const* otks,
                                  const uint8_t* const* msgs,
                                  const uint64_t* lens, uint8_t (*tags)[16],
                                  int count) {
  const uint64_t M26 = 0x3ffffff;
  VQ r0{}, r1{}, r2{}, r3{}, r4{};
  VQ h0{}, h1{}, h2{}, h3{}, h4{};
  // clone lanes (a final partial chunk) mirror lane 0 end to end: they
  // compute lane 0's tag into registers nobody reads, which keeps every
  // lane permanently active — no masking for short batches, no
  // out-of-bounds reads
  const uint8_t* msg_of[L];
  uint64_t len_of[L], nblocks[L];
  uint64_t maxb = 0, min_full = UINT64_MAX, min_nb = UINT64_MAX;
  for (int j = 0; j < L; j++) {
    int ix = j < count ? j : 0;
    const uint8_t* k = otks[ix];
    uint64_t t0 = Poly1305::load64(k), t1 = Poly1305::load64(k + 8);
    t0 &= 0x0ffffffc0fffffffULL;  // clamp per spec
    t1 &= 0x0ffffffc0ffffffcULL;
    r0[j] = t0 & M26;
    r1[j] = (t0 >> 26) & M26;
    r2[j] = ((t0 >> 52) | (t1 << 12)) & M26;
    r3[j] = (t1 >> 14) & M26;
    r4[j] = t1 >> 40;
    msg_of[j] = msgs[ix];
    len_of[j] = lens[ix];
    // blocks = ceil(data/16) data blocks (last zero-padded) + the
    // 16-byte length block
    nblocks[j] = len_of[j] / 16 + (len_of[j] % 16 ? 1 : 0) + 1;
    if (nblocks[j] > maxb) maxb = nblocks[j];
    if (nblocks[j] < min_nb) min_nb = nblocks[j];
    if (len_of[j] / 16 < min_full) min_full = len_of[j] / 16;
  }
  const VQ s1 = r1 * 5, s2 = r2 * 5, s3 = r3 * 5, s4 = r4 * 5;
  const VQ M26v = M26 - (VQ){};
  const VQ HIBIT = (1ULL << 24) - (VQ){};

  // r² limbs for the two-block interleave (h' = (h+m₁)·r² + m₂·r —
  // the scalar core's trick: one carry chain per 32 bytes), computed
  // scalar per lane at init: 26-bit limb products fit u64 with room
  // for the 5-term sums
  VQ q0{}, q1{}, q2{}, q3{}, q4{};
  for (int j = 0; j < L; j++) {
    uint64_t a0 = r0[j], a1 = r1[j], a2 = r2[j], a3 = r3[j], a4 = r4[j];
    uint64_t b1 = a1 * 5, b2 = a2 * 5, b3 = a3 * 5, b4 = a4 * 5;
    uint64_t d0 = a0 * a0 + a1 * b4 + a2 * b3 + a3 * b2 + a4 * b1;
    uint64_t d1 = a0 * a1 + a1 * a0 + a2 * b4 + a3 * b3 + a4 * b2;
    uint64_t d2 = a0 * a2 + a1 * a1 + a2 * a0 + a3 * b4 + a4 * b3;
    uint64_t d3 = a0 * a3 + a1 * a2 + a2 * a1 + a3 * a0 + a4 * b4;
    uint64_t d4 = a0 * a4 + a1 * a3 + a2 * a2 + a3 * a1 + a4 * a0;
    uint64_t c;
    c = d0 >> 26; d0 &= M26; d1 += c;
    c = d1 >> 26; d1 &= M26; d2 += c;
    c = d2 >> 26; d2 &= M26; d3 += c;
    c = d3 >> 26; d3 &= M26; d4 += c;
    c = d4 >> 26; d4 &= M26; d0 += c * 5;
    c = d0 >> 26; d0 &= M26; d1 += c;
    q0[j] = d0; q1[j] = d1; q2[j] = d2; q3[j] = d3; q4[j] = d4;
  }
  const VQ t1 = q1 * 5, t2 = q2 * 5, t3 = q3 * 5, t4 = q4 * 5;

  // one block across all lanes: limb split, multiply, reduce — all in
  // vector registers; only the 2 per-lane 8-byte loads are scalar
  uint64_t w0[L], w1[L];
  auto step = [&](VQ active, bool masked) {
    VQ t0v, t1v;
    memcpy(&t0v, w0, sizeof t0v);
    memcpy(&t1v, w1, sizeof t1v);
    VQ m0 = t0v & M26v;
    VQ m1 = (t0v >> 26) & M26v;
    VQ m2 = ((t0v >> 52) | (t1v << 12)) & M26v;
    VQ m3 = (t1v >> 14) & M26v;
    VQ m4 = (t1v >> 40) | HIBIT;  // hibit: every AEAD block is full
    // h' = (h + m)·r mod p; operands ≤ 2^27, products ≤ 2^53, 5-term
    // sums ≤ 2^55.4 — no 128-bit arithmetic needed in the lanes
    VQ x0 = h0 + m0, x1 = h1 + m1, x2 = h2 + m2, x3 = h3 + m3, x4 = h4 + m4;
    VQ d0 = mul32(x0, r0) + mul32(x1, s4) + mul32(x2, s3) + mul32(x3, s2) +
            mul32(x4, s1);
    VQ d1 = mul32(x0, r1) + mul32(x1, r0) + mul32(x2, s4) + mul32(x3, s3) +
            mul32(x4, s2);
    VQ d2 = mul32(x0, r2) + mul32(x1, r1) + mul32(x2, r0) + mul32(x3, s4) +
            mul32(x4, s3);
    VQ d3 = mul32(x0, r3) + mul32(x1, r2) + mul32(x2, r1) + mul32(x3, r0) +
            mul32(x4, s4);
    VQ d4 = mul32(x0, r4) + mul32(x1, r3) + mul32(x2, r2) + mul32(x3, r1) +
            mul32(x4, r0);
    VQ c;
    c = d0 >> 26; d0 &= M26v; d1 += c;
    c = d1 >> 26; d1 &= M26v; d2 += c;
    c = d2 >> 26; d2 &= M26v; d3 += c;
    c = d3 >> 26; d3 &= M26v; d4 += c;
    c = d4 >> 26; d4 &= M26v; d0 += c * 5;
    c = d0 >> 26; d0 &= M26v; d1 += c;
    if (masked) {  // a drained lane's h carries through untouched
      h0 = (d0 & active) | (h0 & ~active);
      h1 = (d1 & active) | (h1 & ~active);
      h2 = (d2 & active) | (h2 & ~active);
      h3 = (d3 & active) | (h3 & ~active);
      h4 = (d4 & active) | (h4 & ~active);
    } else {
      h0 = d0; h1 = d1; h2 = d2; h3 = d3; h4 = d4;
    }
  };

  // lockstep region: every lane is a plain full data block — straight
  // loads, no branches, no mask (the whole batch for equal-size files).
  // Pairs of blocks run the r² interleave: one carry chain per 32 bytes.
  uint64_t b = 0;
  uint64_t u0[L], u1[L];
  for (; b + 2 <= min_full; b += 2) {
    for (int j = 0; j < L; j++) {
      const uint8_t* p = msg_of[j] + b * 16;
      w0[j] = Poly1305::load64(p);
      w1[j] = Poly1305::load64(p + 8);
      u0[j] = Poly1305::load64(p + 16);
      u1[j] = Poly1305::load64(p + 24);
    }
    VQ a0v, a1v, b0v, b1v;
    memcpy(&a0v, w0, sizeof a0v);
    memcpy(&a1v, w1, sizeof a1v);
    memcpy(&b0v, u0, sizeof b0v);
    memcpy(&b1v, u1, sizeof b1v);
    VQ x0 = h0 + (a0v & M26v);
    VQ x1 = h1 + ((a0v >> 26) & M26v);
    VQ x2 = h2 + (((a0v >> 52) | (a1v << 12)) & M26v);
    VQ x3 = h3 + ((a1v >> 14) & M26v);
    VQ x4 = h4 + ((a1v >> 40) | HIBIT);
    VQ y0 = b0v & M26v;
    VQ y1 = (b0v >> 26) & M26v;
    VQ y2 = ((b0v >> 52) | (b1v << 12)) & M26v;
    VQ y3 = (b1v >> 14) & M26v;
    VQ y4 = (b1v >> 40) | HIBIT;
    // 10-term sums of ≤2^53 products stay under 2^57 — still lane-safe
    VQ d0 = mul32(x0, q0) + mul32(x1, t4) + mul32(x2, t3) + mul32(x3, t2) +
            mul32(x4, t1) + mul32(y0, r0) + mul32(y1, s4) + mul32(y2, s3) +
            mul32(y3, s2) + mul32(y4, s1);
    VQ d1 = mul32(x0, q1) + mul32(x1, q0) + mul32(x2, t4) + mul32(x3, t3) +
            mul32(x4, t2) + mul32(y0, r1) + mul32(y1, r0) + mul32(y2, s4) +
            mul32(y3, s3) + mul32(y4, s2);
    VQ d2 = mul32(x0, q2) + mul32(x1, q1) + mul32(x2, q0) + mul32(x3, t4) +
            mul32(x4, t3) + mul32(y0, r2) + mul32(y1, r1) + mul32(y2, r0) +
            mul32(y3, s4) + mul32(y4, s3);
    VQ d3 = mul32(x0, q3) + mul32(x1, q2) + mul32(x2, q1) + mul32(x3, q0) +
            mul32(x4, t4) + mul32(y0, r3) + mul32(y1, r2) + mul32(y2, r1) +
            mul32(y3, r0) + mul32(y4, s4);
    VQ d4 = mul32(x0, q4) + mul32(x1, q3) + mul32(x2, q2) + mul32(x3, q1) +
            mul32(x4, q0) + mul32(y0, r4) + mul32(y1, r3) + mul32(y2, r2) +
            mul32(y3, r1) + mul32(y4, r0);
    VQ c;
    c = d0 >> 26; d0 &= M26v; d1 += c;
    c = d1 >> 26; d1 &= M26v; d2 += c;
    c = d2 >> 26; d2 &= M26v; d3 += c;
    c = d3 >> 26; d3 &= M26v; d4 += c;
    c = d4 >> 26; d4 &= M26v; d0 += c * 5;
    c = d0 >> 26; d0 &= M26v; d1 += c;
    h0 = d0; h1 = d1; h2 = d2; h3 = d3; h4 = d4;
  }
  for (; b < min_full; b++) {
    for (int j = 0; j < L; j++) {
      const uint8_t* p = msg_of[j] + b * 16;
      w0[j] = Poly1305::load64(p);
      w1[j] = Poly1305::load64(p + 8);
    }
    step(VQ{}, false);
  }
  // ragged tail: per-lane pad/lens-block assembly + drain masking
  for (; b < maxb; b++) {
    VQ active{};
    for (int j = 0; j < L; j++) {
      if (b >= nblocks[j]) { w0[j] = w1[j] = 0; continue; }
      active[j] = ~0ULL;
      uint64_t dlen = len_of[j];
      uint64_t full = dlen / 16;
      if (b + 1 == nblocks[j]) {  // the length block: aad_len(0) ‖ ct_len
        w0[j] = 0;
        w1[j] = dlen;
      } else if (b < full) {
        const uint8_t* p = msg_of[j] + b * 16;
        w0[j] = Poly1305::load64(p);
        w1[j] = Poly1305::load64(p + 8);
      } else {  // final partial data block, zero-padded by the AEAD
        uint8_t blk[16] = {0};
        memcpy(blk, msg_of[j] + full * 16, dlen - full * 16);
        w0[j] = Poly1305::load64(blk);
        w1[j] = Poly1305::load64(blk + 8);
      }
    }
    step(active, b >= min_nb);
  }

  for (int j = 0; j < count; j++) {  // scalar finalize per lane
    uint64_t a0 = h0[j], a1 = h1[j], a2 = h2[j], a3 = h3[j], a4 = h4[j];
    uint64_t c;
    c = a1 >> 26; a1 &= M26; a2 += c;
    c = a2 >> 26; a2 &= M26; a3 += c;
    c = a3 >> 26; a3 &= M26; a4 += c;
    c = a4 >> 26; a4 &= M26; a0 += c * 5;
    c = a0 >> 26; a0 &= M26; a1 += c;
    // g = h - p = h + 5 - 2^130; select g when h >= p (no borrow out)
    uint64_t g0 = a0 + 5;
    c = g0 >> 26; g0 &= M26;
    uint64_t g1 = a1 + c;
    c = g1 >> 26; g1 &= M26;
    uint64_t g2 = a2 + c;
    c = g2 >> 26; g2 &= M26;
    uint64_t g3 = a3 + c;
    c = g3 >> 26; g3 &= M26;
    uint64_t g4 = a4 + c - (1ULL << 26);
    uint64_t mask = (g4 >> 63) - 1;  // all-ones iff no borrow (h >= p)
    a0 = (a0 & ~mask) | (g0 & mask);
    a1 = (a1 & ~mask) | (g1 & mask);
    a2 = (a2 & ~mask) | (g2 & mask);
    a3 = (a3 & ~mask) | (g3 & mask);
    a4 = (a4 & ~mask) | (g4 & M26 & mask);
    uint64_t f0 = a0 | (a1 << 26) | (a2 << 52);
    uint64_t f1 = (a2 >> 12) | (a3 << 14) | (a4 << 40);
    const uint8_t* k = otks[j];
    using u128 = unsigned __int128;
    u128 acc = (u128)f0 + Poly1305::load64(k + 16);
    store64_le(tags[j], (uint64_t)acc);
    acc = (u128)f1 + Poly1305::load64(k + 24) + (uint64_t)(acc >> 64);
    store64_le(tags[j] + 8, (uint64_t)acc);
  }
}

#if defined(__AVX512IFMA__)
// The AVX-512 IFMA shape: radix-2^44 limbs (the scalar core's radix)
// with vpmadd52lo/hi doing the 44×48-bit products directly — 18 madds
// per 16-byte block across 8 files (2.25/file) vs the scalar core's 9
// mulx per file.  Product high halves land at 2^52, i.e. 2^8·2^44, so
// every hi lane is pure carry after an 8-bit shift — no 128-bit
// arithmetic anywhere.
static void poly1305_aead_tags_ifma8(const uint8_t* const* otks,
                                     const uint8_t* const* msgs,
                                     const uint64_t* lens, uint8_t (*tags)[16],
                                     int count) {
  const uint64_t M44 = 0xfffffffffffULL, M42 = 0x3ffffffffffULL;
  typedef v8q VQ;
  VQ r0{}, r1{}, r2{};
  VQ h0{}, h1{}, h2{};
  const uint8_t* msg_of[8];
  uint64_t len_of[8], nblocks[8];
  uint64_t maxb = 0, min_full = UINT64_MAX, min_nb = UINT64_MAX;
  for (int j = 0; j < 8; j++) {
    int ix = j < count ? j : 0;  // clone lanes mirror lane 0 (see xN)
    const uint8_t* k = otks[ix];
    uint64_t t0 = Poly1305::load64(k), t1 = Poly1305::load64(k + 8);
    t0 &= 0x0ffffffc0fffffffULL;
    t1 &= 0x0ffffffc0ffffffcULL;
    r0[j] = t0 & M44;
    r1[j] = ((t0 >> 44) | (t1 << 20)) & M44;
    r2[j] = t1 >> 24;
    msg_of[j] = msgs[ix];
    len_of[j] = lens[ix];
    nblocks[j] = len_of[j] / 16 + (len_of[j] % 16 ? 1 : 0) + 1;
    if (nblocks[j] > maxb) maxb = nblocks[j];
    if (nblocks[j] < min_nb) min_nb = nblocks[j];
    if (len_of[j] / 16 < min_full) min_full = len_of[j] / 16;
  }
  const VQ s1 = r1 * 20, s2 = r2 * 20;  // < 2^48.4: valid madd52 operands
  const VQ M44v = M44 - (VQ){}, M42v = M42 - (VQ){};
  const VQ HIB = (1ULL << 40) - (VQ){};

  auto madlo = [](VQ acc, VQ a, VQ b) {
    return (VQ)_mm512_madd52lo_epu64((__m512i)acc, (__m512i)a, (__m512i)b);
  };
  auto madhi = [](VQ acc, VQ a, VQ b) {
    return (VQ)_mm512_madd52hi_epu64((__m512i)acc, (__m512i)a, (__m512i)b);
  };

  uint64_t w0[8], w1[8];
  auto step = [&](VQ active, bool masked) {
    VQ t0v, t1v;
    memcpy(&t0v, w0, sizeof t0v);
    memcpy(&t1v, w1, sizeof t1v);
    VQ x0 = h0 + (t0v & M44v);
    VQ x1 = h1 + (((t0v >> 44) | (t1v << 20)) & M44v);
    VQ x2 = h2 + (((t1v >> 24) & M42v) | HIB);  // hibit: blocks all full
    VQ lo0{}, hi0{}, lo1{}, hi1{}, lo2{}, hi2{};
    lo0 = madlo(lo0, x0, r0); hi0 = madhi(hi0, x0, r0);
    lo0 = madlo(lo0, x1, s2); hi0 = madhi(hi0, x1, s2);
    lo0 = madlo(lo0, x2, s1); hi0 = madhi(hi0, x2, s1);
    lo1 = madlo(lo1, x0, r1); hi1 = madhi(hi1, x0, r1);
    lo1 = madlo(lo1, x1, r0); hi1 = madhi(hi1, x1, r0);
    lo1 = madlo(lo1, x2, s2); hi1 = madhi(hi1, x2, s2);
    lo2 = madlo(lo2, x0, r2); hi2 = madhi(hi2, x0, r2);
    lo2 = madlo(lo2, x1, r1); hi2 = madhi(hi2, x1, r1);
    lo2 = madlo(lo2, x2, r0); hi2 = madhi(hi2, x2, r0);
    VQ c;
    c = (lo0 >> 44) + (hi0 << 8);
    lo0 &= M44v; lo1 += c;
    c = (lo1 >> 44) + (hi1 << 8);
    lo1 &= M44v; lo2 += c;
    c = (lo2 >> 42) + (hi2 << 10);
    lo2 &= M42v; lo0 += c * 5;
    c = lo0 >> 44; lo0 &= M44v; lo1 += c;
    if (masked) {
      h0 = (lo0 & active) | (h0 & ~active);
      h1 = (lo1 & active) | (h1 & ~active);
      h2 = (lo2 & active) | (h2 & ~active);
    } else {
      h0 = lo0; h1 = lo1; h2 = lo2;
    }
  };

  uint64_t b = 0;
  for (; b < min_full; b++) {  // lockstep: plain full data blocks
    for (int j = 0; j < 8; j++) {
      const uint8_t* p = msg_of[j] + b * 16;
      w0[j] = Poly1305::load64(p);
      w1[j] = Poly1305::load64(p + 8);
    }
    step(VQ{}, false);
  }
  for (; b < maxb; b++) {  // ragged tail: pad/lens blocks + drain mask
    VQ active{};
    for (int j = 0; j < 8; j++) {
      if (b >= nblocks[j]) { w0[j] = w1[j] = 0; continue; }
      active[j] = ~0ULL;
      uint64_t dlen = len_of[j];
      uint64_t full = dlen / 16;
      if (b + 1 == nblocks[j]) {
        w0[j] = 0;
        w1[j] = dlen;
      } else if (b < full) {
        const uint8_t* p = msg_of[j] + b * 16;
        w0[j] = Poly1305::load64(p);
        w1[j] = Poly1305::load64(p + 8);
      } else {
        uint8_t blk[16] = {0};
        memcpy(blk, msg_of[j] + full * 16, dlen - full * 16);
        w0[j] = Poly1305::load64(blk);
        w1[j] = Poly1305::load64(blk + 8);
      }
    }
    step(active, b >= min_nb);
  }

  for (int j = 0; j < count; j++) {  // scalar finalize (Poly1305::finish)
    uint64_t a0 = h0[j], a1 = h1[j], a2 = h2[j];
    uint64_t c;
    c = a1 >> 44; a1 &= M44; a2 += c;
    c = a2 >> 42; a2 &= M42; a0 += c * 5;
    c = a0 >> 44; a0 &= M44; a1 += c;
    c = a1 >> 44; a1 &= M44; a2 += c;
    c = a2 >> 42; a2 &= M42; a0 += c * 5;
    c = a0 >> 44; a0 &= M44; a1 += c;
    uint64_t g0 = a0 + 5;
    c = g0 >> 44; g0 &= M44;
    uint64_t g1 = a1 + c;
    c = g1 >> 44; g1 &= M44;
    uint64_t g2 = a2 + c - (1ULL << 42);
    uint64_t mask = (g2 >> 63) - 1;
    a0 = (a0 & ~mask) | (g0 & mask);
    a1 = (a1 & ~mask) | (g1 & mask);
    a2 = (a2 & ~mask) | (g2 & M42 & mask);
    uint64_t f0 = a0 | (a1 << 44);
    uint64_t f1 = (a1 >> 20) | (a2 << 24);
    const uint8_t* k = otks[j];
    using u128 = unsigned __int128;
    u128 acc = (u128)f0 + Poly1305::load64(k + 16);
    store64_le(tags[j], (uint64_t)acc);
    acc = (u128)f1 + Poly1305::load64(k + 24) + (uint64_t)(acc >> 64);
    store64_le(tags[j] + 8, (uint64_t)acc);
  }
}

// the .so may have been built on an IFMA box and copied — same
// degrade-don't-fault contract as simd_lanes_detect()
static bool ifma_detect() {
#if (defined(__x86_64__) || defined(__i386__)) && defined(__GNUC__)
  __builtin_cpu_init();
  return __builtin_cpu_supports("avx512ifma") != 0;
#else
  return false;
#endif
}
static const bool HAVE_IFMA = ifma_detect();
#endif  // __AVX512IFMA__

// Runtime-dispatched batch front door: AEAD tags (zero AAD — the op-blob
// envelope's shape) for n (one-time key, message, length) triples, in
// lane-width chunks.  Shared by the engine's verify phase and the
// poly1305_aead_tags FFI export the differential tests drive.
static void poly1305_aead_tags_batch(const uint8_t* const* otks,
                                     const uint8_t* const* msgs,
                                     const uint64_t* lens,
                                     uint8_t (*tags)[16], uint64_t n) {
  uint64_t i = 0;
#if defined(__AVX512IFMA__)
  if (HAVE_IFMA && SIMD_LANES >= LANES16) {
    for (; i + 8 <= n; i += 8)
      poly1305_aead_tags_ifma8(otks + i, msgs + i, lens + i, tags + i, 8);
    if (i < n) {
      poly1305_aead_tags_ifma8(otks + i, msgs + i, lens + i, tags + i,
                               (int)(n - i));
      i = n;
    }
    return;
  }
#endif
  if (SIMD_LANES >= LANES16) {
    for (; i + 8 <= n; i += 8)
      poly1305_aead_tags_xN<v8q, 8>(otks + i, msgs + i, lens + i, tags + i, 8);
  } else if (SIMD_LANES >= LANES) {
    for (; i + 4 <= n; i += 4)
      poly1305_aead_tags_xN<v4q, 4>(otks + i, msgs + i, lens + i, tags + i, 4);
  }
  for (; i < n; i += 2) {
    int c = (int)(n - i < 2 ? n - i : 2);
    poly1305_aead_tags_xN<v2q, 2>(otks + i, msgs + i, lens + i, tags + i, c);
  }
}

// Per-lane-width kernel selection for the batched engine: 16 lanes use
// the transpose-optimized AVX-512 shapes above, narrower widths the
// generic templates (scalar lane extraction — 8/4 lanes have too few
// words per register for the butterfly transpose to pay).
template <int L> struct BatchKern;
template <> struct BatchKern<4> {
  static void hch(const uint8_t key[32], const uint8_t* const* nonces,
                  uint8_t (*sk)[32], int c) {
    hchacha20_xN<v4u, 4>(key, nonces, sk, c);
  }
  static void blk(const uint8_t* const* keys, const uint32_t* ctr,
                  const uint8_t* const* n12, uint8_t (*o)[64], int c) {
    chacha20_block_xN<v4u, 4>(keys, ctr, n12, o, c);
  }
};
template <> struct BatchKern<8> {
  static void hch(const uint8_t key[32], const uint8_t* const* nonces,
                  uint8_t (*sk)[32], int c) {
    hchacha20_xN<v8u, 8>(key, nonces, sk, c);
  }
  static void blk(const uint8_t* const* keys, const uint32_t* ctr,
                  const uint8_t* const* n12, uint8_t (*o)[64], int c) {
    chacha20_block_xN<v8u, 8>(keys, ctr, n12, o, c);
  }
};
template <> struct BatchKern<16> {
  static void hch(const uint8_t key[32], const uint8_t* const* nonces,
                  uint8_t (*sk)[32], int c) {
    hchacha20_x16(key, nonces, sk, c);
  }
  static void blk(const uint8_t* const* keys, const uint32_t* ctr,
                  const uint8_t* const* n12, uint8_t (*o)[64], int c) {
    chacha20_block_x16(keys, ctr, n12, o, c);
  }
};

// Batched decrypt of n same-key blobs: three vectorized ChaCha phases
// (subkeys, one-time poly keys, data keystream jobs) + a batched scalar
// Poly1305 verification pass.  Writes cleartext only where the tag
// verifies.  Lane width L follows the runtime dispatch (see the
// non-template front door below).
template <int L>
static int encbox_decrypt_batched_impl(
    const uint8_t* key, const uint8_t* blobs, const uint64_t* nonce_offs,
    const uint64_t* ct_offs, const uint64_t* ct_lens, uint64_t n,
    uint8_t* out, const uint64_t* out_offs, uint8_t* ok_flags) {
  std::vector<std::array<uint8_t, 32>> subkeys(n);
  std::vector<std::array<uint8_t, 12>> n12(n);
  std::vector<std::array<uint8_t, 64>> otk(n);

  // phase 1: subkeys (HChaCha20 over nonce24[0:16))
  for (uint64_t i = 0; i < n; i += L) {
    int c = (int)((n - i) < (uint64_t)L ? (n - i) : (uint64_t)L);
    const uint8_t* np[L];
    uint8_t(*sk)[32] = (uint8_t(*)[32])subkeys[i].data();
    for (int j = 0; j < L; j++)
      np[j] = (blobs + nonce_offs[i + (j < c ? j : 0)]);
    BatchKern<L>::hch(key, np, sk, c);
  }
  for (uint64_t i = 0; i < n; i++) {
    memset(n12[i].data(), 0, 4);
    memcpy(n12[i].data() + 4, (blobs + nonce_offs[i]) + 16, 8);
  }
  // phase 2: Poly1305 one-time keys (block 0 of each file's stream)
  for (uint64_t i = 0; i < n; i += L) {
    int c = (int)((n - i) < (uint64_t)L ? (n - i) : (uint64_t)L);
    const uint8_t* kp[L];
    const uint8_t* np[L];
    uint32_t ctr[L] = {0};
    uint8_t(*op)[64] = (uint8_t(*)[64])otk[i].data();
    for (int j = 0; j < L; j++) {
      uint64_t ix = i + (j < c ? j : 0);
      kp[j] = subkeys[ix].data();
      np[j] = n12[ix].data();
    }
    BatchKern<L>::blk(kp, ctr, np, op, c);
  }
  // phase 3: lane-parallel Poly1305 pass — every file's tag computed
  // one-file-per-lane (poly1305_aead_tags_batch) and verified BEFORE
  // any keystream XOR, matching the scalar path's verify-then-decrypt
  // order: a blob whose tag fails must never have plaintext written
  int failures = 0;
  std::vector<const uint8_t*> mac_keys(n);
  std::vector<const uint8_t*> mac_msgs(n);
  std::vector<uint64_t> mac_lens(n);
  std::vector<std::array<uint8_t, 16>> mac_tags(n);
  uint64_t n_mac = 0;
  for (uint64_t i = 0; i < n; i++) {
    if (ct_lens[i] < 16) {
      ok_flags[i] = 0;
      failures++;
      continue;
    }
    ok_flags[i] = 2;  // marks "tag pending" for the verify sweep below
    mac_keys[n_mac] = otk[i].data();
    mac_msgs[n_mac] = (blobs + ct_offs[i]);
    mac_lens[n_mac] = ct_lens[i] - 16;
    n_mac++;
  }
  poly1305_aead_tags_batch(mac_keys.data(), mac_msgs.data(), mac_lens.data(),
                           (uint8_t(*)[16])mac_tags.data()->data(), n_mac);
  for (uint64_t i = 0, q = 0; i < n; i++) {
    if (ok_flags[i] != 2) continue;
    int rc = ct_compare16(mac_tags[q].data(), mac_msgs[q] + mac_lens[q]);
    ok_flags[i] = rc == 0 ? 1 : 0;
    if (rc != 0) failures++;
    q++;
  }
  // phase 4: data keystream jobs (file, block counter) for VERIFIED
  // files only, 16 at a time, XORed into the scattered output positions
  struct Job { uint64_t file; uint32_t ctr; };
  std::vector<Job> jobs;
  jobs.reserve(n * 3);
  for (uint64_t i = 0; i < n; i++) {
    if (!ok_flags[i]) continue;
    uint64_t data_len = ct_lens[i] - 16;
    for (uint64_t b = 0; b * 64 < data_len; b++)
      jobs.push_back({i, (uint32_t)(b + 1)});
  }
  uint8_t ks[L][64];
  for (size_t q = 0; q < jobs.size(); q += L) {
    int c = (int)((jobs.size() - q) < (size_t)L ? (jobs.size() - q) : (size_t)L);
    const uint8_t* kp[L];
    const uint8_t* np[L];
    uint32_t ctr[L];
    for (int j = 0; j < L; j++) {
      const Job& jb = jobs[q + (j < c ? j : 0)];
      kp[j] = subkeys[jb.file].data();
      np[j] = n12[jb.file].data();
      ctr[j] = jb.ctr;
    }
    BatchKern<L>::blk(kp, ctr, np, ks, c);
    for (int j = 0; j < c; j++) {
      const Job& jb = jobs[q + j];
      uint64_t data_len = ct_lens[jb.file] - 16;
      uint64_t off = (uint64_t)(jb.ctr - 1) * 64;
      uint64_t m = data_len - off < 64 ? data_len - off : 64;
      const uint8_t* src = (blobs + ct_offs[jb.file]) + off;
      uint8_t* dst = out + out_offs[jb.file] + off;
      for (uint64_t b = 0; b < m; b++) dst[b] = src[b] ^ ks[j][b];
    }
  }
  return failures;
}

// Runtime-dispatched front door: widest lane shape the build AND the
// running CPU both support (SIMD_LANES), so one .so degrades gracefully
// instead of faulting on a narrower host.
static int encbox_decrypt_batched(const uint8_t* key, const uint8_t* blobs,
                                  const uint64_t* nonce_offs,
                                  const uint64_t* ct_offs,
                                  const uint64_t* ct_lens, uint64_t n,
                                  uint8_t* out, const uint64_t* out_offs,
                                  uint8_t* ok_flags) {
  if (SIMD_LANES >= LANES16)
    return encbox_decrypt_batched_impl<16>(key, blobs, nonce_offs, ct_offs,
                                           ct_lens, n, out, out_offs,
                                           ok_flags);
  if (SIMD_LANES >= LANES)
    return encbox_decrypt_batched_impl<8>(key, blobs, nonce_offs, ct_offs,
                                          ct_lens, n, out, out_offs,
                                          ok_flags);
  return encbox_decrypt_batched_impl<4>(key, blobs, nonce_offs, ct_offs,
                                        ct_lens, n, out, out_offs, ok_flags);
}

}  // namespace (batched decrypt engine)

extern "C" {

// Threaded batch decrypt reading nonce/ct in place via the offsets the
// parse produced — zero intermediate copies.  Output spans are disjoint
// (out_offs from an exclusive scan of ct_lens-16).  Returns failure count.
int encbox_decrypt_scatter_mt(const uint8_t* key, const uint8_t* blobs,
                              const uint64_t* nonce_offs,
                              const uint64_t* ct_offs,
                              const uint64_t* ct_lens, uint64_t n,
                              uint8_t* out, const uint64_t* out_offs,
                              uint8_t* ok_flags, int n_threads) {
  if (n_threads <= 0) n_threads = 1;
  if ((uint64_t)n_threads > n) n_threads = (int)(n ? n : 1);
  auto work = [&](uint64_t lo, uint64_t hi, int* fail_out) {
    if (hi - lo >= 32) {  // 16-lane batched kernel per worker range
      *fail_out = encbox_decrypt_batched(
          key, blobs, nonce_offs + lo, ct_offs + lo, ct_lens + lo, hi - lo,
          out, out_offs + lo, ok_flags + lo);
      return;
    }
    int f = 0;
    for (uint64_t i = lo; i < hi; i++) {
      int rc = xchacha20poly1305_decrypt(
          key, (blobs + nonce_offs[i]), nullptr, 0,
          (blobs + ct_offs[i]),
          ct_lens[i], out + out_offs[i]);
      ok_flags[i] = rc == 0 ? 1 : 0;
      if (rc != 0) f++;
    }
    *fail_out = f;
  };
  if (n_threads <= 1 || n < 2) {
    if (n >= 32)
      return encbox_decrypt_batched(key, blobs, nonce_offs, ct_offs, ct_lens,
                                    n, out, out_offs, ok_flags);
    int f = 0;
    work(0, n, &f);
    return f;
  }
  std::vector<std::thread> workers;
  std::vector<int> fails((size_t)n_threads, 0);
  uint64_t stride = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    uint64_t lo = t * stride;
    uint64_t hi = lo + stride < n ? lo + stride : n;
    if (lo >= hi) break;
    workers.emplace_back([&, lo, hi, t]() { work(lo, hi, &fails[t]); });
  }
  for (auto& w : workers) w.join();
  int failures = 0;
  for (int f : fails) failures += f;
  return failures;
}

}  // extern "C"
