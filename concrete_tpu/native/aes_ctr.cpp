// Native AES-128-CTR bulk generation for the host-side CSPRNG.
//
// Native analog of the reference's hardware backend
// (concrete-csprng/src/aesni.rs): batched AES-128 encryption of
// little-endian counter blocks, used for key/mask/noise generation on the
// host. Two code paths, selected at runtime:
//   - AES-NI (x86 AESENC/AESENCLAST + AESKEYGENASSIST), 8 blocks in flight
//     per loop iteration to fill the pipeline (aesni.rs:36-88 equivalent);
//   - portable table-based software AES (software.rs equivalent).
// Both are bit-identical to FIPS-197 and to the package's numpy
// implementation (concrete_tpu/csprng/aes.py).
//
// C ABI only — loaded through ctypes (no pybind11 dependency).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__x86_64__) || defined(_M_X64)
#define CTPU_X86 1
#include <cpuid.h>
#include <immintrin.h>
#include <wmmintrin.h>
#else
#define CTPU_X86 0
#endif

namespace {

// ---------------------------------------------------------------------------
// software AES-128 (encrypt only)
// ---------------------------------------------------------------------------

const uint8_t SBOX[256] = {
    0x63, 0x7c, 0x77, 0x7b, 0xf2, 0x6b, 0x6f, 0xc5, 0x30, 0x01, 0x67, 0x2b,
    0xfe, 0xd7, 0xab, 0x76, 0xca, 0x82, 0xc9, 0x7d, 0xfa, 0x59, 0x47, 0xf0,
    0xad, 0xd4, 0xa2, 0xaf, 0x9c, 0xa4, 0x72, 0xc0, 0xb7, 0xfd, 0x93, 0x26,
    0x36, 0x3f, 0xf7, 0xcc, 0x34, 0xa5, 0xe5, 0xf1, 0x71, 0xd8, 0x31, 0x15,
    0x04, 0xc7, 0x23, 0xc3, 0x18, 0x96, 0x05, 0x9a, 0x07, 0x12, 0x80, 0xe2,
    0xeb, 0x27, 0xb2, 0x75, 0x09, 0x83, 0x2c, 0x1a, 0x1b, 0x6e, 0x5a, 0xa0,
    0x52, 0x3b, 0xd6, 0xb3, 0x29, 0xe3, 0x2f, 0x84, 0x53, 0xd1, 0x00, 0xed,
    0x20, 0xfc, 0xb1, 0x5b, 0x6a, 0xcb, 0xbe, 0x39, 0x4a, 0x4c, 0x58, 0xcf,
    0xd0, 0xef, 0xaa, 0xfb, 0x43, 0x4d, 0x33, 0x85, 0x45, 0xf9, 0x02, 0x7f,
    0x50, 0x3c, 0x9f, 0xa8, 0x51, 0xa3, 0x40, 0x8f, 0x92, 0x9d, 0x38, 0xf5,
    0xbc, 0xb6, 0xda, 0x21, 0x10, 0xff, 0xf3, 0xd2, 0xcd, 0x0c, 0x13, 0xec,
    0x5f, 0x97, 0x44, 0x17, 0xc4, 0xa7, 0x7e, 0x3d, 0x64, 0x5d, 0x19, 0x73,
    0x60, 0x81, 0x4f, 0xdc, 0x22, 0x2a, 0x90, 0x88, 0x46, 0xee, 0xb8, 0x14,
    0xde, 0x5e, 0x0b, 0xdb, 0xe0, 0x32, 0x3a, 0x0a, 0x49, 0x06, 0x24, 0x5c,
    0xc2, 0xd3, 0xac, 0x62, 0x91, 0x95, 0xe4, 0x79, 0xe7, 0xc8, 0x37, 0x6d,
    0x8d, 0xd5, 0x4e, 0xa9, 0x6c, 0x56, 0xf4, 0xea, 0x65, 0x7a, 0xae, 0x08,
    0xba, 0x78, 0x25, 0x2e, 0x1c, 0xa6, 0xb4, 0xc6, 0xe8, 0xdd, 0x74, 0x1f,
    0x4b, 0xbd, 0x8b, 0x8a, 0x70, 0x3e, 0xb5, 0x66, 0x48, 0x03, 0xf6, 0x0e,
    0x61, 0x35, 0x57, 0xb9, 0x86, 0xc1, 0x1d, 0x9e, 0xe1, 0xf8, 0x98, 0x11,
    0x69, 0xd9, 0x8e, 0x94, 0x9b, 0x1e, 0x87, 0xe9, 0xce, 0x55, 0x28, 0xdf,
    0x8c, 0xa1, 0x89, 0x0d, 0xbf, 0xe6, 0x42, 0x68, 0x41, 0x99, 0x2d, 0x0f,
    0xb0, 0x54, 0xbb, 0x16};

inline uint8_t xtime(uint8_t x) {
  return static_cast<uint8_t>((x << 1) ^ ((x & 0x80) ? 0x1B : 0x00));
}

void soft_encrypt_block(const uint8_t rk[11][16], const uint8_t in[16],
                        uint8_t out[16]) {
  uint8_t s[16];
  for (int i = 0; i < 16; ++i) s[i] = in[i] ^ rk[0][i];
  for (int round = 1; round <= 10; ++round) {
    uint8_t t[16];
    // SubBytes + ShiftRows (state layout: s[r + 4c])
    for (int c = 0; c < 4; ++c)
      for (int r = 0; r < 4; ++r) t[r + 4 * c] = SBOX[s[r + 4 * ((c + r) & 3)]];
    if (round < 10) {
      // MixColumns
      for (int c = 0; c < 4; ++c) {
        uint8_t a0 = t[4 * c], a1 = t[4 * c + 1], a2 = t[4 * c + 2],
                a3 = t[4 * c + 3];
        uint8_t x = a0 ^ a1 ^ a2 ^ a3;
        s[4 * c + 0] = static_cast<uint8_t>(a0 ^ x ^ xtime(a0 ^ a1));
        s[4 * c + 1] = static_cast<uint8_t>(a1 ^ x ^ xtime(a1 ^ a2));
        s[4 * c + 2] = static_cast<uint8_t>(a2 ^ x ^ xtime(a2 ^ a3));
        s[4 * c + 3] = static_cast<uint8_t>(a3 ^ x ^ xtime(a3 ^ a0));
      }
    } else {
      std::memcpy(s, t, 16);
    }
    for (int i = 0; i < 16; ++i) s[i] ^= rk[round][i];
  }
  std::memcpy(out, s, 16);
}

#if CTPU_X86
bool have_aesni() {
  unsigned eax, ebx, ecx, edx;
  if (!__get_cpuid(1, &eax, &ebx, &ecx, &edx)) return false;
  return (ecx & bit_AES) != 0;
}

// AES-NI with 8 blocks in flight (mirrors the reference's batch width,
// aesni.rs:36: 128-byte batches = 8 blocks).
__attribute__((target("aes,sse2"))) void aesni_encrypt_blocks(
    const uint8_t* rk_bytes, const uint8_t* in, uint8_t* out, size_t n) {
  __m128i rk[11];
  for (int i = 0; i < 11; ++i)
    rk[i] = _mm_loadu_si128(reinterpret_cast<const __m128i*>(rk_bytes + 16 * i));
  size_t i = 0;
  for (; i + 8 <= n; i += 8) {
    __m128i b[8];
    for (int j = 0; j < 8; ++j)
      b[j] = _mm_xor_si128(
          _mm_loadu_si128(reinterpret_cast<const __m128i*>(in + 16 * (i + j))),
          rk[0]);
    for (int r = 1; r < 10; ++r)
      for (int j = 0; j < 8; ++j) b[j] = _mm_aesenc_si128(b[j], rk[r]);
    for (int j = 0; j < 8; ++j) {
      b[j] = _mm_aesenclast_si128(b[j], rk[10]);
      _mm_storeu_si128(reinterpret_cast<__m128i*>(out + 16 * (i + j)), b[j]);
    }
  }
  for (; i < n; ++i) {
    __m128i b = _mm_xor_si128(
        _mm_loadu_si128(reinterpret_cast<const __m128i*>(in + 16 * i)), rk[0]);
    for (int r = 1; r < 10; ++r) b = _mm_aesenc_si128(b, rk[r]);
    b = _mm_aesenclast_si128(b, rk[10]);
    _mm_storeu_si128(reinterpret_cast<__m128i*>(out + 16 * i), b);
  }
}
#endif  // CTPU_X86

}  // namespace

extern "C" {

// Expand a 16-byte key into 11 round keys (176 bytes out).
void ctpu_aes128_key_schedule(const uint8_t* key, uint8_t* round_keys) {
  static const uint8_t RCON[10] = {0x01, 0x02, 0x04, 0x08, 0x10,
                                   0x20, 0x40, 0x80, 0x1B, 0x36};
  uint8_t w[44][4];
  std::memcpy(w, key, 16);
  for (int i = 4; i < 44; ++i) {
    uint8_t t[4] = {w[i - 1][0], w[i - 1][1], w[i - 1][2], w[i - 1][3]};
    if (i % 4 == 0) {
      uint8_t tmp = t[0];
      t[0] = static_cast<uint8_t>(SBOX[t[1]] ^ RCON[i / 4 - 1]);
      t[1] = SBOX[t[2]];
      t[2] = SBOX[t[3]];
      t[3] = SBOX[tmp];
    }
    for (int b = 0; b < 4; ++b) w[i][b] = static_cast<uint8_t>(w[i - 4][b] ^ t[b]);
  }
  std::memcpy(round_keys, w, 176);
}

// 1 if the fast hardware path is active.
int ctpu_aes128_has_hw() {
#if CTPU_X86
  return have_aesni() ? 1 : 0;
#else
  return 0;
#endif
}

// ECB-encrypt n 16-byte blocks.
void ctpu_aes128_encrypt_blocks(const uint8_t* round_keys, const uint8_t* in,
                                uint8_t* out, size_t n) {
#if CTPU_X86
  if (have_aesni()) {
    aesni_encrypt_blocks(round_keys, in, out, n);
    return;
  }
#endif
  const uint8_t(*rk)[16] = reinterpret_cast<const uint8_t(*)[16]>(round_keys);
  for (size_t i = 0; i < n; ++i)
    soft_encrypt_block(rk, in + 16 * i, out + 16 * i);
}

// CTR fill: encrypt n consecutive little-endian u128 counters starting at
// (ctr_lo, ctr_hi) — the CSPRNG hot path (counter/mod.rs:106-170 analog).
void ctpu_aes128_ctr_fill(const uint8_t* round_keys, uint64_t ctr_lo,
                          uint64_t ctr_hi, uint8_t* out, size_t n) {
  constexpr size_t CHUNK = 512;
  uint8_t blocks[CHUNK * 16];
  size_t done = 0;
  while (done < n) {
    size_t m = n - done < CHUNK ? n - done : CHUNK;
    for (size_t i = 0; i < m; ++i) {
      // explicit little-endian, matching the numpy reference path exactly
      // regardless of host byte order (bit-identity contract)
      for (int b = 0; b < 8; ++b) {
        blocks[16 * i + b] = static_cast<uint8_t>(ctr_lo >> (8 * b));
        blocks[16 * i + 8 + b] = static_cast<uint8_t>(ctr_hi >> (8 * b));
      }
      if (++ctr_lo == 0) ++ctr_hi;
    }
    ctpu_aes128_encrypt_blocks(round_keys, blocks, out + 16 * done, m);
    done += m;
  }
}

// Batched CTR fill: r independent little-endian u128 start counters
// (ctr_lo[i], ctr_hi[i]), n_blocks consecutive blocks each ->
// out[r * n_blocks * 16]. Rows are independent streams, so they fan out
// across hardware threads — the host-side analog of the reference's rayon
// par_fill_with_new_key (bootstrap/standard/mod.rs:254); used by the
// key-generation batch sweep (csprng/random.py batch_fill_gaussian_torus).
void ctpu_aes128_ctr_fill_batch(const uint8_t* round_keys,
                                const uint64_t* ctr_lo, const uint64_t* ctr_hi,
                                uint8_t* out, size_t r, size_t n_blocks) {
  size_t n_threads = std::thread::hardware_concurrency();
  if (n_threads == 0) n_threads = 1;
  if (n_threads > r) n_threads = r;
  // thread pools are overkill here: one spawn per keygen-scale call
  if (n_threads <= 1 || r * n_blocks < 4096) {
    for (size_t i = 0; i < r; ++i)
      ctpu_aes128_ctr_fill(round_keys, ctr_lo[i], ctr_hi[i],
                           out + i * n_blocks * 16, n_blocks);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  for (size_t t = 0; t < n_threads; ++t) {
    size_t lo = r * t / n_threads, hi = r * (t + 1) / n_threads;
    threads.emplace_back([=] {
      for (size_t i = lo; i < hi; ++i)
        ctpu_aes128_ctr_fill(round_keys, ctr_lo[i], ctr_hi[i],
                             out + i * n_blocks * 16, n_blocks);
    });
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
