// Batch MurmurHash3 of utf-8 strings for the host featurizer
// (pipeline/vocab.py): the four lexical-attribute strings of every token are
// hashed here, in one call per batch, instead of per string in Python.
// A copy of spacy_ray_tpu/native/murmur.cpp.
//
// MurmurHash3 x86_128 (public-domain algorithm, Austin Appleby), truncated
// to 64 bits as (h2 << 32) | h1. It must stay bit-identical to
// ops/hashing.py:hash_string_u64, which the tests check.
//
// Built at first use by native/__init__.py:
//   g++ -O3 -shared -fPIC -o _build/murmur-<digest>.so murmur.cpp

#include <cstdint>
#include <cstring>

static inline uint32_t rotl32(uint32_t x, int8_t r) {
  return (x << r) | (x >> (32 - r));
}

static inline uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bU;
  h ^= h >> 13;
  h *= 0xc2b2ae35U;
  h ^= h >> 16;
  return h;
}

static inline uint32_t getblock32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);  // little-endian hosts only (x86/arm LE)
  return v;
}

extern "C" {

// 64-bit truncated murmur3_x86_128 of one byte string.
uint64_t murmur3_u64(const uint8_t* data, int64_t len, uint32_t seed) {
  const int64_t nblocks = len / 16;
  uint32_t h1 = seed, h2 = seed, h3 = seed, h4 = seed;
  const uint32_t c1 = 0x239b961bU, c2 = 0xab0e9789U, c3 = 0x38b34ae5U,
                 c4 = 0xa1e38b93U;

  for (int64_t i = 0; i < nblocks; i++) {
    const uint8_t* block = data + i * 16;
    uint32_t k1 = getblock32(block);
    uint32_t k2 = getblock32(block + 4);
    uint32_t k3 = getblock32(block + 8);
    uint32_t k4 = getblock32(block + 12);

    k1 *= c1; k1 = rotl32(k1, 15); k1 *= c2; h1 ^= k1;
    h1 = rotl32(h1, 19); h1 += h2; h1 = h1 * 5 + 0x561ccd1bU;
    k2 *= c2; k2 = rotl32(k2, 16); k2 *= c3; h2 ^= k2;
    h2 = rotl32(h2, 17); h2 += h3; h2 = h2 * 5 + 0x0bcaa747U;
    k3 *= c3; k3 = rotl32(k3, 17); k3 *= c4; h3 ^= k3;
    h3 = rotl32(h3, 15); h3 += h4; h3 = h3 * 5 + 0x96cd1c35U;
    k4 *= c4; k4 = rotl32(k4, 18); k4 *= c1; h4 ^= k4;
    h4 = rotl32(h4, 13); h4 += h1; h4 = h4 * 5 + 0x32ac3b17U;
  }

  const uint8_t* tail = data + nblocks * 16;
  const int64_t t = len & 15;
  uint32_t k1 = 0, k2 = 0, k3 = 0, k4 = 0;
  // byte-accumulate the tail exactly like the reference implementation
  switch (t) {
    case 15: k4 ^= (uint32_t)tail[14] << 16; [[fallthrough]];
    case 14: k4 ^= (uint32_t)tail[13] << 8; [[fallthrough]];
    case 13: k4 ^= (uint32_t)tail[12] << 0;
             k4 *= c4; k4 = rotl32(k4, 18); k4 *= c1; h4 ^= k4; [[fallthrough]];
    case 12: k3 ^= (uint32_t)tail[11] << 24; [[fallthrough]];
    case 11: k3 ^= (uint32_t)tail[10] << 16; [[fallthrough]];
    case 10: k3 ^= (uint32_t)tail[9] << 8; [[fallthrough]];
    case 9:  k3 ^= (uint32_t)tail[8] << 0;
             k3 *= c3; k3 = rotl32(k3, 17); k3 *= c4; h3 ^= k3; [[fallthrough]];
    case 8:  k2 ^= (uint32_t)tail[7] << 24; [[fallthrough]];
    case 7:  k2 ^= (uint32_t)tail[6] << 16; [[fallthrough]];
    case 6:  k2 ^= (uint32_t)tail[5] << 8; [[fallthrough]];
    case 5:  k2 ^= (uint32_t)tail[4] << 0;
             k2 *= c2; k2 = rotl32(k2, 16); k2 *= c3; h2 ^= k2; [[fallthrough]];
    case 4:  k1 ^= (uint32_t)tail[3] << 24; [[fallthrough]];
    case 3:  k1 ^= (uint32_t)tail[2] << 16; [[fallthrough]];
    case 2:  k1 ^= (uint32_t)tail[1] << 8; [[fallthrough]];
    case 1:  k1 ^= (uint32_t)tail[0] << 0;
             k1 *= c1; k1 = rotl32(k1, 15); k1 *= c2; h1 ^= k1;
  }

  h1 ^= (uint32_t)len; h2 ^= (uint32_t)len;
  h3 ^= (uint32_t)len; h4 ^= (uint32_t)len;
  h1 += h2 + h3 + h4;
  h2 += h1; h3 += h1; h4 += h1;
  h1 = fmix32(h1); h2 = fmix32(h2); h3 = fmix32(h3); h4 = fmix32(h4);
  h1 += h2 + h3 + h4;
  h2 += h1;
  return ((uint64_t)h2 << 32) | (uint64_t)h1;
}

// Hash n concatenated strings: string i is data[offsets[i], offsets[i+1]).
void murmur3_u64_batch(const uint8_t* data, const int64_t* offsets, int64_t n,
                       uint32_t seed, uint64_t* out) {
  for (int64_t i = 0; i < n; i++) {
    out[i] = murmur3_u64(data + offsets[i], offsets[i + 1] - offsets[i], seed);
  }
}

}  // extern "C"
