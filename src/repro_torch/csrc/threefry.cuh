// The Threefry-2x32 counter hash on the card, bit for bit the port's
// repro_torch/core/prng.py (and so jax.random's default generator with
// the partitionable layout): 20 rounds in five groups of four, rotations
// (13, 15, 26, 6) and (17, 29, 16, 24) in turns, a key injection after
// each group with the third key word k0 ^ k1 ^ 0x1BD11BDA.
//
// Element i of a draw hashes the 64-bit counter i as (hi, lo) words; its
// 32 random bits are y0 ^ y1 of the hash, and its unit float puts the top
// 23 of them under exponent 0 (a float in [1, 2)) and subtracts 1, which
// is exact. A kernel that draws from (key, i) itself so gives the bytes a
// plain-torch prng.uniform(key, shape) draw would have given, without the
// 4-byte uniform ever reaching device memory.
//
// Costs about 70 32-bit integer instructions an element (an add, a funnel
// shift and an xor a round): a kernel that draws for every element it
// moves is bound by the card's integer rate, not its memory.
#pragma once

#include <stdint.h>

namespace threefry {

struct Key {
  uint32_t k0, k1, k2;
};

__device__ __forceinline__ Key make_key(uint32_t k0, uint32_t k1) {
  return Key{k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
}

__device__ __forceinline__ void round4(uint32_t& x0, uint32_t& x1, int r0,
                                       int r1, int r2, int r3) {
  x0 += x1; x1 = __funnelshift_l(x1, x1, r0) ^ x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, r1) ^ x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, r2) ^ x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, r3) ^ x0;
}

// The hash of counter (x0, x1) under key; returns (y0, y1).
__device__ __forceinline__ uint2 hash(const Key& k, uint32_t x0,
                                      uint32_t x1) {
  x0 += k.k0;
  x1 += k.k1;
  round4(x0, x1, 13, 15, 26, 6);
  x0 += k.k1; x1 += k.k2 + 1u;
  round4(x0, x1, 17, 29, 16, 24);
  x0 += k.k2; x1 += k.k0 + 2u;
  round4(x0, x1, 13, 15, 26, 6);
  x0 += k.k0; x1 += k.k1 + 3u;
  round4(x0, x1, 17, 29, 16, 24);
  x0 += k.k1; x1 += k.k2 + 4u;
  round4(x0, x1, 13, 15, 26, 6);
  x0 += k.k2; x1 += k.k0 + 5u;
  return make_uint2(x0, x1);
}

// 32 random bits of element i (< 2^32) of a draw: prng.random_bits.
__device__ __forceinline__ uint32_t bits(const Key& k, uint32_t i) {
  const uint2 y = hash(k, 0u, i);
  return y.x ^ y.y;
}

// [0, 1) from 32 random bits: prng.bits_to_unit.
__device__ __forceinline__ float unit(uint32_t b) {
  return __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
}

// Element i of prng.uniform(key, shape) (minval 0, maxval 1).
__device__ __forceinline__ float uniform(const Key& k, uint32_t i) {
  return unit(bits(k, i));
}

}  // namespace threefry
