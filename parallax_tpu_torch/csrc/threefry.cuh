// Device code shared by the threefry draws (threefry.cu) and the lander's
// terrain sampler (lander_terrain.cu): jax.random's threefry2x32 hash, a
// key read from its row, and prng.uniform's float from 32 random bits.
// The bits are utils/prng.py's torch bodies'.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

struct Words {
  uint32_t a, b;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

// threefry2x32 of the counters (x1, x2) under the key (k1, k2): 5 groups
// of 4 rounds, a key injection after each group
__device__ __forceinline__ Words threefry2x32(Words k, uint32_t x1, uint32_t x2) {
  const uint32_t ks[3] = {k.a, k.b, k.a ^ k.b ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x1 += ks[0];
  x2 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x1 += x2;
      x2 = rotl(x2, rot[i % 2][j]) ^ x1;
    }
    x1 += ks[(i + 1) % 3];
    x2 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return {x1, x2};
}

// keys are int64 words holding uint32 values, rows `stride` words apart
// with the two words of a key adjacent
__device__ __forceinline__ Words key_at(const int64_t* keys, long long row, long long stride) {
  const int64_t* k = keys + row * stride;
  return {(uint32_t)k[0], (uint32_t)k[1]};
}

// prng.uniform's float from 32 random bits, for bounds lo and lo + span
// (float32 values, and their float32 difference, held in double)
__device__ __forceinline__ float uniform_of(uint32_t bits, double lo, double span) {
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  const float r = __double2float_rn(__dadd_rn(__dmul_rn((double)f, span), lo));
  const float flo = (float)lo;
  return r < flo ? flo : r;
}

int blocks_for(long long threads) {
  return (int)((threads + THREADS - 1) / THREADS);
}

}  // namespace
