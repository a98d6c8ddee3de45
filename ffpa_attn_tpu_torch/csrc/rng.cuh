// The attention-dropout hash of ops/rng.py, for the kernels that apply or
// replay dropout (flash_fwd.cu, flash_bwd.cu): a murmur3-finalizer combine
// over (seed, b, h, row, col) in uint32 arithmetic, giving one fixed
// uniform per logical score element whatever the tiling. The forward and
// the backward see the same bits, and so do the plain PyTorch versions.
#pragma once

#include <stdint.h>

namespace ffpa {

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t hash_combine(uint32_t state, uint32_t value) {
  return fmix32(state ^ (value + 0x9E3779B9u + (state << 6) + (state >> 2)));
}

// uniform_for_scores: float32 in [0, 1) from the top 24 bits of the hash.
// row and col are global Q-row / KV-col ids.
__device__ __forceinline__ float dropout_uniform(uint32_t seed, int b, int h, int row, int col) {
  uint32_t s = fmix32(seed ^ 0x46465041u);  // 'FFPA'
  s = hash_combine(s, (uint32_t)b);
  s = hash_combine(s, (uint32_t)h);
  s = hash_combine(s, (uint32_t)row);
  s = hash_combine(s, (uint32_t)col);
  return (float)(s >> 8) * (1.0f / 16777216.0f);
}

}  // namespace ffpa
