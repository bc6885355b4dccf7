// jax.random's threefry2x32 split and draws, one thread per output.
//
// Replaces no TPU kernel: the JAX package leaves threefry2x32 to XLA, which
// fuses the hash's integer operations into one loop.  In plain torch each
// of the hash's ~150 operations (uint32 adds, rotates and xors, held in
// int64 and masked back to 32 bits) is a launch of its own, so a fleet
// step's auto-reset draw was ~1,550 launches on the lander and its
// billiards jitter moved 50-75 MB per operation.  utils/prng.py's torch
// bodies are the plain versions; the bits here are theirs:
//
//   * threefry_split: keys [N, 2] -> [N, num, 2], key i the hash of the
//     counters (0, first + i) (jax.random.split; fold_in is num 1, first
//     the data);
//   * threefry_uniform: keys [N, 2] -> [N, n], value i the bits b1 ^ b2 of
//     the counters (0, i) (jax.random.bits), or jax.random.uniform's float:
//     the top 23 bits as the mantissa of a float in [1, 2), minus 1, then
//     f * span + lo in double (each rounded alone), once to float and
//     clamped at lo, as prng.uniform computes it.
//
// Keys are read in place through a row stride (threefry.cuh), so a slice
// such as keys[:, 0] of a split needs no copy.  What bounds it: integer
// operations, ~74 per hash (20 rounds of add, rotate and xor, 6 key
// injections); billiards48's jitter at B=32,768 is 3.1 M hashes, ~230 M
// operations and 12.8 MB.  That is microseconds: one launch in place of
// hundreds is the point.  Built with --fmad=false; the epilogue's multiply
// and add are the _rn intrinsics anyway, so they round as torch's do.

#include "threefry.cuh"

namespace {

__global__ void __launch_bounds__(THREADS) threefry_split_kernel(
    const int64_t* keys, long long stride, long long N, int num, uint32_t first,
    int64_t* out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= N * num) return;
  const long long row = t / num;
  const Words w = threefry2x32(key_at(keys, row, stride), 0u,
                               first + (uint32_t)(t - row * num));
  out[2 * t] = w.a;
  out[2 * t + 1] = w.b;
}

__global__ void __launch_bounds__(THREADS) threefry_uniform_kernel(
    const int64_t* keys, long long stride, long long N, long long n, double lo,
    double span, int raw, void* out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= N * n) return;
  const long long row = t / n;
  const Words w = threefry2x32(key_at(keys, row, stride), 0u, (uint32_t)(t - row * n));
  const uint32_t bits = w.a ^ w.b;
  if (raw) {
    ((int64_t*)out)[t] = bits;
  } else {
    ((float*)out)[t] = uniform_of(bits, lo, span);
  }
}

bool too_many(long long threads) {
  return threads <= 0 || (threads + THREADS - 1) / THREADS > 0x7FFFFFFFLL;
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError().  keys are N rows
// of two int64 words (uint32 values), `stride` words apart (0 repeats one
// key); the outputs are contiguous.

// out [N, num, 2] int64: key i of row r is the hash of (0, first + i)
extern "C" int threefry_split(const int64_t* keys, long long stride, long long N, int num,
                              unsigned first, int64_t* out, void* stream) {
  if (num <= 0 || too_many(N * num)) return (int)cudaErrorInvalidValue;
  threefry_split_kernel<<<blocks_for(N * num), THREADS, 0, (cudaStream_t)stream>>>(
      keys, stride, N, num, first, out);
  return (int)cudaGetLastError();
}

// out [N, n]: int64 bits where raw is 1, else float32 uniform draws in
// [lo, lo + span) (lo and span as prng.uniform computes them)
extern "C" int threefry_uniform(const int64_t* keys, long long stride, long long N,
                                long long n, double lo, double span, int raw, void* out,
                                void* stream) {
  if (n <= 0 || n > 0xFFFFFFFFLL || too_many(N * n)) return (int)cudaErrorInvalidValue;
  threefry_uniform_kernel<<<blocks_for(N * n), THREADS, 0, (cudaStream_t)stream>>>(
      keys, stride, N, n, lo, span, raw, out);
  return (int)cudaGetLastError();
}
