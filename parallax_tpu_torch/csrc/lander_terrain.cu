// The lander's terrain sampler, one thread per world.
//
// envs/lunar_lander.py:terrain_planes_batch whole, from each world's key
// to its [7, V, B] vertex planes: the optional first split (the
// auto-reset draws from split(key)[0]), split(key, 5), the 8 heights and
// 4 positions, the quads, the stable 4-element sorting network on the
// pseudo-angle around each quad's centre (its sum in torch's order,
// ((a + b) + c) + d), and the repeat padding.  Its torch body,
// terrain_planes_plain, is the plain version; the bits are its.  In plain
// torch the sampler's post-processing was ~80 launches beside the
// hashes'.  What bounds it: at B=32,768 its 14.7 MB of planes take 4.4 us
// at 3.35 TB/s, its 18 hashes a world ~44 M integer operations.  Built
// without --use_fast_math: the pseudo-angle's division rounds as torch's.

#include "threefry.cuh"

namespace {

constexpr int N_TERRAIN = 7;  // quads of a lander terrain: 8 heights, 7 segments

// the uniform draw of counter i of key k in [lo, hi)
__device__ __forceinline__ float draw(Words k, uint32_t i, float lo, float hi) {
  const Words w = threefry2x32(k, 0u, i);
  return uniform_of(w.a ^ w.b, (double)lo, (double)(hi - lo));
}

// the terrain sampler's clockwise-ordering key (lunar_lander._pseudo_angle)
__device__ __forceinline__ float pseudo_angle(float dx, float dy) {
  const float p = dy / (fabsf(dx) + fabsf(dy));
  return dx >= 0.0f ? p : (dy >= 0.0f ? 2.0f - p : -2.0f - p);
}

__global__ void __launch_bounds__(THREADS) lander_terrain_kernel(
    const int64_t* keys, long long stride, int B, int split_first, int V,
    float* tox, float* toy) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  Words key = key_at(keys, b, stride);
  if (split_first) key = threefry2x32(key, 0u, 0u);
  Words ks[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) ks[j] = threefry2x32(key, 0u, (uint32_t)j);

  float h[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) h[m] = draw(ks[0], (uint32_t)m, -5.0f, 5.0f);
  h[0] = h[0] * 10.0f;
  h[3] = -2.0f;
  h[4] = -2.0f;
  h[7] = h[7] * 10.0f;
  const float x[8] = {-100.0f, draw(ks[1], 0u, -12.0f, -9.0f), draw(ks[2], 0u, -8.0f, -4.0f),
                      -2.0f, 2.0f, draw(ks[3], 0u, 4.0f, 8.0f), draw(ks[4], 0u, 9.0f, 12.0f),
                      100.0f};

  const int net[5][2] = {{0, 1}, {2, 3}, {0, 2}, {1, 3}, {1, 2}};
  for (int s = 0; s < N_TERRAIN; ++s) {
    float qx[4] = {x[s], x[s], x[s + 1], x[s + 1]};
    float qy[4] = {h[s], -10.0f, h[s + 1], -10.0f};
    const float cx = (((qx[0] + qx[1]) + qx[2]) + qx[3]) / 4.0f;
    const float cy = (((qy[0] + qy[1]) + qy[2]) + qy[3]) / 4.0f;
    float ang[4];
    int idx[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ang[j] = pseudo_angle(qx[j] - cx, qy[j] - cy);
      idx[j] = j;
    }
#pragma unroll
    for (int p = 0; p < 5; ++p) {
      const int i = net[p][0], j = net[p][1];
      if (ang[i] > ang[j] || (ang[i] == ang[j] && idx[i] > idx[j])) {
        float f = ang[i]; ang[i] = ang[j]; ang[j] = f;
        int k = idx[i]; idx[i] = idx[j]; idx[j] = k;
        f = qx[i]; qx[i] = qx[j]; qx[j] = f;
        f = qy[i]; qy[i] = qy[j]; qy[j] = f;
      }
    }
    for (int v = 0; v < V; ++v) {
      const int k = v < 3 ? v : 3;
      const long long o = ((long long)s * V + v) * B + b;
      tox[o] = qx[k];
      toy[o] = qy[k];
    }
  }
}

}  // namespace

// tox, toy [7, V, B] float32 (V >= 4): each world's terrain planes from its
// key, or from its key's first split where split_first is 1; keys as in
// threefry.cu.  Launches on `stream` and returns cudaGetLastError().
extern "C" int lander_terrain(const int64_t* keys, long long stride, int B, int split_first,
                              int V, float* tox, float* toy, void* stream) {
  if (B <= 0 || V < 4) return (int)cudaErrorInvalidValue;
  lander_terrain_kernel<<<blocks_for(B), THREADS, 0, (cudaStream_t)stream>>>(
      keys, stride, B, split_first, V, tox, toy);
  return (int)cudaGetLastError();
}
