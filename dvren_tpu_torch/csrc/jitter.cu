// Stratified sampling jitter on the device.
//
// Replaces no Pallas kernel. It is the device half of
// dvren_tpu/ops/rng.py:63-107 (mix_seed, stratified_jitter): the jitter
// of (seed, ray, step) that JAX hashes inside the sampling graph with a
// splitmix64 emulated on uint32 pairs. Without it the port gathered each
// stratified lattice's jitter from a host table and uploaded it per call
// (33.5 M values at the dense headline).
//
// out[r, c] = splitmix64(seed ^ (u32(ray) << 32) ^ u32(step)), low 52 bits
// over 2^52, rounded once to float32, where ray and step are read through
// their (row, column) strides (0 on a broadcast axis) and, when bounds are
// given, clamped to [0, ray_max] and [0, step_max] first (the rows and
// columns of the plan's host table). The hash runs on native 64-bit
// integers and the scale in double, so the values equal the host table's
// (dvren_tpu_torch/ops/rng.py::jitter_table) bit for bit; JAX's float32
// emulation is within one float32 ulp of them.
//
// Bound on the H100: bytes. Each value is written once (4 bytes), and each
// step index read once where the steps are a full (N, K) array; the hash
// (about 12 integer operations) stays far below the integer rate. One warp
// per row: the row's ray index is loaded once, the lanes walk its columns
// (neighbouring lanes write neighbouring words).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ uint64_t mix(uint64_t s) {
  s = (s ^ (s >> 30)) * 0xBF58476D1CE4E5B9ull;
  s = (s ^ (s >> 27)) * 0x94D049BB133111EBull;
  return s ^ (s >> 31);
}

__device__ __forceinline__ int64_t clamp_to(int64_t v, int64_t hi) {
  if (hi < 0) return v;  // no bound
  return v < 0 ? 0 : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
stratified_jitter_kernel(const int64_t* __restrict__ ray, int64_t ray_s0,
                         int64_t ray_s1, const int32_t* __restrict__ step,
                         int64_t step_s0, int64_t step_s1,
                         float* __restrict__ out, int64_t rows, int cols,
                         int64_t ray_max, int64_t step_max, uint64_t seed) {
  const int lane = threadIdx.x & 31;
  const int64_t r =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int64_t* ray_row = ray + r * ray_s0;
  const int32_t* step_row = step + r * step_s0;
  float* out_row = out + r * (int64_t)cols;
  for (int c = lane; c < cols; c += 32) {
    const int64_t ri = clamp_to(ray_row[c * ray_s1], ray_max);
    const int64_t si = clamp_to((int64_t)step_row[c * step_s1], step_max);
    const uint64_t s = seed ^ ((uint64_t)(uint32_t)ri << 32) ^
                       (uint64_t)(uint32_t)si;
    const uint64_t h = mix(s);
    out_row[c] =
        (float)((double)(h & 0x000FFFFFFFFFFFFFull) * 0x1p-52);
  }
}

}  // namespace

extern "C" int dvt_stratified_jitter(const int64_t* ray, long long ray_s0,
                                     long long ray_s1, const int32_t* step,
                                     long long step_s0, long long step_s1,
                                     float* out, long long rows, int cols,
                                     long long ray_max, long long step_max,
                                     unsigned long long seed, void* stream) {
  if (rows > 0 && cols > 0) {
    const int64_t blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    stratified_jitter_kernel<<<(unsigned)blocks, 32 * kWarpsPerBlock, 0,
                               (cudaStream_t)stream>>>(
        ray, ray_s0, ray_s1, step, step_s0, step_s1, out, rows, cols,
        ray_max, step_max, seed);
  }
  return (int)cudaGetLastError();
}
