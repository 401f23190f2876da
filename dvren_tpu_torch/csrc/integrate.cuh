// What K9f (integrate.cu) and K9b (integrate_bwd.cu) share: the launch
// geometry's constants, the warp scans and a ray's row held in registers.
//
// A warp owns a ray. Its row is walked in groups of C 32-step chunks
// (C <= kMaxChunks); lane j holds steps g0 + j, g0 + 32 + j, ... of the
// group from step g0, so each chunk's load is one 128-byte line per plane
// and every load of a group is issued before the group's first scan.
// ops/integrate_fused.py::launch_geometry picks C and the blocks.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace dvt_integrate {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;  // integrate_fused.WARPS_PER_BLOCK
constexpr int kMaxChunks = 4;      // integrate_fused.REGISTER_CHUNKS

// lane j gets the sum of v over lanes 0..j (Hillis-Steele: lane j adds
// lane j - off for off = 1, 2, 4, 8, 16; ops/integrate.py::scan_prefix)
__device__ __forceinline__ float warp_incl_scan(float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += u;
  }
  return v;
}

// lane j gets the sum of v over lanes j..31
__device__ __forceinline__ float warp_suffix_scan(float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_down_sync(kFull, v, off);
    if (lane + off < 32) v += u;
  }
  return v;
}

// The C chunks of a ray's row from step g0, one step per lane and chunk;
// steps at or past `end` read as dead (sigma, dt, colours 0, mask off).
template <int C>
struct Row {
  float sg[C], dv[C], cr[C], cg[C], cb[C];
  bool lv[C];
};

template <int C, bool kColours>
__device__ __forceinline__ void load_row(
    Row<C>& row, const float* __restrict__ sigma,
    const float* __restrict__ dt, const uint8_t* __restrict__ mask,
    const float* __restrict__ cr, const float* __restrict__ cg,
    const float* __restrict__ cb, int64_t base, int g0, int end, int lane) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int kk = g0 + 32 * c + lane;
    row.sg[c] = 0.0f;
    row.dv[c] = 0.0f;
    row.lv[c] = false;
    row.cr[c] = 0.0f;
    row.cg[c] = 0.0f;
    row.cb[c] = 0.0f;
    if (kk < end) {
      row.sg[c] = sigma[base + kk];
      row.dv[c] = dt[base + kk];
      row.lv[c] = mask[base + kk] != 0;
      if (kColours) {
        row.cr[c] = cr[base + kk];
        row.cg[c] = cg[base + kk];
        row.cb[c] = cb[base + kk];
      }
    }
  }
}

// Registers, local memory (bytes per thread: stack and spills) and
// resident blocks per SM of `kernel`: out[0..2].
template <typename Kernel>
int occupancy(Kernel kernel, int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel, 32 * kWarpsPerBlock, 0);
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = blocks;
  return (int)err;
}

// A launch's geometry as ops/integrate_fused.py::launch_geometry gives it:
// 1 <= chunks <= kMaxChunks, a row longer than its chunks walked in groups
// only at kMaxChunks, and one warp per ray.
inline bool geometry_ok(int n, int k, int chunks, int blocks) {
  if (chunks < 1 || chunks > kMaxChunks) return false;
  if (k > 32 * chunks && chunks != kMaxChunks) return false;
  return (int64_t)blocks * kWarpsPerBlock >= n &&
         (int64_t)(blocks - 1) * kWarpsPerBlock < n;
}

}  // namespace dvt_integrate
