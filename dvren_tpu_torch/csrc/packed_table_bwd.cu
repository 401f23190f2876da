// Table-gradient unpack (K4): (R, 32) f32 packed-table gradient ->
// d_sigma (Z, Y, X) and d_color (Z, Y, X, 3).
//
// Replaces dvren_tpu/ops/packed_transpose.py::u16_rows_to_stack
// (_t_merge_kernel) together with the 32 shifted plane adds that follow
// it (dvren_tpu/ops/grid.py::stack_plane_grads), just as K3
// (csrc/packed_table.cu) fuses the forward shift stack. The TPU kernel's
// u16 hi/lo rows served its gathers only; here the gradient stays f32.
//
// K3 wrote table row r, column ch*8 + corner, from plane_ch[r + off]
// with off = dz*Y*X + dy*X + dx, so the adjoint is a gather: voxel v of
// channel ch sums table_grad[v - off, ch*8 + corner] over the 8 corners
// with v - off >= 0 (v - off < R always holds, since v < Z*Y*X <= R).
// The sum runs from 0 in corner order, adding 0 for a missing row, as the
// plain twin (dvren_tpu_torch/ops/grid.py::stack_plane_grads, zero-padded
// shifts) does: the two agree bit for bit, with no atomics.
//
// Bound on the H100: bytes. At 64^3 it reads the 33.6 MB table once (each
// element by one voxel) and writes 4.2 MB. One thread per voxel; a warp's
// reads for one corner cover 32 consecutive 128-byte rows, of which it
// uses 16 bytes each, and the other corners of the same rows come back
// from L1/L2 to neighbouring warps.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void packed_table_grad_kernel(const float* __restrict__ tg,
                                         float* __restrict__ d_sigma,
                                         float* __restrict__ d_color,
                                         int64_t n_cells, int64_t yx,
                                         int64_t x) {
  const int64_t v = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (v >= n_cells) return;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    const int64_t src = v - (((corner >> 2) & 1) * yx
                             + ((corner >> 1) & 1) * x + (corner & 1));
    const float* row = tg + src * 32 + corner;
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      acc[ch] = __fadd_rn(acc[ch], src >= 0 ? row[ch * 8] : 0.f);
    }
  }
  d_sigma[v] = acc[0];
#pragma unroll
  for (int c = 0; c < 3; ++c) d_color[v * 3 + c] = acc[1 + c];
}

}  // namespace

extern "C" int dvt_packed_table_grad(const float* table_grad, float* d_sigma,
                                     float* d_color, int z, int y, int x,
                                     void* stream) {
  const int64_t n_cells = (int64_t)z * y * x;
  const int threads = 256;
  const int64_t blocks = (n_cells + threads - 1) / threads;
  if (blocks > 0) {
    packed_table_grad_kernel<<<(unsigned)blocks, threads, 0,
                               (cudaStream_t)stream>>>(
        table_grad, d_sigma, d_color, n_cells, (int64_t)y * x, (int64_t)x);
  }
  return (int)cudaGetLastError();
}
