// Packed trilinear stencil table, built straight from the grid (K3).
//
// Replaces dvren_tpu/ops/packed_transpose.py::stack_to_u16_rows
// (_t_split_kernel) together with the XLA shift stack that feeds it
// (dvren_tpu/ops/grid.py::_shift_stack_fullpitch): row v of the (R, 32)
// float32 table holds, at column ch*8 + dz*4 + dy*2 + dx, the value
// plane_ch[v + dz*Y*X + dy*X + dx], zero past the end of the grid, where
// plane 0 is sigma (Z,Y,X) and planes 1..3 are the channels of color
// (Z,Y,X,3).
//
// The TPU kernel split each f32 into hi/lo u16 halves because TPU gathers
// are paced by element type; the card has no such cost, so this kernel
// writes the f32 table (bit-identical to hi<<16|lo of the TPU rows).
//
// Bound on the H100: bytes. At 64^3 it reads 4.2 MB (sigma + color) and
// writes 33.6 MB, with no arithmetic to speak of. Design: one thread per
// table row, 32 loads that neighbouring threads issue at neighbouring
// addresses (each corner is a unit-stride stream over v; color's stride
// is 3 floats), and eight 16-byte stores per row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void packed_table_kernel(const float* __restrict__ sigma,
                                    const float* __restrict__ color,
                                    float4* __restrict__ out,
                                    int64_t n_cells, int64_t n_rows,
                                    int64_t yx, int64_t x) {
  const int64_t v = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (v >= n_rows) return;
  float vals[32];
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    const int64_t src = v + ((corner >> 2) & 1) * yx + ((corner >> 1) & 1) * x
                        + (corner & 1);
    const bool in = src < n_cells;
    vals[corner] = in ? sigma[src] : 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      vals[(c + 1) * 8 + corner] = in ? color[src * 3 + c] : 0.0f;
    }
  }
  float4* row = out + v * 8;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    row[q] = make_float4(vals[q * 4], vals[q * 4 + 1], vals[q * 4 + 2],
                         vals[q * 4 + 3]);
  }
}

}  // namespace

extern "C" int dvt_packed_table(const float* sigma, const float* color,
                                float* out, int z, int y, int x, int n_rows,
                                void* stream) {
  const int64_t n_cells = (int64_t)z * y * x;
  const int threads = 256;
  const int64_t blocks = (n_rows + threads - 1) / threads;
  if (blocks > 0) {
    packed_table_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
        sigma, color, reinterpret_cast<float4*>(out), n_cells, n_rows,
        (int64_t)y * x, (int64_t)x);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* dvt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
