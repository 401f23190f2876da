// 16-bit packed trilinear stencil table, built straight from the grid (K5a).
//
// Replaces dvren_tpu/ops/packed_transpose.py::stack_to_rows (_t_fwd_kernel)
// on the route dvren_tpu/ops/grid.py::_build_fullpitch takes for a
// bfloat16 or float16 table: the XLA shift stack, its cast to the table
// dtype, then the Pallas (32, P) -> (P, 32) transpose. As K3
// (csrc/packed_table.cu) does for float32, this kernel fuses all three:
// row v of the (R, 32) table holds, at column ch*8 + dz*4 + dy*2 + dx, the
// value plane_ch[v + dz*Y*X + dy*X + dx] rounded to the table type (round
// to nearest even, __float2bfloat16_rn / __float2half_rn), zero past the
// end of the grid; plane 0 is sigma (Z,Y,X), planes 1..3 the channels of
// color (Z,Y,X,3). Bit-equal to the plain twin
// (dvren_tpu_torch/ops/packed_transpose.py::build_rows16_plain), whose
// cast is torch's round to nearest even.
//
// Bound on the H100: bytes. At 64^3 it reads 4.2 MB and writes 16.8 MB
// (half of K3's table). Design: K3's, one thread per table row with the
// same 32 unit-stride loads, and four 16-byte stores per 64-byte row.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

struct ToBf16 {
  __device__ static unsigned short bits(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

struct ToHalf {
  __device__ static unsigned short bits(float v) {
    return __half_as_ushort(__float2half_rn(v));
  }
};

template <typename Cvt>
__global__ void packed_table16_kernel(const float* __restrict__ sigma,
                                      const float* __restrict__ color,
                                      uint4* __restrict__ out,
                                      int64_t n_cells, int64_t n_rows,
                                      int64_t yx, int64_t x) {
  const int64_t v = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (v >= n_rows) return;
  unsigned short bits[32];
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    const int64_t src = v + ((corner >> 2) & 1) * yx + ((corner >> 1) & 1) * x
                        + (corner & 1);
    const bool in = src < n_cells;
    bits[corner] = Cvt::bits(in ? sigma[src] : 0.0f);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      bits[(c + 1) * 8 + corner] = Cvt::bits(in ? color[src * 3 + c] : 0.0f);
    }
  }
  uint4* row = out + v * 4;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const unsigned short* b = bits + q * 8;
    row[q] = make_uint4((uint32_t)b[0] | ((uint32_t)b[1] << 16),
                        (uint32_t)b[2] | ((uint32_t)b[3] << 16),
                        (uint32_t)b[4] | ((uint32_t)b[5] << 16),
                        (uint32_t)b[6] | ((uint32_t)b[7] << 16));
  }
}

}  // namespace

// kind: 0 bfloat16, 1 float16.
extern "C" int dvt_packed_table16(const float* sigma, const float* color,
                                  void* out, int z, int y, int x, int n_rows,
                                  int kind, void* stream) {
  if (kind != 0 && kind != 1) return (int)cudaErrorInvalidValue;
  const int64_t n_cells = (int64_t)z * y * x;
  const int threads = 256;
  const int64_t blocks = (n_rows + threads - 1) / threads;
  if (blocks > 0) {
    uint4* rows = reinterpret_cast<uint4*>(out);
    if (kind == 0) {
      packed_table16_kernel<ToBf16><<<(unsigned)blocks, threads, 0,
                                      (cudaStream_t)stream>>>(
          sigma, color, rows, n_cells, n_rows, (int64_t)y * x, (int64_t)x);
    } else {
      packed_table16_kernel<ToHalf><<<(unsigned)blocks, threads, 0,
                                      (cudaStream_t)stream>>>(
          sigma, color, rows, n_cells, n_rows, (int64_t)y * x, (int64_t)x);
    }
  }
  return (int)cudaGetLastError();
}
