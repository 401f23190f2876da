// 16-bit table-gradient unpack (K5b): (R, 32) bfloat16 or float16
// packed-table gradient -> d_sigma (Z, Y, X) and d_color (Z, Y, X, 3), f32.
//
// Replaces dvren_tpu/ops/packed_transpose.py::rows_to_stack (_t_fwd_kernel)
// on the adjoint dvren_tpu/ops/grid.py::_build_fullpitch_bwd takes for a
// 16-bit table: the cotangent cast to float32, the Pallas (P, 32) ->
// (32, P) transpose, then the 32 shifted plane adds of stack_plane_grads.
// K4's design (csrc/packed_table_bwd.cu) with a 16-bit input: voxel v of
// channel ch sums the widened table_grad[v - off, ch*8 + corner] over the
// 8 corners with v - off >= 0, from 0 in corner order, adding 0 for a
// missing row; a gather, no atomics. Widening is exact, so the result is
// bit-equal to the plain twin stack_plane_grads(g.float().T, shape)
// (dvren_tpu_torch/ops/packed_transpose.py::table16_grad_to_params_plain).
//
// Bound on the H100: bytes. At 64^3 it reads the 16.8 MB gradient once and
// writes 4.2 MB. One thread per voxel; a warp's reads for one corner cover
// 32 consecutive 64-byte rows, of which it uses 8 bytes each.

#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

struct FromBf16 {
  __device__ static float value(unsigned short b) {
    return __uint_as_float((uint32_t)b << 16);
  }
};

struct FromHalf {
  __device__ static float value(unsigned short b) {
    return __half2float(__ushort_as_half(b));
  }
};

template <typename Cvt>
__global__ void packed_table16_grad_kernel(
    const unsigned short* __restrict__ tg, float* __restrict__ d_sigma,
    float* __restrict__ d_color, int64_t n_cells, int64_t yx, int64_t x) {
  const int64_t v = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (v >= n_cells) return;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int corner = 0; corner < 8; ++corner) {
    const int64_t src = v - (((corner >> 2) & 1) * yx
                             + ((corner >> 1) & 1) * x + (corner & 1));
    const unsigned short* row = tg + src * 32 + corner;
#pragma unroll
    for (int ch = 0; ch < 4; ++ch) {
      acc[ch] = __fadd_rn(acc[ch],
                          src >= 0 ? Cvt::value(row[ch * 8]) : 0.f);
    }
  }
  d_sigma[v] = acc[0];
#pragma unroll
  for (int c = 0; c < 3; ++c) d_color[v * 3 + c] = acc[1 + c];
}

}  // namespace

// kind: 0 bfloat16, 1 float16.
extern "C" int dvt_packed_table16_grad(const void* table_grad, float* d_sigma,
                                       float* d_color, int z, int y, int x,
                                       int kind, void* stream) {
  if (kind != 0 && kind != 1) return (int)cudaErrorInvalidValue;
  const int64_t n_cells = (int64_t)z * y * x;
  const int threads = 256;
  const int64_t blocks = (n_cells + threads - 1) / threads;
  if (blocks > 0) {
    const unsigned short* tg = static_cast<const unsigned short*>(table_grad);
    if (kind == 0) {
      packed_table16_grad_kernel<FromBf16><<<(unsigned)blocks, threads, 0,
                                             (cudaStream_t)stream>>>(
          tg, d_sigma, d_color, n_cells, (int64_t)y * x, (int64_t)x);
    } else {
      packed_table16_grad_kernel<FromHalf><<<(unsigned)blocks, threads, 0,
                                             (cudaStream_t)stream>>>(
          tg, d_sigma, d_color, n_cells, (int64_t)y * x, (int64_t)x);
    }
  }
  return (int)cudaGetLastError();
}
