// Packed trilinear stencil table, built straight from the grid (K3).
//
// Replaces dvren_tpu/ops/packed_transpose.py::stack_to_u16_rows
// (_t_split_kernel) together with the XLA shift stack that feeds it
// (dvren_tpu/ops/grid.py::_shift_stack_fullpitch): row v of the (R, 32)
// float32 table holds, at column ch*8 + dz*4 + dy*2 + dx, the value
// plane_ch[v + dz*Y*X + dy*X + dx], zero past the end of the grid, where
// plane 0 is sigma (Z,Y,X) and planes 1..3 are the channels of color
// (Z,Y,X,3). The offsets are flat: x + 1 at X - 1 is the next line's
// first voxel, and at X = 1 or Y = 1 two corners share a source.
//
// The TPU kernel split each f32 into hi/lo u16 halves because TPU gathers
// are paced by element type; the card has no such cost, so this kernel
// writes the f32 table (bit-identical to hi<<16|lo of the TPU rows). The
// values are moved, never computed on, so NaN payloads and -0.0 pass.
//
// Bound on the H100: bytes. At 64^3 it reads 4.2 MB (sigma + color) and
// writes 33.6 MB (0.0113 ms at 3.35 TB/s); at 128^3 8x that (0.0901 ms).
// The stores are 89 % of the bytes, so they set the design: a block owns
// `rows` consecutive rows and writes them as one contiguous stretch, a
// warp's float4 stores covering 512 contiguous bytes. Before that it
// stages, coalesced, the four source spans the rows read (for each
// (dz, dy), rows + 1 values of every channel, zero past the grid) in
// shared memory as 16 planes, plane dy*8 + ch*2 + dz with a stride of
// 4 mod 32 floats, so that the row's 16-byte word q = ch*2 + dz is planes
// q and 8 + q at the row's voxel and the next one and a warp's reads hit
// 32 banks. The inputs are an eighth of the bytes, so reading each four
// times from the L2 costs little. The launch geometry comes from
// ops/packed_transpose.py::table_tiling.
//
// Device ms (the stream asleep while the host queues the calls) on an
// NVIDIA H100 80GB HBM3 at 700 W, tools/torch_packed_table_times.py, the
// earlier design (one thread a row: 32 scalar loads, eight 16-byte stores
// to its own row, so a warp's store touched 32 rows) -> this one: 64^3
// 0.0404 -> 0.0197, 128^3 0.3484 -> 0.1181 (bound 0.0113 / 0.0901). The
// loads in one round (17 a thread) or 128 rows a block change nothing
// (0.0193); the 64^3 grid's 1,024 blocks run as one wave, so the loads
// and the stores do not overlap there.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 8;     // staged values a thread loads before storing

__global__ void __launch_bounds__(kThreads)
packed_table_kernel(const float* __restrict__ sigma,
                    const float* __restrict__ color,
                    float4* __restrict__ out, int64_t n_cells,
                    int64_t n_rows, int64_t yx, int64_t x, int rows,
                    int stride) {
  extern __shared__ float stage[];
  const int64_t v0 = blockIdx.x * (int64_t)rows;
  const int n = rows + 1;       // voxels a span
  const int per_seg = 4 * n;    // sigma, then color's 3n floats
  const int total = 4 * per_seg;
  for (int e0 = threadIdx.x; e0 < total; e0 += kBatch * blockDim.x) {
    float val[kBatch];
    int dst[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int e = e0 + j * blockDim.x;
      val[j] = 0.0f;
      dst[j] = -1;
      if (e < total) {
        const int seg = e / per_seg;       // dz * 2 + dy
        const int dz = seg >> 1, dy = seg & 1;
        const int t = e - seg * per_seg;
        const int64_t s0 = v0 + dz * yx + dy * x;
        if (t < n) {
          if (s0 + t < n_cells) val[j] = sigma[s0 + t];
          dst[j] = (dy * 8 + dz) * stride + t;
        } else {
          const int c = t - n;             // color float c of the span
          const int vox = c / 3;
          const int ch = 1 + c - 3 * vox;
          if (s0 + vox < n_cells) val[j] = color[3 * s0 + c];
          dst[j] = (dy * 8 + ch * 2 + dz) * stride + vox;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (dst[j] >= 0) stage[dst[j]] = val[j];
    }
  }
  __syncthreads();
  const int64_t n_out = (n_rows - v0 < rows ? n_rows - v0 : rows) * 8;
  float4* dst = out + v0 * 8;
  for (int f = threadIdx.x; f < n_out; f += blockDim.x) {
    const int i = f >> 3;
    const float* lo = stage + (f & 7) * stride + i;         // dy = 0
    const float* hi = stage + (8 + (f & 7)) * stride + i;   // dy = 1
    dst[f] = make_float4(lo[0], lo[1], hi[0], hi[1]);
  }
}

}  // namespace

extern "C" int dvt_packed_table(const float* sigma, const float* color,
                                float* out, int z, int y, int x, int n_rows,
                                int rows, int stride, int blocks,
                                int smem_bytes, void* stream) {
  static int smem_set = 48 * 1024;
  if (rows < 1 || rows > kThreads || stride < rows + 1
      || (int64_t)blocks * rows < n_rows || smem_bytes < 16 * stride * 4) {
    return (int)cudaErrorInvalidValue;
  }
  if (smem_bytes > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        packed_table_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem_bytes;
  }
  if (blocks > 0) {
    packed_table_kernel<<<blocks, rows, smem_bytes,
                          (cudaStream_t)stream>>>(
        sigma, color, reinterpret_cast<float4*>(out),
        (int64_t)z * y * x, n_rows, (int64_t)y * x, (int64_t)x, rows,
        stride);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* dvt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
