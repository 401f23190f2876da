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
// Bound on the H100: bytes. At 64^3 it reads the 33.6 MB table once and
// writes 4.2 MB (0.0113 ms at 3.35 TB/s); at 128^3 8x that (0.0901 ms).
// One thread a voxel reading its 32 values straight from the table would
// take 16 useful bytes of each 32-byte sector and fetch the rest again
// for the voxels X, Y*X and Y*X + X further on. Design: a block owns a
// run of `run` voxels of one z-plane and marches up z over `z_chunk`
// planes. For each plane it stages the table rows its run reads with
// dz = 0 (base - X - 1 to base + run - 1, or two spans of run + 1 rows
// when X > run + 1) in one of two shared-memory slots, as whole 128-byte
// rows read by 8 lanes with 16-byte loads; those rows are the ones the
// run of the next plane reads with dz = 1, so the ring of two slots reads
// each row about (run + X + 1) / run times rather than 4 times over 8
// sectors. The slots are column-major with an odd stride, so that the
// transposing stores and the sums' reads (lane i on row i + const of one
// column) hit 32 banks. Each voxel sums its 8 corners from the slots in
// corner order with __fadd_rn; d_sigma is stored coalesced and d_color
// goes out as 3 * run contiguous floats through shared memory. The launch
// geometry comes from ops/packed_transpose.py::grad_tiling.
//
// Device ms (the stream asleep while the host queues the calls) on an
// NVIDIA H100 80GB HBM3 at 700 W, tools/torch_packed_table_times.py, the
// earlier design (one thread a voxel, 32 scalar loads straight from the
// table) -> this one: 64^3 0.0374 -> 0.0182 (runs of 128, z-chunks of 4:
// 512 blocks, 4 an SM), 128^3 0.2700 -> 0.1459 (runs of 256, z-chunks of
// 16: 512 blocks, 2 an SM); bound 0.0113 / 0.0901. What is left follows
// the rows the ring reads again: runs of 128 at 128^3 (2.1 reads a row)
// take 0.173, of 512 (1.3, one block an SM) 0.157; the next plane's rows
// loaded into registers while a plane sums changed 0.0174 -> 0.0172 and
// 0.1496 -> 0.1548.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;
constexpr int kMaxThreads = 256;
constexpr int kBatch = 8;     // 16-byte pieces a thread loads, then stores

struct Geometry {
  int64_t n_cells, yx, x;
  int z, run, z_chunk, runs, lead, span, stride;
};

// Stage the rows of plane zi's run (base = zi * Y*X + p * run) into
// `slot`, column c at slot[c * stride + l], rows outside [0, n_cells) as
// 0: staged index l < lead is row base - X - 1 + l, the rest row
// base - 1 + (l - lead).
__device__ __forceinline__ void stage_rows(const float4* __restrict__ tg,
                                           float* slot, int64_t base,
                                           const Geometry& g) {
  const int total = g.span * 8;
  const int64_t first = base - g.x - 1;
  for (int e0 = threadIdx.x; e0 < total; e0 += kBatch * blockDim.x) {
    float4 val[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int e = e0 + j * blockDim.x;
      const int l = e >> 3;
      const int64_t row = l < g.lead ? first + l : base - 1 + (l - g.lead);
      val[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (e < total && row >= 0 && row < g.n_cells) {
        val[j] = tg[row * 8 + (e & 7)];
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int e = e0 + j * blockDim.x;
      if (e < total) {
        float* col = slot + (e & 7) * 4 * g.stride + (e >> 3);
        col[0] = val[j].x;
        col[g.stride] = val[j].y;
        col[2 * g.stride] = val[j].z;
        col[3 * g.stride] = val[j].w;
      }
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
packed_table_grad_kernel(const float4* __restrict__ tg,
                         float* __restrict__ d_sigma,
                         float* __restrict__ d_color, Geometry g) {
  extern __shared__ float smem[];
  float* out3 = smem + 2 * kCols * g.stride;   // d_color of one run
  const int p = blockIdx.x % g.runs;
  const int z0 = blockIdx.x / g.runs * g.z_chunk;
  const int z1 = min(z0 + g.z_chunk, g.z);
  const int64_t in_plane = (int64_t)p * g.run;
  const int n_valid =
      (int)(g.yx - in_plane < g.run ? g.yx - in_plane : g.run);
  const int i = threadIdx.x;
  // plane z's rows live in slot z & 1; the ring starts with plane z0 - 1
  stage_rows(tg, smem + ((z0 + 1) & 1) * kCols * g.stride,
             (int64_t)(z0 - 1) * g.yx + in_plane, g);
  for (int zi = z0; zi < z1; ++zi) {
    const int64_t base = (int64_t)zi * g.yx + in_plane;
    stage_rows(tg, smem + (zi & 1) * kCols * g.stride, base, g);
    __syncthreads();
    if (i < n_valid) {
      const float* slot[2] = {smem + (zi & 1) * kCols * g.stride,
                              smem + ((zi + 1) & 1) * kCols * g.stride};
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int corner = 0; corner < 8; ++corner) {
        const int dz = (corner >> 2) & 1, dy = (corner >> 1) & 1;
        const int dx = corner & 1;
        const float* src = slot[dz] + (dy ? 0 : g.lead) + i + 1 - dx;
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) {
          acc[ch] = __fadd_rn(acc[ch], src[(ch * 8 + corner) * g.stride]);
        }
      }
      d_sigma[base + i] = acc[0];
#pragma unroll
      for (int c = 0; c < 3; ++c) out3[3 * i + c] = acc[1 + c];
    }
    __syncthreads();
    for (int t = i; t < 3 * n_valid; t += blockDim.x) {
      d_color[3 * base + t] = out3[t];
    }
  }
}

}  // namespace

extern "C" int dvt_packed_table_grad(const float* table_grad, float* d_sigma,
                                     float* d_color, int z, int y, int x,
                                     int run, int z_chunk, int runs,
                                     int lead, int span, int stride,
                                     int blocks, int smem_bytes,
                                     void* stream) {
  static int smem_set = 48 * 1024;
  const Geometry g{(int64_t)z * y * x, (int64_t)y * x, (int64_t)x,
                   z, run, z_chunk, runs, lead, span, stride};
  // the staged index of voxel i's dy = 1 rows runs to i + 1 <= run, so
  // they are the first segment when lead = run + 1 and continue it when
  // lead = X
  if (run < 1 || run > kMaxThreads || z_chunk < 1
      || (lead != x && lead != run + 1) || span != lead + run + 1
      || stride < span || (int64_t)runs * run < g.yx
      || blocks != runs * ((z + z_chunk - 1) / z_chunk)
      || smem_bytes < (2 * kCols * stride + 3 * run) * 4) {
    return (int)cudaErrorInvalidValue;
  }
  if (smem_bytes > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        packed_table_grad_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          packed_table_grad_kernel,
          cudaFuncAttributePreferredSharedMemoryCarveout,
          (int)cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return (int)err;
    smem_set = smem_bytes;
  }
  if (blocks > 0) {
    packed_table_grad_kernel<<<blocks, run, smem_bytes,
                               (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(table_grad), d_sigma, d_color, g);
  }
  return (int)cudaGetLastError();
}
