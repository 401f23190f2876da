// Table-gradient unpack: (R, 32) packed-table gradient -> d_sigma
// (Z, Y, X) and d_color (Z, Y, X, 3), f32; from f32 rows (K4) or from
// bfloat16 / float16 rows (K5b).
//
// K4 replaces dvren_tpu/ops/packed_transpose.py::u16_rows_to_stack
// (_t_merge_kernel) together with the 32 shifted plane adds that follow
// it (dvren_tpu/ops/grid.py::stack_plane_grads), just as K3
// (csrc/packed_table.cu) fuses the forward shift stack. The TPU kernel's
// u16 hi/lo rows served its gathers only; here the gradient stays f32.
// K5b replaces dvren_tpu/ops/packed_transpose.py::rows_to_stack
// (_t_fwd_kernel) on the adjoint dvren_tpu/ops/grid.py::_build_fullpitch_bwd
// takes for a 16-bit table: the cotangent cast to float32, the (P, 32) ->
// (32, P) transpose, then stack_plane_grads. It is this kernel with a
// 16-bit row: widening is exact, so the sums below are the same.
//
// K3 wrote table row r, column ch*8 + corner, from plane_ch[r + off]
// with off = dz*Y*X + dy*X + dx, so the adjoint is a gather: voxel v of
// channel ch sums table_grad[v - off, ch*8 + corner] over the 8 corners
// with v - off >= 0 (v - off < R always holds, since v < Z*Y*X <= R).
// The sum runs from 0 in corner order, adding 0 for a missing row, as the
// plain twins (dvren_tpu_torch/ops/grid.py::stack_plane_grads, zero-padded
// shifts, after widening for K5b) do: they agree bit for bit, with no
// atomics.
//
// Bound on the H100: bytes. At 64^3 K4 reads the 33.6 MB table once and
// writes 4.2 MB (0.0113 ms at 3.35 TB/s), K5b reads 16.8 MB (0.0063 ms);
// at 128^3 8x that (0.0901 / 0.0501 ms). One thread a voxel reading its
// 32 values straight from the table would take a quarter or less of each
// 32-byte sector and fetch the rest again for the voxels X, Y*X and
// Y*X + X further on. Design: a block owns a run of `run` voxels of one
// z-plane and marches up z over `z_chunk` planes. For each plane it
// stages the table rows its run reads with dz = 0 (base - X - 1 to
// base + run - 1, or two spans of run + 1 rows when X > run + 1) in one of
// two shared-memory slots, as whole rows read with 16-byte loads (8 lanes
// a 128-byte f32 row, 4 a 64-byte 16-bit row); those rows are the ones
// the run of the next plane reads with dz = 1, so the ring of two slots
// reads each row about (run + X + 1) / run times rather than 4 times over
// its sectors. A slot is column-major: K4's holds 32 f32 columns, K5b's
// 16 columns of the 16-bit pair words as they came (word k of channel ch
// holds corners 2k and 2k + 1), half the shared memory of slots widened
// as staged. The strides (odd for 32 columns, 2 mod 4 for 16) make the
// transposing stores and the sums' reads (lane i on row i + const of one
// column) hit 32 banks. Each voxel sums its 8
// corners from the slots in corner order with __fadd_rn; d_sigma is
// stored coalesced and d_color goes out as 3 * run contiguous floats
// through shared memory. The launch geometry comes from
// ops/packed_transpose.py::grad_tiling.
//
// K4's device ms (the stream asleep while the host queues the calls) on
// an NVIDIA H100 80GB HBM3 at 700 W, tools/torch_packed_table_times.py,
// the earlier design (one thread a voxel, 32 scalar loads straight from
// the table) -> this one: 64^3 0.0374 -> 0.0182 (runs of 128, z-chunks of
// 4: 512 blocks, 4 an SM), 128^3 0.2700 -> 0.1459 (runs of 256, z-chunks
// of 16: 512 blocks, 2 an SM); bound 0.0113 / 0.0901. What is left follows
// the rows the ring reads again: runs of 128 at 128^3 (2.1 reads a row)
// take 0.173, of 512 (1.3, one block an SM) 0.157; the next plane's rows
// loaded into registers while a plane sums changed 0.0174 -> 0.0172 and
// 0.1496 -> 0.1548. K5b, bfloat16 (float16 the same): the first design
// (one thread a voxel, 32 two-byte loads straight from the table) 0.0192
// at 64^3, 0.1378 at 128^3; this kernel with K4's runs and z-chunks over
// 16-bit slots 0.0102 / 0.0763 (bound 0.0063 / 0.0501), over slots of
// widened floats 0.0110 / 0.0817 (not kept). At 64^3 runs of 128 in
// chunks of 2 or 4, or of 256 in chunks of 2, all take 0.0102-0.0103; at
// 128^3 chunks of 2, 4 or 8 take 0.078-0.080 and runs of 512 0.079.

#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBatch = 8;     // 16-byte pieces a thread loads, then stores

struct Geometry {
  int64_t n_cells, yx, x;
  int z, run, z_chunk, runs, lead, span, stride;
};

// A table row's element type, how a 16-byte piece of it is staged and how
// a staged corner is read back as a float.
struct RowF32 {      // K4: 8 pieces of 4 floats; 32 float columns
  using Piece = float4;
  static constexpr int kShift = 3, kSlotCols = 32, kMaxThreads = 256;
  __device__ static void put(uint32_t* slot, int stride, int piece, int l,
                             Piece v) {
    float* col = reinterpret_cast<float*>(slot) + piece * 4 * stride + l;
    col[0] = v.x;
    col[stride] = v.y;
    col[2 * stride] = v.z;
    col[3 * stride] = v.w;
  }
  __device__ static float get(const uint32_t* slot, int stride, int ch,
                              int corner, int l) {
    return __uint_as_float(slot[(ch * 8 + corner) * stride + l]);
  }
};

struct FromBf16 {
  __device__ static float value(uint32_t b) { return __uint_as_float(b << 16); }
};

struct FromHalf {
  __device__ static float value(uint32_t b) {
    return __half2float(__ushort_as_half((unsigned short)b));
  }
};

// K5b: 4 pieces, piece ch = channel ch's 8 corners as 4 pair words
// (corners 2k, 2k + 1 in word k's low, high half), staged as they came,
// word k of channel ch in column ch*4 + k; a corner is widened where it
// is summed.
template <typename Cvt>
struct RowHalf {
  using Piece = uint4;
  static constexpr int kShift = 2, kSlotCols = 16, kMaxThreads = 512;
  __device__ static void put(uint32_t* slot, int stride, int piece, int l,
                             Piece v) {
    uint32_t* col = slot + piece * 4 * stride + l;
    col[0] = v.x;
    col[stride] = v.y;
    col[2 * stride] = v.z;
    col[3 * stride] = v.w;
  }
  __device__ static float get(const uint32_t* slot, int stride, int ch,
                              int corner, int l) {
    const uint32_t w = slot[(ch * 4 + (corner >> 1)) * stride + l];
    return Cvt::value(corner & 1 ? w >> 16 : w & 0xFFFFu);
  }
};

// Stage the rows of plane zi's run (base = zi * Y*X + p * run) into
// `slot`, rows outside [0, n_cells) as 0: staged index l < lead is row
// base - X - 1 + l, the rest row base - 1 + (l - lead).
template <typename Row>
__device__ __forceinline__ void stage_rows(
    const typename Row::Piece* __restrict__ tg, uint32_t* slot, int64_t base,
    const Geometry& g) {
  constexpr int kPieces = 1 << Row::kShift;    // 16-byte pieces a row
  const int total = g.span * kPieces;
  const int64_t first = base - g.x - 1;
  for (int e0 = threadIdx.x; e0 < total; e0 += kBatch * blockDim.x) {
    typename Row::Piece val[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int e = e0 + j * blockDim.x;
      const int l = e >> Row::kShift;
      const int64_t row = l < g.lead ? first + l : base - 1 + (l - g.lead);
      val[j] = {};
      if (e < total && row >= 0 && row < g.n_cells) {
        val[j] = tg[row * kPieces + (e & (kPieces - 1))];
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int e = e0 + j * blockDim.x;
      if (e < total) {
        Row::put(slot, g.stride, e & (kPieces - 1), e >> Row::kShift,
                 val[j]);
      }
    }
  }
}

template <typename Row>
__global__ void __launch_bounds__(Row::kMaxThreads)
packed_table_grad_kernel(const typename Row::Piece* __restrict__ tg,
                         float* __restrict__ d_sigma,
                         float* __restrict__ d_color, Geometry g) {
  extern __shared__ uint32_t smem[];
  const int slot_words = Row::kSlotCols * g.stride;
  float* out3 = reinterpret_cast<float*>(smem + 2 * slot_words);
  const int p = blockIdx.x % g.runs;
  const int z0 = blockIdx.x / g.runs * g.z_chunk;
  const int z1 = min(z0 + g.z_chunk, g.z);
  const int64_t in_plane = (int64_t)p * g.run;
  const int n_valid =
      (int)(g.yx - in_plane < g.run ? g.yx - in_plane : g.run);
  const int i = threadIdx.x;
  // plane z's rows live in slot z & 1; the ring starts with plane z0 - 1
  stage_rows<Row>(tg, smem + ((z0 + 1) & 1) * slot_words,
                  (int64_t)(z0 - 1) * g.yx + in_plane, g);
  for (int zi = z0; zi < z1; ++zi) {
    const int64_t base = (int64_t)zi * g.yx + in_plane;
    stage_rows<Row>(tg, smem + (zi & 1) * slot_words, base, g);
    __syncthreads();
    if (i < n_valid) {
      const uint32_t* slot[2] = {smem + (zi & 1) * slot_words,
                                 smem + ((zi + 1) & 1) * slot_words};
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int corner = 0; corner < 8; ++corner) {
        const int dz = (corner >> 2) & 1, dy = (corner >> 1) & 1;
        const int dx = corner & 1;
        const int l = (dy ? 0 : g.lead) + i + 1 - dx;
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) {
          acc[ch] = __fadd_rn(acc[ch],
                              Row::get(slot[dz], g.stride, ch, corner, l));
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

template <typename Row>
int launch_grad(const void* table_grad, float* d_sigma, float* d_color,
                const Geometry& g, int blocks, int smem_bytes,
                cudaStream_t stream) {
  static int smem_set = 48 * 1024;
  // the staged index of voxel i's dy = 1 rows runs to i + 1 <= run, so
  // they are the first segment when lead = run + 1 and continue it when
  // lead = X
  if (g.run < 1 || g.run > Row::kMaxThreads || g.z_chunk < 1
      || (g.lead != g.x && g.lead != g.run + 1)
      || g.span != g.lead + g.run + 1 || g.stride < g.span
      || (int64_t)g.runs * g.run < g.yx
      || blocks != g.runs * ((g.z + g.z_chunk - 1) / g.z_chunk)
      || smem_bytes < (2 * Row::kSlotCols * g.stride + 3 * g.run) * 4) {
    return (int)cudaErrorInvalidValue;
  }
  if (smem_bytes > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        packed_table_grad_kernel<Row>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(
          packed_table_grad_kernel<Row>,
          cudaFuncAttributePreferredSharedMemoryCarveout,
          (int)cudaSharedmemCarveoutMaxShared);
    }
    if (err != cudaSuccess) return (int)err;
    smem_set = smem_bytes;
  }
  if (blocks > 0) {
    packed_table_grad_kernel<Row><<<blocks, g.run, smem_bytes, stream>>>(
        static_cast<const typename Row::Piece*>(table_grad), d_sigma,
        d_color, g);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dvt_packed_table_grad(const float* table_grad, float* d_sigma,
                                     float* d_color, int z, int y, int x,
                                     int run, int z_chunk, int runs,
                                     int lead, int span, int stride,
                                     int blocks, int smem_bytes,
                                     void* stream) {
  const Geometry g{(int64_t)z * y * x, (int64_t)y * x, (int64_t)x,
                   z, run, z_chunk, runs, lead, span, stride};
  return launch_grad<RowF32>(table_grad, d_sigma, d_color, g, blocks,
                             smem_bytes, (cudaStream_t)stream);
}

// kind: 0 bfloat16, 1 float16.
extern "C" int dvt_packed_table16_grad(const void* table_grad, float* d_sigma,
                                       float* d_color, int z, int y, int x,
                                       int kind, int run, int z_chunk,
                                       int runs, int lead, int span,
                                       int stride, int blocks, int smem_bytes,
                                       void* stream) {
  const Geometry g{(int64_t)z * y * x, (int64_t)y * x, (int64_t)x,
                   z, run, z_chunk, runs, lead, span, stride};
  const cudaStream_t s = (cudaStream_t)stream;
  if (kind == 0) {
    return launch_grad<RowHalf<FromBf16>>(table_grad, d_sigma, d_color, g,
                                          blocks, smem_bytes, s);
  }
  if (kind == 1) {
    return launch_grad<RowHalf<FromHalf>>(table_grad, d_sigma, d_color, g,
                                          blocks, smem_bytes, s);
  }
  return (int)cudaErrorInvalidValue;
}
