// Packed trilinear stencil tables, built straight from the grid: float32
// (K3) and bfloat16 / float16 (K5a).
//
// K3 replaces dvren_tpu/ops/packed_transpose.py::stack_to_u16_rows
// (_t_split_kernel) together with the XLA shift stack that feeds it
// (dvren_tpu/ops/grid.py::_shift_stack_fullpitch): row v of the (R, 32)
// float32 table holds, at column ch*8 + dz*4 + dy*2 + dx, the value
// plane_ch[v + dz*Y*X + dy*X + dx], zero past the end of the grid, where
// plane 0 is sigma (Z,Y,X) and planes 1..3 are the channels of color
// (Z,Y,X,3). The offsets are flat: x + 1 at X - 1 is the next line's
// first voxel, and at X = 1 or Y = 1 two corners share a source.
//
// K5a replaces dvren_tpu/ops/packed_transpose.py::stack_to_rows
// (_t_fwd_kernel) on the route dvren_tpu/ops/grid.py::_build_fullpitch
// takes for a bfloat16 or float16 table: the shift stack, its cast to the
// table type, then the (32, P) -> (P, 32) transpose. Its rows hold the same
// values rounded to the table type (round to nearest even,
// __float2bfloat16_rn / __float2half_rn, per element, so where the
// rounding happens changes no bit), bit-equal to the plain twin
// ops/packed_transpose.py::build_rows16_plain.
//
// The TPU kernel split each f32 into hi/lo u16 halves because TPU gathers
// are paced by element type; the card has no such cost, so K3 writes the
// f32 table (bit-identical to hi<<16|lo of the TPU rows). Its values are
// moved, never computed on, so NaN payloads and -0.0 pass.
//
// Bound on the H100: bytes. At 64^3 K3 reads 4.2 MB (sigma + color) and
// writes 33.6 MB (0.0113 ms at 3.35 TB/s), K5a writes 16.8 MB (0.0063
// ms); at 128^3 8x that (0.0901 / 0.0501 ms). The stores are 80-89 % of
// the bytes, so they set the design: a block owns `rows` consecutive rows
// and writes them as one contiguous stretch, a warp's 16-byte stores
// covering 512 contiguous bytes. Before that it stages, coalesced, the
// four source spans the rows read (for each (dz, dy), rows + 1 values of
// every channel, zero past the grid) in shared memory as 16 planes, plane
// dy*8 + ch*2 + dz with a stride of 4 mod 32 words (stage_spans, shared
// by both kernels). K3 stages floats, so that the row's 16-byte word
// q = ch*2 + dz is planes q and 8 + q at the row's voxel and the next
// one. K5a stages 32-bit pair words, word i of a plane holding the
// rounded values of voxels i and i + 1 (low, high half), so that a row's
// 16-byte word ch (channel ch's 8 corners) is word i of planes ch*2,
// 8 + ch*2, ch*2 + 1 and 9 + ch*2: four aligned reads, which a warp (8
// rows x 4 channels) makes on 32 banks, as K3's reads are. The inputs are
// a fifth of the bytes or less, so reading each four times from the L2
// costs little. The launch geometry comes from
// ops/packed_transpose.py::table_tiling.
//
// Device ms (the stream asleep while the host queues the calls) on an
// NVIDIA H100 80GB HBM3 at 700 W, tools/torch_packed_table_times.py, at
// 64^3 / 128^3. K3: the first design (one thread a row: 32 scalar loads,
// eight 16-byte stores to its own row, so a warp's store touched 32 rows)
// 0.0404 / 0.3484; staged spans with a staging loop that divided by a
// runtime span length for every value 0.0197 / 0.1181; this loop (a
// thread's 24 loads issued before its stores, the four spans unrolled)
// 0.0139 / 0.1074 (bound 0.0113 / 0.0901). K5a: the first design (one
// thread a row, four 16-byte stores to its own 64-byte row) 0.0149 /
// 0.0996 in bfloat16; staged pair words with the dividing loop 0.0189 /
// 0.1204, so the loop's instructions, not the stores, set the time; this
// loop 0.0109 / 0.0668 (bound 0.0063 / 0.0501), float16 the same. 64, 128
// or 256 rows a block: 0.0115, 0.0109, 0.0109 at 64^3 and 0.0723, 0.0670,
// 0.0668 at 128^3. The 64^3 table's 1,024 blocks run as one wave, so its
// loads and stores do not overlap.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// Stage the four (dz, dy) spans of block v0's rows: put(dst, value) for
// staged value t of plane dy*8 + ch*2 + dz at dst = plane * stride + t.
// A thread loads its at most 24 values (sigma t = tid, tid + rows; color
// float c = tid + k * rows, k < 4, of each span) before it puts any; the
// block has `rows` threads, so 2 * rows >= rows + 1 and 4 * rows >=
// 3 * (rows + 1) (rows >= 3) cover the spans.
template <typename Put>
__device__ __forceinline__ void stage_spans(const float* __restrict__ sigma,
                                            const float* __restrict__ color,
                                            int64_t v0, int64_t n_cells,
                                            int64_t yx, int64_t x, int rows,
                                            int stride, Put put) {
  const int n = rows + 1;       // voxels a span
  const int tid = threadIdx.x;
  float sv[4][2], cv[4][4];
#pragma unroll
  for (int seg = 0; seg < 4; ++seg) {      // dz * 2 + dy
    const int64_t s0 = v0 + (seg >> 1) * yx + (seg & 1) * x;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int t = tid + k * rows;
      sv[seg][k] = t < n && s0 + t < n_cells ? sigma[s0 + t] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = tid + k * rows;        // color float c of the span
      cv[seg][k] = c < 3 * n && s0 + c / 3 < n_cells ? color[3 * s0 + c]
                                                     : 0.0f;
    }
  }
#pragma unroll
  for (int seg = 0; seg < 4; ++seg) {
    const int plane = (seg & 1) * 8 + (seg >> 1);   // dy * 8 + dz
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int t = tid + k * rows;
      if (t < n) put(plane * stride + t, sv[seg][k]);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = tid + k * rows;
      if (c < 3 * n) {
        const int vox = c / 3;
        const int ch = 1 + c - 3 * vox;
        put((plane + ch * 2) * stride + vox, cv[seg][k]);
      }
    }
  }
}

struct PutF32 {
  float* stage;
  __device__ void operator()(int dst, float v) const { stage[dst] = v; }
};

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

// Staged value t rounded, as the low half of pair word t and the high half
// of pair word t - 1. At t = 0 that is the word before the plane: the
// previous plane's padding (stride > rows), or nothing for plane 0.
template <typename Cvt>
struct PutPair16 {
  unsigned short* stage;   // the pair words' 16-bit halves
  __device__ void operator()(int dst, float v) const {
    const unsigned short b = Cvt::bits(v);
    stage[2 * dst] = b;
    if (dst > 0) stage[2 * dst - 1] = b;
  }
};

__global__ void __launch_bounds__(kThreads)
packed_table_kernel(const float* __restrict__ sigma,
                    const float* __restrict__ color,
                    float4* __restrict__ out, int64_t n_cells,
                    int64_t n_rows, int64_t yx, int64_t x, int rows,
                    int stride) {
  extern __shared__ float stage[];
  const int64_t v0 = blockIdx.x * (int64_t)rows;
  stage_spans(sigma, color, v0, n_cells, yx, x, rows, stride,
              PutF32{stage});
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

template <typename Cvt>
__global__ void __launch_bounds__(kThreads)
packed_table16_kernel(const float* __restrict__ sigma,
                      const float* __restrict__ color,
                      uint4* __restrict__ out, int64_t n_cells,
                      int64_t n_rows, int64_t yx, int64_t x, int rows,
                      int stride) {
  extern __shared__ uint32_t words[];
  const int64_t v0 = blockIdx.x * (int64_t)rows;
  stage_spans(sigma, color, v0, n_cells, yx, x, rows, stride,
              PutPair16<Cvt>{reinterpret_cast<unsigned short*>(words)});
  __syncthreads();
  const int64_t n_out = (n_rows - v0 < rows ? n_rows - v0 : rows) * 4;
  uint4* dst = out + v0 * 4;
  for (int f = threadIdx.x; f < n_out; f += blockDim.x) {
    // row f >> 2, channel f & 3: pairs (dz, dy) = (0, 0), (0, 1), (1, 0),
    // (1, 1) from planes dy*8 + ch*2 + dz
    const uint32_t* w = words + (f & 3) * 2 * stride + (f >> 2);
    dst[f] = make_uint4(w[0], w[8 * stride], w[stride], w[9 * stride]);
  }
}

// The checks both entry points make: block b's rows [b * rows, (b + 1) *
// rows) cover the table, its rows threads stage the spans, and the 16
// staged planes fit.
bool bad_table_geometry(int n_rows, int rows, int stride, int blocks,
                        int smem_bytes) {
  return rows < 3 || rows > kThreads || stride < rows + 1
         || (int64_t)blocks * rows < n_rows || smem_bytes < 16 * stride * 4;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem_bytes, int* smem_set) {
  if (smem_bytes <= *smem_set) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess) *smem_set = smem_bytes;
  return err;
}

template <typename Cvt>
int launch_table16(const float* sigma, const float* color, void* out,
                   int64_t n_cells, int n_rows, int64_t yx, int64_t x,
                   int rows, int stride, int blocks, int smem_bytes,
                   cudaStream_t stream) {
  static int smem_set = 48 * 1024;
  const cudaError_t err =
      allow_smem(packed_table16_kernel<Cvt>, smem_bytes, &smem_set);
  if (err != cudaSuccess) return (int)err;
  if (blocks > 0) {
    packed_table16_kernel<Cvt><<<blocks, rows, smem_bytes, stream>>>(
        sigma, color, reinterpret_cast<uint4*>(out), n_cells, n_rows, yx, x,
        rows, stride);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dvt_packed_table(const float* sigma, const float* color,
                                float* out, int z, int y, int x, int n_rows,
                                int rows, int stride, int blocks,
                                int smem_bytes, void* stream) {
  static int smem_set = 48 * 1024;
  if (bad_table_geometry(n_rows, rows, stride, blocks, smem_bytes)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err =
      allow_smem(packed_table_kernel, smem_bytes, &smem_set);
  if (err != cudaSuccess) return (int)err;
  if (blocks > 0) {
    packed_table_kernel<<<blocks, rows, smem_bytes,
                          (cudaStream_t)stream>>>(
        sigma, color, reinterpret_cast<float4*>(out),
        (int64_t)z * y * x, n_rows, (int64_t)y * x, (int64_t)x, rows,
        stride);
  }
  return (int)cudaGetLastError();
}

// kind: 0 bfloat16, 1 float16.
extern "C" int dvt_packed_table16(const float* sigma, const float* color,
                                  void* out, int z, int y, int x, int n_rows,
                                  int kind, int rows, int stride, int blocks,
                                  int smem_bytes, void* stream) {
  if ((kind != 0 && kind != 1)
      || bad_table_geometry(n_rows, rows, stride, blocks, smem_bytes)) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t n_cells = (int64_t)z * y * x;
  return kind == 0
      ? launch_table16<ToBf16>(sigma, color, out, n_cells, n_rows,
                               (int64_t)y * x, x, rows, stride, blocks,
                               smem_bytes, (cudaStream_t)stream)
      : launch_table16<ToHalf>(sigma, color, out, n_cells, n_rows,
                               (int64_t)y * x, x, rows, stride, blocks,
                               smem_bytes, (cudaStream_t)stream);
}

extern "C" const char* dvt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
