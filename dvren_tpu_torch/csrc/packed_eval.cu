// Packed-stencil point evaluation (forward) and its adjoint into the
// stencil rows (backward), the per-sample field evaluation of the per-ray
// paths (windowed groups, the tiled schedule's fallback, the Renderer's
// fused, staged, override and streamed modes, the windowed fit).
//
// It replaces no Pallas kernel: dvren_tpu/ops/grid.py::eval_packed_trilinear
// is XLA ops in JAX (a row gather, the corner weights, a product and a
// sum; autodiff's scatter-add in the backward). The plain twin is
// dvren_tpu_torch/ops/grid.py::eval_packed_trilinear(use_kernel=False):
// trilinear_fractions, take_rows and its sort-based segment sum.
//
// The table: R = (Z-1)(Y-1)(X-1) rows of 32 values, column corner*4 + ch
// (corner = dz*4 + dy*2 + dx, ch in sigma, r, g, b), in float32, bfloat16
// or float16 (ops/grid.py::build_packed_stencil). A sample's bbox locals,
// base cell and corner weights are the twin's operations in the twin's
// order, each rounded on its own (__fsub_rn / __fmul_rn: no FMA
// contraction), so the weights equal the twin's bit for bit.
//
// Forward (packed_eval_forward_kernel): a thread a sample reads its 12
// bytes of position, the cell's 128-byte row (64 bytes in 16 bits) as 16-
// byte loads, widens 16-bit values exactly, sums the 8 corners in corner
// order and writes the four planes, coalesced. Nothing else per sample is
// stored. Bound on the H100: bytes. The 63^3 float32 table (32 MB) stays in
// the 50 MB L2, so a pass over S samples moves 28 S bytes of HBM
// (64,520,192 samples: 1.81 GB, 0.54 ms at 3.35 TB/s) and reads 128 S
// bytes from L2.
//
// Backward, four steps on one stream, no float atomics:
// 1. packed_eval_keys_kernel, a thread a sample: the cell key (R, past the
//    last row, for a sample outside the bbox under OOB_ZERO: its weights
//    are all zero and it adds nothing), the sample's index, and a 32-byte
//    record (tx, ty, tz, 0, g_sigma, g_r, g_g, g_b) read back in step 4
//    as one sector. Where the positions carry a gradient (the camera
//    differentiated through them), the same thread reads the cell's row
//    and writes the position cotangent, three planes: the twin's autograd
//    through its corner weights (position_adjoint).
// 2. cub's DeviceRadixSort::SortPairs over the key's bits alone (18 at
//    63^3): stable, so a row's samples keep their index order.
// 3. packed_eval_bounds_kernel: seg[key[i]] = {i, ...} where key[i]
//    differs from key[i - 1], {..., i + 1} where it differs from key[i + 1];
//    seg is zeroed first, so a row with no sample has an empty segment.
//    Every row is written by at most one thread of each kind.
// 4. packed_eval_segment_kernel, a warp a row and a lane a column: the
//    warp loads 32 of its row's samples at a time (a record a lane), each
//    lane computes its sample's 8 weights from tx, ty, tz as the forward
//    does, and the warp adds w[corner] * g[ch] in the sorted order from
//    shared memory. Each row is written once (0 without a sample), in
//    float32 or rounded once to the table's 16-bit type.
// The sums run in the same order every time, so repeat backwards and
// repeat graph replays give the same bits. Bound: about 84 bytes a sample
// of HBM (the cotangent and the position read, the record written and
// read, int32 key and index pairs through the sort's passes) plus 128 R
// bytes of rows; 12 more a sample, and a row read from L2, with the
// position cotangent. Steps 2-4 run only where the table wants a
// cotangent.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <cub/device/device_radix_sort.cuh>

namespace {

constexpr int kCols = 32;           // 8 corners x 4 channels
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWStride = 9;         // shared rows of 8 weights, padded
constexpr int kGStride = 5;         // shared rows of 4 cotangents, padded

enum TableType { kF32 = 0, kBF16 = 1, kF16 = 2 };

struct Geom {
  int nx, ny, nz;       // grid points per axis
  float lo[3];          // bbox_min, as float32
  float inv[3];         // 1 / extent in double, as float32
  int degenerate;       // bit a: axis a has a zero extent (local 0)
  int clamp;            // OOB_CLAMP: locals clamped, nothing outside
};

// The base cell (ix, iy, iz), the fractions (tx, ty, tz) and whether the
// sample lies outside the bbox, as ops/grid.py::trilinear_fractions
// computes them.
// `pass` has bit a where a change of the position moves the local along
// axis a: not a zero-extent axis, and under OOB_CLAMP a local in [0, 1]
// (torch.clamp's adjoint passes at the bounds, not past them or at NaN).
struct Cell {
  int ix, iy, iz;
  float tx, ty, tz;
  bool outside;
  int pass;
};

__device__ __forceinline__ float axis_local(float p, const Geom& g, int a,
                                            bool& outside, int& pass) {
  const bool degenerate = (g.degenerate >> a) & 1;
  float l = degenerate ? 0.0f : __fmul_rn(__fsub_rn(p, g.lo[a]), g.inv[a]);
  outside = outside || (l < 0.0f) || (l > 1.0f);
  if (!degenerate && (!g.clamp || (l >= 0.0f && l <= 1.0f))) pass |= 1 << a;
  if (g.clamp && !isnan(l)) l = fminf(fmaxf(l, 0.0f), 1.0f);
  return l;
}

// floor(l * (n - 1)) clamped to [0, n - 2] (NaN to 0, as int64 then clamp
// gives it), and the fraction l * (n - 1) - base.
__device__ __forceinline__ int axis_base(float l, int n, float& t) {
  const float f = __fmul_rn(l, (float)(n - 1));
  const float fl = floorf(f);
  const int b = !(fl >= 0.0f) ? 0 : (fl > (float)(n - 2) ? n - 2 : (int)fl);
  t = __fsub_rn(f, (float)b);
  return b;
}

__device__ __forceinline__ Cell locate(float px, float py, float pz,
                                       const Geom& g) {
  Cell c;
  bool out = false;
  c.pass = 0;
  const float lx = axis_local(px, g, 0, out, c.pass);
  const float ly = axis_local(py, g, 1, out, c.pass);
  const float lz = axis_local(pz, g, 2, out, c.pass);
  c.outside = !g.clamp && out;
  c.ix = axis_base(lx, g.nx, c.tx);
  c.iy = axis_base(ly, g.ny, c.ty);
  c.iz = axis_base(lz, g.nz, c.tz);
  return c;
}

// The 8 corner weights in corner order: (wz * wy) * wx, each factor 1 - t
// or t, then times 0 or 1 (outside or not under OOB_ZERO).
__device__ __forceinline__ void corner_weights(float tx, float ty, float tz,
                                               float inside, float* w) {
  const float wx[2] = {__fsub_rn(1.0f, tx), tx};
  const float wy[2] = {__fsub_rn(1.0f, ty), ty};
  const float wz[2] = {__fsub_rn(1.0f, tz), tz};
#pragma unroll
  for (int k = 0; k < 8; ++k)
    w[k] = __fmul_rn(__fmul_rn(__fmul_rn(wz[k >> 2], wy[(k >> 1) & 1]),
                               wx[k & 1]),
                     inside);
}

__device__ __forceinline__ long long row_of(const Cell& c, const Geom& g) {
  return ((long long)c.iz * (g.ny - 1) + c.iy) * (g.nx - 1) + c.ix;
}

__device__ __forceinline__ float widen_bf16(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

__device__ __forceinline__ float widen_f16(uint32_t bits16) {
  return __half2float(__ushort_as_half((unsigned short)bits16));
}

// The row's 32 values as float32, read as 16-byte loads.
template <int T>
__device__ __forceinline__ void load_row(const void* table, long long row,
                                         float* v) {
  if (T == kF32) {
    const float4* p = reinterpret_cast<const float4*>(table) + row * 8;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float4 x = __ldg(p + q);
      v[4 * q] = x.x;
      v[4 * q + 1] = x.y;
      v[4 * q + 2] = x.z;
      v[4 * q + 3] = x.w;
    }
  } else {
    const uint4* p = reinterpret_cast<const uint4*>(table) + row * 4;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 x = __ldg(p + q);
      const uint32_t words[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint32_t lo = words[k] & 0xffffu, hi = words[k] >> 16;
        v[8 * q + 2 * k] = T == kBF16 ? widen_bf16(lo) : widen_f16(lo);
        v[8 * q + 2 * k + 1] = T == kBF16 ? widen_bf16(hi) : widen_f16(hi);
      }
    }
  }
}

// The position cotangent d[3] of a sample inside the bbox with plane
// cotangents gv[4] and row v[32], as the twin's autograd takes it:
// gw[k] = sum_ch gv[ch] * v[4k + ch], through w[k] = (wz * wy) * wx into
// (tx, ty, tz), then per axis times (n - 1), the pass bit and inv.
__device__ __forceinline__ void position_adjoint(const Cell& c,
                                                 const float* gv,
                                                 const float* v,
                                                 const Geom& g, float* d) {
  const float wx[2] = {__fsub_rn(1.0f, c.tx), c.tx};
  const float wy[2] = {__fsub_rn(1.0f, c.ty), c.ty};
  const float wz[2] = {__fsub_rn(1.0f, c.tz), c.tz};
  float dt[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int bx = k & 1, by = (k >> 1) & 1, bz = k >> 2;
    float gw = __fmul_rn(gv[0], v[4 * k]);
#pragma unroll
    for (int ch = 1; ch < 4; ++ch)
      gw = __fadd_rn(gw, __fmul_rn(gv[ch], v[4 * k + ch]));
    const float ex = __fmul_rn(gw, __fmul_rn(wz[bz], wy[by]));
    const float gx = __fmul_rn(gw, wx[bx]);
    const float ey = __fmul_rn(gx, wz[bz]);
    const float ez = __fmul_rn(gx, wy[by]);
    dt[0] = bx ? __fadd_rn(dt[0], ex) : __fsub_rn(dt[0], ex);
    dt[1] = by ? __fadd_rn(dt[1], ey) : __fsub_rn(dt[1], ey);
    dt[2] = bz ? __fadd_rn(dt[2], ez) : __fsub_rn(dt[2], ez);
  }
  const int n[3] = {g.nx, g.ny, g.nz};
#pragma unroll
  for (int a = 0; a < 3; ++a)
    d[a] = ((c.pass >> a) & 1)
               ? __fmul_rn(__fmul_rn(dt[a], (float)(n[a] - 1)), g.inv[a])
               : 0.0f;
}

template <int T>
__global__ void __launch_bounds__(kThreads) packed_eval_forward_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const void* __restrict__ table,
    float* __restrict__ out_s, float* __restrict__ out_r,
    float* __restrict__ out_g, float* __restrict__ out_b, long long n,
    Geom g) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const Cell c = locate(px[i], py[i], pz[i], g);
  float w[8];
  corner_weights(c.tx, c.ty, c.tz, c.outside ? 0.0f : 1.0f, w);
  float v[kCols];
  load_row<T>(table, row_of(c, g), v);
  float acc[4];
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) {
    acc[ch] = __fmul_rn(w[0], v[ch]);
#pragma unroll
    for (int k = 1; k < 8; ++k)
      acc[ch] = __fadd_rn(acc[ch], __fmul_rn(w[k], v[4 * k + ch]));
  }
  out_s[i] = acc[0];
  out_r[i] = acc[1];
  out_g[i] = acc[2];
  out_b[i] = acc[3];
}

// kPos: also the position cotangent (dpx, dpy, dpz), from the row of the
// table of type T; without it T is not read.
template <int T, bool kPos>
__global__ void __launch_bounds__(kThreads) packed_eval_keys_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const float* __restrict__ gs,
    const float* __restrict__ gr, const float* __restrict__ gg,
    const float* __restrict__ gb, const void* __restrict__ table,
    uint32_t* __restrict__ keys, uint32_t* __restrict__ idx,
    float4* __restrict__ records, float* __restrict__ dpx,
    float* __restrict__ dpy, float* __restrict__ dpz, long long n,
    uint32_t sentinel, Geom g) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const Cell c = locate(px[i], py[i], pz[i], g);
  const float gv[4] = {gs[i], gr[i], gg[i], gb[i]};
  keys[i] = c.outside ? sentinel : (uint32_t)row_of(c, g);
  idx[i] = (uint32_t)i;
  records[2 * i] = make_float4(c.tx, c.ty, c.tz, 0.0f);
  records[2 * i + 1] = make_float4(gv[0], gv[1], gv[2], gv[3]);
  if (kPos) {
    float d[3] = {0.0f, 0.0f, 0.0f};
    if (!c.outside) {  // outside under OOB_ZERO: all weights 0, no motion
      float v[kCols];
      load_row<T>(table, row_of(c, g), v);
      position_adjoint(c, gv, v, g, d);
    }
    dpx[i] = d[0];
    dpy[i] = d[1];
    dpz[i] = d[2];
  }
}

__global__ void __launch_bounds__(kThreads) packed_eval_bounds_kernel(
    const uint32_t* __restrict__ keys, int2* __restrict__ seg, long long n,
    uint32_t n_rows) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t k = keys[i];
  if (k >= n_rows) return;  // the sentinel: outside samples, no row
  if (i == 0 || keys[i - 1] != k) seg[k].x = (int)i;
  if (i == n - 1 || keys[i + 1] != k) seg[k].y = (int)(i + 1);
}

template <int T>
__global__ void __launch_bounds__(kThreads) packed_eval_segment_kernel(
    const uint32_t* __restrict__ idx_sorted,
    const float4* __restrict__ records, const int2* __restrict__ seg,
    void* __restrict__ out, uint32_t n_rows) {
  __shared__ float w_sm[kWarps][32 * kWStride];
  __shared__ float g_sm[kWarps][32 * kGStride];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row >= n_rows) return;  // the whole warp leaves together
  const int2 s = seg[row];
  float* ws = w_sm[warp];
  float* gsh = g_sm[warp];
  const int corner = lane >> 2, ch = lane & 3;
  float acc = 0.0f;
  for (int base = s.x; base < s.y; base += 32) {
    const int j = base + lane;
    if (j < s.y) {
      const uint32_t i = idx_sorted[j];
      const float4 t = records[2 * (long long)i];
      const float4 gv = records[2 * (long long)i + 1];
      float w[8];
      corner_weights(t.x, t.y, t.z, 1.0f, w);
#pragma unroll
      for (int k = 0; k < 8; ++k) ws[lane * kWStride + k] = w[k];
      gsh[lane * kGStride] = gv.x;
      gsh[lane * kGStride + 1] = gv.y;
      gsh[lane * kGStride + 2] = gv.z;
      gsh[lane * kGStride + 3] = gv.w;
    }
    __syncwarp();
    const int m = min(32, s.y - base);
    for (int k = 0; k < m; ++k)
      acc = __fadd_rn(acc, __fmul_rn(ws[k * kWStride + corner],
                                     gsh[k * kGStride + ch]));
    __syncwarp();
  }
  const long long o = row * kCols + lane;
  if (T == kF32) {
    reinterpret_cast<float*>(out)[o] = acc;
  } else if (T == kBF16) {
    reinterpret_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(acc);
  } else {
    reinterpret_cast<__half*>(out)[o] = __float2half_rn(acc);
  }
}

inline unsigned blocks_for(long long items, int per_block) {
  return (unsigned)((items + per_block - 1) / per_block);
}

Geom make_geom(int nx, int ny, int nz, float lo_x, float lo_y, float lo_z,
               float inv_x, float inv_y, float inv_z, int degenerate,
               int clamp) {
  Geom g;
  g.nx = nx; g.ny = ny; g.nz = nz;
  g.lo[0] = lo_x; g.lo[1] = lo_y; g.lo[2] = lo_z;
  g.inv[0] = inv_x; g.inv[1] = inv_y; g.inv[2] = inv_z;
  g.degenerate = degenerate;
  g.clamp = clamp;
  return g;
}

}  // namespace

// Forward: four (n,) planes.
extern "C" int dvt_packed_eval_forward(
    const float* px, const float* py, const float* pz, const void* table,
    int table_type, float* out_s, float* out_r, float* out_g, float* out_b,
    long long n, int nx, int ny, int nz, float lo_x,
    float lo_y, float lo_z, float inv_x, float inv_y, float inv_z,
    int degenerate, int clamp, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const Geom g = make_geom(nx, ny, nz, lo_x, lo_y, lo_z, inv_x, inv_y, inv_z,
                           degenerate, clamp);
  const unsigned blocks = blocks_for(n, kThreads);
  if (table_type == kF32)
    packed_eval_forward_kernel<kF32><<<blocks, kThreads, 0, st>>>(
        px, py, pz, table, out_s, out_r, out_g, out_b, n, g);
  else if (table_type == kBF16)
    packed_eval_forward_kernel<kBF16><<<blocks, kThreads, 0, st>>>(
        px, py, pz, table, out_s, out_r, out_g, out_b, n, g);
  else if (table_type == kF16)
    packed_eval_forward_kernel<kF16><<<blocks, kThreads, 0, st>>>(
        px, py, pz, table, out_s, out_r, out_g, out_b, n, g);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The scratch bytes the backward's sort needs for n pairs over end_bit
// bits, into *bytes (host memory); no device work.
extern "C" int dvt_packed_eval_sort_bytes(long long n, int end_bit,
                                          unsigned long long* bytes) {
  size_t need = 0;
  cudaError_t err = cub::DeviceRadixSort::SortPairs(
      nullptr, need, (const uint32_t*)nullptr, (uint32_t*)nullptr,
      (const uint32_t*)nullptr, (uint32_t*)nullptr, (int)n, 0, end_bit);
  *bytes = (unsigned long long)need;
  return (int)err;
}

// Backward: the (R, 32) row cotangents `out`, in the table's type, and the
// position cotangents (dpx, dpy, dpz; n float32 each), of the four (n,)
// plane cotangents; `out` null skips the sort, the bounds and the segment
// sums, `dpx` null the position cotangent (`table` is read only for it).
// `keys`, `keys_sorted`, `idx`, `idx_sorted` (n uint32 each), `records`
// (n x 32 bytes), `temp` (`temp_bytes`, from dvt_packed_eval_sort_bytes)
// and `seg` (R int2) are scratch.
extern "C" int dvt_packed_eval_backward(
    const float* px, const float* py, const float* pz, const float* gs,
    const float* gr, const float* gg, const float* gb, const void* table,
    uint32_t* keys, uint32_t* keys_sorted, uint32_t* idx,
    uint32_t* idx_sorted, void* records, void* temp,
    unsigned long long temp_bytes, void* seg, void* out, float* dpx,
    float* dpy, float* dpz, int table_type, long long n, int n_rows,
    int end_bit, int nx, int ny, int nz, float lo_x, float lo_y, float lo_z,
    float inv_x, float inv_y, float inv_z, int degenerate, int clamp,
    void* stream) {
  if (table_type < kF32 || table_type > kF16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Geom g = make_geom(nx, ny, nz, lo_x, lo_y, lo_z, inv_x, inv_y, inv_z,
                           degenerate, clamp);
  const uint32_t rows = (uint32_t)n_rows;
  float4* recs = (float4*)records;
  if (n > 0) {
    const unsigned blocks = blocks_for(n, kThreads);
    if (dpx == nullptr)
      packed_eval_keys_kernel<kF32, false><<<blocks, kThreads, 0, st>>>(
          px, py, pz, gs, gr, gg, gb, table, keys, idx, recs, dpx, dpy, dpz,
          n, rows, g);
    else if (table_type == kF32)
      packed_eval_keys_kernel<kF32, true><<<blocks, kThreads, 0, st>>>(
          px, py, pz, gs, gr, gg, gb, table, keys, idx, recs, dpx, dpy, dpz,
          n, rows, g);
    else if (table_type == kBF16)
      packed_eval_keys_kernel<kBF16, true><<<blocks, kThreads, 0, st>>>(
          px, py, pz, gs, gr, gg, gb, table, keys, idx, recs, dpx, dpy, dpz,
          n, rows, g);
    else
      packed_eval_keys_kernel<kF16, true><<<blocks, kThreads, 0, st>>>(
          px, py, pz, gs, gr, gg, gb, table, keys, idx, recs, dpx, dpy, dpz,
          n, rows, g);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || out == nullptr) return (int)err;
    size_t bytes = (size_t)temp_bytes;
    err = cub::DeviceRadixSort::SortPairs(temp, bytes, keys, keys_sorted,
                                          idx, idx_sorted, (int)n, 0,
                                          end_bit, st);
    if (err != cudaSuccess) return (int)err;
  }
  if (out == nullptr) return (int)cudaGetLastError();
  cudaError_t err = cudaMemsetAsync(seg, 0, sizeof(int2) * rows, st);
  if (err != cudaSuccess) return (int)err;
  if (n > 0)
    packed_eval_bounds_kernel<<<blocks_for(n, kThreads), kThreads, 0, st>>>(
        keys_sorted, (int2*)seg, n, rows);
  const unsigned blocks = blocks_for(rows, kWarps);
  const int2* segs = (const int2*)seg;
  if (table_type == kF32)
    packed_eval_segment_kernel<kF32><<<blocks, kThreads, 0, st>>>(
        idx_sorted, recs, segs, out, rows);
  else if (table_type == kBF16)
    packed_eval_segment_kernel<kBF16><<<blocks, kThreads, 0, st>>>(
        idx_sorted, recs, segs, out, rows);
  else
    packed_eval_segment_kernel<kF16><<<blocks, kThreads, 0, st>>>(
        idx_sorted, recs, segs, out, rows);
  return (int)cudaGetLastError();
}
