// Fused tile forward (K1): slot expansion, trilinear interpolation and
// the emission-absorption recurrence for every ray of a tile schedule.
//
// Replaces dvren_tpu/ops/fused_tiles.py::_fwd_kernel (launched by
// _tile_op.fwd_call). It computes what that kernel computes, not how:
// the TPU kernel lays 2048 samples of a chunk across (16, 128) vregs,
// expands slots with lane shuffles and turns the per-ray prefix sums into
// mask matmuls on the MXU. Here one thread owns one ray and walks its
// samples in order, so the prefix sums are a running sum in a register.
//
// One launch covers every tile group of a schedule: through a descriptor
// (desc, (T, 4) i32: nc, nb, first chunk, first bank per tile;
// tile_set.cuh::tile_span) each tile finds its chunks and banks in the
// schedule's flat arrays, so a launch fills the card however few tiles a
// group holds (the JAX package launches once per group). One group is the
// case of a single shape.
//
// Layouts (see dvren_tpu_torch/render/tiled.py, ops/fused_tiles.py), with
// S_c = the tiles' chunks and S_b their banks, summed over the groups:
//   tabs  (S_b, C, 128) f32  bank tables, lane slot; C = 32, row
//                            ch*8 + corner (cells), or C = 108, row
//                            ch*27 + vertex (supercells)
//   samp  (S_c, 3, 16, 128) u16  [sample_t hi16, lo16, lane | m << 15]
//                                (supercells: lane(12) | lb << 12 | m << 15)
//   base  (S_b, 3, 128) f32  per-slot cell base coordinates (x, y, z),
//                            a supercell's vertex origin
//   rayt  (T, 12, 128) f32  row ax*2 + ray/128, lane ray%128 for
//                           (ox, oy, oz, dx, dy, dz)
//   ke    (T,) i32  tile window start step
//   bank0 (S_c*subs,) i32  window start bank per (chunk, sub-tile) in
//                    bits 0..13 (bit 30, the JAX backward's ALIGNED
//                    flag, is ignored here)
//   desc  (T, 4) i32  per tile: nc, nb, first chunk, first bank
//   order (T,) i32  block b renders tile order[b]: the tiles by falling
//                   chunk count, so the longest start first and the
//                   launch's tail is short; no output moves
//   out   (T, 5, 16, 16) f32  per ray: r, g, b, sum w*mid, processed od
// Sample (chunk c, step j) of ray `ray` sits at block row ray/16, lane
// (ray%16)*8 + j.
//
// Bound on the H100: memory latency of the slot reads. Each live sample
// reads 32 table values and 3 bases from its tile's 2-bank window (a
// tile's banks total at most 160 KB at the headline scene and stay in
// L1/L2); masked samples (about 2/3 of the lattice there) read nothing.
// This first version reads tables straight from global memory; staging a
// tile's banks in shared memory, and folding the bank gather in, are
// later steps.
//
// Arithmetic runs in the plain twin's order, with explicit _rn intrinsics
// so nvcc does not contract a*b+c into FMAs: the kernel then agrees with
// fused_tiles.tile_forward_plain to the last bit wherever expf does.
// Stopping a ray once T <= stop is exact: its later steps all have
// weight 0.

#include <cstdint>
#include <cuda_runtime.h>

#include "tile_set.cuh"

namespace {

using dvt_tiles::tile_span;
using dvt_tiles::TileSpan;

constexpr int kLanes = 128;
constexpr int kRows = 16;
constexpr int kSteps = 8;
constexpr int kNch = 32;
constexpr int kRays = 256;
constexpr int kChunkSamples = kRows * kLanes;   // 2048

// What the tiles of a launch share; each tile's chunk and bank counts
// come from its descriptor.
struct TileConsts {
  int k_max;
  float dt, t_near, t_far, t_stop, stop;
  float lo[3], inv[3], ns[3];
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// SUBS sub-tiles per block (1, 4, 16): ray `ray` belongs to sub-tile
// ray / (256 / SUBS), whose window at the tile's chunk c starts at
// bank0[(chunk0 + c)*SUBS + s]. SUPER: the supercell stencil (108 columns
// ch*27 + vertex; packed word lane(12) | lb << 12 | m << 15). A supercell
// sample's cell base is its supercell's vertex origin plus lb, an exact
// float add, and its 8 corners are the vertices lb + (dx, dy, dz): the
// JAX kernel sums all 27 hat-weighted vertices, whose 19 extra terms are
// exact zeros, so reading the 8 gives the same sum to the last bit.
template <int SUBS, bool SUPER>
__global__ void __launch_bounds__(kRays)
tile_forward_kernel(const float* __restrict__ tabs,
                    const uint16_t* __restrict__ samp,
                    const float* __restrict__ base,
                    const float* __restrict__ rayt,
                    const int* __restrict__ ke,
                    const int* __restrict__ bank0,
                    const int* __restrict__ desc,
                    const int* __restrict__ order,
                    float* __restrict__ out, TileConsts k) {
  constexpr int kCols = SUPER ? 108 : kNch;
  constexpr int kPer = SUPER ? 27 : 8;            // columns per channel
  constexpr unsigned kLaneMask = SUPER ? 0xFFFu : 0x7FFFu;
  const int64_t t = order[blockIdx.x];   // the longest tiles start first
  const TileSpan span = tile_span(desc, t);
  const int ray = threadIdx.x;
  const int row = ray >> 4;
  const int lane0 = (ray & 15) * kSteps;
  const int sub_tile = ray / (kRays / SUBS);

  const float* rt = rayt + t * 12 * kLanes;
  const int half = ray >> 7;
  const int rl = ray & (kLanes - 1);
  float o[3], d[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    o[ax] = rt[(ax * 2 + half) * kLanes + rl];
    d[ax] = rt[((3 + ax) * 2 + half) * kLanes + rl];
  }

  const int ket = ke[t];
  const float t_origin = add(k.t_near, mul((float)ket, k.dt));
  const float t_origin_c = fminf(t_origin, k.t_stop);

  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_wd = 0.f, acc_odp = 0.f;
  float s = 0.f;   // optical depth of every earlier step, processed or not
  bool done = false;
  for (int c = 0; c < span.nc && !done; ++c) {
    const int64_t ch = span.chunk0 + c;
    const int b0 = bank0[ch * SUBS + sub_tile] & 0x3FFF;
    const int b1 = min(b0 + 1, span.nb - 1);
    const float* tab0 = tabs + (span.bank0 + b0) * kCols * kLanes;
    const float* tab1 = tabs + (span.bank0 + b1) * kCols * kLanes;
    const float* base0 = base + (span.bank0 + b0) * 3 * kLanes;
    const float* base1 = base + (span.bank0 + b1) * 3 * kLanes;
    const uint16_t* sc = samp + ch * 3 * kChunkSamples + row * kLanes + lane0;

    float c_r = 0.f, c_g = 0.f, c_b = 0.f, c_wd = 0.f, c_odp = 0.f;
    for (int j = 0; j < kSteps; ++j) {
      const int kk = ket + c * kSteps + j;
      const float base_t = add(k.t_near, mul((float)kk, k.dt));
      const bool live = (base_t < k.t_far) && (kk < k.k_max);
      const float livef = live ? 1.f : 0.f;
      const float dta =
          live ? sub(fminf(add(base_t, k.dt), k.t_far), base_t) : 0.f;
      const float tcur =
          add(t_origin, fmaxf(sub(fminf(base_t, k.t_stop), t_origin_c), 0.f));

      const float tb = expf(-s);
      if (!(tb > k.stop)) {   // every later step has weight 0
        done = true;
        break;
      }

      const uint32_t packed = sc[2 * kChunkSamples + j];
      float sig = 0.f, cr = 0.f, cg = 0.f, cb = 0.f;
      if ((packed >> 15) & 1u) {   // masked samples interpolate to 0
        const uint32_t bits = ((uint32_t)sc[j] << 16) | sc[kChunkSamples + j];
        const float st = __uint_as_float(bits);
        const int idx2 = (int)(packed & kLaneMask) - b0 * kLanes;
        const bool second = idx2 >= kLanes;
        const int slot = second ? min(max(idx2 - kLanes, 0), kLanes - 1)
                                : min(max(idx2, 0), kLanes - 1);
        const float* tab = second ? tab1 : tab0;
        const float* cbase = second ? base1 : base0;
        int lb[3] = {0, 0, 0};
        if (SUPER) {
#pragma unroll
          for (int ax = 0; ax < 3; ++ax) lb[ax] = (packed >> (12 + ax)) & 1u;
        }
        float w[3][2];
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) {
          const float p = add(o[ax], mul(d[ax], st));
          const float local = mul(sub(p, k.lo[ax]), k.inv[ax]);
          const float f = mul(local, k.ns[ax]);
          float cb_ax = cbase[ax * kLanes + slot];
          if (SUPER) cb_ax = add(cb_ax, (float)lb[ax]);
          const float frac = sub(f, cb_ax);
          w[ax][0] = sub(1.f, frac);
          w[ax][1] = frac;
        }
        float w8[8];
        int col8[8];
#pragma unroll
        for (int corner = 0; corner < 8; ++corner) {
          const int dz = corner >> 2, dy = (corner >> 1) & 1, dx = corner & 1;
          w8[corner] = mul(mul(w[2][dz], w[1][dy]), w[0][dx]);
          col8[corner] = SUPER ? (lb[2] + dz) * 9 + (lb[1] + dy) * 3
                                     + (lb[0] + dx)
                               : corner;
        }
        float ch_val[4];
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) {
          const float* col = tab + ch * kPer * kLanes + slot;
          float acc = mul(w8[0], col[col8[0] * kLanes]);
#pragma unroll
          for (int corner = 1; corner < 8; ++corner) {
            acc = add(acc, mul(w8[corner], col[col8[corner] * kLanes]));
          }
          ch_val[ch] = acc;
        }
        sig = ch_val[0];
        cr = ch_val[1];
        cg = ch_val[2];
        cb = ch_val[3];
      }

      const float od = mul(fmaxf(mul(sig, dta), 0.f), livef);
      const float p = expf(-add(s, od));
      const float wgt = mul(sub(tb, p), livef);
      const float mid = add(tcur, mul(0.5f, dta));
      c_r = add(c_r, mul(wgt, cr));
      c_g = add(c_g, mul(wgt, cg));
      c_b = add(c_b, mul(wgt, cb));
      c_wd = add(c_wd, mul(wgt, mid));
      c_odp = add(c_odp, mul(od, livef));
      s = add(s, od);
    }
    acc_r = add(acc_r, c_r);
    acc_g = add(acc_g, c_g);
    acc_b = add(acc_b, c_b);
    acc_wd = add(acc_wd, c_wd);
    acc_odp = add(acc_odp, c_odp);
  }

  float* o_t = out + t * 5 * kRays + ray;
  o_t[0 * kRays] = acc_r;
  o_t[1 * kRays] = acc_g;
  o_t[2 * kRays] = acc_b;
  o_t[3 * kRays] = acc_wd;
  o_t[4 * kRays] = acc_odp;
}

template <int SUBS, bool SUPER>
void launch(int n_tiles, cudaStream_t stream, const float* tabs,
            const uint16_t* samp, const float* base, const float* rayt,
            const int* ke, const int* bank0, const int* desc,
            const int* order, float* out, const TileConsts& k) {
  tile_forward_kernel<SUBS, SUPER><<<n_tiles, kRays, 0, stream>>>(
      tabs, samp, base, rayt, ke, bank0, desc, order, out, k);
}

}  // namespace

extern "C" int dvt_tile_forward(
    const float* tabs, const uint16_t* samp, const float* base,
    const float* rayt, const int* ke, const int* bank0, const int* desc,
    const int* order, float* out, int n_tiles, int k_max, int subs,
    int super_stencil,
    float dt, float t_near, float t_far, float t_stop, float stop,
    float lo_x, float lo_y, float lo_z, float inv_x, float inv_y,
    float inv_z, float ns_x, float ns_y, float ns_z, void* stream) {
  TileConsts k;
  k.k_max = k_max;
  k.dt = dt;
  k.t_near = t_near;
  k.t_far = t_far;
  k.t_stop = t_stop;
  k.stop = stop;
  k.lo[0] = lo_x; k.lo[1] = lo_y; k.lo[2] = lo_z;
  k.inv[0] = inv_x; k.inv[1] = inv_y; k.inv[2] = inv_z;
  k.ns[0] = ns_x; k.ns[1] = ns_y; k.ns[2] = ns_z;
  if (n_tiles <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  const bool sup = super_stencil != 0;
#define DVT_FWD(S, SUP)                                                      \
  launch<S, SUP>(n_tiles, st, tabs, samp, base, rayt, ke, bank0, desc,     \
                 order, out, k)
  if (subs == 1 && !sup) {
    DVT_FWD(1, false);
  } else if (subs == 4 && !sup) {
    DVT_FWD(4, false);
  } else if (subs == 16 && !sup) {
    DVT_FWD(16, false);
  } else if (subs == 1) {
    DVT_FWD(1, true);
  } else if (subs == 4) {
    DVT_FWD(4, true);
  } else if (subs == 16) {
    DVT_FWD(16, true);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef DVT_FWD
  return (int)cudaGetLastError();
}
