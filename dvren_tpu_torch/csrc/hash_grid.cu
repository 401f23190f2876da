// Fused hash-grid tile forward (K8f): the multi-level encoding from the
// tile's bank tables, both MLP heads and the emission-absorption
// recurrence for every ray of a tile group.
//
// Replaces dvren_tpu/ops/hash_grid.py::_fwd_kernel (launched by
// _hash_grid_op.fwd_call). It computes what that kernel computes, not how:
// the TPU kernel lays a chunk's 2048 samples over (16, 128) vregs, expands
// each bank column with lane gathers and turns the per-ray prefix sums
// into mask matmuls. Here, as in K1 (csrc/fused_tiles.cu), one block owns
// one 16x16 tile and one thread one ray, walking its samples in order with
// the optical-depth prefix as a running sum in a register. The packed MLP
// scalars (308 floats at hidden 8, enc 16) are loaded once per block into
// shared memory; every weight read is a broadcast.
//
// Layouts (see dvren_tpu_torch/render/tiled.py, ops/hash_grid.py):
//   tabs  (T, NB, C, 128) f32  bank tables, column (l*8 + corner)*F + f
//   samp  (T, nc, 3, 16, 128) u16  [sample_t hi16, lo16, lane | m << 15]
//   base  (T, NB, 3, 128) f32  per-slot finest cell base (x, y, z)
//   rayt  (T, 12, 128) f32, ke (T,) i32, bank0 (T*nc*SUBS,) i32  as K1's
//   sc    (P,) f32  packed MLP scalars (ops/hash_tiles.py::_mlp_layout)
//   out   (T, 5, 16, 16) f32  per ray: r, g, b, sum w*mid, processed od
//
// Per live sample: the slot and mask as K1; the finest coordinates
// fs = local * ns; each level's fraction fs * r - floor(base * r) with the
// exact power-of-two ratio r = res_l / res_finest; enc[l*F + f] as the
// corner sum of w8 times the bank column (l*8 + corner)*F + f; both heads;
// sigma and colour are 0 for a masked sample (the field is zero outside
// the unit cube), so those samples are skipped; then K1's recurrence with
// its exact early stop once T <= stop.
//
// Bound on the H100: the latency of the slot reads (C = 64 columns per
// sample at the headline, from a tile's window in L1/L2) and the MLP's
// 2*hidden*enc multiply-adds without FMA. Arithmetic runs in the plain
// twin's order with _rn intrinsics, so the kernel agrees with
// hash_grid.hash_grid_forward_plain to the last bit wherever expf does.

#include "hash_grid.cuh"

namespace {

using namespace dvt_grid;

// SUBS sub-tiles per block (1, 4, 16; 16, 8 or 4 px tiles): ray `ray`
// belongs to sub-tile ray / (256 / SUBS), i.e. block row r to sub-tile
// r / (16 / SUBS), whose chunk window starts at bank0[(t*nc + c)*SUBS + s],
// as _Windows(..., subs) resolves it in the TPU kernel.
template <int SUBS>
__global__ void __launch_bounds__(kRays)
hash_grid_forward_kernel(const float* __restrict__ tabs,
                         const uint16_t* __restrict__ samp,
                         const float* __restrict__ base,
                         const float* __restrict__ rayt,
                         const int* __restrict__ ke,
                         const int* __restrict__ bank0,
                         const float* __restrict__ scg,
                         float* __restrict__ out, GridConsts k) {
  extern __shared__ float sc[];
  block_copy(sc, scg, k.h.n_sc);
  __syncthreads();

  const int64_t t = blockIdx.x;
  const int ray = threadIdx.x;
  const int row = ray >> 4;
  const int lane0 = (ray & 15) * kSteps;
  const int sub_tile = ray / (kRays / SUBS);
  float o[3], d[3];
  load_ray(rayt, t, ray, o, d);
  const MlpLayout lay(k.h);
  const int ket = ke[t];
  const TileTime tt(ket, k.h);
  const int nc = k.h.nc;

  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_wd = 0.f, acc_odp = 0.f;
  float s = 0.f;   // optical depth of every earlier step
  bool done = false;
  for (int c = 0; c < nc && !done; ++c) {
    const int b0 = bank0[(t * nc + c) * SUBS + sub_tile] & 0x3FFF;
    const int b1 = min(b0 + 1, k.nb - 1);
    const uint16_t* sp = samp + (t * nc + c) * 3 * kChunkSamples
                         + row * kLanes + lane0;

    float c_r = 0.f, c_g = 0.f, c_b = 0.f, c_wd = 0.f, c_odp = 0.f;
    for (int j = 0; j < kSteps; ++j) {
      // a dead step (past t_far or k_max) has weight 0 and od 0
      float dta = 0.f, mid = 0.f;
      const bool live = tt.step(ket + c * kSteps + j, k.h, &dta, &mid);
      const float livef = live ? 1.f : 0.f;

      const float tb = expf(-s);
      if (!(tb > k.h.stop)) {   // every later step has weight 0
        done = true;
        break;
      }

      const uint32_t packed = sp[2 * kChunkSamples + j];
      float sig = 0.f, rgb[3] = {0.f, 0.f, 0.f};
      if ((packed >> 15) & 1u) {   // masked samples are zero
        const float st = __uint_as_float(((uint32_t)sp[j] << 16)
                                         | sp[kChunkSamples + j]);
        bool second;
        const int slot = window_slot((int)(packed & 0x7FFFu) - b0 * kLanes,
                                     &second);
        const int64_t bank = t * k.nb + (second ? b1 : b0);
        const float* cbase = base + bank * 3 * kLanes + slot;
        float fs[3], cb[3];
        finest_coords(o, d, st, k, fs);
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) cb[ax] = cbase[ax * kLanes];
        float pre_s[kMaxHidden], pre_c[kMaxHidden], c_pre2[3];
        grid_encode<true>(fs, cb, tabs + bank * k.cols * kLanes + slot, sc,
                          k, lay, pre_s, pre_c, nullptr);
        sig = fmaxf(sigma_pre2(pre_s, sc, k.h, lay), 0.f);
        color_pre2(pre_c, sc, k.h, lay, c_pre2);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) rgb[ch] = fminf(fmaxf(c_pre2[ch], 0.f), 1.f);
      }

      const float od = mul(fmaxf(mul(sig, dta), 0.f), livef);
      const float p = expf(-add(s, od));
      const float wgt = mul(sub(tb, p), livef);
      c_r = add(c_r, mul(wgt, rgb[0]));
      c_g = add(c_g, mul(wgt, rgb[1]));
      c_b = add(c_b, mul(wgt, rgb[2]));
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

template <int SUBS>
void launch(int n_tiles, cudaStream_t stream, const float* tabs,
            const uint16_t* samp, const float* base, const float* rayt,
            const int* ke, const int* bank0, const float* sc, float* out,
            const GridConsts& k) {
  hash_grid_forward_kernel<SUBS><<<n_tiles, kRays, (size_t)k.h.n_sc * 4,
                                   stream>>>(tabs, samp, base, rayt, ke,
                                             bank0, sc, out, k);
}

}  // namespace

extern "C" int dvt_hash_grid_forward(
    const float* tabs, const uint16_t* samp, const float* base,
    const float* rayt, const int* ke, const int* bank0, const float* sc,
    float* out, int n_tiles, int nc, int nb, int k_max, int subs,
    int n_levels,
    int n_feat, int hidden, float dt, float t_near, float t_far,
    float t_stop, float stop, float lo_x, float lo_y, float lo_z,
    float inv_x, float inv_y, float inv_z, float ns_x, float ns_y,
    float ns_z, const float* ratios, void* stream) {
  if (!spec_ok(n_levels, n_feat, hidden)) return (int)cudaErrorInvalidValue;
  const GridConsts k = make_grid_consts(
      nc, nb, k_max, n_levels, n_feat, hidden, dt, t_near, t_far, t_stop,
      stop, lo_x, lo_y, lo_z, inv_x, inv_y, inv_z, ns_x, ns_y, ns_z, ratios);
  if (n_tiles <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (subs == 1) {
    launch<1>(n_tiles, st, tabs, samp, base, rayt, ke, bank0, sc, out, k);
  } else if (subs == 4) {
    launch<4>(n_tiles, st, tabs, samp, base, rayt, ke, bank0, sc, out, k);
  } else if (subs == 16) {
    launch<16>(n_tiles, st, tabs, samp, base, rayt, ke, bank0, sc, out, k);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
