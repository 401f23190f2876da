// Fused hash-MLP tile forward (K7f): hash encoding, both MLP heads and the
// emission-absorption recurrence for every ray of a tile group.
//
// Replaces dvren_tpu/ops/hash_tiles.py::_fwd_kernel (launched by
// _hash_tile_op.fwd_call). It computes what that kernel computes, not
// how: the TPU kernel lays a chunk's 2048 samples over (16, 128) vregs,
// keeps the table as an (8, 128) lane block searched by lane gathers and
// turns the per-ray prefix sums into mask matmuls. Here one block owns
// one 16x16 tile and one thread owns one ray, walking its samples in
// order with the optical-depth prefix as a running sum in a register.
// The whole table (L*T*F floats, 8 KB at L=8, T=128, F=2) and the packed
// MLP scalars (308 floats at hidden 8, enc 16) are loaded once per block
// into shared memory; every weight read is a broadcast.
//
// Layouts (see dvren_tpu_torch/render/hash_tiled.py):
//   samp  (T, nc, 16, 128) f32  sample_t; chunk c, step j of ray r at row
//                               r/16, lane (r%16)*8 + j
//   rayt  (T, 12, 128) f32      row ax*2 + ray/128, lane ray%128 for
//                               (ox, oy, oz, dx, dy, dz)
//   table (L, T, F) f32, sc (P,) f32 (ops/hash_tiles.py::_mlp_layout)
//   out   (T, 5, 16, 16) f32    per ray: r, g, b, sum w*mid, processed od
//
// Bound on the H100: arithmetic. Each sample costs 8*L hashes, 8*L*F
// shared-memory table reads and 2*hidden*(enc+2) + 6*hidden multiply-adds
// (without FMA, to stay in the twin's rounding); nothing but sample_t is
// read from device memory per sample. A ray stops once T <= stop (exact:
// every later step has weight 0) and at the end of the live lattice.

#include "hash_tiles.cuh"

namespace {

using namespace dvt_hash;

__global__ void __launch_bounds__(kRays)
hash_forward_kernel(const float* __restrict__ samp,
                    const float* __restrict__ rayt,
                    const float* __restrict__ table,
                    const float* __restrict__ scg,
                    float* __restrict__ out, HashConsts k) {
  extern __shared__ float smem[];
  const int ltf = k.n_levels * k.t_size * k.n_feat;
  float* tab = smem;
  float* sc = smem + ltf;
  block_copy(tab, table, ltf);
  block_copy(sc, scg, k.n_sc);
  __syncthreads();

  const int64_t t = blockIdx.x;
  const int ray = threadIdx.x;
  const int row = ray >> 4;
  const int lane0 = (ray & 15) * kSteps;
  float o[3], d[3];
  load_ray(rayt, t, ray, o, d);
  const MlpLayout lay(k);

  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_wd = 0.f, acc_odp = 0.f;
  float s = 0.f;   // optical depth of every earlier step
  bool done = false;
  for (int c = 0; c < k.nc && !done; ++c) {
    const float* st_c = samp + ((t * k.nc + c) * kRows + row) * kLanes + lane0;
    float c_r = 0.f, c_g = 0.f, c_b = 0.f, c_wd = 0.f, c_odp = 0.f;
    for (int j = 0; j < kSteps; ++j) {
      float dta, mid;
      // dead steps (past t_far or k_max) are trailing and add exactly 0;
      // so does every step from the first with T <= stop
      const float tb = expf(-s);
      if (!step_geometry(c * kSteps + j, k, &dta, &mid) || !(tb > k.stop)) {
        done = true;
        break;
      }
      const float st = st_c[j];
      float p[3];
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) p[ax] = add(o[ax], mul(d[ax], st));
      float pre_s[kMaxHidden], pre_c[kMaxHidden], rgb[3];
      encode_dense<true>(p, tab, sc, k, lay, pre_s, pre_c, nullptr);
      const float sig = fmaxf(sigma_pre2(pre_s, sc, k, lay), 0.f);
      color_pre2(pre_c, sc, k, lay, rgb);

      const float od = fmaxf(mul(sig, dta), 0.f);
      const float pn = expf(-add(s, od));
      const float wgt = sub(tb, pn);
      c_r = add(c_r, mul(wgt, fminf(fmaxf(rgb[0], 0.f), 1.f)));
      c_g = add(c_g, mul(wgt, fminf(fmaxf(rgb[1], 0.f), 1.f)));
      c_b = add(c_b, mul(wgt, fminf(fmaxf(rgb[2], 0.f), 1.f)));
      c_wd = add(c_wd, mul(wgt, mid));
      c_odp = add(c_odp, od);
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

}  // namespace

extern "C" int dvt_hash_forward(
    const float* samp, const float* rayt, const float* table,
    const float* sc, float* out, int n_tiles, int nc, int k_max,
    int n_levels, int n_feat, int t_size, int hidden, float dt,
    float t_near, float t_far, float t_stop, float stop, const float* res,
    void* stream) {
  if (n_levels < 1 || n_levels * n_feat > kMaxLevels || hidden < 1
      || hidden > kMaxHidden) {
    return (int)cudaErrorInvalidValue;
  }
  const HashConsts k = make_consts(nc, k_max, n_levels, n_feat, t_size,
                                   hidden, dt, t_near, t_far, t_stop, stop,
                                   res);
  const size_t smem = (size_t)(n_levels * t_size * n_feat + k.n_sc) * 4;
  if (n_tiles > 0) {
    hash_forward_kernel<<<n_tiles, kRays, smem, (cudaStream_t)stream>>>(
        samp, rayt, table, sc, out, k);
  }
  return (int)cudaGetLastError();
}
