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
// The whole table (L*T*F floats, 8 KB at L=8, T=128, F=2) and the MLP
// scalars are loaded once per block into shared memory.
//
// Layouts (see dvren_tpu_torch/render/hash_tiled.py):
//   samp  (T, nc, 16, 128) f32  sample_t; chunk c, step j of ray r at row
//                               r/16, lane (r%16)*8 + j
//   rayt  (T, 12, 128) f32      row ax*2 + ray/128, lane ray%128 for
//                               (ox, oy, oz, dx, dy, dz)
//   table (L, T, F) f32, sc (P,) f32 (ops/hash_tiles.py::_mlp_layout)
//   out   (T, 5, 16, 16) f32    per ray: r, g, b, sum w*mid, processed od
//
// Bound on the H100: instruction throughput. Each sample costs 8*L hashes,
// 8*L corner reads and 2*hidden*(enc+2) + 6*hidden multiply-adds
// (without FMA, to stay in the twin's rounding); nothing but sample_t is
// read from device memory per sample. The SM runs about four float
// instructions for each shared-memory load, so the loads per sample are
// kept few beside the 1,111 float operations: the block keeps its
// scalars as feature-major rows (hash_tiles.cuh::MlpRows) read as float4
// broadcasts, a corner's features are read together (float2 at F = 2),
// and a thread computes two consecutive samples' heads at once, each
// weight read once for both (the recurrence then takes them in order):
// about 100 loads a sample, 64 of them the corners. The transmittance
// after a step is the next step's before it (the same float), so a step
// takes one expf. A ray stops once T <= stop (exact: every later step has
// weight 0) and at the end of the live lattice; a sample computed past
// that point is not used. Timing-only variants
// (tools/torch_hash_bwd_ablate.py, H100 at 700 W, 512^2 hash headline):
// 2.12 ms as it is, 1.85 with every MLP read a constant, 2.22
// with every table read one; two blocks per SM (128 registers) beat
// three (80 registers and spills: 2.42 ms) and four (4.46).

#include "hash_tiles.cuh"

namespace {

using namespace dvt_hash;

// two blocks per SM: at most 128 registers (two samples' state; three
// blocks spill)
__global__ void __launch_bounds__(kRays, 2)
hash_forward_kernel(const float* __restrict__ samp,
                    const float* __restrict__ rayt,
                    const float* __restrict__ table,
                    const float* __restrict__ scg,
                    float* __restrict__ out, HashConsts k) {
  extern __shared__ __align__(16) float smem[];
  const int ltf = k.n_levels * k.t_size * k.n_feat;
  float* rows = smem;                              // MlpRows
  float* tab = rows + MlpRows(k.enc).floats();     // 16-byte aligned
  load_mlp_rows(rows, scg, k);
  block_copy(tab, table, ltf);
  __syncthreads();

  const int64_t t = blockIdx.x;
  const int ray = threadIdx.x;
  const int row = ray >> 4;
  const int lane0 = (ray & 15) * kSteps;
  float o[3], d[3];
  load_ray(rayt, t, ray, o, d);

  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_wd = 0.f, acc_odp = 0.f;
  float s = 0.f;    // optical depth of every earlier step
  float tb = 1.f;   // expf(-s)
  bool done = false;
  for (int c = 0; c < k.nc && !done; ++c) {
    const float* st_c = samp + ((t * k.nc + c) * kRows + row) * kLanes + lane0;
    float c_r = 0.f, c_g = 0.f, c_b = 0.f, c_wd = 0.f, c_odp = 0.f;
    // two steps at a time: both samples' heads first (each weight read
    // once for both), then the recurrence step by step
    for (int j = 0; j < kSteps && !done; j += 2) {
      float p[2][3];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float st = st_c[j + n];
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) p[n][ax] = add(o[ax], mul(d[ax], st));
      }
      float pre_s[2][kMaxHidden], pre_c[2][kMaxHidden], s_pre2[2], rgb[2][3];
      encode_rows_n<true, 2>(p, tab, rows, k, pre_s, pre_c, nullptr);
      sigma_pre2_rows_n<2>(pre_s, rows, k, s_pre2);
      color_pre2_rows_n<2>(pre_c, rows, k, rgb);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float dta, mid;
        // dead steps (past t_far or k_max) are trailing and add exactly
        // 0; so does every step from the first with T <= stop
        if (!step_geometry(c * kSteps + j + n, k, &dta, &mid)
            || !(tb > k.stop)) {
          done = true;
          break;
        }
        const float od = fmaxf(mul(fmaxf(s_pre2[n], 0.f), dta), 0.f);
        s = add(s, od);
        const float pn = expf(-s);
        const float wgt = sub(tb, pn);
        tb = pn;
        c_r = add(c_r, mul(wgt, fminf(fmaxf(rgb[n][0], 0.f), 1.f)));
        c_g = add(c_g, mul(wgt, fminf(fmaxf(rgb[n][1], 0.f), 1.f)));
        c_b = add(c_b, mul(wgt, fminf(fmaxf(rgb[n][2], 0.f), 1.f)));
        c_wd = add(c_wd, mul(wgt, mid));
        c_odp = add(c_odp, od);
      }
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

size_t forward_smem(int n_levels, int n_feat, int t_size) {
  return (size_t)(MlpRows(n_levels * n_feat).floats()
                  + n_levels * t_size * n_feat) * 4;
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
  const size_t smem = forward_smem(n_levels, n_feat, t_size);
  if (n_tiles > 0) {
    hash_forward_kernel<<<n_tiles, kRays, smem, (cudaStream_t)stream>>>(
        samp, rayt, table, sc, out, k);
  }
  return (int)cudaGetLastError();
}

// K7f's registers, static and dynamic shared memory (bytes per block),
// local memory (bytes per thread) and resident blocks per SM at a spec.
extern "C" int dvt_hash_forward_occupancy(int n_levels, int n_feat,
                                          int t_size, int hidden, int* out) {
  if (n_levels < 1 || n_levels * n_feat > kMaxLevels || hidden < 1
      || hidden > kMaxHidden) {
    return (int)cudaErrorInvalidValue;
  }
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, hash_forward_kernel);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = forward_smem(n_levels, n_feat, t_size);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, hash_forward_kernel, kRays, smem);
  out[0] = fa.numRegs;
  out[1] = (int)fa.sharedSizeBytes;
  out[2] = (int)fa.localSizeBytes;
  out[3] = (int)smem;
  out[4] = blocks;
  return (int)err;
}
