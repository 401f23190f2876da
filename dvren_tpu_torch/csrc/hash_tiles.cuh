// Shared device code of the fused hash-MLP kernels (K7f hash_tiles.cu,
// K7b hash_tiles_bwd.cu, and through hash_grid.cuh K8f / K8b): constants,
// the sample lattice, the hash, the per-sample encoding folded into both
// heads' pre-activations, and the heads' second layers.
//
// Every float operation uses the _rn intrinsics (no FMA contraction) in
// the order of dvren_tpu_torch/ops/hash_tiles.py's plain twins, which is
// the order of dvren_tpu/ops/hash_tiles.py's _encode_chunk / _mlp_heads:
//   position p = o + d * st; per level s = p * res, x0 = floor(s),
//   f = s - x0; corners dz, dy, dx (outer to inner) with weight
//   (wx * wy) * wz; enc[l*F + f] = sum over corners of w * table value;
//   pre[j] = (sum over i of w1[j, i] * enc[i]) + b1[j].
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace dvt_hash {

constexpr int kLanes = 128;
constexpr int kRows = 16;
constexpr int kSteps = 8;
constexpr int kRays = 256;
constexpr int kChunkSamples = kRows * kLanes;   // 2048
constexpr int kMaxLevels = 64;                  // encoding_dim <= 64
constexpr int kMaxHidden = 8;                   // hidden_dim <= 8
constexpr uint32_t kPrimeY = 2654435761u;
constexpr uint32_t kPrimeZ = 805459861u;

struct HashConsts {
  int nc, k_max, n_levels, n_feat, t_size, hidden, enc, n_sc;
  float dt, t_near, t_far, t_stop, stop;
  float res[kMaxLevels];
};

// Offsets into the packed MLP scalar vector (ops/hash_tiles.py::_mlp_layout).
struct MlpLayout {
  int sw1, sb1, sw2, sb2, cw1, cb1, cw2, cb2;
  __device__ __forceinline__ explicit MlpLayout(const HashConsts& k) {
    const int he = k.hidden * k.enc;
    sw1 = 0;
    sb1 = he;
    sw2 = sb1 + k.hidden;
    sb2 = sw2 + k.hidden;
    cw1 = sb2 + 1;
    cb1 = cw1 + he;
    cw2 = cb1 + k.hidden;
    cb2 = cw2 + 3 * k.hidden;
  }
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// d max(x, 0) / dx with JAX's tie value 0.5 at x == 0.
__device__ __forceinline__ float tie(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? 0.f : 0.5f);
}

// Wrapping uint32 3-prime XOR hash; t_size is a power of two.
__device__ __forceinline__ int hash3(int x, int y, int z, int t_size) {
  const uint32_t h = (uint32_t)x ^ ((uint32_t)y * kPrimeY)
                     ^ ((uint32_t)z * kPrimeZ);
  return (int)(h & (uint32_t)(t_size - 1));
}

// The cell of position p at resolution res (integer corner ic) and the
// eight corner weights (wx*wy)*wz in corner order dz*4 + dy*2 + dx.
__device__ __forceinline__ void level_cell(const float p[3], float res,
                                           float w[8], int ic[3]) {
  float fr[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float s = mul(p[ax], res);
    const float fl = floorf(s);
    fr[ax] = sub(s, fl);
    ic[ax] = (int)fl;
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float wx = (c & 1) ? fr[0] : sub(1.f, fr[0]);
    const float wy = ((c >> 1) & 1) ? fr[1] : sub(1.f, fr[1]);
    const float wz = (c >> 2) ? fr[2] : sub(1.f, fr[2]);
    w[c] = mul(mul(wx, wy), wz);
  }
}

// Table entry of corner c of the cell at ic.
__device__ __forceinline__ int corner_entry(const int ic[3], int c,
                                            int t_size) {
  return hash3(ic[0] + (c & 1), ic[1] + ((c >> 1) & 1), ic[2] + (c >> 2),
               t_size);
}

// The eight corners of level `l` around position p: weights w and table
// entries id, in corner order.
__device__ __forceinline__ void level_corners(const float p[3], float res,
                                              int t_size, float w[8],
                                              int id[8]) {
  int ic[3];
  level_cell(p, res, w, ic);
#pragma unroll
  for (int c = 0; c < 8; ++c) id[c] = corner_entry(ic, c, t_size);
}

// Feature f of level l: sum over the corners, in corner order.
__device__ __forceinline__ float level_feature(const float* tab, int l,
                                               int f, const float w[8],
                                               const int id[8],
                                               const HashConsts& k) {
  const float* lt = tab + l * k.t_size * k.n_feat + f;
  float e = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) e = add(e, mul(w[c], lt[id[c] * k.n_feat]));
  return e;
}

// The first layers' pre-activations are folded feature by feature, in
// the i-order of the sums: zero_pre, then fold_feature for i = 0, 1, ...
// as each feature is final, then add_biases; pre_s (and pre_c when
// kColor) end as w1 . enc + b1.
__device__ __forceinline__ void zero_pre(float pre_s[kMaxHidden],
                                         float pre_c[kMaxHidden]) {
#pragma unroll
  for (int j = 0; j < kMaxHidden; ++j) {
    pre_s[j] = 0.f;
    pre_c[j] = 0.f;
  }
}

template <bool kColor>
__device__ __forceinline__ void fold_feature(int i, float e, const float* sc,
                                             const HashConsts& k,
                                             const MlpLayout& lay,
                                             float pre_s[kMaxHidden],
                                             float pre_c[kMaxHidden]) {
#pragma unroll
  for (int j = 0; j < kMaxHidden; ++j) {
    if (j < k.hidden) {
      pre_s[j] = add(pre_s[j], mul(sc[lay.sw1 + j * k.enc + i], e));
      if (kColor) pre_c[j] = add(pre_c[j], mul(sc[lay.cw1 + j * k.enc + i], e));
    }
  }
}

template <bool kColor>
__device__ __forceinline__ void add_biases(const float* sc,
                                           const HashConsts& k,
                                           const MlpLayout& lay,
                                           float pre_s[kMaxHidden],
                                           float pre_c[kMaxHidden]) {
#pragma unroll
  for (int j = 0; j < kMaxHidden; ++j) {
    if (j < k.hidden) {
      pre_s[j] = add(pre_s[j], sc[lay.sb1 + j]);
      if (kColor) pre_c[j] = add(pre_c[j], sc[lay.cb1 + j]);
    }
  }
}

// Encode the sample at p and fold each feature into the first layers'
// pre-activations as soon as it is final. With enc_out, the features are
// also written to enc_out[i].
template <bool kColor>
__device__ __forceinline__ void encode_dense(const float p[3],
                                             const float* tab,
                                             const float* sc,
                                             const HashConsts& k,
                                             const MlpLayout& lay,
                                             float pre_s[kMaxHidden],
                                             float pre_c[kMaxHidden],
                                             float* enc_out) {
  zero_pre(pre_s, pre_c);
  for (int l = 0; l < k.n_levels; ++l) {
    float w[8];
    int id[8];
    level_corners(p, k.res[l], k.t_size, w, id);
    for (int f = 0; f < k.n_feat; ++f) {
      const float e = level_feature(tab, l, f, w, id, k);
      const int i = l * k.n_feat + f;
      if (enc_out != nullptr) enc_out[i] = e;
      fold_feature<kColor>(i, e, sc, k, lay, pre_s, pre_c);
    }
  }
  add_biases<kColor>(sc, k, lay, pre_s, pre_c);
}

// Second layer of the sigma head: s_pre2 = sum_j w2[j] * relu(pre_s[j]) + b2.
__device__ __forceinline__ float sigma_pre2(const float pre_s[kMaxHidden],
                                            const float* sc,
                                            const HashConsts& k,
                                            const MlpLayout& lay) {
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxHidden; ++j) {
    if (j < k.hidden) acc = add(acc, mul(sc[lay.sw2 + j], fmaxf(pre_s[j], 0.f)));
  }
  return add(acc, sc[lay.sb2]);
}

// Second layer of the colour head, before the clamp.
__device__ __forceinline__ void color_pre2(const float pre_c[kMaxHidden],
                                           const float* sc,
                                           const HashConsts& k,
                                           const MlpLayout& lay,
                                           float out[3]) {
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxHidden; ++j) {
      if (j < k.hidden) {
        acc = add(acc, mul(sc[lay.cw2 + ch * k.hidden + j],
                           fmaxf(pre_c[j], 0.f)));
      }
    }
    out[ch] = add(acc, sc[lay.cb2 + ch]);
  }
}

// Lattice step kk of every ray (tiles start at step 0): live flag, the
// segment length dt_actual and the depth cursor (closed form, as
// fused_tiles._chunk_geometry with k_enter 0).
__device__ __forceinline__ bool step_geometry(int kk, const HashConsts& k,
                                              float* dta, float* mid) {
  const float base_t = add(k.t_near, mul((float)kk, k.dt));
  if (!(base_t < k.t_far && kk < k.k_max)) return false;
  *dta = sub(fminf(add(base_t, k.dt), k.t_far), base_t);
  const float t_origin_c = fminf(k.t_near, k.t_stop);
  const float tcur =
      add(k.t_near, fmaxf(sub(fminf(base_t, k.t_stop), t_origin_c), 0.f));
  *mid = add(tcur, mul(0.5f, *dta));
  return true;
}

// The ray's origin and direction from the compact ray planes.
__device__ __forceinline__ void load_ray(const float* rayt, int64_t t,
                                         int ray, float o[3], float d[3]) {
  const float* rt = rayt + t * 12 * kLanes;
  const int half = ray >> 7;
  const int rl = ray & (kLanes - 1);
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    o[ax] = rt[(ax * 2 + half) * kLanes + rl];
    d[ax] = rt[((3 + ax) * 2 + half) * kLanes + rl];
  }
}

// Copy n floats from global to shared memory, the whole block.
__device__ __forceinline__ void block_copy(float* dst, const float* src,
                                           int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

inline HashConsts make_consts(int nc, int k_max, int n_levels, int n_feat,
                              int t_size, int hidden, float dt, float t_near,
                              float t_far, float t_stop, float stop,
                              const float* res) {
  HashConsts k;
  k.nc = nc;
  k.k_max = k_max;
  k.n_levels = n_levels;
  k.n_feat = n_feat;
  k.t_size = t_size;
  k.hidden = hidden;
  k.enc = n_levels * n_feat;
  k.n_sc = 2 * hidden * k.enc + 6 * hidden + 4;
  k.dt = dt;
  k.t_near = t_near;
  k.t_far = t_far;
  k.t_stop = t_stop;
  k.stop = stop;
  for (int l = 0; l < kMaxLevels; ++l) k.res[l] = l < n_levels ? res[l] : 0.f;
  return k;
}

}  // namespace dvt_hash
